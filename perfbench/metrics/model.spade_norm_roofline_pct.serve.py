"""Share of the HBM bandwidth bound that the SPADE generator's
normalise-and-modulate passes reach over the profiled requests: the bytes
the port counts on its ``c2m.model.spade.norm`` spans (x, gamma and beta
read once, the output written once), over ``roofline.HBM_BYTES_PER_S``,
over the summed device intervals of those spans. The passes do a few
operations a byte, so bytes bound them. None where the spans, their
device intervals or their counts are absent (a plain generator, the CPU, a
port that counts nothing)."""

from perfbench import roofline, spans

UNIT = "%"
SPAN = "c2m.model.spade.norm"


def share(norms):
    """100 x (summed bytes / HBM rate) / summed device seconds of the spans
    ``norms``; None where one lacks its count or interval."""
    if not norms or any(s.device_ms is None
                        or "bytes" not in getattr(s, "counts", {})
                        for s in norms):
        return None
    seconds = sum(s.device_ms for s in norms) / 1e3
    if seconds <= 0:
        return None
    moved = sum(s.counts["bytes"] for s in norms)
    return 100.0 * moved / roofline.HBM_BYTES_PER_S / seconds


def read(run):
    if run.kind != "serve":
        return None
    try:
        from c2m_tpu_torch import trace
    except ImportError:
        return None
    records = trace.records()
    units = {s.id for s in records if s.name == spans.UNIT_SPANS["serve"]}
    return share([s for s in records if s.name == SPAN and s.unit in units])
