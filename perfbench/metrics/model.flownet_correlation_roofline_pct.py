"""Share of its least time that FlowNetC's cost volume (kernel K5) reaches
over the profiled requests of the flow tool: per ``c2m.flownet.correlation``
span the larger of its counted ``bytes`` (both feature maps read once, the
441-channel volume written once) over ``roofline.HBM_BYTES_PER_S`` and its
counted ``flops`` (2 x C for each pixel and displacement that stays inside
the map) over ``roofline.FP32_FLOPS``,
summed, over the spans' summed device intervals. None where the spans,
their intervals or their counts are absent."""

from perfbench import flow_spans, roofline

UNIT = "%"
SPAN = "c2m.flownet.correlation"


def read(run):
    spans = flow_spans.counted(run, SPAN, ("bytes", "flops"))
    if spans is None:
        return None
    seconds = sum(s.device_ms for s in spans) / 1e3
    if seconds <= 0:
        return None
    least = sum(max(s.counts["bytes"] / roofline.HBM_BYTES_PER_S,
                    s.counts["flops"] / roofline.FP32_FLOPS) for s in spans)
    return 100.0 * least / seconds
