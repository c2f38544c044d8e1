"""Share of the HBM bandwidth bound that FlowNet2's four warps with their
channel norms reach over the profiled requests of the flow tool: the bytes
the port counts on its ``c2m.flownet.warp`` spans (both images and the
flow read once, the warped image and the norm written once) over
``roofline.HBM_BYTES_PER_S``, over the spans' summed device intervals.
The passes do a few operations a byte, so bytes bound them. None where the
spans, their intervals or their counts are absent."""

from perfbench import flow_spans, roofline

UNIT = "%"
SPAN = "c2m.flownet.warp"


def read(run):
    spans = flow_spans.counted(run, SPAN, ("bytes",))
    if spans is None:
        return None
    seconds = sum(s.device_ms for s in spans) / 1e3
    if seconds <= 0:
        return None
    moved = sum(s.counts["bytes"] for s in spans)
    return 100.0 * moved / roofline.HBM_BYTES_PER_S / seconds
