"""Summed device intervals of the port's ``c2m.flownet.deconv`` spans per
profiled request of the flow tool: FlowNet2's 36 transposed convolutions a
call (``F.conv_transpose2d``, cuDNN), busy and idle alike. None in other
cells."""

from perfbench import flow_spans

UNIT = "ms"


def read(run):
    return flow_spans.mean_per_request(run, "c2m.flownet.deconv", "device_ms")
