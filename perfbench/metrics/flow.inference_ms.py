"""Device interval of the port's ``c2m.flow.inference`` span per profiled
request of the flow tool (``c2m.flow.request``): ``compute_flow_and_conf``
over the request's frame pairs, FlowNet2 and the confidence splat, busy
and idle alike (CUDA events at the span's edges). None in other cells."""

from perfbench import flow_spans

UNIT = "ms"


def read(run):
    return flow_spans.mean_per_request(run, "c2m.flow.inference", "device_ms")
