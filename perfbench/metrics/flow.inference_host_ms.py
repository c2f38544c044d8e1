"""Host time inside the port's ``c2m.flow.inference`` span per profiled
request of the flow tool: how long the host takes to queue FlowNet2 and
the confidence. At or above ``flow.inference_ms`` the request is bound by
the host's launches. None in other cells."""

from perfbench import flow_spans

UNIT = "ms"


def read(run):
    return flow_spans.mean_per_request(run, "c2m.flow.inference", "host_ms")
