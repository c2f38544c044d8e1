"""Host time inside the port's ``c2m.serve.inference`` span per profiled
request: how long the host takes to queue the forward. At or above
``serving.inference_ms`` the request is bound by the host's launches."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "serve", "c2m.serve.inference", "host_ms")
