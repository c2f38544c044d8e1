"""Device interval of the port's ``c2m.serve.inference`` span per profiled
request: the stream's time from the forward's first work to its last,
busy and idle alike (CUDA events at the span's edges)."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "serve", "c2m.serve.inference",
                               "device_ms")
