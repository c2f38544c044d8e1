"""Device interval of the port's ``c2m.serve.output`` span per profiled
request: from the end of the forward on the device to the last output
copied to the host (CUDA events at the span's edges)."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "serve", "c2m.serve.output", "device_ms")
