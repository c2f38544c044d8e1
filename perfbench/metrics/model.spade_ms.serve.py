"""Device interval of the port's ``c2m.model.spade`` span per profiled
request: the SPADE generator's up blocks with their resizes, busy and idle
alike (CUDA events at the span's edges). None in a cell whose generator
has no SPADE blocks."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "serve", "c2m.model.spade", "device_ms")
