"""Device interval of the port's ``c2m.train.backward`` span per profiled
step: the one ``backward()`` of the combined loss (CUDA events at the
span's edges)."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "train", "c2m.train.backward", "device_ms")
