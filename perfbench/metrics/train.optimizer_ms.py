"""Device interval of the port's ``c2m.train.optimizer`` span per profiled
step: Adam over the four groups and the schedulers (CUDA events at the
span's edges)."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "train", "c2m.train.optimizer",
                               "device_ms")
