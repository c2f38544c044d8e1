"""Device interval of the port's ``c2m.train.forward`` span per profiled
step: the model's forward, the losses and the discriminators (CUDA events
at the span's edges)."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "train", "c2m.train.forward", "device_ms")
