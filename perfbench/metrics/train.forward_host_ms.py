"""Host time inside the port's ``c2m.train.forward`` span per profiled
step: how long the host takes to queue the forward and the losses."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "train", "c2m.train.forward", "host_ms")
