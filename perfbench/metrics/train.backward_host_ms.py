"""Host time inside the port's ``c2m.train.backward`` span per profiled
step: how long the autograd engine takes to queue the backward."""

from perfbench import spans

UNIT = "ms"


def read(run):
    return spans.mean_per_unit(run, "train", "c2m.train.backward", "host_ms")
