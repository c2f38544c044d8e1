"""Device kernels per traced step, counted in the trace."""

from perfbench import tracing

UNIT = "launches"


def read(run):
    return tracing.launches_per_unit(run) if run.kind == "train" else None
