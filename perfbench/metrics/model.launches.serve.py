"""Device kernels per traced request, counted in the trace."""

from perfbench import tracing

UNIT = "launches"


def read(run):
    return tracing.launches_per_unit(run) if run.kind == "serve" else None
