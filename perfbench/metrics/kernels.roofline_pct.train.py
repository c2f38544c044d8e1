"""The hand-written kernels' (K1-K4) least time over their device time in
the trace, summed over every launch of the traced steps (``roofline``)."""

from perfbench import tracing

UNIT = "%"


def read(run):
    return tracing.roofline_pct(run) if run.kind == "train" else None
