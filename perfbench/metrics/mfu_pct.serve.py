"""The requested clips' forward FLOPs (the configuration file's count of the
reference's forward per clip) over the time of the requests the traced run
sends after its profiled ones, host clock, and the peak of the precision
the configuration states (float32 with TF32 off: the CUDA cores' 67
TFLOP/s)."""

from perfbench import tracing

UNIT = "%"


def read(run):
    if run.kind != "serve" or run.flops_per_clip is None or not run.after:
        return None
    _, clips, seconds = run.after
    return tracing.mfu_pct(run.flops_per_clip * clips, seconds, run.cell)
