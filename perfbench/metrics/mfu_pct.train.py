"""The steps' FLOPs (the configuration file's count of the reference's
forward and backward per clip, times the batch) over their time and the
peak of the precision the configuration states (float32 with TF32 off:
the CUDA cores' 67 TFLOP/s): the steps the traced run takes after its
profiled ones, timed on the host clock to the window's closing synchronise
(the profiler slows the host)."""

from perfbench import tracing

UNIT = "%"


def read(run):
    if run.kind != "train" or run.flops_per_step is None or not run.after:
        return None
    steps, _, seconds = run.after
    return tracing.mfu_pct(run.flops_per_step * steps, seconds, run.cell)
