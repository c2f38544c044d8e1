"""Share of the traced window with no kernel or copy on the device."""

from perfbench import tracing

UNIT = "%"


def read(run):
    return tracing.idle_pct(run) if run.kind == "serve" else None
