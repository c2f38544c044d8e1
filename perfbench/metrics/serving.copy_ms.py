"""Device time of host-to-device and device-to-host copies per traced
request, from the trace's memcpy events."""

UNIT = "ms"


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    us = sum(c.end - c.start for c in run.trace.copies
             if c.name.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    return us / 1e3 / run.trace.units
