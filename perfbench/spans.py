"""Per-layer metrics read from the port's own spans (``c2m_tpu_torch.trace``).

The port records its spans only while torch.profiler records, so in a
``--trace 1`` run they cover the profiled requests or steps and nothing
else; the profiler slows the host there, so host times read high. A value
is the mean per unit (a ``c2m.serve.request`` or ``c2m.train.step`` span)
over those units. A port without the ``trace`` module, or a run that
recorded no such span, reads None.
"""

from __future__ import annotations

from typing import Optional

UNIT_SPANS = {"serve": "c2m.serve.request", "train": "c2m.train.step"}


def mean_per_unit(run, kind: str, name: str, field: str) -> Optional[float]:
    """The sum of ``field`` (``"device_ms"`` or ``"host_ms"``) over the
    spans named ``name`` inside the run's units, over the count of units;
    None outside cells of ``kind`` or where the spans hold no such value."""
    if run.kind != kind:
        return None
    try:
        from c2m_tpu_torch import trace
    except ImportError:
        return None
    spans = trace.records()
    units = {s.id for s in spans if s.name == UNIT_SPANS[kind]}
    values = [getattr(s, field) for s in spans
              if s.name == name and s.unit in units]
    if not units or not values or any(v is None for v in values):
        return None
    return sum(values) / len(units)
