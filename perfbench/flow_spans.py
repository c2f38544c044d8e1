"""Per-layer metrics of the FlowNet2 precompute cell, read from the port's
own spans (``c2m_tpu_torch.trace``).

As ``spans.py``, but the unit is the flow tool's request,
``c2m.flow.request`` (``tools/precompute_flow.batch_flows``): a value is
the mean per profiled request. Outside such a cell, in a port without the
``trace`` module or without these spans, and where a span lacks its device
interval or its counts (the CPU, a port that counts nothing), a reader
reads None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

UNIT_SPAN = "c2m.flow.request"


def spans_in_requests(run, name: str) -> Optional[Tuple[List, int]]:
    """(the spans named ``name`` inside profiled requests, the count of
    requests); None outside serve-kind cells or without a request span."""
    if run.kind != "serve":
        return None
    try:
        from c2m_tpu_torch import trace
    except ImportError:
        return None
    records = trace.records()
    units = {s.id for s in records if s.name == UNIT_SPAN}
    if not units:
        return None
    return [s for s in records if s.name == name and s.unit in units], \
        len(units)


def mean_per_request(run, name: str, field: str) -> Optional[float]:
    """The sum of ``field`` (``"device_ms"`` or ``"host_ms"``) over the
    spans named ``name`` inside the profiled requests, over their count."""
    found = spans_in_requests(run, name)
    if found is None:
        return None
    spans, units = found
    values = [getattr(s, field) for s in spans]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / units


def counted(run, name: str, keys) -> Optional[List]:
    """The spans named ``name`` inside the profiled requests, each with a
    device interval and every count of ``keys``; None where one lacks
    either, or where there are none."""
    found = spans_in_requests(run, name)
    if found is None or not found[0]:
        return None
    spans = found[0]
    if any(s.device_ms is None or any(k not in s.counts for k in keys)
           for s in spans):
        return None
    return spans
