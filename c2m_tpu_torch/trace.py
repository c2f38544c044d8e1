"""Spans of the port's phases, on the profiler's clock.

A span names one phase of a serving request, a train step or the model
(``c2m.serve.request``, ``c2m.train.backward``, ``c2m.model.gnn``, ...).
Spans are on only while a ``torch.profiler`` records on the calling thread
(``torch.autograd._profiler_enabled()``); the profiler being on is the one
switch. Outside a profiler :func:`span` returns one shared no-op context
and records nothing.

Under a profiler each span
- enters ``torch.profiler.record_function(name)``, so the profiler's
  timeline, and every chrome trace exported from it, shows the span around
  its own ops, kernels and idle gaps;
- appends one record to a bounded buffer in memory: its name, its id, the
  id of the innermost span open on this thread when it opened (its
  parent), the id of the outermost one (its unit: every span of one
  request or step shares it), and its host start and end
  (``time.perf_counter_ns``);
- where CUDA is initialised, records a timing event on the current stream
  at its entry and at its exit.

:func:`count` adds a counted value (bytes a pass must move, say) to the
innermost span open on the calling thread; with no span open, as outside
a profiler, it does nothing.

:func:`records` resolves the events once the work is done, so nothing
synchronises while spans are recorded. A record's ``device_ms`` is the
current stream's interval between the span's two events: the time from
the stream reaching the span's start to it reaching the span's end, busy
and idle alike (kernels queued before the span that are still running when
it opens are not in it; work on another stream is in it only where that
stream joins the current one before the span ends, as cuDNN's do). It is
None on the CPU. ``host_ms`` is the host's time inside
the span; the stream runs behind the host, so the two may differ either way.

The buffer holds the newest :data:`MAX_RECORDS` spans and counts the ones
it dropped. It is the process's, as the profiler is: :func:`clear` empties
it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_RECORDS = 10_000

_OFF = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span (:func:`records`)."""
    name: str
    id: int
    parent: Optional[int]         # None for a unit
    unit: int                     # the outermost span's id (own for a unit)
    start_ns: int                 # host, time.perf_counter_ns
    end_ns: int
    device_ms: Optional[float]    # None where CUDA is not in use
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Open:
    """A span while it runs (under a profiler)."""
    __slots__ = ("recorder", "name", "id", "parent", "unit", "function",
                 "events", "start_ns", "end_ns", "device_ms", "counts")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder, self.name = recorder, name
        self.id = next(recorder._ids)
        self.events = None
        self.counts: Dict[str, float] = {}
        self.end_ns = self.device_ms = None

    def __enter__(self):
        rec = self.recorder
        stack = rec._stack()
        self.parent = stack[-1].id if stack else None
        self.unit = stack[0].id if stack else self.id
        stack.append(self)
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        rec._append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.function.__exit__(*exc)
        self.recorder._stack().pop()
        return False

    def resolve(self) -> Span:
        if self.events is not None:
            self.events[1].synchronize()
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None
        return Span(self.name, self.id, self.parent, self.unit,
                    self.start_ns, self.end_ns, self.device_ms,
                    dict(self.counts))


class Recorder:
    """A bounded buffer of spans: the module's functions use one for the
    process; a test may make its own."""

    def __init__(self, limit: int = MAX_RECORDS):
        self._buffer = collections.deque()
        self._limit = int(limit)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, span: _Open) -> None:
        if len(self._buffer) >= self._limit:
            self._buffer.popleft()
            self.dropped += 1
        self._buffer.append(span)

    def span(self, name: str):
        """A context manager for one span named ``name``; the shared no-op
        context when no profiler records."""
        if not torch.autograd._profiler_enabled():
            return _OFF
        return _Open(self, name)

    def count(self, key: str, value: float) -> None:
        """Adds ``value`` to ``key`` of the innermost span open on this
        thread; nothing when none is open."""
        stack = self._stack()
        if stack:
            counts = stack[-1].counts
            counts[key] = counts.get(key, 0) + value

    def records(self) -> List[Span]:
        """Every closed span in the buffer, oldest first, with its device
        interval resolved (this waits for the spans' work to finish)."""
        return [s.resolve() for s in list(self._buffer)
                if s.end_ns is not None]

    def clear(self) -> None:
        self._buffer.clear()
        self.dropped = 0


_RECORDER = Recorder()


def span(name: str):
    """A span named ``name`` in the process's buffer (module docstring)."""
    return _RECORDER.span(name)


def count(key: str, value: float) -> None:
    """Adds ``value`` to ``key`` of the innermost span open on the calling
    thread (module docstring)."""
    _RECORDER.count(key, value)


def records() -> List[Span]:
    """The process's closed spans, oldest first (:meth:`Recorder.records`)."""
    return _RECORDER.records()


def dropped() -> int:
    """Spans the process's buffer dropped for want of room."""
    return _RECORDER.dropped


def clear() -> None:
    """Empty the process's buffer."""
    _RECORDER.clear()
