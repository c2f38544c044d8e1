"""The readers of the port's spans: None in the other kind's cells, without
spans and without the port's ``trace`` module; the mean per unit of a
fabricated span list; and on the tiny cells' traced run on the CPU, where
the profiler records the host alone, a number from each host-time reader
and None from each device-time reader."""

import sys
import types

import pytest
from conftest import run_cell

from c2m_tpu_torch import trace
from perfbench import harness

# reader -> (cell kind, span, field)
READERS = {
    "serving.inference_ms": ("serve", "c2m.serve.inference", "device_ms"),
    "serving.inference_host_ms": ("serve", "c2m.serve.inference",
                                  "host_ms"),
    "serving.output_ms": ("serve", "c2m.serve.output", "device_ms"),
    "train.forward_ms": ("train", "c2m.train.forward", "device_ms"),
    "train.backward_ms": ("train", "c2m.train.backward", "device_ms"),
    "train.optimizer_ms": ("train", "c2m.train.optimizer", "device_ms"),
    "train.forward_host_ms": ("train", "c2m.train.forward", "host_ms"),
    "train.backward_host_ms": ("train", "c2m.train.backward", "host_ms"),
}
UNIT = {"serve": "c2m.serve.request", "train": "c2m.train.step"}


def readers():
    found = harness.metric_readers()
    return {name: found[name][0] for name in READERS}


def fabricated(kind):
    """Two units of ``kind`` (ids 1 and 10), every phase span twice in the
    first and once in the second (host 2 ms, device 3 ms each), and one
    stray phase span outside any unit."""
    spans = []

    def add(name, id_, parent, unit):
        spans.append(trace.Span(name, id_, parent, unit, 0, 2_000_000, 3.0))

    phases = sorted({n for k, n, _ in READERS.values() if k == kind})
    add(UNIT[kind], 1, None, 1)
    for i, name in enumerate(phases):
        add(name, 2 + 2 * i, 1, 1)
        add(name, 3 + 2 * i, 1, 1)
    add(UNIT[kind], 10, None, 10)
    for i, name in enumerate(phases):
        add(name, 11 + i, 10, 10)
    for i, name in enumerate(phases):
        add(name, 20 + i, None, 20 + i)
    return spans


def test_other_kind_and_no_spans_read_none():
    trace.clear()
    for name, read in readers().items():
        kind = READERS[name][0]
        other = "train" if kind == "serve" else "serve"
        assert read(types.SimpleNamespace(kind=other)) is None, name
        assert read(types.SimpleNamespace(kind=kind)) is None, name


def test_a_port_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "c2m_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["c2m_tpu_torch"], "trace")
    for name, read in readers().items():
        assert read(types.SimpleNamespace(kind=READERS[name][0])) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_mean_per_unit_of_fabricated_spans(monkeypatch, kind):
    monkeypatch.setattr(trace, "records", lambda: fabricated(kind))
    run = types.SimpleNamespace(kind=kind)
    for name, read in readers().items():
        if READERS[name][0] != kind:
            continue
        # three spans in two units: 3 x 2 ms or 3 x 3 ms over 2
        want = 3.0 if READERS[name][2] == "host_ms" else 4.5
        assert read(run) == pytest.approx(want), name


@pytest.mark.parametrize("cell,kind", [("tiny.serve", "serve"),
                                       ("tiny.train", "train")])
def test_traced_cpu_run_reads_host_times(tiny_base, capsys, cell, kind):
    trace.clear()
    rc, result = run_cell(tiny_base, cell, trace=1, capsys=capsys)
    assert rc == 0 and result["correct"] is True
    for name, (k, _, field) in READERS.items():
        if k == kind and field == "host_ms":
            assert result["metrics"][name]["value"] > 0, name
        else:
            assert name not in result["metrics"], name
    trace.clear()
