"""The port's spans (``c2m_tpu_torch.trace``): off outside a profiler, and
under one nested by parent and unit, on the profiler's own timeline,
bounded; one request of ``ServingModel`` and one ``train_step`` give their
phases and the model's stages, on the CPU at 64x128 with shrunk widths.

The tests marked ``cuda`` check the device intervals, and that served
outputs come back in page-locked memory, on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_trace.py``
(this file imports nothing of JAX).
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from c2m_tpu_torch import config as pconfig
from c2m_tpu_torch import trace
from c2m_tpu_torch.data.synthetic import make_batch
from c2m_tpu_torch.models.c2m import C2MGenerator
from c2m_tpu_torch.serving import ServingModel, z_dim
from c2m_tpu_torch.train.state import create_train_state
from c2m_tpu_torch.train.step import make_train_step

SERVE_PHASES = ["c2m.serve.prepare", "c2m.serve.h2d", "c2m.serve.inference",
                "c2m.serve.output"]
INFERENCE_STAGES = ["c2m.model.appearance", "c2m.model.gnn",
                    "c2m.model.raster.k2", "c2m.model.dense_motion",
                    "c2m.model.generator"]
STEP_PHASES = ["c2m.train.draws", "c2m.train.forward", "c2m.train.backward",
               "c2m.train.optimizer"]
FORWARD_PARTS = ["c2m.model.appearance", "c2m.model.motion_encoder",
                 "c2m.model.gnn", "c2m.model.raster.k2",
                 "c2m.model.dense_motion", "c2m.model.generator",
                 "c2m.train.losses", "c2m.train.netd_image",
                 "c2m.train.netd_video"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tiny_cfg():
    cfg = pconfig.shrink_model(pconfig.tiny_config(batch_size=2), 8, 32)
    cfg.train_params.dtype = "float32"
    cfg.train_params.loss_weights.perceptual = 0.0
    return cfg


def children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_off_outside_a_profiler():
    trace.clear()
    assert trace.span("a") is trace.span("b")
    for _ in range(1000):
        with trace.span("c2m.test.off"):
            pass
    assert trace.records() == [] and trace.dropped() == 0


def test_nested_spans_on_the_profiler_timeline():
    trace.clear()
    with cpu_profile() as prof:
        with trace.span("c2m.test.unit"):
            with trace.span("c2m.test.outer"):
                with trace.span("c2m.test.inner"):
                    torch.ones(8).add_(1.0)
            with trace.span("c2m.test.second"):
                pass
        with trace.span("c2m.test.next_unit"):
            pass
    spans = {s.name: s for s in trace.records()}
    unit, outer, inner = (spans["c2m.test.unit"], spans["c2m.test.outer"],
                          spans["c2m.test.inner"])
    assert unit.parent is None and unit.unit == unit.id
    assert outer.parent == unit.id and outer.unit == unit.id
    assert inner.parent == outer.id and inner.unit == unit.id
    assert spans["c2m.test.second"].parent == unit.id
    nxt = spans["c2m.test.next_unit"]
    assert nxt.parent is None and nxt.unit == nxt.id != unit.id
    assert [s.name for s in trace.records()] == [
        "c2m.test.unit", "c2m.test.outer", "c2m.test.inner",
        "c2m.test.second", "c2m.test.next_unit"]
    for s in spans.values():
        assert s.device_ms is None
    assert unit.start_ns <= outer.start_ns <= inner.start_ns
    assert inner.end_ns <= outer.end_ns <= unit.end_ns
    assert inner.host_ms <= outer.host_ms <= unit.host_ms

    # the profiler's own events: every span, and the inner one around its
    # own aten op
    events = prof.events()
    by_name = {e.name: e for e in events}
    for name in spans:
        assert name in by_name, name
    box = by_name["c2m.test.inner"].time_range
    adds = [e.time_range for e in events if e.name == "aten::add_"]
    assert adds and all(box.start <= a.start and a.end <= box.end
                        for a in adds)


def test_a_thread_the_profiler_does_not_record_records_no_span():
    def work():
        with trace.span("c2m.test.thread"):
            pass

    trace.clear()
    with cpu_profile():
        with trace.span("c2m.test.main"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    assert [s.name for s in trace.records()] == ["c2m.test.main"]


def test_buffer_bound_drops_the_oldest_and_counts():
    rec = trace.Recorder(limit=3)
    with cpu_profile():
        for i in range(5):
            with rec.span(f"c2m.test.{i}"):
                pass
    assert [s.name for s in rec.records()] == [
        "c2m.test.2", "c2m.test.3", "c2m.test.4"]
    assert rec.dropped == 2
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0


def request(cfg, bs, seed):
    """(batch, latent, clicks) of one request, as numpy arrays."""
    batch = make_batch(cfg, batch_size=bs, seed=seed, device="cpu")
    z = torch.randn(bs, z_dim(cfg),
                    generator=torch.Generator().manual_seed(seed)).numpy()
    return batch, z, batch["node_mask"].astype("float32")


def test_serving_request_spans():
    cfg = tiny_cfg()
    torch.manual_seed(0)
    server = ServingModel(C2MGenerator(cfg), batch_sizes=(1, 2))
    first, one, two = (request(cfg, 2, 1), request(cfg, 1, 2),
                       request(cfg, 2, 3))
    trace.clear()
    server(*first)
    assert trace.records() == []
    with cpu_profile():
        server(*one)
        server(*two)
    spans = trace.records()
    requests = [s for s in spans if s.name == "c2m.serve.request"]
    assert len(requests) == 2
    for req in requests:
        assert req.parent is None
        assert children(spans, req) == SERVE_PHASES
        inference = next(s for s in spans if s.parent == req.id
                         and s.name == "c2m.serve.inference")
        assert children(spans, inference) == INFERENCE_STAGES
        for s in spans:
            if s.unit == req.id and s is not req:
                assert s.host_ms <= req.host_ms
    assert {s.unit for s in spans} == {r.id for r in requests}


def test_serving_output_counts_pageable_bytes():
    cfg = tiny_cfg()
    torch.manual_seed(0)
    server = ServingModel(C2MGenerator(cfg), batch_sizes=(1, 2))
    trace.clear()
    with cpu_profile():
        out = server(*request(cfg, 1, 4))
    spans = [s for s in trace.records() if s.name == "c2m.serve.output"]
    assert len(spans) == 1
    assert spans[0].counts == {
        "pinned_bytes": 0,
        "pageable_bytes": sum(a.nbytes for a in out.values())}
    assert all(a.shape[0] == 1 for a in out.values())


def test_train_step_spans():
    cfg = tiny_cfg()
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg)
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch(cfg, seed=5, device="cpu").items()}
    trace.clear()
    with cpu_profile():
        metrics = step(state, batch)
    assert torch.isfinite(metrics["total_gen"])
    spans = trace.records()
    steps = [s for s in spans if s.name == "c2m.train.step"]
    assert len(steps) == 1
    unit = steps[0]
    assert children(spans, unit) == STEP_PHASES
    forward = next(s for s in spans if s.name == "c2m.train.forward")
    assert children(spans, forward) == FORWARD_PARTS
    for s in spans:
        assert s.unit == unit.id and s.device_ms is None
        assert s.host_ms <= unit.host_ms
    phases = [s for s in spans if s.parent == unit.id]
    assert sum(s.host_ms for s in phases) <= unit.host_ms


@pytest.mark.cuda
def test_device_intervals_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device intervals are "
                    "CUDA events")
    cfg = tiny_cfg()
    dev = torch.device("cuda")
    state = create_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             make_batch(cfg, seed=5, device=dev).items()}
    step(state, batch)
    server = ServingModel(state.model.c2m, batch_sizes=(2,))
    served = request(cfg, 2, 1)
    server(*served)
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step(state, batch)
        server(*served)
    spans = trace.records()
    for s in spans:
        assert s.device_ms is not None and s.device_ms >= 0.0
    unit = next(s for s in spans if s.name == "c2m.train.step")
    phases = [s for s in spans if s.parent == unit.id
              and s.name in STEP_PHASES[1:]]
    assert len(phases) == 3
    assert sum(s.device_ms for s in phases) <= unit.device_ms + 1e-2
    req = next(s for s in spans if s.name == "c2m.serve.request")
    parts = [s for s in spans if s.parent == req.id
             and s.name in ("c2m.serve.inference", "c2m.serve.output")]
    assert len(parts) == 2
    assert sum(s.device_ms for s in parts) <= req.device_ms + 1e-2


@pytest.mark.cuda
def test_served_outputs_land_in_page_locked_memory(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked copies come from the "
                    "card")
    cfg = tiny_cfg()
    torch.manual_seed(0)
    model = C2MGenerator(cfg).to("cuda")
    server = ServingModel(model, batch_sizes=(1, 2))
    produced = []
    real = model.inference

    def inference(*args, **kwargs):
        produced.append(real(*args, **kwargs))
        return produced[-1]
    monkeypatch.setattr(model, "inference", inference)
    for bs in (1, 2):
        first = server(*request(cfg, bs, 1))
        want = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in produced[-1].items()}
        assert sorted(first) == sorted(want)
        for k, a in first.items():
            assert a.dtype == want[k].dtype and a.shape == want[k].shape, k
            assert np.array_equal(a, want[k]), k
            assert a.flags.writeable, k
            assert torch.from_numpy(a).is_pinned(), k
        kept = {k: a.copy() for k, a in first.items()}
        later = [server(*request(cfg, bs, seed)) for seed in (2, 3)]
        assert not np.array_equal(later[-1]["generated"], kept["generated"])
        for k, a in first.items():
            assert np.array_equal(a, kept[k]), k
    trace.clear()
    with cpu_profile():
        out = server(*request(cfg, 2, 4))
    spans = [s for s in trace.records() if s.name == "c2m.serve.output"]
    assert len(spans) == 1
    assert spans[0].counts == {
        "pinned_bytes": sum(a.nbytes for a in out.values()),
        "pageable_bytes": 0}
