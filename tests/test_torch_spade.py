"""The SPADE generator of the port against the benchmark's plain reference
(``perfbench/reference``, a frozen plain-PyTorch copy of the model), and
its spans and counter, on the CPU at 64x128 with shrunk widths.

- one request of ``C2MGenerator.inference`` (click path) and one train
  step of ``C2MTrainModel``, both with the reference's weights
  (``perfbench.weights``), against the reference;
- under ``torch.profiler`` a SPADE request records one
  ``c2m.model.flow_embedder``, one ``c2m.model.spade`` and one
  ``c2m.model.spade.norm`` per ``SpatiallyAdaptiveNorm``, each norm span
  counting the bytes its pass moves; a plain request records none of them,
  and nothing is recorded with the profiler off;
- the three readers of ``journal_spade.serve`` on fabricated spans;
- ``SpatiallyAdaptiveNorm`` with its condition convolved before the norm
  equals the norm-first order bit for bit.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from c2m_tpu_torch import trace
from c2m_tpu_torch.models.c2m import C2MGenerator
from c2m_tpu_torch.models.generator import SpatiallyAdaptiveNorm
from c2m_tpu_torch.serving import ServingModel, z_dim
from c2m_tpu_torch.train.model import C2MTrainModel
from c2m_tpu_torch.train.state import TrainState, build_optimizer
from c2m_tpu_torch.train.step import make_train_step
from perfbench import harness, roofline, scenes, weights
from perfbench.reference.config import shrink_model
from perfbench.reference.config import tiny_config as reference_tiny
from perfbench.reference.models.c2m import C2MGenerator as RefGenerator
from perfbench.reference.train.model import C2MTrainModel as RefTrainModel
from perfbench.reference.train.state import TrainState as RefTrainState
from perfbench.reference.train.state import \
    build_optimizer as ref_build_optimizer
from perfbench.reference.train.step import \
    make_train_step as ref_make_train_step

SEED = 3_000_000_019
SPADE_SPANS = ("c2m.model.flow_embedder", "c2m.model.spade",
               "c2m.model.spade.norm")
READERS = ("model.flow_embedder_ms.serve", "model.spade_ms.serve",
           "model.spade_norm_roofline_pct.serve")


def cell(use_spade=True):
    """A cell dict holding the tiny configuration (64x128, widths 16 to
    128, 4 objects, float32) as a configuration file would."""
    cfg = shrink_model(reference_tiny(max_objects=4, batch_size=2))
    cfg.train_params.dtype = "float32"
    cfg.model_params.generator.use_spade = use_spade
    return {"config_file": {"config": cfg.to_dict()}}


@pytest.fixture(scope="module")
def spade():
    c = cell()
    return harness.program_config(c), harness.reference_config(c)


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


def request(rcfg, size=2):
    """A request's inputs as the serving cell sends them (numpy), a latent
    and one or two clicks a clip."""
    clips = scenes.make_clips(rcfg, [2, 4][:size], 11, with_targets=False,
                              frames=rcfg.train_params.num_input_frames)
    rng = np.random.RandomState(5)
    enc = rcfg.model_params.motion_estimator.dense_motion_encoder
    z = rng.standard_normal(
        (size, enc.out_channel_bg + enc.out_channel_fg)).astype(np.float32)
    click = np.zeros((size, rcfg.dataset_params.max_objects), np.float32)
    click[:, 0] = 1.0
    click[-1, 1] = 1.0
    return clips, z, click


def test_inference_matches_the_reference(spade):
    pcfg, rcfg = spade
    mine = weights.build_on_device(lambda: C2MGenerator(pcfg), SEED,
                                   "cpu").eval()
    ref = weights.build_on_device(lambda: RefGenerator(rcfg), SEED,
                                  "cpu").eval()
    assert hasattr(mine.generator, "flowembedder")
    clips, z, click = request(rcfg)
    batch = {k: torch.from_numpy(v) for k, v in clips.items()}
    args = (torch.from_numpy(z), torch.from_numpy(click))
    with torch.no_grad():
        got = mine.inference(batch, *args, use_gt_eval=False)
        want = ref.inference(batch, *args, use_gt_eval=False)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if not w.is_floating_point():
            assert torch.equal(g, w), k
            continue
        # both compute in float32 on the CPU with the same operations; the
        # port's kernels take their plain versions here, which agree with
        # the reference's to float32 rounding, far under 1e-5
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 1e-5 * scale, k


def test_one_train_step_matches_the_reference(spade):
    pcfg, rcfg = spade
    clips = scenes.make_clips(rcfg, [1, 3], 13, with_targets=True)
    rng = np.random.RandomState(7)
    enc = rcfg.model_params.motion_estimator.dense_motion_encoder
    eps = torch.from_numpy(rng.standard_normal(
        (2, enc.out_channel_bg + enc.out_channel_fg)).astype(np.float32))
    click = torch.zeros(2, rcfg.dataset_params.max_objects)
    click[0, 0] = click[1, 2] = 1.0

    def step(model_cls, state_cls, optimizer, make_step, cfg):
        model = weights.build_on_device(lambda: model_cls(cfg), SEED,
                                        "cpu").train()
        state = state_cls(model, *optimizer(cfg, model), torch.Generator())
        batch = {k: torch.from_numpy(v) for k, v in clips.items()}
        metrics = make_step(cfg)(state, batch, eps, click)
        grads = {n: float(torch.linalg.vector_norm(p.grad.double()))
                 for n, p in model.named_parameters() if p.grad is not None}
        return {k: float(v) for k, v in metrics.items()}, grads

    got, got_grads = step(C2MTrainModel, TrainState, build_optimizer,
                          make_train_step, pcfg)
    want, want_grads = step(RefTrainModel, RefTrainState,
                            ref_build_optimizer, ref_make_train_step, rcfg)
    assert any(".flowembedder." in n for n in want_grads)
    assert set(got) == set(want)
    # the same float32 operations in the same order on the CPU: the losses
    # agree to float32 rounding of sums over the batch (1e-5 relative)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-5, abs=1e-6), k
    assert set(got_grads) == set(want_grads)
    # a gradient norm sums rounding over every element of the backward;
    # 1e-4 relative is a tenth of what TF32 would leave (section 6 of
    # PERF.md: the worst leaf reads 0.025 under TF32 at full size)
    for n, w in want_grads.items():
        assert got_grads[n] == pytest.approx(w, rel=1e-4, abs=1e-7), n


def spade_norms(model):
    return [m for m in model.modules()
            if isinstance(m, SpatiallyAdaptiveNorm)]


def serve_traced(pcfg, rcfg, profiled=True):
    """One 2-clip request through ``ServingModel`` (under a CPU profiler
    when ``profiled``), with each SPADE norm's least bytes taken from its
    input, its condition's gamma_beta and its output by hooks; returns
    (spans, those bytes in call order, the model)."""
    model = weights.build_on_device(lambda: C2MGenerator(pcfg), SEED, "cpu")
    server = ServingModel(model, (2,), use_gt_eval=False)
    expected, hooks = [], []
    for norm in spade_norms(model):
        seen = {}
        hooks.append(norm.gamma_beta.register_forward_hook(
            lambda m, a, out, seen=seen: seen.update(gb=out.numel())))
        hooks.append(norm.register_forward_hook(
            lambda m, a, out, seen=seen: expected.append(
                4 * (a[0].numel() + seen["gb"] + out.numel()))))
    clips, z, click = request(rcfg)
    assert z.shape[1] == z_dim(pcfg)
    trace.clear()
    try:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                server(clips, z, click)
        else:
            server(clips, z, click)
    finally:
        for h in hooks:
            h.remove()
    spans = trace.records()
    trace.clear()
    return spans, expected, model


def test_a_spade_request_records_its_spans_and_bytes(spade):
    pcfg, rcfg = spade
    spans, expected, model = serve_traced(pcfg, rcfg)
    by_id = {s.id: s for s in spans}

    def inside(s, name):
        while s.parent is not None:
            s = by_id[s.parent]
            if s.name == name:
                return True
        return False

    named = {n: [s for s in spans if s.name == n] for n in SPADE_SPANS}
    assert len(named["c2m.model.flow_embedder"]) == 1
    assert len(named["c2m.model.spade"]) == 1
    norms = named["c2m.model.spade.norm"]
    # three up blocks, each changing width: norm1, norm2 and norm_s
    assert len(norms) == len(spade_norms(model)) == 9
    for s in [*named["c2m.model.flow_embedder"], *named["c2m.model.spade"]]:
        assert inside(s, "c2m.model.generator")
    for s in norms:
        assert inside(s, "c2m.model.spade")
        assert inside(s, "c2m.model.generator")
        assert s.device_ms is None     # the CPU has no device interval
    assert [s.counts["bytes"] for s in norms] == expected
    # besides the norms, only the request's output copies count anything
    output = [s for s in spans if s.name == "c2m.serve.output"]
    assert len(output) == 1
    assert set(output[0].counts) == {"pinned_bytes", "pageable_bytes"}
    assert all(s.counts == {} for s in spans
               if s.name not in ("c2m.model.spade.norm", "c2m.serve.output"))


def test_a_plain_request_records_none_of_them():
    c = cell(use_spade=False)
    spans, expected, model = serve_traced(harness.program_config(c),
                                          harness.reference_config(c))
    assert expected == [] and not spade_norms(model)
    assert any(s.name == "c2m.model.generator" for s in spans)
    assert not [s for s in spans if s.name in SPADE_SPANS]


def test_nothing_is_recorded_with_the_profiler_off(spade):
    spans, expected, _ = serve_traced(*spade, profiled=False)
    assert spans == [] and len(expected) == 9
    trace.count("bytes", 1)         # no span open: nothing to add to
    assert trace.records() == []


def fabricated():
    """Two serve units (ids 1 and 20): the first with the embedder, the
    decoder and two norms, the second with one of each; one norm outside
    any unit. Device 3 ms, host 2 ms a span; norms count 6.7e9 bytes."""
    spans = []

    def add(name, id_, parent, unit, counts=None):
        spans.append(trace.Span(name, id_, parent, unit, 0, 2_000_000, 3.0,
                                counts or {}))

    for unit, norms in ((1, 2), (20, 1)):
        add("c2m.serve.request", unit, None, unit)
        add("c2m.model.flow_embedder", unit + 1, unit, unit)
        add("c2m.model.spade", unit + 2, unit, unit)
        for i in range(norms):
            add("c2m.model.spade.norm", unit + 3 + i, unit + 2, unit,
                {"bytes": 6.7e9})
    add("c2m.model.spade.norm", 40, None, 40, {"bytes": 1.0})
    return spans


def readers():
    found = harness.metric_readers()
    return {name: found[name][0] for name in READERS}


def test_the_readers_on_fabricated_spans(monkeypatch):
    monkeypatch.setattr(trace, "records", fabricated)
    read = readers()
    serve = types.SimpleNamespace(kind="serve")
    # one span of 3 ms in each of two units
    assert read["model.flow_embedder_ms.serve"](serve) == pytest.approx(3.0)
    assert read["model.spade_ms.serve"](serve) == pytest.approx(3.0)
    # three norms in units: 3 x 6.7e9 bytes at 3.35e12 B/s is 6 ms of
    # bound over 9 ms of intervals; the stray norm is left out
    want = 100.0 * (3 * 6.7e9 / roofline.HBM_BYTES_PER_S) / 9e-3
    assert want == pytest.approx(66.6667, rel=1e-4)
    assert read["model.spade_norm_roofline_pct.serve"](serve) == \
        pytest.approx(want)
    train = types.SimpleNamespace(kind="train")
    assert all(r(train) is None for r in read.values())


def test_the_readers_read_none_without_spade_spans(monkeypatch):
    serve = types.SimpleNamespace(kind="serve")
    plain = [s for s in fabricated()
             if s.name not in SPADE_SPANS]
    monkeypatch.setattr(trace, "records", lambda: plain)
    assert all(r(serve) is None for r in readers().values())
    # the CPU's spans have no device interval; a port that counts nothing
    # leaves the share without bytes
    no_device = [trace.Span(s.name, s.id, s.parent, s.unit, s.start_ns,
                            s.end_ns, None, s.counts) for s in fabricated()]
    monkeypatch.setattr(trace, "records", lambda: no_device)
    assert all(r(serve) is None for r in readers().values())
    uncounted = [trace.Span(s.name, s.id, s.parent, s.unit, s.start_ns,
                            s.end_ns, s.device_ms) for s in fabricated()]
    monkeypatch.setattr(trace, "records", lambda: uncounted)
    assert readers()["model.spade_norm_roofline_pct.serve"](serve) is None


def test_conditions_first_equals_the_norm_first_order():
    torch.manual_seed(3)
    norm = SpatiallyAdaptiveNorm(8, 6, num_filters=16)
    for p in norm.parameters():
        p.data.uniform_(-0.5, 0.5)
    x = torch.randn(2, 8, 16, 8)
    for cond in (torch.randn(2, 8, 16, 6), torch.randn(2, 4, 8, 6)):
        got = norm(x, cond)
        c = cond
        if c.shape[1:3] != x.shape[1:3]:
            from c2m_tpu_torch.ops.warp import resize_nearest
            c = resize_nearest(c, x.shape[1:3])
        out = norm.norm(x)
        gamma, beta = norm.gamma_beta(norm.mlp(c)).chunk(2, dim=-1)
        assert torch.equal(got, out * (1.0 + gamma) + beta)
