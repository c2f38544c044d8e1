"""FlowNet2 as the benchmark runs it (configuration ``journal_flownet2``,
cell ``journal_flownet2.precompute``), on the CPU, in float32, on seeded
weights from ``perfbench.weights`` (the same names and shapes give the port
and the plain reference the same values):

- the port's sub-networks and its whole stack through
  ``compute_flow_and_conf`` against the plain reference
  (``perfbench/reference/models/flownet2.py``);
- ``tools/precompute_flow.batch_flows`` on two clips against each frame
  pair on its own (``clip_flows``), output by output, and the tool's main
  loop over runs of ``batch_size`` clips writing every file it wrote a
  clip at a time, the same files when a run is split into calls under
  ``PAIR_PIXELS_PER_CALL``;
- the spans and counters the entry and the model record under a profiler,
  and nothing without one;
- the six readers of the cell on fabricated spans, and None elsewhere;
- the new reference, traffic and reader files importing nothing of JAX,
  and the reference nothing of the port.

Gates. The port runs its convolutions on channels-last inputs and the
reference on NCHW ones (``F.conv2d`` sums in another order), through some
25 layers a sub-network: a sub-network's output and the whole stack's flow
are held at 2e-5 of their largest reference value (read: 1e-6 to 2.3e-6).
The confidence is a forward splat of the flow whose masses, each up to
four bilinear weights of a moving point, are summed in another order by
each side's plain splat: 1e-4 absolute on values in [0, 1] (read: 1.05e-5).
A batch of pairs against each pair alone runs the same operations at
another batch size, whose CPU convolutions block the sums otherwise:
the same gates.
"""

import ast
import os
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from c2m_tpu_torch import trace
from c2m_tpu_torch.config import shrink_model, tiny_config
from c2m_tpu_torch.data.cityscapes import load_image, shift_frame_index
from c2m_tpu_torch.data.flow_io import read_flow
from c2m_tpu_torch.models import flownet2 as port_fn
from c2m_tpu_torch.tools import precompute_flow as pflow
from perfbench import harness, roofline, weights
from perfbench.reference.models import flownet2 as ref_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3_100_000_019
FLOW_GATE = 2e-5       # of the largest reference value
CONF_GATE = 1e-4       # absolute
SUBNETS = [("flownetc", 6, 16), ("flownets_1", 12, 16),
           ("flownets_2", 12, 16), ("flownets_d", 6, 16),
           ("flownetfusion", 11, 64)]
FLOW_SPANS = ("c2m.flow.request", "c2m.flow.h2d", "c2m.flow.inference",
              "c2m.flow.conf", "c2m.flow.output")
NET_SPANS = ("c2m.flownet.c", "c2m.flownet.s1", "c2m.flownet.s2",
             "c2m.flownet.sd", "c2m.flownet.fusion")
READERS = ("flow.inference_ms", "flow.inference_host_ms", "flow.output_ms",
           "model.flownet_deconv_ms", "model.flownet_correlation_roofline_pct",
           "model.flownet_warp_roofline_pct")


@pytest.fixture(scope="module")
def nets():
    port = weights.build_on_device(port_fn.FlowNet2, SEED, "cpu")
    ref = weights.build_on_device(ref_fn.FlowNet2, SEED, "cpu")
    return port.eval().requires_grad_(False), ref.eval()


def frames(rng, *shape):
    """Frames in [0, 1] of smooth content: low-frequency sinusoids."""
    *lead, h, w, _ = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros(shape, np.float32)
    for idx in np.ndindex(*lead, 3):
        fy, fx, ph = rng.rand(3) * (0.3, 0.3, 6.0)
        out[idx[:-1] + (..., idx[-1])] = 0.5 + 0.4 * np.sin(ys * fy + xs * fx
                                                             + ph)
    return out


def close(got, want, gate=FLOW_GATE):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.isfinite(want).all() and scale > 0
    assert np.abs(got - want).max() <= gate * scale


def conf_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CONF_GATE


@pytest.mark.parametrize("name,channels,side", SUBNETS,
                         ids=[s[0] for s in SUBNETS])
def test_subnetwork_matches_the_reference(nets, name, channels, side):
    port, ref = nets
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 64, 64, channels).astype(np.float32))
    with torch.no_grad():
        got = getattr(port, name)(x)
        want = getattr(ref, name)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, side, side, 2)
    close(got, want)


def test_whole_stack_matches_the_reference(nets):
    port, ref = nets
    rng = np.random.RandomState(2)
    a = torch.from_numpy(frames(rng, 2, 64, 128, 3))
    b = torch.from_numpy(frames(rng, 2, 64, 128, 3))
    with torch.no_grad():
        flow, conf = port_fn.compute_flow_and_conf(port, a, b)
        want_flow, want_conf = ref_fn.compute_flow_and_conf(ref, a, b)
    assert flow.shape == (2, 64, 128, 2) and conf.shape == (2, 64, 128, 1)
    close(flow, want_flow)
    conf_close(conf, want_conf)
    assert 0.0 <= float(conf.min()) and float(conf.max()) <= 1.0


def test_batch_flows_against_each_pair_alone(nets):
    port, _ = nets
    clips = frames(np.random.RandomState(3), 2, 3, 64, 64, 3)
    got = pflow.batch_flows(port, clips, 1)
    assert set(got) == {"bw_of", "fw_of", "bw_occ", "fw_occ"}
    for kind in ("bw", "fw"):
        assert got[f"{kind}_of"].shape == (2, 2, 64, 64, 2)
        assert got[f"{kind}_occ"].shape == (2, 2, 64, 64)
        assert got[f"{kind}_of"].dtype == np.float32
    for c in range(2):
        one = [torch.from_numpy(f)[None] for f in clips[c]]
        for i, kind, flow, conf in pflow.clip_flows(port, one, 1):
            close(got[f"{kind}_of"][c, i - 1], flow)
            conf_close(got[f"{kind}_occ"][c, i - 1], conf)
    # each occlusion is its own pair's: the backward pair (frame 1, frame 0)
    # is not the forward pair (frame 0, frame 1)
    assert not np.array_equal(got["bw_occ"], got["fw_occ"])


class StandIn(torch.nn.Module):
    """A net whose flow for each pair is an elementwise function of the
    pair alone, so batching leaves it bit for bit."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(3.0))

    def forward(self, im1, im2):
        return (im2 - im1)[..., :2] * self.scale + im1[..., 2:3]


def tiny_dataset(tmp_path):
    """Three clips of random 64x64 frames under ``tmp_path`` and a tiny
    config reading them in runs of two -> (config YAML, config, names)."""
    cfg = shrink_model(tiny_config(h=64, w=64, num_predicted=2))
    cfg.train_params.batch_size = 2
    dp = cfg.dataset_params
    dp.root = str(tmp_path)
    dp.train_images_path = "images"
    for kind in ("bw", "fw"):
        setattr(dp, f"train_{kind}_of_path", f"{kind}_of")
        setattr(dp, f"train_{kind}_occ_path", f"{kind}_occ")
    t = cfg.train_params.num_frames
    rng = np.random.RandomState(4)
    names = [f"town/town_{k:06d}_000010_leftImg8bit.png" for k in range(3)]
    for name in names:
        for i in range(t):
            path = tmp_path / "images" / shift_frame_index(name, i)
            os.makedirs(path.parent, exist_ok=True)
            Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(
                path)
    (tmp_path / dp.train_data_list).write_text("\n".join(names) + "\n")
    yml = tmp_path / "tiny.yaml"
    yml.write_text(yaml.safe_dump(cfg.to_dict()))
    return str(yml), cfg, names


def written_files(root):
    """{path under ``root``: bytes} of every flow and occlusion file."""
    out = {}
    for kind in ("bw_of", "fw_of", "bw_occ", "fw_occ"):
        for path in sorted((root / kind).rglob("*")):
            if path.is_file():
                out[str(path.relative_to(root))] = path.read_bytes()
    return out


def test_the_tool_writes_every_run_of_clips(tmp_path, monkeypatch):
    """Three clips in runs of two: every file of every clip, equal to the
    stand-in's pairs one at a time."""
    yml, cfg, names = tiny_dataset(tmp_path)
    dp, t = cfg.dataset_params, cfg.train_params.num_frames
    model = StandIn()
    monkeypatch.setattr(pflow, "OnTheFlyFlow",
                        lambda *a, **k: types.SimpleNamespace(model=model))
    assert pflow.main(["--config", yml, "--device", "cpu"]) == 0

    for name in names:
        clip = [torch.from_numpy(load_image(
            str(tmp_path / "images" / shift_frame_index(name, i)),
            (64, 64)))[None] for i in range(t)]
        for i, kind, flow, conf in pflow.clip_flows(model, clip, 1):
            stem = name[:-15]
            of = read_flow(str(tmp_path / f"{kind}_of" / shift_frame_index(
                stem + getattr(dp, f"{kind}_of_suffix"), i)))
            occ = np.array(Image.open(tmp_path / f"{kind}_occ" /
                                      shift_frame_index(
                stem + getattr(dp, f"{kind}_occ_suffix"), i)))
            np.testing.assert_array_equal(of, flow)
            np.testing.assert_array_equal(occ, (conf * 255).astype(np.uint8))
    for kind in ("bw_of", "fw_of", "bw_occ", "fw_occ"):
        assert len(os.listdir(tmp_path / kind / "town")) == 3 * (t - 1)


def test_a_run_over_the_pixel_budget_writes_the_same_files(tmp_path,
                                                            monkeypatch):
    """A run whose pairs exceed ``PAIR_PIXELS_PER_CALL`` goes through in
    calls of at most that many pair pixels, and the tool writes the same
    files as with the whole run in one call. The published run of 3 clips
    at 128x256 is one call; a 512x1024 frame pair is a call of its own."""
    assert pflow.pairs_per_call(128, 256) == 30
    assert pflow.pairs_per_call(512, 1024) == 1
    assert pflow.pairs_per_call(2048, 4096) == 1
    yml, cfg, _ = tiny_dataset(tmp_path)
    model = StandIn()
    monkeypatch.setattr(pflow, "OnTheFlyFlow",
                        lambda *a, **k: types.SimpleNamespace(model=model))
    calls = []
    real = pflow.compute_flow_and_conf

    def counted(net, im1, im2):
        calls.append(im1.shape[0])
        return real(net, im1, im2)
    monkeypatch.setattr(pflow, "compute_flow_and_conf", counted)
    pairs = 2 * (cfg.train_params.num_frames - 1)
    assert pflow.main(["--config", yml, "--device", "cpu"]) == 0
    assert calls == [2 * pairs, pairs]           # runs of two clips and one
    whole = written_files(tmp_path)
    assert len(whole) == 3 * 2 * pairs
    for kind in ("bw_of", "fw_of", "bw_occ", "fw_occ"):
        for path in (tmp_path / kind).rglob("*"):
            if path.is_file():
                path.unlink()
    calls.clear()
    monkeypatch.setattr(pflow, "PAIR_PIXELS_PER_CALL", 3 * 64 * 64)
    assert pflow.main(["--config", yml, "--device", "cpu"]) == 0
    assert calls == [min(3, n - k) for n in (2 * pairs, pairs)
                     for k in range(0, n, 3)]
    assert written_files(tmp_path) == whole


def traced_request(port, clips):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = pflow.batch_flows(port, clips, 1)
    spans = trace.records()
    trace.clear()
    return spans, out


def test_a_request_records_its_spans_and_counts(nets):
    port, _ = nets
    clips = frames(np.random.RandomState(5), 1, 2, 64, 64, 3)
    spans, out = traced_request(port, clips)
    names = [s.name for s in spans]
    for name in FLOW_SPANS + NET_SPANS + ("c2m.flownet.correlation",):
        assert names.count(name) == 1, name
    assert names.count("c2m.flownet.warp") == 4
    assert names.count("c2m.flownet.deconv") == 36
    unit = next(s for s in spans if s.name == "c2m.flow.request")
    assert all(s.unit == unit.id for s in spans)
    assert all(s.device_ms is None for s in spans)   # the CPU's
    by_id = {s.id: s for s in spans}

    def parent(s):
        return by_id[s.parent].name
    for name in NET_SPANS:
        assert parent(next(s for s in spans if s.name == name)) == \
            "c2m.flow.inference"
    assert parent(next(s for s in spans
                       if s.name == "c2m.flownet.correlation")) == \
        "c2m.flownet.c"
    # 2 pairs; the cost volume correlates C = 256 at an eighth of 64x64; of
    # the 21 displacements -20..20 an axis of 8 positions keeps
    # 8 + 2 x (6 + 4 + 2) = 32 (position, displacement) pairs inside
    pairs, pix, c = 2, 8 * 8, 256
    corr = next(s for s in spans if s.name == "c2m.flownet.correlation")
    assert corr.counts == {"bytes": 4 * (2 * pairs * pix * c
                                         + pairs * pix * 441),
                           "flops": 2 * c * pairs * 32 * 32}
    # at the cell's 16x32 features: 128 x 452 of 336 x 672 pairs
    assert port_fn._inside(16) == 128 and port_fn._inside(32) == 452
    full = pairs * 64 * 64
    for s in spans:
        if s.name == "c2m.flownet.warp":
            # both images, the flow, the warped image and the norm
            assert s.counts == {"bytes": 4 * full * (3 + 3 + 2 + 3 + 1)}
    output = next(s for s in spans if s.name == "c2m.flow.output")
    nbytes = sum(a.nbytes for a in out.values())
    assert nbytes == 4 * full * 3
    assert output.counts == {"pinned_bytes": 0, "pageable_bytes": nbytes}
    assert all(s.counts == {} for s in spans if s.name not in (
        "c2m.flownet.correlation", "c2m.flownet.warp", "c2m.flow.output"))


def test_nothing_is_recorded_without_a_profiler(nets):
    port, _ = nets
    trace.clear()
    pflow.batch_flows(port, frames(np.random.RandomState(6), 1, 2, 64, 64, 3),
                      1)
    assert trace.records() == []


@pytest.mark.cuda
def test_on_the_card_spans_have_intervals_and_outputs_are_pinned(
        monkeypatch):
    """``python -m pytest --noconftest -m cuda`` on a card: the request's
    spans carry device intervals, the flows and confidences come back in
    page-locked memory equal to what the card computed, and the six readers
    read a number."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device intervals are "
                    "CUDA events")
    port = weights.build_on_device(port_fn.FlowNet2, SEED, "cuda")
    port = port.eval().requires_grad_(False)
    clips = frames(np.random.RandomState(7), 1, 3, 128, 256, 3)
    pflow.batch_flows(port, clips, 1)
    produced = []
    real = pflow.compute_flow_and_conf

    def computed(*args):
        produced.append(real(*args))
        return produced[-1]
    monkeypatch.setattr(pflow, "compute_flow_and_conf", computed)
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = pflow.batch_flows(port, clips, 1)
    spans = trace.records()
    assert all(s.device_ms is not None and s.device_ms >= 0.0 for s in spans)
    output = next(s for s in spans if s.name == "c2m.flow.output")
    nbytes = sum(a.nbytes for a in out.values())
    assert output.counts == {"pinned_bytes": nbytes, "pageable_bytes": 0}
    for a in out.values():
        assert torch.from_numpy(a).is_pinned()
    flow, conf = (t.cpu().numpy() for t in produced[-1])
    np.testing.assert_array_equal(out["bw_of"], flow[:2][None])
    np.testing.assert_array_equal(out["fw_of"], flow[2:][None])
    np.testing.assert_array_equal(out["bw_occ"], conf[:2, ..., 0][None])
    np.testing.assert_array_equal(out["fw_occ"], conf[2:, ..., 0][None])
    run = types.SimpleNamespace(kind="serve")
    for name, read in readers().items():
        value = read(run)
        assert value is not None and value > 0, (name, value)
    trace.clear()


def readers():
    found = harness.metric_readers()
    return {name: found[name][0] for name in READERS}


def fabricated(unit_name="c2m.flow.request", device_ms=3.0, counts=True):
    """Two units (ids 1 and 30): the first with two of every counted span,
    the second with one; one stray of each outside any unit. Device 3 ms,
    host 2 ms a span."""
    spans = []

    def add(name, id_, parent, unit, extra=None):
        spans.append(trace.Span(name, id_, parent, unit, 0, 2_000_000,
                                device_ms, extra if counts else {}))

    corr = {"bytes": 3.35e9, "flops": 6.7e10}     # 1 ms each bound
    warp = {"bytes": 6.7e9}                         # 2 ms bound
    for unit, n in ((1, 2), (30, 1)):
        add(unit_name, unit, None, unit)
        add("c2m.flow.inference", unit + 1, unit, unit)
        add("c2m.flow.output", unit + 2, unit, unit)
        for k in range(n):
            add("c2m.flownet.deconv", unit + 3 + k, unit + 1, unit)
            add("c2m.flownet.correlation", unit + 6 + k, unit + 1, unit, corr)
            add("c2m.flownet.warp", unit + 9 + k, unit + 1, unit, warp)
    for k, name in enumerate(("c2m.flownet.deconv", "c2m.flownet.correlation",
                              "c2m.flownet.warp")):
        add(name, 60 + k, None, 60 + k, {"bytes": 1.0, "flops": 1.0})
    return spans


def test_the_readers_on_fabricated_spans(monkeypatch):
    monkeypatch.setattr(trace, "records", fabricated)
    read = readers()
    run = types.SimpleNamespace(kind="serve")
    assert read["flow.inference_ms"](run) == pytest.approx(3.0)
    assert read["flow.inference_host_ms"](run) == pytest.approx(2.0)
    assert read["flow.output_ms"](run) == pytest.approx(3.0)
    # three deconv spans of 3 ms in two requests
    assert read["model.flownet_deconv_ms"](run) == pytest.approx(4.5)
    # three spans of 1 ms bound (bytes and operations alike) over 9 ms
    assert read["model.flownet_correlation_roofline_pct"](run) == \
        pytest.approx(100.0 / 3.0)
    # three spans of 2 ms bound over 9 ms
    assert read["model.flownet_warp_roofline_pct"](run) == \
        pytest.approx(200.0 / 3.0)
    assert 6.7e9 / roofline.HBM_BYTES_PER_S == pytest.approx(2e-3)
    train = types.SimpleNamespace(kind="train")
    assert all(r(train) is None for r in read.values())


def test_the_readers_read_none_elsewhere(monkeypatch):
    run = types.SimpleNamespace(kind="serve")
    # a C2M serve run: its unit is the serving request, not the flow tool's
    serve = fabricated(unit_name="c2m.serve.request")
    monkeypatch.setattr(trace, "records", lambda: serve)
    assert all(r(run) is None for r in readers().values())
    monkeypatch.setattr(trace, "records", lambda: [])
    assert all(r(run) is None for r in readers().values())
    # the CPU's spans have no device interval; a port that counts nothing
    no_device = fabricated(device_ms=None)
    monkeypatch.setattr(trace, "records", lambda: no_device)
    read = readers()
    assert read["flow.inference_host_ms"](run) == pytest.approx(2.0)
    assert all(read[n](run) is None for n in READERS
               if n != "flow.inference_host_ms")
    uncounted = fabricated(counts=False)
    monkeypatch.setattr(trace, "records", lambda: uncounted)
    assert read["model.flownet_correlation_roofline_pct"](run) is None
    assert read["model.flownet_warp_roofline_pct"](run) is None


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


NEW_FILES = ["perfbench/reference/models/flownet2.py",
             "perfbench/reference/ops/correlation.py",
             "perfbench/traffic/flow_closed.py", "perfbench/flow_spans.py",
             "perfbench/flownet2_flops.py"] + [
    f"perfbench/metrics/{name}.py" for name in READERS]


@pytest.mark.parametrize("path", NEW_FILES)
def test_new_benchmark_files_import_no_jax(path):
    found = {m.split(".")[0] for m in imports(os.path.join(REPO, path))}
    assert not found & {"jax", "jaxlib", "flax", "optax", "c2m_tpu"}
    if "/reference/" in path:
        assert "c2m_tpu_torch" not in found
    # the traffic reaches the port by its entry and model alone, never a
    # kernel module
    assert not [m for m in imports(os.path.join(REPO, path))
                if m.startswith("c2m_tpu_torch.ops")]
