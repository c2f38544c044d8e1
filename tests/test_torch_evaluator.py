"""The port's evaluator and visual output against the JAX package.

- The same numpy ``(batch, out)`` through both evaluators'
  ``fetch_metrics_data`` -> ``generate_metrics`` gives equal results, with
  the same stub embedder (FID and FVD) and stub detector on both sides,
  and NaN FID / FVD without embedders.
- The FID math, the detection metric and sklearn's F1 / accuracy of the
  paired lists are the originals'.
- Click guidance files written by one evaluator are loaded by the other.
- The port's evaluator over a model on the CPU writes gifs, pngs, an HTML
  page and ``results.txt``, and a pass that loads the saved guidance
  reproduces the clicks.
- ``flow_to_color``, the HTML gallery, the loss and trajectory logs and the
  gallery's images are byte-equal for the same input.
"""

import os

import numpy as np
import pytest
import torch

import jax

from c2m_tpu.config import tiny_config
from c2m_tpu.eval import detection_metric as jdet
from c2m_tpu.eval import fid as jfid
from c2m_tpu.eval.evaluator import Evaluator as JaxEvaluator
from c2m_tpu.eval.i3d import compute_fvd as jax_compute_fvd
from c2m_tpu.utils import flow_color as jcolor
from c2m_tpu.utils import html as jhtml
from c2m_tpu.utils import visualizer as jvis
from c2m_tpu_torch.eval import detection_metric as pdet
from c2m_tpu_torch.eval import fid as pfid
from c2m_tpu_torch.eval.evaluator import Evaluator, binary_f1
from c2m_tpu_torch.utils import flow_color as pcolor
from c2m_tpu_torch.utils import html as phtml
from c2m_tpu_torch.utils import visualizer as pvis
from tests.torch_port_fixtures import make_batch, port_cfg, tiny_cfg

HIT = np.array([19, 9, 61, 41, 0.9, 0.9, 2.0], np.float32)


def mini_batch(b=4, h=64, w=128, t=6, n_max=4, tpred=5, seed=0):
    rng = np.random.RandomState(seed)
    batch = {
        "video": rng.rand(b, t, h, w, 3).astype(np.float32),
        "targets_theta": np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32),
                                 (b, n_max, tpred, 1))
        + rng.randn(b, n_max, tpred, 6).astype(np.float32) * 0.05,
        "node_mask": np.zeros((b, n_max), bool),
        "num_real_nodes": np.full((b,), 2, np.int32),
        "nodes_x": rng.uniform(-1, 1, (b, n_max, 23)).astype(np.float32),
        "rois_target_last": np.zeros((b, n_max, 4), np.float32),
    }
    batch["node_mask"][:, :2] = True
    batch["rois_target_last"][:, :2] = [20, 10, 60, 40]  # x1 y1 x2 y2
    return batch


def mini_out(b=4, h=64, w=128, n_max=4, tpred=5, seed=1):
    rng = np.random.RandomState(seed)
    click = np.zeros((b, n_max), np.float32)
    click[np.arange(b), np.arange(b) % 2] = 1
    return {
        "generated": rng.rand(b, tpred, h, w, 3).astype(np.float32),
        "thetas": np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32),
                          (b, n_max, tpred, 1)),
        "click_mask": click,
    }


def stub_embedder(x):
    """[N, ...] -> [N, 6]: per-channel means and standard deviations."""
    x = np.asarray(x, np.float64).reshape(len(x), -1, 3)
    return np.concatenate([x.mean(1), x.std(1)], axis=1)


def stub_detector(pattern):
    """GT frames first, generated second: per image a hit or None."""
    calls = {"n": 0}

    def detect(images):
        calls["n"] += 1
        keep = pattern[(calls["n"] - 1) % 2]
        return [[HIT] if keep[i % len(keep)] else None
                for i in range(len(images))]
    return detect


def both_evaluators(tmp_path, detector_pattern=None, embed=True):
    cfg = tiny_config(h=64, w=128, num_predicted=5, max_objects=4,
                      batch_size=4)
    jdetector = pdetector = None
    if detector_pattern is not None:
        jdetector = stub_detector(detector_pattern)
        pdetector = stub_detector(detector_pattern)
    jev = JaxEvaluator(cfg, model=None, variables=None,
                       job_dir=str(tmp_path / "jax"), detector=jdetector)
    pev = Evaluator(port_cfg(cfg), None, str(tmp_path / "port"),
                    detector=pdetector,
                    fid_embedder=stub_embedder if embed else None,
                    fvd_embedder=stub_embedder if embed else None)
    jev._fid_embedder = lambda: stub_embedder if embed else None
    jev._compute_fvd = lambda: (jax_compute_fvd(
        stub_embedder(np.concatenate(jev._real_videos)),
        stub_embedder(np.concatenate(jev._fake_videos))) if embed
        else float("nan"))
    return cfg, jev, pev


@pytest.mark.parametrize("pattern,embed", [
    (None, True), (None, False),
    (([1, 1, 0, 1], [1, 0, 1, 1]), True),
    (([1, 1, 1, 1], [0, 0, 0, 0]), True),
    (([0, 0, 0, 0], [1, 1, 1, 1]), False)])
def test_metrics_equal_the_jax_evaluators(tmp_path, pattern, embed):
    _, jev, pev = both_evaluators(tmp_path, pattern, embed)
    for seed in (0, 1):
        batch, out = mini_batch(seed=seed), mini_out(seed=seed + 1)
        jev.fetch_metrics_data(batch, out)
        pev.fetch_metrics_data(batch, out)
    want, got = jev.generate_metrics(), pev.generate_metrics()
    assert list(got) == list(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == want[k], (k, got[k], want[k])
    assert np.isnan(got["fid"]) == (not embed)
    assert ("detection_f1" in got) == (pattern is not None
                                       and any(pattern[0]))
    jpath, ppath = jev.write_metrics(want), pev.write_metrics(got)
    assert open(ppath).read() == open(jpath).read()


def test_binary_f1_and_accuracy_are_sklearns():
    from sklearn.metrics import f1_score
    rng = np.random.RandomState(0)
    for n in (1, 2, 5, 30):
        for _ in range(20):
            gt = list(rng.randint(0, 2, n))
            pred = list(rng.randint(0, 2, n))
            want = f1_score(gt, pred, zero_division=0.0)
            assert binary_f1(gt, pred) == pytest.approx(want, abs=1e-12)


def test_fid_math_and_detection_metric_are_the_originals():
    rng = np.random.RandomState(3)
    a, b = rng.randn(40, 6), rng.randn(50, 6) * 1.3 + 0.2
    assert pfid.compute_fid(a, b) == jfid.compute_fid(a, b)
    for got, want in zip(pfid.activation_statistics(a),
                         jfid.activation_statistics(a)):
        np.testing.assert_array_equal(got, want)
    batch = mini_batch()
    gt = np.random.RandomState(4).rand(4, 64, 128, 3).astype(np.float32)
    gen = np.random.RandomState(5).rand(4, 64, 128, 3).astype(np.float32)
    click = np.array([0, 1, 0, 1])
    pattern = ([1, 0, 1, 1], [1, 1, 0, 1])
    want = jdet.compute_detection(stub_detector(pattern), gt, gen, batch,
                                  click, batch["rois_target_last"])
    got = pdet.compute_detection(stub_detector(pattern), gt, gen, batch,
                                 click, batch["rois_target_last"])
    assert got == want


def test_guidance_files_cross_between_the_evaluators(tmp_path):
    cfg, jev, pev = both_evaluators(tmp_path)
    batch = mini_batch()
    batch["num_real_nodes"] = np.array([2, 1, 0, 2], np.int32)
    # JAX writes, the port loads
    cfg.test_params.save_index_user_guidance = True
    want = np.asarray(jev.click_mask_for(batch, 3, jax.random.PRNGKey(1)))
    pev.out_dir = jev.out_dir
    pev.cfg.test_params.load_index_user_guidance = True
    got = pev.click_mask_for(batch, 3, torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2].sum() == 0 and want.sum() == 3
    # the port writes, JAX loads
    pev.cfg.test_params.save_index_user_guidance = True
    pev.cfg.test_params.load_index_user_guidance = False
    got = pev.click_mask_for(batch, 4, torch.Generator().manual_seed(9))
    saved = np.load(os.path.join(pev.out_dir, "index_user_guidance_00004.npy"))
    assert saved.dtype == np.int32 and saved.shape == (4,)
    cfg.test_params.load_index_user_guidance = True
    want = np.asarray(jev.click_mask_for(batch, 4, jax.random.PRNGKey(2)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_evaluator_writes_its_outputs_and_reloads_its_clicks(tmp_path):
    from c2m_tpu_torch.models.c2m import C2MGenerator, init_random_
    cfg = port_cfg(tiny_cfg(batch_size=2))
    cfg.test_params.save_index_user_guidance = True
    cfg.test_params.load_index_user_guidance = False
    model = init_random_(C2MGenerator(cfg), torch.Generator().manual_seed(0))
    batch = make_batch(tiny_cfg(batch_size=2), seed=3)
    ev = Evaluator(cfg, model, str(tmp_path))
    out = ev.evaluate_batch(batch, 0, torch.Generator().manual_seed(1))
    assert out["generated"].shape == (2, 5, 64, 128, 3)
    assert np.isfinite(out["generated"]).all()
    ev.save_samples(batch, out, 0)
    ev.fetch_metrics_data(batch, out)
    results = ev.generate_metrics()
    assert np.isfinite(results["trajectory_mse_theta"])
    assert np.isnan(results["fid"]) and np.isnan(results["fvd"])
    assert not any(k.startswith("detection") for k in results)
    ev.write_metrics(results)
    files = set(os.listdir(ev.out_dir))
    for name in ("b00000_s0_gen.gif", "b00000_s0_real.gif",
                 "b00000_s1_gen.png", "b00000_s0_flow.png",
                 "b00000_s0_occ.png", "results.txt",
                 "index_user_guidance_00000.npy"):
        assert name in files, name
    page = open(os.path.join(ev.out_dir, "web", "index.html")).read()
    assert "b00000_s1_gen.png" in page
    # a second pass loads the clicks the first saved: the same clicks
    # whatever the generator draws
    cfg.test_params.load_index_user_guidance = True
    again = Evaluator(cfg, model, str(tmp_path)).evaluate_batch(
        batch, 0, torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(again["click_mask"], out["click_mask"])


def flows(seed=0):
    rng = np.random.RandomState(seed)
    f = rng.randn(4, 16, 24, 2).astype(np.float32) * 3
    f[0, 0, 0] = [1e8, 0]                                   # unknown flow
    return f


def test_flow_colors_are_equal():
    f = flows()
    for frame in f:
        np.testing.assert_array_equal(pcolor.flow_to_color(frame),
                                      jcolor.flow_to_color(frame))
        np.testing.assert_array_equal(pcolor.flow_to_color(frame, 2.0),
                                      jcolor.flow_to_color(frame, 2.0))
    np.testing.assert_array_equal(pcolor.flow_video_to_color(f),
                                  jcolor.flow_video_to_color(f))


def test_html_gallery_is_byte_equal(tmp_path):
    pages = []
    for mod, name in ((jhtml, "jax"), (phtml, "port")):
        g = mod.HTMLGallery(str(tmp_path / name), title="t <1>", refresh=3)
        g.add_header("epoch 1 & more")
        g.add_images(["a.png", "b.png"], ["x<y", "z"], ["a.png", "b.png"],
                     width=256)
        g.save()
        pages.append((tmp_path / name / "index.html").read_bytes())
    assert pages[0] == pages[1]


def visual_inputs():
    rng = np.random.RandomState(7)
    b, t, tp, h, w, n = 2, 6, 5, 16, 24, 3
    batch = {"video": rng.rand(b, t, h, w, 3).astype(np.float32),
             "tracking_mask": rng.rand(b, t, h, w, 1).astype(np.float32),
             "target_bw_of": rng.randn(b, tp, h, w, 2).astype(np.float32),
             "target_bw_occ": rng.rand(b, tp, h, w, 1).astype(np.float32),
             "targets_theta": rng.randn(b, n, tp, 6).astype(np.float32),
             "node_mask": np.array([[1, 1, 0], [1, 0, 0]], bool)}
    out = {k: rng.rand(b, tp, h, w, c).astype(np.float32) for k, c in (
        ("generated", 3), ("generated_sparse", 3),
        ("generated_sparse_occ", 3), ("occlusion_bw", 1),
        ("sparse_occ_bw", 1), ("sparse_motion_bin", 1))}
    out["dense_motion_bw"] = rng.randn(b, tp, h, w, 2).astype(np.float32)
    out["sparse_motion_bw"] = rng.randn(b, tp, h, w, 2).astype(np.float32)
    out["thetas"] = rng.randn(b, n, tp, 6).astype(np.float32)
    return batch, out


def test_visualizer_writes_the_same_bytes(tmp_path, capsys):
    """Both visualizers in turn in one job dir (the page's title is the
    job dir): every file they write is byte-equal."""
    import shutil
    batch, out = visual_inputs()
    job = tmp_path / "job"
    written = {}
    for mod, name in ((jvis, "jax"), (pvis, "port")):
        shutil.rmtree(job, ignore_errors=True)
        vis = mod.Visualizer(str(job), use_html=True, tf_log=False)
        vis.log_losses(2, 40, {"total_gen": 1.23456, "kl": 0.5}, 0.25)
        vis.log_losses(2, 41, {"total_gen": np.float32(1.5), "kl": 0.25},
                       0.125)
        vis.log_trajectories(2, 41, out["thetas"], batch["targets_theta"],
                             batch["node_mask"], tag="eval")
        vis.display_results(batch, out, 2, 41, max_samples=2, tag="eval")
        written[name] = {os.path.relpath(os.path.join(d, f), job):
                         open(os.path.join(d, f), "rb").read()
                         for d, _, files in os.walk(job) for f in files}
    assert written["port"].keys() == written["jax"].keys()
    assert {"loss_log.txt", "trajectory_log.txt", "web/index.html"} <= \
        set(written["jax"])
    assert len(written["jax"]) == 3 + 2 * 13
    for rel, data in written["jax"].items():
        assert written["port"][rel] == data, rel
    printed = capsys.readouterr().out.splitlines()
    assert printed[:2] == printed[2:]
    strip = pvis.video_strip(out["occlusion_bw"][0])
    np.testing.assert_array_equal(strip,
                                  jvis.video_strip(out["occlusion_bw"][0]))
