"""The port's Evaluator with its metric nets built from INCEPTION_WEIGHTS,
I3D_WEIGHTS and YOLO_WEIGHTS (npz files the bridge wrote) against the JAX
Evaluator with the same files, on the same frames, on the CPU.

The embeddings that FID and FVD are computed from are compared (resize,
``x * 2 - 1`` and the net; 1e-4 relative to the largest), not the
distances: with a handful of 2048-d features the covariances are singular
and ``sqrtm`` amplifies float noise. The port's FID and FVD must be finite
and its ``results.txt`` must hold the JAX one's keys; the detectors
(YOLOv3 at 416x416, NMS) must give the same boxes. The JAX side's Frechet
distance is recorded and not computed (its ``sqrtm`` of a 2048x2048 matrix
takes ~14 s on an 8-core CPU; the copied math is held to it in
tests/test_torch_evaluator.py), nor is it in the entry-point test, which
checks what the nets hand to it. Also: torchvision's checkpoint in the
torch hub cache as the FID fallback.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from c2m_tpu.config import tiny_config
from c2m_tpu.eval import fid as jfid
from c2m_tpu.eval.evaluator import Evaluator as JaxEvaluator
from c2m_tpu_torch.eval import fid as pfid
from c2m_tpu_torch.eval.detection_metric import make_yolo_detector, pad_416
from c2m_tpu_torch.eval.evaluator import Evaluator
from c2m_tpu_torch.utils import convert
from tests.test_torch_evaluator import mini_batch, mini_out
from tests.torch_metric_fixtures import net_weights, within
from tests.torch_port_fixtures import port_cfg

ENV = {"inception": "INCEPTION_WEIGHTS", "i3d": "I3D_WEIGHTS",
       "yolov3": "YOLO_WEIGHTS"}


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """npz files of seeded, calibrated weights; YOLOv3 calibrated on a
    padded 416x416 frame like those the detector then sees."""
    d = tmp_path_factory.mktemp("nets")
    last = mini_out(b=1, tpred=2)["generated"][:, -1]
    paths = {}
    for seed, name in enumerate(ENV):
        calib = pad_416(last) if name == "yolov3" else None
        variables, _ = net_weights(name, seed=seed, calib=calib)
        paths[name] = str(d / f"{name}.npz")
        convert.write_variables_npz(paths[name], variables)
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weight_files):
    """Both evaluators over one clip of 64x128 frames (2 predicted), the
    embeddings each hands to the Frechet distance recorded."""
    d = tmp_path_factory.mktemp("eval_nets")
    batch, out = mini_batch(b=1, t=3, tpred=2), mini_out(b=1, tpred=2)
    seen = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        for name, var in ENV.items():
            mp.setenv(var, weight_files[name])
        for key, mod in (("jax", jfid), ("port", pfid)):
            def record(a, b, key=key, f=mod.compute_fid):
                seen[key].append((a, b))
                return f(a, b) if key == "port" else float("nan")
            mp.setattr(mod, "compute_fid", record)
        cfg = tiny_config(h=64, w=128, num_predicted=2, max_objects=4,
                          batch_size=1)
        jev = JaxEvaluator(cfg, model=None, variables=None,
                           job_dir=str(d / "jax"))
        pev = Evaluator(port_cfg(cfg), None, str(d / "port"))
        results, files, detections = {}, {}, {"jax": [], "port": []}
        for key, ev in (("jax", jev), ("port", pev)):
            def detect(images, key=key, f=ev.detector):
                detections[key].append(f(images))
                return detections[key][-1]
            ev.detector = detect
            ev.fetch_metrics_data(batch, out)
            results[key] = ev.generate_metrics()
            files[key] = open(ev.write_metrics(results[key])).read()
    return {"seen": seen, "results": results, "files": files,
            "detections": detections, "port": pev}


@pytest.mark.parametrize("metric,side", [(0, 0), (0, 1), (1, 0), (1, 1)],
                         ids=["fid-real", "fid-fake", "fvd-real", "fvd-fake"])
def test_embeddings_equal_the_jax_evaluators(runs, metric, side):
    want = runs["seen"]["jax"][metric][side]
    got = runs["seen"]["port"][metric][side]
    assert got.shape == want.shape == ((2, 2048) if metric == 0 else (2, 1024))
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    assert within(got, want, rel=1e-4, abs_=0.0) <= 1.0, within(got, want)


def test_results_finite_with_the_jax_keys(runs):
    res = runs["results"]["port"]
    assert np.isfinite(res["fid"]) and np.isfinite(res["fvd"]), res
    keys = {k: [ln.split(":")[0] for ln in runs["files"][k].splitlines()]
            for k in ("jax", "port")}
    assert keys["port"] == keys["jax"]
    assert "gt_detection" in keys["port"]          # the detector found the box


@pytest.mark.parametrize("call", [0, 1], ids=["gt-frames", "generated"])
def test_detector_gives_the_jax_boxes(runs, call):
    want = runs["detections"]["jax"][call]
    got = runs["detections"]["port"][call]
    assert len(got) == len(want) == 1
    assert want[0] is not None and got[0] is not None
    g, w = got[0], want[0]
    assert g.shape == w.shape and len(w) > 10
    np.testing.assert_array_equal(np.sort(g[:, 6]), np.sort(w[:, 6]))
    # boxes of nearly equal score may swap places in the kept order: each
    # kept box is matched with the nearest JAX box of its class
    tol = 1e-4 * np.abs(w[:, :6]).max()
    for row in g:
        same = w[w[:, 6] == row[6], :6]
        assert np.abs(same - row[:6]).max(1).min() <= tol, row


def test_the_evaluator_names_the_nets_it_built(runs, weight_files):
    ev = runs["port"]
    assert ev.metric_nets == {
        "detector": f"YOLOv3 from {weight_files['yolov3']}",
        "fid": f"InceptionV3 from {weight_files['inception']}",
        "fvd": f"I3D from {weight_files['i3d']}"}
    assert ev.detector_frames == 2
    assert make_yolo_detector(None) is None and make_yolo_detector("") is None


def test_hub_cache_inception_is_the_fid_fallback(tmp_path):
    """Without INCEPTION_WEIGHTS, torchvision's checkpoint in the torch hub
    cache (its keys, AuxLogits and fc included) -> the port's net, mapped
    to [-1, 1] then resized; without the file, None. Never a download."""
    import torch.nn.functional as F
    from tests.torch_inception import InceptionV3Trunk
    before = torch.hub.get_dir()
    torch.hub.set_dir(str(tmp_path))
    try:
        assert pfid.hub_inception_checkpoint() is None
        assert pfid.inception_embedder(device="cpu") is None
        torch.manual_seed(1)
        ref = InceptionV3Trunk().eval()
        state = dict(ref.state_dict())
        state["fc.weight"] = torch.zeros(1000, 2048)
        state["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
        os.makedirs(tmp_path / "checkpoints")
        path = tmp_path / "checkpoints" / "inception_v3_google-0cc3c7bd.pth"
        torch.save(state, path)
        assert pfid.hub_inception_checkpoint() == str(path)
        embed = pfid.inception_embedder(batch_size=2, device="cpu")
        images = np.random.RandomState(2).rand(3, 40, 56, 3).astype(np.float32)
        got = embed(images)
        x = F.interpolate(torch.from_numpy(images * 2.0 - 1.0).permute(
            0, 3, 1, 2), size=(299, 299), mode="bilinear", align_corners=False)
        with torch.no_grad():
            want = ref(x).numpy()
        assert got.shape == (3, 2048)
        assert within(got, want, rel=1e-5, abs_=0.0) <= 1.0
    finally:
        torch.hub.set_dir(before)


def test_eval_entry_point_builds_and_runs_the_nets(tmp_path, monkeypatch,
                                                  capsys, weight_files):
    import eval_torch
    from c2m_tpu_torch import config as pconfig
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.utils.checkpoint import save_checkpoint
    cfg = pconfig.shrink_model(pconfig.tiny_config(
        h=64, w=128, num_predicted=2, max_objects=4, batch_size=1), 8, 32)
    cfg.dataset_params.dataset = "synthetic"
    cfg.train_params.dtype = "float32"
    cfg.test_params.batch_size = 1
    cfg.test_params.workers = 0
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    job = str(tmp_path / "job")
    save_checkpoint(job, create_train_state(cfg, device="cpu"), 0, 0)
    for name, var in ENV.items():
        monkeypatch.setenv(var, weight_files[name])
    seen = []
    monkeypatch.setattr(pfid, "compute_fid",
                        lambda a, b: seen.append((a, b)) or 0.0)
    assert eval_torch.main(["--config", str(path), "--device", "cpu",
                            "--job-dir", job, "--max-batches", "1"]) == 0
    printed = capsys.readouterr().out
    assert ("metric nets: detector: YOLOv3 from "
            f"{weight_files['yolov3']}; fid: InceptionV3") in printed
    assert "detector ran on 2 last frames" in printed
    assert [(a.shape, b.shape) for a, b in seen] == [
        ((2, 2048), (2, 2048)), ((2, 1024), (2, 1024))]
    assert all(np.isfinite(a).all() and np.isfinite(b).all() for a, b in seen)
    text = open(os.path.join(job, "eval", "results.txt")).read()
    assert "fid: 0.0" in text and "fvd: 0.0" in text
