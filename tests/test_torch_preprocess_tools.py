"""The port's preprocessing and scoring host code against the JAX package on
the CPU: the region library (``c2m_tpu_torch/native``), the tracker
benchmark, the trajectory tool's host functions, the Cityscapes evaluators,
and the ``generate_trajectories``, ``precompute_flow`` and
``evaluate_cityscapes`` CLIs.

- Region IoU: the port's copy of ``region.cc`` is the original below its
  header comment, builds with g++ (a broken source raises with the
  compiler's message), and ``rect_iou`` / ``rect_iou_matrix`` /
  ``polygon_iou`` are within 1e-12 of ``c2m_tpu.native``'s.
- ``success_curve``, ``precision_curve``, ``evaluate_tracker``; the
  trajectory constants, ``list_clips``, ``instance_path``,
  ``extract_instances``, ``bbox_covers``, ``match_instance`` and
  ``track_clip`` (scripted trackers, as tests/test_trajectories.py has
  them); ``evaluate_pixel_level`` / ``evaluate_instance_level`` and the
  ``evaluate_cityscapes`` CLI's JSON: equal to the JAX package's.
- ``generate_trajectories`` on a 30-frame clip with a moving car (random
  tracker, smoke thresholds): 9 rows with the crafted motion.
- ``precompute_flow`` on a tiny config with ``--limit 1``: 2(T-1) files per
  kind, equal to the port's ``compute_flow_and_conf`` on the same frames;
  the JAX ``get_training_set`` and the port's load the clip to equal
  arrays. No JAX FlowNet2 is compiled.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from c2m_tpu import config as jconfig
from c2m_tpu import native as jnative
from c2m_tpu.data.dataset import get_training_set as jax_training_set
from c2m_tpu.eval import cityscapes_eval as jce
from c2m_tpu.eval import tracker_benchmark as jtb
from c2m_tpu_torch import native as pnative
from c2m_tpu_torch.data.cityscapes import load_image
from c2m_tpu_torch.data.dataset import get_training_set as port_training_set
from c2m_tpu_torch.data.flow_io import read_flow
from c2m_tpu_torch.eval import cityscapes_eval as pce
from c2m_tpu_torch.eval import tracker_benchmark as ptb
from c2m_tpu_torch.models.flownet2 import compute_flow_and_conf
from c2m_tpu_torch.tools import evaluate_cityscapes as pevalcli
from c2m_tpu_torch.tools import generate_trajectories as ptraj
from c2m_tpu_torch.tools import precompute_flow as pflow
from c2m_tpu_torch.train.flow_onthefly import OnTheFlyFlow
from tests.test_trajectories import ScriptedTracker, _frame_instances
from tests.torch_port_fixtures import port_cfg
from tools import evaluate_cityscapes as jevalcli
from tools import generate_trajectories as jtraj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CITY = "syntown"
RAW_H, RAW_W = 128, 256
TRAIN_H, TRAIN_W = 64, 128
CAR_IID = 13001


# -- region IoU -----------------------------------------------------------------

def _body(path):
    src = open(path).read()
    return src[src.index("#include <algorithm>"):]


def test_region_source_is_the_originals():
    assert _body(pnative.SOURCE) == _body(
        os.path.join(REPO, "c2m_tpu", "native", "region.cc"))


def _polygon(rng):
    """A rotated rectangle as a [4, 2] convex polygon."""
    cx, cy, w, h = rng.uniform(0, 50), rng.uniform(0, 50), *rng.uniform(
        1, 30, 2)
    t = rng.uniform(0, np.pi)
    c, s = np.cos(t), np.sin(t)
    pts = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    return pts @ np.array([[c, s], [-s, c]]) + [cx, cy]


def test_region_iou_matches_the_native_library():
    assert jnative._load() is not None      # the C library, not numpy
    rng = np.random.RandomState(0)
    boxes1 = np.concatenate([rng.uniform(0, 60, (20, 2)),
                             rng.uniform(0, 30, (20, 2))], 1)
    boxes2 = np.concatenate([rng.uniform(0, 60, (15, 2)),
                             rng.uniform(0, 30, (15, 2))], 1)
    boxes2[0] = [200, 200, 5, 5]             # disjoint from all
    boxes2[1] = [10, 10, 0, 0]               # empty
    for a in boxes1[:6]:
        for b in boxes2[:6]:
            assert abs(pnative.rect_iou(a, b) - jnative.rect_iou(a, b)) \
                <= 1e-12
    got = pnative.rect_iou_matrix(boxes1, boxes2)
    np.testing.assert_allclose(got, jnative.rect_iou_matrix(boxes1, boxes2),
                               rtol=0, atol=1e-12)
    assert got.shape == (20, 15) and (got[:, 0] == 0).all()
    for _ in range(20):
        p, q = _polygon(rng), _polygon(rng)
        assert abs(pnative.polygon_iou(p, q) - jnative.polygon_iou(p, q)) \
            <= 1e-12
    square = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], float)
    assert pnative.polygon_iou(square, square + [1, 0]) == pytest.approx(1 / 3)
    with pytest.raises(ValueError, match="expected"):
        pnative.rect_iou_matrix(boxes1[:, :3], boxes2)


def test_region_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "region.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("C2M_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(pnative, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed"):
        pnative.build()


# -- tracker benchmark ----------------------------------------------------------

class _Noisy:
    """Ground truth plus seeded jitter, the same for each caller."""

    def __init__(self, gt, seed):
        self.gt, self.seed = gt, seed

    def init(self, img, bbox):
        self.i = 0
        self.rng = np.random.RandomState(self.seed)

    def track(self, img):
        self.i += 1
        box = np.asarray(self.gt[self.i], float) + self.rng.randn(4) * 4
        return {"bbox": box.tolist(), "best_score": 1.0}


def test_tracker_benchmark_matches():
    rng = np.random.RandomState(1)
    gt = np.concatenate([rng.uniform(0, 100, (12, 2)),
                         rng.uniform(5, 40, (12, 2))], 1)
    pred = gt + rng.randn(12, 4) * 6
    np.testing.assert_array_equal(ptb.success_curve(pred, gt),
                                  jtb.success_curve(pred, gt))
    np.testing.assert_array_equal(ptb.precision_curve(pred, gt),
                                  jtb.precision_curve(pred, gt))
    frames = [np.zeros((8, 8, 3), np.uint8)] * 12
    videos = [{"frames": frames, "gt": gt.tolist()},
              {"frames": frames[:6], "gt": gt[:6].tolist()}]
    assert ptb.evaluate_tracker(_Noisy(gt, 3), videos) == \
        jtb.evaluate_tracker(_Noisy(gt, 3), videos)


# -- trajectory host functions --------------------------------------------------

def _write_uint16(path, arr):
    Image.fromarray(arr.astype(np.uint16)).save(path)


def test_trajectory_constants_and_clips(tmp_path):
    for name in ("CLIP_LEN", "TRACK_LEN", "SCORE_THRESH", "COVER_THRESH",
                 "HOOD_ROW_FRAC"):
        assert getattr(ptraj, name) == getattr(jtraj, name), name
    for city, n in (("a", 65), ("b", 29)):
        os.makedirs(tmp_path / city)
        for f in range(n):
            (tmp_path / city / f"{city}_000000_{f:06d}_leftImg8bit.png").touch()
    clips = ptraj.list_clips(str(tmp_path))
    assert clips == jtraj.list_clips(str(tmp_path)) and len(clips) == 2
    p = clips[1][1][3]
    assert ptraj.instance_path("/inst", "a", p, "x.png") == \
        jtraj.instance_path("/inst", "a", p, "x.png")


def test_extract_and_match_instances(tmp_path):
    rng = np.random.RandomState(2)
    arr = np.zeros((64, 128), np.int32)
    for iid, x, y, w, h in ((26001, 10, 10, 20, 12), (24, 40, 10, 10, 10),
                            (25002, 5, 55, 30, 8), (26002, 70, 20, 3, 1),
                            (24001, 90, 5, 15, 30), (26003, 50, 30, 1, 9)):
        arr[y:y + h, x:x + w] = iid
    arr[rng.rand(64, 128) < 0.01] = 26004
    path = str(tmp_path / "inst.png")
    _write_uint16(path, arr)
    got, want = ptraj.extract_instances(path), jtraj.extract_instances(path)
    assert [g[1:] for g in got] == [w[1:] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
    assert len(got) >= 3
    for bbox in ([10, 10, 20, 12], [8, 8, 16, 12], [-5, -5, 200, 200],
                 [90, 5, 15, 30], [0, 0, 0, 0]):
        for inst in got:
            assert ptraj.bbox_covers(inst[0], bbox) == \
                jtraj.bbox_covers(inst[0], bbox)
        for cls in (24, 26, 25):
            for thresh in (0.8, 0.0):
                assert ptraj.match_instance(got, bbox, cls, thresh) == \
                    jtraj.match_instance(want, bbox, cls, thresh)


def _scripts():
    """name -> (inst_lists, make_tracker) of tests/test_trajectories.py's
    scenarios: a clean track, a score dip, a degenerate box, a vanished
    instance, an id switch, two objects."""
    h, w, n = 64, 128, jtraj.TRACK_LEN
    moving = [_frame_instances(h, w, [(26001, 10 + 2 * f, 10, 20, 12),
                                      (24001, 80, 30, 10, 20)])
              for f in range(n)]

    def script(dip=None, degenerate=None):
        def make(frame0, bbox):
            s = [(0.99, [10 + 2 * f, 10, 20, 12] if bbox[0] < 50
                  else [80, 30, 10, 20]) for f in range(1, n)]
            if dip is not None:
                s[dip] = (0.9499, s[dip][1])
            if degenerate is not None:
                s[degenerate] = (0.99, [0, 0, 0, 0])
            return ScriptedTracker(s)
        return make

    vanish = [list(fr) for fr in moving]
    vanish[6] = vanish[6][1:]
    switch = [_frame_instances(h, w, [(26001 if f < 5 else 26002, 10, 10, 20,
                                       12)]) for f in range(n)]
    return {"clean": (moving, script()), "dip": (moving, script(dip=3)),
            "degenerate": (moving, script(degenerate=5)),
            "vanish": (vanish, script()), "switch": (switch, script())}


@pytest.mark.parametrize("case", ["clean", "dip", "degenerate", "vanish",
                                  "switch"])
def test_track_clip_matches(case):
    inst_lists, make = _scripts()[case]
    frames = [np.zeros((64, 128, 3), np.uint8)] * jtraj.TRACK_LEN
    for kw in ({}, {"score_thresh": 0.9, "cover_thresh": 0.5}):
        assert ptraj.track_clip(frames, inst_lists, make, **kw) == \
            jtraj.track_clip(frames, inst_lists, make, **kw)


# -- Cityscapes evaluators ------------------------------------------------------

def _cityscapes_data(seed=0, n=3, h=48, w=64):
    """(label-id predictions, label-id ground truths, instanceIds ground
    truths, instance predictions) with crafted objects and noise."""
    rng = np.random.RandomState(seed)
    ids = np.array([0, 7, 8, 11, 21, 23, 24, 26, 33])
    preds, gts, insts, inst_preds = [], [], [], []
    for _ in range(n):
        gt = ids[rng.randint(0, len(ids), (h // 8, w // 8))].repeat(8, 0) \
            .repeat(8, 1).astype(np.uint8)
        inst = gt.astype(np.int32)
        image_preds = []
        for k, cls in enumerate((26, 26, 24), start=1):
            y, x = rng.randint(0, h - 16), rng.randint(0, w - 20)
            gt[y:y + 14, x:x + 18] = cls
            inst[y:y + 14, x:x + 18] = cls * 1000 + k
            mask = np.zeros((h, w), bool)
            dy, dx = rng.randint(-2, 3, 2)
            mask[max(y + dy, 0):y + dy + 14, max(x + dx, 0):x + dx + 18] = True
            image_preds.append({"mask": mask, "label_id": int(cls),
                                "confidence": float(rng.rand())})
        pred = gt.copy()
        flip = rng.rand(h, w) < 0.1
        pred[flip] = ids[rng.randint(1, len(ids), flip.sum())]
        preds.append(pred)
        gts.append(gt)
        insts.append(inst)
        inst_preds.append(image_preds)
    return preds, gts, insts, inst_preds


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b)
    else:
        assert a == b, (a, b)


def test_cityscapes_evaluators_match():
    for name in ("EVAL_IDS", "INSTANCE_NAMES", "CATEGORIES",
                 "AVG_INSTANCE_SIZE", "MIN_REGION_SIZE", "N_IDS"):
        assert getattr(pce, name) == getattr(jce, name), name
    np.testing.assert_array_equal(pce.OVERLAPS, jce.OVERLAPS)
    preds, gts, insts, inst_preds = _cityscapes_data()
    pairs = list(zip(preds, gts))
    _same(pce.evaluate_pixel_level(pairs, insts),
          jce.evaluate_pixel_level(pairs, insts))
    _same(pce.evaluate_pixel_level(pairs), jce.evaluate_pixel_level(pairs))
    _same(pce.evaluate_instance_level(insts, inst_preds),
          jce.evaluate_instance_level(insts, inst_preds))


def test_evaluate_cityscapes_cli_matches(tmp_path):
    preds, gts, insts, inst_preds = _cityscapes_data(seed=1, n=2)
    gt_dir, pred_dir = tmp_path / "gt" / CITY, tmp_path / "pred"
    os.makedirs(gt_dir)
    os.makedirs(pred_dir / "masks")
    for i, (pred, gt, inst, ipreds) in enumerate(zip(preds, gts, insts,
                                                     inst_preds)):
        stem = f"{CITY}_000000_{i:06d}"
        Image.fromarray(gt).save(gt_dir / f"{stem}_gtFine_labelIds.png")
        _write_uint16(gt_dir / f"{stem}_gtFine_instanceIds.png", inst)
        Image.fromarray(pred).save(pred_dir / f"{stem}_pred.png")
        lines = []
        for k, p in enumerate(ipreds):
            rel = f"masks/m{i}_{k}.png"
            Image.fromarray(p["mask"].astype(np.uint8) * 255).save(
                pred_dir / rel)
            lines.append(f"{rel} {p['label_id']} {p['confidence']}")
        (pred_dir / f"{stem}_pred.txt").write_text("\n".join(lines))
    for mode in ("pixel", "instance"):
        outs = []
        for cli in (pevalcli, jevalcli):
            out = str(tmp_path / f"{mode}_{cli.__name__}.json")
            assert cli.main([mode, "--gt-dir", str(tmp_path / "gt"),
                             "--pred-dir", str(pred_dir), "--out", out]) == 0
            outs.append(json.loads(open(out).read()))
        assert outs[0] == outs[1], mode


# -- the CLIs on a synthetic city -----------------------------------------------

def _car_box(f):
    return 30 + 2 * f, 40, 40, 24              # x, y, w, h at RAW size


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """30 raw frames (gradient road / sky, a car moving right 2 px a frame)
    with their crafted semantic and instance maps, as
    tests/test_preprocess_chain.py paints them, and the same at the
    training size (frames bicubic, maps nearest)."""
    root = tmp_path_factory.mktemp("city")
    for d in ("raw", "gt_instance", "train_images", "train_semantic",
              "train_instance"):
        os.makedirs(root / d / CITY)
    for f in range(ptraj.CLIP_LEN):
        img = np.zeros((RAW_H, RAW_W, 3), np.uint8)
        img[:RAW_H // 2] = (70, 130, 180)
        img[RAW_H // 2:] = (90, 90, 90)
        x, y, bw, bh = _car_box(f)
        img[y:y + bh, x:x + bw] = (220, 40, 40)
        sem = np.zeros((RAW_H, RAW_W), np.uint8)
        sem[:RAW_H // 2] = 10
        sem[y:y + bh, x:x + bw] = 13
        inst = np.zeros((RAW_H, RAW_W), np.int32)
        inst[y:y + bh, x:x + bw] = CAR_IID
        stem = f"{CITY}_000000_{f:06d}"
        Image.fromarray(img).save(root / "raw" / CITY /
                                  f"{stem}_leftImg8bit.png")
        _write_uint16(root / "gt_instance" / CITY /
                      f"{stem}_gtFine_instanceIds.png", inst)
        size = (TRAIN_W, TRAIN_H)
        Image.fromarray(img).resize(size, Image.BICUBIC).save(
            root / "train_images" / CITY / f"{stem}_leftImg8bit.png")
        Image.fromarray(sem).resize(size, Image.NEAREST).save(
            root / "train_semantic" / CITY / f"{stem}_ssmask.png")
        Image.fromarray(inst.astype(np.uint16)).resize(
            size, Image.NEAREST).save(root / "train_instance" / CITY /
                                      f"{stem}_gtFine_instanceIds.png")
    return root


def test_generate_trajectories_cli(city):
    out = city / "tracking_cli"
    assert ptraj.main(["--images-root", str(city / "raw"), "--instance-root",
                       str(city / "gt_instance"), "--out", str(out),
                       "--score-thresh", "0", "--cover-thresh", "0",
                       "--limit", "1", "--device", "cpu"]) == 0
    rows = (out / CITY / f"{CITY}_000000_000000_{CAR_IID}.txt") \
        .read_text().splitlines()
    assert len(rows) == ptraj.TRACK_LEN
    for f, row in enumerate(rows):
        x, y, w, h, iid = row.split(",")
        bx, by, bw, bh = _car_box(f)
        assert int(iid) == CAR_IID
        assert (float(x), float(y)) == (bx, by)
        assert (float(w), float(h)) == (bw - 1, bh - 1)


def _configs(root):
    """(the JAX package's config, the port's) over the city at 64x128, one
    input and two predicted frames."""
    cfg = jconfig.tiny_config(h=TRAIN_H, w=TRAIN_W, num_predicted=2,
                              max_objects=4, batch_size=1)
    dp = cfg.dataset_params
    dp.root, dp.dataset = str(root), "cityscapes"
    for split in ("train", "val"):
        for field, value in (("images_path", "train_images"),
                             ("data_list", "cityscapes_train.txt"),
                             ("segmasks_path", "train_semantic"),
                             ("instances_path", "train_instance"),
                             ("tracking_path", "tracking"),
                             ("bw_of_path", "bw_of"), ("bw_occ_path", "bw_occ"),
                             ("fw_of_path", "fw_of"),
                             ("fw_occ_path", "fw_occ")):
            setattr(dp, f"{split}_{field}", value)
    cfg.train_params.use_fw_of = True
    cfg.validate()
    return cfg, port_cfg(cfg)


def test_precompute_flow_cli_and_the_loaders(city):
    jcfg, pcfg = _configs(city)
    name = f"{CITY}/{CITY}_000000_000000_leftImg8bit.png"
    (city / "cityscapes_train.txt").write_text(name + "\n")
    os.makedirs(city / "tracking" / CITY, exist_ok=True)
    (city / "tracking" / CITY / f"{CITY}_000000_000000_{CAR_IID}.txt") \
        .write_text("\n".join(f"{x}.0,{y}.0,{w - 1}.0,{h - 1}.0,{CAR_IID}"
                              for x, y, w, h in map(_car_box, range(9))))
    yml = city / "tiny.yaml"
    yml.write_text(yaml.safe_dump(pcfg.to_dict()))
    assert pflow.main(["--config", str(yml), "--split", "train", "--limit",
                       "1", "--device", "cpu"]) == 0

    t = pcfg.train_params.num_frames
    model = OnTheFlyFlow(1, 2, device="cpu").model
    frames = [torch.from_numpy(load_image(str(
        city / "train_images" / CITY / f"{CITY}_000000_{i:06d}_leftImg8bit.png"),
        (TRAIN_H, TRAIN_W)))[None] for i in range(t)]
    dp = pcfg.dataset_params
    for kind in ("bw", "fw"):
        files = sorted(os.listdir(city / f"{kind}_of" / CITY))
        assert len(files) == t - 1
        assert len(os.listdir(city / f"{kind}_occ" / CITY)) == t - 1
    with torch.no_grad():
        for i in range(1, t):
            for kind, pair in (("bw", (frames[i], frames[0])),
                               ("fw", (frames[0], frames[i]))):
                flow, conf = compute_flow_and_conf(model, *pair)
                stem = f"{CITY}_000000_{i:06d}_"
                of = read_flow(str(city / f"{kind}_of" / CITY /
                                   (stem + getattr(dp, f"{kind}_of_suffix"))))
                occ = np.array(Image.open(
                    city / f"{kind}_occ" / CITY /
                    (stem + getattr(dp, f"{kind}_occ_suffix"))))
                assert of.shape == (TRAIN_H, TRAIN_W, 2)
                assert np.isfinite(of).all()
                np.testing.assert_array_equal(of, flow[0].numpy())
                np.testing.assert_array_equal(
                    occ, (conf[0, ..., 0].numpy() * 255).astype(np.uint8))

    want = jax_training_set(jcfg)
    got = port_training_set(pcfg)
    assert len(got) == len(want) == 1
    a, b = got[0], want[0]
    assert set(a) == set(b)
    for key in b:
        if isinstance(b[key], str):
            assert a[key] == b[key]
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a["node_mask"].sum() == 1 and a["inst_ids"][0] == CAR_IID
    assert a["target_bw_of"].shape == (2, TRAIN_H, TRAIN_W, 2)
