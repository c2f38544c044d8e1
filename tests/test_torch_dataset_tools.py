"""The port's ground-truth tools against the JAX package's, on the CPU:
``prepare_gt_labels`` and ``kitti2cityscapes_semantic``
(``c2m_tpu_torch/tools/``; ``make_synthetic_dataset`` is held in
``tests/test_torch_data.py``, beside the JAX tool's trees it reads).

- ``prepare_gt_labels`` on one polygon JSON (draw order, groups, deleted
  objects, a negative id, several instances per class): byte-equal label
  and instance PNGs in both encodings.
- ``kitti2cityscapes_semantic``: ``convert_pair`` and the written tree equal
  to the JAX tool's for semantic ids up to 255; an id above 255 converts
  to 0 in both outputs (the JAX tool raises IndexError there).

The port writes every instance PNG from a uint16 array: each port tool runs
here with Pillow's DeprecationWarning raised as an error (saving an ``I``
image as PNG is deprecated), and its bytes are those of the JAX tool's
``I`` image.
"""

import json
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from c2m_tpu_torch.tools import kitti2cityscapes_semantic as pkitti
from c2m_tpu_torch.tools import prepare_gt_labels as pgt
from tools import kitti2cityscapes_semantic as jkitti
from tools import prepare_gt_labels as jgt


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _strict(main, argv):
    """A port tool's main with DeprecationWarning raised as an error."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        return main(argv)


# -- prepare_gt_labels ----------------------------------------------------------

def _rect(x0, y0, x1, y1):
    return [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]


ANNOTATION = {"imgWidth": 96, "imgHeight": 64, "objects": [
    {"label": "road", "polygon": _rect(0, 32, 95, 63)},
    {"label": "sky", "polygon": _rect(0, 0, 95, 31)},
    {"label": "building", "polygon": [[5, 5], [40, 8], [30, 30], [8, 25]]},
    {"label": "car", "polygon": _rect(10, 36, 30, 50)},
    {"label": "car", "polygon": _rect(25, 40, 45, 58)},
    {"label": "cargroup", "polygon": _rect(50, 36, 70, 52)},
    {"label": "person", "polygon": [[75, 20], [85, 20], [82, 55], [76, 55]]},
    {"label": "person", "polygon": _rect(60, 10, 66, 30), "deleted": 1},
    {"label": "license plate", "polygon": _rect(15, 44, 20, 47)},
    {"label": "rider", "polygon": _rect(86, 30, 94, 50)},
]}


@pytest.fixture(scope="module")
def gt_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("gt")
    for name in ("jax", "port"):
        d = root / name / "gtFine" / "train" / "town"
        d.mkdir(parents=True)
        for i in range(2):
            (d / f"town_000000_00001{i}_gtFine_polygons.json").write_text(
                json.dumps(ANNOTATION))
    for enc in ("trainIds", "ids"):
        assert jgt.prepare(str(root / "jax"), encoding=enc, verbose=False) == 2
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            assert pgt.prepare(str(root / "port"), encoding=enc,
                               verbose=False) == 2
    return root / "jax", root / "port"


def test_prepare_gt_labels_bytes_equal(gt_trees):
    jroot, proot = gt_trees
    files = _files(jroot)
    assert files == _files(proot)
    pngs = [f for f in files if f.endswith(".png")]
    assert len(pngs) == 8          # 2 files x label / instance x 2 encodings
    for f in pngs:
        assert _bytes(jroot / f) == _bytes(proot / f), f
    inst = np.array(Image.open(jroot / [f for f in pngs
                                        if "instanceIds" in f][0]))
    assert {26000, 26001, 24000} <= set(np.unique(inst))


def test_prepare_gt_labels_cli(tmp_path, gt_trees):
    jroot, _ = gt_trees
    shutil.copytree(jroot / "gtFine", tmp_path / "gtFine")
    for f in (tmp_path / "gtFine").rglob("*.png"):
        f.unlink()
    assert _strict(pgt.main, [str(tmp_path), "--kinds", "instance",
                              "--device", "cpu"]) == 0
    for f in _files(tmp_path):
        if f.endswith(".png"):
            assert _bytes(tmp_path / f) == _bytes(jroot / f), f


# -- kitti2cityscapes_semantic ----------------------------------------------------

def _kitti_pair(seed, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    sem = rng.choice([0, 5, 7, 11, 24, 26, 28, 31, 33, 34, 37, 44, 200, 255],
                     size=(24, 40)).astype(dtype)
    inst = (sem.astype(np.int64) * 1000
            + rng.randint(0, 999, size=sem.shape)).astype(np.int32)
    return sem, inst


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_kitti_convert_pair_equals_jax(dtype):
    sem, inst = _kitti_pair(1, dtype)
    for got, want in zip(pkitti.convert_pair(sem, inst),
                         jkitti.convert_pair(sem, inst)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_kitti_id_above_255_converts_to_zero():
    sem, inst = _kitti_pair(2, np.uint16)
    wide = sem.copy()
    wide[::3, ::5] = 300
    wide[1, 1] = 65535
    with pytest.raises(IndexError):
        jkitti.convert_pair(wide, inst)
    new_sem, new_inst = pkitti.convert_pair(wide, inst)
    above = wide > 255
    assert (new_sem[above] == 0).all() and (new_inst[above] == 0).all()
    want_sem, want_inst = jkitti.convert_pair(sem, inst)
    np.testing.assert_array_equal(new_sem[~above], want_sem[~above])
    np.testing.assert_array_equal(new_inst[~above], want_inst[~above])


def _kitti_tree(root, seed):
    base = root / "leftImg8bit_sequence" / "2013_05_28" / "drive_0003"
    for i in range(2):
        sem, inst = _kitti_pair(seed + i)
        for kind, arr in (("semantic", sem), ("instance", inst)):
            d = base / "image_00" / kind
            d.mkdir(parents=True, exist_ok=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                Image.fromarray(arr, mode="I" if arr.dtype == np.int32
                                else None).save(d / f"{i:010d}.png")


def test_kitti_tree_bytes_equal(tmp_path):
    _kitti_tree(tmp_path, seed=3)
    assert jkitti.convert_tree(tmp_path, "*/*/*/semantic/*.png",
                               tmp_path / "jax") == 2
    assert _strict(pkitti.main, ["--root", str(tmp_path), "--out",
                                 str(tmp_path / "port"), "--device",
                                 "cpu"]) == 0
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and len(files) == 4
    assert any(f.startswith("train_instance/drive_0003/image_00/")
               for f in files)
    for f in files:
        assert _bytes(tmp_path / "jax" / f) == _bytes(tmp_path / "port" / f), f


@pytest.mark.parametrize("main", [pgt.main, pkitti.main],
                         ids=["prepare_gt_labels", "kitti2cityscapes_semantic"])
def test_host_tools_refuse_a_device_other_than_the_cpu(tmp_path, main):
    """Both tools place nothing on a device: ``--device cuda`` is an error,
    not a flag without effect."""
    args = ([str(tmp_path)] if main is pgt.main else ["--root", str(tmp_path)])
    with pytest.raises(SystemExit) as err:
        main(args + ["--device", "cuda"])
    assert err.value.code == 2
