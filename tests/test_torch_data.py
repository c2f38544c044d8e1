"""The port's copies of ``c2m_tpu/data`` against the originals: the on-disk
datasets (Cityscapes, KITTI and MVTID layouts written by
``tools/make_synthetic_dataset.py``) give equal arrays key by key, frame
indices shift alike, ``.flow`` files cross between the packages, the label
tables are equal, and the loader gives the same batches in the same order
(epochs 1-3, with and without shuffle, host 0 and 1 of 2, ``drop_last``
both ways). The port's loader also starts an epoch at a given batch
without loading the ones before it (the trainer's resume). The port's
``tools/make_synthetic_dataset`` writes the JAX tool's trees: the same
files, byte for byte but for the rasterized flows and occlusions, which
stay within the rasterizer's gates.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

from c2m_tpu.config import Config
from c2m_tpu.data import cityscapes as jcity
from c2m_tpu.data import dataset as jdataset
from c2m_tpu.data import flow_io as jflow
from c2m_tpu.data import labels as jlabels
from c2m_tpu.data import loader as jloader
from c2m_tpu_torch.data import cityscapes as pcity
from c2m_tpu_torch.data import dataset as pdataset
from c2m_tpu_torch.data import flow_io as pflow
from c2m_tpu_torch.data import labels as plabels
from c2m_tpu_torch.data import loader as ploader
from c2m_tpu_torch.data.synthetic import make_batch
from tests.torch_port_fixtures import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STYLES = ("cityscapes", "kitti", "mvtid")


def make_dataset(root, style):
    """``tools/make_synthetic_dataset.py`` in this process (its raster
    compile is then paid once for the three layouts): 3 clips per split,
    64x128, 4 objects."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import make_synthetic_dataset as tool
    finally:
        sys.path.pop(0)
    argv = sys.argv
    sys.argv = ["make_synthetic_dataset.py", "--root", root, "--clips", "3",
                "--height", "64", "--width", "128", "--max-objects", "4",
                "--style", style]
    try:
        tool.main()
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for style in STYLES:
        out[style] = str(tmp_path_factory.mktemp(f"c2m_{style}"))
        make_dataset(out[style], style)
    return out


@pytest.fixture(scope="module")
def port_roots(tmp_path_factory):
    """The port's ``make_synthetic_dataset`` with the arguments of
    :func:`make_dataset`, on the CPU, with Pillow's DeprecationWarning
    raised as an error (it writes no ``I`` image)."""
    from c2m_tpu_torch.tools import make_synthetic_dataset as tool
    out = {}
    for style in STYLES:
        out[style] = str(tmp_path_factory.mktemp(f"port_{style}"))
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            assert tool.main(["--root", out[style], "--clips", "3",
                              "--height", "64", "--width", "128",
                              "--max-objects", "4", "--style", style,
                              "--device", "cpu"]) == 0
    return out


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _is_raster(path):
    return path.endswith(".flow") or "occlusion" in path or "_occ" in path


@pytest.mark.parametrize("style", STYLES)
def test_port_dataset_tool_writes_the_same_files(roots, port_roots, style):
    """Frames, semantic and instance maps, data lists and trajectory txts
    byte for byte; the flows and occlusions are checked below."""
    files = _tree(roots[style])
    assert files == _tree(port_roots[style])
    assert any(f.endswith(".flow") for f in files)
    assert any("instance" in f.lower() for f in files)
    for f in files:
        if not _is_raster(f):
            with open(os.path.join(roots[style], f), "rb") as a, \
                    open(os.path.join(port_roots[style], f), "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("style", STYLES)
def test_port_dataset_tool_flows_within_raster_gates(roots, port_roots,
                                                     style):
    """The JAX tool rasterizes with JAX, the port with its own rasterizer:
    the gates of tests/test_torch_raster.py, flows 1e-5 x the flow scale
    where both give a flow, their support and the occlusions differing on
    at most 1e-4 of the pixels."""
    from PIL import Image
    scale = 1e-5 * (128 - 1) / 2
    rasters = [f for f in _tree(roots[style]) if _is_raster(f)]
    assert any(f.endswith(".flow") for f in rasters)
    for f in rasters:
        a, b = (os.path.join(r[style], f) for r in (roots, port_roots))
        if f.endswith(".flow"):
            want, got = jflow.read_flow(a), pflow.read_flow(b)
            same = (got != 0).any(-1) == (want != 0).any(-1)
            assert 1.0 - same.mean() <= 1e-4, f
            np.testing.assert_allclose(got[same], want[same], atol=scale,
                                       rtol=0, err_msg=f)
        else:
            want, got = np.array(Image.open(a)), np.array(Image.open(b))
            assert got.shape == want.shape and np.mean(got != want) <= 1e-4


def test_port_tools_refuse_instance_ids_outside_16_bits(tmp_path):
    from c2m_tpu_torch.tools import write_instance_png
    for bad in (70000, -1):
        with pytest.raises(ValueError, match="16 bits"):
            write_instance_png(str(tmp_path / "x.png"),
                               np.array([[bad]], np.int32))


def jax_cfg(root, style, use_fw_of=False):
    """The configs of ``tests/test_data.py`` for each layout."""
    cfg = Config()
    dp = cfg.dataset_params
    dp.root = root
    dp.max_objects = 4
    cfg.train_params.input_size = [64, 128]
    cfg.test_params.input_size = [64, 128]
    cfg.train_params.batch_size = 2
    cfg.train_params.use_fw_of = use_fw_of
    if style == "kitti":
        dp.dataset = "kitti"
        dp.segmask_suffix = "_ssmask.png"
        dp.instance_suffix = "_instanceIds.png"
        dp.bw_of_suffix = "_flow_backward.flow"
        dp.bw_occ_suffix = "_occlusion_bw.png"
        dp.fw_of_suffix = "_flow_forward.flow"
        dp.fw_occ_suffix = "_occlusion_fw.png"
    elif style == "mvtid":
        dp.dataset = "mvtid"
        dp.segmask_suffix = "gtFine_labelIds.png"
        dp.instance_suffix = "gtFine_instanceIds.png"
        dp.bw_of_suffix = "flow_backward.flow"
        dp.bw_occ_suffix = "occlusion_bw.png"
    return cfg.validate()


def assert_same_sample(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "name":
            assert got[k] == want[k]
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("style,split,fw", [
    ("cityscapes", "train", False), ("cityscapes", "val", False),
    ("cityscapes", "train", True), ("kitti", "train", False),
    ("kitti", "val", True), ("mvtid", "train", False), ("mvtid", "val", False)])
def test_datasets_give_equal_samples(roots, style, split, fw):
    cfg = jax_cfg(roots[style], style, use_fw_of=fw)
    get = "get_training_set" if split == "train" else "get_test_set"
    want = getattr(jdataset, get)(cfg)
    got = getattr(pdataset, get)(port_cfg(cfg))
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == 3
    for i in range(len(want)):
        assert_same_sample(got[i], want[i])


def test_lambda_traj_amplification_is_the_same(roots):
    cfg = jax_cfg(roots["cityscapes"], "cityscapes")
    want = jcity.ClipDataset(cfg, split="val", lambda_traj=2.0)
    got = pcity.ClipDataset(port_cfg(cfg), split="val", lambda_traj=2.0)
    for i in range(len(want)):
        assert_same_sample(got[i], want[i])


@pytest.mark.parametrize("name,delta", [
    ("aachen/aachen_000001_000019_leftImg8bit.png", 2),
    ("x_000000_000099_gtFine_instanceIds.png", 1),
    ("drive0001/0000000019.png", 2),
    ("drive0001/0000000019_flow_backward.flow", 3),
    ("2011_09_26_drive_0001_sync_0000000099.png", 1),
    ("aachen/aachen_000001_000019_leftImg8bit.png", -19)])
def test_shift_frame_index_is_the_same(name, delta):
    assert pcity.shift_frame_index(name, delta) == \
        jcity.shift_frame_index(name, delta)


def test_shift_frame_index_refuses_alike():
    for mod in (jcity, pcity):
        with pytest.raises(ValueError):
            mod.shift_frame_index("nounderscoreindex.png", 1)


def test_flow_files_cross_between_the_packages(tmp_path):
    flow = np.random.RandomState(0).randn(16, 24, 2).astype(np.float32)
    jflow.write_flow(str(tmp_path / "j.flow"), flow)
    pflow.write_flow(str(tmp_path / "p.flow"), flow)
    assert (tmp_path / "j.flow").read_bytes() == \
        (tmp_path / "p.flow").read_bytes()
    np.testing.assert_array_equal(pflow.read_flow(str(tmp_path / "j.flow")),
                                  flow)
    np.testing.assert_array_equal(jflow.read_flow(str(tmp_path / "p.flow")),
                                  flow)
    (tmp_path / "bad.flow").write_bytes(b"\0" * 16)
    for mod in (jflow, pflow):
        with pytest.raises(ValueError):
            mod.read_flow(str(tmp_path / "bad.flow"))


def test_resizers_are_the_same(roots):
    rng = np.random.RandomState(1)
    flow = rng.randn(32, 48, 2).astype(np.float32)
    np.testing.assert_array_equal(pcity._resize_bilinear_np(flow, (64, 128)),
                                  jcity._resize_bilinear_np(flow, (64, 128)))
    path = os.path.join(roots["cityscapes"], "x.flow")
    jflow.write_flow(path, flow)
    np.testing.assert_array_equal(pcity.load_flow_resized(path, (64, 128)),
                                  jcity.load_flow_resized(path, (64, 128)))


def test_label_tables_are_equal():
    for name in ("LABELS", "ID_TO_TRAINID", "TRAINID_TO_NAME",
                 "TRAINID_TO_COLOR", "THING_TRAINIDS",
                 "KITTI360_EXTRA_ID_TO_TRAINID", "KITTI360_ID_TO_TRAINID"):
        assert getattr(plabels, name) == getattr(jlabels, name), name
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(plabels.id_to_trainid(ids),
                                  jlabels.id_to_trainid(ids))
    np.testing.assert_array_equal(plabels.kitti360_id_to_trainid(ids),
                                  jlabels.kitti360_id_to_trainid(ids))


class Numbered:
    """n samples {"i": i, "name": str(i)}, counting the loads."""

    def __init__(self, n):
        self.n, self.loaded = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.loaded.append(i)
        return {"i": np.int64(i), "x": np.full((2, 3), i, np.float32),
                "name": str(i)}


def batches_of(loader):
    return [(b["i"].tolist(), b["x"].tolist(), b["names"]) for b in loader]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("host,hosts", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_gives_the_same_batches(shuffle, host, hosts, drop_last):
    kw = dict(batch_size=2, shuffle=shuffle, seed=5, num_workers=2,
              drop_last=drop_last, host_id=host, num_hosts=hosts)
    want_loader = jloader.DataLoader(Numbered(7), **kw)
    got_loader = ploader.DataLoader(Numbered(7), **kw)
    for epoch in (1, 2, 3):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        assert len(got_loader) == len(want_loader)
        want = batches_of(want_loader)
        assert batches_of(got_loader) == want
        assert [b.tolist() for b in got_loader.batch_indices()] == \
            [w[0] for w in want]


def test_loader_starts_an_epoch_at_a_batch_without_loading_the_ones_before():
    want = batches_of(ploader.DataLoader(Numbered(9), batch_size=2, seed=3))
    data = Numbered(9)
    loader = ploader.DataLoader(data, batch_size=2, seed=3)
    loader.set_epoch(0, start=3)
    assert batches_of(loader) == want[3:]
    assert sorted(data.loaded) == sorted(i for w in want[3:] for i in w[0])
    loader.set_epoch(0)
    assert batches_of(loader) == want


def test_collate_is_the_same():
    samples = [Numbered(3)[i] for i in range(3)]
    want, got = jloader.collate(samples), ploader.collate(samples)
    assert want.keys() == got.keys() and got["names"] == want["names"]
    for k in ("i", "x"):
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_dataset_is_the_jax_packages_with_the_ports_batches():
    """The same clip seeds as the JAX package's SyntheticDataset (train
    seeds 0.., val 10000.. of 8 clips); each clip is the port's
    ``make_batch`` at batch 1, held to the JAX package's by
    ``tests/test_torch_config.py``."""
    cfg = jax_cfg("unused", "cityscapes")
    cfg.dataset_params.dataset = "synthetic"
    pcfg = port_cfg(cfg)
    for get in ("get_training_set", "get_test_set"):
        want = getattr(jdataset, get)(cfg)
        got = getattr(pdataset, get)(pcfg, device="cpu")
        assert (len(got), got.seed_offset) == (len(want), want.seed_offset)
    got = pdataset.get_test_set(pcfg, device="cpu")
    clip = make_batch(pcfg, batch_size=1, seed=10_001, device="cpu")
    assert_same_sample(got[1], {k: v[0] for k, v in clip.items()})
    for mod, c in ((jdataset, cfg), (pdataset, pcfg)):
        c.dataset_params.dataset = "nope"
        with pytest.raises(ValueError):
            mod.get_training_set(c)


def test_collate_pinned_holds_the_collated_batch(monkeypatch):
    """``collate_pinned`` gives ``collate``'s arrays as tensors. A CPU-only
    PyTorch has no page-locked memory, so the test allocates unpinned and
    records that pinning was asked for."""
    empty = torch.empty
    asked = []

    def unpinned(*args, pin_memory=False, **kwargs):
        asked.append(pin_memory)
        return empty(*args, **kwargs)
    monkeypatch.setattr(ploader.torch, "empty", unpinned)
    samples = [{"x": np.random.RandomState(i).rand(2, 3).astype(np.float32),
                "m": np.array([i % 2 == 0, True]), "n": np.int32(i),
                "name": f"c{i}"} for i in range(3)]
    want, got = ploader.collate(samples), ploader.collate_pinned(samples)
    assert got.keys() == want.keys() and got["names"] == want["names"]
    assert asked == [True] * 3
    for k in ("x", "m", "n"):
        assert isinstance(got[k], torch.Tensor)
        assert got[k].numpy().dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])
