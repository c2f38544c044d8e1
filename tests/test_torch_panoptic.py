"""The port's Panoptic-DeepLab (c2m_tpu_torch/models/panoptic_deeplab.py),
its bridge and the segmentation CLI against the JAX package on the CPU.

- Modules: ``HRModule`` at channels (4, 8, 16), ``ASPP`` and
  ``SeparableConv5`` against their Flax counterparts within 1e-4 abs +
  1e-4 relative to the largest output.
- The whole net at [1, 64, 128, 3], both ``upsample`` settings, within
  1e-4 of the largest output, on seeded weights whose BatchNorm statistics
  are set from one forward (``torch_seeded_nets.calibrate_bn_``). The JAX
  net is compiled once, with ``upsample=False``; its ``upsample=True`` outputs are
  the JAX module's own last step, ``resize_bilinear(..., align_corners=
  True)`` of those, applied here.
- Naming: the port's state_dict through ``tools/convert_panoptic.convert``
  gives exactly the JAX tree (paths and shapes of ``eval_shape``) and the
  bridge's output; the bridge's round trip is bit for bit and refuses a
  leaf too many or too few; a torch checkpoint of these names loads
  strictly through the CLI's loader.
- ``postprocess`` equal to the numpy one, map for map.
- ``generate_segmentation`` on 2 frames at ``--size 64 128`` writes the JAX
  tool's file contract, with maps equal to ``postprocess`` of the net.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from c2m_tpu.models import panoptic_deeplab as jpd
from c2m_tpu.ops.warp import resize_bilinear as jax_resize
from tests.torch_seeded_nets import calibrate_bn_
from c2m_tpu_torch.models import panoptic_deeplab as ppd
from c2m_tpu_torch.tools import generate_segmentation as gen
from c2m_tpu_torch.utils import convert
from tests.torch_metric_fixtures import seeded, within
from tests.torch_port_fixtures import LEVEL0, random_leaves
from tests.torch_preprocess_fixtures import (jax_variables, jnp_list, nhwc,
                                             port_module, to_nhwc)
from tools.convert_panoptic import convert as tool_convert

SHAPE = (1, 64, 128, 3)
_CACHE = {}


def net_and_variables():
    """(port net, its JAX variables, the JAX variables' eval_shape tree)."""
    if "net" not in _CACHE:
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: jpd.PanopticDeepLab().init(
            key, jnp.zeros(SHAPE, jnp.float32)))
        net = ppd.PanopticDeepLab()
        net.load_state_dict(convert.panoptic_from_jax(random_leaves(shapes, 3)))
        net.eval()
        calibrate_bn_(net, torch.from_numpy(seeded(SHAPE, -2.0, 2.0, 4)))
        _CACHE["net"] = (net, convert.panoptic_to_jax(net.state_dict()),
                         shapes)
    return _CACHE["net"]


def jax_outputs(x):
    """The JAX net's outputs at the decoder's resolution (one compile)."""
    if "apply" not in _CACHE:
        model = jpd.PanopticDeepLab(upsample=False)
        _CACHE["apply"] = jax.jit(
            lambda v, x: model.apply(v, x, train=False),
            compiler_options=LEVEL0)
    _, variables, _ = net_and_variables()
    return _CACHE["apply"](variables, jnp.asarray(x))


def test_hrmodule_matches_flax():
    channels = (4, 8, 16)
    xs = [seeded((1, 16 // 2 ** i, 32 // 2 ** i, c), seed=i)
          for i, c in enumerate(channels)]
    jmod = jpd.HRModule(channels)
    variables = jax_variables(jmod, jnp_list(xs), seed=1)
    port = port_module(ppd.HRModule(channels), convert._panoptic_entry,
                       variables, ("backbone", "stage2_0"),
                       "backbone.stage2.0.")
    want = jax.jit(lambda v, xs: jmod.apply(v, xs))(variables, jnp_list(xs))
    with torch.no_grad():
        got = port([nhwc(x) for x in xs])
    for g, w in zip(got, want):
        assert within(to_nhwc(g), w) <= 1.0


def test_aspp_matches_flax():
    x = seeded((2, 6, 10, 12), seed=2)
    jmod = jpd.ASPP(8)
    variables = jax_variables(jmod, jnp.asarray(x), seed=2)
    port = port_module(ppd.ASPP(12, 8), convert._panoptic_entry, variables,
                       ("semantic_decoder", "aspp"),
                       "decoder.semantic_decoder.aspp.")
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = to_nhwc(port(nhwc(x)))
    assert got.shape == want.shape
    assert within(got, want) <= 1.0


def test_separable_conv5_matches_flax():
    x = seeded((1, 9, 13, 6), seed=3)
    jmod = jpd.SeparableConv5(10)
    variables = jax_variables(jmod, jnp.asarray(x), seed=3)
    port = port_module(ppd.SeparableConv5(6, 10), convert._panoptic_entry,
                       variables, ("instance_decoder", "fuse_1"),
                       "decoder.instance_decoder.fuse.1.0.")
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = to_nhwc(port(nhwc(x)))
    assert within(got, want) <= 1.0


@pytest.mark.parametrize("upsample", [False, True])
def test_net_matches_the_jax_net(upsample):
    net, _, _ = net_and_variables()
    x = seeded(SHAPE, -2.0, 2.0, seed=5)
    want = {k: np.asarray(v) for k, v in jax_outputs(x).items()}
    if upsample:
        want = {k: np.asarray(jax_resize(jnp.asarray(v), SHAPE[1:3],
                                         align_corners=True))
                for k, v in want.items()}
    net.upsample = upsample
    try:
        with torch.no_grad():
            got = {k: v.numpy() for k, v in net(torch.from_numpy(x)).items()}
    finally:
        net.upsample = True
    hw = SHAPE[1:3] if upsample else (SHAPE[1] // 4, SHAPE[2] // 4)
    for key, chans in (("semantic", 19), ("center", 1), ("offset", 2)):
        assert got[key].shape == want[key].shape == (1, *hw, chans)
        assert np.abs(want[key]).max() > 0.1 and np.isfinite(want[key]).all()
        assert within(got[key], want[key], abs_=0.0) <= 1.0, key


def test_state_dict_names_are_the_checkpoints():
    """The port's keys are those tools/convert_panoptic.py reads: its
    conversion is the bridge's, leaf for leaf, over the JAX tree's paths."""
    net, variables, shapes = net_and_variables()
    params, stats = tool_convert(
        {k: v for k, v in net.state_dict().items()})
    want = convert.flatten({"params": params, "batch_stats": stats})
    got = convert.flatten(variables)
    paths = {"/".join(str(k.key) for k in p): tuple(leaf.shape)
             for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert set(want) == set(got) == set(paths)
    for path, shape in paths.items():
        assert want[path].shape == shape, path
        np.testing.assert_array_equal(want[path], got[path])


def test_bridge_round_trip_and_refusals():
    net, variables, _ = net_and_variables()
    back = convert.panoptic_from_jax(variables)
    for key, value in net.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], value), key
    flat = convert.flatten(variables)
    extra = dict(flat, **{"params/semantic_head/out/extra": np.zeros(1)})
    with pytest.raises(KeyError, match="not consumed"):
        convert.panoptic_from_jax(convert.unflatten(extra))
    short = {k: v for k, v in flat.items()
             if k != "params/backbone/stem1/Conv_0/kernel"}
    with pytest.raises(KeyError, match="lack"):
        convert.panoptic_from_jax(convert.unflatten(short))


def test_torch_checkpoint_loads_strictly(tmp_path):
    net, _, _ = net_and_variables()
    path = str(tmp_path / "panoptic.pth")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in net.state_dict().items()}}, path)
    loaded = gen.build_model(path, "cpu").state_dict()
    for key, value in net.state_dict().items():
        assert torch.equal(loaded[key], value), key


def _heads(h, w, seed, peaks, heat_scale=1.0):
    """Head outputs: 19-class logits with blobs of thing classes, a center
    heat with Gaussian peaks at ``peaks``, offsets towards the nearest peak
    plus noise."""
    rng = np.random.RandomState(seed)
    sem = rng.randn(h, w, 19).astype(np.float32)
    for cls in (11, 13, 14, 18):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 16)
        sem[y:y + 12, x:x + 24, cls] += 6.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    heat = np.zeros((h, w), np.float32)
    for py, px in peaks:
        heat = np.maximum(heat, np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / 8))
    heat *= heat_scale
    off = rng.randn(h, w, 2).astype(np.float32)
    if peaks:
        c = np.array(peaks, np.float32)
        d = ((yy[..., None] - c[:, 0]) ** 2 + (xx[..., None] - c[:, 1]) ** 2)
        near = c[d.argmin(-1)]
        off += np.stack([near[..., 0] - yy, near[..., 1] - xx], -1)
    return sem, heat[..., None], off


def _boundary_case():
    """Votes exactly between two centers (argmin's first index decides) and
    a hair off the midline (float32 vote positions would round onto it)."""
    h, w = 32, 48
    sem, heat, off = _heads(h, w, 11, [(10, 10), (10, 30)])
    sem[:] = -5.0
    sem[..., 13] = 5.0                          # all car
    yy, xx = np.mgrid[0:h, 0:w]
    off[..., 0] = 10.0 - yy
    off[..., 1] = 20.0 - xx                     # every vote at x = 20
    off[::2, :, 1] += np.float32(2.0 ** -20)    # just right of the midline
    return sem, heat, off


def _cases():
    rng = np.random.RandomState(0)
    many = rng.rand(64, 128).astype(np.float32)          # ~400 NMS peaks
    sem, _, off = _heads(64, 128, 1, [])
    return {
        "classes": _heads(64, 128, 2, [(10, 20), (30, 64), (50, 100),
                                       (12, 110)]),
        "top_k": (sem, many[..., None], off * 20),
        "no_centers": _heads(64, 128, 3, [(20, 20)], heat_scale=0.05),
        "boundary": _boundary_case(),
    }


@pytest.mark.parametrize("chunk", [None, 3 * 128 * 200],
                         ids=["one_chunk", "chunked"])
@pytest.mark.parametrize("case", ["classes", "top_k", "no_centers",
                                  "boundary"])
def test_postprocess_matches_numpy(case, chunk, monkeypatch):
    sem, heat, off = _cases()[case]
    if chunk is not None:
        monkeypatch.setattr(ppd, "_VOTE_CHUNK", chunk)
    want_sem, want_inst = jpd.postprocess(sem, heat, off)
    got_sem, got_inst = ppd.postprocess(*map(torch.from_numpy,
                                             (sem, heat, off)))
    assert got_sem.dtype == got_inst.dtype == torch.int32
    np.testing.assert_array_equal(got_sem.numpy(), want_sem)
    np.testing.assert_array_equal(got_inst.numpy(), want_inst)
    ids = np.unique(want_inst)
    if case == "no_centers":
        assert (ids == 0).all()
    else:
        assert (ids > 1000).sum() >= (1 if case == "boundary" else 3), ids


def test_generate_segmentation_cli(tmp_path):
    net, variables, _ = net_and_variables()
    weights = str(tmp_path / "panoptic.npz")
    convert.write_variables_npz(weights, variables)
    src = tmp_path / "raw" / "syntown"
    src.mkdir(parents=True)
    rng = np.random.RandomState(6)
    for f in range(3):
        Image.fromarray(rng.randint(0, 255, (96, 160, 3), np.uint8)).save(
            src / f"syntown_000000_{f:06d}_leftImg8bit.png")
    out_sem, out_inst = tmp_path / "sem", tmp_path / "inst"
    assert gen.main(["--images-root", str(tmp_path / "raw"),
                     "--out-semantic", str(out_sem), "--out-instance",
                     str(out_inst), "--weights", weights, "--size", "64",
                     "128", "--limit", "2", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out_sem / "syntown")) == [
        f"syntown_000000_{f:06d}_ssmask.png" for f in range(2)]
    assert sorted(os.listdir(out_inst / "syntown")) == [
        f"syntown_000000_{f:06d}_gtFine_instanceIds.png" for f in range(2)]
    for f in range(2):
        stem = f"syntown_000000_{f:06d}"
        sem = np.array(Image.open(out_sem / "syntown" / f"{stem}_ssmask.png"))
        inst = np.array(Image.open(
            out_inst / "syntown" / f"{stem}_gtFine_instanceIds.png"))
        assert sem.shape == inst.shape == (64, 128)
        assert sem.dtype == np.uint8 and sem.max() <= 18
        assert inst.dtype in (np.uint16, np.int32), inst.dtype
        assert all(11 <= v // 1000 <= 18 for v in np.unique(inst[inst > 0]))
        img = Image.open(src / f"{stem}_leftImg8bit.png").convert("RGB")
        x = (np.asarray(img.resize((128, 64), Image.BICUBIC), np.float32)
             / 255.0 - gen.MEAN) / gen.STD
        with torch.no_grad():
            out = net(torch.from_numpy(x)[None])
        want_sem, want_inst = ppd.postprocess(
            out["semantic"][0], out["center"][0], out["offset"][0])
        np.testing.assert_array_equal(sem, want_sem.numpy())
        np.testing.assert_array_equal(inst, want_inst.numpy())
