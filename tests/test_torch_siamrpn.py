"""The port's SiamRPN++ (c2m_tpu_torch/models/siamrpn.py), its bridge and
its tracker against the JAX package on the CPU.

- Modules: ``Bottleneck`` in each stride / dilation / downsample case of
  the atrous ResNet, ``AdjustLayer`` with and without its centre crop, and
  ``xcorr_depthwise``, against their Flax counterparts within 1e-4 abs +
  1e-4 relative to the largest output.
- The whole net: ``features`` at 127 and 255 and ``heads`` on them within
  1e-4 of the largest output, on seeded weights whose residual branches
  are damped (``torch_seeded_nets.damp_residuals_``: undamped, float32
  rounding alone moved the boxes by more than 1e-3 px within 8 frames)
  and whose BatchNorm statistics are set from one forward of a template
  and a search crop of the test's frames (``torch_seeded_nets.calibrate_bn_``).
- Naming: the port's state_dict through ``tools/convert_siamrpn.convert``
  gives exactly the JAX tree and the bridge's output (that converter
  reports no unmapped key; the bridge does, and refuses a leaf too many
  or too few); pysot's checkpoint layout loads strictly through the
  trajectory CLI's loader.
- ``generate_anchors`` and ``get_subwindow`` equal to the JAX ones.
- The tracker: one JAX ``SiamRPNTracker`` and one port tracker with the
  same weights over 8 frames of a moving box: the same anchor on every
  frame and boxes within 1e-3 px. The JAX side's pscore is read where it
  picks its anchor, and its top-two margin must exceed 1e-3 on every
  frame, so that the agreement means something (the weights' seed, 13,
  was picked for that).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c2m_tpu.models import siamrpn as jsr
from tests.torch_seeded_nets import Pair, calibrate_bn_, damp_residuals_
from c2m_tpu_torch.models import siamrpn as psr
from c2m_tpu_torch.tools import generate_trajectories as gtraj
from c2m_tpu_torch.utils import convert
from tests.torch_metric_fixtures import seeded, within
from tests.torch_port_fixtures import random_leaves
from tests.torch_preprocess_fixtures import (jax_variables, nhwc,
                                             port_module, to_nhwc)
from tools.convert_siamrpn import convert as tool_convert

H, W = 240, 320
N_FRAMES = 8
BOX0 = (100.0, 90.0, 48.0, 36.0)
_CACHE = {}


def frames():
    """A textured background and a textured box moving 3 px right and 1 px
    down per frame, uint8 [H, W, 3]."""
    if "frames" not in _CACHE:
        rng = np.random.RandomState(0)
        bg = rng.randint(40, 160, (H, W, 3)).astype(np.uint8)
        tex = rng.randint(150, 255, (int(BOX0[3]), int(BOX0[2]), 3))
        out = []
        for f in range(N_FRAMES):
            img = bg.copy()
            x, y = int(BOX0[0]) + 3 * f, int(BOX0[1]) + f
            img[y:y + tex.shape[0], x:x + tex.shape[1]] = tex
            out.append(img)
        _CACHE["frames"] = out
    return _CACHE["frames"]


def crops():
    """The template and search crops the tracker takes from frame 0."""
    cfg = psr.TrackConfig()
    img = frames()[0]
    pos = np.array([BOX0[0] + (BOX0[2] - 1) / 2, BOX0[1] + (BOX0[3] - 1) / 2])
    s_z = np.sqrt((BOX0[2] + 0.5 * (BOX0[2] + BOX0[3]))
                  * (BOX0[3] + 0.5 * (BOX0[2] + BOX0[3])))
    avg = img.mean(axis=(0, 1))
    z = psr.get_subwindow(img, pos, cfg.exemplar_size, round(s_z), avg)
    x = psr.get_subwindow(img, pos, cfg.instance_size,
                          round(s_z * cfg.instance_size / cfg.exemplar_size),
                          avg)
    return z[None], x[None]


def net_and_variables():
    if "net" not in _CACHE:
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: jsr.SiamRPNpp().init(
            key, jnp.zeros((1, 127, 127, 3)), jnp.zeros((1, 255, 255, 3))))
        net = psr.SiamRPNpp()
        net.load_state_dict(convert.siamrpn_from_jax(random_leaves(shapes, 13)))
        net.eval()
        damp_residuals_(net)
        z, x = crops()
        calibrate_bn_(Pair(net), (torch.from_numpy(z), torch.from_numpy(x)))
        with torch.no_grad():                # spread the fusion weights
            net.rpn_head.cls_weight.copy_(torch.tensor([0.3, -0.2, 0.5]))
            net.rpn_head.loc_weight.copy_(torch.tensor([-0.4, 0.1, 0.2]))
        _CACHE["net"] = (net, convert.siamrpn_to_jax(net.state_dict()),
                         shapes)
    return _CACHE["net"]


def jax_tracker():
    """One JAX tracker (its constructor jits ``features`` and ``heads``)."""
    if "tracker" not in _CACHE:
        _, variables, _ = net_and_variables()
        _CACHE["tracker"] = jsr.SiamRPNTracker(jsr.SiamRPNpp(), variables)
    return _CACHE["tracker"]


@pytest.mark.parametrize("stride,dilation,downsample,layer", [
    (1, 1, True, "layer1_0"), (2, 1, True, "layer2_0"),
    (1, 2, True, "layer3_0"), (1, 4, True, "layer4_0"),
    (1, 2, False, "layer3_1"), (1, 4, False, "layer4_2"),
])
def test_bottleneck_matches_flax(stride, dilation, downsample, layer):
    planes = 4
    c_in = 6 if downsample else planes * 4
    x = seeded((2, 13, 15, c_in), seed=dilation + stride)
    jmod = jsr.Bottleneck(planes, stride, dilation, has_downsample=downsample)
    variables = jax_variables(jmod, jnp.asarray(x), seed=stride * dilation)
    name, block = layer.split("_")
    port = port_module(psr.Bottleneck(c_in, planes, stride, dilation,
                                      downsample),
                       convert._siamrpn_entry, variables,
                       ("backbone", layer), f"backbone.{name}.{block}.")
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = to_nhwc(port(nhwc(x)))
    assert got.shape == want.shape
    assert within(got, want) <= 1.0


@pytest.mark.parametrize("width", [15, 31], ids=["cropped", "whole"])
def test_adjust_layer_matches_flax(width):
    x = seeded((1, width, width, 12), seed=width)
    jmod = jsr.AdjustLayer(8)
    variables = jax_variables(jmod, jnp.asarray(x), seed=7)
    port = port_module(psr.AdjustLayer(12, 8), convert._siamrpn_entry,
                       variables, ("neck_0",), "neck.downsample2.")
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = to_nhwc(port(nhwc(x)))
    assert got.shape == want.shape == ((1, 7, 7, 8) if width < 20
                                       else (1, width, width, 8))
    assert within(got, want) <= 1.0


def test_xcorr_depthwise_matches_jax():
    search = seeded((2, 9, 11, 5), seed=8)
    kernel = seeded((2, 3, 4, 5), seed=9)
    want = np.asarray(jsr.xcorr_depthwise(jnp.asarray(search),
                                          jnp.asarray(kernel)))
    got = to_nhwc(psr.xcorr_depthwise(nhwc(search), nhwc(kernel)))
    assert got.shape == want.shape == (2, 7, 8, 5)
    assert within(got, want) <= 1.0


def test_net_matches_the_jax_net():
    net, variables, _ = net_and_variables()
    tracker = jax_tracker()
    z, x = crops()
    jzf = tracker._features(variables, jnp.asarray(z))
    jxf = tracker._features(variables, jnp.asarray(x))
    jcls, jloc = tracker._heads(variables, jzf, jxf)
    with torch.no_grad():
        zf = net.features(torch.from_numpy(z))
        xf = net.features(torch.from_numpy(x))
        cls, loc = net.heads(zf, xf)
    for got, want, shape in zip(zf + xf, list(jzf) + list(jxf),
                                [(1, 7, 7, 256)] * 3 + [(1, 31, 31, 256)] * 3):
        assert got.shape == want.shape == shape
        assert within(got.numpy(), want, abs_=0.0) <= 1.0
    for got, want, c in ((cls, jcls, 10), (loc, jloc, 20)):
        assert got.shape == want.shape == (1, 25, 25, c)
        assert np.abs(want).max() > 0.1 and np.isfinite(want).all()
        assert within(got.numpy(), want, abs_=0.0) <= 1.0


def test_state_dict_names_are_the_checkpoints():
    net, variables, shapes = net_and_variables()
    params, stats = tool_convert(dict(net.state_dict()))
    want = convert.flatten({"params": params, "batch_stats": stats})
    got = convert.flatten(variables)
    paths = {"/".join(str(k.key) for k in p): tuple(leaf.shape)
             for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert set(want) == set(got) == set(paths)
    for path, shape in paths.items():
        assert want[path].shape == shape, path
        np.testing.assert_array_equal(want[path], got[path])


def test_bridge_round_trip_and_refusals(tmp_path):
    net, variables, _ = net_and_variables()
    path = str(tmp_path / "siamrpn.npz")
    convert.write_variables_npz(path, variables)
    back = convert.siamrpn_from_jax(convert.read_variables_npz(path))
    state = net.state_dict()
    for key, value in state.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], value), key
    flat = convert.flatten(variables)
    extra = dict(flat, **{"params/rpn_0/cls/head3/kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="not consumed"):
        convert.siamrpn_from_jax(convert.unflatten(extra))
    short = {k: v for k, v in flat.items() if k != "params/cls_weight"}
    with pytest.raises(KeyError, match="lack"):
        convert.siamrpn_from_jax(convert.unflatten(short))
    with pytest.raises(KeyError, match="no JAX path"):
        convert.siamrpn_to_jax({"rpn_head.rpn2.cls.head.5.weight":
                                torch.zeros(1)})
    pth = str(tmp_path / "siamrpn.pth")
    torch.save({"state_dict": state}, pth)
    loaded = gtraj.build_model(pth, "cpu").state_dict()
    for key, value in state.items():
        assert torch.equal(loaded[key], value), key


def test_generate_anchors_is_the_same():
    for cfg in (jsr.TrackConfig(), jsr.TrackConfig(ratios=(0.5, 1, 2),
                                                   scales=(4, 8))):
        pcfg = psr.TrackConfig(**vars(cfg))
        for size in (25, 17):
            np.testing.assert_array_equal(psr.generate_anchors(pcfg, size),
                                          jsr.generate_anchors(cfg, size))


@pytest.mark.parametrize("pos,original", [
    ((160.0, 120.0), 127), ((10.0, 20.0), 200), ((315.0, 235.0), 255),
    ((160.0, 120.0), 50),
], ids=["inside", "top-left", "bottom-right", "upscaled"])
def test_get_subwindow_is_the_same(pos, original):
    img = frames()[3]
    avg = img.mean(axis=(0, 1))
    for size in (127, 255):
        np.testing.assert_array_equal(
            psr.get_subwindow(img, np.array(pos), size, original, avg),
            jsr.get_subwindow(img, np.array(pos), size, original, avg))


class _ArgmaxRecorder:
    """Stands in for numpy in the JAX tracker's module: records the array
    each ``argmax`` picks from (the pscore of each ``track`` call)."""

    def __init__(self):
        self.picked = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argmax(self, a, *args, **kwargs):
        self.picked.append(np.array(a))
        return np.argmax(a, *args, **kwargs)


def test_tracker_matches_the_jax_tracker(monkeypatch):
    net, _, _ = net_and_variables()
    jt = jax_tracker()
    pt = psr.SiamRPNTracker(net)
    recorder = _ArgmaxRecorder()
    monkeypatch.setattr(jsr, "np", recorder)
    imgs = frames()
    jt.init(imgs[0], BOX0)
    pt.init(imgs[0], BOX0)
    for f in range(1, N_FRAMES):
        want = jt.track(imgs[f])
        got = pt.track(imgs[f])
        pscore = recorder.picked[-1]
        top = np.sort(pscore)[-2:]
        if top[1] - top[0] <= 1e-3:
            pytest.fail(f"fixture fault: frame {f}'s top-two pscore margin "
                        f"{top[1] - top[0]:.3g} is within 1e-3")
        assert pt.best == int(np.argmax(pscore)), f
        np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=0,
                                   atol=1e-3)
        assert abs(got["best_score"] - want["best_score"]) <= 1e-4
    assert len(recorder.picked) == N_FRAMES - 1
