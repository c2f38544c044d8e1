"""The port's FlowNet2 and on-the-fly flow against the JAX package, on the
CPU, in float32.

The JAX parameter tree's structure comes from ``jax.eval_shape`` of
``FlowNet2.init``; its leaves are drawn with numpy (kernels
U(+-sqrt(5 / fan_in)) so that the signal survives the ~25 layers of a
sub-network, biases U(+-0.05)) and carried into the port by
``flownet2_from_jax``. Both sides get the same numpy inputs; the whole
stack gets smooth frames (sums of low-frequency sinusoids), because it warps
the second frame by its own intermediate flows three times, and on white
noise a float32 rounding that moves a sample across a pixel edge is
amplified beyond any fixed gate in both packages alike.

Gate: 1e-4 abs + 1e-4 rel on every flow (deep float32 conv stacks summed in
different orders by XLA and PyTorch's CPU kernels; flows reach tens of
pixels, hence the relative part). The confidence is a forward splat of the
flow (up to four bilinear weights per pixel land on a cell, each moving
with the flow's error), gated at 1e-3 abs.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.models import flownet2 as jax_fn
from c2m_tpu.train.flow_onthefly import OnTheFlyFlow as JaxOnTheFlyFlow
from c2m_tpu_torch.models import flownet2 as port_fn
from c2m_tpu_torch.train.flow_onthefly import OnTheFlyFlow
from c2m_tpu_torch.utils.convert import (flatten, flownet2_from_jax,
                                         flownet2_to_jax,
                                         module_state_from_jax, unflatten)

ATOL = RTOL = 1e-4
CONF_ATOL = 1e-3


def _random_params(seed=0):
    model = jax_fn.FlowNet2()
    probe = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), probe, probe))["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for keys, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = "/".join(str(k.key) for k in keys)
        shape = tuple(leaf.shape)
        if path.endswith("kernel"):
            # conv [kh, kw, in, out]; deconv [kh, kw, out, in], 4 of its 16
            # taps reach an output pixel
            fan_in = (shape[0] * shape[1] * shape[3] / 4
                      if "ConvTranspose" in path else np.prod(shape[:3]))
            bound = np.sqrt(5.0 / fan_in)
        else:
            bound = 0.05
        flat[path] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return unflatten(flat)


@pytest.fixture(scope="module")
def nets():
    params = _random_params()
    port = port_fn.FlowNet2()
    port.load_state_dict(flownet2_from_jax(params))
    return params, port.eval()


def _smooth_frames(rng, n, h, w):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((n, h, w, 3), np.float32)
    for i in range(n):
        for c in range(3):
            for _ in range(3):
                fy, fx, ph = rng.rand() * 0.2, rng.rand() * 0.2, rng.rand() * 6
                out[i, ..., c] += np.sin(ys * fy + xs * fx + ph) / 3
    return out


def _close(got, want, atol=ATOL, rtol=RTOL):
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=rtol)


def test_parameter_count_and_reference_keys(nets):
    _, port = nets
    n = sum(p.numel() for p in port.parameters())
    assert 162.4e6 < n < 162.6e6             # reference: 162.5M
    keys = set(port.state_dict())
    # the reference torch checkpoint's names
    for key in ("flownetc.conv1.0.weight", "flownetc.conv_redir.0.bias",
                "flownetc.predict_flow6.weight", "flownetc.deconv5.0.weight",
                "flownetc.upsampled_flow6_to_5.bias",
                "flownets_1.upsampled_flow6_to_5.weight",
                "flownets_d.inter_conv5.0.weight",
                "flownetfusion.upsampled_flow1_to_0.weight",
                "flownetfusion.predict_flow0.bias"):
        assert key in keys, key
    # FlowNetS's flow upsamplers have no bias; the other nets' have one
    assert "flownets_1.upsampled_flow6_to_5.bias" not in keys
    assert "flownets_2.upsampled_flow3_to_2.bias" not in keys
    assert "flownets_d.upsampled_flow3_to_2.bias" in keys


@pytest.mark.parametrize("name,cls,channels", [
    ("flownetc", jax_fn.FlowNetC, 6), ("flownets_1", jax_fn.FlowNetS, 12),
    ("flownets_2", jax_fn.FlowNetS, 12), ("flownets_d", jax_fn.FlowNetSD, 6),
    ("flownetfusion", jax_fn.FlowNetFusion, 11)])
def test_subnetwork_matches(nets, name, cls, channels):
    params, port = nets
    x = np.random.RandomState(1).randn(2, 64, 64, channels).astype(np.float32)
    want = cls().apply({"params": params[name]}, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(port, name)(torch.from_numpy(x))
    side = 64 if name == "flownetfusion" else 16
    assert got.shape == (2, side, side, 2)
    _close(got, want)


@pytest.mark.parametrize("hw", [(64, 128), (72, 100)])
def test_whole_stack_flow_and_confidence(nets, hw):
    """compute_flow_and_conf; 72x100 goes through the resize to 64x64 and
    the height-ratio rescale back."""
    params, port = nets
    rng = np.random.RandomState(2)
    a, b = _smooth_frames(rng, 2, *hw), _smooth_frames(rng, 2, *hw)
    # jitted at XLA's default optimization: the whole stack runs long
    # enough on the CPU that the compile pays for itself (on 8 cores 7.3 s
    # against 15.7 s eager and 10.2 s with the backend optimizations off)
    want_flow, want_conf = jax.jit(lambda p, x, y: jax_fn.compute_flow_and_conf(
        jax_fn.FlowNet2().apply, {"params": p}, x, y))(
        params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        flow, conf = port_fn.compute_flow_and_conf(
            port, torch.from_numpy(a), torch.from_numpy(b))
    assert flow.shape == (2, *hw, 2) and conf.shape == (2, *hw, 1)
    _close(flow, want_flow)
    _close(conf, want_conf, atol=CONF_ATOL, rtol=0)
    assert float(conf.min()) >= 0.0 and float(conf.max()) <= 1.0


def test_onthefly_flow_matches_the_jax_class(nets, tmp_path, monkeypatch):
    """Keys, shapes and the crossed naming (the confidence computed with the
    forward flow is ``target_bw_occ``), two input frames so that the input
    stream is there too; both classes read the same npz. The JAX class runs
    a Flax init of FlowNet2 (~40 s on the CPU) and then replaces what it
    made with the npz's parameters, so its init is stood in for here."""
    params, _ = nets
    monkeypatch.setattr(jax_fn.FlowNet2, "init",
                        lambda self, *args, **kwargs: {"params": params})
    path = str(tmp_path / "flownet2.npz")
    np.savez(path, params=np.asarray(params, dtype=object))
    video = _smooth_frames(np.random.RandomState(3), 4, 64, 64)[None] * 0.5 \
        + 0.5
    want = JaxOnTheFlyFlow(2, 2, weights_path=path)(jnp.asarray(video))
    otf = OnTheFlyFlow(2, 2, weights_path=path, device="cpu")
    got = otf(torch.from_numpy(video))
    assert set(got) == set(want) == {
        "input_of", "input_occ", "target_bw_of", "target_bw_occ",
        "target_fw_of", "target_fw_occ"}
    for key in sorted(want):
        assert got[key].shape == want[key].shape, key
        occ = key.endswith("occ")
        _close(got[key], want[key], atol=CONF_ATOL if occ else ATOL,
               rtol=0 if occ else RTOL)
    assert got["target_bw_of"].shape == (1, 2, 64, 64, 2)
    assert got["input_occ"].shape == (1, 1, 64, 64, 1)
    # forward and backward flows differ, so a swap of the names would show
    assert not np.allclose(np.asarray(want["target_bw_of"]),
                           np.asarray(want["target_fw_of"]), atol=1e-2)
    assert not any(p.requires_grad for p in otf.model.parameters())
    assert not got["target_bw_of"].requires_grad


def test_onthefly_flow_default_weights_are_seeded():
    a = OnTheFlyFlow(1, 1, device="cpu").model.state_dict()
    b = OnTheFlyFlow(1, 1, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_bridge_round_trip(nets):
    params, port = nets
    flat = flatten(params)
    back = flatten(flownet2_to_jax(port.state_dict()))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    broken = dict(flat)
    broken["flownetc/extra/Conv_0/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(KeyError):
        flownet2_from_jax(broken)
    del flat["flownetc/conv1/Conv_0/bias"]
    with pytest.raises(KeyError):
        flownet2_from_jax(flat)


@pytest.mark.parametrize("use_bias", [True, False])
def test_deconv_axis_map_with_unequal_widths(use_bias):
    """flax ``ConvTranspose(transpose_kernel=True)`` [kh, kw, out, in] ->
    torch ``ConvTranspose2d`` [in, out, kh, kw], 3 channels in, 5 out."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 6, 3).astype(np.float32)
    module = jax_fn.DeconvTorch(5, act=False, use_bias=use_bias)
    variables = module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda v: rng.uniform(-1, 1, v.shape).astype(np.float32), variables)
    want = module.apply(variables, jnp.asarray(x))
    port = port_fn.Deconv(3, 5, bias=use_bias)
    port.load_state_dict(module_state_from_jax(port, variables))
    assert port.weight.shape == (3, 5, 4, 4)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 8, 12, 5)
    _close(got, want, atol=1e-5, rtol=1e-5)
