"""Each training objective of the port against ``c2m_tpu/losses/losses.py``
on the CPU: same numpy inputs, float32, 1e-5 abs + 1e-5 rel (single
reductions over <= 1e5 float32 terms; the relative part is for the sums that
reach order 10). The perceptual loss runs a small stand-in feature extractor
on both sides (the VGG itself is held in tests/test_torch_vgg.py).
"""

import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.losses import losses as jl
from c2m_tpu_torch.losses import losses as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape):
    return rng.rand(*shape).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(float(got), float(want), err_msg=msg, **TOL)


def test_l1_masked_divides_by_the_full_element_count():
    rng = np.random.RandomState(0)
    a, b = _rand(rng, 2, 3, 8, 9, 2), _rand(rng, 2, 3, 8, 9, 2)
    m = (rng.rand(2, 3, 8, 9, 1) > 0.7).astype(np.float32)
    _close(tl.l1_masked(torch.as_tensor(a), torch.as_tensor(b)),
           jl.l1_masked(jnp.asarray(a), jnp.asarray(b)))
    got = tl.l1_masked(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(m))
    _close(got, jl.l1_masked(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)))
    _close(got, np.abs((a - b) * m).sum() / a.size)      # not / mask mass


def test_kl_loss():
    rng = np.random.RandomState(1)
    mu, logvar = rng.randn(3, 16).astype(np.float32), \
        rng.randn(3, 16).astype(np.float32) * 0.3
    _close(tl.kl_loss(torch.as_tensor(mu), torch.as_tensor(logvar)),
           jl.kl_loss(jnp.asarray(mu), jnp.asarray(logvar)))


def test_ssim_loss():
    rng = np.random.RandomState(2)
    x, y = _rand(rng, 2, 3, 12, 14, 3), _rand(rng, 2, 3, 12, 14, 3)
    _close(tl.ssim_loss(torch.as_tensor(x), torch.as_tensor(y)),
           jl.ssim_loss(jnp.asarray(x), jnp.asarray(y)))
    assert float(tl.ssim_loss(torch.as_tensor(x), torch.as_tensor(x))) < 1e-6


def test_smooth_loss():
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 3, 10, 12, 2).astype(np.float32)
    img = _rand(rng, 2, 3, 10, 12, 3)
    _close(tl.smooth_loss(torch.as_tensor(flow), torch.as_tensor(img)),
           jl.smooth_loss(jnp.asarray(flow), jnp.asarray(img)))


@pytest.mark.parametrize("masked", [False, True])
def test_flow_consistency_loss_and_its_gradient(masked):
    """Through K1 both ways: each flow is the image of one warp and the
    flow of the other, so the image and flow gradients of K1 both enter."""
    rng = np.random.RandomState(4)
    fw = (rng.randn(2, 3, 10, 12, 2) * 2).astype(np.float32)
    bw = (rng.randn(2, 3, 10, 12, 2) * 2).astype(np.float32)
    mf, mb = ((_rand(rng, 2, 3, 10, 12, 1), _rand(rng, 2, 3, 10, 12, 1))
              if masked else (None, None))

    def jloss(f, b):
        return jl.flow_consistency_loss(
            f, b, None if mf is None else jnp.asarray(mf),
            None if mb is None else jnp.asarray(mb), 3)

    want, (gf, gb) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(fw), jnp.asarray(bw))
    tf, tb = torch.tensor(fw, requires_grad=True), torch.tensor(bw,
                                                                requires_grad=True)
    got = tl.flow_consistency_loss(
        tf, tb, None if mf is None else torch.as_tensor(mf),
        None if mb is None else torch.as_tensor(mb), 3)
    _close(got, want)
    got.backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **TOL)


def _taps(x, lib):
    """A stand-in feature extractor with VGG's tap names: fixed polynomial
    maps of the input, so both frameworks compute the same features."""
    names = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1",
             "relu2_2", "relu3_4", "relu4_4", "relu5_2")
    cat = jnp.concatenate if lib is jnp else torch.cat
    return {n: cat([x * (i + 1), x * x - 0.1 * i], -1)[:, ::(i % 3) + 1]
            for i, n in enumerate(names)}


@pytest.mark.parametrize("style_weight", [0.0, 2.0])
def test_perceptual_loss_and_target_side_detached(style_weight):
    rng = np.random.RandomState(5)
    gt, fake = _rand(rng, 2, 3, 12, 10, 3), _rand(rng, 2, 3, 12, 10, 3)

    def jloss(g, f):
        out = jl.perceptual_loss(lambda x: _taps(x, jnp), g, f, style_weight)
        return sum(out.values()), out

    (_, want), (gg, gf) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jnp.asarray(gt),
                                                           jnp.asarray(fake))
    tg, tf = torch.tensor(gt, requires_grad=True), torch.tensor(
        fake, requires_grad=True)
    got = tl.perceptual_loss(lambda x: _taps(x, torch), tg, tf, style_weight)
    assert set(got) == set(want) == ({"perceptual", "style"} if style_weight
                                     else {"perceptual"})
    for k in want:
        _close(got[k], want[k], k)
    sum(got.values()).backward()
    assert tg.grad is None and not np.asarray(gg).any()     # target detached
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), **TOL)


def test_perceptual_loss_accumulates_bfloat16_taps_in_float32():
    rng = np.random.RandomState(6)
    gt, fake = _rand(rng, 1, 2, 8, 8, 3), _rand(rng, 1, 2, 8, 8, 3)
    out = tl.perceptual_loss(lambda x: _taps(x.bfloat16(), torch),
                             torch.as_tensor(gt), torch.as_tensor(fake))
    assert out["perceptual"].dtype == torch.float32


def test_masked_theta_losses():
    rng = np.random.RandomState(7)
    th, gt = rng.randn(3, 5, 4, 6).astype(np.float32), \
        rng.randn(3, 5, 4, 6).astype(np.float32)
    for mask in (rng.rand(3, 5) > 0.4, np.zeros((3, 5), bool)):
        want = jl.masked_theta_losses(jnp.asarray(th), jnp.asarray(gt),
                                      jnp.asarray(mask))
        got = tl.masked_theta_losses(torch.as_tensor(th), torch.as_tensor(gt),
                                     torch.as_tensor(mask))
        assert set(got) == set(want) == {"translation", "scale", "rotation"}
        for k in want:
            _close(got[k], want[k], k)


def test_gan_mse_loss_reads_the_last_batch_element_only():
    rng = np.random.RandomState(8)
    pred = rng.randn(4, 6, 7, 1).astype(np.float32)
    for real in (True, False):
        got = tl.gan_mse_loss(torch.as_tensor(pred), real)
        _close(got, jl.gan_mse_loss(jnp.asarray(pred), real))
        _close(got, np.mean((pred[-1] - float(real)) ** 2))
    other = pred.copy()
    other[:-1] += 5.0                       # the other elements do not count
    assert float(tl.gan_mse_loss(torch.as_tensor(other), True)) == \
        float(tl.gan_mse_loss(torch.as_tensor(pred), True))


def test_feature_matching_loss_detaches_the_real_side():
    rng = np.random.RandomState(9)
    real = [_rand(rng, 2, 8 // s, 8 // s, 4 * s) for s in (1, 2, 4)]
    fake = [_rand(rng, 2, 8 // s, 8 // s, 4 * s) for s in (1, 2, 4)]
    want = jl.feature_matching_loss([jnp.asarray(a) for a in real],
                                    [jnp.asarray(a) for a in fake])
    treal = [torch.tensor(a, requires_grad=True) for a in real]
    tfake = [torch.tensor(a, requires_grad=True) for a in fake]
    got = tl.feature_matching_loss(treal, tfake)
    _close(got, want)
    got.backward()
    assert all(t.grad is None for t in treal)
    assert all(t.grad is not None for t in tfake)
    half = tl.feature_matching_loss([t.bfloat16() for t in treal],
                                    [t.bfloat16() for t in tfake])
    assert half.dtype == torch.float32


@pytest.mark.parametrize("use_fw,smooth", [(False, 0.0), (True, 0.5)])
def test_training_losses(use_fw, smooth):
    """The whole generator-side objective, term by term, with the forward
    flow terms and the smoothness term switched on in the second case."""
    rng = np.random.RandomState(10)
    b, t, h, w, n = 2, 3, 16, 24, 4
    batch = {"video": _rand(rng, b, t + 1, h, w, 3),
             "target_bw_of": rng.randn(b, t, h, w, 2).astype(np.float32),
             "target_bw_occ": (rng.rand(b, t, h, w, 1) > 0.3).astype(np.float32),
             "target_fw_of": rng.randn(b, t, h, w, 2).astype(np.float32),
             "target_fw_occ": (rng.rand(b, t, h, w, 1) > 0.3).astype(np.float32),
             "targets_theta": rng.randn(b, n, t, 6).astype(np.float32),
             "node_mask": rng.rand(b, n) > 0.3}
    out = {"dense_motion_bw": (rng.randn(b, t, h, w, 2) * 2).astype(np.float32),
           "dense_motion_fw": (rng.randn(b, t, h, w, 2) * 2).astype(np.float32),
           "occlusion_bw": _rand(rng, b, t, h, w, 1),
           "occlusion_fw": _rand(rng, b, t, h, w, 1),
           "generated": _rand(rng, b, t, h, w, 3),
           "mu": rng.randn(b, 8).astype(np.float32),
           "logvar": rng.randn(b, 8).astype(np.float32) * 0.2,
           "thetas": rng.randn(b, n, t, 6).astype(np.float32)}
    weights = types.SimpleNamespace(flow_smooth=smooth, perceptual=10.0,
                                    style=0.0)
    tp = types.SimpleNamespace(loss_weights=weights, num_input_frames=1,
                               num_predicted_frames=t, use_fw_of=use_fw)
    # jitted: one compile, where eager JAX compiles each operation alone
    want = jax.jit(lambda bb, oo: jl.training_losses(
        tp, bb, oo, lambda x: _taps(x, jnp)))(
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in out.items()})
    got = tl.training_losses(tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                             {k: torch.as_tensor(v) for k, v in out.items()},
                             lambda x: _taps(x, torch))
    assert set(got) == set(want)
    assert ("flowcon" in got) == use_fw and ("flow_smooth" in got) == (smooth > 0)
    for k in want:
        _close(got[k], want[k], k)
