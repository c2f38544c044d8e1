"""Kernel K1's gradients and forward on the CPU against the JAX package.

The port's ``resample`` / ``resample_masked`` on CPU tensors run the plain
PyTorch version, forward and (through autograd) backward; this is what the
CUDA backward kernel is held against on the card. Here it is held against
``jax.grad`` of ``c2m_tpu.ops.warp.resample(use_pallas=False)`` (the jnp
path the JAX train step differentiates), for the image, the flow and the
mask, at 1e-5 abs plus one ulp of the source coordinate (W·2^-23) times the
summed size of a gradient's terms, as stated where it is used. The forward is also held against the Pallas kernel run in
interpret mode, as ``tests/test_pallas.py`` runs it.

Flows are random floats: a source coordinate exactly on a cell boundary or
exactly on the image border (where the gradient of floor/clip is a tie) has
measure zero; many coordinates do fall OUTSIDE the image, where the clamp's
gradient must be zero.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.ops.warp import resample as jax_resample
from c2m_tpu_torch.ops.warp import resample, resample_masked

ATOL = 1e-5


def _inputs(shape, seed, spread):
    b, h, w, c = shape
    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w, c).astype(np.float32)
    flow = ((rng.rand(b, h, w, 2) - 0.5) * spread).astype(np.float32)
    mask = rng.rand(b, h, w, 1).astype(np.float32)
    gout = rng.randn(b, h, w, c).astype(np.float32)
    return img, flow, mask, gout


# (shape, flow spread in pixels): a small odd shape with most samples
# clamped, a decoder-skip shape, a full-resolution RGB frame
CASES = [((2, 9, 13, 5), 30.0), ((2, 16, 32, 24), 12.0), ((1, 64, 128, 3), 16.0)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape,spread", CASES)
def test_gradients_match_jax_grad(shape, spread, masked):
    img, flow, mask, gout = _inputs(shape, 0, spread)

    def jloss(i, f, m):
        out = jax_resample(i, f, use_pallas=False)
        if masked:
            out = out * m
        return jnp.sum(out * gout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(flow), jnp.asarray(mask))
    ti, tf, tm = (torch.tensor(a, requires_grad=True) for a in (img, flow, mask))
    out = resample_masked(ti, tf, tm) if masked else resample(ti, tf)
    (out * torch.as_tensor(gout)).sum().backward()
    # A source coordinate is a float32 of size up to W, and XLA may contract
    # (x + f)·W/(W-1) - 0.5 into a fused multiply-add: it moves by one ulp,
    # W·2^-23 (1.5e-5 at W = 128), the bilinear weights move by as much, and
    # every term of a gradient by that times the term's own size. So on top
    # of 1e-5 abs each gradient gets that ulp times the summed magnitudes of
    # its terms: for a pixel of the image gradient the same gradient taken
    # with |gout| (weights and mask are >= 0; a border pixel collects every
    # clamped sample), for the flow and mask gradients the channel sum of
    # |gout| times the range of a tap difference (values lie in [0, 1]).
    h, w = shape[1:3]
    ulp = max(h, w) * 2.0 ** -23
    ai = torch.tensor(img, requires_grad=True)
    aout = (resample_masked(ai, torch.as_tensor(flow), torch.as_tensor(mask))
            if masked else resample(ai, torch.as_tensor(flow)))
    (aout * torch.as_tensor(np.abs(gout))).sum().backward()
    diff = np.abs(ti.grad.numpy() - np.asarray(want[0]))
    assert np.all(diff <= ATOL + ulp * ai.grad.numpy()), diff.max()
    gsum = np.abs(gout).sum(axis=-1, keepdims=True)
    scale = 2.0 * max(w / (w - 1.0), h / (h - 1.0))
    diff = np.abs(tf.grad.numpy() - np.asarray(want[1]))
    assert np.all(diff <= ATOL + ulp * scale * gsum), diff.max()
    if masked:
        diff = np.abs(tm.grad.numpy() - np.asarray(want[2]))
        assert np.all(diff <= ATOL + ulp * 2.0 * gsum), diff.max()
    else:
        assert tm.grad is None
    # samples clamped at the border carry no flow gradient
    sx = (np.arange(w)[None, None, :] + flow[..., 0]) * w / (w - 1.0) - 0.5
    outside = (sx < 0) | (sx > w - 1)
    assert outside.any()
    assert np.all(tf.grad.numpy()[..., 0][outside] == 0)


def test_bfloat16_image_gradient_is_bfloat16():
    """The conv stacks hand K1 bfloat16 features and float32 flow/mask: the
    image gradient comes back in bfloat16, flow and mask in float32, and all
    agree with the float32 gradients to bfloat16 rounding of the inputs
    (2^-8 relative on the image and the upstream gradient)."""
    img, flow, mask, gout = _inputs((2, 16, 32, 24), 1, 12.0)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        ti = torch.tensor(img).to(dtype).requires_grad_(True)
        tf, tm = (torch.tensor(a, requires_grad=True) for a in (flow, mask))
        out = resample_masked(ti, tf, tm)
        assert out.dtype == dtype
        (out.float() * torch.as_tensor(gout)).sum().backward()
        grads[dtype] = (ti.grad, tf.grad, tm.grad)
    gi, gf, gm = grads[torch.bfloat16]
    assert gi.dtype == torch.bfloat16
    assert gf.dtype == torch.float32 and gm.dtype == torch.float32
    for a, b in zip(grads[torch.bfloat16], grads[torch.float32]):
        scale = b.abs().max().item()
        assert (a.float() - b).abs().max().item() <= 2 ** -6 * scale


def test_forward_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    import c2m_tpu.ops.pallas.warp_kernels as pk
    monkeypatch.setattr(pk, "_INTERPRET", True)
    rng = np.random.RandomState(3)
    img = rng.rand(2, 32, 128, 3).astype(np.float32)
    flow = (rng.rand(2, 32, 128, 2) * 16 - 8).astype(np.float32)
    mask = rng.rand(2, 32, 128, 1).astype(np.float32)
    want = np.asarray(pk.resample(jnp.asarray(img), jnp.asarray(flow)))
    got = resample(torch.as_tensor(img), torch.as_tensor(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    want = np.asarray(pk.resample_masked(jnp.asarray(img), jnp.asarray(flow),
                                         jnp.asarray(mask)))
    got = resample_masked(torch.as_tensor(img), torch.as_tensor(flow),
                          torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("frames", [2, 5])
def test_frames_per_image_match_the_repeated_image(frames, masked):
    """One image for ``frames`` output rows (output row i reads image row
    i // frames): forward and gradients equal those of the image repeated
    ``frames`` times; against jax.grad on the repeated image, its image
    gradient summed over the copies, at 1e-5 abs + 1e-5 rel."""
    b, h, w, c = 2, 9, 13, 5
    img, flow, mask, gout = _inputs((b * frames, h, w, c), 7, 20.0)
    img = img[:b]
    rep = np.repeat(img, frames, axis=0)

    def port(image, f, m, fr):
        return (resample_masked(image, f, m, frames=fr) if masked
                else resample(image, f, frames=fr))

    grads = []
    for image, fr in ((img, frames), (rep, 1)):
        ti, tf, tm = (torch.tensor(a, requires_grad=True)
                      for a in (image, flow, mask))
        out = port(ti, tf, tm, fr)
        assert out.shape == (b * frames, h, w, c)
        (out * torch.as_tensor(gout)).sum().backward()
        grads.append((out.detach(), ti.grad, tf.grad, tm.grad))
    (out1, gi1, gf1, gm1), (out2, gi2, gf2, gm2) = grads
    assert torch.equal(out1, out2)
    assert torch.equal(gf1, gf2)
    if masked:
        assert torch.equal(gm1, gm2)
    # the repeated image's gradient, summed over its copies
    torch.testing.assert_close(gi1, gi2.reshape(b, frames, h, w, c).sum(1),
                               rtol=1e-6, atol=1e-6)

    def jloss(i, f, m):
        out = jax_resample(jnp.repeat(i, frames, axis=0), f, use_pallas=False)
        if masked:
            out = out * m
        return jnp.sum(out * gout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(flow), jnp.asarray(mask))
    for got, w_ in zip((gi1, gf1) + ((gm1,) if masked else ()), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)
