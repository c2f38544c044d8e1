"""The port's ops (c2m_tpu_torch/ops) against the JAX package's on the CPU.

Same numpy inputs (seeded) into both; float32. Tolerance 1e-5 abs unless
stated, as tests/test_ops_golden.py holds the JAX ops to torch: the two
sides do the same float32 operations, in places in another order.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from c2m_tpu.ops import roi as jroi
from c2m_tpu.ops import splat as jsplat
from c2m_tpu.ops import warp as jwarp
from c2m_tpu_torch.ops import roi, splat, warp
from c2m_tpu_torch.ops.hopper import splat_kernel, warp_kernels

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _jx(f, *arrays):
    """``f`` of the arrays through one jit: one compile of the JAX op, where
    eager JAX compiles each of its operations on its own."""
    return jax.jit(f)(*(jnp.asarray(a) for a in arrays))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# (B, H, W, C): odd sizes, and the serving size 128x256
SHAPES = [(2, 16, 32, 3), (1, 17, 45, 5), (1, 128, 256, 4)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_resample_plain_matches_jnp(shape, masked):
    rng = np.random.RandomState(3)
    img = rng.rand(*shape).astype(np.float32)
    flow = (rng.rand(*shape[:3], 2) * 24 - 12).astype(np.float32)
    mask = rng.rand(*shape[:3], 1).astype(np.float32)
    want = np.asarray(_jx(jwarp._resample_jnp, img, flow))
    if masked:
        got = warp.resample_masked(_t(img), _t(flow), _t(mask))
        want = want * mask
    else:
        got = warp.resample(_t(img), _t(flow))
    _close(got, want)


def test_resample_matches_pallas_interpret(monkeypatch):
    """The Pallas kernel K1 replaces, run in interpret mode as
    tests/test_pallas.py runs it."""
    import c2m_tpu.ops.pallas.warp_kernels as wk
    monkeypatch.setattr(wk, "_INTERPRET", True)
    rng = np.random.RandomState(4)
    img = rng.rand(2, 16, 128, 3).astype(np.float32)
    flow = (rng.rand(2, 16, 128, 2) * 16 - 8).astype(np.float32)
    mask = rng.rand(2, 16, 128, 1).astype(np.float32)
    want = wk.resample_masked(jnp.asarray(img), jnp.asarray(flow),
                              jnp.asarray(mask))
    _close(warp.resample_masked(_t(img), _t(flow), _t(mask)), want)


def test_resample_bf16_plain_rounds_once():
    """bfloat16 images: float32 math inside, one rounding at the store."""
    rng = np.random.RandomState(5)
    img = torch.as_tensor(rng.rand(1, 8, 12, 4).astype(np.float32))
    flow = torch.as_tensor((rng.rand(1, 8, 12, 2) * 6 - 3).astype(np.float32))
    got = warp.resample(img.bfloat16(), flow)
    assert got.dtype == torch.bfloat16
    want = warp.resample(img.bfloat16().float(), flow).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_bilinear_sample_matches_jnp(padding):
    rng = np.random.RandomState(6)
    img = rng.rand(2, 9, 13, 3).astype(np.float32)
    sx = (rng.rand(2, 5, 7) * 20 - 4).astype(np.float32)
    sy = (rng.rand(2, 5, 7) * 16 - 4).astype(np.float32)
    want = _jx(jax.vmap(lambda i, x, y: jwarp.bilinear_sample(
        i, x, y, padding)), img, sx, sy)
    _close(warp.bilinear_sample(_t(img), _t(sx), _t(sy), padding), want)


def test_affine_grid_sample_and_flow_match_jnp():
    rng = np.random.RandomState(7)
    theta = (np.eye(2, 3) + rng.randn(3, 2, 3) * 0.1).astype(np.float32)
    img = rng.rand(3, 12, 20, 2).astype(np.float32)
    for h, w in ((12, 20), (1, 7), (64, 128)):
        _close(warp.affine_grid(_t(theta), h, w),
               _jx(lambda t: jwarp.affine_grid(t, h, w), theta))
        # pixel flows reach (size-1)/2 x grid: 1e-5 relative to that scale
        _close(warp.affine_flow(_t(theta), h, w),
               _jx(lambda t: jwarp.affine_flow(t, h, w), theta),
               atol=ATOL * w)
    grid = _jx(lambda t: jwarp.affine_grid(t, 12, 20), theta)
    want = _jx(jax.vmap(jwarp.grid_sample_normalized), img, grid)
    _close(warp.grid_sample_normalized(_t(img), _t(grid)), want)


@pytest.mark.parametrize("size,align", [((32, 48), False), ((7, 11), False),
                                        ((8, 12), False), ((29, 37), True)])
def test_resize_bilinear_matches_jnp(size, align):
    x = np.random.RandomState(8).rand(2, 3, 16, 24, 5).astype(np.float32)
    _close(warp.resize_bilinear(_t(x), size, align),
           _jx(lambda a: jwarp.resize_bilinear(a, size, align), x))


@pytest.mark.parametrize("size", [(32, 48), (5, 9)])
def test_resize_nearest_and_flow_match_jnp(size):
    rng = np.random.RandomState(9)
    x = rng.rand(2, 16, 24, 3).astype(np.float32)
    flow = (rng.rand(2, 16, 24, 2) * 10 - 5).astype(np.float32)
    _close(warp.resize_nearest(_t(x), size),
           _jx(lambda a: jwarp.resize_nearest(a, size), x))
    _close(warp.resize_flow(_t(flow), size),
           _jx(lambda a: jwarp.resize_flow(a, size), flow))
    _close(warp.resize_video(_t(x[None]), size, "nearest"),
           _jx(lambda a: jwarp.resize_video(a, size, "nearest"), x[None]))


@pytest.mark.parametrize("shape", [(3, 16, 32), (2, 128, 256)])
def test_splat_plain_matches_jnp(shape):
    b, h, w = shape
    flow = (np.random.RandomState(10).rand(b, h, w, 2) * 20 - 10).astype(
        np.float32)
    _close(splat.occlusion_map(_t(flow)),
           _jx(lambda f: jsplat.occlusion_map(f, use_pallas=False), flow))
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    coords = (np.stack([xs, ys], -1)[None] + flow).astype(np.float32)
    _close(splat.corresponding_map(_t(coords)),
           _jx(jsplat.corresponding_map, coords))


def test_splat_matches_pallas_interpret():
    """The Pallas kernel K4 replaces, in interpret mode."""
    from unittest import mock
    from jax.experimental import pallas as pl
    flow = (np.random.RandomState(11).rand(3, 16, 128, 2) * 20 - 10).astype(
        np.float32)
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", interp_call):
        want = jsplat.occlusion_map(jnp.asarray(flow), use_pallas=True)
    _close(splat.occlusion_map(_t(flow)), want)
    mask = np.random.RandomState(12).rand(2, 3, 4, 1).astype(np.float32)
    assert torch.equal(splat.clip_mask(_t(mask)),
                       _t(np.asarray(jsplat.clip_mask(jnp.asarray(mask)))))


def test_roi_align_matches_jnp():
    rng = np.random.RandomState(13)
    feats = rng.rand(2, 16, 32, 4).astype(np.float32)
    boxes = np.array([[[0, 0, 20, 30], [10, 5, 120, 60], [100, 50, 140, 90]],
                      [[3, 3, 3.5, 3.5], [-8, -8, 40, 20], [0, 0, 0, 0]]],
                     np.float32)
    _close(roi.roi_align(_t(feats), _t(boxes), 7, 0.25),
           _jx(lambda f, b: jroi.roi_align(f, b, 7, 0.25), feats, boxes))


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes a plain version; any other device launches a
    kernel or raises (here: 'meta', which has none)."""
    img = torch.empty(1, 4, 4, 3, device="meta")
    flow = torch.empty(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError):
        warp_kernels.resample(img, flow)
    with pytest.raises(ValueError):
        splat_kernel.corresponding_map(flow)
    from c2m_tpu_torch.ops.hopper import maskwarp_kernel
    with pytest.raises(ValueError):
        maskwarp_kernel.warp_masks_winner(
            torch.empty(1, 4, 4, device="meta"),
            torch.empty(1, 2, dtype=torch.int32, device="meta"),
            torch.empty(1, 2, dtype=torch.bool, device="meta"),
            torch.empty(1, 2, 3, 6, device="meta"))
