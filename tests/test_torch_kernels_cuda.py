"""The port's Hopper kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU. On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (``--noconftest``: the suite's
conftest.py sets up JAX, which a GPU machine serving the port need not
have; nothing here uses it). The pytest twin of chip_smoke.py's
kernel phase, at small shapes and at the serving slice's shapes
(B=12, T=5, N=16, 128x256).
"""

import numpy as np
import pytest
import torch

from c2m_tpu_torch.ops import splat
from c2m_tpu_torch.ops.hopper import maskwarp_kernel as mk
from c2m_tpu_torch.ops.hopper import splat_kernel as sk
from c2m_tpu_torch.ops.hopper import warp_kernels as wk

pytestmark = pytest.mark.cuda

# (B, H, W, C): odd small shapes, the decoder skips, the generator
# bottleneck, the previews
RESAMPLE_SHAPES = [(2, 17, 33, 5), (60, 32, 64, 64), (60, 16, 32, 128),
                   (60, 8, 16, 256), (60, 4, 8, 512), (60, 128, 256, 3)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", RESAMPLE_SHAPES)
def test_resample_kernel_matches_plain(dev, shape, masked, dtype):
    b, h, w, c = shape
    g = _gen(1)
    img = torch.rand(b, h, w, c, generator=g).to(dtype).to(dev)
    flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 16).to(dev)
    mask = torch.rand(b, h, w, 1, generator=g).to(dev) if masked else None
    before = (wk.RESAMPLE_F32 if dtype == torch.float32
              else wk.RESAMPLE_BF16).launches
    got = (wk.resample_masked(img, flow, mask) if masked
           else wk.resample(img, flow))
    want = wk.resample_plain(img, flow, mask)
    torch.cuda.synchronize()
    assert (wk.RESAMPLE_F32 if dtype == torch.float32
            else wk.RESAMPLE_BF16).launches == before + 1
    assert got.dtype == dtype and got.shape == img.shape
    # float32: same float ops, only contraction differs in the plain
    # version's CUDA ops -> 1e-5; bfloat16: one rounding of the same float32
    # result, so at most one bf16 ulp (2^-8 of values in [0, 1])
    atol = 1e-5 if dtype == torch.float32 else 2 ** -8
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.parametrize("shape", [(3, 16, 40), (60, 128, 256)])
def test_splat_kernel_matches_plain(dev, shape):
    b, h, w = shape
    g = _gen(2)
    flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 20).to(dev)
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1)
    coords = (base[None] + flow).contiguous()
    got = sk.corresponding_map(coords)
    want = sk.corresponding_map_plain(coords)
    torch.cuda.synchronize()
    # atomics sum in another order: a few float32 ulps of masses <= ~4
    assert (got - want).abs().max().item() <= 1e-5
    flips = (splat.clip_mask(got.clamp(0, 1))
             != splat.clip_mask(want.clamp(0, 1))).float().mean().item()
    assert flips <= 1e-4


def _raster_inputs(b, n, t, h, w, seed):
    rng = np.random.RandomState(seed)
    inst = np.zeros((b, h, w), np.float32)
    ids = np.zeros((b, n), np.int32)
    for bi in range(b):
        for k in range(n):
            y0, x0 = rng.randint(0, h - h // 4), rng.randint(0, w - w // 4)
            inst[bi, y0:y0 + h // 5, x0:x0 + w // 6] = 100 + k
            ids[bi, k] = 100 + k
    th = np.zeros((b, n, t, 6), np.float32)
    th[..., 0] = 1 + rng.randn(b, n, t) * 0.05
    th[..., 4] = 1 + rng.randn(b, n, t) * 0.05
    th[..., 1] = rng.randn(b, n, t) * 0.03
    th[..., 3] = rng.randn(b, n, t) * 0.03
    th[..., 2] = rng.randn(b, n, t) * 0.1
    th[..., 5] = rng.randn(b, n, t) * 0.1
    valid = rng.rand(b, n) > 0.2
    return inst, ids, valid, th


@pytest.mark.parametrize("shape", [(2, 3, 2, 16, 40), (12, 16, 5, 128, 256)])
def test_winner_kernel_matches_plain(dev, shape):
    inst, ids, valid, th = _raster_inputs(*shape, seed=3)
    args = [torch.as_tensor(a, device=dev) for a in (inst, ids, valid, th)]
    got = mk.warp_masks_winner(*args)
    want = mk.warp_masks_winner_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    # only pixels whose sample lies within float rounding of 1 - 1e-5 can
    # flip (STATUS round 3 flip class)
    assert (got != want).float().mean().item() <= 1e-4


def _bwd_inputs(shape, dtype, masked, dev, seed=4):
    b, h, w, c = shape
    g = _gen(seed)
    img = torch.rand(b, h, w, c, generator=g).to(dtype).to(dev)
    flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 16).to(dev)
    mask = torch.rand(b, h, w, 1, generator=g).to(dev) if masked else None
    gout = torch.randn(b, h, w, c, generator=g).to(dtype).to(dev)
    return img, flow, mask, gout


def _grads(fn, img, flow, mask, gout, needs):
    ts = [t.detach().clone().requires_grad_(need) if t is not None else None
          for t, need in zip((img, flow, mask), needs)]
    out = fn(*ts) if mask is not None else fn(ts[0], ts[1])
    wrt = [t for t, need in zip(ts, needs) if need and t is not None]
    return torch.autograd.grad(out, wrt, gout)


# odd small shapes (C not a multiple of 4, a pixel run that straddles
# warps), the train step's shapes: decoder skips, generator bottleneck,
# the full-resolution warped loss
BWD_SHAPES = [(2, 17, 33, 5), (1, 9, 7, 37), (15, 32, 64, 64), (15, 4, 8, 512),
              (15, 16, 32, 256), (15, 128, 256, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_resample_backward_kernel_matches_autograd_of_plain(dev, shape, masked,
                                                            dtype):
    img, flow, mask, gout = _bwd_inputs(shape, dtype, masked, dev)
    needs = (True, True, masked)
    kernel = (wk.RESAMPLE_BWD_F32 if dtype == torch.float32
              else wk.RESAMPLE_BWD_BF16)
    before = kernel.launches
    fn = wk.resample_masked if masked else wk.resample
    got = _grads(fn, img, flow, mask, gout, needs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    plain = (wk.resample_plain if masked
             else lambda i, f: wk.resample_plain(i, f, None))
    want = _grads(plain, img, flow, mask, gout, needs)
    for name, a, b in zip(("image", "flow", "mask"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        # atomics and shuffles add the same float32 terms in another order:
        # 2e-5 of the largest gradient; a bfloat16 image gradient is one
        # rounding of such a sum and may land on the neighbouring bfloat16
        # value (spacing 2^-7 relative)
        tol = 2 ** -7 if (name == "image" and dtype == torch.bfloat16) else 2e-5
        scale = max(b.float().abs().max().item(), 1e-6)
        assert (a.float() - b.float()).abs().max().item() / scale <= tol, name


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, False, True)])
def test_resample_backward_skips_what_is_not_needed(dev, needs):
    """Each subset of gradients alone equals its part of the full set."""
    img, flow, mask, gout = _bwd_inputs((3, 12, 20, 40), torch.float32, True,
                                        dev)
    full = _grads(wk.resample_masked, img, flow, mask, gout, (True,) * 3)
    part = _grads(wk.resample_masked, img, flow, mask, gout, needs)
    picked = [g for g, need in zip(full, needs) if need]
    for a, b in zip(part, picked):
        scale = max(b.abs().max().item(), 1e-6)
        assert (a - b).abs().max().item() / scale <= 2e-5


def test_resample_backward_degenerate_shapes(dev):
    """A 1-wide image (the W-1 guard) and an empty batch."""
    for shape in [(2, 6, 1, 3), (2, 1, 9, 3)]:
        img, flow, mask, gout = _bwd_inputs(shape, torch.float32, True, dev)
        flow = flow * 0.01          # the guard scales coordinates by 1e6
        got = _grads(wk.resample_masked, img, flow, mask, gout, (True,) * 3)
        want = _grads(wk.resample_plain, img, flow, mask, gout, (True,) * 3)
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            scale = max(b.abs().max().item(), 1e-6)
            assert (a - b).abs().max().item() / scale <= 2e-5
    img, flow, mask, gout = _bwd_inputs((0, 4, 4, 3), torch.float32, True, dev)
    before = wk.RESAMPLE_BWD_F32.launches
    got = _grads(wk.resample_masked, img, flow, mask, gout, (True,) * 3)
    assert [tuple(g.shape) for g in got] == [(0, 4, 4, 3), (0, 4, 4, 2),
                                             (0, 4, 4, 1)]
    assert wk.RESAMPLE_BWD_F32.launches == before      # nothing to launch


def test_resample_backward_finite_differences(dev):
    """Central differences of the kernel's own forward in float32 on a tiny
    case. Flows are built so that every source coordinate lies 0.3-0.7 into
    its cell and at least one cell inside the border: off the kinks of the
    bilinear weights and off the clamp, where a difference quotient means
    nothing. Step 1e-2 on values of order 1: 2e-3 abs (float32 rounding of
    the quotient ~1e-5/1e-2, curvature none: the function is piecewise
    bilinear)."""
    b, h, w, c = 1, 6, 7, 3
    g = _gen(5)
    img = torch.rand(b, h, w, c, generator=g)
    mask = torch.rand(b, h, w, 1, generator=g) + 0.5
    tx = torch.randint(1, w - 2, (b, h, w), generator=g) + 0.3 \
        + 0.4 * torch.rand(b, h, w, generator=g)
    ty = torch.randint(1, h - 2, (b, h, w), generator=g) + 0.3 \
        + 0.4 * torch.rand(b, h, w, generator=g)
    xs = torch.arange(w, dtype=torch.float32)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32)[None, :, None]
    flow = torch.stack([(tx + 0.5) * (w - 1) / w - xs,
                        (ty + 0.5) * (h - 1) / h - ys], dim=-1)
    gout = torch.randn(b, h, w, c, generator=g)
    img, mask, flow, gout = (t.to(dev).contiguous()
                             for t in (img, mask, flow, gout))
    got = _grads(wk.resample_masked, img, flow, mask, gout, (True,) * 3)
    step = 1e-2

    def f(i, fl, m):
        return (wk.resample_masked(i, fl, m) * gout).sum().item()

    for which, grad in zip(range(3), got):
        base = [img, flow, mask]
        flat = base[which].flatten()
        for idx in torch.randperm(flat.numel(), generator=g)[:24].tolist():
            hi, lo = flat.clone(), flat.clone()
            hi[idx] += step
            lo[idx] -= step
            args_hi, args_lo = list(base), list(base)
            args_hi[which] = hi.view_as(base[which])
            args_lo[which] = lo.view_as(base[which])
            fd = (f(*args_hi) - f(*args_lo)) / (2 * step)
            assert abs(fd - grad.flatten()[idx].item()) <= 2e-3, (which, idx)


def test_wrappers_raise_instead_of_falling_back(dev):
    img = torch.rand(1, 8, 8, 3, device=dev)
    flow = torch.zeros(1, 8, 8, 2, device=dev)
    with pytest.raises(ValueError):
        wk.resample(img.transpose(1, 2), flow)          # not contiguous
    with pytest.raises(ValueError):
        wk.resample(img.half(), flow)                   # unsupported dtype
    with pytest.raises(ValueError):
        sk.corresponding_map(flow.double())
