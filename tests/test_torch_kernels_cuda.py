"""The port's Hopper kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU. On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (``--noconftest``: the suite's
conftest.py sets up JAX, which a GPU machine serving the port need not
have; nothing here uses it). Each kernel at small and ragged shapes,
at what the paths never give it (every route by name, unaligned views,
1-wide images, NaN and far-out coordinates), and at every shape the paths
do give it: journal serving (B=12, T=5, N=16, 128x256) and the journal
train step (batch 3), the long-horizon config (24 nodes, 10 frames,
512x1024), FlowNet2 on the fly, and the tools' one clip or frame pair a
call. The paths' shapes are the ``PATH_*`` lists, which ``chip_smoke.py``
also runs (its phase 3).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from c2m_tpu_torch.ops import splat
from c2m_tpu_torch.ops.hopper import correlation_kernel as ck
from c2m_tpu_torch.ops.hopper import maskwarp_banded as mb
from c2m_tpu_torch.ops.hopper import maskwarp_kernel as mk
from c2m_tpu_torch.ops.hopper import splat_kernel as sk
from c2m_tpu_torch.ops.hopper import warp_kernels as wk

pytestmark = pytest.mark.cuda

# (B, H, W, C): odd small shapes, the decoder skips, the generator
# bottleneck, the previews; then every route of the forward: channel counts
# that do and do not fill 16 bytes, 1-wide and 1-high images
RESAMPLE_SHAPES = [(2, 17, 33, 5), (60, 32, 64, 64), (60, 16, 32, 128),
                   (60, 8, 16, 256), (60, 4, 8, 512), (60, 128, 256, 3)]
RESAMPLE_SHAPES += [(2, 17, 33, c) for c in (1, 2, 3, 4, 8, 12, 64, 72, 256,
                                             512)]
RESAMPLE_SHAPES += [(2, 6, 1, 3), (2, 1, 9, 3), (3, 1, 1, 8), (2, 5, 1, 64),
                    (1, 1, 70, 1)]


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
    # the same float32 operations term for term, built without contraction:
    # equal bit for bit; bfloat16 is one rounding of that float32 value
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 17, 33, 3), (2, 17, 33, 8),
                                   (2, 17, 33, 64), (2, 9, 5, 5)]
                         + [(2, 17, 33, c) for c in (1, 2, 4, 5, 12, 72, 256,
                                                      512)]
                         + [(2, 6, 1, 3), (2, 1, 9, 3), (3, 1, 1, 8),
                            (2, 5, 1, 64)])
def test_resample_kernel_on_an_unaligned_view(dev, shape, dtype):
    """A contiguous view whose data_ptr() is not 16-byte aligned takes the
    route of scalar loads and gives the same bits."""
    g = _gen(8)
    n = int(np.prod(shape))
    img = torch.rand(n + 1, generator=g).to(dtype).to(dev)[1:].view(shape)
    flow = ((torch.rand(*shape[:3], 2, generator=g) - 0.5) * 16).to(dev)
    mask = torch.rand(*shape[:3], 1, generator=g).to(dev)
    assert img.is_contiguous() and img.data_ptr() % 16 != 0
    assert torch.equal(wk.resample_masked(img, flow, mask),
                       wk.resample_plain(img, flow, mask))
    assert torch.equal(wk.resample(img, flow), wk.resample_plain(img, flow))


@pytest.mark.parametrize("route", sorted(wk.ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample_every_route_by_name(dev, dtype, route):
    """Each kernel of csrc/resample.cu on a shape they all take."""
    c = 4 if dtype == torch.float32 else 8
    if route == "pixel":
        c = 3
    g = _gen(9)
    img = torch.rand(3, 19, 35, c, generator=g).to(dtype).to(dev)
    flow = ((torch.rand(3, 19, 35, 2, generator=g) - 0.5) * 16).to(dev)
    mask = torch.rand(3, 19, 35, 1, generator=g).to(dev)
    assert torch.equal(wk._launch(img, flow, mask, route=route),
                       wk.resample_plain(img, flow, mask))
    if route == "vec":
        with pytest.raises(RuntimeError):      # a shape the route cannot take
            wk._launch(img[..., :3].contiguous(), flow, mask, route=route)


# K4's coordinates [B, H, W] at the paths' shapes: a journal request and
# step, FlowNet2's confidence on the fly and precompute_flow's run of 3
# clips (30 frame pairs), precompute_flow's run of one clip (10 pairs) and
# one frame pair, make_synthetic_dataset's clip (5 frames), a long-horizon
# step and request, and precompute_flow's call at 512x1024 (one pair:
# PAIR_PIXELS_PER_CALL)
PATH_SPLAT = [(60, 128, 256), (15, 128, 256), (30, 128, 256), (1, 128, 256),
              (5, 128, 256), (10, 512, 1024), (40, 512, 1024),
              (10, 128, 256), (1, 512, 1024)]
FLOW_KINDS = ["noise", "smooth"]


def smooth_flow(g, b, h, w, dev, px=8.0):
    """A flow as a request's dense flow looks: noise of +-px pixels at 1/16
    of the resolution, bilinearly enlarged to [b, h, w, 2]."""
    low = (torch.rand(b, 2, max(2, h // 16), max(2, w // 16), generator=g)
           - 0.5) * 2 * px
    return F.interpolate(low.to(dev), size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1).contiguous()


# (B, H, W, largest |flow|): flows shorter and longer than the halo; H and W
# that are no multiple of the tile, of 4, or of anything; then the paths'
# shapes at +-10 px
@pytest.mark.parametrize("flow_kind", FLOW_KINDS)
@pytest.mark.parametrize("shape,px", [
    ((3, 16, 40), 10.0), ((2, 50, 70), 3.0),
    ((2, 50, 70), 4.0 * sk.HALO), ((3, 2 * sk.TILE[1], 2 * sk.TILE[0]), 40.0),
    ((1, sk.TILE[1] + 1, sk.TILE[0] + 4), 10.0), ((2, 7, 5), 2.0)]
    + [(s, 10.0) for s in PATH_SPLAT])
def test_splat_kernel_matches_plain(dev, shape, px, flow_kind):
    """On noise of +-px per pixel (masses up to ~4: atomics sum in another
    order, a few float32 ulps, 1e-5) and on a smooth flow, which piles tens
    of points onto a pixel where it converges: a float32 sum added in
    another order then differs by steps of its own size, so a pixel of mass
    m above 4 is held to the same number of steps, 1e-5 * m / 4."""
    b, h, w = shape
    g = _gen(2)
    flow = (((torch.rand(b, h, w, 2, generator=g) - 0.5) * 2 * px).to(dev)
            if flow_kind == "noise" else smooth_flow(g, b, h, w, dev, px))
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1)
    coords = (base[None] + flow).contiguous()
    got = sk.corresponding_map(coords)
    want = sk.corresponding_map_plain(coords)
    torch.cuda.synchronize()
    tol = torch.full_like(want, 1e-5)
    if flow_kind == "smooth":
        tol = tol * (want / 4.0).clamp(min=1.0)
    assert bool(((got - want).abs() <= tol).all())
    flips = (splat.clip_mask(got.clamp(0, 1))
             != splat.clip_mask(want.clamp(0, 1))).float().mean().item()
    assert flips <= 1e-4


def test_splat_kernel_nan_and_far_coordinates_add_nothing(dev):
    """NaN, infinite and far-out coordinates add no mass and touch nothing;
    coordinates that are not 8-byte aligned load as scalars."""
    g = _gen(3)
    b, h, w = 2, 50, 72
    flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 6).to(dev)
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1)
    coords = (base[None] + flow).contiguous()
    dirty, lost = coords.clone(), coords.clone()
    dirty[0, 3, 4] = float("nan")
    dirty[0, 5, 60, 0] = float("inf")
    dirty[1, 49, 0, 1] = -1e30
    dirty[1, 20, 71] = torch.tensor([3e9, 1.0], device=dev)
    for bi, y, x in ((0, 3, 4), (0, 5, 60), (1, 49, 0), (1, 20, 71)):
        lost[bi, y, x] = -5.0                      # off the image
    got = sk.corresponding_map(dirty)
    want = sk.corresponding_map_plain(lost)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5
    odd = torch.zeros(coords.numel() + 1, device=dev)[1:].view(coords.shape)
    odd.copy_(coords)
    assert odd.data_ptr() % 8 != 0
    assert (sk.corresponding_map(odd)
            - sk.corresponding_map_plain(coords)).abs().max().item() <= 1e-5


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


def _winner_case(case):
    """K2's edge cases at ragged map sizes (no multiple of the 32x8 tile):
    more nodes than one shared-memory chunk, no valid node, one node, two
    valid nodes with the same id whose warped masks overlap (the later one
    must win), and thetas so large that the kernel skips its quick test."""
    if case == "many_nodes":
        inst, ids, valid, th = _raster_inputs(2, 600, 2, 50, 70, seed=16)
    elif case == "none_valid":
        inst, ids, valid, th = _raster_inputs(2, 5, 3, 37, 45, seed=17)
        valid[:] = False
    elif case == "one_node":
        inst, ids, valid, th = _raster_inputs(3, 1, 2, 19, 33, seed=18)
        valid[:] = True
    elif case == "huge_thetas":             # beyond the quick tap test
        inst, ids, valid, th = _raster_inputs(2, 6, 2, 40, 72, seed=20)
        th[:, ::2] *= 2e3
        th[:, ::2, :, 2] = -th[:, ::2, :, 0] * 0.1   # some land inside
    else:                                   # "same_id"
        inst, ids, valid, th = _raster_inputs(2, 4, 3, 41, 67, seed=19)
        ids[:, 2] = ids[:, 1]
        valid[:, 1:3] = True
        th[:, 2] = th[:, 1]
        th[:, 2, :, 2] += 0.02              # mostly overlapping
    return inst, ids, valid, th


@pytest.mark.parametrize("case", ["many_nodes", "none_valid", "one_node",
                                  "same_id", "huge_thetas"])
def test_winner_kernel_edge_cases(dev, case):
    inst, ids, valid, th = _winner_case(case)
    args = [torch.as_tensor(a, device=dev) for a in (inst, ids, valid, th)]
    before = mk.WARP_MASKS_WINNER.launches
    got = mk.warp_masks_winner(*args)
    torch.cuda.synchronize()
    assert mk.WARP_MASKS_WINNER.launches == before + 1
    # K2 and K3 evaluate the same float32 expression per pixel and node
    assert torch.equal(got, mb.warp_masks_winner_banded(*args))
    want = mk.warp_masks_winner_plain(*args)
    assert (got != want).float().mean().item() <= 1e-4
    if case == "none_valid":
        assert not got.any()
    if case == "same_id":                   # node 2 (rank 3) wins the overlap
        assert (got == 3).any() and (got == 3).sum() > (got == 2).sum()


def _special_thetas(kind, th, rng):
    """half: axis-aligned half-integer pixel translations (no sample near a
    threshold); zoom: node 0 rotated by 1 rad and zoomed out 6x, whose
    regions exceed mb.WIN_MAX pixels (a strong zoom-out);
    wild: every affine random at scale 3 (flips, off-image, far zooms)."""
    b, n, t, _ = th.shape
    if kind == "half":
        th[...] = np.array([1, 0, 0, 0, 1, 0], np.float32)
        th[..., 2] = (rng.randint(-9, 10, (b, n, t)) + 0.5) * 2.0
        th[..., 5] = (rng.randint(-5, 6, (b, n, t)) + 0.5) * 2.0
    elif kind == "zoom":
        c, s = 6 * np.cos(1.0), 6 * np.sin(1.0)
        th[:, 0] = np.array([c, -s, 0.1, s, c, -0.05], np.float32)
    elif kind == "wild":
        th[...] = rng.randn(b, n, t, 6) * 3.0
    return th


def _wide_objects(inst, ids):
    """Every node an image-wide object: a band of rows per node, so that
    every tile's window meets every box (K3 skips nothing)."""
    b, h, w = inst.shape
    n = ids.shape[1]
    for k in range(n):
        inst[:, (k * h) // n:((k + 1) * h) // n or h, :] = ids[0, k]
    for k in range(n):
        inst[:, :, (k * w) // n] = ids[0, k]      # a column across the map
    return inst


WINNER_KINDS = ["general", "half", "zoom", "wild", "wide"]
# K2 and K3 on the same inputs [B, N, T, H, W] at the paths' maps: K2's
# journal maps (a request, a step, make_synthetic_dataset's clip), K3's
# long-horizon maps (a step, a bucket-4 request)
PATH_WINNER = [(12, 16, 5, 128, 256), (3, 16, 5, 128, 256),
               (1, 16, 5, 128, 256), (1, 24, 10, 512, 1024),
               (4, 24, 10, 512, 1024)]


@pytest.mark.parametrize("kind", WINNER_KINDS)
@pytest.mark.parametrize("shape", [(2, 3, 2, 16, 40), (2, 5, 3, 50, 70)]
                         + PATH_WINNER)
def test_banded_winner_kernel_matches_plain_and_k2(dev, shape, kind):
    """K3 against K2 (equal bit for bit) and the plain winner (within 1e-4,
    0 on half-integer translations), on objects of the usual size under
    each kind of thetas and on image-wide objects ('wide': K3 skips no
    tile). On the long-horizon maps K3's plan has a window over its budget
    on the zoom case and, short of the wild thetas, on no other."""
    inst, ids, valid, th = _raster_inputs(*shape, seed=5)
    if kind == "wide":
        inst = _wide_objects(inst, ids)
    else:
        th = _special_thetas(kind, th, np.random.RandomState(6))
    if kind == "half":          # pixels: normalize by the map size
        th[..., 2] /= shape[4]
        th[..., 5] /= shape[3]
    if kind == "zoom":          # a node large enough to overflow the budget
        h, w = shape[3:]
        inst[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = ids[0, 0]
        valid[:, 0] = True
    args = [torch.as_tensor(a, device=dev) for a in (inst, ids, valid, th)]
    before = mb.WARP_MASKS_BANDED.launches
    got = mb.warp_masks_winner_banded(*args)
    torch.cuda.synchronize()
    assert mb.WARP_MASKS_BANDED.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (
        shape[0], shape[2], shape[3], shape[4])
    # K3 and K2 evaluate the same float32 expression per pixel and node
    assert torch.equal(got, mk.warp_masks_winner(*args))
    want = mk.warp_masks_winner_plain(*args)
    mismatch = (got != want).float().mean().item()
    assert mismatch <= (0.0 if kind == "half" else 1e-4)
    if shape[3] >= 512 and kind != "wild":
        plan = mb.source_windows_plain(
            args[3], shape[3], shape[4], boxes=mb.node_boxes_plain(*args[:3]))
        assert bool(plan["gather"].any()) == (kind == "zoom")


# K5 at FlowNetC's grid (max displacement 20, stride 2) at the paths' shapes:
# the journal train batch's 30 frame pairs on the fly and precompute_flow's
# run of 3 clips, two 512x1024 pairs, precompute_flow's call at 512x1024
# (one pair: PAIR_PIXELS_PER_CALL), one frame pair at 128x256,
# precompute_flow's run of one clip (10 pairs)
PATH_CORRELATION = [((30, 16, 32, 256), 20, 2), ((2, 64, 128, 256), 20, 2),
                    ((1, 16, 32, 256), 20, 2), ((1, 64, 128, 256), 20, 2),
                    ((10, 16, 32, 256), 20, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,md,stride", [
    ((2, 9, 13, 20), 4, 2), ((2, 9, 13, 7), 3, 1), ((1, 5, 30, 33), 6, 3),
    ((1, 4, 4, 8), 20, 2)] + PATH_CORRELATION)
def test_correlation_kernel_matches_plain(dev, shape, md, stride, dtype):
    g = _gen(7)
    a = torch.randn(shape, generator=g).to(dtype).to(dev)
    b = torch.randn(shape, generator=g).to(dtype).to(dev)
    before = ck.CORRELATION.launches
    got = ck.correlation(a, b, md, stride)
    torch.cuda.synchronize()
    assert ck.CORRELATION.launches == before + 1
    want = ck.correlation_plain(a, b, md, stride)
    d = 2 * (md // stride) + 1
    assert got.dtype == torch.float32 and got.shape == (*shape[:3], d * d)
    # the same float32 products (bfloat16 inputs widened first) summed over
    # C <= 256 channels in another order; means of order 1
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,md,stride", [
    ((1, 5, 45, 16), 4, 2),       # W no multiple of the block's run
    ((2, 6, 70, 33), 8, 2),       # C no multiple of the channel chunk
    ((2, 6, 9, 12), 0, 1),        # md = 0: one displacement
    ((1, 7, 40, 7), 20, 1),       # stride 1, 41 displacements, C odd
    ((1, 11, 50, 24), 9, 3),      # stride 3
    ((1, 40, 20, 16), 20, 2),     # more displacement rows than one wave
    ((1, 2, 2, 4096), 20, 2)])    # any C: the chunks carry it
def test_correlation_kernel_at_ragged_geometry(dev, shape, md, stride, dtype):
    g = _gen(9)
    a = torch.randn(shape, generator=g).to(dtype).to(dev)
    b = torch.randn(shape, generator=g).to(dtype).to(dev)
    got = ck.correlation(a, b, md, stride)
    want = ck.correlation_plain(a, b, md, stride)
    torch.cuda.synchronize()
    d = 2 * (md // stride) + 1
    assert got.shape == (*shape[:3], d * d)
    # the same float32 products summed in another order; means of order 1
    assert (got - want).abs().max().item() <= 1e-5


def test_correlation_kernel_on_an_unaligned_view(dev):
    """A view whose data_ptr() is not 16-byte aligned takes scalar loads."""
    g = _gen(10)
    shape = (2, 9, 13, 20)
    n = int(np.prod(shape))
    buf = torch.randn(2 * n + 1, generator=g).to(dev)
    a, b = buf[1:n + 1].view(shape), buf[n + 1:].view(shape)
    assert a.data_ptr() % 16 != 0
    got = ck.correlation(a, b, 4, 2)
    assert (got - ck.correlation_plain(a, b, 4, 2)).abs().max().item() <= 1e-5


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
    feat = torch.rand(1, 8, 8, 16, device=dev)
    with pytest.raises(ValueError):
        ck.correlation(feat.half(), feat.half())        # unsupported dtype
    with pytest.raises(ValueError):
        ck.correlation(feat, feat[:, :4])               # shapes differ
    big = torch.rand(1, 2, 2, 4096, device=dev)         # any C is taken
    assert (ck.correlation(big, big) - ck.correlation_plain(big, big)
            ).abs().max().item() <= 1e-5
    with pytest.raises(ValueError):     # one displacement row > 256 threads
        ck.correlation(feat, feat, 2000, 1)
    inst = torch.zeros(1, 8, 8, device=dev)
    ids = torch.ones(1, 2, dtype=torch.int32, device=dev)
    valid = torch.ones(1, 2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):                     # thetas not float32
        mb.warp_masks_winner_banded(
            inst, ids, valid, torch.zeros(1, 2, 1, 6, device=dev).double())


def _frames_inputs(shape, frames, dtype, masked, dev, seed=11):
    """An image [B,H,W,C] and flow, mask, upstream gradient for its
    B*frames output rows."""
    b, h, w, c = shape
    g = _gen(seed)
    img = torch.rand(b, h, w, c, generator=g).to(dtype).to(dev)
    n = b * frames
    flow = ((torch.rand(n, h, w, 2, generator=g) - 0.5) * 16).to(dev)
    mask = torch.rand(n, h, w, 1, generator=g).to(dev) if masked else None
    gout = torch.randn(n, h, w, c, generator=g).to(dtype).to(dev)
    return img, flow, mask, gout


def _close(got, want, name, dtype):
    """K1 backward's tolerances: 2e-5 of the largest gradient (float32
    sums in another order), 2^-7 for a bfloat16 image gradient (one
    rounding of such a sum)."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    tol = 2 ** -7 if (name == "image" and dtype == torch.bfloat16) else 2e-5
    scale = max(want.float().abs().max().item(), 1e-6)
    assert (got.float() - want.float()).abs().max().item() / scale <= tol, name


@pytest.mark.parametrize("frames", [1, 5, 10])
@pytest.mark.parametrize("c", [1, 2, 3, 8, 64, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample_frames_forward_and_backward(dev, dtype, c, frames):
    """One image for `frames` output rows: the forward equals the forward of
    the repeated image bit for bit, and the gradients equal autograd of the
    plain version (which repeats the image), the image gradient summed over
    its frames."""
    img, flow, mask, gout = _frames_inputs((2, 9, 13, c), frames, dtype, True,
                                           dev)
    rep = img.repeat_interleave(frames, dim=0)
    for m in (None, mask):
        got = (wk.resample(img, flow, frames=frames) if m is None
               else wk.resample_masked(img, flow, m, frames=frames))
        want = (wk.resample(rep, flow) if m is None
                else wk.resample_masked(rep, flow, m))
        assert got.shape == (2 * frames, 9, 13, c)
        assert torch.equal(got, want)
        assert torch.equal(got, wk.resample_plain(img, flow, m, frames))

    def kernel(i, f, m):
        return wk.resample_masked(i, f, m, frames=frames)

    def plain(i, f, m):
        return wk.resample_plain(i, f, m, frames)

    got = _grads(kernel, img, flow, mask, gout, (True,) * 3)
    want = _grads(plain, img, flow, mask, gout, (True,) * 3)
    for name, a, b in zip(("image", "flow", "mask"), got, want):
        _close(a, b, name, dtype)


@pytest.mark.parametrize("frames", [1, 5])
@pytest.mark.parametrize("route", sorted(wk.BACKWARD_ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample_backward_every_route_by_name(dev, dtype, route, frames):
    """Each kernel of csrc/resample_bwd.cu on a shape it takes, against
    autograd of the plain version; the vec and pixel routes store the flow
    and mask gradients without atomics, in the order of
    resample_backward_plain: equal to it and to themselves bit for bit."""
    c = 3 if route == "pixel" else 64
    img, flow, mask, gout = _frames_inputs((3, 19, 35, c), frames, dtype,
                                           True, dev, seed=12)
    runs = [wk._launch_backward(gout, img, flow, mask, True, True, True,
                                frames, route=route) for _ in range(2)]
    want = _grads(lambda i, f, m: wk.resample_plain(i, f, m, frames), img,
                  flow, mask, gout, (True,) * 3)
    for name, a, b in zip(("image", "flow", "mask"), runs[0], want):
        _close(a, b, name, dtype)
    if route != "scalar64":
        order = wk.resample_backward_plain(gout, img, flow, mask, frames,
                                           route=route)
        for k in (1, 2):
            assert torch.equal(runs[0][k], runs[1][k])
            assert torch.equal(runs[0][k], order[k])
    if route == "vec":
        with pytest.raises(RuntimeError):      # a shape the route cannot take
            wk._launch_backward(gout[..., :3].contiguous(),
                                img[..., :3].contiguous(), flow, mask, True,
                                True, True, frames, route=route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 8, 64])
def test_resample_backward_on_unaligned_views(dev, dtype, c):
    """Image and upstream gradient as contiguous views that do not start on
    16 bytes: the scalar64 route, the same gradients."""
    img, flow, mask, gout = _frames_inputs((2, 17, 33, c), 5, dtype, True,
                                           dev, seed=13)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    before = (wk.RESAMPLE_BWD_F32 if dtype == torch.float32
              else wk.RESAMPLE_BWD_BF16).launches
    got = wk._launch_backward(shifted(gout), shifted(img), flow, mask, True,
                              True, True, 5)
    assert (wk.RESAMPLE_BWD_F32 if dtype == torch.float32
            else wk.RESAMPLE_BWD_BF16).launches == before + 1
    want = _grads(lambda i, f, m: wk.resample_plain(i, f, m, 5), img, flow,
                  mask, gout, (True,) * 3)
    for name, a, b in zip(("image", "flow", "mask"), got, want):
        _close(a, b, name, dtype)


@pytest.mark.parametrize("kind", ["general", "wide", "zoom"])
@pytest.mark.parametrize("shape", [(2, 1, 3, 50, 70), (2, 24, 3, 64, 128),
                                   (1, 100, 2, 96, 160),
                                   (1, mb.NODES_MAX - 5, 2, 48, 96),
                                   (1, mb.NODES_MAX - 8, 5, 128, 256)])
def test_banded_winner_at_node_counts(dev, shape, kind):
    """K3 at N = 1, 24, 100 and near its limit (also at the journal
    map), against K2 (equal) and the
    plain winner, on objects of the usual size, image-wide objects and the
    zoom case."""
    b, n, t, h, w = shape
    inst, ids, valid, th = _raster_inputs(*shape, seed=14)
    if kind == "wide":
        inst = _wide_objects(inst, ids)
    if kind == "zoom":
        th = _special_thetas("zoom", th, np.random.RandomState(15))
        inst[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = ids[0, 0]
        valid[:, 0] = True
    args = [torch.as_tensor(a, device=dev) for a in (inst, ids, valid, th)]
    got = mb.warp_masks_winner_banded(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, mk.warp_masks_winner(*args))
    assert (got != mk.warp_masks_winner_plain(*args)).float().mean().item() \
        <= 1e-4


def test_banded_winner_refuses_what_it_cannot_take(dev):
    inst = torch.zeros(1, 16, 32, device=dev)
    n = mb.NODES_MAX + 1
    ids = torch.ones(1, n, dtype=torch.int32, device=dev)
    valid = torch.ones(1, n, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        mb.warp_masks_winner_banded(inst, ids, valid,
                                    torch.zeros(1, n, 1, 6, device=dev))


# -- the shapes the paths give the kernels ------------------------------------
# A bucket-12 journal request folds 60 frames, a journal train step (batch 3)
# 15; a long-horizon step (one clip) 10 and a bucket-4 request 40. Each
# kernel is held at every shape of a path, so that what a request or a step
# runs is what was checked: K1's cases are here, K2-K5's are parameters of
# their tests above (PATH_SPLAT, PATH_WINNER, PATH_CORRELATION).
# chip_smoke.py's phase 3 runs every PATH_* case on the card too.

BF16, F32 = torch.bfloat16, torch.float32
# the decoder skips (H, W, C) of the journal and the long-horizon config:
# the appearance features of a clip, passed once for its frames
SKIPS = [(32, 64, 64), (16, 32, 128), (8, 16, 256), (4, 8, 512)]
LONG_SKIPS = [(128, 256, 64), (64, 128, 128), (32, 64, 256), (16, 32, 512)]

# K1 forward: (output [B*T, H, W, C], frames an image, dtype, masked)
PATH_RESAMPLE = (
    [((60, *s), 5, dt, True) for dt in (BF16, F32) for s in SKIPS]  # request
    + [((60, 16, 32, 256), 1, BF16, True),               # bottleneck
       ((60, 16, 32, 256), 1, F32, True),
       ((60, 128, 256, 3), 5, F32, False)]                # previews
    + [((15, *s), 5, BF16, True) for s in SKIPS]         # step
    + [((15, 16, 32, 256), 1, BF16, True),
       ((15, 128, 256, 3), 5, F32, False),                # warped loss
       ((15, 128, 256, 2), 1, F32, False)]                # flow consistency
    + [((b, *s), 10, BF16, True) for b in (10, 40) for s in LONG_SKIPS]
    + [((b, 64, 128, 256), 1, BF16, True) for b in (10, 40)]
    + [((b, 512, 1024, 3), 10, F32, False) for b in (10, 40)])

# K1 backward, the train steps' shapes: (output shape, frames, dtype,
# masked, gradients needed of image, flow, mask); the skips also at
# frames=1 (the image repeated for its frames)
IMAGE, FLOW, ALL = (True, False, False), (False, True, False), (True,) * 3
PATH_RESAMPLE_BWD = (
    [((15, 16, 32, 256), 1, BF16, True, ALL),             # bottleneck
     ((15, 16, 32, 256), 1, BF16, False, (True, True, False)),
     ((15, 16, 32, 256), 1, F32, True, ALL),
     ((15, 128, 256, 3), 5, F32, False, FLOW),            # warped loss
     ((15, 128, 256, 2), 1, F32, False, (True, True, False))]  # consistency
    + [((15, *s), f, BF16, True, IMAGE) for f in (5, 1) for s in SKIPS]
    + [((10, *s), f, BF16, True, IMAGE) for f in (10, 1) for s in LONG_SKIPS]
    + [((10, 64, 128, 256), 1, BF16, True, ALL),
       ((10, 512, 1024, 3), 10, F32, False, FLOW)])


def _case_id(case):
    """'60x32x64x64-f5-bfloat16-masked' and the like."""
    shape, frames, dtype, masked = case[:4]
    out = (f"{'x'.join(map(str, shape))}-f{frames}-{str(dtype)[6:]}-"
           f"{'masked' if masked else 'plain'}")
    if len(case) > 4:
        out += "-grad-" + "".join("ifm"[i] for i, need in enumerate(case[4])
                              if need)
    return out


@pytest.mark.parametrize("flow_kind", FLOW_KINDS)
@pytest.mark.parametrize("case", PATH_RESAMPLE, ids=_case_id)
def test_resample_kernel_at_the_paths_shapes(dev, case, flow_kind):
    """K1's forward at every shape a request or a step gives it, the image
    passed once for its frames where the paths do: equal bit for bit to the
    plain version and, for frames > 1, to the forward of the repeated
    image; on noise per pixel and on a smooth flow."""
    (n, h, w, c), frames, dtype, masked = case
    img, flow, mask, _ = _frames_inputs((n // frames, h, w, c), frames, dtype,
                                        masked, dev, seed=21)
    if flow_kind == "smooth":
        flow = smooth_flow(_gen(22), n, h, w, dev)
    got = (wk.resample_masked(img, flow, mask, frames=frames) if masked
           else wk.resample(img, flow, frames=frames))
    assert got.shape == (n, h, w, c)
    assert torch.equal(got, wk.resample_plain(img, flow, mask, frames))
    if frames > 1:
        rep = img.repeat_interleave(frames, dim=0)
        assert torch.equal(got, wk.resample_masked(rep, flow, mask) if masked
                           else wk.resample(rep, flow))


@pytest.mark.parametrize("case", PATH_RESAMPLE_BWD, ids=_case_id)
def test_resample_backward_at_the_paths_shapes(dev, case):
    """K1's backward at every shape a train step gives it, through autograd
    as the step reaches it, against autograd of the plain version; off the
    scalar64 route the flow and mask gradients, stored without atomics,
    repeat bit for bit from run to run."""
    (n, h, w, c), frames, dtype, masked, needs = case
    img, flow, mask, gout = _frames_inputs((n // frames, h, w, c), frames,
                                           dtype, masked, dev, seed=23)

    def kernel(i, f, m=None):
        return (wk.resample(i, f, frames=frames) if m is None
                else wk.resample_masked(i, f, m, frames=frames))

    def plain(i, f, m=None):
        return wk.resample_plain(i, f, m, frames)

    got = _grads(kernel, img, flow, mask, gout, needs)
    want = _grads(plain, img, flow, mask, gout, needs)
    names = [k for k, need in zip(("image", "flow", "mask"), needs) if need]
    assert len(got) == len(names)
    for name, a, b in zip(names, got, want):
        _close(a, b, name, dtype)
    runs = [wk._launch_backward(gout, img, flow, mask, *needs, frames)
            for _ in range(2)]
    if wk.resample_backward_route(dtype, (n, h, w, c)) != "scalar64":
        for k in (1, 2):
            assert runs[0][k] is None or torch.equal(runs[0][k], runs[1][k])
