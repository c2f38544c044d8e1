"""What can be held on the CPU of the two kernels laid out for the H100.

K1 forward (``csrc/resample.cu``) and K4 (``csrc/splat.cu``) run only on a
card, but what decides how they run is plain Python: the route functions of
their wrappers, the tile decomposition of the splat (emulated by
``corresponding_map_tiled_plain``) and the tap addressing of K1's narrow-pixel
route (emulated by ``resample_pixel_route_plain``). These tests hold those
against the plain versions and against the JAX package's ops, float32, same
numpy inputs into both.
"""

import inspect
import os
import zlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from c2m_tpu.ops import splat as jsplat
from c2m_tpu_torch.ops.hopper import splat_kernel as sk
from c2m_tpu_torch.ops.hopper import warp_kernels as wk

BF16, F32 = torch.bfloat16, torch.float32

# the shapes the five paths give K1's forward: folded frames x decoder skips
# and bottleneck in bfloat16, frames and flows in float32
JOURNAL_SKIPS = [(32, 64, 64), (16, 32, 128), (8, 16, 256), (4, 8, 512),
                 (16, 32, 256)]
LONG_SKIPS = [(128, 256, 64), (64, 128, 128), (32, 64, 256), (16, 32, 512),
              (64, 128, 256)]
PATH_ROUTES = (
    [(BF16, (b, *hwc), "vec") for b in (60, 15) for hwc in JOURNAL_SKIPS]
    + [(BF16, (b, *hwc), "vec") for b in (40, 10) for hwc in LONG_SKIPS]
    + [(F32, (b, 128, 256, 3), "pixel") for b in (60, 15)]
    + [(F32, (b, 512, 1024, 3), "pixel") for b in (40, 10)]
    + [(F32, (15, 128, 256, 2), "pixel"), (F32, (10, 512, 1024, 2), "pixel")])

OTHER_ROUTES = [
    # channel counts that fill 16 bytes in one type and not in the other
    (F32, (2, 17, 33, 64), "vec"), (F32, (2, 17, 33, 72), "vec"),
    (BF16, (2, 17, 33, 72), "vec"), (F32, (2, 17, 33, 4), "vec"),
    (BF16, (2, 17, 33, 4), "pixel"), (BF16, (2, 17, 33, 3), "pixel"),
    (F32, (2, 17, 33, 1), "pixel"), (BF16, (2, 17, 33, 1), "pixel"),
    # neither: a thread per element
    (F32, (2, 17, 33, 5), "scalar"), (F32, (2, 17, 33, 6), "scalar"),
    (BF16, (2, 17, 33, 12), "scalar"), (BF16, (2, 17, 33, 5), "scalar"),
    (F32, (1, 9, 7, 37), "scalar"),
    # 1-wide and 1-high images route by their channels like any other
    (F32, (2, 6, 1, 3), "pixel"), (F32, (2, 1, 9, 3), "pixel"),
    (BF16, (3, 1, 1, 8), "vec"),
    # more elements than 32 bits count, but each image within them
    (BF16, (40, 512, 1024, 128), "vec"),
    # beyond 32-bit indices: pixels of the tensor, elements of one image,
    # elements of the tensor on the scalar route
    (F32, (1, 50000, 50000, 1), "scalar64"),
    (BF16, (1, 20000, 20000, 8), "scalar64"),
    (F32, (500, 1024, 1024, 5), "scalar64"),
]


@pytest.mark.parametrize("dtype,shape,want", PATH_ROUTES + OTHER_ROUTES)
def test_resample_route(dtype, shape, want):
    assert wk.resample_route(dtype, shape) == want
    assert want in wk.ROUTES


@pytest.mark.parametrize("dtype,shape,_", PATH_ROUTES + OTHER_ROUTES)
def test_resample_route_unaligned_is_scalar(dtype, shape, _):
    """A contiguous view whose base is not 16-byte aligned never takes a
    route that loads 16 bytes or a float2 flow."""
    got = wk.resample_route(dtype, shape, aligned=False)
    total = int(np.prod(shape))
    assert got == ("scalar" if total < 2 ** 31 else "scalar64")


def test_routes_have_no_way_to_the_plain_version():
    """The route functions see dtype, shape and alignment, never a device:
    whatever they answer names a kernel of csrc/, and a tensor that lies
    neither on the CPU nor on a card raises."""
    assert set(inspect.signature(wk.resample_route).parameters) == {
        "dtype", "shape", "aligned"}
    assert set(inspect.signature(sk.splat_route).parameters) == {
        "shape", "aligned"}
    assert set(wk.ROUTES) == {"scalar", "vec", "pixel", "scalar64"}
    assert sorted(wk.ROUTES.values()) == list(range(len(wk.ROUTES)))
    img = torch.empty(1, 4, 4, 3, device="meta")
    flow = torch.empty(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError):
        wk.resample(img, flow)
    with pytest.raises(ValueError):
        sk.corresponding_map(flow)


@pytest.mark.parametrize("shape,want", [
    ((60, 128, 256, 2), "float4"), ((15, 128, 256, 2), "float4"),
    ((30, 128, 256, 2), "float4"), ((40, 512, 1024, 2), "float4"),
    ((10, 512, 1024, 2), "float4"), ((1, 33, 68, 2), "float4"),
    ((2, 50, 70, 2), "scalar"), ((2, 7, 5, 2), "scalar"),
    ((1, 64, 1, 2), "scalar")])
def test_splat_route(shape, want):
    assert sk.splat_route(shape) == want


def test_splat_tile_constants():
    """The wrapper's mirror of csrc/splat.cu's tile: the same numbers,
    16-byte groups in the flush and static shared memory under 48 KB."""
    (tw, th), r = sk.TILE, sk.HALO
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, sk.SPLAT.source)) as f:
        assert f"TILE_W = {tw}, TILE_H = {th}, HALO = {r};" in f.read()
    assert tw % 4 == 0 and r % 4 == 0
    assert (tw + 2 * r) * (th + 2 * r) * 4 <= 48 * 1024
    # an output that does not start on a 16-byte boundary flushes by scalars
    assert sk.splat_route((1, 32, 64, 2), aligned=False) == "scalar"


def _coords(b, h, w, flow):
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    return (np.stack([xs, ys], -1)[None] + flow).astype(np.float32)


def _flow(kind, b, h, w, halo, rng):
    """Flows shorter than, as long as and longer than the halo; points that
    leave the image on each of its four sides; NaN coordinates."""
    if kind == "short":
        return rng.uniform(-0.4 * max(halo, 1), 0.4 * max(halo, 1),
                           (b, h, w, 2))
    if kind == "halo":            # corners land on the accumulator's rim
        return rng.choice([-float(halo), float(halo), halo - 0.5,
                           -halo - 0.5, halo + 0.5], (b, h, w, 2))
    if kind == "long":
        return rng.uniform(-3.0 * halo - 9, 3.0 * halo + 9, (b, h, w, 2))
    if kind == "leaving":
        flow = rng.uniform(-2, 2, (b, h, w, 2))
        flow[:, :, :3, 0] -= 4.5          # off the left side
        flow[:, :, -3:, 0] += 4.5         # the right
        flow[:, :3, :, 1] -= 4.5          # the top
        flow[:, -3:, :, 1] += 4.5         # the bottom
        return flow
    assert kind == "integer"      # exact pixel hits: three corners weigh 0
    return rng.randint(-5, 6, (b, h, w, 2)).astype(np.float64)


@pytest.mark.parametrize("tile,halo", [(sk.TILE, sk.HALO), ((16, 8), 4),
                                       ((8, 8), 0), ((64, 32), 12)])
@pytest.mark.parametrize("kind", ["short", "halo", "long", "leaving",
                                  "integer"])
@pytest.mark.parametrize("hw", [(50, 70), (33, 130), (64, 128)])
def test_splat_tiled_decomposition_matches_plain_and_jax(hw, kind, tile, halo):
    """In-halo corners through per-tile accumulators, the rest direct, then
    the flush: the same masses as the plain scatter (1e-6: the same float32
    terms in another order) and as the JAX package's op (its 1e-5 gate)."""
    h, w = hw
    rng = np.random.RandomState(zlib.crc32(repr((hw, kind, halo)).encode()))
    coords = _coords(2, h, w, _flow(kind, 2, h, w, halo, rng))
    got = sk.corresponding_map_tiled_plain(torch.as_tensor(coords), tile, halo)
    want = sk.corresponding_map_plain(torch.as_tensor(coords))
    assert got.shape == (2, h, w, 1)
    assert (got - want).abs().max().item() <= 1e-6 * max(
        1.0, want.max().item())
    ref = np.asarray(jsplat.corresponding_map(jnp.asarray(coords)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tile,halo", [(sk.TILE, sk.HALO), ((16, 8), 4)])
def test_splat_nan_and_far_coordinates_add_nothing(tile, halo):
    """A NaN, infinite or far-out coordinate adds no mass, in the plain
    version, in the tiled decomposition and in the JAX package's op."""
    rng = np.random.RandomState(9)
    h, w = 40, 72
    coords = _coords(1, h, w, rng.uniform(-3, 3, (1, h, w, 2)))
    dirty = coords.copy()
    spots = [(3, 4), (5, 60), (39, 0), (20, 71)]
    dirty[0, 3, 4] = np.nan
    dirty[0, 5, 60, 0] = np.inf
    dirty[0, 39, 0, 1] = -1e30
    dirty[0, 20, 71] = (3e9, 1.0)
    lost = coords.copy()
    for y, x in spots:
        lost[0, y, x] = -5.0              # off the image: adds nothing
    want = sk.corresponding_map_plain(torch.as_tensor(lost))
    for fn in (sk.corresponding_map_plain,
               lambda c: sk.corresponding_map_tiled_plain(c, tile, halo)):
        got = fn(torch.as_tensor(dirty))
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-6
    ref = np.asarray(jsplat.corresponding_map(jnp.asarray(dirty)))
    np.testing.assert_allclose(want.numpy(), ref, atol=1e-5)


def _border_flows(h, w, rng):
    """Flows whose source coordinates fall on and beyond every border, on
    integer taps and between them, plus uniform noise."""
    wf = w / max(w - 1.0, 1e-6)
    hf = h / max(h - 1.0, 1e-6)
    xs = np.arange(w, dtype=np.float64)[None, :]
    ys = np.arange(h, dtype=np.float64)[:, None]
    out = [rng.uniform(-8, 8, (h, w, 2))]
    for tx, ty in ((0.0, 0.0), (w - 1.0, h - 1.0), (-3.0, -3.0),
                   (w + 2.0, h + 2.0), (w - 1.5, h - 1.5), (0.25, h - 1.0),
                   (w - 2.0, 0.5)):
        # the flow that sends every pixel to source coordinate (tx, ty)
        fx = (tx + 0.5) / wf - xs + 0 * ys
        fy = (ty + 0.5) / hf - ys + 0 * xs
        out.append(np.stack([fx, fy], -1))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("w", [1, 2, 5])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_pixel_route_addressing_matches_plain_exactly(c, w, h, masked):
    """A row's two taps as one run from x0 (C values long where x0 is the
    last column), the lower row W*C further (0 where y0 is the last row):
    bit for bit the plain version, in float32 and bfloat16."""
    rng = np.random.RandomState(100 * c + 10 * w + h)
    flow = torch.as_tensor(_border_flows(h, w, rng))
    b = flow.shape[0]
    img = torch.as_tensor(rng.rand(b, h, w, c).astype(np.float32))
    mask = (torch.as_tensor(rng.rand(b, h, w, 1).astype(np.float32))
            if masked else None)
    for image in (img, img.bfloat16()):
        want = wk.resample_plain(image, flow, mask)
        got = wk.resample_pixel_route_plain(image, flow, mask)
        assert got.dtype == image.dtype
        assert torch.equal(got, want)


# the shapes the paths give K1's backward (output rows: folded frames) and
# the route each takes: the decoder skips, bottlenecks, the warped loss and
# the flow consistency
BACKWARD_PATH_ROUTES = (
    [(BF16, (15, *hwc), "vec") for hwc in JOURNAL_SKIPS]
    + [(BF16, (10, *hwc), "vec") for hwc in LONG_SKIPS]
    + [(F32, (15, 16, 32, 256), "vec"), (F32, (15, 128, 256, 3), "pixel"),
       (F32, (10, 512, 1024, 3), "pixel"), (F32, (15, 128, 256, 2), "pixel")])
BACKWARD_OTHER_ROUTES = [
    (BF16, (2, 17, 33, 4), "vec"), (F32, (2, 17, 33, 1), "pixel"),
    (BF16, (2, 17, 33, 3), "pixel"), (F32, (2, 17, 33, 4), "vec"),
    (BF16, (2, 17, 33, 40), "vec"), (BF16, (2, 17, 33, 12), "vec"),
    # neither layout: the first version
    (F32, (2, 17, 33, 5), "scalar64"), (BF16, (2, 17, 33, 6), "scalar64"),
    (F32, (1, 9, 7, 37), "scalar64"),
    (F32, (1, 50000, 50000, 1), "scalar64"),
    (BF16, (1, 20000, 20000, 8), "scalar64")]


@pytest.mark.parametrize("dtype,shape,want",
                         BACKWARD_PATH_ROUTES + BACKWARD_OTHER_ROUTES)
def test_resample_backward_route(dtype, shape, want):
    assert wk.resample_backward_route(dtype, shape) == want
    assert want in wk.BACKWARD_ROUTES
    assert wk.resample_backward_route(dtype, shape, aligned=False) == \
        "scalar64"


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 64, (4, 16)), (BF16, 128, (4, 32)), (BF16, 256, (4, 32)),
    (BF16, 512, (4, 32)), (BF16, 40, (4, 16)), (BF16, 8, (4, 2)),
    (F32, 256, (4, 32)), (F32, 4, (4, 1)), (F32, 12, (4, 4))])
def test_backward_lane_group(dtype, c, want):
    """A lane's piece of 4 channels and the lanes of a pixel where its flow
    and mask sums are taken: min(C/4, 32) rounded up to a power of two, so
    that a group never straddles a warp."""
    assert wk.resample_backward_route(dtype, (2, 5, 7, c)) == "vec"
    assert wk.backward_lane_group(c, "vec") == want
    assert wk.backward_lane_group(3, "pixel") == (3, 1)


# (image shape, frames, dtype): C on the vec route from one lane to more
# pieces than lanes, the pixel route at C = 1..3; frames 1 and 5
DECOMPOSED = [((2, 9, 13, 8), 1, BF16), ((2, 9, 13, 64), 5, BF16),
              ((1, 5, 7, 512), 3, BF16), ((2, 9, 13, 40), 2, BF16),
              ((2, 9, 13, 12), 5, F32), ((2, 9, 13, 256), 1, F32),
              ((3, 17, 9, 3), 5, F32), ((2, 6, 5, 2), 1, F32),
              ((2, 6, 5, 1), 2, BF16)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape,frames,dtype", DECOMPOSED)
def test_backward_decomposition_matches_autograd(shape, frames, dtype,
                                                 masked):
    """resample_backward_plain, the work as the vec and pixel routes split
    it (per-tap index_add_ of the image gradient into one image for all its
    frames, per-pixel channel sums in lane-group order), equals autograd of
    the plain version: 2e-5 of the largest gradient (float32 sums in another
    order), 2^-7 for a bfloat16 image gradient (one rounding of such a sum
    may land on the neighbouring bfloat16 value)."""
    b, h, w, c = shape
    rng = np.random.RandomState(zlib.crc32(repr((shape, frames)).encode()))
    img = torch.as_tensor(rng.rand(*shape).astype(np.float32)).to(dtype)
    n = b * frames
    flow = torch.as_tensor(((rng.rand(n, h, w, 2) - 0.5) * 20)
                           .astype(np.float32))
    mask = (torch.as_tensor(rng.rand(n, h, w, 1).astype(np.float32))
            if masked else None)
    gout = torch.as_tensor(rng.randn(n, h, w, c).astype(np.float32)).to(dtype)
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (img, flow, mask)]
    out = wk.resample_plain(*leaves, frames)
    want = torch.autograd.grad(out, [t for t in leaves if t is not None],
                               gout)
    got = wk.resample_backward_plain(gout, img, flow, mask, frames)
    assert (got[2] is None) == (not masked)
    for name, a, b_ in zip(("image", "flow", "mask"), got, want):
        assert a.dtype == b_.dtype and a.shape == b_.shape, name
        tol = 2 ** -7 if (name == "image" and dtype == BF16) else 2e-5
        scale = max(b_.float().abs().max().item(), 1e-6)
        assert (a.float() - b_.float()).abs().max().item() / scale <= tol, name
    # each gradient alone is its part of the full set
    alone = wk.resample_backward_plain(gout, img, flow, mask, frames,
                                       needs=(False, True, False))
    assert alone[0] is None and alone[2] is None
    assert torch.equal(alone[1], got[1])
