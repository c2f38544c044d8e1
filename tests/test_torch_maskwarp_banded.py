"""Kernel K3's route (the windowed mask warp) against the JAX package's
banded Pallas kernel, and its window arithmetic, on the CPU.

The JAX side is ``c2m_tpu.ops.pallas.maskwarp_banded.warp_masks`` in
interpret mode with ``plan_windows``' plan, as ``tests/test_pallas.py``
runs it, followed by the winner reduction of ``c2m_tpu/ops/raster.py``
(covered = warped >= 1 - 1e-4 on that path, the last covered node wins).
The port's side is ``ops.raster.generate_sparse_motion`` pushed above its
size rule, which on a CPU tensor takes the plain winner shared by K2 and K3.

Gates: the winner is identical on half-integer translations (no sample
near a threshold); on general affines at most 1e-3 of the pixels may differ
(the two sides decide covered at 1 - 1e-4 and 1 - 1e-5, and the hat
contraction sums in another order than the four-tap form: edge pixels).

``source_windows_plain`` is the kernel's window arithmetic: for every pixel
of every tile, each tap inside the image must lie inside the tile's window,
unless the tile is flagged for the global gather; an empty window means no
tap of the tile is inside the image.
"""

from unittest import mock

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from c2m_tpu.ops.pallas import maskwarp_banded as jax_banded
from c2m_tpu_torch.ops import raster
from c2m_tpu_torch.ops.hopper import maskwarp_banded, maskwarp_kernel
from tests.torch_port_fixtures import general_raster, half_integer_raster

H, W = 16, 256          # the smallest size the JAX kernel supports


def _jax_winner(inst, ids, mask, th):
    """The JAX package's banded route: plan, kernel (interpret), winner."""
    b, n, t = th.shape[:3]
    h, w = inst.shape[1:3]
    assert jax_banded.supported(h, w)
    valid = mask & (ids != 0)
    obj = (inst[:, None, :, :, 0] == ids[:, :, None, None]) \
        & valid[:, :, None, None]
    thj = jnp.asarray(th)
    yb, xb, ok = jax_banded.plan_windows(thj.reshape(b * n, t, 6), h, w)
    assert bool(ok), "the test's thetas must fit the JAX kernel's windows"
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", interp_call):
        warped = np.asarray(jax_banded.warp_masks(
            jnp.asarray(obj.astype(np.float32)), thj, yb, xb))
    covered = (warped >= 1.0 - 1e-4) & valid[:, :, None, None, None]
    rank = np.arange(1, n + 1, dtype=np.int32)[None, :, None, None, None]
    return np.where(covered, rank, 0).max(axis=1)


def _port_winner(monkeypatch, inst, ids, mask, th):
    """generate_sparse_motion above the size rule -> winner_bw."""
    monkeypatch.setattr(raster, "BANDED_ABOVE", 0)
    calls = []
    real = maskwarp_banded.warp_masks_winner_banded

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(maskwarp_banded, "warp_masks_winner_banded", spy)
    out = raster.generate_sparse_motion(
        torch.from_numpy(inst), torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(th))
    assert calls == [1], "the rasterizer did not take K3's route"
    return out["winner_bw"].numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_winner_identical_on_half_integer_translations(monkeypatch, seed):
    inst, ids, mask, th = half_integer_raster(2, 4, 3, H, W, seed)
    got = _port_winner(monkeypatch, inst, ids, mask, th)
    want = _jax_winner(inst, ids, mask, th)
    assert got.shape == want.shape == (2, 3, H, W)
    assert (want > 0).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_winner_on_general_affines(monkeypatch, seed):
    inst, ids, mask, th = general_raster(2, 4, 3, H, W, seed)
    th[..., 1] *= 0.2          # keep the shear inside the JAX kernel's windows
    th[..., 3] *= 0.2
    got = _port_winner(monkeypatch, inst, ids, mask, th)
    want = _jax_winner(inst, ids, mask, th)
    assert (want > 0).any()
    assert (got != want).mean() <= 1e-3


def test_size_rule_routes_as_the_jax_package():
    # every 128x256 path stays on K2; one 512x1024 clip goes to K3
    assert not raster.banded(12, 16, 5, 128, 256)
    assert not raster.banded(3, 16, 5, 128, 256)
    assert raster.banded(1, 24, 10, 512, 1024)
    assert raster.banded(4, 24, 10, 512, 1024)
    # the JAX package's own gate value
    assert raster.BANDED_ABOVE == 2e12


def test_below_the_rule_the_rasterizer_takes_k2(monkeypatch):
    inst, ids, mask, th = half_integer_raster(1, 2, 2, 16, 32, 0)
    monkeypatch.setattr(maskwarp_banded, "warp_masks_winner_banded",
                        lambda *a: pytest.fail("K3 below the size rule"))
    raster.generate_sparse_motion(
        torch.from_numpy(inst), torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(th))


def test_wrapper_takes_the_plain_winner_on_the_cpu_only():
    inst, ids, mask, th = general_raster(1, 3, 2, 24, 40, 3)
    args = (torch.from_numpy(inst[..., 0]), torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(th))
    assert torch.equal(maskwarp_banded.warp_masks_winner_banded(*args),
                       maskwarp_kernel.warp_masks_winner_plain(*args))
    assert maskwarp_banded.WARP_MASKS_BANDED.launches == 0
    with pytest.raises(ValueError):
        maskwarp_banded.warp_masks_winner_banded(
            *(a.to("meta") for a in args))


def _thetas(kind: str, rng, shape):
    th = np.zeros((*shape, 6), np.float32)
    th[..., 0] = th[..., 4] = 1.0
    if kind == "gt":            # axis-aligned scale + translation
        th[..., 0] += rng.randn(*shape) * 0.1
        th[..., 4] += rng.randn(*shape) * 0.1
        th[..., 2] = rng.randn(*shape) * 0.3
        th[..., 5] = rng.randn(*shape) * 0.3
    elif kind == "gnn":         # small shear
        th += rng.randn(*shape, 6).astype(np.float32) * 0.05
    elif kind == "wild":        # rotations, zooms, flips, far translations
        th = rng.randn(*shape, 6).astype(np.float32) * 3.0
    elif kind == "shear":       # fails plan_windows' verdict on the TPU
        th[..., 3] = 2.0
        th[..., 1] = -1.5
    elif kind == "degenerate":  # everything maps to one point / off the image
        th[..., :] = 0.0
        th[..., 2] = rng.choice([0.0, 5.0, -5.0], shape)
    return th


@pytest.mark.parametrize("kind", ["gt", "gnn", "wild", "shear", "degenerate"])
@pytest.mark.parametrize("hw,tile,win_max", [
    ((48, 80), (16, 32), 8192),      # the kernel's tile and budget
    ((37, 70), (16, 32), 600),       # ragged edges, a budget that overflows
    ((64, 64), (8, 8), 100),
])
def test_every_tap_lies_in_the_window_or_the_tile_gathers(kind, hw, tile,
                                                          win_max):
    h, w = hw
    rng = np.random.RandomState(sum(map(ord, kind)) + 1000 * hw[0])
    th = torch.from_numpy(_thetas(kind, rng, (2, 3, 2)))       # [B, N, T, 6]
    plan = maskwarp_banded.source_windows_plain(th, h, w, tile, win_max)
    ty, tx = -(-h // tile[0]), -(-w // tile[1])
    assert plan["window"].shape == (2, 3, 2, ty, tx, 4)
    if kind == "shear":
        _, _, ok = jax_banded.plan_windows(jnp.asarray(
            _thetas(kind, rng, (1, 1))), 256, 1024)
        assert not bool(ok)

    # the taps of every pixel, by the kernel's own float32 arithmetic
    xs = torch.arange(w, dtype=torch.float32)
    ys = torch.arange(h, dtype=torch.float32)
    bx = ((2.0 * xs + 1.0) / w - 1.0)[None, :]
    by = ((2.0 * ys + 1.0) / h - 1.0)[:, None]
    t6 = th[..., None, None, :]
    sx = (((t6[..., 0] * bx + t6[..., 1] * by + t6[..., 2]) + 1.0) * w
          - 1.0) * 0.5                                         # [B,N,T,h,w]
    sy = (((t6[..., 3] * bx + t6[..., 4] * by + t6[..., 5]) + 1.0) * h
          - 1.0) * 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)

    def per_pixel(v):                  # [B,N,T,ty,tx] -> [B,N,T,h,w]
        v = v.repeat_interleave(tile[0], dim=3)[..., :h, :]
        return v.repeat_interleave(tile[1], dim=4)[..., :w]

    wy0, wy1, wx0, wx1 = (per_pixel(plan["window"][..., k]) for k in range(4))
    empty, gather = per_pixel(plan["empty"]), per_pixel(plan["gather"])
    assert not (plan["empty"] & plan["gather"]).any()
    area = (plan["window"][..., 1] - plan["window"][..., 0] + 1) \
        * (plan["window"][..., 3] - plan["window"][..., 2] + 1)
    assert (area[~plan["empty"] & ~plan["gather"]] <= win_max).all()
    for dx in (0.0, 1.0):
        for dy in (0.0, 1.0):
            tx_, ty_ = x0 + dx, y0 + dy
            in_image = (tx_ >= 0) & (tx_ <= w - 1) & (ty_ >= 0) & (ty_ <= h - 1)
            in_window = ((tx_ >= wx0) & (tx_ <= wx1) & (ty_ >= wy0)
                         & (ty_ <= wy1))
            assert not (in_image & empty).any()
            assert (~in_image | in_window | gather).all()


def test_windows_follow_a_translation():
    """An identity affine's window is the tile plus the bilinear margin; a
    translation by whole tiles moves it by as much; far off the image it is
    empty; a strong zoom-out overflows the budget."""
    h, w, tile = 64, 128, (16, 32)
    th = torch.tensor([[1, 0, 0, 0, 1, 0],
                       [1, 0, 64 * 2 / w, 0, 1, 16 * 2 / h],   # +64 px, +16 px
                       [1, 0, 4.0, 0, 1, 0],                   # off the image
                       [8, 0, 0, 0, 8, 0]],                    # zoom-out x8
                      dtype=torch.float32).reshape(1, 4, 1, 6)
    plan = maskwarp_banded.source_windows_plain(th, h, w, tile, 1024)
    win = plan["window"][0, :, 0]
    assert win[0, 1, 1].tolist() == [15, 32, 31, 64]
    assert win[1, 1, 1].tolist() == [31, 48, 95, 127]
    assert plan["empty"][0, 2, 0].all() and not plan["empty"][0, 0].any()
    # the translated affine empties exactly the last tile column
    assert plan["empty"][0, 1, 0].tolist() == [[False] * 3 + [True]] * 4
    assert plan["gather"][0, 3, 0].any() and not plan["gather"][0, :3].any()


def _blocks_map(rng, b, n, h, w):
    """An instance map of n rectangles per row (later ones overwrite), ids
    26001.., with the last node absent from the map."""
    inst = np.zeros((b, h, w), np.float32)
    for bi in range(b):
        for k in range(n - 1):
            bh, bw = rng.randint(2, h // 2), rng.randint(2, w // 2)
            y0, x0 = rng.randint(0, h - bh), rng.randint(0, w - bw)
            inst[bi, y0:y0 + bh, x0:x0 + bw] = 26001 + k
    ids = np.tile(26001 + np.arange(n, dtype=np.int32), (b, 1))
    return torch.from_numpy(inst), torch.from_numpy(ids)


def test_node_boxes_hold_every_pixel_of_the_node_and_no_more():
    rng = np.random.RandomState(5)
    inst, ids = _blocks_map(rng, 2, 5, 20, 30)
    valid = torch.ones(2, 5, dtype=torch.bool)
    valid[1, 0] = False
    boxes = maskwarp_banded.node_boxes_plain(inst, ids, valid)
    assert boxes.shape == (2, 5, 4)
    for bi in range(2):
        for k in range(5):
            ys, xs = np.nonzero(inst[bi].numpy() == ids[bi, k].item())
            if len(ys) == 0 or not valid[bi, k]:
                assert boxes[bi, k].tolist() == [20, -1, 30, -1]
            else:
                assert boxes[bi, k].tolist() == [ys.min(), ys.max(),
                                                 xs.min(), xs.max()]
    assert boxes[0, 4].tolist() == [20, -1, 30, -1]      # the absent node


@pytest.mark.parametrize("kind", ["gt", "gnn", "wild", "shear", "degenerate"])
def test_a_skipped_node_has_no_matching_tap_in_the_tile(kind):
    """The kernel does not visit a node for a tile whose window is empty or
    misses the node's box: then no tap of any pixel of the tile may hit the
    node. Where it does visit, a tap outside the box reads 0: the box must
    hold every matching tap."""
    h, w, tile = 48, 80, (16, 32)
    rng = np.random.RandomState(sum(map(ord, kind)))
    b, n, t = 2, 4, 2
    inst, ids = _blocks_map(rng, b, n, h, w)
    valid = torch.ones(b, n, dtype=torch.bool)
    th = torch.from_numpy(_thetas(kind, rng, (b, n, t)))
    if kind == "gt":
        th[..., 2] *= 3.0           # far translations: many windows miss
    boxes = maskwarp_banded.node_boxes_plain(inst, ids, valid)
    plan = maskwarp_banded.source_windows_plain(th, h, w, tile, 600, boxes)
    assert (plan["skip"] >= plan["empty"]).all()
    assert plan["skip"][:, n - 1].all()                  # the absent node
    assert not (plan["skip"] & plan["gather"]).any()

    xs = torch.arange(w, dtype=torch.float32)
    ys = torch.arange(h, dtype=torch.float32)
    bx = ((2.0 * xs + 1.0) / w - 1.0)[None, :]
    by = ((2.0 * ys + 1.0) / h - 1.0)[:, None]
    t6 = th[..., None, None, :]
    sx = (((t6[..., 0] * bx + t6[..., 1] * by + t6[..., 2]) + 1.0) * w
          - 1.0) * 0.5                                         # [B,N,T,h,w]
    sy = (((t6[..., 3] * bx + t6[..., 4] * by + t6[..., 5]) + 1.0) * h
          - 1.0) * 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    skip = plan["skip"].repeat_interleave(tile[0], dim=3)[..., :h, :]
    skip = skip.repeat_interleave(tile[1], dim=4)[..., :w]
    box = boxes[:, :, None, None, None, :]
    bidx = torch.arange(b)[:, None, None, None, None]
    want = ids[:, :, None, None, None].float()
    hits = 0
    for dx in (0.0, 1.0):
        for dy in (0.0, 1.0):
            tx_, ty_ = x0 + dx, y0 + dy
            in_image = (tx_ >= 0) & (tx_ <= w - 1) & (ty_ >= 0) & (ty_ <= h - 1)
            xi = tx_.clamp(0, w - 1).nan_to_num(0).long()
            yi = ty_.clamp(0, h - 1).nan_to_num(0).long()
            match = in_image & (inst[bidx, yi, xi] == want)
            in_box = ((yi >= box[..., 0]) & (yi <= box[..., 1])
                      & (xi >= box[..., 2]) & (xi <= box[..., 3]))
            assert not (match & skip).any()
            assert (~match | in_box).all()
            hits += int(match.sum())
    if kind in ("gt", "gnn"):
        assert hits > 0 and plan["skip"][:, :n - 1].any() \
            and not plan["skip"][:, :n - 1].all()


def _plan_inputs(kind, seed, b=2, n=40, t=3, h=64, w=128):
    """Objects of a few tiles on a 64x128 map, thetas of ``kind``; more
    nodes than one 32-bit word of live bits."""
    rng = np.random.RandomState(seed)
    inst = np.zeros((b, h, w), np.float32)
    for bi in range(b):
        for k in range(n):
            y0, x0 = rng.randint(0, h - 16), rng.randint(0, w - 32)
            inst[bi, y0:y0 + rng.randint(3, 16),
                 x0:x0 + rng.randint(3, 32)] = 100 + k
    ids = np.tile(100 + np.arange(n, dtype=np.int32), (b, 1))
    valid = rng.rand(b, n) > 0.2
    th = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (b, n, t, 1))
    if kind == "wild":
        th = (rng.randn(b, n, t, 6) * 3.0).astype(np.float32)
    else:
        th[..., 0] += rng.randn(b, n, t) * 0.05
        th[..., 4] += rng.randn(b, n, t) * 0.05
        th[..., 1] = rng.randn(b, n, t) * 0.03
        th[..., 3] = rng.randn(b, n, t) * 0.03
        th[..., 2] = rng.randn(b, n, t) * 0.2
        th[..., 5] = rng.randn(b, n, t) * 0.2
    return [torch.as_tensor(a) for a in (inst, ids, valid, th)]


@pytest.mark.parametrize("kind", ["gnn", "wild"])
def test_tile_masks_are_the_window_verdicts_bit_for_bit(kind):
    """The plan's live-node ballots, laid out per (b, t, tile) as the
    kernel's warps hold them, unpack to exactly the (tile, node) pairs that
    source_windows_plain does not skip; ``tiles`` holds exactly the tiles
    with a live node."""
    args = _plan_inputs(kind, 3)
    b, n, t = args[3].shape[:3]
    plan = maskwarp_banded.tile_masks_plain(*args)
    boxes = maskwarp_banded.node_boxes_plain(*args[:3])
    skip = maskwarp_banded.source_windows_plain(args[3], 64, 128,
                                                boxes=boxes)["skip"]
    masks = plan["masks"]
    assert masks.shape == (b * t * 4 * 4, 2)
    assert int(masks.max()) < 2 ** 32 and int(masks.min()) >= 0
    bits = ((masks[..., None] >> torch.arange(32)) & 1).reshape(-1, 64)[:, :n]
    want = ~skip.permute(0, 2, 3, 4, 1).reshape(-1, n)
    assert torch.equal(bits.bool(), want)
    assert torch.equal(plan["tiles"], torch.nonzero(want.any(-1)).flatten())
    assert 0 < plan["tiles"].numel() < masks.shape[0]


@pytest.mark.parametrize("kind", ["gnn", "wild"])
def test_winner_from_the_plan_alone_matches_plain(kind):
    """Zeros in the tiles without a live node, and in the others only the
    nodes their bits name, in node order: the plain winner exactly, at
    64x128."""
    args = _plan_inputs(kind, 4)
    got = maskwarp_banded.warp_masks_winner_planned_plain(*args)
    assert torch.equal(got, maskwarp_kernel.warp_masks_winner_plain(*args))
