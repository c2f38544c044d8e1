"""Kernel K3: windowed ("banded") affine mask warp fused with the winner,
for maps too large for K2's all-nodes gather (512x1024).

Replaces the Pallas kernel ``_call`` / ``_kernel`` of
``c2m_tpu/ops/pallas/maskwarp_banded.py`` with its window plan
(``plan_windows``), the ``lax.cond`` gather fallback around it and the
winner reduction after it (``c2m_tpu/ops/raster.py:308-330``). CUDA source:
``csrc/maskwarp_banded.cu``. It computes K2's function
(:func:`maskwarp_kernel.warp_masks_winner_plain` is the plain version of
both): a first pass takes every node's bounding box on the instance map;
then a warp per (b, t, 16x32 output tile) plans: the tile's source window
under each node's affine follows from the tile's four corners, and a window
that is empty or misses the node's box skips the node for the tile (a
ballot makes the tile's live-node bits). The warp samples its 512 pixels
for the live nodes only, in node order, with K2's per-pixel taps (a tap
outside the node's box is 0 unread). :func:`node_boxes_plain` and
:func:`source_windows_plain` are that box and window arithmetic in PyTorch,
float32 operation for operation, :func:`tile_masks_plain` the plan's bits
per tile as the warp holds them, and :func:`warp_masks_winner_planned_plain`
the winner made from those bits alone, so they can be tested without a
card.

A CPU tensor takes the plain winner; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from c2m_tpu_torch.ops import hopper
from c2m_tpu_torch.ops.hopper import maskwarp_kernel
from c2m_tpu_torch.ops.hopper.maskwarp_kernel import (INTERIOR_EPS,
                                                      covered_plain,
                                                      warp_masks_winner_plain)

# the kernel's constants (csrc/maskwarp_banded.cu)
TILE = (16, 32)      # output tile, rows x columns
WIN_MAX = 8192       # pixels of a region above which it is a strong zoom-out
                     # (``gather`` below)
NODES_MAX = 2048     # the box pass keeps 20 bytes per node in 48 KB

WARP_MASKS_BANDED = hopper.Kernel(
    "warp_masks_banded", "c2m_tpu_torch/csrc/maskwarp_banded.cu")
KERNELS = (WARP_MASKS_BANDED,)


def _source_coord(a, b, c, bx, by, size: int):
    g = a * bx + b * by + c
    return ((g + 1.0) * size - 1.0) * 0.5


def node_boxes_plain(instance: torch.Tensor, inst_ids: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The bounding box of ``instance == id`` for every node: instance
    [B, H, W], inst_ids [B, N], valid [B, N] bool -> [B, N, 4] int64
    (y0, y1, x0, x1), inclusive. A node that is invalid or nowhere on the
    map gets the empty box (h, -1, w, -1)."""
    _, h, w = instance.shape
    mask = ((instance[:, None] == inst_ids[:, :, None, None].to(instance.dtype))
            & valid[:, :, None, None].bool())                 # [B, N, H, W]
    rows, cols = mask.any(dim=3), mask.any(dim=2)             # [B,N,H], [B,N,W]
    ys = torch.arange(h, device=instance.device)
    xs = torch.arange(w, device=instance.device)
    return torch.stack([
        torch.where(rows, ys, h).amin(dim=2),
        torch.where(rows, ys, -1).amax(dim=2),
        torch.where(cols, xs, w).amin(dim=2),
        torch.where(cols, xs, -1).amax(dim=2)], dim=-1)


def source_windows_plain(thetas: torch.Tensor, h: int, w: int,
                         tile: Tuple[int, int] = TILE,
                         win_max: int = WIN_MAX,
                         boxes: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """The source window of every (b, n, t, tile), as the kernel derives it.

    thetas [B, N, T, 6] float32 -> over [B, N, T, tiles_y, tiles_x]:
    ``window`` [..., 4] int64 (y0, y1, x0, x1), inclusive and clipped to the
    image; ``empty`` (the tile maps wholly off the image); ``region``
    [..., 4], the window met with the node's box from ``boxes`` [B, N, 4]
    (:func:`node_boxes_plain`; the window itself without ``boxes``);
    ``skip`` (the window is empty or misses the box: the kernel does not
    visit the node for this tile); ``gather`` (the region exceeds
    ``win_max`` pixels: a strong zoom-out, whose taps lie far apart; the
    kernel reads every tap from the map, near or far). The affine is evaluated at the tile's four corner pixels
    (source coordinates are affine in the output pixel, so their extremes
    sit there), widened by one pixel each side for the bilinear support.
    """
    th_, tw_ = tile
    dev = thetas.device
    th = thetas.float()[:, :, :, None, None, :]            # [B,N,T,1,1,6]
    r0 = torch.arange(0, h, th_, device=dev, dtype=torch.float32)
    c0 = torch.arange(0, w, tw_, device=dev, dtype=torch.float32)
    rows = torch.stack([r0, (r0 + (th_ - 1)).clamp_max(h - 1.0)])   # [2, TY]
    cols = torch.stack([c0, (c0 + (tw_ - 1)).clamp_max(w - 1.0)])   # [2, TX]
    by = (2.0 * rows + 1.0) / h - 1.0
    bx = (2.0 * cols + 1.0) / w - 1.0
    sx_lo = sx_hi = sy_lo = sy_hi = None
    for k in range(4):
        bxk = bx[k & 1][None, None, None, None, :]
        byk = by[k >> 1][None, None, None, :, None]
        sx = _source_coord(th[..., 0], th[..., 1], th[..., 2], bxk, byk, w)
        sy = _source_coord(th[..., 3], th[..., 4], th[..., 5], bxk, byk, h)
        if k == 0:
            sx_lo, sx_hi, sy_lo, sy_hi = sx, sx, sy, sy
        else:
            # fmin/fmax drop a NaN operand, as CUDA's fminf/fmaxf
            sx_lo, sx_hi = torch.fmin(sx_lo, sx), torch.fmax(sx_hi, sx)
            sy_lo, sy_hi = torch.fmin(sy_lo, sy), torch.fmax(sy_hi, sy)
    zero = torch.zeros((), device=dev)
    xlo = torch.fmax(torch.floor(sx_lo) - 1.0, zero)
    xhi = torch.fmin(torch.ceil(sx_hi) + 1.0, zero + (w - 1.0))
    ylo = torch.fmax(torch.floor(sy_lo) - 1.0, zero)
    yhi = torch.fmin(torch.ceil(sy_hi) + 1.0, zero + (h - 1.0))
    empty = (xlo > xhi) | (ylo > yhi)
    window = torch.stack([ylo, yhi, xlo, xhi], dim=-1).long()
    region = window
    if boxes is not None:
        box = boxes[:, :, None, None, None, :].to(dev)
        lo = torch.maximum(window[..., 0::2], box[..., 0::2])   # y0, x0
        hi = torch.minimum(window[..., 1::2], box[..., 1::2])   # y1, x1
        region = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                             dim=-1)
    rh = region[..., 1] - region[..., 0] + 1
    rw = region[..., 3] - region[..., 2] + 1
    skip = empty | (rh <= 0) | (rw <= 0)
    return {"window": window, "empty": empty, "region": region, "skip": skip,
            "gather": ~skip & (rh * rw > win_max)}


def tile_masks_plain(instance: torch.Tensor, inst_ids: torch.Tensor,
                     valid: torch.Tensor, thetas: torch.Tensor,
                     tile: Tuple[int, int] = TILE) -> Dict[str, torch.Tensor]:
    """The kernel's plan, laid out as its warps hold it: for every (b, t,
    tile) in ``((b * T + t) * tiles_y + tile_y) * tiles_x + tile_x`` order
    (the warp's number), ``masks`` [tiles, words] int64 holding the 32-bit
    ballots of its live-node bits, one per round of 32 nodes (bit j of word
    k: node 32k + j is visited), words = max(1, ceil(N/32)); and ``tiles``,
    the ascending numbers of the tiles that have a live node (the only
    warps that sample). A node is live for a tile where it is valid,
    somewhere on the map, and the tile's source window, clipped to the
    image, meets its box: the verdict of :func:`source_windows_plain`,
    evaluated here per (tile, node) as a lane of the warp does."""
    th_, tw_ = tile
    b, h, w = instance.shape
    n, t = thetas.shape[1:3]
    dev = instance.device
    boxes = node_boxes_plain(instance, inst_ids, valid)          # [B, N, 4]
    r0 = torch.arange(0, h, th_, device=dev)
    c0 = torch.arange(0, w, tw_, device=dev)
    ty, tx = len(r0), len(c0)
    # corner base coordinates per tile: [TY, 2] and [TX, 2]
    by = (2.0 * torch.stack([r0, (r0 + th_ - 1).clamp_max(h - 1)], -1).float()
          + 1.0) / h - 1.0
    bx = (2.0 * torch.stack([c0, (c0 + tw_ - 1).clamp_max(w - 1)], -1).float()
          + 1.0) / w - 1.0
    # [B, T, TY, TX, N, 6]: a tile's lanes are its nodes
    th = thetas.float().permute(0, 2, 1, 3)[:, :, None, None]
    lo = hi = None
    for k in range(4):
        cx = bx[None, None, None, :, None, k & 1]
        cy = by[None, None, :, None, None, k >> 1]
        s = torch.stack([
            _source_coord(th[..., 0], th[..., 1], th[..., 2], cx, cy, w),
            _source_coord(th[..., 3], th[..., 4], th[..., 5], cx, cy, h)], -1)
        lo, hi = (s, s) if k == 0 else (torch.fmin(lo, s), torch.fmax(hi, s))
    zero = torch.zeros((), device=dev)
    size = torch.tensor([w - 1.0, h - 1.0], device=dev)
    wlo = torch.fmax(torch.floor(lo) - 1.0, zero)                # (x, y)
    whi = torch.fmin(torch.ceil(hi) + 1.0, size)
    box = boxes[:, None, None, None].to(dev)                     # [B,1,1,1,N,4]
    rlo = torch.maximum(wlo.long(), box[..., [2, 0]])
    rhi = torch.minimum(whi.long(), box[..., [3, 1]])
    live = ((wlo <= whi).all(-1) & (rlo <= rhi).all(-1)
            & valid[:, None, None, None, :].to(dev)
            & (box[..., 0] < h))                                 # nowhere: h
    words = max(1, -(-n // 32))
    bits = torch.zeros(b, t, ty, tx, words * 32, dtype=torch.int64,
                       device=dev)
    bits[..., :n] = live.long()
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=dev)
    masks = (bits.reshape(-1, words, 32) * weights).sum(-1)
    tiles = torch.nonzero(masks.any(-1)).flatten()
    return {"masks": masks, "tiles": tiles}


def warp_masks_winner_planned_plain(instance: torch.Tensor,
                                    inst_ids: torch.Tensor,
                                    valid: torch.Tensor,
                                    thetas: torch.Tensor,
                                    tile: Tuple[int, int] = TILE
                                    ) -> torch.Tensor:
    """The winner as the kernel's warps make it, from the plan alone: every
    pixel of a tile without a live node is 0, and a tile with some visits
    only the nodes its bits name, in node order. Equal to
    :func:`warp_masks_winner_plain` exactly where the plan skips no node
    that covers a pixel of the tile."""
    b, h, w = instance.shape
    n, t = thetas.shape[1:3]
    th_, tw_ = tile
    ty, tx = -(-h // th_), -(-w // tw_)
    plan = tile_masks_plain(instance, inst_ids, valid, thetas, tile)
    visit = torch.zeros_like(plan["masks"])
    visit[plan["tiles"]] = plan["masks"][plan["tiles"]]
    winner = torch.zeros(b, t, h, w, dtype=torch.int32, device=instance.device)
    for k in range(n):
        bit = ((visit[:, k // 32] >> (k % 32)) & 1).bool()
        bit = bit.reshape(b, t, ty, tx).repeat_interleave(th_, 2)
        bit = bit.repeat_interleave(tw_, 3)[:, :, :h, :w]
        covered = covered_plain(instance, inst_ids, valid, thetas, k) & bit
        winner = torch.where(covered, torch.full_like(winner, k + 1), winner)
    return winner


def _launch(instance, inst_ids, valid, thetas):
    ids, valid_i, winner = maskwarp_kernel.check_and_allocate(
        instance, inst_ids, valid, thetas)
    if winner.numel() == 0:
        return winner
    b, t, h, w = winner.shape
    n = thetas.shape[1]
    hopper.require(n <= NODES_MAX and b <= 65535,
                   f"at most {NODES_MAX} nodes and 65535 rows, got {n}, {b}")
    # the kernel's scratch: the nodes' boxes
    scratch = torch.empty(b * n * 4, dtype=torch.int32,
                          device=instance.device)
    err = hopper.library().c2m_warp_masks_banded(
        instance.data_ptr(), ids.data_ptr(), valid_i.data_ptr(),
        thetas.data_ptr(), scratch.data_ptr(), winner.data_ptr(), b, n, t, h,
        w, 1.0 - INTERIOR_EPS, hopper.stream_ptr(instance))
    hopper.check(err, "c2m_warp_masks_banded")
    WARP_MASKS_BANDED.launches += 1
    return winner


def warp_masks_winner_banded(instance: torch.Tensor, inst_ids: torch.Tensor,
                             valid: torch.Tensor, thetas: torch.Tensor
                             ) -> torch.Tensor:
    """Winner node per (b, t, y, x) of the warped object masks: instance
    [B, H, W] f32; inst_ids [B, N]; valid [B, N] bool; thetas [B, N, T, 6]
    f32 -> winner [B, T, H, W] int32, exact for every theta."""
    if instance.device.type == "cpu":
        return warp_masks_winner_plain(instance, inst_ids, valid, thetas)
    if instance.device.type != "cuda":
        raise ValueError(f"warp_masks_winner_banded: no kernel for "
                         f"{instance.device}")
    return _launch(instance, inst_ids, valid, thetas)
