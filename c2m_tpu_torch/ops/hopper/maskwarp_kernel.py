"""Kernel K2: affine mask warp fused with winner-takes-last composition.

Replaces the Pallas kernel ``_call`` / ``_kernel`` in
``c2m_tpu/ops/pallas/maskwarp_kernel.py`` together with the winner
reduction that follows it in ``c2m_tpu/ops/raster.py:325-330``. CUDA source:
``csrc/maskwarp.cu``. The warped stack [B, N, T, H, W] is never written: the
kernel emits the winner map [B, T, H, W] directly. A block owns a 32x8 tile
of one (b, t), stages that step's valid nodes in shared memory and visits
them last to first, each pixel stopping at its first covered node.

A CPU tensor takes :func:`warp_masks_winner_plain`; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from c2m_tpu_torch.ops import hopper

# A bilinear sample of a {0,1} mask is exactly 1 only in the interior; the
# reference tests ``warped == 1``. The gather path's eps (ops/raster.py:37).
INTERIOR_EPS = 1e-5

WARP_MASKS_WINNER = hopper.Kernel(
    "warp_masks_winner", "c2m_tpu_torch/csrc/maskwarp.cu")
KERNELS = (WARP_MASKS_WINNER,)


def warp_masks_winner_plain(instance: torch.Tensor, inst_ids: torch.Tensor,
                            valid: torch.Tensor, thetas: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch version: JAX's gather path. Each valid node's mask
    (instance == id) is warped by ``affine_grid`` + zero-padded
    ``grid_sample`` (align_corners=False); covered = warped >= 1 − eps; the
    last covered node wins (rank n+1, 0 = background).

    instance [B, H, W] f32; inst_ids [B, N]; valid [B, N] bool;
    thetas [B, N, T, 6] f32 -> winner [B, T, H, W] int32.
    """
    b, h, w = instance.shape
    t = thetas.shape[2]
    winner = torch.zeros(b, t, h, w, dtype=torch.int32, device=instance.device)
    for k in range(thetas.shape[1]):
        covered = covered_plain(instance, inst_ids, valid, thetas, k)
        winner = torch.where(covered, torch.full_like(winner, k + 1), winner)
    return winner


def covered_plain(instance: torch.Tensor, inst_ids: torch.Tensor,
                  valid: torch.Tensor, thetas: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Where node ``k``'s warped mask covers the pixel, [B, T, H, W] bool:
    the step of :func:`warp_masks_winner_plain` for one node."""
    from c2m_tpu_torch.ops.warp import affine_grid, grid_sample_normalized
    b, h, w = instance.shape
    t = thetas.shape[2]
    ids = inst_ids.to(instance.dtype)
    obj = ((instance == ids[:, k, None, None])
           & valid[:, k, None, None]).to(thetas.dtype)          # [B, H, W]
    grid = affine_grid(thetas[:, k].reshape(b, t, 2, 3), h, w)
    warped = grid_sample_normalized(
        obj[..., None], grid.reshape(b, t * h, w, 2),
        padding="zeros").reshape(b, t, h, w)
    return (warped >= 1.0 - INTERIOR_EPS) & valid[:, k, None, None, None]


def check_and_allocate(instance, inst_ids, valid, thetas):
    """Check the arguments shared by K2 and K3 (raises on what the kernels
    do not take) and return (ids as float32, valid as int32, the empty
    winner [B, T, H, W] int32)."""
    req = hopper.require
    req(instance.dim() == 3 and instance.dtype == torch.float32,
        f"instance must be float32 [B,H,W], got {instance.dtype} "
        f"{tuple(instance.shape)}")
    b, h, w = instance.shape
    req(thetas.dim() == 4 and thetas.shape[0] == b and thetas.shape[3] == 6
        and thetas.dtype == torch.float32,
        f"thetas must be float32 [{b},N,T,6], got {thetas.dtype} "
        f"{tuple(thetas.shape)}")
    n, t = thetas.shape[1:3]
    req(inst_ids.shape == (b, n), f"inst_ids must be [{b},{n}]")
    req(valid.shape == (b, n) and valid.dtype == torch.bool,
        f"valid must be bool [{b},{n}]")
    for x in (instance, inst_ids, valid, thetas):
        req(x.device == instance.device, "all inputs must be on one device")
        req(x.is_contiguous(), "inputs must be contiguous")
    ids = inst_ids.to(torch.float32).contiguous()
    valid_i = valid.to(torch.int32).contiguous()
    winner = torch.empty(b, t, h, w, dtype=torch.int32, device=instance.device)
    return ids, valid_i, winner


def _launch(instance, inst_ids, valid, thetas):
    ids, valid_i, winner = check_and_allocate(instance, inst_ids, valid,
                                              thetas)
    if winner.numel() == 0:
        return winner
    b, t, h, w = winner.shape
    hopper.require(b * t <= 65535 and h <= 65535 * 8 and h * w < 2 ** 31,
                   f"warp_masks_winner: [{b},{t},{h},{w}] exceeds the grid")
    err = hopper.library().c2m_warp_masks_winner(
        instance.data_ptr(), ids.data_ptr(), valid_i.data_ptr(),
        # the threshold as the plain version's comparison rounds it: the
        # double 1 - eps to the nearest float32
        thetas.data_ptr(), winner.data_ptr(), b, thetas.shape[1], t, h, w,
        1.0 - INTERIOR_EPS, hopper.stream_ptr(instance))
    hopper.check(err, "c2m_warp_masks_winner")
    WARP_MASKS_WINNER.launches += 1
    return winner


def warp_masks_winner(instance: torch.Tensor, inst_ids: torch.Tensor,
                      valid: torch.Tensor, thetas: torch.Tensor
                      ) -> torch.Tensor:
    """Winner node per (b, t, y, x) of the warped object masks."""
    if instance.device.type == "cpu":
        return warp_masks_winner_plain(instance, inst_ids, valid, thetas)
    if instance.device.type != "cuda":
        raise ValueError(f"warp_masks_winner: no kernel for {instance.device}")
    return _launch(instance, inst_ids, valid, thetas)
