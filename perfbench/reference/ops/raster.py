# Frozen copy of c2m_tpu_torch/ops/raster.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Sparse-motion rasterization over padded object nodes (gather form).

Port of ``c2m_tpu/ops/raster.py``. One gather-form path serves both GT and
GNN thetas on the GPU: a kernel warps every object mask by its affine and
composes the winner map (last covered node wins, as the reference's
overwrite order): K2 up to the map size at which the JAX package leaves its
quadratic kernel, the windowed K3 above it (:func:`banded`). ``torch.gather``
picks the winning theta per pixel and its affine flow is evaluated
pointwise, and the occlusion maps are forward splats (kernel K4) of the
other direction's flow. The separable and scan
variants of the JAX package were TPU rewrites of the same math and are not
ported.

Everything here is off the autodiff path (the reference detaches it).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.ops import splat
from perfbench.reference.ops.plain import warp_masks_winner_plain
from perfbench.reference.ops.warp import pointwise_affine_flow


# b·n·t·(h·w)² above which the mask warp leaves K2 for K3: the JAX package's
# own gate (c2m_tpu/ops/raster.py:288-289). Every 128x256 path stays below
# it (1.03e12 at batch 12, 16 nodes, 5 frames); one 512x1024 clip of 24 nodes
# and 10 frames is at 6.6e13.
BANDED_ABOVE = 2e12


def banded(b: int, n: int, t: int, h: int, w: int) -> bool:
    """Whether a mask warp of this shape takes K3 (else K2)."""
    return b * n * t * (h * w) ** 2 > BANDED_ABOVE


def _winning_theta(thetas_btn: torch.Tensor, winner: torch.Tensor
                   ) -> torch.Tensor:
    """thetas [B, T, N, 6], winner [B, T, H, W] (0 = none) -> [B, T, H, W, 6]."""
    b, t, h, w = winner.shape
    idx = (winner.long() - 1).clamp_min(0).reshape(b, t, h * w, 1)
    picked = torch.gather(thetas_btn, 2, idx.expand(b, t, h * w, 6))
    return picked.reshape(b, t, h, w, 6)


@torch.no_grad()
def generate_sparse_motion(instance: torch.Tensor, inst_ids: torch.Tensor,
                           node_mask: torch.Tensor, thetas: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """Rasterize per-object affine motions into sparse flow fields.

    instance [B, H, W, 1] float instance ids (last input frame); inst_ids
    [B, N] int (0 = skip); node_mask [B, N] bool; thetas [B, N, T, 6] f32
    rows of the 2x3 affines. Returns ``sparse_motion_bw``/``_fw``
    [B, T, H, W, 2], ``sparse_motion_bin``, ``sparse_occ_bw``/``_fw``
    [B, T, H, W, 1] and ``winner_bw`` [B, T, H, W] int32.
    """
    b, h, w, _ = instance.shape
    n, t = thetas.shape[1:3]
    thetas = thetas.float().contiguous()
    node_mask = node_mask.bool()
    valid = node_mask & (inst_ids != 0)

    # the plain winner for every size: K2 and K3 compute this one function
    winner_bw = warp_masks_winner_plain(
        instance[..., 0].contiguous(), inst_ids.contiguous(),
        valid.contiguous(), thetas)                              # [B, T, H, W]
    theta_btn = thetas.permute(0, 2, 1, 3).contiguous()          # [B, T, N, 6]
    flow_all = pointwise_affine_flow(_winning_theta(theta_btn, winner_bw), h, w)
    has_bw = (winner_bw > 0)[..., None]
    zero = torch.zeros((), dtype=flow_all.dtype, device=flow_all.device)
    sparse_bw = torch.where(has_bw, flow_all, zero)
    sparse_bin = has_bw.to(thetas.dtype)

    # Forward: the flow sits at the unwarped object mask, negated
    # (dense_motion.py:139-140); the winner over static masks is t-independent.
    ids = inst_ids.to(instance.dtype)
    obj = (instance[:, None, :, :, 0] == ids[:, :, None, None]) \
        & valid[:, :, None, None]                                # [B, N, H, W]
    ranks = torch.arange(1, n + 1, dtype=torch.int32, device=instance.device)
    winner_fw = torch.where(obj, ranks[None, :, None, None],
                            torch.zeros((), dtype=torch.int32,
                                        device=instance.device)).amax(dim=1)
    theta_fw = _winning_theta(
        theta_btn, winner_fw[:, None].expand(b, t, h, w))
    flow_fw_all = pointwise_affine_flow(theta_fw, h, w)
    has_fw = (winner_fw > 0)[:, None, :, :, None]
    sparse_fw = torch.where(has_fw, -flow_fw_all, zero)

    # Occlusion by forward splat of the other direction's flow
    # (dense_motion.py:147-152), binarized at 0.5.
    occ_bw = splat.clip_mask(splat.occlusion_map(
        sparse_fw.reshape(b * t, h, w, 2))).reshape(b, t, h, w, 1)
    occ_fw = splat.clip_mask(splat.occlusion_map(
        sparse_bw.reshape(b * t, h, w, 2))).reshape(b, t, h, w, 1)

    return {
        "sparse_motion_bw": sparse_bw,
        "sparse_motion_fw": sparse_fw,
        "sparse_motion_bin": sparse_bin,
        "sparse_occ_bw": occ_bw,
        "sparse_occ_fw": occ_fw,
        "winner_bw": winner_bw,
    }
