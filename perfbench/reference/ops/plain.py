# Frozen copies of the plain PyTorch versions of kernels K1, K2/K3 and K4
# from c2m_tpu_torch/ops/hopper/{warp_kernels,maskwarp_kernel,splat_kernel}.py
# at commit ef9a2dc. The reference runs these on every device: it launches
# no hand-written kernel.
"""Plain versions of the port's hand-written kernels.

K1 ``resample`` / ``resample_masked``: bilinear backward warp (+ x mask),
differentiated by autograd. K2 and K3 ``warp_masks_winner_plain``: the
affine mask warp with winner-takes-last composition (K3 computes the same
function as K2 on larger maps). K4 ``corresponding_map``: the forward
bilinear splat.
"""

from __future__ import annotations

from typing import Optional

import torch

# A bilinear sample of a {0,1} mask is exactly 1 only in the interior; the
# reference tests ``warped == 1``. The gather path's eps (ops/raster.py:37).
INTERIOR_EPS = 1e-5


def resample_plain(image: torch.Tensor, flow: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   frames: int = 1) -> torch.Tensor:
    """The JAX ``_resample_jnp`` math in float32, times ``mask`` when
    given, rounded once to the image dtype. With ``frames`` > 1 each image
    row is repeated ``frames`` times first."""
    from perfbench.reference.ops.warp import bilinear_sample
    if frames != 1:
        image = image.repeat_interleave(frames, dim=0)
    _, h, w, _ = image.shape
    xs = torch.arange(w, dtype=torch.float32, device=image.device)
    ys = torch.arange(h, dtype=torch.float32, device=image.device)
    # degenerate 1-wide axes are guarded as in the reference port
    wf = w / max(w - 1.0, 1e-6)
    hf = h / max(h - 1.0, 1e-6)
    sx = (xs[None, None, :] + flow[..., 0].float()) * wf - 0.5
    sy = (ys[None, :, None] + flow[..., 1].float()) * hf - 0.5
    out = bilinear_sample(image.float(), sx, sy, padding="border")
    if mask is not None:
        out = out * mask.float()
    return out.to(image.dtype)


def resample(image: torch.Tensor, flow: torch.Tensor,
             frames: int = 1) -> torch.Tensor:
    """image [B,H,W,C], flow [B*frames,H,W,2] -> warped [B*frames,H,W,C]."""
    return resample_plain(image, flow, None, frames)


def resample_masked(image: torch.Tensor, flow: torch.Tensor,
                    mask: torch.Tensor, frames: int = 1) -> torch.Tensor:
    """``resample(image, flow, frames) * mask``."""
    return resample_plain(image, flow, mask, frames)


def warp_masks_winner_plain(instance: torch.Tensor, inst_ids: torch.Tensor,
                            valid: torch.Tensor, thetas: torch.Tensor
                            ) -> torch.Tensor:
    """JAX's gather path. Each valid node's mask (instance == id) is warped
    by ``affine_grid`` + zero-padded ``grid_sample`` (align_corners=False);
    covered = warped >= 1 - eps; the last covered node wins (rank n+1,
    0 = background).

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
    """Where node ``k``'s warped mask covers the pixel, [B, T, H, W] bool."""
    from perfbench.reference.ops.warp import affine_grid, grid_sample_normalized
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


def corresponding_map(coords: torch.Tensor) -> torch.Tensor:
    """The reference's ``get_corresponding_map``: every point adds unit
    mass to its 4 grid neighbours with bilinear weights; corners outside
    the image get weight 0. coords [B, H, W, 2] (x, y) pixels -> mass
    [B, H, W, 1]."""
    b, h, w, _ = coords.shape
    x = coords[..., 0].reshape(b, -1)
    y = coords[..., 1].reshape(b, -1)
    x_f = torch.floor(x)
    y_f = torch.floor(y)
    x_c = x_f + 1.0
    y_c = y_f + 1.0
    idx, val = [], []
    # corner order as the JAX scatter, so the summation order matches too
    for cx, cy in ((x_c, y_c), (x_c, y_f), (x_f, y_c), (x_f, y_f)):
        cxc = cx.clamp(0.0, w - 1.0)
        cyc = cy.clamp(0.0, h - 1.0)
        invalid = (cx != cxc) | (cy != cyc)
        wgt = (1.0 - (x - cxc).abs()) * (1.0 - (y - cyc).abs())
        val.append(torch.where(invalid, torch.zeros_like(wgt), wgt))
        # an invalid corner adds 0 at pixel 0 (a NaN coordinate has no index)
        idx.append(torch.where(invalid, torch.zeros_like(cxc),
                               cxc + cyc * w).long())
    idx = torch.cat(idx, dim=1)
    val = torch.cat(val, dim=1)
    out = torch.zeros(b, h * w, dtype=coords.dtype, device=coords.device)
    out.scatter_add_(1, idx, val)
    return out.reshape(b, h, w, 1)
