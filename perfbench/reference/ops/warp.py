# Frozen copy of c2m_tpu_torch/ops/warp.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Flow warping, bilinear sampling, affine grids and torch-parity resizes.

Port of ``c2m_tpu/ops/warp.py``. Layout is channels-last, as there:
images ``[B, H, W, C]``, flows ``[B, H, W, 2]`` with ``(fx, fy)`` in pixels.

Four sampling conventions stay as the reference has them (they are
load-bearing parity, not accidents):
- ``resample``: sx = (x + fx)·W/(W−1) − 0.5, border clamp (the hand-written
  kernel K1 behind ``ops/hopper/warp_kernels.py``);
- ``resample_pixel``: sx = x + fx, border clamp (FlowNet2's resample2d);
- ``affine_grid`` + ``grid_sample_normalized``: align_corners=False with
  zeros padding (the mask warp, kernel K2);
- ``affine_flow``: the affine grid minus an align_corners=True base.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

# Backward-warp an image [B, H, W, C] by a pixel flow [B, H, W, 2], plain or
# times a mask [B, H, W, 1] in one pass (reference ``utils.ops.resample``):
# kernel K1 on CUDA, its plain version on the CPU. Inputs must be contiguous.
from perfbench.reference.ops.plain import (  # noqa: F401
    resample, resample_masked)


def linspace_pm1(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` bit for bit (float32): -(1 − s) + s with
    s = i/(n−1), endpoint exactly 1. ``torch.linspace`` rounds differently
    in the last bit, which the pixel flows scale by (n−1)/2."""
    if n == 1:
        return -torch.ones(1, device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    out = -(1.0 - s) + s
    return torch.cat([out, torch.ones(1, device=device)])


def acf_base(n: int, device=None) -> torch.Tensor:
    """align_corners=False base coords (2i + 1)/n − 1."""
    return (2.0 * torch.arange(n, dtype=torch.float32, device=device)
            + 1.0) / n - 1.0


def bilinear_sample(image: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                    padding: str = "border") -> torch.Tensor:
    """Bilinear sample at pixel coordinates, batched.

    image: [B, H, W, C]; sx, sy: [B, *S] float pixel coords -> [B, *S, C].
    'border' clamps the coordinates; 'zeros' gives 0 to corners outside the
    image. Same arithmetic, term for term, as the JAX ``bilinear_sample``.
    """
    b, h, w, c = image.shape
    lead = sx.shape
    if padding == "border":
        sx = sx.clamp(0.0, w - 1.0)
        sy = sy.clamp(0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0).reshape(b, -1, 1).to(image.dtype)
    wy = (sy - y0).reshape(b, -1, 1).to(image.dtype)
    x0i = x0.long().reshape(b, -1)
    y0i = y0.long().reshape(b, -1)
    x1i = x0i + 1
    y1i = y0i + 1
    flat = image.reshape(b, h * w, c)
    rows = torch.arange(b, device=image.device)[:, None]

    def tap(yi, xi):
        v = flat[rows, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        if padding == "zeros":
            ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            v = torch.where(ok[..., None], v, torch.zeros((), dtype=v.dtype,
                                                          device=v.device))
        return v

    v00, v10 = tap(y0i, x0i), tap(y0i, x1i)
    v01, v11 = tap(y1i, x0i), tap(y1i, x1i)
    top = v00 * (1.0 - wx) + v10 * wx
    bot = v01 * (1.0 - wx) + v11 * wx
    return (top * (1.0 - wy) + bot * wy).reshape(*lead, c)


def resample_pixel(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Pixel-space backward warp (FlowNet2's resample2d): source coords are
    plainly (x + fx, y + fy), clamped to the border. Another convention than
    ``resample`` (kernel K1), and plain PyTorch as it is plain jnp in the
    JAX package. image [B, H, W, C]; flow [B, H, W, 2] pixels."""
    _, h, w, _ = image.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
    return bilinear_sample(image, xs[None, :] + flow[..., 0],
                           ys[:, None] + flow[..., 1], padding="border")


def affine_grid(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """torch ``F.affine_grid(theta, align_corners=False)`` on [..., 2, 3]
    thetas -> grid [..., h, w, 2] of normalized (gx, gy)."""
    bx = acf_base(w, theta.device)[None, :]
    by = acf_base(h, theta.device)[:, None]
    t = theta[..., None, None]            # [..., 2, 3, 1, 1]
    gx = t[..., 0, 0, :, :] * bx + t[..., 0, 1, :, :] * by + t[..., 0, 2, :, :]
    gy = t[..., 1, 0, :, :] * bx + t[..., 1, 1, :, :] * by + t[..., 1, 2, :, :]
    return torch.stack([gx, gy], dim=-1)


def grid_sample_normalized(image: torch.Tensor, grid: torch.Tensor,
                           padding: str = "zeros") -> torch.Tensor:
    """torch ``F.grid_sample(image, grid, align_corners=False)``, channels-last:
    image [B, H, W, C]; grid [B, H', W', 2] -> [B, H', W', C]."""
    _, h, w, _ = image.shape
    sx = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    sy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    return bilinear_sample(image, sx, sy, padding=padding)


def pointwise_affine_flow(theta6: torch.Tensor, h: int, w: int
                          ) -> torch.Tensor:
    """Pixel flow from affine rows that may differ per pixel: theta6
    [..., H, W, 6] (or broadcastable to it) -> [..., H, W, 2]. The grid of
    ``affine_grid`` minus the align_corners=True base, scaled by (size−1)/2."""
    dev = theta6.device
    bx = acf_base(w, dev)[None, :]
    by = acf_base(h, dev)[:, None]
    gx = theta6[..., 0] * bx + theta6[..., 1] * by + theta6[..., 2]
    gy = theta6[..., 3] * bx + theta6[..., 4] * by + theta6[..., 5]
    fx = (gx - linspace_pm1(w, dev)[None, :]) * ((w - 1.0) / 2.0)
    fy = (gy - linspace_pm1(h, dev)[:, None]) * ((h - 1.0) / 2.0)
    return torch.stack([fx, fy], dim=-1)


def affine_flow(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel flow of one affine: theta [..., 2, 3] -> [..., h, w, 2]."""
    return pointwise_affine_flow(
        theta.reshape(*theta.shape[:-2], 1, 1, 6), h, w)


# -- torch-parity resizes (reference utils.py:346-372) ------------------------

def _interpolate(x: torch.Tensor, size: Sequence[int], **kw) -> torch.Tensor:
    """F.interpolate on a channels-last [..., H, W, C] tensor."""
    *lead, h, w, c = x.shape
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=tuple(int(s) for s in size), **kw)
    return out.permute(0, 2, 3, 1).reshape(*lead, *out.shape[2:], c)


def resize_bilinear(x: torch.Tensor, size: Sequence[int],
                    align_corners: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear')`` on [..., H, W, C]; the source
    coordinate clamp at 0 (JAX ``_bilinear_axis_weights``) is F.interpolate's
    own."""
    if tuple(size) == tuple(x.shape[-3:-1]):
        return x
    return _interpolate(x, size, mode="bilinear", align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')``: src = floor(dst · in/out)."""
    if tuple(size) == tuple(x.shape[-3:-1]):
        return x
    return _interpolate(x, size, mode="nearest")


def resize_flow(flow: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """align_corners=True bilinear resize plus magnitude rescale."""
    h, w = flow.shape[-3], flow.shape[-2]
    nh, nw = size
    out = resize_bilinear(flow, size, align_corners=True)
    scale = torch.tensor([nw / float(w), nh / float(h)], dtype=flow.dtype,
                         device=flow.device)
    return out * scale


def resize_video(video: Optional[torch.Tensor], size: Sequence[int],
                 mode: str = "bilinear", is_flow: bool = False
                 ) -> Optional[torch.Tensor]:
    """Frame-wise resize of [..., T, H, W, C]."""
    if video is None:
        return None
    if is_flow:
        return resize_flow(video, size)
    if mode == "bilinear":
        return resize_bilinear(video, size, align_corners=False)
    if mode == "nearest":
        return resize_nearest(video, size)
    raise ValueError(f"unknown resize mode {mode}")
