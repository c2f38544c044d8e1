# Frozen copy of c2m_tpu_torch/ops/roi.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""ROI-align as bilinear crop-and-pool (port of ``c2m_tpu/ops/roi.py``).

Written by hand, not torchvision's: a fixed 2x2 sample grid per bin,
zero padding, aligned=False coordinates, roi size clamped to >= 1 — the
JAX package's semantics (see that file for the reference's box quirk).
Boxes are (x1, y1, x2, y2) in input-image pixels.
"""

from __future__ import annotations

import torch

from perfbench.reference.ops.warp import bilinear_sample

SAMPLING_RATIO = 2


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float) -> torch.Tensor:
    """features [B, H, W, C]; boxes [B, N, 4] -> [B, N, out, out, C]."""
    b, _, _, c = features.shape
    n = boxes.shape[1]
    s = SAMPLING_RATIO
    out = output_size
    x1 = boxes[..., 0] * spatial_scale
    y1 = boxes[..., 1] * spatial_scale
    x2 = boxes[..., 2] * spatial_scale
    y2 = boxes[..., 3] * spatial_scale
    bin_w = (x2 - x1).clamp_min(1.0) / out
    bin_h = (y2 - y1).clamp_min(1.0) / out
    # sample k of bin i sits at x1 + (i + (k + 0.5)/s) * bin_w
    grid = (torch.arange(out * s, dtype=torch.float32,
                         device=features.device) + 0.5) / s
    sx = x1[..., None] + grid * bin_w[..., None]                # [B, N, out*s]
    sy = y1[..., None] + grid * bin_h[..., None]
    m = out * s
    xx = sx[:, :, None, :].expand(b, n, m, m)
    yy = sy[:, :, :, None].expand(b, n, m, m)
    sampled = bilinear_sample(features, xx, yy, padding="zeros")
    return sampled.reshape(b, n, out, s, out, s, c).mean(dim=(3, 5))
