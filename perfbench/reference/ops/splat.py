# Frozen copy of c2m_tpu_torch/ops/splat.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Forward-splat occlusion maps (port of ``c2m_tpu/ops/splat.py``).

The splat itself is kernel K4 (``ops/hopper/splat_kernel.py``); this module
adds the base grid, the clip to [0, 1] and the binarization.
"""

from __future__ import annotations

import torch

# Splat unit mass at target coords [B, H, W, 2] -> mass [B, H, W, 1].
from perfbench.reference.ops.plain import corresponding_map


def occlusion_map(flow: torch.Tensor) -> torch.Tensor:
    """Soft visibility from a flow [B, H, W, 2] (pixels) -> [B, H, W, 1] in
    [0, 1], 0 = occluded (reference ops.py:263-275). No gradient."""
    flow = flow.detach()
    _, h, w, _ = flow.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
    base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1)
    coords = (base[None] + flow).contiguous()
    return corresponding_map(coords).clamp(0.0, 1.0)


def clip_mask(mask: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Binarize a soft mask (reference dense_motion.py:155-159)."""
    return (mask > threshold).to(mask.dtype)
