"""Occlusion-aware frame generator, plain path (port of
``c2m_tpu/models/generator.py``).

Encodes the conditioning frame, warps the bottleneck features by the dense
flow times the occlusion map (kernel K1, masked form), runs residual blocks
and decodes to RGB. The SPADE / FlowEmbedder and KITTI branches wait for a
later port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from c2m_tpu_torch.config import GeneratorParams
from c2m_tpu_torch.nn.layers import (Conv, DownBlock2d, ResidualBlock,
                                     SameBlock2d, UpBlock2d)
from c2m_tpu_torch.ops.warp import resample, resample_masked, resize_bilinear


def deform_input(inp: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``inp`` by ``flow`` resized to inp's size WITHOUT magnitude
    rescale (reference generator.py:80-86)."""
    h, w = inp.shape[1:3]
    if flow.shape[1:3] != (h, w):
        flow = resize_bilinear(flow, (h, w), align_corners=False)
    return resample(inp.contiguous(), flow.float().contiguous())


def apply_optical(inp: torch.Tensor, flow: torch.Tensor,
                  occlusion: Optional[torch.Tensor]) -> torch.Tensor:
    """Warp + occlusion mask (reference generator.py:88-96): flow and
    occlusion are resized to inp's size first, then one masked K1 pass."""
    if occlusion is None:
        return deform_input(inp, flow)
    h, w = inp.shape[1:3]
    if flow.shape[1:3] != (h, w):
        flow = resize_bilinear(flow, (h, w), align_corners=False)
    if occlusion.shape[1:3] != (h, w):
        occlusion = resize_bilinear(occlusion, (h, w), align_corners=False)
    return resample_masked(inp.contiguous(), flow.float().contiguous(),
                           occlusion.float().contiguous())


class OcclusionAwareGenerator(nn.Module):
    def __init__(self, p: GeneratorParams, in_features: int = 3):
        super().__init__()
        if p.use_spade:
            raise NotImplementedError("the SPADE generator is not ported yet")
        self.p = p
        self.first = SameBlock2d(in_features, p.block_expansion, kernel_size=7,
                                 strides=1, padding=3,
                                 padding_mode=p.padding_mode)
        prev = p.block_expansion
        nd = p.num_down_blocks
        for i in range(nd):
            f = min(p.max_expansion, p.block_expansion * (2 ** (i + 1)))
            self.add_module(f"down_{i}", DownBlock2d(
                prev, f, 4, 2, 1, padding_mode=p.padding_mode))
            prev = f
        for i in range(p.num_bottleneck_blocks):
            self.add_module(f"middle_{i}", ResidualBlock(prev, 3, 1))
        for i in range(nd):
            f = min(p.max_expansion, p.block_expansion * (2 ** (nd - i - 1)))
            self.add_module(f"up_{i}", UpBlock2d(
                prev, f, 3, 1, 1, padding_mode=p.padding_mode))
            prev = f
        self.final = Conv(prev, 3, 7, 1, 3, "zeros")

    def forward(self, first_frame: torch.Tensor, flow: torch.Tensor,
                occlusion: torch.Tensor) -> torch.Tensor:
        """first_frame [B*, H, W, 3]; flow [B*, H, W, 2]; occlusion
        [B*, H, W, 1] -> RGB [B*, H, W, 3] in [0, 1] (float32)."""
        p = self.p
        out = self.first(first_frame)
        for i in range(p.num_down_blocks):
            out = getattr(self, f"down_{i}")(out)
        out = apply_optical(out, flow, occlusion)
        for i in range(p.num_bottleneck_blocks):
            out = getattr(self, f"middle_{i}")(out)
        for i in range(p.num_down_blocks):
            out = getattr(self, f"up_{i}")(out)
        if out.shape[1:3] != first_frame.shape[1:3]:
            out = resize_bilinear(out, first_frame.shape[1:3],
                                  align_corners=False)
        return torch.sigmoid(self.final(out).float())
