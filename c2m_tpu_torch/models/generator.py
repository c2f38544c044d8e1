"""Occlusion-aware frame generator with its SPADE and KITTI variants (port
of ``c2m_tpu/models/generator.py``).

Encodes the conditioning frame, warps the bottleneck features by the dense
flow times the occlusion map (kernel K1, masked form), runs residual
blocks and decodes to RGB. Two variants, as in the JAX package:

- SPADE (``use_spade``): no bottleneck warp; the decoder's up blocks are
  ``ResidualSpadeBlock``s conditioned on ``FlowEmbedder`` features of
  [warped image, flow, occlusion];
- KITTI (a dataset name holding ``kitti``): a second encoder of the
  warped image (``first_warped``, ``down_warped_i``) whose features, times
  the occlusion, join the bottleneck through ``pre_decode``.

Both warp the full-resolution image in float32 (K1's ``pixel`` route),
whatever dtype the conv stacks compute in. Child names are the JAX
variable tree's keys, so ``utils/convert`` carries every variant.

Spans of the SPADE path (``trace``, under a profiler only):
``c2m.model.flow_embedder`` around the embedder, ``c2m.model.spade``
around the decoder's SPADE blocks and their resizes, and
``c2m.model.spade.norm`` around each normalise-and-modulate, which counts
under ``"bytes"`` the least bytes that pass moves: x, gamma and beta read
once and the output written once.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from c2m_tpu_torch import trace
from c2m_tpu_torch.config import FlowEmbedderParams, GeneratorParams
from c2m_tpu_torch.nn.layers import (Conv, DownBlock2d, InstanceNorm,
                                     ResidualBlock, SameBlock2d, UpBlock2d,
                                     leaky)
from c2m_tpu_torch.ops.warp import (resample, resample_masked,
                                    resize_bilinear, resize_nearest)


def deform_input(inp: torch.Tensor, flow: torch.Tensor,
                 frames: int = 1) -> torch.Tensor:
    """Warp ``inp`` by ``flow`` resized to inp's size WITHOUT magnitude
    rescale (reference generator.py:80-86). With ``frames`` > 1 each row of
    ``inp`` is warped by ``frames`` flows in a row (K1's ``frames``)."""
    h, w = inp.shape[1:3]
    if flow.shape[1:3] != (h, w):
        flow = resize_bilinear(flow, (h, w), align_corners=False)
    return resample(inp.contiguous(), flow.float().contiguous(), frames)


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


def level_widths(block_expansion: int, max_expansion: int, levels: int
                 ) -> List[int]:
    """Channels at each level: min(max, expansion·2^i), i = 0..levels."""
    return [min(max_expansion, block_expansion * (2 ** i))
            for i in range(levels + 1)]


class FlowEmbedder(nn.Module):
    """U-net embedding of [warped image, flow, occlusion] into multiscale
    SPADE conditions (flowembedder.py:9-81). Returns nd + 1 maps, the
    finest first; map i has ``level_widths(...)[i]`` channels at 1/2^i of
    the input's size.

    With the decoder, map 0 (``up_0``, at full size) conditions no SPADE
    block: the generator reads maps nd..1. Eval mode skips it and returns
    None in its place; train mode runs it for its BatchNorm running
    statistics, which the JAX package's train step moves too."""

    def __init__(self, p: FlowEmbedderParams, in_features: int):
        super().__init__()
        self.p = p
        ch = level_widths(p.block_expansion, p.max_expansion,
                          p.num_down_blocks)
        self.first = SameBlock2d(in_features, p.block_expansion, 3, 1, 1,
                                 padding_mode=p.padding_mode, use_norm=False)
        for i in range(p.num_down_blocks):
            self.add_module(f"down_{i}", DownBlock2d(
                ch[i] if i else p.block_expansion, ch[i + 1], 4, 2, 1,
                padding_mode=p.padding_mode))
        if p.use_decoder:
            for i in reversed(range(p.num_down_blocks)):
                # the deepest up block reads the bottleneck alone, the
                # others the previous up block's output beside the skip
                inp = ch[i + 1] * (1 if i == p.num_down_blocks - 1 else 2)
                self.add_module(f"up_{i}", UpBlock2d(
                    inp, ch[i], 3, 1, 1, padding_mode=p.padding_mode))

    def forward(self, x: torch.Tensor) -> List[Optional[torch.Tensor]]:
        p = self.p
        nd = p.num_down_blocks
        outputs = [self.first(x)]
        for i in range(nd):
            outputs.append(getattr(self, f"down_{i}")(outputs[-1]))
        if not p.use_decoder:
            return outputs
        for i in reversed(range(nd)):
            if i == 0 and not self.training:
                outputs.append(None)
                break
            inp = outputs[-1]
            if i != nd - 1:
                skip = outputs[i + 1]
                inp = resize_bilinear(inp, skip.shape[1:3],
                                      align_corners=False)
                inp = torch.cat([inp, skip], dim=-1)
            outputs.append(getattr(self, f"up_{i}")(inp))
        return outputs[nd:][::-1]


class SpatiallyAdaptiveNorm(nn.Module):
    """SPADE (spade_block.py:7-77): instance norm without affine, then
    (1 + gamma)·x + beta with gamma, beta = the first and second half of
    ``gamma_beta``'s channels, convolved from the condition (resized to
    x's size by nearest where the sizes differ)."""
    JAX_NAMES = {"norm": None}          # no parameters, no level in the tree

    def __init__(self, features: int, cond_features: int,
                 num_filters: int = 128, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.norm = InstanceNorm(features, affine=False)
        self.mlp = SameBlock2d(cond_features, num_filters, kernel_size, 1,
                               pad, padding_mode="reflect", use_norm=False)
        self.gamma_beta = Conv(num_filters, 2 * features, kernel_size, 1, pad,
                               "reflect")

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        # the condition's convolutions first, so that the span holds the
        # bandwidth-bound normalise-and-modulate alone (the same values as
        # normalising first: neither reads the other's result)
        if cond.shape[1:3] != x.shape[1:3]:
            cond = resize_nearest(cond, x.shape[1:3])
        gamma, beta = self.gamma_beta(self.mlp(cond)).chunk(2, dim=-1)
        with trace.span("c2m.model.spade.norm"):
            out = self.norm(x) * (1.0 + gamma) + beta
            trace.count("bytes", sum(t.numel() * t.element_size()
                                     for t in (x, gamma, beta, out)))
        return out


class ResidualSpadeBlock(nn.Module):
    """SPADE residual up block (residual_block.py:34-71): two
    norm -> leaky -> conv stages; where the width changes, a bias-free 1x1
    shortcut of the normed input is added (``norm_s``, ``conv_s``). At an
    unchanged width the JAX package returns the two stages alone."""

    def __init__(self, in_features: int, features: int, cond_features: int,
                 kernel_size: int = 3):
        super().__init__()
        self.norm1 = SpatiallyAdaptiveNorm(in_features, cond_features)
        self.conv1 = Conv(in_features, features, kernel_size, 1, 1, "reflect")
        self.norm2 = SpatiallyAdaptiveNorm(features, cond_features)
        self.conv2 = Conv(features, features, kernel_size, 1, 1, "reflect")
        if in_features != features:
            self.norm_s = SpatiallyAdaptiveNorm(in_features, cond_features)
            self.conv_s = Conv(in_features, features, 1, 1, 0, "zeros",
                               use_bias=False)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        dx = self.conv1(leaky(self.norm1(x, cond)))
        dx = self.conv2(leaky(self.norm2(dx, cond)))
        if hasattr(self, "conv_s"):
            return dx + self.conv_s(leaky(self.norm_s(x, cond)))
        return dx


class OcclusionAwareGenerator(nn.Module):
    def __init__(self, p: GeneratorParams,
                 flow_params: Optional[FlowEmbedderParams] = None,
                 dataset: str = "cityscapes", in_features: int = 3):
        super().__init__()
        self.p = p
        self.kitti = "kitti" in dataset
        nd = p.num_down_blocks
        ch = level_widths(p.block_expansion, p.max_expansion, nd)
        if p.use_spade:
            fp = flow_params or FlowEmbedderParams()
            # [warped image, flow, occlusion]
            self.flowembedder = FlowEmbedder(fp, in_features + 2 + 1)
            cond = level_widths(fp.block_expansion, fp.max_expansion,
                                fp.num_down_blocks)
        self.first = SameBlock2d(in_features, p.block_expansion, kernel_size=7,
                                 strides=1, padding=3,
                                 padding_mode=p.padding_mode)
        for i in range(nd):
            self.add_module(f"down_{i}", DownBlock2d(
                ch[i] if i else p.block_expansion, ch[i + 1], 4, 2, 1,
                padding_mode=p.padding_mode))
        prev = ch[nd] if nd else p.block_expansion
        for i in range(p.num_bottleneck_blocks):
            self.add_module(f"middle_{i}", ResidualBlock(prev, 3, 1))
        if self.kitti:
            self.first_warped = SameBlock2d(in_features, p.block_expansion, 7,
                                            1, 3, padding_mode=p.padding_mode)
            for i in range(nd):
                self.add_module(f"down_warped_{i}", DownBlock2d(
                    ch[i] if i else p.block_expansion, ch[i + 1], 4, 2, 1,
                    padding_mode=p.padding_mode))
            warped = ch[nd] if nd else p.block_expansion
            self.pre_decode = SameBlock2d(prev + warped, warped, 3, 1, 1,
                                          padding_mode=p.padding_mode)
            prev = warped
        for i in range(nd):
            f = ch[nd - i - 1]
            if p.use_spade:
                c = cond[min(nd - i, len(cond) - 1)]
                self.add_module(f"up_{i}", ResidualSpadeBlock(prev, f, c))
            else:
                self.add_module(f"up_{i}", UpBlock2d(
                    prev, f, 3, 1, 1, padding_mode=p.padding_mode))
            prev = f
        self.final = Conv(prev, 3, 7, 1, 3, "zeros")

    def forward(self, first_frame: torch.Tensor, flow: torch.Tensor,
                occlusion: torch.Tensor, frames: int = 1) -> torch.Tensor:
        """first_frame [B*, H, W, 3]; flow [B*, H, W, 2]; occlusion
        [B*, H, W, 1] -> RGB [B*, H, W, 3] in [0, 1] (float32).
        ``frames``: first_frame holds each image ``frames`` times in a row
        (the time-folded source frame); the image warp then reads each image
        once, bit for bit the warp of the copies."""
        p = self.p
        nd = p.num_down_blocks
        img_warp = None
        if p.use_spade or self.kitti:
            # the full-resolution image in its own dtype (float32), as the
            # JAX package warps it under bfloat16 conv stacks
            img_warp = deform_input(first_frame[::frames], flow, frames)
        if p.use_spade:
            with trace.span("c2m.model.flow_embedder"):
                cond = self.flowembedder(torch.cat(
                    [img_warp, flow.to(img_warp.dtype),
                     occlusion.to(img_warp.dtype)], dim=-1))

        out = self.first(first_frame)
        for i in range(nd):
            out = getattr(self, f"down_{i}")(out)
        if not p.use_spade:
            out = apply_optical(out, flow, occlusion)
        for i in range(p.num_bottleneck_blocks):
            out = getattr(self, f"middle_{i}")(out)

        if self.kitti:
            xw = self.first_warped(img_warp)
            for i in range(nd):
                xw = getattr(self, f"down_warped_{i}")(xw)
            # a plain product with the occlusion resized to the features'
            # size, not a masked warp
            occ = resize_bilinear(occlusion, xw.shape[1:3],
                                  align_corners=False)
            out = self.pre_decode(torch.cat([out, xw * occ], dim=-1))

        if p.use_spade:
            with trace.span("c2m.model.spade"):
                for i in range(nd):
                    c = cond[min(nd - i, len(cond) - 1)]
                    out = resize_bilinear(out, c.shape[1:3],
                                          align_corners=False)
                    out = getattr(self, f"up_{i}")(out, c)
                    h, w = out.shape[1:3]
                    out = resize_bilinear(out, (h * 2, w * 2),
                                          align_corners=False)
        else:
            for i in range(nd):
                out = getattr(self, f"up_{i}")(out)
        out = resize_bilinear(out, first_frame.shape[1:3], align_corners=False)
        return torch.sigmoid(self.final(out).float())
