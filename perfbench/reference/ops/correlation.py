"""The FlowNetC cost volume and the channel norm in plain PyTorch, written
from flownet2-pytorch's ``networks/correlation_package`` and
``networks/channelnorm_package`` (NVIDIA, the CUDA extensions FlowNet2
builds), independently of the port's kernel K5.

Layout NCHW, as upstream. FlowNetC builds ``Correlation(pad_size=20,
kernel_size=1, max_displacement=20, stride1=1, stride2=2)``: for every pixel
x and every displacement d on the grid {-20, -18, ..., 20}^2, the sum over
channels of a(x) * b(x + d), divided by the channel count (kernel 1x1, so
``sumelems`` is C), zero where x + d leaves the image; output channel
(dy + 20) / 2 * 21 + (dx + 20) / 2, so dy outer and dx fastest.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def correlation(a: torch.Tensor, b: torch.Tensor, max_displacement: int = 20,
                stride: int = 2) -> torch.Tensor:
    """a, b [B, C, H, W] -> [B, D*D, H, W] float32, D = 2 * (md // stride) + 1:
    one channel mean of a times the shifted, zero-padded b a displacement."""
    _, c, h, w = a.shape
    md = max_displacement
    a = a.float()
    padded = F.pad(b.float(), (md, md, md, md))
    out = []
    for dy in range(-md, md + 1, stride):
        for dx in range(-md, md + 1, stride):
            shifted = padded[:, :, md + dy:md + dy + h, md + dx:md + dx + w]
            out.append((a * shifted).sum(dim=1) / c)
    return torch.stack(out, dim=1)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 norm over the channels: [B, C, H, W] -> [B, 1, H, W]."""
    return torch.sqrt((x * x).sum(dim=1, keepdim=True))
