"""Kernel K5: the FlowNetC correlation cost volume, no gradient (FlowNet2 is
frozen and runs forward only; the JAX package has no backward either).

Replaces the Pallas kernel ``correlation_pallas`` / ``_corr_kernel`` in
``c2m_tpu/ops/pallas/correlation_kernel.py``. CUDA source:
``csrc/correlation.cu``.

A CPU tensor takes :func:`correlation_plain`; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from c2m_tpu_torch.ops import hopper

CORRELATION = hopper.Kernel("correlation", "c2m_tpu_torch/csrc/correlation.cu")
KERNELS = (CORRELATION,)

_INT32_MAX = 2 ** 31 - 1


def _tiles_per_row(md: int, stride: int) -> int:
    """Threads csrc/correlation.cu gives one displacement row of a block:
    a tile of 4 pixels by 21 displacements each, over a run of 16 * stride
    pixels. A block has at most 256 threads."""
    d = 2 * (md // stride) + 1
    return 4 * stride * -(-d // 21)


def correlation_plain(a: torch.Tensor, b: torch.Tensor,
                      max_displacement: int = 20, stride: int = 2
                      ) -> torch.Tensor:
    """Plain PyTorch version, the loop of ``c2m_tpu/ops/correlation.py``:
    pad ``b`` with zeros, slice per displacement (dy outer, dx fastest),
    channel mean of the product in float32. a, b [B, H, W, C] ->
    [B, H, W, D*D] float32 with D = 2 * (md // stride) + 1."""
    _, h, w, _ = a.shape
    md = max_displacement
    a = a.float()
    padded = F.pad(b.float(), (0, 0, md, md, md, md))
    outs = []
    for dy in range(-md, md + 1, stride):
        for dx in range(-md, md + 1, stride):
            shifted = padded[:, md + dy:md + dy + h, md + dx:md + dx + w, :]
            outs.append((a * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def _launch(a: torch.Tensor, b: torch.Tensor, md: int, stride: int
            ) -> torch.Tensor:
    req = hopper.require
    req(a.dim() == 4 and a.shape == b.shape,
        f"a, b must be [B,H,W,C] of one shape, got {tuple(a.shape)} and "
        f"{tuple(b.shape)}")
    req(a.dtype == b.dtype and a.dtype in (torch.float32, torch.bfloat16),
        f"a, b must both be float32 or bfloat16, got {a.dtype}, {b.dtype}")
    req(a.device == b.device, "a and b must be on one device")
    req(a.is_contiguous() and b.is_contiguous(), "a, b must be contiguous")
    bsz, h, w, c = a.shape
    d = 2 * (md // stride) + 1
    out = torch.empty(bsz, h, w, d * d, dtype=torch.float32, device=a.device)
    if out.numel() == 0 or c == 0:
        return out.zero_()
    req(_tiles_per_row(md, stride) <= 256,
        f"max_displacement {md} at stride {stride} needs more than a block's "
        f"256 threads")
    req(bsz <= 65535 and h <= 65535 and w * d * d <= _INT32_MAX,
        "map too large for the kernel's grid and 32-bit offsets")
    fn = (hopper.library().c2m_correlation_f32 if a.dtype == torch.float32
          else hopper.library().c2m_correlation_bf16)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, w, c, md,
             stride, hopper.stream_ptr(a))
    hopper.check(err, "c2m_correlation")
    CORRELATION.launches += 1
    return out


def correlation(a: torch.Tensor, b: torch.Tensor, max_displacement: int = 20,
                stride: int = 2) -> torch.Tensor:
    """Cost volume of a against b over the strided displacement grid:
    a, b [B, H, W, C] -> [B, H, W, D*D] float32."""
    if max_displacement < 0 or stride < 1 or max_displacement % stride:
        raise ValueError(f"max_displacement {max_displacement} must be a "
                         f"non-negative multiple of stride {stride}")
    if a.device.type == "cpu":
        return correlation_plain(a, b, max_displacement, stride)
    if a.device.type != "cuda":
        raise ValueError(f"correlation: no kernel for {a.device}")
    return _launch(a, b, max_displacement, stride)
