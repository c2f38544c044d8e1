"""The patch gather of a channels-last convolution (im2col), for the float32
convolutions that ``nn/layers.patch_conv`` computes as one cuBLAS GEMM.

Replaces no TPU kernel: it takes over convolutions that the JAX package
left to XLA and the port to cuDNN (``csrc/patches.cu`` says why and what
bounds it). CUDA source: ``csrc/patches.cu``.

Rows ``[row0, row0 + rows)`` of the patch matrix of ``x`` [B, H, W, C]
(2D) or [B, T, H, W, C] (3D): a row per output pixel, counted over the
batch and the output's spatial axes in order, holding for each tap of the
kernel, in the weight's spatial order, the C channels of the input pixel
that tap reads, so K = taps x C and column k = tap * C + c. Each axis is
padded by ``pad`` on both sides by ``layers.pad_spatial``'s rule: zeros,
replicate, or reflect falling back to edge on an axis no longer than its
pad.

A CPU tensor takes :func:`conv_patches_plain`; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from c2m_tpu_torch.ops import hopper

CONV_PATCHES = hopper.Kernel(
    "conv_patches", "c2m_tpu_torch/csrc/patches.cu",
    "none: the convolutions the JAX package leaves to XLA")
KERNELS = (CONV_PATCHES,)

# an axis's padding as csrc/patches.cu numbers it
AXIS_MODES = {"zeros": 0, "edge": 1, "reflect": 2}
_INT32 = 2 ** 31 - 1


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    """Output length of a conv axis of input length n."""
    return (n + 2 * pad - k) // stride + 1


def axis_modes(spatial: Sequence[int], pads: Sequence[int],
               mode: str) -> tuple:
    """Each spatial axis's padding as the kernel takes it: ``zeros``,
    ``edge`` (replicate, and reflect on an axis of length <= its pad, as
    ``pad_spatial`` falls back) or ``reflect``."""
    if mode not in ("zeros", "reflect", "replicate"):
        raise ValueError(f"unknown padding mode {mode}")
    return tuple(
        "zeros" if mode == "zeros" else
        "reflect" if mode == "reflect" and n > p else "edge"
        for n, p in zip(spatial, pads))


def source_index(n: int, out: int, k: int, stride: int, pad: int,
                 mode: str, device=None) -> torch.Tensor:
    """[out, k]: the input coordinate tap d of output o reads on an axis of
    length n under an ``axis_modes`` mode; -1 where it reads zero."""
    i = (torch.arange(out, device=device)[:, None] * stride
         + torch.arange(k, device=device)[None, :] - pad)
    if mode == "reflect":
        i = i.abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)
    if mode == "edge":
        return i.clamp(0, n - 1)
    return torch.where((i >= 0) & (i < n), i, torch.full_like(i, -1))


def _geometry(shape, kernel, stride, pad):
    """(B, spatial, C, output spatial, all rows, K) of a conv of ``x`` of
    ``shape``."""
    b, *spatial, c = shape
    outs = [out_size(n, k, s, p) for n, k, s, p in
            zip(spatial, kernel, stride, pad)]
    return b, spatial, c, outs, b * math.prod(outs), c * math.prod(kernel)


def conv_patches_plain(x: torch.Tensor, kernel: Sequence[int],
                       stride: Sequence[int], pad: Sequence[int], mode: str,
                       row0: int = 0, rows: Optional[int] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version, the kernel's arithmetic: each row's output
    coordinates from its index, each tap's input coordinate per axis by
    :func:`source_index`, one gather, zeros where a tap reads outside."""
    b, spatial, c, outs, n_rows, k_all = _geometry(x.shape, kernel, stride,
                                                   pad)
    rows = n_rows - row0 if rows is None else rows
    modes = axis_modes(spatial, pad, mode)
    r = torch.arange(row0, row0 + rows, device=x.device)
    coords = []
    for o in reversed(outs):
        coords.append(r % o)
        r = r // o
    coords.reverse()
    nd = len(spatial)
    idx, valid = [r.view(-1, *([1] * nd))], True
    for a, (n, o, k, s, p, m) in enumerate(zip(spatial, outs, kernel, stride,
                                               pad, modes)):
        i = source_index(n, o, k, s, p, m, x.device)[coords[a]]   # [rows, k]
        shape = [rows] + [1] * nd
        shape[1 + a] = k
        i = i.view(shape)
        valid = valid & (i >= 0)
        idx.append(i.clamp_min(0))
    vals = x[tuple(idx)]                                # [rows, *kernel, C]
    vals = torch.where(valid[..., None], vals, torch.zeros_like(vals))
    return vals.reshape(rows, k_all)


def patches_route(shape, n_rows: int, align: int = 16) -> tuple:
    """How ``csrc/patches.cu`` moves the data of an input of ``shape``
    [B, (T,) H, W, C] whose conv has ``n_rows`` output pixels, when input
    and output start on ``align``-byte boundaries: (floats a thread moves,
    64-bit offsets). 4 (16 bytes) where C % 4 == 0 and align is 16, 2 where
    C is even and align at least 8, else 1; 64-bit offsets where the input
    or the row count pass 2^31 - 1. Never the plain version: that is for
    CPU tensors only."""
    c = shape[-1]
    width = (4 if c % 4 == 0 and align % 16 == 0 else
             2 if c % 2 == 0 and align % 8 == 0 else 1)
    return width, math.prod(shape) > _INT32 or n_rows > _INT32


def _launch(x: torch.Tensor, kernel, stride, pad, mode, row0: int, rows: int,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on the card."""
    req = hopper.require
    nd = x.dim() - 2
    req(nd in (2, 3) and len(kernel) == len(stride) == len(pad) == nd,
        lambda: f"a 2D or 3D conv of x [B,(T,)H,W,C], got x "
        f"{tuple(x.shape)}, kernel {kernel}")
    req(x.dtype == torch.float32, lambda: f"x dtype {x.dtype} != float32")
    req(x.is_contiguous(), "x must be contiguous")
    b, spatial, c, outs, n_rows, k_all = _geometry(x.shape, kernel, stride,
                                                   pad)
    req(0 <= row0 and rows >= 0 and row0 + rows <= n_rows,
        lambda: f"rows [{row0}, {row0 + rows}) outside the {n_rows} of the "
        f"conv")
    req(rows * k_all <= _INT32, lambda: f"a chunk of {rows} rows of "
        f"{k_all} is beyond the kernel's 32-bit element index: chunk it")
    if out is None:
        out = torch.empty(rows, k_all, dtype=x.dtype, device=x.device)
    req(out.shape == (rows, k_all) and out.dtype == x.dtype
        and out.is_contiguous() and out.device == x.device,
        lambda: f"out must be a contiguous float32 [{rows}, {k_all}] on "
        f"{x.device}, got {tuple(out.shape)} {out.dtype}")
    if rows == 0:
        return out
    align = math.gcd(x.data_ptr(), out.data_ptr(), 16)
    width, wide = patches_route(x.shape, n_rows, align)
    if nd == 2:                           # a 2D conv: T = 1, kt = 1
        spatial, kernel, stride, pad = ((1, *spatial), (1, *kernel),
                                        (1, *stride), (0, *pad))
    modes = [AXIS_MODES[m] for m in axis_modes(spatial, pad, mode)]
    err = hopper.library().c2m_conv_patches_f32(
        x.data_ptr(), out.data_ptr(), b, *spatial, c, *kernel, *stride, *pad,
        *modes, row0, rows, width, int(wide), hopper.stream_ptr(x))
    hopper.check(err, "c2m_conv_patches_f32")
    CONV_PATCHES.launches += 1
    return out


def conv_patches(x: torch.Tensor, kernel: Sequence[int],
                 stride: Sequence[int], pad: Sequence[int], mode: str,
                 row0: int = 0, rows: Optional[int] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``[row0, row0 + rows)`` (all from ``row0`` when ``rows`` is None)
    of the patch matrix [rows, taps * C] of a conv of ``x``; written into
    ``out`` on the card when given."""
    if rows is None:
        rows = _geometry(x.shape, kernel, stride, pad)[4] - row0
    if x.device.type == "cpu":
        got = conv_patches_plain(x, kernel, stride, pad, mode, row0, rows)
        return got if out is None else out.copy_(got)
    if x.device.type != "cuda":
        raise ValueError(f"conv_patches: no kernel for {x.device}")
    return _launch(x, kernel, stride, pad, mode, row0, rows, out)
