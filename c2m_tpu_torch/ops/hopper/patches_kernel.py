"""The patch gather of a channels-last convolution (im2col), for the float32
convolutions that ``nn/layers.patch_conv`` computes as one cuBLAS GEMM, and
its adjoint, which adds a chunk of patch-matrix gradient back into the
input gradient (``nn/layers.PatchConv``'s backward).

Replace no TPU kernel: they take over convolutions, forward and backward,
that the JAX package left to XLA and the port to cuDNN (``csrc/patches.cu``
says why and what bounds each). CUDA source: ``csrc/patches.cu``.

Rows ``[row0, row0 + rows)`` of the patch matrix of ``x`` [B, H, W, C]
(2D) or [B, T, H, W, C] (3D): a row per output pixel, counted over the
batch and the output's spatial axes in order, holding for each tap of the
kernel, in the weight's spatial order, the C channels of the input pixel
that tap reads, so K = taps x C and column k = tap * C + c. Each axis is
padded by ``pad`` on both sides by ``layers.pad_spatial``'s rule: zeros,
replicate, or reflect falling back to edge on an axis no longer than its
pad.

The adjoint (:func:`conv_patches_adjoint`) is the transpose of that
gather: each element of a chunk's gradient [rows, K] is added into the
input element its tap read, a zeros tap outside the input dropped, an edge
or reflect tap into the pixel it clamped or folded onto.

A CPU tensor takes the plain versions (:func:`conv_patches_plain`,
:func:`conv_patches_adjoint_plain`); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from c2m_tpu_torch.ops import hopper

CONV_PATCHES = hopper.Kernel("conv_patches", "c2m_tpu_torch/csrc/patches.cu")
CONV_PATCHES_ADJOINT = hopper.Kernel("conv_patches_adjoint",
                                     "c2m_tpu_torch/csrc/patches.cu")
KERNELS = (CONV_PATCHES, CONV_PATCHES_ADJOINT)

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


def _source_pixels(shape, kernel, stride, pad, mode, row0: int, rows: int,
                   device) -> torch.Tensor:
    """[rows, taps]: the input pixel, counted over B and the spatial axes,
    that each tap of rows [row0, row0 + rows) of the patch matrix of a conv
    of an input of ``shape`` reads; -1 where it reads zero. The kernels'
    arithmetic: each row's output coordinates from its index, each tap's
    input coordinate per axis by :func:`source_index`."""
    b, spatial, c, outs, n_rows, k_all = _geometry(shape, kernel, stride, pad)
    modes = axis_modes(spatial, pad, mode)
    r = torch.arange(row0, row0 + rows, device=device)
    coords = []
    for o in reversed(outs):
        coords.append(r % o)
        r = r // o
    coords.reverse()
    nd = len(spatial)
    flat, valid = r.view(-1, *([1] * nd)), True
    for a, (n, o, k, s, p, m) in enumerate(zip(spatial, outs, kernel, stride,
                                               pad, modes)):
        i = source_index(n, o, k, s, p, m, device)[coords[a]]   # [rows, k]
        shape_a = [rows] + [1] * nd
        shape_a[1 + a] = k
        i = i.view(shape_a)
        valid = valid & (i >= 0)
        flat = flat * n + i.clamp_min(0)
    return torch.where(valid, flat, -1).reshape(rows, -1)


def conv_patches_plain(x: torch.Tensor, kernel: Sequence[int],
                       stride: Sequence[int], pad: Sequence[int], mode: str,
                       row0: int = 0, rows: Optional[int] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version: one gather of the pixels
    :func:`_source_pixels` names, zeros where a tap reads outside."""
    b, spatial, c, outs, n_rows, k_all = _geometry(x.shape, kernel, stride,
                                                   pad)
    rows = n_rows - row0 if rows is None else rows
    src = _source_pixels(x.shape, kernel, stride, pad, mode, row0, rows,
                         x.device)
    vals = x.reshape(-1, c)[src.clamp_min(0)]          # [rows, taps, C]
    vals = torch.where((src >= 0)[..., None], vals, torch.zeros_like(vals))
    return vals.reshape(rows, k_all)


def conv_patches_adjoint_plain(grad_patches: torch.Tensor, shape,
                               kernel: Sequence[int], stride: Sequence[int],
                               pad: Sequence[int], mode: str, row0: int = 0
                               ) -> torch.Tensor:
    """Plain PyTorch version of the adjoint: the gradient [*shape] of the
    input of a conv from the gradient [rows, K] of rows [row0, row0 + rows)
    of its patch matrix, by ``index_add_`` over the pixels
    :func:`_source_pixels` names (taps that read zero dropped)."""
    c, rows = shape[-1], grad_patches.shape[0]
    src = _source_pixels(shape, kernel, stride, pad, mode, row0, rows,
                         grad_patches.device).reshape(-1)
    keep = src >= 0
    out = grad_patches.new_zeros(math.prod(shape[:-1]), c)
    out.index_add_(0, src[keep], grad_patches.reshape(-1, c)[keep])
    return out.view(*shape)


def adjoint_lines(shape, kernel: Sequence[int], stride: Sequence[int],
                  pad: Sequence[int], mode: str, row0: int, rows: int
                  ) -> tuple:
    """(first, count): a run of the input lines (b, (t,) h, counted in that
    order) that holds every line rows [row0, row0 + rows) of the patch
    matrix read, so that an adjoint launch which adds into an input
    gradient covers no more than that run. From each axis's lowest
    coordinate any output from o on reads and highest any output up to o
    reads (the windows move by the stride; reflect folds the far pad
    back)."""
    b, spatial, c, outs, n_rows, k_all = _geometry(shape, kernel, stride, pad)
    if len(spatial) == 2:
        spatial, outs, kernel, stride, pad = (
            (1, *spatial), (1, *outs), (1, *kernel), (1, *stride),
            (0, *pad))
    modes = axis_modes(spatial, pad, mode)

    def low(a: int, o: int) -> int:
        n, k, s, p = spatial[a], kernel[a], stride[a], pad[a]
        lo = o * s - p
        if modes[a] == "reflect":
            lo = min(lo, 2 * (n - 1) - ((outs[a] - 1) * s - p + k - 1))
        return min(n - 1, max(0, lo))

    def high(a: int, o: int) -> int:
        n, k, s, p = spatial[a], kernel[a], stride[a], pad[a]
        hi = o * s - p + k - 1
        if modes[a] == "reflect":
            hi = max(hi, p)
        return min(n - 1, max(0, hi))

    def line(row: int):
        q, ho = divmod(row // outs[2], outs[1])
        bb, to = divmod(q, outs[0])
        return bb, to, ho

    t_n, h_n = spatial[0], spatial[1]
    b0, t0, h0 = line(row0)
    first = (b0 * t_n + low(0, t0)) * h_n
    if t0 == outs[0] - 1 or low(0, t0 + 1) > low(0, t0):
        first += low(1, h0)
    b1, t1, h1 = line(row0 + rows - 1)
    last = (b1 * t_n + high(0, t1)) * h_n
    if t1 == 0 or high(0, t1 - 1) < high(0, t1):
        last += high(1, h1)
    else:
        last += h_n - 1
    return first, last - first + 1


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
    """The gather kernel on the card."""
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


def _launch_adjoint(grad_patches: torch.Tensor, out: torch.Tensor, kernel,
                    stride, pad, mode, row0: int, accumulate: bool
                    ) -> torch.Tensor:
    """The adjoint kernel on the card."""
    req = hopper.require
    nd = out.dim() - 2
    req(nd in (2, 3) and len(kernel) == len(stride) == len(pad) == nd,
        lambda: f"a 2D or 3D conv of an input [B,(T,)H,W,C], got "
        f"{tuple(out.shape)}, kernel {kernel}")
    b, spatial, c, outs, n_rows, k_all = _geometry(out.shape, kernel, stride,
                                                   pad)
    rows = grad_patches.shape[0]
    req(out.dtype == grad_patches.dtype == torch.float32
        and out.is_contiguous() and grad_patches.is_contiguous()
        and grad_patches.device == out.device
        and grad_patches.shape == (rows, k_all),
        lambda: f"grad_patches must be a contiguous float32 [rows, {k_all}] "
        f"and out a contiguous float32 input on one device, got "
        f"{tuple(grad_patches.shape)} {grad_patches.dtype} and "
        f"{tuple(out.shape)} {out.dtype}")
    req(0 <= row0 and row0 + rows <= n_rows,
        lambda: f"rows [{row0}, {row0 + rows}) outside the {n_rows} of the "
        f"conv")
    req(rows * k_all <= _INT32, lambda: f"a chunk of {rows} rows of "
        f"{k_all} is beyond the kernel's 32-bit element index: chunk it")
    if rows == 0:
        return out
    line0, lines = (adjoint_lines(out.shape, kernel, stride, pad, mode,
                                  row0, rows) if accumulate
                    else (0, b * math.prod(spatial[:-1])))
    align = math.gcd(grad_patches.data_ptr(), out.data_ptr(), 16)
    width = patches_route(out.shape, n_rows, align)[0]
    if nd == 2:
        spatial, kernel, stride, pad = ((1, *spatial), (1, *kernel),
                                        (1, *stride), (0, *pad))
    modes = [AXIS_MODES[m] for m in axis_modes(spatial, pad, mode)]
    err = hopper.library().c2m_conv_patches_adjoint_f32(
        grad_patches.data_ptr(), out.data_ptr(), b, *spatial, c, *kernel,
        *stride, *pad, *modes, row0, rows, line0, lines, int(accumulate),
        width, hopper.stream_ptr(out))
    hopper.check(err, "c2m_conv_patches_adjoint_f32")
    CONV_PATCHES_ADJOINT.launches += 1
    return out


def conv_patches_adjoint(grad_patches: torch.Tensor, out: torch.Tensor,
                         kernel: Sequence[int], stride: Sequence[int],
                         pad: Sequence[int], mode: str, row0: int = 0,
                         accumulate: bool = False) -> torch.Tensor:
    """The gradient of the conv's input [B, (T,) H, W, C] from the gradient
    [rows, K] of rows ``[row0, row0 + rows)`` of its patch matrix, written
    into ``out`` (which has the input's shape), or added to it where
    ``accumulate`` (a later chunk of the same conv)."""
    if out.device.type == "cpu":
        got = conv_patches_adjoint_plain(grad_patches, out.shape, kernel,
                                         stride, pad, mode, row0)
        return out.add_(got) if accumulate else out.copy_(got)
    if out.device.type != "cuda":
        raise ValueError(f"conv_patches_adjoint: no kernel for {out.device}")
    return _launch_adjoint(grad_patches, out, kernel, stride, pad, mode,
                           row0, accumulate)
