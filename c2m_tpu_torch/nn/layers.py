"""Conv/norm building blocks (port of ``c2m_tpu/nn/layers.py``).

Every module takes and returns channels-last tensors (``[B, H, W, C]`` or
``[B, T, H, W, C]``) as the JAX package does. Inside, a conv takes one of
two routes (:func:`conv_route`): ``cudnn`` pads, permutes its input to
PyTorch's NCHW view (a view, no copy) and runs
``torch.nn.functional.conv2d``/``conv3d`` (cuDNN on the card); ``patch``,
only for float32 on the card with TF32 off and never for a trained conv's
training call, gathers the padded patches with a hand-written kernel and
multiplies them by the weight in one cuBLAS float32 GEMM
(:func:`patch_conv`), and, outside ``torch.inference_mode``,
differentiates through :class:`PatchConv`: cuBLAS GEMMs and the gather's
hand-written adjoint.

Norms follow ``module.training``: batch statistics (and running-stat
updates) in train mode, running statistics in eval mode. Padding is explicit so that reflect padding can fall back to edge padding on
an axis too short to reflect, as in the JAX package (torch's ReflectionPad
raises there).

Parameters are float32. A conv or linear layer computes in its
``compute_dtype`` when one is set (:func:`use_compute_dtype`): it casts its
weight, bias and input at use, as flax's ``dtype=`` does, so the optimizer
keeps float32 parameters while the conv stacks run in bfloat16; serving
takes the same route. With no ``compute_dtype`` a layer computes in its
weight's dtype.

``JAX_NAMES`` on a block maps its children to the names the same module has
in the JAX variable tree (``utils/convert.py`` walks it).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from c2m_tpu_torch.ops.hopper import patches_kernel
from c2m_tpu_torch.ops.warp import resize_bilinear
from c2m_tpu_torch.parallel import mesh

IntOrSeq = Union[int, Sequence[int]]


def _tuple(v: IntOrSeq, n: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def pad_spatial(x: torch.Tensor, pads: Sequence[Tuple[int, int]],
                mode: str) -> torch.Tensor:
    """Pad the spatial axes (all but first and last) of a channels-last
    tensor. ``mode``: 'zeros', 'reflect' (edge padding on an axis of size
    <= the pad) or 'replicate'."""
    for axis, (lo, hi) in enumerate(pads, start=1):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[axis]
        if mode == "zeros":
            cfg = [0, 0] * (x.dim() - axis - 1) + [lo, hi]
            x = F.pad(x, cfg)
            continue
        idx = torch.arange(-lo, n + hi, device=x.device)
        if mode == "reflect" and n > max(lo, hi):
            idx = idx.abs()
            idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        elif mode in ("reflect", "replicate"):
            idx = idx.clamp(0, n - 1)
        else:
            raise ValueError(f"unknown padding mode {mode}")
        x = x.index_select(axis, idx)
    return x


def _operands(mod, x: torch.Tensor):
    """Input, weight and bias in the layer's compute dtype."""
    dt = mod.compute_dtype or mod.weight.dtype
    bias = None if mod.bias is None else mod.bias.to(dt)
    return x.to(dt), mod.weight.to(dt), bias


# Bytes of patch matrix one chunk of rows may take under
# torch.inference_mode. The widest conv of the journal and long-horizon
# models (K = 27 x 528) still gets 37k rows a chunk, a GEMM far past
# cuBLAS's tile count; the scratch is reused chunk after chunk and never
# exceeds this.
PATCH_BYTES = 2 << 30

# Bytes of scratch a conv outside torch.inference_mode (a frozen net's
# forward and backward in a train step, a no_grad pass) may take: the
# forward's patch chunk, and in the backward the rebuilt patches and the
# patch gradient together. Of 256 MiB to 2 GiB, the least read fastest in
# the journal train step on an H100, and none moved its memory peak
# (PERF.md, PR 17).
TRAIN_PATCH_BYTES = 256 << 20

# Conv and Conv3d calls by route since the process started, and the
# backwards on the patch route (tests and chip_smoke.py read the share the
# patch route takes).
CONV_CALLS = {"patch": 0, "cudnn": 0, "patch_backward": 0}


def conv_route(device_type: str, dtype: torch.dtype, cudnn_tf32: bool,
               matmul_tf32: bool, trains_weight: bool) -> str:
    """How a Conv or Conv3d computes, from what the call can observe:
    ``patch`` for operands on the card in float32 with TF32 off for both
    cuDNN and cuBLAS (so that the GEMMs are exactly as precise as the convs
    they replace), unless the call records a gradient for a weight that
    trains (``trains_weight``: grad mode on and the weight requires grad).
    So serving (:func:`patch_conv`), ``no_grad`` passes (generation, the
    perceptual loss's pass on the real frames) and frozen nets in a train
    step (VGG19 on the generated frames, with its input gradient:
    :class:`PatchConv`) take it. ``cudnn`` (pad_spatial + F.conv2d /
    conv3d, autograd's cuDNN backward) for every other call: the CPU,
    bfloat16, TF32 and a trained conv's training call. That one keeps
    cuDNN's forward because the train step turns a one-ulp change of any
    trained conv's output into a change of some 1e-3 in a parameter's first
    gradient norm, past what holds the port to its float32 reference, and
    cuDNN's backward because the patch route's, faster on the device, read
    slower end to end, where the host's launches set the pace (PERF.md,
    PR 17). No width rule: on an H100 the patch route read faster at every
    conv of the journal model, down to 1 output channel (PERF.md section
    6)."""
    if (device_type == "cuda" and dtype == torch.float32 and not cudnn_tf32
            and not matmul_tf32 and not trains_weight):
        return "patch"
    return "cudnn"


def _route(mod, x: torch.Tensor) -> str:
    """:func:`conv_route` for this call of ``mod``, counted."""
    route = conv_route(x.device.type, mod.compute_dtype or mod.weight.dtype,
                       torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32,
                       torch.is_grad_enabled() and mod.weight.requires_grad)
    CONV_CALLS[route] += 1
    return route


def _nchw_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride: Sequence[int]
               ) -> torch.Tensor:
    """F.conv2d / conv3d (cuDNN on the card) on PyTorch's NCHW view of a
    padded channels-last input; the channels-last view of the result."""
    conv = F.conv2d if weight.dim() == 4 else F.conv3d
    return conv(x.movedim(-1, 1), weight, bias, stride).movedim(1, -1)


def _patch_weight(weight: torch.Tensor) -> torch.Tensor:
    """[F, C, *kernel] -> [F, taps * C], the patches' (taps, C) order."""
    return weight.permute(0, *range(2, weight.dim()), 1).reshape(
        weight.shape[0], -1)


def _chunk_rows(rows: int, k_all: int, element_size: int, budget: int) -> int:
    """Rows of a [rows, k_all] matrix whose chunk fits ``budget`` bytes."""
    return max(1, min(rows, budget // (k_all * element_size)))


def patch_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride: Sequence[int],
               pad: Sequence[int], mode: str,
               budget: Optional[int] = None) -> torch.Tensor:
    """A channels-last conv as patches x weight: x [B, (T,) H, W, C], weight
    [F, C, *kernel] -> [B, *out, F] contiguous. Output rows are cut into
    chunks whose patch matrix fits ``budget`` bytes (``PATCH_BYTES`` when
    None); per chunk the kernel gathers the padded patches
    (``ops/hopper/patches_kernel``) and one GEMM writes the chunk's rows of
    the output, bias added. The weight is permuted once to the patches'
    (taps, C) order."""
    kernel = tuple(weight.shape[2:])
    x = x.contiguous()
    b, *spatial, _ = x.shape
    outs = [patches_kernel.out_size(n, k, s, p)
            for n, k, s, p in zip(spatial, kernel, stride, pad)]
    rows = b * math.prod(outs)
    features = weight.shape[0]
    w = _patch_weight(weight)
    out = torch.empty(b, *outs, features, dtype=x.dtype, device=x.device)
    y = out.view(rows, features)
    k_all = w.shape[1]
    chunk = _chunk_rows(rows, k_all, x.element_size(),
                        PATCH_BYTES if budget is None else budget)
    scratch = torch.empty(chunk, k_all, dtype=x.dtype, device=x.device)
    for row0 in range(0, rows, chunk):
        n = min(chunk, rows - row0)
        patches = patches_kernel.conv_patches(x, kernel, stride, pad, mode,
                                              row0, n, out=scratch[:n])
        if bias is None:
            torch.mm(patches, w.t(), out=y[row0:row0 + n])
        else:
            torch.addmm(bias, patches, w.t(), out=y[row0:row0 + n])
    return out


def patch_conv_backward(x: torch.Tensor, weight: torch.Tensor,
                        grad_y: torch.Tensor, stride: Sequence[int],
                        pad: Sequence[int], mode: str, need_x: bool,
                        need_w: bool, need_b: bool) -> tuple:
    """The gradients (input, weight, bias; None where not needed) of
    :func:`patch_conv` of x [B, (T,) H, W, C] by weight [F, C, *kernel] from
    grad_y [B, *out, F]. Output rows are walked in chunks whose rebuilt
    patches and patch gradient fit ``TRAIN_PATCH_BYTES`` together: the
    weight gradient is
    grad_y^T x patches, the chunk's patches rebuilt by the gather and the
    products accumulated in one [F, K] buffer by cuBLAS; the input gradient
    is grad_y x weight (cuBLAS), added back into the input by the gather's
    adjoint kernel; the bias gradient the sum of grad_y over rows. No
    atomics: the gradients repeat bit for bit."""
    kernel, features = tuple(weight.shape[2:]), weight.shape[0]
    g = grad_y.contiguous().view(-1, features)
    rows = g.shape[0]
    w = _patch_weight(weight)
    k_all = w.shape[1]
    grad_x = grad_w = None
    if need_x or need_w:
        chunk = _chunk_rows(rows, k_all, x.element_size(),
                            TRAIN_PATCH_BYTES // (need_x + need_w))
        if need_w:
            patches = torch.empty(chunk, k_all, dtype=x.dtype,
                                  device=x.device)
            grad_w = torch.empty(features, k_all, dtype=x.dtype,
                                 device=x.device)
        if need_x:
            grad_patches = torch.empty(chunk, k_all, dtype=x.dtype,
                                       device=x.device)
            grad_x = torch.empty_like(x)
        for row0 in range(0, rows, chunk):
            n = min(chunk, rows - row0)
            g_n = g[row0:row0 + n]
            if need_w:
                p = patches_kernel.conv_patches(x, kernel, stride, pad, mode,
                                                row0, n, out=patches[:n])
                if row0 == 0:
                    torch.mm(g_n.t(), p, out=grad_w)
                else:
                    grad_w.addmm_(g_n.t(), p)
            if need_x:
                gp = torch.mm(g_n, w, out=grad_patches[:n])
                patches_kernel.conv_patches_adjoint(
                    gp, grad_x, kernel, stride, pad, mode, row0,
                    accumulate=row0 > 0)
        if need_w:
            nd = len(kernel)
            grad_w = grad_w.view(features, *kernel, -1).permute(
                0, nd + 1, *range(1, nd + 1)).contiguous()
    return grad_x, grad_w, g.sum(0) if need_b else None


class PatchConv(torch.autograd.Function):
    """:func:`patch_conv` with its backward on the patch route
    (:func:`patch_conv_backward`), for the calls outside
    ``torch.inference_mode``; its scratch budget is ``TRAIN_PATCH_BYTES``.
    The forward saves the unpadded input and the weight: no padded copy and
    no patch matrix. The backward computes only what ``needs_input_grad``
    asks for."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, pad, mode):
        x = x.contiguous()
        ctx.save_for_backward(x, weight)
        ctx.conv = (tuple(stride), tuple(pad), mode)
        return patch_conv(x, weight, bias, stride, pad, mode,
                          TRAIN_PATCH_BYTES)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_y):
        CONV_CALLS["patch_backward"] += 1
        x, weight = ctx.saved_tensors
        return (*patch_conv_backward(x, weight, grad_y, *ctx.conv,
                                     *ctx.needs_input_grad[:3]),
                None, None, None)


def _conv(mod, x: torch.Tensor) -> torch.Tensor:
    """One call of a Conv or Conv3d ``mod`` on its route
    (:func:`conv_route`): pad_spatial + cuDNN with autograd's backward,
    :func:`patch_conv` under ``torch.inference_mode`` (serving: no autograd,
    ``PATCH_BYTES`` of scratch), else :class:`PatchConv`."""
    if _route(mod, x) == "cudnn":
        x = pad_spatial(x, [(p, p) for p in mod.pad], mod.pad_mode)
        return _nchw_conv(*_operands(mod, x), mod.stride)
    x, weight, bias = _operands(mod, x)
    if torch.is_inference_mode_enabled():
        return patch_conv(x, weight, bias, mod.stride, mod.pad, mod.pad_mode)
    return PatchConv.apply(x, weight, bias, mod.stride, mod.pad, mod.pad_mode)


class Conv(nn.Conv2d):
    """2D conv on NHWC with explicit reflect/replicate/zeros padding.
    Parameters: ``weight`` [F, C, kh, kw], ``bias`` [F] unless ``use_bias``
    is off (torch default init, which is also the JAX package's)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOrSeq = 3, strides: IntOrSeq = 1,
                 padding: IntOrSeq = 0, padding_mode: str = "zeros",
                 use_bias: bool = True):
        super().__init__(in_features, features, _tuple(kernel_size, 2),
                         stride=_tuple(strides, 2), padding=0, bias=use_bias)
        self.pad = _tuple(padding, 2)
        self.pad_mode = padding_mode
        self.compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self, x)


class Conv3d(nn.Conv3d):
    """3D conv on NTHWC (time, height and width padded first). Parameters:
    ``weight`` [F, C, kt, kh, kw], ``bias`` [F]."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOrSeq = 3, strides: IntOrSeq = 1,
                 padding: IntOrSeq = 0, padding_mode: str = "reflect"):
        super().__init__(in_features, features, _tuple(kernel_size, 3),
                         stride=_tuple(strides, 3), padding=0)
        self.pad = _tuple(padding, 3)
        self.pad_mode = padding_mode
        self.compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self, x)


class Dense(nn.Linear):
    """Linear layer; casts its input to its compute dtype (the weight's
    dtype unless ``compute_dtype`` is set)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        self.compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_operands(self, x))


def use_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every conv and linear layer under ``module`` computes in ``dtype``
    from now on; parameters and buffers keep their own dtype."""
    for m in module.modules():
        if isinstance(m, (Conv, Conv3d, Dense, SpectralNormConv)):
            m.compute_dtype = dtype
    return module


# share of the batch statistic in a running statistic after one train-mode
# forward (torch's convention; flax's momentum 0.9 is one minus this)
BN_MOMENTUM = 0.1


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, statistics in float32:
    (x − mean)·rsqrt(var + 1e-5)·weight + bias.

    Eval mode uses the running statistics. Train mode uses the batch
    statistics over all axes but the last, var = max(0, E[x²] − E[x]²) as
    flax computes it, and moves the running statistics by momentum 0.1
    (flax 0.9). As in the JAX package (flax), ``running_var`` takes the
    BIASED batch variance; ``torch.nn.BatchNorm`` would store the unbiased
    one.

    The statistics are the global batch's, as flax's are under ``jit`` on a
    data mesh: under a live process group the per-channel E[x] and E[x²]
    are averaged over the ranks, whose counts are equal
    (``parallel/mesh.global_sums``, whose backward carries the other ranks'
    terms), so every rank normalizes alike and keeps the same running
    statistics. Without a group they are the local batch's."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean, meansq = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            if mesh.is_live():
                # every rank normalizes the same number of rows (each takes
                # train_params.batch_size clips), so the global moments are
                # the ranks' mean moments; a group of one rank divides by 1
                world = float(mesh.world_size())
                mean, meansq = (m / world for m in
                                mesh.global_sums(mean, meansq))
            var = (meansq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                        BN_MOMENTUM)
                self.running_var.lerp_(var.to(self.running_var.dtype),
                                       BN_MOMENTUM)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean) * mul + self.bias.float()
        return y.to(x.dtype)


class InstanceNorm(nn.Module):
    """torch InstanceNorm(affine, no running stats): per-sample, per-channel
    statistics over the spatial axes of a channels-last tensor."""

    def __init__(self, num_features: int, affine: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class DownBlock2d(nn.Module):
    """conv + BatchNorm + leaky(0.2)."""
    JAX_NAMES = {"conv": "Conv_0", "norm": "BatchNorm_0"}

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOrSeq = 3, strides: IntOrSeq = 1,
                 padding: IntOrSeq = 1, padding_mode: str = "zeros"):
        super().__init__()
        self.conv = Conv(in_features, features, kernel_size, strides, padding,
                         padding_mode)
        self.norm = BatchNorm(features)

    def forward(self, x):
        return leaky(self.norm(self.conv(x)))


class DownBlock3d(nn.Module):
    """conv3d + BatchNorm + leaky(0.2)."""
    JAX_NAMES = {"conv": "Conv3d_0", "norm": "BatchNorm_0"}

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOrSeq = 3, strides: IntOrSeq = 1,
                 padding: IntOrSeq = 1, padding_mode: str = "reflect"):
        super().__init__()
        self.conv = Conv3d(in_features, features, kernel_size, strides,
                           padding, padding_mode)
        self.norm = BatchNorm(features)

    def forward(self, x):
        return leaky(self.norm(self.conv(x)))


SameBlock3d = DownBlock3d    # pad + conv3d + BatchNorm3d + leaky: same layers


class UpBlock2d(nn.Module):
    """2x bilinear upsample + conv + BatchNorm + leaky (up_block.py:5-27)."""
    JAX_NAMES = {"conv": "Conv_0", "norm": "BatchNorm_0"}

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOrSeq = 3, strides: IntOrSeq = 1,
                 padding: IntOrSeq = 1, padding_mode: str = "zeros"):
        super().__init__()
        self.conv = Conv(in_features, features, kernel_size, strides, padding,
                         padding_mode)
        self.norm = BatchNorm(features)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = resize_bilinear(x, (2 * h, 2 * w), align_corners=False)
        return leaky(self.norm(self.conv(x)))


class SameBlock2d(nn.Module):
    """conv + InstanceNorm(affine) + leaky."""
    JAX_NAMES = {"conv": "Conv_0", "norm": "InstanceNorm_0"}

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOrSeq = 3, strides: IntOrSeq = 1,
                 padding: IntOrSeq = 1, padding_mode: str = "zeros",
                 use_norm: bool = True):
        super().__init__()
        self.conv = Conv(in_features, features, kernel_size, strides, padding,
                         padding_mode)
        self.norm = InstanceNorm(features) if use_norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return leaky(x)


class SameBlockTwoConv2d(nn.Module):
    """conv + InstanceNorm + conv(leaky(.))."""
    JAX_NAMES = {"conv1": "Conv_0", "norm": "InstanceNorm_0",
                 "conv2": "Conv_1"}

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOrSeq = 3, strides: IntOrSeq = 1,
                 padding: IntOrSeq = 1, padding_mode: str = "zeros"):
        super().__init__()
        self.conv1 = Conv(in_features, features, kernel_size, strides,
                          padding, padding_mode)
        self.norm = InstanceNorm(features)
        self.conv2 = Conv(features, features, kernel_size, strides, padding,
                          padding_mode)

    def forward(self, x):
        return self.conv2(leaky(self.norm(self.conv1(x))))


class ResidualBlock(nn.Module):
    """BN → relu → reflect conv → BN → relu → reflect conv → + x."""
    JAX_NAMES = {"norm1": "BatchNorm_0", "conv1": "Conv_0",
                 "norm2": "BatchNorm_1", "conv2": "Conv_1"}

    def __init__(self, features: int, kernel_size: int = 3, padding: int = 1):
        super().__init__()
        self.norm1 = BatchNorm(features)
        self.conv1 = Conv(features, features, kernel_size, 1, padding,
                          "reflect")
        self.norm2 = BatchNorm(features)
        self.conv2 = Conv(features, features, kernel_size, 1, padding,
                          "reflect")

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return out + x


class SpectralNormConv(nn.Module):
    """Conv (no padding, stride 1) with torch-style spectral normalisation
    (port of ``c2m_tpu/nn/layers.py`` SpectralNormConv): the weight is
    divided by sigma = u·(W v), W the weight as an [out, in·kh·kw] matrix.
    Train mode runs one power iteration per forward (v = W'u/|W'u|,
    u = Wv/|Wv|, eps 1e-12) and stores the new ``u`` in its buffer, in
    place and without gradient; eval mode recomputes ``v`` from the stored
    ``u``. ``u`` and ``v`` are constants to autograd."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1):
        super().__init__()
        k = _tuple(kernel_size, 2)
        self.weight = nn.Parameter(torch.empty(features, in_features, *k))
        self.bias = nn.Parameter(torch.empty(features))
        bound = 1.0 / float(in_features * k[0] * k[1]) ** 0.5
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)
        self.register_buffer("u", torch.randn(features))
        self.compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def normalize(v):
            return v / (torch.linalg.vector_norm(v) + 1e-12)

        w_mat = self.weight.flatten(1)                       # [out, in*kh*kw]
        with torch.no_grad():
            u = self.u.float()
            v = normalize(w_mat.t() @ u)
            if self.training:
                # a new tensor: an earlier forward's graph still holds the
                # u it used, so the buffer is only copied into
                u = normalize(w_mat @ v)
                self.u.copy_(u)
        sigma = torch.dot(u, w_mat @ v)
        dt = self.compute_dtype or self.weight.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), (self.weight / sigma).to(dt))
        return y.permute(0, 2, 3, 1) + self.bias.to(y.dtype)


def fold_time(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """[B, T, ...] -> ([B*T, ...], T), batch-major as the JAX package."""
    b, t = x.shape[:2]
    return x.reshape(b * t, *x.shape[2:]), t


def unfold_time(x: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of :func:`fold_time`."""
    return x.reshape(x.shape[0] // t, t, *x.shape[1:])
