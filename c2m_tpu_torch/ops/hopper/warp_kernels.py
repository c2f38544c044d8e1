"""Kernel K1: bilinear resample (+ fused ×mask), forward and backward.

Replaces the Pallas kernel ``_resample_pallas`` / ``_warp_kernel`` in
``c2m_tpu/ops/pallas/warp_kernels.py``. CUDA sources: ``csrc/resample.cu``
(forward) and ``csrc/resample_bwd.cu`` (the gradients with respect to the
image, the flow and the mask; the JAX package differentiates its jnp path
with ``jax.grad`` and has no backward kernel).

A CPU tensor takes :func:`resample_plain`, forward and (through autograd)
backward; a CUDA tensor goes through a ``torch.autograd.Function`` whose
forward and backward launch the kernels or raise. One entry point per
image dtype (float32, bfloat16) and direction, each with its own launch
count. The forward has several layouts of the same arithmetic onto threads
(:func:`resample_route`): every one is a kernel of ``csrc/resample.cu``.
The image gradient is a scatter of float atomics, summed in an order that
changes from run to run: it agrees with autograd of the plain version
to float32 summation error, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from c2m_tpu_torch.ops import hopper

RESAMPLE_F32 = hopper.Kernel(
    "resample_f32", "c2m_tpu_torch/csrc/resample.cu",
    "c2m_tpu/ops/pallas/warp_kernels.py:130")
RESAMPLE_BF16 = hopper.Kernel(
    "resample_bf16", "c2m_tpu_torch/csrc/resample.cu",
    "c2m_tpu/ops/pallas/warp_kernels.py:130")
_BWD_OF = ("backward of c2m_tpu/ops/warp.py:195 under jax.grad "
           "(no Pallas counterpart)")
RESAMPLE_BWD_F32 = hopper.Kernel(
    "resample_bwd_f32", "c2m_tpu_torch/csrc/resample_bwd.cu", _BWD_OF)
RESAMPLE_BWD_BF16 = hopper.Kernel(
    "resample_bwd_bf16", "c2m_tpu_torch/csrc/resample_bwd.cu", _BWD_OF)
KERNELS = (RESAMPLE_F32, RESAMPLE_BF16, RESAMPLE_BWD_F32, RESAMPLE_BWD_BF16)


def resample_plain(image: torch.Tensor, flow: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the JAX ``_resample_jnp`` math in float32,
    times ``mask`` when given, rounded once to the image dtype."""
    from c2m_tpu_torch.ops.warp import bilinear_sample
    _, h, w, _ = image.shape
    xs = torch.arange(w, dtype=torch.float32, device=image.device)
    ys = torch.arange(h, dtype=torch.float32, device=image.device)
    # degenerate 1-wide axes are guarded as in the reference port
    wf = w / max(w - 1.0, 1e-6)
    hf = h / max(h - 1.0, 1e-6)
    sx = (xs[None, None, :] + flow[..., 0].float()) * wf - 0.5
    sy = (ys[None, :, None] + flow[..., 1].float()) * hf - 0.5
    out = bilinear_sample(image.float(), sx, sy, padding="border")
    if mask is not None:
        out = out * mask.float()
    return out.to(image.dtype)


# The forward's routes and the number csrc/resample.cu knows each by.
ROUTES = {"scalar": 0, "vec": 1, "pixel": 2, "scalar64": 3}
_INT32 = 2 ** 31
# channels that fill 16 bytes, the width of a lane's loads on the vec route
VEC_CHANNELS = {torch.float32: 4, torch.bfloat16: 8}
# the widest pixel of the pixel route (frames, flows, masks)
PIXEL_MAX_CHANNELS = 4


def resample_route(dtype: torch.dtype, shape, aligned: bool = True) -> str:
    """Which kernel of ``csrc/resample.cu`` the forward launches for an image
    of ``dtype`` and ``shape`` [B, H, W, C] on the card. ``aligned``: image,
    flow and output start on 16-byte boundaries (a contiguous view with a
    storage offset need not).

    - ``vec``: C fills whole 16-byte pieces (8 bfloat16 or 4 float32
      channels): a lane blends one piece, a group of lanes shares a pixel;
    - ``pixel``: up to 4 channels: a warp owns 32 pixels, a lane computes one
      pixel's taps and the warp walks its 32*C elements together;
    - ``scalar``: every other C, and unaligned tensors: a thread per element;
    - ``scalar64``: the same with 64-bit indices, where 32 bits do not reach
      (B*H*W or H*W*C of 2^31 and more for the first two routes, B*H*W*C for
      ``scalar``).
    Never the plain version: that is for CPU tensors only.
    """
    b, h, w, c = shape
    if aligned and b * h * w < _INT32 and h * w * c < _INT32:
        if c % VEC_CHANNELS[dtype] == 0:
            return "vec"
        if c <= PIXEL_MAX_CHANNELS:
            return "pixel"
    return "scalar" if b * h * w * c < _INT32 else "scalar64"


def resample_pixel_route_plain(image: torch.Tensor, flow: torch.Tensor,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The ``pixel`` route's addressing in plain PyTorch, for the CPU tests:
    per pixel the offset of the top-left tap and the steps to its right and
    lower neighbours (0 at the border), so that a row's two taps are one run
    of 2C values starting at x0, or of C values where x0 is the last column.
    Same blend, term for term, as :func:`resample_plain`."""
    b, h, w, c = image.shape
    xs = torch.arange(w, dtype=torch.float32, device=image.device)
    ys = torch.arange(h, dtype=torch.float32, device=image.device)
    wf = w / max(w - 1.0, 1e-6)
    hf = h / max(h - 1.0, 1e-6)
    sx = ((xs[None, None, :] + flow[..., 0].float()) * wf - 0.5).clamp(
        0.0, w - 1.0)
    sy = ((ys[None, :, None] + flow[..., 1].float()) * hf - 0.5).clamp(
        0.0, h - 1.0)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    r0 = ((y0 * w + x0) * c).reshape(b, -1, 1)          # the upper run
    dx = ((x0 + 1 < w).long() * c).reshape(b, -1, 1)    # 0 at the right border
    r1 = r0 + ((y0 + 1 < h).long() * (w * c)).reshape(b, -1, 1)
    ch = torch.arange(c, device=image.device)
    flat = image.float().reshape(b, h * w * c)

    def run(idx):
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, h, w, c)

    v00, v10 = run(r0 + ch), run(r0 + dx + ch)
    v01, v11 = run(r1 + ch), run(r1 + dx + ch)
    top = v00 * (1.0 - wx) + v10 * wx
    bot = v01 * (1.0 - wx) + v11 * wx
    out = top * (1.0 - wy) + bot * wy
    if mask is not None:
        out = out * mask.float()
    return out.to(image.dtype)


_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(image, flow, mask):
    """[B, H, W, C] of the image, or ValueError saying which input the
    kernels do not take. The messages are made only when a check fails:
    this runs before every launch."""
    req = hopper.require
    req(image.dim() == 4,
        lambda: f"image must be [B,H,W,C], got {tuple(image.shape)}")
    b, h, w, c = image.shape
    req(image.dtype in _DTYPES,
        lambda: f"image dtype {image.dtype} not float32/bfloat16")
    req(flow.shape == (b, h, w, 2) and flow.dtype == torch.float32,
        lambda: f"flow must be float32 [{b},{h},{w},2], got {flow.dtype} "
        f"{tuple(flow.shape)}")
    req(flow.device == image.device, "all inputs must be on one device")
    req(image.is_contiguous() and flow.is_contiguous(),
        "inputs must be contiguous")
    if mask is not None:
        req(mask.shape == (b, h, w, 1) and mask.dtype == torch.float32,
            lambda: f"mask must be float32 [{b},{h},{w},1], got {mask.dtype} "
            f"{tuple(mask.shape)}")
        req(mask.device == image.device, "all inputs must be on one device")
        req(mask.is_contiguous(), "inputs must be contiguous")
    return b, h, w, c


def _launch(image, flow, mask, route: Optional[str] = None):
    """The forward on the card. ``route`` overrides :func:`resample_route`,
    to test a route by name; a route that does not take the shape makes the
    launch fail, and that raises."""
    b, h, w, c = _check_inputs(image, flow, mask)
    out = torch.empty_like(image)
    if out.numel() == 0:
        return out
    if route is None:
        aligned = (image.data_ptr() | flow.data_ptr()
                   | out.data_ptr()) % 16 == 0
        route = resample_route(image.dtype, (b, h, w, c), aligned)
    kernel, fn = ((RESAMPLE_F32, "c2m_resample_f32")
                  if image.dtype == torch.float32
                  else (RESAMPLE_BF16, "c2m_resample_bf16"))
    err = getattr(hopper.library(), fn)(
        image.data_ptr(), flow.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        b, h, w, c, int(mask is not None), ROUTES[route],
        hopper.stream_ptr(image))
    hopper.check(err, fn)
    kernel.launches += 1
    return out


def _launch_backward(grad_out, image, flow, mask, need_image, need_flow,
                     need_mask):
    """The gradients that were asked for (None for the others). The image
    gradient is accumulated in a zeroed float32 buffer and cast once to the
    image dtype."""
    b, h, w, c = _check_inputs(image, flow, mask)
    hopper.require(grad_out.shape == image.shape
                   and grad_out.dtype == image.dtype
                   and grad_out.device == image.device,
                   "grad_out must match the image in shape, dtype and device")
    grad_out = grad_out.contiguous()
    need_mask = need_mask and mask is not None
    dev = image.device
    g_image = (torch.zeros(image.shape, dtype=torch.float32, device=dev)
               if need_image else None)
    g_flow = torch.zeros_like(flow) if need_flow else None
    g_mask = torch.zeros_like(mask) if need_mask else None
    if image.numel() and (need_image or need_flow or need_mask):
        kernel, fn = ((RESAMPLE_BWD_F32, "c2m_resample_bwd_f32")
                      if image.dtype == torch.float32
                      else (RESAMPLE_BWD_BF16, "c2m_resample_bwd_bf16"))

        def ptr(t):
            return t.data_ptr() if t is not None else None

        err = getattr(hopper.library(), fn)(
            grad_out.data_ptr(), image.data_ptr(), flow.data_ptr(), ptr(mask),
            ptr(g_image), ptr(g_flow), ptr(g_mask), b, h, w, c,
            int(mask is not None), int(need_image), int(need_flow),
            int(need_mask), hopper.stream_ptr(image))
        hopper.check(err, fn)
        kernel.launches += 1
    if g_image is not None:
        g_image = g_image.to(image.dtype)
    return g_image, g_flow, g_mask


class _ResampleCuda(torch.autograd.Function):
    """K1 on the card: forward and backward are the hand-written kernels.
    Saves image, flow and mask (not the taps)."""

    @staticmethod
    def forward(ctx, image, flow, mask):
        ctx.save_for_backward(image, flow, mask)
        return _launch(image, flow, mask)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        image, flow, mask = ctx.saved_tensors
        return _launch_backward(grad_out, image, flow, mask,
                                *ctx.needs_input_grad)


def _dispatch(image, flow, mask):
    if image.device.type == "cpu":
        return resample_plain(image, flow, mask)
    if image.device.type != "cuda":
        raise ValueError(f"resample: no kernel for device {image.device}")
    if torch.is_grad_enabled() and (
            image.requires_grad or flow.requires_grad
            or (mask is not None and mask.requires_grad)):
        return _ResampleCuda.apply(image, flow, mask)
    return _launch(image, flow, mask)        # serving: nothing to record


def resample(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """image [B,H,W,C] f32/bf16, flow [B,H,W,2] f32 -> warped [B,H,W,C]."""
    return _dispatch(image, flow, None)


def resample_masked(image: torch.Tensor, flow: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """``resample(image, flow) * mask`` with mask [B,H,W,1] f32, one pass."""
    return _dispatch(image, flow, mask)
