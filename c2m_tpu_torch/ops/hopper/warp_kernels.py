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
count. Each direction has several layouts of the same arithmetic onto
threads (:func:`resample_route`, :func:`resample_backward_route`): every
one is a kernel of its ``.cu`` file. ``frames``: the image holds one row
per ``frames`` rows of flow and output (output row i reads image row
i // frames), so one image warped into T frames is passed once; its
gradient sums the T frames in the kernel. The image gradient is a scatter
of float atomics, summed in an order that changes from run to run: it
agrees with autograd of the plain version to float32 summation error, not
bit for bit. The flow and mask gradients of the ``vec`` and ``pixel``
backward routes are sums in a fixed order (:func:`resample_backward_plain`
is that order in PyTorch) and repeat bit for bit.
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
                   mask: Optional[torch.Tensor] = None,
                   frames: int = 1) -> torch.Tensor:
    """Plain PyTorch version: the JAX ``_resample_jnp`` math in float32,
    times ``mask`` when given, rounded once to the image dtype. With
    ``frames`` > 1 each image row is repeated ``frames`` times first."""
    from c2m_tpu_torch.ops.warp import bilinear_sample
    if frames != 1:
        image = image.repeat_interleave(frames, dim=0)
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


# The backward's routes and the number csrc/resample_bwd.cu knows each by.
BACKWARD_ROUTES = {"vec": 1, "pixel": 2, "scalar64": 3}
# channels of a lane's piece on the backward's vec route: 4 float32 values
# of image gradient, one float4 atomic
BACKWARD_PIECE = 4


def resample_backward_route(dtype: torch.dtype, shape,
                            aligned: bool = True) -> str:
    """Which kernel of ``csrc/resample_bwd.cu`` the backward launches for an
    upstream gradient of ``dtype`` and ``shape`` [B, H, W, C] (B counts
    frames, as the flow does) on the card. ``aligned``: the upstream
    gradient, the image and the flow start on 16-byte boundaries.

    - ``vec``: C % 4 == 0: a lane owns pieces of 4 channels (8 bytes of
      bfloat16 or 16 of float32 read, one float4 atomic a tap), a group
      of :func:`backward_lane_group` lanes a pixel;
    - ``pixel``: up to 3 channels: a lane owns a pixel;
    - ``scalar64``: everything else (C above 3 that 4 does not divide,
      unaligned views, 2^31 pixels of the tensor or elements of an image
      and more): the first version, a thread per element with 64-bit
      indices.
    Never the plain version: that is for CPU tensors only.
    """
    b, h, w, c = shape
    if aligned and b * h * w < _INT32 and h * w * c < _INT32:
        if c % BACKWARD_PIECE == 0:
            return "vec"
        if c < BACKWARD_PIECE:
            return "pixel"
    return "scalar64"


def backward_lane_group(c: int, route: str):
    """(channels a lane takes at a time, lanes that share a pixel) on the
    ``vec`` and ``pixel`` backward routes where the flow or mask gradient
    is taken: a piece of 4 channels and min(C / 4, 32) lanes rounded up to
    a power of two, or the whole pixel and one lane."""
    if route != "vec":
        return c, 1
    lanes = 1
    while lanes < c // BACKWARD_PIECE and lanes < 32:
        lanes *= 2
    return BACKWARD_PIECE, lanes


def resample_backward_plain(grad_out: torch.Tensor, image: torch.Tensor,
                            flow: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            frames: int = 1, needs=(True, True, True),
                            route: Optional[str] = None):
    """The ``vec`` and ``pixel`` backward routes as they decompose the work,
    in PyTorch: the image gradient as four per-tap ``index_add_`` into a
    float32 image (the T frames of an image land on the same rows), cast
    once to the image dtype; the flow and mask gradients as per-pixel sums
    over the channels in the kernel's order: each lane of the pixel's group
    adds its pieces in order (piece k of lane l holds channels
    (k * lanes + l) * n ...), then the group halves its lanes pairwise, as
    xor shuffles do. Returns (image, flow, mask) gradients, None where not
    in ``needs``. ``route`` defaults to the one the card would take."""
    bi, h, w, c = image.shape
    b = bi * frames
    dev = image.device
    if route is None:
        route = resample_backward_route(image.dtype, (b, h, w, c))
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    wf = w / max(w - 1.0, 1e-6)
    hf = h / max(h - 1.0, 1e-6)
    sx = (xs[None, None, :] + flow[..., 0].float()) * wf - 0.5
    sy = (ys[None, :, None] + flow[..., 1].float()) * hf - 0.5
    in_x = (sx >= 0.0) & (sx <= w - 1.0)
    in_y = (sy >= 0.0) & (sy <= h - 1.0)
    sx, sy = sx.clamp(0.0, w - 1.0), sy.clamp(0.0, h - 1.0)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    row = torch.arange(b, device=dev) // frames
    p00 = (row[:, None, None] * h + y0) * w + x0           # pixel of the image
    dx = (x0 + 1 < w).long()
    dy = (y0 + 1 < h).long() * w
    taps = (p00, p00 + dx, p00 + dy, p00 + dy + dx)
    g = grad_out.float()
    gm = g * mask.float() if mask is not None else g
    g_image = g_flow = g_mask = None
    if needs[0]:
        gt, gb = gm * (1.0 - wy), gm * wy
        acc = torch.zeros(bi * h * w, c, dtype=torch.float32, device=dev)
        for idx, val in zip(taps, (gt * (1.0 - wx), gt * wx, gb * (1.0 - wx),
                                   gb * wx)):
            acc.index_add_(0, idx.reshape(-1), val.reshape(-1, c))
        g_image = acc.reshape(image.shape).to(image.dtype)
    if needs[1] or (needs[2] and mask is not None):
        flat = image.float().reshape(bi * h * w, c)
        v00, v10, v01, v11 = (flat[i] for i in taps)
        n, lanes = backward_lane_group(c, route)

        def lane_sum(terms):
            pieces = -(-c // n)
            k = -(-pieces // lanes)
            t = torch.zeros(b * h * w, k * lanes * n, device=dev)
            t[:, :c] = terms.reshape(-1, c)
            t = t.reshape(-1, k, lanes, n)
            acc = torch.zeros(t.shape[0], lanes, device=dev)
            for j in range(k):
                for i in range(n):
                    acc = acc + t[:, j, :, i]
            while acc.shape[1] > 1:
                half = acc.shape[1] // 2
                acc = acc[:, :half] + acc[:, half:]
            return acc.reshape(b, h, w)

        zero = torch.zeros((), device=dev)
        if needs[1]:
            tx = gm * ((v10 - v00) * (1.0 - wy) + (v11 - v01) * wy)
            ty = gm * ((v01 - v00) * (1.0 - wx) + (v11 - v10) * wx)
            g_flow = torch.stack([
                torch.where(in_x, lane_sum(tx), zero) * wf,
                torch.where(in_y, lane_sum(ty), zero) * hf], dim=-1)
        if needs[2] and mask is not None:
            top = v00 * (1.0 - wx) + v10 * wx
            bot = v01 * (1.0 - wx) + v11 * wx
            g_mask = lane_sum(g * (top * (1.0 - wy) + bot * wy))[..., None]
    return g_image, g_flow, g_mask


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


def _check_inputs(image, flow, mask, frames=1):
    """[B, H, W, C] of the output (B = the image's rows x frames), or
    ValueError saying which input the kernels do not take. The messages are
    made only when a check fails: this runs before every launch."""
    req = hopper.require
    req(image.dim() == 4,
        lambda: f"image must be [B,H,W,C], got {tuple(image.shape)}")
    req(isinstance(frames, int) and frames >= 1,
        lambda: f"frames must be a positive int, got {frames!r}")
    bi, h, w, c = image.shape
    b = bi * frames
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


def _launch(image, flow, mask, frames: int = 1, route: Optional[str] = None):
    """The forward on the card. ``route`` overrides :func:`resample_route`,
    to test a route by name; a route that does not take the shape makes the
    launch fail, and that raises."""
    b, h, w, c = _check_inputs(image, flow, mask, frames)
    out = torch.empty((b, h, w, c), dtype=image.dtype, device=image.device)
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
        b, h, w, c, frames, int(mask is not None), ROUTES[route],
        hopper.stream_ptr(image))
    hopper.check(err, fn)
    kernel.launches += 1
    return out


def _launch_backward(grad_out, image, flow, mask, need_image, need_flow,
                     need_mask, frames: int = 1, route: Optional[str] = None):
    """The gradients that were asked for (None for the others). The image
    gradient is accumulated in a zeroed float32 buffer of the image's shape
    and cast once to the image dtype; the flow and mask gradients are
    stored, not accumulated, except on the ``scalar64`` route (zeroed
    buffers, atomics). ``route`` overrides
    :func:`resample_backward_route`, to test a route by name."""
    b, h, w, c = _check_inputs(image, flow, mask, frames)
    hopper.require(grad_out.shape == (b, h, w, c)
                   and grad_out.dtype == image.dtype
                   and grad_out.device == image.device,
                   "grad_out must match the output in shape, dtype and device")
    grad_out = grad_out.contiguous()
    need_mask = need_mask and mask is not None
    if route is None:
        aligned = (grad_out.data_ptr() | image.data_ptr()
                   | flow.data_ptr()) % 16 == 0
        route = resample_backward_route(image.dtype, (b, h, w, c), aligned)
    dev = image.device
    stored = torch.zeros if route == "scalar64" else torch.empty
    g_image = (torch.zeros(image.shape, dtype=torch.float32, device=dev)
               if need_image else None)
    g_flow = stored(flow.shape, dtype=torch.float32, device=dev) \
        if need_flow else None
    g_mask = stored(mask.shape, dtype=torch.float32, device=dev) \
        if need_mask else None
    if grad_out.numel() and (need_image or need_flow or need_mask):
        kernel, fn = ((RESAMPLE_BWD_F32, "c2m_resample_bwd_f32")
                      if image.dtype == torch.float32
                      else (RESAMPLE_BWD_BF16, "c2m_resample_bwd_bf16"))

        def ptr(t):
            return t.data_ptr() if t is not None else None

        err = getattr(hopper.library(), fn)(
            grad_out.data_ptr(), image.data_ptr(), flow.data_ptr(), ptr(mask),
            ptr(g_image), ptr(g_flow), ptr(g_mask), b, h, w, c, frames,
            int(mask is not None), int(need_image), int(need_flow),
            int(need_mask), BACKWARD_ROUTES[route], hopper.stream_ptr(image))
        hopper.check(err, fn)
        kernel.launches += 1
    if g_image is not None:
        g_image = g_image.to(image.dtype)
    return g_image, g_flow, g_mask


class _ResampleCuda(torch.autograd.Function):
    """K1 on the card: forward and backward are the hand-written kernels.
    Saves image, flow and mask (not the taps)."""

    @staticmethod
    def forward(ctx, image, flow, mask, frames):
        ctx.save_for_backward(image, flow, mask)
        ctx.frames = frames
        return _launch(image, flow, mask, frames)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        image, flow, mask = ctx.saved_tensors
        return (*_launch_backward(grad_out, image, flow, mask,
                                  *ctx.needs_input_grad[:3], ctx.frames),
                None)


def _dispatch(image, flow, mask, frames):
    if image.device.type == "cpu":
        return resample_plain(image, flow, mask, frames)
    if image.device.type != "cuda":
        raise ValueError(f"resample: no kernel for device {image.device}")
    if torch.is_grad_enabled() and (
            image.requires_grad or flow.requires_grad
            or (mask is not None and mask.requires_grad)):
        return _ResampleCuda.apply(image, flow, mask, frames)
    return _launch(image, flow, mask, frames)   # serving: nothing to record


def resample(image: torch.Tensor, flow: torch.Tensor,
             frames: int = 1) -> torch.Tensor:
    """image [B,H,W,C] f32/bf16, flow [B*frames,H,W,2] f32 -> warped
    [B*frames,H,W,C]: output row i samples image row i // frames."""
    return _dispatch(image, flow, None, frames)


def resample_masked(image: torch.Tensor, flow: torch.Tensor,
                    mask: torch.Tensor, frames: int = 1) -> torch.Tensor:
    """``resample(image, flow, frames) * mask`` with mask
    [B*frames,H,W,1] f32, one pass."""
    return _dispatch(image, flow, mask, frames)
