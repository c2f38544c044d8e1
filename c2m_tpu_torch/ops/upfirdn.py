"""upfirdn2d and fused bias + activation, StyleGAN2's ops: the port of
``c2m_tpu/ops/upfirdn.py``, plain PyTorch, channels-last as there.

The reference vendors StyleGAN2's upfirdn2d and bias_act CUDA extensions
and never calls them on the C2M path; the port keeps them as utilities, as
the JAX package does. No path of the port reads this module.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad: Sequence[int] = (0, 0)) -> torch.Tensor:
    """x [B, H, W, C]; kernel [kh, kw] FIR filter, separable or not.

    Insert ``up - 1`` zeros between samples, pad both spatial axes by
    ``pad = (before, after)`` (a negative pad crops), convolve with the
    filter, then keep every ``down``-th sample. The convolution is a true
    one: the filter is flipped before the cross-correlation, as in
    StyleGAN2's ``upfirdn2d_native`` and the JAX function."""
    b, h, w, c = x.shape
    pad0, pad1 = pad
    if up > 1:
        z = x.new_zeros((b, h, up, w, up, c))
        z[:, :, 0, :, 0, :] = x
        x = z.reshape(b, h * up, w * up, c)
    p0, p1 = max(pad0, 0), max(pad1, 0)
    x = F.pad(x, (0, 0, p0, p1, p0, p1))
    if pad0 < 0 or pad1 < 0:
        x = x[:, max(-pad0, 0):x.shape[1] - max(-pad1, 0),
              max(-pad0, 0):x.shape[2] - max(-pad1, 0)]
    weight = torch.flip(kernel.to(x.dtype), (0, 1))[None, None]
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.expand(c, 1, -1, -1),
                 groups=c).permute(0, 2, 3, 1)
    if down > 1:
        y = y[:, ::down, ::down]
    return y


_ACTS = {
    "linear": (lambda x: x, 1.0),
    "relu": (torch.relu, 2.0 ** 0.5),
    "lrelu": (lambda x: F.leaky_relu(x, 0.2), 2.0 ** 0.5),
    "tanh": (torch.tanh, 1.0),
    "sigmoid": (torch.sigmoid, 1.0),
}


def bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
             act: str = "linear", gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """x + bias (broadcast over the trailing axes), the activation, times
    ``gain`` (the activation's default gain when None), clipped to
    [-clamp, clamp] when ``clamp`` is given and >= 0."""
    fn, def_gain = _ACTS[act]
    if bias is not None:
        x = x + bias
    x = fn(x) * (gain if gain is not None else def_gain)
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x
