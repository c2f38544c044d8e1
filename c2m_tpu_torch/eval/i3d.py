"""I3D (inflated Inception-V1), the FVD embedding net: the port of
``c2m_tpu/eval/i3d.py`` (reference src/utils/fvd/fvd.py:70-127 drives the
TF-Hub kinetics I3D).

Unit3D = conv3d + BatchNorm(eps 1e-3) + ReLU with TF-SAME padding (``total
// 2`` before, the rest after, on every axis; the stride-2 stem too), the
GoogLeNet channel spec, SAME max pools that pad with -inf. ``"embedding"``
is the 1024-d spatiotemporal mean FVD reads; ``"logits"`` adds the
bias-carrying ``Logits`` conv and its mean. The submodules carry the names
of the public pytorch-i3d checkpoint (``Mixed_3b.b0.conv3d.weight``,
``logits.conv3d.bias``), which ``tools/convert_i3d.py`` reads, so such a
checkpoint loads with ``load_state_dict``; the npz of that tool loads
through ``utils/convert.i3d_from_jax``. Input ``[B, T, H, W, 3]`` in
[-1, 1] (224x224 canonical; the evaluator's T = 5 runs: SAME keeps every
temporal size >= 1), channels last as the JAX module takes it; NCDHW
inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from c2m_tpu_torch.eval.fid import compute_fid


def _same_pad(x, kernel: Sequence[int], stride: Sequence[int],
              value: float = 0.0):
    """TF-SAME padding of the (T, H, W) axes of an NCDHW tensor."""
    pads = []
    for size, k, s in zip(x.shape[2:], kernel, stride):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    flat = [p for pair in reversed(pads) for p in pair]   # W first for F.pad
    return F.pad(x, flat, value=value) if any(flat) else x


def _maxpool3d_same(x, window: Sequence[int], stride: Sequence[int]):
    return F.max_pool3d(_same_pad(x, window, stride, float("-inf")),
                        tuple(window), tuple(stride))


class Unit3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), use_bn: bool = True,
                 act: bool = True):
        super().__init__()
        self.kernel, self.stride, self.act = tuple(kernel), tuple(stride), act
        self.conv3d = nn.Conv3d(in_ch, out_ch, self.kernel, self.stride,
                                bias=not use_bn)
        self.bn = nn.BatchNorm3d(out_ch, eps=1e-3) if use_bn else None

    def forward(self, x):
        x = self.conv3d(_same_pad(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class InceptionModule(nn.Module):
    def __init__(self, in_ch: int, channels: Sequence[int]):
        """channels: (b0, b1a, b1b, b2a, b2b, b3b)."""
        super().__init__()
        c = channels
        self.b0 = Unit3D(in_ch, c[0])
        self.b1a = Unit3D(in_ch, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(in_ch, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(in_ch, c[5])
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x):
        b3 = self.b3b(_maxpool3d_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], 1)


# (name, channels) of the inception modules; a max pool before 4b and 5b
_MIXED = (("Mixed_3b", (64, 96, 128, 16, 32, 32)),
          ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
          ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
          ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
          ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
          ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
          ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5c", (384, 192, 384, 48, 128, 128)))
_POOL_BEFORE = {"Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3d(nn.Module):
    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        ch = 192
        for name, channels in _MIXED:
            setattr(self, name, InceptionModule(ch, channels))
            ch = getattr(self, name).out_channels
        self.logits = Unit3D(ch, num_classes, use_bn=False, act=False)

    def forward(self, x, endpoint: str = "embedding"):
        """x: [B, T, H, W, 3] -> [B, 1024] ("embedding") or [B, classes]
        ("logits")."""
        x = x.permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = _maxpool3d_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _maxpool3d_same(x, (1, 3, 3), (1, 2, 2))
        for name, _ in _MIXED:
            if name in _POOL_BEFORE:
                x = _maxpool3d_same(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        if endpoint == "embedding":
            return x.mean(dim=(2, 3, 4))
        return self.logits(x).mean(dim=(2, 3, 4))


def compute_fvd(real_emb, fake_emb) -> float:
    """Frechet distance over I3D embeddings (fvd/score.py semantics)."""
    return compute_fid(real_emb, fake_emb)


def load_i3d(path: str, device) -> InceptionI3d:
    """The net with the weights of an npz of tools/convert_i3d.py (``params``
    and ``batch_stats``), float32, eval mode, on ``device``."""
    from c2m_tpu_torch.utils.convert import i3d_from_jax, read_variables_npz
    net = InceptionI3d()
    net.load_state_dict(i3d_from_jax(read_variables_npz(path)))
    return net.to(device).eval()
