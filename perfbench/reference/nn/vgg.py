# Frozen copy of c2m_tpu_torch/nn/vgg.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""VGG19 feature extractor for the perceptual loss (port of
``c2m_tpu/nn/vgg.py``).

The torchvision vgg19 ``features`` trunk tapped after every ReLU: the
perceptual loss reads relu{1..5}_1, the (off by default) style loss
relu2_2 / relu3_4 / relu4_4 / relu5_2. The extractor ImageNet-normalizes its
input itself, as the reference's wrapper does. Its parameters are frozen
(``requires_grad=False``).

Pretrained weights come from a local npz (``VGG19_WEIGHTS`` or
``weights_path``) in the layout ``tools/convert_vgg.py`` writes:
``conv{s}_{i}.kernel`` [kh, kw, in, out] and ``conv{s}_{i}.bias``. Without
one the extractor keeps torch-default random weights: the loss is then still
a multi-scale feature matcher.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.nn.layers import Conv

# (out_channels, n_convs) per stage of VGG19
_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))

# taps returned, in forward order
TAPS = tuple(f"relu{s}_{i}" for s, (_, n) in enumerate(_STAGES, 1)
             for i in range(1, n + 1))

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class Vgg19Features(nn.Module):
    """x [B, H, W, 3] in [0, 1] -> {relu{s}_{i}: feature map} (NHWC)."""

    def __init__(self, normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        prev = 3
        for stage, (ch, n_convs) in enumerate(_STAGES, start=1):
            for i in range(1, n_convs + 1):
                self.add_module(f"conv{stage}_{i}", Conv(prev, ch, 3, 1, 1,
                                                         "zeros"))
                prev = ch
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.normalize:
            mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
            std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
            x = (x - mean) / std
        taps = {}
        for stage, (_, n_convs) in enumerate(_STAGES, start=1):
            for i in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"conv{stage}_{i}")(x))
                taps[f"relu{stage}_{i}"] = x
            if stage < len(_STAGES):
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return taps


def load_vgg19_params(weights_path: Optional[str] = None
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """Converted torchvision VGG19 weights from the npz as a state_dict of
    :class:`Vgg19Features`, or None when no file is given or found."""
    path = weights_path or os.environ.get("VGG19_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    state = {}
    with np.load(path) as data:
        for stage, (_, n_convs) in enumerate(_STAGES, start=1):
            for i in range(1, n_convs + 1):
                name = f"conv{stage}_{i}"
                kernel = torch.from_numpy(np.asarray(data[f"{name}.kernel"],
                                                     np.float32))
                state[f"{name}.weight"] = kernel.permute(3, 2, 0, 1).contiguous()
                state[f"{name}.bias"] = torch.from_numpy(
                    np.asarray(data[f"{name}.bias"], np.float32))
    return state
