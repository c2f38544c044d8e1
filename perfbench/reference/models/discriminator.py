# Frozen copy of c2m_tpu_torch/models/discriminator.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""PatchGAN discriminators (port of ``c2m_tpu/models/discriminator.py``).

``PatchDiscriminator``: ``n_layers_D`` blocks of (pad 1, conv 4x4 stride 2,
BatchNorm, leaky 0.2) and a spectral-norm 1x1 prediction head; it returns
every intermediate feature map (for feature matching) and the prediction
map in float32. ``MultiScaleDiscriminator`` wraps ``num_D`` of them (1 in
the shipped config). Init as the reference's ``weights_init``: conv weights
normal(0, 0.02) with zero bias, BatchNorm weight normal(1, 0.02); the head
keeps the default conv init.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from perfbench.reference.config import DiscriminatorParams
from perfbench.reference.nn.layers import BatchNorm, Conv, SpectralNormConv, leaky


class DiscDownBlock(nn.Module):
    """pad + conv(4, stride 2) + BatchNorm + leaky, DCGAN init. In the JAX
    tree its conv and norm are bare flax modules (no wrapper level)."""
    JAX_NAMES = {"conv": "Conv_0", "norm": "BatchNorm_0"}

    def __init__(self, in_features: int, features: int, padding_mode: str):
        super().__init__()
        self.conv = Conv(in_features, features, 4, 2, 1, padding_mode)
        self.norm = BatchNorm(features)
        self.conv.jax_bare = self.norm.jax_bare = True
        nn.init.normal_(self.conv.weight, 0.0, 0.02)
        nn.init.zeros_(self.conv.bias)
        nn.init.normal_(self.norm.weight, 1.0, 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky(self.norm(self.conv(x)))


class PatchDiscriminator(nn.Module):
    def __init__(self, p: DiscriminatorParams, in_features: int,
                 max_features: int = 512):
        super().__init__()
        self.n_layers = p.n_layers_D
        prev = in_features
        for i in range(p.n_layers_D):
            f = min(max_features, p.ndf * (2 ** (i + 1)))
            self.add_module(f"down_{i}", DiscDownBlock(prev, f, p.padding_mode))
            prev = f
        self.pred = SpectralNormConv(prev, 1, kernel_size=1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feature_maps = []
        out = x
        for i in range(self.n_layers):
            out = getattr(self, f"down_{i}")(out)
            feature_maps.append(out)
        return feature_maps, self.pred(out).float()


class MultiScaleDiscriminator(nn.Module):
    """x [B, H, W, C] -> {feature_maps_{s}: list, prediction_map_{s}:
    [B, h, w, 1] float32} for each of the ``num_D`` discriminators."""

    def __init__(self, p: DiscriminatorParams, in_features: int):
        super().__init__()
        self.num_d = p.num_D
        for scale in range(p.num_D):
            self.add_module(f"disc_{scale}", PatchDiscriminator(p, in_features))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for scale in range(self.num_d):
            fmaps, pred = getattr(self, f"disc_{scale}")(x)
            out[f"feature_maps_{scale}"] = fmaps
            out[f"prediction_map_{scale}"] = pred
        return out
