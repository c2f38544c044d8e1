"""Correlation (cost volume) and channel norm: port of
``c2m_tpu/ops/correlation.py`` (the reference's correlation and channelnorm
CUDA extensions).

FlowNetC's configuration: max_displacement 20, stride 2 -> 21 x 21 = 441
output channels, each the channel mean of feature A at x times feature B at
x + d, zero outside the image; displacement rows scan dy, dx fastest.
"""

from __future__ import annotations

import torch

# kernel K5 on CUDA, its plain version on the CPU
from c2m_tpu_torch.ops.hopper.correlation_kernel import (  # noqa: F401
    correlation)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 norm across channels: [..., C] -> [..., 1]."""
    return torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
