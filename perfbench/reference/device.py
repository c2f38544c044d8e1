# Frozen copy of c2m_tpu_torch/device.py at commit ef9a2dc, imports rewired to
# perfbench.reference (see perfbench/reference/__init__.py for what differs).
"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device, or a RuntimeError when there is none
    (an entry point never carries on on the CPU by itself); anything else
    -> ``torch.device(device)``, e.g. ``"cpu"`` as the tests ask."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on an NVIDIA GPU "
                "by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_float32():
    """float32 matmuls and convolutions in full float32 (TF32 off) inside
    the block; the settings before it are restored after it."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
