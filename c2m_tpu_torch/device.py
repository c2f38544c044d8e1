"""Where the port's entry points run: on the card unless told otherwise."""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping

import numpy as np
import torch

from c2m_tpu_torch import trace


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


def to_host(out: Mapping[str, torch.Tensor],
            device: torch.device) -> Dict[str, np.ndarray]:
    """``out``, tensors on ``device``, as fresh numpy arrays. From the card:
    each into its own page-locked block of PyTorch's caching host
    allocator, every copy queued on ``device``'s current stream, then one
    wait on that stream; the array holds its block, which returns to the
    cache once the caller drops it. On the CPU: ``.numpy()`` as they are.
    Counts ``pinned_bytes`` and ``pageable_bytes`` on the innermost span."""
    pinned = device.type == "cuda"
    if pinned:
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in out.items()}
        for k, v in out.items():
            host[k].copy_(v, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        out = host
    arrays = {k: v.numpy() for k, v in out.items()}
    nbytes = sum(a.nbytes for a in arrays.values())
    trace.count("pinned_bytes", nbytes if pinned else 0)
    trace.count("pageable_bytes", 0 if pinned else nbytes)
    return arrays
