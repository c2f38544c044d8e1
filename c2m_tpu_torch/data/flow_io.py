"""The port's copy of ``c2m_tpu/data/flow_io.py``, held to the original by
``tests/test_torch_data.py``.

Middlebury .flo / .flow optical-flow file IO.

Reference reader: src/utils/utils.py:324-343 (little-endian only; magic float
202021.25, then int32 width/height, then h*w*2 float32 (fx, fy)). The
reference ships no writer (SURVEY.md §3.4 notes the missing precompute
script); ``write_flow`` defines the canonical one.
"""

from __future__ import annotations

import os

import numpy as np

_MAGIC = 202021.25


def read_flow(path: str) -> np.ndarray:
    """Read a .flo/.flow file -> [H, W, 2] float32 (fx, fy) in pixels."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        if data.size != 2 * w * h:
            raise ValueError(f"{path}: truncated flow file")
        return data.reshape(h, w, 2)


def write_flow(path: str, flow: np.ndarray) -> None:
    """Write [H, W, 2] float32 flow to .flo format."""
    assert flow.ndim == 3 and flow.shape[-1] == 2, flow.shape
    h, w = flow.shape[:2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        np.float32(_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)
