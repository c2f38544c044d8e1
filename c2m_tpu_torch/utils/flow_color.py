"""The port's copy of ``c2m_tpu/utils/flow_color.py``, held to the original by
``tests/test_torch_evaluator.py``.

Middlebury flow colorization (behavioral parity with src/utils/ops.py:21-175).

Standard Baker et al. color wheel: 55 hues over RY/YG/GC/CB/BM/MR arcs;
saturation encodes magnitude (normalized by the per-image max), unknown/large
flows masked to black. Vectorized numpy (the reference loops in python).
"""

from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7


def _make_color_wheel() -> np.ndarray:
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_color(flow: np.ndarray, max_flow: float = None) -> np.ndarray:
    """flow [H, W, 2] -> uint8 RGB [H, W, 3]."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0

    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow is not None else max(rad.max(), 1e-9)
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)

    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        col[unknown] = 0
        img[..., i] = np.floor(255 * col)
    return img


def flow_video_to_color(flows: np.ndarray) -> np.ndarray:
    """[T, H, W, 2] -> [T, H, W, 3] uint8, shared normalization across T."""
    maxrad = max(float(np.sqrt((flows ** 2).sum(-1)).max()), 1e-9)
    return np.stack([flow_to_color(f, max_flow=maxrad) for f in flows])
