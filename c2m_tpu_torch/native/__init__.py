"""ctypes bindings for the region-overlap library of the tracker benchmark:
the port of ``c2m_tpu/native/__init__.py``, over its own copy of
``region.cc``.

The library is compiled with g++ (``$CXX`` where set) at first use into the
port's build directory (``c2m_tpu_torch/_build``, listed in .gitignore;
``C2M_TORCH_BUILD_DIR`` overrides it), named after a hash of the source so
that an edit rebuilds it. No binary is committed. A failed build raises
with the compiler's message: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from c2m_tpu_torch.ops.hopper import build_dir

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "region.cc")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_D = ctypes.c_double
_DP = ctypes.POINTER(ctypes.c_double)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir(),
                        f"libc2m_region_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile region.cc into the hashed .so unless it already exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX): the region "
                           "library is built from c2m_tpu_torch/native/"
                           "region.cc at first use")
    os.makedirs(build_dir(), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", lib, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stderr}")
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.c2m_rect_iou.restype = _D
            lib.c2m_rect_iou.argtypes = [_D] * 8
            lib.c2m_polygon_iou.restype = _D
            lib.c2m_polygon_iou.argtypes = [_DP, ctypes.c_int, _DP,
                                            ctypes.c_int]
            lib.c2m_rect_iou_matrix.restype = None
            lib.c2m_rect_iou_matrix.argtypes = [_DP, ctypes.c_int, _DP,
                                                ctypes.c_int, _DP]
            _lib = lib
        return _lib


def _rows(a, width: int, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"{what}: expected [n, {width}], got {a.shape}")
    return a


def rect_iou(a, b) -> float:
    """IoU of two (x, y, w, h) rects."""
    return library().c2m_rect_iou(*map(float, a), *map(float, b))


def rect_iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """[n1, 4] x [n2, 4] (x, y, w, h) -> [n1, n2] IoU matrix."""
    boxes1 = _rows(boxes1, 4, "boxes1")
    boxes2 = _rows(boxes2, 4, "boxes2")
    out = np.zeros((len(boxes1), len(boxes2)), np.float64)
    library().c2m_rect_iou_matrix(
        boxes1.ctypes.data_as(_DP), len(boxes1),
        boxes2.ctypes.data_as(_DP), len(boxes2), out.ctypes.data_as(_DP))
    return out


def polygon_iou(poly1: np.ndarray, poly2: np.ndarray) -> float:
    """IoU of two convex polygons, [n, 2] vertex arrays."""
    poly1 = _rows(poly1, 2, "poly1")
    poly2 = _rows(poly2, 2, "poly2")
    return library().c2m_polygon_iou(poly1.ctypes.data_as(_DP), len(poly1),
                                     poly2.ctypes.data_as(_DP), len(poly2))
