"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

Every ``csrc/*.cu`` file is compiled at first use by nvcc (one nvcc process
per source, all started together) and linked into ONE shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), named
after a hash of the sources so that an edit rebuilds it, and loaded with
ctypes. Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`check` raises on non-zero.

The build directory defaults to ``c2m_tpu_torch/_build`` inside the
checkout (listed in .gitignore); ``C2M_TORCH_BUILD_DIR`` overrides it.
nvcc is looked up as ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin``,
then on ``PATH``.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only install has no nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC",
              # no fused multiply-add contraction: keeps each kernel's
              # float rounding op-for-op equal to its plain version, so the
              # {0,1} thresholds (covered >= 1-eps, mass > 0.5) flip only
              # where summation order differs (splat atomics)
              "-fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points in csrc/ (all return cudaError_t as int)
_SIGNATURES = {
    # img, flow, mask, out, B, H, W, C, frames, masked, route, stream
    "c2m_resample_f32": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _I, _I, _P],
    "c2m_resample_bf16": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _I, _I, _P],
    # grad_out, img, flow, mask, grad_img, grad_flow, grad_mask, B, H, W, C,
    # frames, masked, need_img, need_flow, need_mask, route, stream
    "c2m_resample_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L,
                             _I, _I, _I, _I, _I, _P],
    "c2m_resample_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L,
                              _I, _I, _I, _I, _I, _P],
    # instance, inst_ids, valid, thetas, winner, B, N, T, H, W, thr, stream
    "c2m_warp_masks_winner": [_P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _F, _P],
    # instance, inst_ids, valid, thetas, scratch, winner, B, N, T, H, W, thr,
    # stream
    "c2m_warp_masks_banded": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _F,
                              _P],
    # coords, out, B, H, W, stream
    "c2m_splat": [_P, _P, _L, _L, _L, _P],
    # a, b, out, B, H, W, C, max_displacement, stride, stream
    "c2m_correlation_f32": [_P, _P, _P, _L, _L, _L, _L, _I, _I, _P],
    "c2m_correlation_bf16": [_P, _P, _P, _L, _L, _L, _L, _I, _I, _P],
    # x, out, B, T, H, W, C, kt, kh, kw, st, sh, sw, pt, ph, pw, mt, mh, mw,
    # row0, rows, width, wide, stream
    "c2m_conv_patches_f32": [_P, _P] + [_L] * 14 + [_I] * 3 + [_L, _L, _I, _I,
                                                               _P],
    # grad_patches, out, B, T, H, W, C, kt, kh, kw, st, sh, sw, pt, ph, pw,
    # mt, mh, mw, row0, rows, line0, lines, accumulate, width, stream
    "c2m_conv_patches_adjoint_f32": [_P, _P] + [_L] * 14 + [_I] * 3
    + [_L] * 4 + [_I, _I, _P],
}


@dataclasses.dataclass(eq=False)
class Kernel:
    """One hand-written kernel: where it lives, what TPU kernel it replaces,
    and how many times it was launched (its wrapper adds one per launch)."""
    name: str
    source: str        # path in the repo
    replaces: str      # file:line of the TPU kernel (or what stands for it)
    launches: int = 0


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the Hopper kernels "
                           "are built from c2m_tpu_torch/csrc at first use")
    return found


def build_dir() -> str:
    return os.environ.get("C2M_TORCH_BUILD_DIR",
                          os.path.join(_PKG_DIR, "_build"))


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"libc2m_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the hashed .so unless it already exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(cu, objs)]
        results = [(p.communicate(), p.returncode) for p in procs]
        for src, ((_, err), rc) in zip(cu, results):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {src}:\n{err}")
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:                 # every launch comes through here
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the integer a C entry
    point takes. ``_cuda_getCurrentRawStream`` is private to torch (checked
    on torch 2.11; the code torch.compile generates calls it too): it is what
    ``torch.cuda.current_stream(t.device).cuda_stream`` reads, without
    making a Stream object before every launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require(cond: bool, msg) -> None:
    """ValueError(msg) unless cond; msg may be a callable that makes the
    text, so that a check on every launch formats nothing when it holds."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def all_kernels():
    """Every hand-written kernel's ``Kernel`` record (name, source, the TPU
    kernel it replaces, its launch count)."""
    from c2m_tpu_torch.ops.hopper import (correlation_kernel, maskwarp_banded,
                                          maskwarp_kernel, patches_kernel,
                                          splat_kernel, warp_kernels)
    return (warp_kernels.KERNELS + maskwarp_kernel.KERNELS
            + maskwarp_banded.KERNELS + splat_kernel.KERNELS
            + correlation_kernel.KERNELS + patches_kernel.KERNELS)
