#!/usr/bin/env python3
"""Time kernels K2, K3 and K5 of this checkout against the same kernels of an
older checkout, in turns on one NVIDIA GPU.

    git archive <commit> c2m_tpu_torch/csrc | tar -x -C _archive/parent
    python3 kernel_ab.py _archive/parent [k2] [k3] [k5]   # default: all three

Each older source (``c2m_tpu_torch/csrc/maskwarp.cu`` for K2,
``maskwarp_banded.cu`` for K3, ``correlation.cu`` for K5) is compiled alone
(nvcc, the port's flags, one nvcc per source, all started together) into a
library of its own and called through its C entry point as the first
versions' wrappers called it; this checkout's kernels run through their
wrappers (``ops/hopper/``). On the same inputs it prints, for both, the
agreement (K2 and K3 equal bit for bit, K5 within chip_smoke.TOL_CORR) and
the device time of one call alone (a CUDA graph of 20 calls, wrapper work
included) in turns old, new, new, old; for K3 also the device time of each
pass (torch.profiler). Shapes: K2 at the journal request and step
([12 / 3,16,5,128,256], ``chip_smoke.maskwarp_inputs``) and on image-wide
objects ([3,16,5,128,256]); K3 at the long-horizon maps
(``chip_smoke.banded_inputs``: B = 4 and 1, 24 nodes, 10 frames, 512x1024,
GNN-like and GT-like thetas); K5 at FlowNetC's on-the-fly map
[30,16,32,256] and at [2,64,128,256] (max displacement 20, stride 2). One
JSON object per shape goes to stdout. Exits non-zero without a card.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_INT_MAX = 2 ** 31 - 1

# kernel -> (older source, {entry point: C signature})
OLD = {
    "k2": ("maskwarp.cu", {"c2m_warp_masks_winner": [_P] * 5 + [_L] * 5
                           + [_F, _P]}),
    "k3": ("maskwarp_banded.cu", {"c2m_warp_masks_banded": [_P] * 6
                                  + [_L] * 5 + [_F, _P]}),
    "k5": ("correlation.cu", {
        name: [_P] * 3 + [_L] * 4 + [_I, _I, _P]
        for name in ("c2m_correlation_f32", "c2m_correlation_bf16")}),
}


def load_old(tree: str, kernels) -> dict:
    """The older tree's sources of ``kernels``, each compiled alone into a
    library of its own."""
    from c2m_tpu_torch.ops import hopper
    out_dir = tempfile.mkdtemp()
    procs = {}
    for k in kernels:
        src = os.path.join(tree, "c2m_tpu_torch", "csrc", OLD[k][0])
        out = os.path.join(out_dir, f"libold_{k}.so")
        procs[k] = (out, subprocess.Popen(
            [hopper._nvcc(), *hopper.NVCC_FLAGS, "-shared", "-o", out, src]))
    libs = {}
    for k, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the older {OLD[k][0]}")
        lib = ctypes.CDLL(out)
        for name, argtypes in OLD[k][1].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[k] = lib
    return libs


def old_k2(lib, instance, inst_ids, valid, thetas):
    """The older wrapper's work: checks and casts, one call."""
    from c2m_tpu_torch.ops import hopper
    from c2m_tpu_torch.ops.hopper import maskwarp_kernel as mk
    ids, valid_i, winner = mk.check_and_allocate(instance, inst_ids, valid,
                                                 thetas)
    b, t, h, w = winner.shape
    err = lib.c2m_warp_masks_winner(
        instance.data_ptr(), ids.data_ptr(), valid_i.data_ptr(),
        thetas.data_ptr(), winner.data_ptr(), b, thetas.shape[1], t, h, w,
        1.0 - mk.INTERIOR_EPS, hopper.stream_ptr(instance))
    hopper.check(err, "old c2m_warp_masks_winner")
    return winner


def old_k3(lib, instance, inst_ids, valid, thetas):
    """The older wrapper's work: checks and casts, the INT_MAX boxes, one
    call."""
    from c2m_tpu_torch.ops import hopper
    from c2m_tpu_torch.ops.hopper import maskwarp_kernel as mk
    ids, valid_i, winner = mk.check_and_allocate(instance, inst_ids, valid,
                                                 thetas)
    b, t, h, w = winner.shape
    n = thetas.shape[1]
    boxes = torch.full((b, n, 4), _INT_MAX, dtype=torch.int32,
                       device=instance.device)
    err = lib.c2m_warp_masks_banded(
        instance.data_ptr(), ids.data_ptr(), valid_i.data_ptr(),
        thetas.data_ptr(), boxes.data_ptr(), winner.data_ptr(), b, n, t, h, w,
        1.0 - mk.INTERIOR_EPS, hopper.stream_ptr(instance))
    hopper.check(err, "old c2m_warp_masks_banded")
    return winner


def old_k5(lib, a, b, md, stride):
    """The older wrapper's work: one float32 call into a new output."""
    from c2m_tpu_torch.ops import hopper
    bsz, h, w, c = a.shape
    d = 2 * (md // stride) + 1
    out = torch.empty(bsz, h, w, d * d, dtype=torch.float32, device=a.device)
    err = lib.c2m_correlation_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  bsz, h, w, c, md, stride,
                                  hopper.stream_ptr(a))
    hopper.check(err, "old c2m_correlation_f32")
    return out


def in_turns(old, new) -> dict:
    """Device time alone of one call, old, new, new, old."""
    turns = [cs.device_ms(old), cs.device_ms(new), cs.device_ms(new),
             cs.device_ms(old)]
    return {"old_device_ms": (turns[0] + turns[3]) / 2,
            "new_device_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}


def ab_k2(lib, dev, smi):
    from c2m_tpu_torch.ops.hopper import maskwarp_kernel as mk
    for b, kind in ((12, "journal"), (3, "journal"), (3, "wide")):
        args = (cs.maskwarp_inputs(b, dev) if kind == "journal"
                else cs.banded_inputs(b, "wide", dev, 16, 5, 128, 256))
        old = lambda: old_k2(lib, *args)                        # noqa: E731
        new = lambda: mk.warp_masks_winner(*args)               # noqa: E731
        cs.check(torch.equal(old(), new()), f"K2 {kind} B={b}: winners differ")
        bd = cs.k2_bound(args, mk.warp_masks_winner_plain(*args))
        cs.log(json.dumps({"kernel": "K2", "shape": [b, 16, 5, 128, 256],
                           "objects": kind, **in_turns(old, new), **bd,
                           "max_abs_err": 0, "device": smi}))


def ab_k3(lib, dev, smi):
    from c2m_tpu_torch.ops.hopper import maskwarp_banded as mb
    for b, kind in ((4, "gnn"), (1, "gnn"), (4, "gt"), (1, "gt")):
        args = cs.banded_inputs(b, kind, dev)
        old = lambda: old_k3(lib, *args)                        # noqa: E731
        new = lambda: mb.warp_masks_winner_banded(*args)        # noqa: E731
        cs.check(torch.equal(old(), new()), f"{kind} B={b}: winners differ")
        row = {
            "kernel": "K3", "shape": [b, 24, 10, 512, 1024], "thetas": kind,
            **in_turns(old, new),
            "old_passes_ms": cs.kernel_split(old, {
                "fill": "Fill", "boxes": "node_boxes",
                "tiles": "warp_masks_banded_kernel"}),
            "new_passes_ms": cs.kernel_split(new, {
                "memsets": "Memset", "boxes": "node_boxes",
                "tiles": "warp_masks_tiles"}),
            "device": smi}
        cs.log(json.dumps(row))


def ab_k5(lib, dev, smi):
    from c2m_tpu_torch.ops.hopper import correlation_kernel as ck
    g = torch.Generator().manual_seed(cs.SEED)
    md, stride = 20, 2
    for shape in ((30, 16, 32, 256), (2, 64, 128, 256)):
        a = torch.randn(shape, generator=g).to(dev)
        b = torch.randn(shape, generator=g).to(dev)
        old = lambda: old_k5(lib, a, b, md, stride)             # noqa: E731
        new = lambda: ck.correlation(a, b, md, stride)          # noqa: E731
        err = (old() - new()).abs().max().item()
        cs.check(err <= cs.TOL_CORR, f"K5 {list(shape)}: old vs new {err}")
        cs.log(json.dumps({"kernel": "K5", "shape": list(shape),
                           **in_turns(old, new), "max_abs_err": err,
                           "device": smi}))


def main() -> int:
    kernels = sys.argv[2:] or sorted(OLD)
    if (not torch.cuda.is_available() or len(sys.argv) < 2
            or not set(kernels) <= set(OLD)):
        print("usage: kernel_ab.py OLD_TREE [k2] [k3] [k5] (needs one CUDA "
              "device)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(smi)
    libs = load_old(sys.argv[1], kernels)
    for k in kernels:
        {"k2": ab_k2, "k3": ab_k3, "k5": ab_k5}[k](libs[k], dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
