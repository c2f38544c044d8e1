#!/usr/bin/env python3
"""Time kernel K3 (the windowed mask warp, csrc/maskwarp_banded.cu) of this
checkout against the K3 of an older checkout, in turns on one NVIDIA GPU.

    git archive <commit> | tar -x -C _archive/parent    # any older tree
    python3 kernel_ab.py _archive/parent

The older tree's ``c2m_tpu_torch/csrc/maskwarp_banded.cu`` is compiled alone
(nvcc, the port's flags) into a library of its own and called as the
first version's wrapper called it: boxes [B, N, 4] int32 filled with
INT_MAX by the caller, then one entry point ``c2m_warp_masks_banded`` that
launches the box pass and one block per (b, t, 16x32 tile). This checkout's K3 runs
through its wrapper (``ops/hopper/maskwarp_banded.py``). On the long-horizon
maps (``chip_smoke.banded_inputs``: B = 4 and 1, 24 nodes, 10 frames,
512x1024, GNN-like and GT-like thetas) it prints, for both: the winner's
agreement (equal bit for bit), the device time of one call alone (a CUDA
graph of 20 calls, wrapper work included) in turns old, new, new, old, and
the device time of each pass (torch.profiler). One JSON object per map goes
to stdout. Exits non-zero without a card. Imports nothing of JAX.
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

_P, _L, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
_INT_MAX = 2 ** 31 - 1


def load_old(tree: str) -> ctypes.CDLL:
    """The older tree's K3 alone, compiled into a library of its own."""
    from c2m_tpu_torch.ops import hopper
    src = os.path.join(tree, "c2m_tpu_torch", "csrc", "maskwarp_banded.cu")
    out = os.path.join(tempfile.mkdtemp(), "libold_k3.so")
    subprocess.run([hopper._nvcc(), *hopper.NVCC_FLAGS, "-shared", "-o", out,
                    src], check=True)
    lib = ctypes.CDLL(out)
    lib.c2m_warp_masks_banded.argtypes = [_P] * 6 + [_L] * 5 + [_F, _P]
    lib.c2m_warp_masks_banded.restype = ctypes.c_int
    return lib


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


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: kernel_ab.py OLD_TREE (needs one CUDA device)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from c2m_tpu_torch.ops.hopper import maskwarp_banded as mb
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(smi)
    lib = load_old(sys.argv[1])
    for b, kind in ((4, "gnn"), (1, "gnn"), (4, "gt"), (1, "gt")):
        args = cs.banded_inputs(b, kind, dev)
        old = lambda: old_k3(lib, *args)                        # noqa: E731
        new = lambda: mb.warp_masks_winner_banded(*args)        # noqa: E731
        cs.check(torch.equal(old(), new()), f"{kind} B={b}: winners differ")
        turns = [cs.device_ms(old), cs.device_ms(new), cs.device_ms(new),
                 cs.device_ms(old)]
        row = {
            "shape": [b, 24, 10, 512, 1024], "thetas": kind,
            "old_device_ms": (turns[0] + turns[3]) / 2,
            "new_device_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
            "old_passes_ms": cs.kernel_split(old, {
                "fill": "Fill", "boxes": "node_boxes",
                "tiles": "warp_masks_banded_kernel"}),
            "new_passes_ms": cs.kernel_split(new, {
                "memsets": "Memset", "boxes": "node_boxes",
                "tiles": "warp_masks_tiles"}),
            "device": smi}
        cs.log(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
