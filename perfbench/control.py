#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card at the cell's own size,
in one process: the program's compared numbers over many seeds (the lower
readings), the precision control's (the upper), and for a train cell the
fault of a half batch. The benchmark's own runs never run this.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 2] [--control 3] [--faults 3] [--out FILE]

``--control n`` / ``--faults n``: the first n seeds also read the control
/ the faults. Every seed prints one JSON line (and appends it to
``--out``):
- ``program``: the timed path's numbers (a short window at the cell's
  load, then the reference), as ``run.py`` computes them;
- ``control.tf32`` and ``control.bfloat16``: the reference put in the
  program's place, computed one precision step below the configuration's
  float32 with TF32 off (TF32 on), and a step below that (the conv stacks
  in bfloat16, the port's own lower path), against the float32 reference;
- ``half_batch`` (train cells of batch 2 or more): the reference stepping
  on the first half of each batch's rows, the mean taken over them;
- a state left unchanged reads 1 on ``train_change_gap`` by its
  definition and needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


CONTROLS = ("tf32", "bfloat16")


def half_batch(step):
    """The step on the first half of the batch's rows (rounded up)."""
    def faulty(state, batch, eps, click):
        keep = batch["video"].shape[0] - batch["video"].shape[0] // 2
        return step(state, {k: v[:keep] for k, v in batch.items()},
                    eps[:keep], click[:keep])
    return faulty


def readings(cell, seed: int, seconds: float, control: bool,
             faults: bool, device="cuda") -> dict:
    from perfbench import compare, harness
    kind = harness.traffic_kind(cell["traffic"])
    run = kind.Cell(cell, seed, device)
    t0 = time.perf_counter()
    run.setup()
    start = run.window(seconds, False)
    e2e = run.end_to_end(start)
    run.release()
    out = {"seed": seed, "program": run.check(),
           "e2e": {k: v[0] for k, v in e2e.items()},
           "setup_and_window_s": time.perf_counter() - t0}
    if getattr(run, "worst", None):
        out["worst"] = run.worst
    if getattr(run, "output_gaps", None):
        out["output_gaps"] = run.output_gaps
    if run.kind == "serve":
        if control:
            for name in CONTROLS:
                run.control_outputs(name)
                out[f"control.{name}"] = run.check()
                out[f"control.{name}_output_gaps"] = run.output_gaps
    else:
        if control:
            for name in CONTROLS:
                numbers, worst = compare.train_numbers(
                    run.reference_readings(control=name), run.reference)
                out[f"control.{name}"] = numbers
                out[f"control.{name}_worst"] = worst
        if faults and run.batch > 1:
            numbers, worst = compare.train_numbers(
                run.reference_readings(fault=half_batch), run.reference)
            out["half_batch"], out["half_batch_worst"] = numbers, worst
    out["total_s"] = time.perf_counter() - t0
    del run
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from perfbench import harness
    harness.set_environment(ROOT)
    harness.require_cards(1)
    harness.one_thread()
    cell = harness.workload(args.workload)
    harness.program_precision(cell)
    print("card:", harness.power_limit(), flush=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, **readings(
            cell, seed, args.seconds, i < args.control, i < args.faults)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
