#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is ``perfbench/workloads/<cell>.json``;
its configuration ``perfbench/configs/<config>.json``; its traffic kind
``perfbench/traffic/<kind>.py``; with ``--trace 1`` every reader in
``perfbench/metrics/`` is asked for its per-layer metric. The last line
on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; the compared numbers last, under ``checks``); the compared
numbers beside their limits are the last lines on standard error.

Exit codes: 0 a result was printed; 2 an unknown cell or a bad argument;
3 fewer cards than the cell needs (no result); 4 a forbidden module (JAX,
the JAX package) was loaded by the end of the window (no result).
"""

import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    import os
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, require_card: bool = True, device: str = "cuda",
         base: str = HERE, prepare=None) -> int:
    """One run. ``require_card=False`` and ``device="cpu"`` skip the look
    for a card (the CPU tests); ``prepare(run)`` may alter the cell's run
    object after it is made (the tests plant faults that way)."""
    args = parse(argv)
    from perfbench import harness
    harness.set_environment(ROOT)
    try:
        cell = harness.workload(args.workload, base)
        kind = harness.traffic_kind(cell["traffic"], base)
    except KeyError as e:
        print(f"perfbench: {e.args[0]}", file=sys.stderr)
        return 2
    if require_card:
        try:
            harness.require_cards(int(cell.get("chips", 1)))
        except harness.NoCard as e:
            print(f"perfbench: no result: {e}", file=sys.stderr)
            return 3
    readers = harness.metric_readers(base) if args.trace else {}
    harness.one_thread()
    harness.program_precision(cell)

    run = kind.Cell(cell, args.seed, device)
    if prepare is not None:
        prepare(run)
    t_setup = time.perf_counter()
    run.setup()
    print(f"setup s: before {t_setup - _T0 + _AGE0:.3f} "
          f"{getattr(run, 'setup_marks', {})}", file=sys.stderr)
    start = run.window(args.seconds, bool(args.trace))
    setup_s = (start - _T0) + _AGE0
    e2e = run.end_to_end(start)
    run.release()
    numbers = run.check()

    checks = [harness.Check(name, float(numbers[name]), float(limit))
              for name, limit in sorted(cell["limits"].items())]
    for name in sorted(set(numbers) - set(cell["limits"])):
        print(f"reading {name} {numbers[name]!r} (not compared)",
              file=sys.stderr)
    for what, where in sorted(getattr(run, "worst", {}).items()):
        print(f"worst {what}: {where}", file=sys.stderr)
    ends = getattr(run, "step_ends", None)
    if ends:
        steps = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
        print(f"step ms: median {1e3 * sorted(steps)[len(steps) // 2]:.1f} "
              f"over {len(steps)}: {[round(1e3 * x) for x in steps]}",
              file=sys.stderr)
    if getattr(run, "records", None):
        print(f"request ms over {len(run.records)}: "
              f"{[(r[0], round(1e3 * r[2])) for r in run.records]}",
              file=sys.stderr)
    if getattr(run, "output_gaps", None):
        print(f"output gaps: {run.output_gaps}", file=sys.stderr)

    if args.trace:
        metrics = {}
        for name, (read, unit) in readers.items():
            value = read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {name: {"value": value, "unit": unit}
                   for name, (value, unit) in e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    if device == "cuda":
        info = harness.device_info(run.trace if args.trace else None)
        card = harness.power_limit()
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
        card = None
    info["memory_peak_bytes"] = int(run.memory_peak)
    attempted = len(run.records) if hasattr(run, "records") else run.steps
    result = {
        "correct": all(c.ok for c in checks) and run.failed == 0,
        "attempted": attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": info,
        "card": card,
        "setup_s": setup_s,
    }
    if args.trace and run.trace is not None:
        from perfbench import tracing
        result["breakdown"] = {
            "device_ops": tracing.top_device_ops(run.trace),
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps[:10]]}
    forbidden = harness.forbidden_loaded()
    if forbidden:
        print(f"perfbench: no result: the run loaded {forbidden}",
              file=sys.stderr)
        return 4
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
