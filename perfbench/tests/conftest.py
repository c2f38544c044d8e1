"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
and code folders with a tiny configuration and a tiny cell of each
traffic kind beside the real ones."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PERFBENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def tiny_config() -> dict:
    """The journal config at 64x128 with shrunk widths, 4 objects, float32
    (the CPU computes no bfloat16 convolutions worth comparing)."""
    from perfbench.reference.config import shrink_model
    from perfbench.reference.config import tiny_config as tiny
    cfg = shrink_model(tiny(max_objects=4, batch_size=2))
    cfg.train_params.dtype = "float32"
    return cfg.to_dict()


def tiny_cells(real: dict) -> dict:
    """A tiny cell of each traffic kind, with the real cells' limits."""
    serve = dict(real["journal.serve"], config="tiny", buckets=[1, 2],
                 request_sizes=[1, 2], objects=[1, 4], pool_clips=4,
                 warmup_per_size=1, trace_after=1, trace_requests=1,
                 check_within=3, check_requests=2)
    train = dict(real["journal.train"], config="tiny", batch=2,
                 objects=[1, 4], pool_clips=6, trace_after=1, trace_steps=1)
    return {"tiny.serve": serve, "tiny.train": train}


@pytest.fixture
def tiny_base(tmp_path):
    """A copy of perfbench's traffic, metrics, configs and workloads under
    tmp_path, with configs/tiny.json and workloads/tiny.{serve,train}.json
    added; returns its path."""
    base = tmp_path / "perfbench"
    for sub in ("traffic", "metrics", "configs", "workloads"):
        shutil.copytree(os.path.join(PERFBENCH, sub), base / sub)
    real = {f[:-5]: json.load(open(base / "workloads" / f))
            for f in os.listdir(base / "workloads")}
    with open(base / "configs" / "tiny.json", "w") as f:
        json.dump({"source": "tiny test configuration", "reduced": [],
                   "config": tiny_config(),
                   "flops": {"serve_forward_per_clip": 1,
                             "train_step_per_clip": 1}}, f)
    for name, cell in tiny_cells(real).items():
        with open(base / "workloads" / f"{name}.json", "w") as f:
            json.dump(cell, f)
    return str(base)


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


def run_cell(base, name, seed=3_000_000_007, seconds=0.5, trace=0,
             prepare=None, capsys=None):
    """main() of run.py on the CPU; -> (exit code, result dict or None)."""
    from perfbench import run
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], require_card=False,
                  device="cpu", base=base, prepare=prepare)
    result = None
    if capsys is not None:
        lines = capsys.readouterr().out.strip().splitlines()
        result = json.loads(lines[-1]) if lines and rc == 0 else None
    return rc, result
