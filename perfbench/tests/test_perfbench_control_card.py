"""On the card, at each cell's own size: the program passes the cell's
limits, and both precision controls (the reference with TF32 on, one
precision step below the configuration's float32 with TF32 off, and with
its conv stacks in bfloat16, in the program's place) fail them, on three
seeds;
a train cell of batch 2 or more also fails them with half of each batch
left out. Skips without a card (decided inside the test).

    python3 -m pytest perfbench/tests -m cuda -q -s
(``-s`` shows each seed's readings as a JSON line.)
"""

import json
import os

import pytest
from conftest import ROOT

SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_control_fails_and_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at full size")
    from perfbench import control, harness
    harness.set_environment(ROOT)
    harness.one_thread()
    cell = harness.workload(workload)
    harness.program_precision(cell)
    limits = cell["limits"]
    for seed in SEEDS:
        r = control.readings(cell, seed, 2.0, True, True)
        print(json.dumps({"workload": workload, **r}))
        assert not fails(r["program"], limits), r
        assert fails(r["control.tf32"], limits), r
        assert fails(r["control.bfloat16"], limits), r
        if "half_batch" in r:
            assert fails(r["half_batch"], limits), r
