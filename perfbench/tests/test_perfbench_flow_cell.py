"""The FlowNet2 precompute cell (traffic kind ``flow_closed``) at a tiny
size on the CPU: its configuration at 64x64 with three frames a clip, two
clips a request; traced, correct, with the host reader read and the device
readers absent; and not correct when the timed path's flows are altered."""

import json
import os

import numpy as np
from conftest import run_cell

READERS = ("flow.inference_ms", "flow.inference_host_ms", "flow.output_ms",
           "model.flownet_deconv_ms", "model.flownet_correlation_roofline_pct",
           "model.flownet_warp_roofline_pct")


def tiny_flow_cell(base):
    with open(os.path.join(base, "configs", "journal_flownet2.json")) as f:
        cf = json.load(f)
    for params in ("train_params", "test_params"):
        cf["config"][params]["input_size"] = [64, 64]
    cf["config"]["train_params"]["num_predicted_frames"] = 2
    with open(os.path.join(base, "configs", "tiny_flow.json"), "w") as f:
        json.dump(cf, f)
    with open(os.path.join(base, "workloads",
                           "journal_flownet2.precompute.json")) as f:
        cell = json.load(f)
    cell.update(config="tiny_flow", clips=2, pool_clips=4, warmup_requests=1,
                trace_after=1, trace_requests=1, check_within=3,
                check_requests=2)
    with open(os.path.join(base, "workloads", "tiny.flow.json"), "w") as f:
        json.dump(cell, f)
    return "tiny.flow"


def test_the_cell_runs_traced_and_correct(tiny_base, capsys):
    from c2m_tpu_torch import trace
    trace.clear()
    rc, result = run_cell(tiny_base, tiny_flow_cell(tiny_base), seconds=0.1,
                          trace=1, capsys=capsys)
    trace.clear()
    assert rc == 0 and result["correct"] is True
    assert set(result["checks"]) == {"flow_gap", "flow_occ_gap",
                                     "flow_occ_mean_gap"}
    metrics = result["metrics"]
    assert metrics["flow.inference_host_ms"]["value"] > 0
    for name in READERS:
        if name != "flow.inference_host_ms":
            assert name not in metrics, name


def test_altered_flows_are_not_correct(tiny_base, capsys, monkeypatch):
    from c2m_tpu_torch.tools import precompute_flow
    real = precompute_flow.batch_flows

    def altered(model, frames, nif):
        out = real(model, frames, nif)
        out["fw_of"] = out["fw_of"] * np.float32(1.01)
        return out
    monkeypatch.setattr(precompute_flow, "batch_flows", altered)
    rc, result = run_cell(tiny_base, tiny_flow_cell(tiny_base), seconds=0.1,
                          capsys=capsys)
    assert rc == 0 and result["correct"] is False
