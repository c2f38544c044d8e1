"""run.py finds every configuration, cell, traffic kind and metric reader
by name, refuses an unknown one, and takes a cell added as a file."""

import json
import os

from conftest import PERFBENCH, ROOT, run_cell

from perfbench import harness


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_named_piece_is_found():
    b = bench()
    for config in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, config["file"]))
    for cell in b["workloads"]:
        found = harness.workload(cell["name"])
        assert found["config"] == cell["config"]
        assert found["traffic"] == cell["traffic"]
        assert found["chips"] == cell["chips"]
        kind = harness.traffic_kind(found["traffic"])
        assert hasattr(kind, "Cell")
    readers = harness.metric_readers()
    assert {m["name"] for m in b["per_layer"]} <= set(readers)
    for name, (read, unit) in readers.items():
        assert callable(read) and unit


def test_unknown_names_are_refused(tiny_base, capsys):
    rc, result = run_cell(tiny_base, "no.such.cell", capsys=capsys)
    assert rc == 2 and result is None
    with open(os.path.join(tiny_base, "workloads", "bad.json"), "w") as f:
        json.dump({"config": "no_such_config", "traffic": "serve_closed"}, f)
    rc, result = run_cell(tiny_base, "bad", capsys=capsys)
    assert rc == 2 and result is None


def test_a_cell_added_as_a_file_runs(tiny_base, capsys):
    with open(os.path.join(tiny_base, "workloads", "tiny.serve.json")) as f:
        cell = json.load(f)
    cell["request_sizes"] = [2]
    with open(os.path.join(tiny_base, "workloads", "tiny.added.json"),
              "w") as f:
        json.dump(cell, f)
    rc, result = run_cell(tiny_base, "tiny.added", capsys=capsys)
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"serve_p95_ms", "serve_clips_per_s",
                                      "setup_s"}


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    from perfbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "journal.serve", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 3
    assert capsys.readouterr().out.strip() == ""


def test_benchmark_file_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert os.path.isdir(PERFBENCH)
