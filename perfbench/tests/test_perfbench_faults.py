"""A run with the timed path broken underneath comes out not correct:
the look for a card is skipped and the rest of the run is driven, on the
tiny cells under the real cells' limits, with each fault the cell can
have planted in the port's path."""

import numpy as np
import pytest
import torch
from conftest import run_cell


def test_serve_answer_altered(tiny_base, capsys, monkeypatch):
    from c2m_tpu_torch import serving
    real = serving.ServingModel.__call__

    def altered(self, batch, z_m, click, *a, **k):
        out = real(self, batch, z_m, click, *a, **k)
        out["generated"] = out["generated"].copy()
        out["generated"][-1] = 1.0 - out["generated"][-1]
        return out
    monkeypatch.setattr(serving.ServingModel, "__call__", altered)
    rc, result = run_cell(tiny_base, "tiny.serve", capsys=capsys)
    assert rc == 0 and result["correct"] is False


def test_serve_half_batch_left_out(tiny_base, capsys, monkeypatch):
    from c2m_tpu_torch import serving
    real = serving.ServingModel.__call__

    def half(self, batch, z_m, click, *a, **k):
        b = len(z_m)
        keep = b - b // 2
        out = real(self, {key: v[:keep] for key, v in batch.items()},
                   z_m[:keep], click[:keep], *a, **k)
        # the rows left out answered with the last computed row
        return {key: np.concatenate([v] + [v[-1:]] * (b - keep))
                for key, v in out.items()}
    monkeypatch.setattr(serving.ServingModel, "__call__", half)
    rc, result = run_cell(tiny_base, "tiny.serve", capsys=capsys)
    assert rc == 0 and result["correct"] is False


def planted_step(monkeypatch, fault):
    from c2m_tpu_torch.train import step as step_module
    real = step_module.make_train_step
    monkeypatch.setattr(step_module, "make_train_step",
                        lambda cfg: fault(real(cfg)))


def test_train_state_unchanged(tiny_base, capsys, monkeypatch):
    def unchanged(step):
        def run(state, batch, eps, click):
            saved = {k: v.clone() for k, v in state.model.state_dict().items()}
            metrics = step(state, batch, eps, click)
            with torch.no_grad():
                state.model.load_state_dict(saved)
            return metrics
        return run
    planted_step(monkeypatch, unchanged)
    rc, result = run_cell(tiny_base, "tiny.train", capsys=capsys)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["train_change_gap_median"]["value"] == pytest.approx(
        1.0)


def test_train_half_batch(tiny_base, capsys, monkeypatch):
    from perfbench.control import half_batch
    planted_step(monkeypatch, half_batch)
    rc, result = run_cell(tiny_base, "tiny.train", capsys=capsys)
    assert rc == 0 and result["correct"] is False
