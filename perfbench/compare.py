"""The numbers that decide ``correct``: what the timed path produced against
what the plain reference computes from the same inputs and weights.

Serving: every output a sampled request returned, row by row. A row's gap
in one output is the mean absolute gap over the row's values over the mean
magnitude of the reference's values of that output over all compared rows.
- ``serve_out_gap``: the worst row of every floating output but the dense
  flow and the binary sparse map (``sparse_motion_bin``), whose pixels
  flip whole where two nodes tie for a pixel: the winner share counts
  those flips;
- ``serve_frame_gap``: the worst row of the generated frames;
- ``serve_flow_gap``: the worst row of the dense flow (``dense_motion_bw``);
- ``serve_winner_gap``: the share of a row's pixels whose winner node
  (``winner_bw``) differs; the worst row.

Training, over the first three steps from the same weights, batches and
draws, leaf by leaf (a leaf: a parameter or a buffer by its name):
- ``train_loss_gap``: the first step's metrics (every loss term, the
  totals), the gap of each as a share of the larger of the reference's
  magnitude of it and the median magnitude of the step's metrics; the
  worst. ``train_loss_gap_steps``: the same over the three steps;
- ``train_grad_gap``: the norm of each parameter's first gradient as Adam
  received it (its first moment after step 1 over 1 - beta1), the gap
  between the program's norm and the reference's as a share of the larger
  of the reference's norm and the median leaf's; the median leaf's.
  ``train_grad_gap_worst``: the worst leaf's;
- ``train_change_gap``: the same for the norm of each leaf's change over
  the three steps, buffers (norm statistics, spectral ``u``) included; the
  worst leaf's. ``train_change_gap_median``: the median leaf's (where one
  leaf's change is round-off that Adam amplifies: PERF.md).
Which of these are compared, and why the others are not, is in each
cell's ``limits`` and in PERF.md.
Parameters whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone: they are left out of both
gradient and change by that rule, never by name.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

ROUND_OFF_SHARE = 1e-3
# outputs that serve_out_gap leaves to serve_flow_gap and serve_winner_gap
OUT_GAP_SKIPS = ("dense_motion_bw", "sparse_motion_bin")


class ServeGap:
    """Accumulates row gaps over the compared requests."""

    def __init__(self):
        self.abs_sum: Dict[str, List[Tuple[float, int]]] = {}
        self.ref_sum: Dict[str, float] = {}
        self.ref_count: Dict[str, int] = {}
        self.winner: List[float] = []

    def add_row(self, got: Mapping[str, np.ndarray],
                want: Mapping[str, torch.Tensor]) -> None:
        """One row: ``got`` the program's numpy outputs of the row,
        ``want`` the reference's tensors of the same row."""
        missing = set(want) - set(got)
        if missing:
            raise KeyError(f"the program returned no {sorted(missing)}")
        for key, ref in want.items():
            ref = ref.detach()
            mine = torch.as_tensor(np.asarray(got[key]), device=ref.device)
            if tuple(mine.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {tuple(mine.shape)} against "
                                 f"{tuple(ref.shape)}")
            if key == "winner_bw":
                self.winner.append(float((mine != ref).float().mean()))
                continue
            if not ref.is_floating_point():
                continue
            mine, ref = mine.double(), ref.double()
            gap = float((mine - ref).abs().sum())
            self.abs_sum.setdefault(key, []).append((gap, ref.numel()))
            self.ref_sum[key] = self.ref_sum.get(key, 0.0) + float(
                ref.abs().sum())
            self.ref_count[key] = self.ref_count.get(key, 0) + ref.numel()

    def by_output(self) -> Dict[str, float]:
        """Each floating output's worst row gap."""
        out = {}
        for key, rows in self.abs_sum.items():
            scale = self.ref_sum[key] / max(self.ref_count[key], 1)
            worst = 0.0
            for gap, n in rows:
                rel = (gap / n) / scale if scale > 0 else (
                    0.0 if gap == 0 else float("inf"))
                if not rel <= worst:
                    worst = rel
            out[key] = worst
        return out

    def numbers(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """({'serve_out_gap': worst output and row, 'serve_frame_gap': the
        generated frames' worst row, 'serve_winner_gap': y}, each output's
        worst row gap)."""
        each = self.by_output()
        return ({"serve_out_gap": max((v for k, v in each.items()
                                       if k not in OUT_GAP_SKIPS),
                                      default=0.0),
                 "serve_frame_gap": each.get("generated", 0.0),
                 "serve_flow_gap": each.get("dense_motion_bw", 0.0),
                 "serve_winner_gap": max(self.winner, default=0.0)}, each)


def leaf_gaps(mine: Mapping[str, float], ref: Mapping[str, float],
              names: Iterable[str]) -> Tuple[float, str]:
    """max over ``names`` of |mine - ref| / max(ref, median ref), with the
    name of the worst leaf. A leaf the program lacks reads infinite."""
    names = list(names)
    if not names:
        return 0.0, "none"
    med = statistics.median(ref[n] for n in names)
    worst, where = 0.0, "none"
    for n in names:
        if n not in mine:
            return float("inf"), n
        rel = abs(mine[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not rel <= worst:
            worst, where = rel, n
    return worst, where


def train_numbers(mine: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict]:
    """Both sides as {'metrics': [3 dicts name -> float], 'grad':
    {param: norm}, 'change': {leaf: norm}, 'buffers': [names]}.

    -> (numbers, diagnostics). Numbers: ``train_loss_gap`` (the first
    step's worst metric), ``train_loss_gap_steps`` (the worst over the
    three steps), ``train_grad_gap`` (the median leaf's),
    ``train_grad_gap_worst`` (the worst leaf's), ``train_change_gap`` (the
    worst leaf's change), ``train_change_gap_median`` (the median leaf's)."""
    if len(mine["metrics"]) != len(ref["metrics"]):
        by_step = [float("inf")]
    else:
        by_step = [step_gap(m, r) for m, r in zip(mine["metrics"],
                                                  ref["metrics"])]
    grads = ref["grad"]
    med = statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= ROUND_OFF_SHARE * med]
    grad_worst, grad_at = leaf_gaps(mine["grad"], grads, moved)
    grad_spread = spread(mine["grad"], grads, moved)
    change_names = moved + [b for b in ref["buffers"]
                            if ref["change"].get(b, 0.0) > 0.0]
    change, change_at = leaf_gaps(mine["change"], ref["change"], change_names)
    first_m, first_r = (mine["metrics"][0], ref["metrics"][0]) if (
        mine["metrics"] and ref["metrics"]) else ({}, {})
    return ({"train_loss_gap": by_step[0],
             "train_loss_gap_steps": max(by_step),
             "train_grad_gap": grad_spread.get("p50", 0.0),
             "train_grad_gap_worst": grad_worst,
             "train_change_gap": change,
             "train_change_gap_median": spread(mine["change"], ref["change"],
                                               change_names).get("p50", 0.0)},
            {"train_grad_gap_worst": grad_at, "train_change_gap": change_at,
             "leaves_left_out": len(grads) - len(moved),
             "loss_gap_by_step": by_step, "grad_gaps": grad_spread,
             "first_step_terms": {k: abs(first_m.get(k, float("nan")) - v)
                                  / max(abs(v), 1e-30)
                                  for k, v in first_r.items()},
             "change_gaps": spread(mine["change"], ref["change"],
                                   change_names)})


def step_gap(mine: Dict[str, float], ref: Dict[str, float]) -> float:
    """One step's worst metric gap (as ``train_loss_gap``)."""
    med = statistics.median(abs(v) for v in ref.values())
    return max(abs(mine.get(k, float("nan")) - v) / max(abs(v), med, 1e-30)
               for k, v in ref.items())


def spread(mine, ref, names) -> Dict:
    """Quantiles of the leaf gaps (p50: the median leaf's gap) and the five
    worst leaves."""
    if not names:
        return {}
    med = statistics.median(ref[n] for n in names)
    gaps = sorted(((abs(mine.get(n, float("inf")) - ref[n])
                    / max(ref[n], med, 1e-30), n) for n in names),
                  reverse=True)
    values = [g for g, _ in gaps][::-1]

    def q(p):
        return values[min(len(values) - 1, int(p * len(values)))]
    return {"p50": q(0.5), "p90": q(0.9), "p99": q(0.99),
            "worst5": [[n, g, ref[n] / med] for g, n in gaps[:5]]}
