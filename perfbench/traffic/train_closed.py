"""Closed-loop training: one trainer takes the next step when the last one
has been queued, through ``make_train_step(cfg)(state, batch, eps,
click_mask)`` on a train state built from the seed.

Parameters (``workloads/<cell>.json``):
- ``batch``: clips per step;
- ``objects`` [lo, hi]: real objects per clip of the pool, every count
  equally often in each cycle of the range (order drawn from the seed);
- ``pool_clips``: clips made at set-up with every stream (flows and
  occlusions precomputed as inputs), held in pinned host memory; a step's
  batch is a run of consecutive pool clips from an offset drawn from the
  seed and goes to the card through ``device_batch`` inside the window;
- ``queue_depth``: steps the host may run ahead of the card;
- ``trace_after`` / ``trace_steps``: which window steps the traced run
  profiles;
- ``limits``: the compared numbers' limits.

Set-up drives the same train state through its first three steps, on pool
rows that all differ, with the window's own call and feed; the reference
follows those three steps from the same weights, batches and draws.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import compare, harness, scenes, tracing, weights

KIND = "train"
CHECKED_STEPS = 3


class Cell:
    def __init__(self, cell: Dict, seed: int, device="cuda"):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.kind = KIND
        self.cfg = harness.program_config(cell)
        self.rcfg = harness.reference_config(cell)
        self.batch = int(cell["batch"])
        self.flops_per_step = self.batch * cell["config_file"].get(
            "flops", {}).get("train_step_per_clip", 0) or None
        self.enqueue: List[float] = []
        self.step_ends: List[float] = []
        self.after = None       # (steps, steps, seconds) after the trace
        self.trace = None
        self.launches: List[tracing.Launch] = []
        self.failed = 0

    # -- traffic ----------------------------------------------------------

    def _draws(self, step: int):
        """The VAE noise and the click mask of step ``step`` (one random
        real node per clip, as the step would draw them), from the seed."""
        rng = np.random.RandomState(
            weights.sub_seed(self.seed, f"step{step}") % 2 ** 32)
        off = self._offset(step, rng)
        enc = self.cfg.model_params.motion_estimator.dense_motion_encoder
        eps = rng.standard_normal(
            (self.batch, enc.out_channel_bg + enc.out_channel_fg)
        ).astype(np.float32)
        real = self.host["num_real_nodes"][off:off + self.batch]
        click = np.zeros((self.batch, self.cfg.dataset_params.max_objects),
                         np.float32)
        click[np.arange(self.batch),
              (rng.rand(self.batch) * real).astype(int)] = 1.0
        return off, eps, click

    def _offset(self, step: int, rng) -> int:
        """The checked steps take rows that all differ; later steps a run of
        the pool from an offset drawn from the seed."""
        if step < CHECKED_STEPS:
            return step * self.batch
        return int(rng.randint(0, self.cell["pool_clips"] - self.batch + 1))

    def _feed(self, step: int):
        """(batch on the device, eps, click mask) of step ``step``: the
        window's own feed."""
        from c2m_tpu_torch.train.trainer import device_batch
        off, eps, click = self._draws(step)
        batch = device_batch({k: v[off:off + self.batch]
                              for k, v in self.pool.items()}, self.device)
        return (batch, torch.as_tensor(eps, device=self.device),
                torch.as_tensor(click, device=self.device))

    # -- phases ------------------------------------------------------------

    def setup(self) -> None:
        from c2m_tpu_torch.ops import hopper
        from c2m_tpu_torch.train.model import C2MTrainModel
        from c2m_tpu_torch.train.state import TrainState, build_optimizer
        from c2m_tpu_torch.train.step import make_train_step
        c = self.cell
        if c["pool_clips"] < CHECKED_STEPS * self.batch:
            raise ValueError("the pool must hold the checked steps' rows")
        marks = [("start", time.perf_counter())]
        if self.device.type == "cuda":
            hopper.build()
        marks.append(("build", time.perf_counter()))
        rng = np.random.RandomState(weights.sub_seed(self.seed, "pool")
                                    % 2 ** 32)
        objects = scenes.stratified(rng, *c["objects"], c["pool_clips"])
        self.host = scenes.make_clips(
            self.rcfg, objects,
            weights.sub_seed(self.seed, "scenes") % 2 ** 32,
            with_targets=True, device=self.device)
        pin = self.device.type == "cuda"
        self.pool = {k: (torch.from_numpy(v).pin_memory() if pin
                         else torch.from_numpy(v))
                     for k, v in self.host.items()}
        marks.append(("pool", time.perf_counter()))
        model = weights.build_on_device(lambda: C2MTrainModel(self.cfg),
                                        self.seed, self.device).train()
        optimizer, scheduler = build_optimizer(self.cfg, model)
        self.state = TrainState(model, optimizer, scheduler,
                                torch.Generator().manual_seed(
                                    weights.sub_seed(self.seed, "state")))
        self.step_fn = make_train_step(self.cfg)
        marks.append(("model", time.perf_counter()))
        self.first = run_checked_steps(self.state, self.step_fn, self._feed,
                                       self.cfg.train_params.beta1)
        self._sync()
        marks.append(("checked_steps", time.perf_counter()))
        self.setup_marks = {b[0]: round(b[1] - a[1], 3)
                            for a, b in zip(marks, marks[1:])}

    def window(self, seconds: float, trace: bool) -> float:
        c = self.cell
        first_traced = c["trace_after"]
        last_traced = first_traced + c["trace_steps"] - 1
        pending = collections.deque()
        self._reset_peak()
        self._sync()
        start = time.perf_counter()
        n = 0
        while True:
            if trace and n == first_traced:
                self._sync()
                record = tracing.LaunchRecord().__enter__()
                prof_cm = tracing.profiled()
                prof = prof_cm.__enter__()
                span = torch.profiler.record_function(tracing.WINDOW_SPAN)
                span.__enter__()
            traced = trace and first_traced <= n <= last_traced
            batch, eps, click = self._feed(CHECKED_STEPS + n)
            t0 = time.perf_counter()
            if traced:
                with torch.profiler.record_function(tracing.UNIT_SPAN):
                    self.metrics = self.step_fn(self.state, batch, eps, click)
            else:
                self.metrics = self.step_fn(self.state, batch, eps, click)
            t1 = time.perf_counter()
            if not traced:
                self.enqueue.append(t1 - t0)
            if trace and n == last_traced:
                self._sync()
                span.__exit__(None, None, None)
                prof_cm.__exit__(None, None, None)
                record.__exit__(None, None, None)
                self.launches = record.launches
                self._prof = prof
                after_start, after_from = time.perf_counter(), n + 1
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                pending.append(done)
                if len(pending) > c["queue_depth"]:
                    pending.popleft().synchronize()
            n += 1
            self.step_ends.append(time.perf_counter() - start)
            if (time.perf_counter() - start >= seconds
                    and (not trace or n > last_traced)):
                break
        self._sync()
        self.end = time.perf_counter()
        self.steps = n
        if trace and n > after_from:
            self.after = (n - after_from, n - after_from,
                          self.end - after_start)
        self.window_peak = self._peak()
        self.memory_peak = max(self.setup_peak, self.window_peak)
        return start

    def release(self) -> None:
        self.state = self.step_fn = self.metrics = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if getattr(self, "_prof", None) is not None:
            self.trace = tracing.summarise(self._prof,
                                           self.cell["trace_steps"])
            self._prof = None

    def end_to_end(self, start: float) -> Dict[str, float]:
        return {"train_step_ms": ((self.end - start) / self.steps * 1e3,
                                  "ms"),
                "train_peak_gib": (self.window_peak / 2 ** 30, "GiB")}

    def reference_state(self, control=None):
        """The reference's train state from the same weights: float32
        compute, or the conv stacks in bfloat16 for the ``"bfloat16"``
        control."""
        from perfbench.reference.train.model import C2MTrainModel
        from perfbench.reference.train.state import (TrainState,
                                                     build_optimizer)
        model = weights.build_on_device(lambda: C2MTrainModel(self.rcfg),
                                        self.seed, self.device).train()
        model.use_compute_dtype(torch.bfloat16 if control == "bfloat16"
                                else torch.float32)
        optimizer, scheduler = build_optimizer(self.rcfg, model)
        return TrainState(model, optimizer, scheduler, torch.Generator())

    def reference_readings(self, control=None, fault=None) -> Dict:
        """The reference's first three steps: float32 with TF32 off, or a
        precision control one step below the configuration's, ``"tf32"``
        (TF32 on) or ``"bfloat16"`` (the conv stacks in bfloat16, the step
        below that); ``fault``, for the fault readings, wraps its step
        function."""
        from perfbench.reference.train.step import make_train_step
        with harness.tf32(control == "tf32"):
            state = self.reference_state(control)
            step = make_train_step(self.rcfg)
            if fault is not None:
                step = fault(step)
            readings = run_checked_steps(state, step, self._feed,
                                         self.rcfg.train_params.beta1)
            del state
        gc.collect()
        return readings

    def check(self) -> Dict[str, float]:
        self.reference = self.reference_readings()
        numbers, self.worst = compare.train_numbers(self.first,
                                                    self.reference)
        self._count_pairs()
        return numbers

    def _count_pairs(self) -> None:
        from perfbench import roofline
        from perfbench.reference.ops.plain import warp_masks_winner_plain
        for launch in self.launches:
            if launch.inputs:
                with torch.no_grad():
                    winner = warp_masks_winner_plain(*launch.inputs)
                launch.args["pairs"] = roofline.k2_pairs(launch.inputs[2],
                                                         winner)
                launch.inputs = ()

    # -- device helpers ------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _reset_peak(self):
        self.setup_peak = 0
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def _peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated()


def run_checked_steps(state, step_fn, feed, beta1: float) -> Dict:
    """The first three steps of ``state`` through ``step_fn`` on
    ``feed(step)``: each step's metrics, each parameter's first gradient
    norm as Adam received it (first moment after step 1 over 1 - beta1),
    and each leaf's change over the three steps."""
    model = state.model
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    buffers = dict(model.named_buffers())
    leaves = {**params, **buffers}
    before = {n: t.detach().clone() for n, t in leaves.items()}
    metrics, grad = [], None
    for step in range(CHECKED_STEPS):
        out = step_fn(state, *feed(step))
        metrics.append({k: float(v) for k, v in out.items()})
        if step == 0:
            names = [n for n, p in params.items()
                     if p in state.optimizer.state]
            norms = torch.stack([
                torch.linalg.vector_norm(
                    state.optimizer.state[params[n]]["exp_avg"].double())
                for n in names]) / (1.0 - beta1)
            grad = dict(zip(names, norms.cpu().tolist()))
    norms = torch.stack([
        torch.linalg.vector_norm((leaves[n].detach().double()
                                  - before[n].double()))
        for n in leaves]).cpu().tolist()
    return {"metrics": metrics, "grad": grad,
            "change": dict(zip(leaves, norms)), "buffers": list(buffers)}
