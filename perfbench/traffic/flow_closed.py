"""Closed-loop FlowNet2 precompute: one client sends a batch of clips'
frames, waits for their flows and confidences as numpy, and sends the next,
through ``c2m_tpu_torch.tools.precompute_flow.batch_flows``, the call the
flow tool makes per run of clips.

Parameters (``workloads/<cell>.json``):
- ``clips``: clips a request (the tool's run of ``batch_size`` clips);
- ``objects`` [lo, hi]: moving objects per clip of the pool, every count
  of the range equally often;
- ``pool_clips``: clips made at set-up (the video stream of every frame,
  in page-locked host memory on the card); a request is a run of ``clips``
  consecutive pool clips from an offset drawn from the seed;
- ``warmup_requests``: requests before the window;
- ``trace_after`` / ``trace_requests``: which requests the traced run
  profiles;
- ``check_within`` / ``check_requests``: the reference compares that many
  requests drawn from the seed among the window's first ``check_within``;
- ``limits``: the compared numbers' limits.

The numbers, over the kept requests, row by row (a row: one clip's
backward and forward flows, or its confidences), the worst row's:
``flow_gap`` and ``flow_occ_gap``, the row's largest absolute gap over its
largest absolute reference value, of the flows and of the confidences;
``flow_mean_gap`` and ``flow_occ_mean_gap``, the same with means; and
``flow_ref_max_px``, the largest reference flow in pixels. The cell's
``limits`` name the compared ones; PERF.md says why the others are read
and not compared.

Its kind is ``serve``: the generic serve readers (trace, launches, copies,
MFU from ``flops_per_clip``) read it, and ``control.py`` runs its
precision controls through :meth:`Cell.control_outputs`.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, scenes, tracing, weights

KIND = "serve"


class Cell:
    def __init__(self, cell: Dict, seed: int, device="cuda"):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.kind = KIND
        self.cfg = harness.program_config(cell)
        self.rcfg = harness.reference_config(cell)
        self.nif = self.cfg.train_params.num_input_frames
        self.flops_per_clip = cell["config_file"].get(
            "flownet2_flops", {}).get("per_clip")
        self.records: List = []          # (clips, clips, seconds)
        self.trace = None
        self.launches: List[tracing.Launch] = []
        self.traced_clips = 0
        self.kept: Dict[int, Dict] = {}
        self.failed = 0
        self.after = None       # (requests, clips, seconds) after the trace

    def _draws(self):
        """The request stream: the pool offset of each request, from the
        seed."""
        rng = np.random.RandomState(weights.sub_seed(self.seed, "requests")
                                    % 2 ** 32)
        last = self.cell["pool_clips"] - self.cell["clips"]
        while True:
            yield int(rng.randint(0, last + 1))

    def _frames(self, offset: int) -> np.ndarray:
        return self.pool[offset:offset + self.cell["clips"]]

    def setup(self) -> None:
        # the program's entry first: a port without it fails here, at once
        from c2m_tpu_torch.tools.precompute_flow import batch_flows
        from c2m_tpu_torch.models.flownet2 import FlowNet2
        c = self.cell
        self.batch_flows = batch_flows
        marks = [("start", time.perf_counter())]
        self.model = weights.build_on_device(
            FlowNet2, self.seed, self.device).eval().requires_grad_(False)
        rng = np.random.RandomState(weights.sub_seed(self.seed, "pool")
                                    % 2 ** 32)
        objects = scenes.stratified(rng, *c["objects"], c["pool_clips"])
        video = scenes.make_clips(
            self.rcfg, objects, weights.sub_seed(self.seed, "scenes")
            % 2 ** 32, with_targets=False)["video"]
        if self.device.type == "cuda":
            pinned = torch.empty(video.shape, dtype=torch.float32,
                                 pin_memory=True)
            pinned.copy_(torch.from_numpy(video))
            self._pinned = pinned
            video = pinned.numpy()
        self.pool = video
        marks.append(("model_and_pool", time.perf_counter()))
        self.stream = self._draws()
        pick = np.random.RandomState(weights.sub_seed(self.seed, "check")
                                     % 2 ** 32)
        self.sample = set(pick.choice(c["check_within"], c["check_requests"],
                                      replace=False).tolist())
        # warm-up: the one request shape the traffic sends (the kernels
        # build at their first call)
        for _ in range(c["warmup_requests"]):
            self.batch_flows(self.model, self._frames(0), self.nif)
        self._sync()
        marks.append(("warmup", time.perf_counter()))
        self.setup_marks = {b[0]: round(b[1] - a[1], 3)
                            for a, b in zip(marks, marks[1:])}

    def window(self, seconds: float, trace: bool) -> float:
        """The measured window; returns its start (perf_counter)."""
        c = self.cell
        size = c["clips"]
        first_traced = c["trace_after"]
        last_traced = first_traced + c["trace_requests"] - 1
        self._reset_peak()
        start = time.perf_counter()
        i = 0
        while True:
            offset = next(self.stream)
            frames = self._frames(offset)
            if trace and i == first_traced:
                self._sync()
                record = tracing.LaunchRecord().__enter__()
                prof_cm = tracing.profiled()
                prof = prof_cm.__enter__()
                span = torch.profiler.record_function(tracing.WINDOW_SPAN)
                span.__enter__()
            traced = trace and first_traced <= i <= last_traced
            t0 = time.perf_counter()
            try:
                if traced:
                    with torch.profiler.record_function(tracing.UNIT_SPAN):
                        out = self.batch_flows(self.model, frames, self.nif)
                else:
                    out = self.batch_flows(self.model, frames, self.nif)
            except RuntimeError:
                self.failed += 1
                out = None
            t1 = time.perf_counter()
            if traced:
                self.traced_clips += size
            if trace and i == last_traced:
                self._sync()
                span.__exit__(None, None, None)
                prof_cm.__exit__(None, None, None)
                record.__exit__(None, None, None)
                self.launches = record.launches
                self._prof, self._traced_units = prof, c["trace_requests"]
            if i in self.sample:
                self.kept[i] = {"offset": offset, "out": out}
            self.records.append((size, size, t1 - t0))
            if trace and i == last_traced:
                after_start = time.perf_counter()
                after_from = len(self.records)
            i += 1
            if (t1 - start >= seconds and i > max(self.sample)
                    and (not trace or i > last_traced)):
                break
        self.end = t1
        if trace and len(self.records) > after_from:
            rest = self.records[after_from:]
            self.after = (len(rest), sum(r[0] for r in rest), t1 - after_start)
        self.memory_peak = self._peak()
        return start

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if getattr(self, "_prof", None) is not None:
            self.trace = tracing.summarise(self._prof, self._traced_units)
            self._prof = None

    def end_to_end(self, start: float) -> Dict[str, float]:
        lat = sorted(r[2] for r in self.records)
        clips = sum(r[0] for r in self.records)
        p95 = float(np.percentile(np.asarray(lat) * 1e3, 95))
        return {"serve_p95_ms": (p95, "ms"),
                "serve_clips_per_s": (clips / (self.end - start), "clips/s")}

    def reference_model(self, control=None):
        """The reference FlowNet2 with the same weights, its convolutions in
        float32, or in bfloat16 for the ``"bfloat16"`` control."""
        from perfbench.reference.models import flownet2
        model = weights.build_on_device(flownet2.FlowNet2, self.seed,
                                        self.device).eval()
        if control == "bfloat16":
            flownet2.use_compute_dtype(model, torch.bfloat16)
        return model

    def reference_outputs(self, model, kept):
        """The reference's outputs of one kept request, clip by clip, in the
        layout ``batch_flows`` returns for one clip."""
        from perfbench.reference.models.flownet2 import compute_flow_and_conf
        nif = self.nif
        for row, clip in enumerate(self._frames(kept["offset"])):
            video = torch.as_tensor(np.ascontiguousarray(clip),
                                    device=self.device)
            later = video[1:]
            src = video[nif - 1:nif].expand_as(later)
            with torch.no_grad():
                flow, conf = compute_flow_and_conf(
                    model, torch.cat([later, src]), torch.cat([src, later]))
            n = later.shape[0]
            yield row, {"bw_of": flow[:n], "fw_of": flow[n:],
                        "bw_occ": conf[:n, ..., 0], "fw_occ": conf[n:, ..., 0]}

    def check(self) -> Dict[str, float]:
        """The compared numbers over the kept requests: their outputs
        against the float32 reference's, clip by clip."""
        names = ("flow_gap", "flow_occ_gap", "flow_mean_gap",
                 "flow_occ_mean_gap")
        with harness.tf32(False):
            ref = self.reference_model()
            worst = dict.fromkeys(names, 0.0)
            ref_max = 0.0
            for i in sorted(self.kept):
                kept = self.kept[i]
                if kept["out"] is None:
                    return {**dict.fromkeys(names, float("inf")),
                            "flow_ref_max_px": float("inf")}
                for row, want in self.reference_outputs(ref, kept):
                    for key, group in (("flow", ("bw_of", "fw_of")),
                                       ("flow_occ", ("bw_occ", "fw_occ"))):
                        got = torch.cat([torch.as_tensor(
                            kept["out"][k][row], device=self.device)
                            for k in group]).double()
                        exp = torch.cat([want[k] for k in group]).double()
                        if got.shape != exp.shape:
                            raise ValueError(f"{key}: shape {tuple(got.shape)}"
                                             f" against {tuple(exp.shape)}")
                        gap = (got - exp).abs()
                        scale = exp.abs()
                        for name, value in (
                                (f"{key}_gap", _ratio(gap.max(), scale.max())),
                                (f"{key}_mean_gap",
                                 _ratio(gap.mean(), scale.mean()))):
                            if not value <= worst[name]:
                                worst[name] = value
                    ref_max = max(ref_max, float(want["bw_of"].abs().max()),
                                  float(want["fw_of"].abs().max()))
            del ref
        self.output_gaps = dict(worst)
        return {**worst, "flow_ref_max_px": ref_max}

    def control_outputs(self, control: str) -> None:
        """A precision control in the program's place: the kept requests'
        outputs replaced by the reference's one precision step below the
        configuration's, ``"tf32"`` (TF32 on) or ``"bfloat16"`` (the
        convolutions in bfloat16, the step below that)."""
        with harness.tf32(control == "tf32"):
            model = self.reference_model(control)
            for kept in self.kept.values():
                rows = [out for _, out in self.reference_outputs(model, kept)]
                kept["out"] = {k: torch.stack([r[k] for r in rows])
                               .cpu().numpy() for k in rows[0]}
            del model

    # -- device helpers ------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _reset_peak(self):
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def _peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return max(self.setup_peak, torch.cuda.max_memory_allocated())


def _ratio(gap: torch.Tensor, scale: torch.Tensor) -> float:
    """gap / scale, 0 where both are 0 and infinite where only scale is."""
    gap, scale = float(gap), float(scale)
    if scale > 0:
        return gap / scale
    return 0.0 if gap == 0 else float("inf")
