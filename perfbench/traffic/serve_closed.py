"""Closed-loop serving: one client sends a request, waits for its numpy
outputs, and sends the next, through ``ServingModel.__call__``.

Parameters (``workloads/<cell>.json``):
- ``buckets``: the server's batch buckets;
- ``request_sizes``: the clips a request may ask for, each entry equally
  often in each cycle of the list (order drawn from the seed); an entry
  given twice is sent twice as often;
- ``objects`` [lo, hi]: real objects per clip of the pool, likewise;
- ``clicks`` [lo, hi]: clicked objects per clip (at most its objects);
- ``pool_clips``: clips made at set-up (input frames only); a request is a
  run of consecutive pool clips from an offset drawn from the seed, each
  with a fresh latent drawn from the seed;
- ``use_gt_eval``: false for the click path (the GNN's thetas);
- ``warmup_per_size``: requests of each size before the window;
- ``trace_after`` / ``trace_requests``: which requests the traced run
  profiles;
- ``check_within`` / ``check_requests``: the reference compares that many
  requests drawn from the seed among the window's first ``check_within``,
  one of them of the largest size;
- ``limits``: the compared numbers' limits.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import compare, harness, scenes, tracing, weights

KIND = "serve"
FRAME_STREAMS = ("video", "bg_mask", "fg_mask", "instance_mask")


class Cell:
    def __init__(self, cell: Dict, seed: int, device="cuda"):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.kind = KIND
        self.cfg = harness.program_config(cell)
        self.rcfg = harness.reference_config(cell)
        self.flops_per_clip = cell["config_file"].get("flops", {}).get(
            "serve_forward_per_clip")
        self.records: List = []          # (clips, bucket, seconds)
        self.trace = None
        self.launches: List[tracing.Launch] = []
        self.traced_clips = 0
        self.kept: Dict[int, Dict] = {}
        self.failed = 0
        self.after = None       # (requests, clips, seconds) after the trace

    # -- traffic ----------------------------------------------------------

    def _draws(self):
        """The request stream: (clips, offset, latent, click mask) per
        request, from the seed."""
        c = self.cell
        rng = np.random.RandomState(weights.sub_seed(self.seed, "requests")
                                    % 2 ** 32)
        pool = c["pool_clips"]
        n_max = self.cfg.dataset_params.max_objects
        from c2m_tpu_torch.serving import z_dim
        zd = z_dim(self.cfg)
        while True:
            for size in rng.permutation(c["request_sizes"]):
                size = int(size)
                offset = int(rng.randint(0, pool - size + 1))
                z = rng.standard_normal((size, zd)).astype(np.float32)
                click = np.zeros((size, n_max), np.float32)
                real = self.pool["num_real_nodes"][offset:offset + size]
                for row in range(size):
                    k = min(int(rng.randint(c["clicks"][0],
                                            c["clicks"][1] + 1)),
                            int(real[row]))
                    click[row, rng.choice(int(real[row]), k,
                                          replace=False)] = 1.0
                yield size, offset, z, click

    def _request(self, size, offset):
        return {k: v[offset:offset + size] for k, v in self.pool.items()}

    # -- phases ------------------------------------------------------------

    def setup(self) -> None:
        from c2m_tpu_torch.models.c2m import DTYPES, C2MGenerator
        from c2m_tpu_torch.ops import hopper
        from c2m_tpu_torch.serving import ServingModel
        c = self.cell
        marks = [("start", time.perf_counter())]
        if self.device.type == "cuda":
            hopper.build()
        marks.append(("build", time.perf_counter()))
        model = weights.build_on_device(lambda: C2MGenerator(self.cfg),
                                        self.seed, self.device)
        model.use_compute_dtype(DTYPES[self.cfg.train_params.dtype])
        self.server = ServingModel(model, c["buckets"],
                                   use_gt_eval=c.get("use_gt_eval", False))
        rng = np.random.RandomState(weights.sub_seed(self.seed, "pool")
                                    % 2 ** 32)
        objects = scenes.stratified(rng, *c["objects"], c["pool_clips"])
        self.pool = scenes.make_clips(
            self.rcfg, objects, weights.sub_seed(self.seed, "scenes")
            % 2 ** 32, frames=self.cfg.train_params.num_input_frames,
            with_targets=False)
        marks.append(("model_and_pool", time.perf_counter()))
        self.stream = self._draws()
        # the sampled requests: one of the largest size among the first
        # check_within, the rest drawn from the seed
        sizes = []
        probe = self._draws()
        for _ in range(c["check_within"]):
            sizes.append(next(probe)[0])
        pick = np.random.RandomState(weights.sub_seed(self.seed, "check")
                                     % 2 ** 32)
        largest = sizes.index(max(sizes))
        others = [i for i in range(len(sizes)) if i != largest]
        self.sample = {largest, *pick.choice(
            others, c["check_requests"] - 1, replace=False).tolist()}
        # warm-up: every size the traffic sends, and no other
        for size in sorted(set(c["request_sizes"])):
            for _ in range(c["warmup_per_size"]):
                z = np.zeros((size, z_dim_of(self.cfg)), np.float32)
                click = np.zeros((size, self.cfg.dataset_params.max_objects),
                                 np.float32)
                click[:, 0] = 1.0
                self.server(self._request(size, 0), z, click)
        self._sync()
        marks.append(("warmup", time.perf_counter()))
        self.setup_marks = {b[0]: round(b[1] - a[1], 3)
                            for a, b in zip(marks, marks[1:])}

    def window(self, seconds: float, trace: bool) -> float:
        """The measured window; returns its start (perf_counter)."""
        c = self.cell
        first_traced = c["trace_after"]
        last_traced = first_traced + c["trace_requests"] - 1
        prof = record = span = None
        self._reset_peak()
        start = time.perf_counter()
        i = 0
        while True:
            size, offset, z, click = next(self.stream)
            batch = self._request(size, offset)
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
                        out = self.server(batch, z, click)
                else:
                    out = self.server(batch, z, click)
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
                self.kept[i] = {"size": size, "offset": offset, "z": z,
                                "click": click, "out": out}
            self.records.append((size, self.server.bucket_for(size), t1 - t0))
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
        del self.server
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
        """The reference generator with the same weights, its conv stacks
        in float32, or in bfloat16 for the ``"bfloat16"`` control."""
        from perfbench.reference.models.c2m import C2MGenerator
        model = weights.build_on_device(lambda: C2MGenerator(self.rcfg),
                                        self.seed, self.device).eval()
        if control == "bfloat16":
            model.use_compute_dtype(torch.bfloat16)
        return model

    def reference_outputs(self, model, kept):
        """The reference's outputs of one kept request, row by row."""
        batch = self._request(kept["size"], kept["offset"])
        nif = self.rcfg.train_params.num_input_frames
        for row in range(kept["size"]):
            arrays = {k: (v[row:row + 1, :nif] if k in FRAME_STREAMS
                          else v[row:row + 1]) for k, v in batch.items()}
            dev = {k: torch.as_tensor(np.ascontiguousarray(v),
                                      device=self.device)
                   for k, v in arrays.items()}
            z = torch.as_tensor(kept["z"][row:row + 1], device=self.device)
            ck = torch.as_tensor(kept["click"][row:row + 1],
                                 device=self.device)
            with torch.no_grad():
                out = model.inference(dev, z, ck,
                                      self.cell.get("use_gt_eval", False))
            yield row, {k: v.float() if v.is_floating_point() else v
                        for k, v in out.items()}

    def check(self) -> Dict[str, float]:
        """The compared numbers over the kept requests: their outputs
        against the float32 reference's, row by row."""
        with harness.tf32(False):
            ref = self.reference_model()
            gaps = compare.ServeGap()
            for i in sorted(self.kept):
                kept = self.kept[i]
                if kept["out"] is None:
                    inf = float("inf")
                    return {**{k: inf for k in self.cell["limits"]},
                            "serve_out_gap": inf, "serve_frame_gap": inf,
                            "serve_flow_gap": inf, "serve_winner_gap": inf}
                for row, want in self.reference_outputs(ref, kept):
                    got = {k: v[row] for k, v in kept["out"].items()}
                    gaps.add_row(got, {k: v[0] for k, v in want.items()})
            numbers, self.output_gaps = gaps.numbers()
            del ref
            self._count_pairs()
        return numbers

    def control_outputs(self, control: str) -> None:
        """A precision control in the program's place: the kept requests'
        outputs replaced by the reference's one precision step below the
        configuration's, ``"tf32"`` (TF32 on) or ``"bfloat16"`` (the conv
        stacks in bfloat16, the step below that)."""
        with harness.tf32(control == "tf32"):
            model = self.reference_model(control)
            for kept in self.kept.values():
                rows = [out for _, out in self.reference_outputs(model, kept)]
                kept["out"] = {k: torch.cat([r[k] for r in rows]).cpu().numpy()
                               for k in rows[0]}
            del model

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
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def _peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return max(self.setup_peak, torch.cuda.max_memory_allocated())


def z_dim_of(cfg) -> int:
    enc = cfg.model_params.motion_estimator.dense_motion_encoder
    return int(enc.out_channel_bg + enc.out_channel_fg)
