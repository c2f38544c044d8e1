#!/usr/bin/env python3
"""Drive the PyTorch port's two main paths once on one NVIDIA GPU: serving
and the train step.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):
  1. torch / CUDA versions and the card's name and power limit;
  2. build the hand-written kernels from c2m_tpu_torch/csrc (nvcc, ctypes);
  3. each kernel against its plain PyTorch version on the card at the
     shapes the two paths give it (serving: B=12, T=5, N=16, 128x256; train:
     15 folded frames), forward and, for K1, backward against autograd of
     the plain version, with median times (CUDA events, after warm-up), the
     least time the card could take (bound) and, where one PyTorch call
     computes the same function (F.grid_sample for K1), that call's time;
  4. a ServingModel at the journal config's full width
     (configs/c2m_journal_cityscapes.yaml, bfloat16 conv stacks, batch
     bucket 12), random weights from a seeded torch.Generator, answering
     three requests: batch 12 with GT thetas, batch 5 padded into the
     bucket, batch 12 on the click path (GNN thetas). Every forward
     kernel's launch count over these requests must be > 0;
  5. the same slice in float32 at batch 2: the card (kernels) against the
     CPU (plain versions), TF32 off;
  6. the train step at the journal config, nothing cut: batch 3, bfloat16
     compute with float32 parameters, both discriminators, VGG perceptual
     loss, seeded weights, synthetic scenes with all 16 nodes real; three
     steps through make_train_step. Every metric finite, the generator
     objective of one batch moves between the weights before and after,
     every optimizer group moves and VGG does not, running statistics and
     spectral u move, every kernel (K1 backward included) launched;
  7. the train model in float32 at batch 1, TF32 off: one forward+backward
     on the card (kernels) against the CPU (plain versions), same noise and
     click: every loss term and the gradient of each optimizer group.
With --profile, torch.profiler splits one warm train step and one warm
request by operator and by kernel (printed).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero at once when no
CUDA device is visible. Imports nothing of JAX and nothing of c2m_tpu.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BUCKET = 12
SEED = 0

# tolerances of kernel vs plain version on the card, and why
TOL_F32 = 1e-5          # same float32 ops; the plain CUDA ops may contract
TOL_BF16 = 2.0 ** -8    # one bf16 rounding of the same float32 value in [0,1]
TOL_SPLAT = 1e-5        # atomics reorder float32 sums of masses <= ~4
TOL_FLIP = 1e-4         # share of {0,1} pixels allowed to flip at a threshold
TOL_SLICE = 5e-4        # generated frames, card vs CPU (float32 conv sums)
TOL_PAD = 2.0 ** -9     # padded vs unpadded rows: cuDNN may pick other bf16
                        # conv algorithms per batch size; one bf16 ulp at 0.5
# K1 backward vs autograd of the plain version, relative to the largest
# reference gradient: float atomics and warp shuffles add the same float32
# terms in another order (up to 256 channels x 4 taps per sum); a bfloat16
# image gradient is one rounding of such a float32 sum, so it may land on
# the neighbouring bfloat16 value (spacing 2^-7 relative)
TOL_BWD_F32 = 2e-5
TOL_BWD_BF16 = 2.0 ** -7
# train model, card vs CPU in float32 (TF32 off): loss terms relative (plus
# 1e-5 abs); gradients per optimizer group by the noise class of train-mode
# BatchNorm backward under float32 reassociation (cos, norm ratio)
TOL_LOSS_REL = 1e-3
TOL_GRAD_COS = 0.9995
TOL_GRAD_NORM = 0.02

# the card's published peaks (NVIDIA H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12      # float32 outside the tensor cores: all these kernels


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the CUDA-core peak, whichever is larger."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def grid_of(flow: torch.Tensor) -> torch.Tensor:
    """The normalized grid for which F.grid_sample(padding_mode='border',
    align_corners=False) computes K1's function."""
    _, h, w, _ = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    sx = (xs[None, None, :] + flow[..., 0]) * (w / (w - 1.0)) - 0.5
    sy = (ys[None, :, None] + flow[..., 1]) * (h / (h - 1.0)) - 0.5
    return torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], dim=-1)


def phase_kernels(dev):
    """Phase 3: kernel vs plain version at the two paths' shapes."""
    import torch.nn.functional as F
    from c2m_tpu_torch.ops import splat
    from c2m_tpu_torch.ops.hopper import maskwarp_kernel as mk
    from c2m_tpu_torch.ops.hopper import splat_kernel as sk
    from c2m_tpu_torch.ops.hopper import warp_kernels as wk
    g = torch.Generator().manual_seed(SEED)
    rows = {}

    def inputs(dtype, shape, masked):
        b, h, w, c = shape
        img = torch.rand(b, h, w, c, generator=g).to(dtype).to(dev)
        flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 16).to(dev)
        mask = torch.rand(b, h, w, 1, generator=g).to(dev) if masked else None
        return img, flow, mask

    def resample_case(kernel, dtype, shape, masked, role):
        img, flow, mask = inputs(dtype, shape, masked)
        if masked:
            run = lambda: wk.resample_masked(img, flow, mask)   # noqa: E731
        else:
            run = lambda: wk.resample(img, flow)                # noqa: E731
        plain = lambda: wk.resample_plain(img, flow, mask)      # noqa: E731
        # the library call (yardstick only, the port never calls it): the
        # warp without the mask product, grid and NCHW view made beforehand
        grid, nchw = grid_of(flow), img.permute(0, 3, 1, 2)
        lib = lambda: F.grid_sample(nchw, grid.to(dtype), mode="bilinear",  # noqa: E731
                                    padding_mode="border", align_corners=False)
        err = (run().float() - plain().float()).abs().max().item()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib)
        pix, n = img.numel() // shape[3], img.numel()
        bd = bound(nbytes(img, flow, mask) + nbytes(img), 16 * pix + 10 * n)
        log(f"  {kernel.name} {role} {list(shape)} masked={masked}: "
            f"max|diff| {err:.3g} (tol {tol:.3g})  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  grid_sample {lib_ms:.4f} ms  bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        check(err <= tol, f"{kernel.name} {shape}: max|diff| {err} > {tol}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "shape": list(shape), **bd}

    def backward_case(kernel, dtype, shape, masked, needs, role):
        """K1's gradients (needs: which of image, flow, mask) against
        autograd of the plain version and against F.grid_sample's."""
        img, flow, mask = inputs(dtype, shape, masked)
        gout = torch.randn(shape, generator=g).to(dtype).to(dev)
        names = [n for n, need in zip(("image", "flow", "mask"), needs) if need]

        def leaves():
            ts = {"image": img, "flow": flow, "mask": mask}
            ts = {k: (v.detach().clone().requires_grad_(k in names)
                      if v is not None else None) for k, v in ts.items()}
            return ts, [ts[k] for k in names]

        def grads_of(fn):
            ts, wrt = leaves()
            out = fn(ts["image"], ts["flow"], ts["mask"])
            return lambda: torch.autograd.grad(out, wrt, gout,   # noqa: E731
                                               retain_graph=True)

        def kernel_fn(i, f, m):
            return wk.resample_masked(i, f, m) if masked else wk.resample(i, f)

        def lib_fn(i, f, m):
            out = F.grid_sample(i.permute(0, 3, 1, 2), grid_of(f).to(dtype),
                                mode="bilinear", padding_mode="border",
                                align_corners=False).permute(0, 2, 3, 1)
            return out * m.to(dtype) if m is not None else out

        run, plain, lib = (grads_of(kernel_fn), grads_of(wk.resample_plain),
                           grads_of(lib_fn))
        # the forward that the backward differentiates, on the same inputs
        with torch.no_grad():
            fwd_err = (kernel_fn(img, flow, mask).float()
                       - wk.resample_plain(img, flow, mask).float()
                       ).abs().max().item()
        fwd_tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        check(fwd_err <= fwd_tol, f"{kernel.name} {shape}: forward max|diff| "
              f"{fwd_err} > {fwd_tol}")
        worst = 0.0
        for name, got, want in zip(names, run(), plain()):
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"{kernel.name} {shape}: grad {name} dtype/shape")
            scale = max(want.float().abs().max().item(), 1e-6)
            err = (got.float() - want.float()).abs().max().item() / scale
            tol = (TOL_BWD_BF16 if name == "image" and dtype == torch.bfloat16
                   else TOL_BWD_F32)
            log(f"  {kernel.name} {role} {list(shape)} d/d{name}: max|diff| "
                f"{err:.3g} of the largest gradient (tol {tol:.3g})")
            check(err <= tol, f"{kernel.name} {shape} d/d{name}: {err} > {tol}")
            worst = max(worst, err)
        # the wrapper alone (zeroed buffers, the kernel, one cast), then the
        # same through autograd, as the train step reaches it
        direct = lambda: wk._launch_backward(gout, img, flow, mask, *needs)  # noqa: E731
        ms, autograd_ms = time_ms(direct), time_ms(run)
        plain_ms, lib_ms = time_ms(plain, reps=10), time_ms(lib)
        pix, n = img.numel() // shape[3], img.numel()
        need_taps = needs[1] or needs[2]
        moved = (nbytes(gout, flow, mask) + (nbytes(img) if need_taps else 0)
                 + (nbytes(img) if needs[0] else 0)
                 + (nbytes(flow) if needs[1] else 0)
                 + (nbytes(mask) if needs[2] else 0))
        bd = bound(moved, 16 * pix + 25 * n)
        log(f"  {kernel.name} {role} {list(shape)} grads {names}: kernel "
            f"{ms:.4f} ms ({autograd_ms:.4f} through autograd)  plain "
            f"autograd {plain_ms:.4f} ms  grid_sample backward {lib_ms:.4f} "
            f"ms  bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        return {"max_abs_err": worst, "ms": ms, "autograd_ms": autograd_ms,
                "plain_ms": plain_ms,
                "library_ms": lib_ms, "shape": list(shape),
                "err": "max |diff| over the largest reference gradient", **bd}

    log("[phase 3] kernels vs plain versions on the card")
    for shape in [(60, 32, 64, 64), (60, 16, 32, 128), (60, 8, 16, 256),
                  (60, 4, 8, 512)]:
        resample_case(wk.RESAMPLE_BF16, torch.bfloat16, shape, True,
                      "decoder skip")
        resample_case(wk.RESAMPLE_F32, torch.float32, shape, True,
                      "decoder skip")
    rows["resample_bf16"] = resample_case(
        wk.RESAMPLE_BF16, torch.bfloat16, (60, 16, 32, 256), True,
        "generator bottleneck")
    resample_case(wk.RESAMPLE_F32, torch.float32, (60, 16, 32, 256), True,
                  "generator bottleneck")
    rows["resample_f32"] = resample_case(
        wk.RESAMPLE_F32, torch.float32, (60, 128, 256, 3), False, "previews")

    # K1 forward at the train step's shapes (batch 3 x 5 frames folded)
    train = {}
    for shape in [(15, 32, 64, 64), (15, 16, 32, 128), (15, 8, 16, 256),
                  (15, 4, 8, 512)]:
        resample_case(wk.RESAMPLE_BF16, torch.bfloat16, shape, True,
                      "train decoder skip")
    train["resample_bf16"] = resample_case(
        wk.RESAMPLE_BF16, torch.bfloat16, (15, 16, 32, 256), True,
        "train generator bottleneck")
    train["resample_f32"] = resample_case(
        wk.RESAMPLE_F32, torch.float32, (15, 128, 256, 3), False,
        "train warped loss and previews")

    # K1 backward at the same shapes
    for shape in [(15, 32, 64, 64), (15, 16, 32, 128), (15, 8, 16, 256),
                  (15, 4, 8, 512)]:
        backward_case(wk.RESAMPLE_BWD_BF16, torch.bfloat16, shape, True,
                      (True, False, False), "decoder skip")
    rows["resample_bwd_bf16"] = backward_case(
        wk.RESAMPLE_BWD_BF16, torch.bfloat16, (15, 16, 32, 256), True,
        (True, True, True), "generator bottleneck")
    backward_case(wk.RESAMPLE_BWD_F32, torch.float32, (15, 16, 32, 256), True,
                  (True, True, True), "generator bottleneck")
    backward_case(wk.RESAMPLE_BWD_BF16, torch.bfloat16, (15, 16, 32, 256),
                  False, (True, True, False), "unmasked")
    backward_case(wk.RESAMPLE_BWD_F32, torch.float32, (15, 128, 256, 2), False,
                  (True, True, False), "flow consistency")
    rows["resample_bwd_f32"] = backward_case(
        wk.RESAMPLE_BWD_F32, torch.float32, (15, 128, 256, 3), False,
        (False, True, False), "warped loss")

    def maskwarp_case(b, role):
        """K2 at [B, N, H, W] x [B, N, T, 6] = [b, 16, 128, 256] x [b, 16, 5, 6]."""
        n, t, h, w = 16, 5, 128, 256
        rng = np.random.RandomState(SEED)
        inst = np.zeros((b, h, w), np.float32)
        for bi in range(b):
            for k in range(n):
                y0, x0 = rng.randint(0, h - 32), rng.randint(0, w - 64)
                inst[bi, y0:y0 + rng.randint(8, 32),
                     x0:x0 + rng.randint(8, 64)] = 26001 + k
        ids = np.tile(26001 + np.arange(n, dtype=np.int32), (b, 1))
        th = np.zeros((b, n, t, 6), np.float32)
        th[..., 0] = 1 + rng.randn(b, n, t) * 0.05
        th[..., 4] = 1 + rng.randn(b, n, t) * 0.05
        th[..., 1] = rng.randn(b, n, t) * 0.03
        th[..., 3] = rng.randn(b, n, t) * 0.03
        th[..., 2] = rng.randn(b, n, t) * 0.1
        th[..., 5] = rng.randn(b, n, t) * 0.1
        args = [torch.as_tensor(a, device=dev)
                for a in (inst, ids, np.ones((b, n), bool), th)]
        run = lambda: mk.warp_masks_winner(*args)               # noqa: E731
        plain = lambda: mk.warp_masks_winner_plain(*args)       # noqa: E731
        winner = run()
        frac = (winner != plain()).float().mean().item()
        ms, plain_ms = time_ms(run), time_ms(plain, reps=5)
        # per output pixel 6 operations for its base coordinates, and per
        # valid node ~30 (affine, source coordinate, bilinear weights,
        # interpolation)
        n_valid = int(args[2].sum().item()) * t * h * w
        bd = bound(nbytes(*args) + nbytes(winner),
                   6 * winner.numel() + 30 * n_valid)
        log(f"  warp_masks_winner {role} [{b},16,128,256]x[{b},16,5,6]: winner "
            f"mismatch {frac:.3g} of pixels (tol {TOL_FLIP})  kernel {ms:.4f} "
            f"ms  plain {plain_ms:.4f} ms  bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})  no single library call")
        check(frac <= TOL_FLIP, f"winner mismatch {frac} > {TOL_FLIP}")
        return {"max_abs_err": frac, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "shape": [b, n, t, h, w],
                "err": "winner mismatch fraction", **bd}

    def splat_case(b, role):
        """K4 at [b, 128, 256, 2] coords (base grid + a +-10 px flow)."""
        h, w = 128, 256
        flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 20).to(dev)
        xs = torch.arange(w, device=dev, dtype=torch.float32)
        ys = torch.arange(h, device=dev, dtype=torch.float32)
        base = torch.stack([xs[None].expand(h, w), ys[:, None].expand(h, w)], -1)
        coords = (base[None] + flow).contiguous()
        run = lambda: sk.corresponding_map(coords)              # noqa: E731
        plain = lambda: sk.corresponding_map_plain(coords)      # noqa: E731
        got, want = run(), plain()
        err = (got - want).abs().max().item()
        flips = (splat.clip_mask(got.clamp(0, 1))
                 != splat.clip_mask(want.clamp(0, 1))).float().mean().item()
        ms, plain_ms = time_ms(run), time_ms(plain)
        bd = bound(nbytes(coords, got), 14 * got.numel())
        log(f"  corresponding_map {role} [{b},128,256,2]: max|diff| {err:.3g} "
            f"(tol {TOL_SPLAT}), 0.5-threshold flips {flips:.3g} (tol "
            f"{TOL_FLIP})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})  no single library "
            f"call")
        check(err <= TOL_SPLAT and flips <= TOL_FLIP,
              f"splat max|diff| {err} / flips {flips} over tolerance")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "shape": [b, h, w, 2], "flips": flips, **bd}

    rows["warp_masks_winner"] = maskwarp_case(12, "serving")
    train["warp_masks_winner"] = maskwarp_case(3, "train")
    rows["corresponding_map"] = splat_case(60, "serving")
    train["corresponding_map"] = splat_case(15, "train")
    # a forward kernel's row is its serving shape's; its check and times at
    # the train step's shape ride along under "train"
    for name, case in train.items():
        rows[name]["train"] = case
    return rows


def build_model(cfg):
    """C2MGenerator(cfg) on the CPU with seeded random weights; the GNN
    affine heads (zero-initialised, so every theta would be the identity)
    get small random weights so the click path sees general affines."""
    from c2m_tpu_torch.models.c2m import C2MGenerator, init_random_
    from c2m_tpu_torch.models.sparse_motion import AffineHead
    gen = torch.Generator().manual_seed(SEED)
    model = init_random_(C2MGenerator(cfg), gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AffineHead):
                m.fc2.weight.uniform_(-0.01, 0.01, generator=gen)
    return model.eval()


def requests(cfg, dev):
    """Three requests of synthetic scenes with all 16 nodes real."""
    from c2m_tpu_torch.data.synthetic import make_batch
    from c2m_tpu_torch.serving import z_dim
    n = cfg.dataset_params.max_objects
    out = []
    for seed, bs in ((1, BUCKET), (2, 5), (3, BUCKET)):
        batch = make_batch(cfg, batch_size=bs, seed=seed, num_objects=n,
                           device=dev)
        g = torch.Generator().manual_seed(100 + seed)
        z = torch.randn(bs, z_dim(cfg), generator=g).numpy()
        click = np.zeros((bs, n), np.float32)
        click[np.arange(bs), torch.randint(0, n, (bs,), generator=g).numpy()] = 1
        out.append((batch, z, click))
    return out


def phase_serving(cfg, dev, profile: bool = False):
    """Phase 4: the serving path through ServingModel; returns launch counts."""
    from c2m_tpu_torch.models.c2m import DTYPES
    from c2m_tpu_torch.serving import ServingModel
    kernels = all_kernels()
    log(f"[phase 4] ServingModel, journal config at full width, bucket "
        f"{BUCKET}, dtype {cfg.train_params.dtype}")
    model = build_model(cfg).to(dev).set_compute_dtype(
        DTYPES[cfg.train_params.dtype])
    gt = ServingModel(model, (BUCKET,), use_gt_eval=True)
    click_path = ServingModel(model, (BUCKET,), use_gt_eval=False)
    reqs = requests(cfg, dev)
    plan = [("batch 12, GT thetas", gt, reqs[0]),
            ("batch 5 padded to 12, GT thetas", gt, reqs[1]),
            ("batch 12, click path (GNN thetas)", click_path, reqs[2])]
    h, w = cfg.test_params.input_size
    tpred = cfg.test_params.num_predicted_frames
    for k in kernels:
        k.launches = 0
    warm_request_ms = None
    for name, server, (batch, z, click) in plan:
        times = []
        for _ in range(3):               # cold (cuDNN plans), then warm
            t0 = time.perf_counter()
            out = server(batch, z, click)
            times.append((time.perf_counter() - t0) * 1e3)
        if warm_request_ms is None:
            warm_request_ms = min(times[1:])
        bs = z.shape[0]
        gen = out["generated"]
        check(gen.shape == (bs, tpred, h, w, 3), f"{name}: shape {gen.shape}")
        check(bool(np.isfinite(gen).all()), f"{name}: non-finite frames")
        check(gen.min() >= 0.0 and gen.max() <= 1.0, f"{name}: outside [0,1]")
        for key in ("dense_motion_bw", "occlusion_bw", "sparse_motion_bw",
                    "generated_sparse"):
            check(bool(np.isfinite(out[key]).all()), f"{name}: {key} finite")
        if server is click_path:
            dev_id = np.abs(out["thetas"] - np.array([1, 0, 0, 0, 1, 0],
                                                     np.float32)).max()
            check(dev_id > 1e-3, "click path saw identity thetas only")
        log(f"  {name}: generated {list(gen.shape)} in [{gen.min():.3f}, "
            f"{gen.max():.3f}]; latency ms cold {times[0]:.1f}, warm "
            f"{times[1]:.1f}, {times[2]:.1f}")
    counts = {k.name: k.launches for k in kernels}
    log(f"  launches over the three requests: {counts}")
    for name, c in counts.items():
        # serving differentiates nothing: the backward kernels stay at 0
        check((c > 0) != ("_bwd_" in name),
              f"kernel {name}: {c} launches on the serving path")
    if profile:
        profile_window("request", lambda: gt(*reqs[0]), warm_request_ms)
    # padded request == the same rows served alone in a bucket of their own
    solo = ServingModel(model, (5,), use_gt_eval=True)(*reqs[1])
    padded = gt(*reqs[1])
    pad_err = float(np.abs(solo["generated"] - padded["generated"]).max())
    log(f"  padded vs unpadded batch 5: max|diff| generated {pad_err:.3g} "
        f"(tol {TOL_PAD:.3g})")
    check(pad_err <= TOL_PAD, f"padded rows differ by {pad_err} > {TOL_PAD}")
    return counts


def phase_cpu_parity(cfg, dev):
    """Phase 5: float32 slice at batch 2, card (kernels) vs CPU (plain)."""
    from c2m_tpu_torch.data.synthetic import make_batch
    from c2m_tpu_torch.serving import z_dim
    cfg32 = copy.deepcopy(cfg)
    cfg32.train_params.dtype = "float32"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[phase 5] float32 slice at batch 2: card (kernels) vs CPU (plain), "
        "TF32 off")
    cpu_model = build_model(cfg32)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    n = cfg.dataset_params.max_objects
    batch = make_batch(cfg32, batch_size=2, seed=7, num_objects=n, device=dev)
    g = torch.Generator().manual_seed(7)
    z = torch.randn(2, z_dim(cfg32), generator=g)
    click = torch.zeros(2, n)
    click[:, 0] = 1
    worst = 0.0
    for gt in (True, False):
        outs = []
        for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
            bt = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            with torch.inference_mode():
                o = model.inference(bt, z.to(d), click.to(d), gt)
            outs.append({k: v.float().cpu() for k, v in o.items()})
        cpu, gpu = outs
        diff = (cpu["generated"] - gpu["generated"]).abs().max().item()
        wmis = (cpu["winner_bw"] != gpu["winner_bw"]).float().mean().item()
        flow = (cpu["dense_motion_bw"] - gpu["dense_motion_bw"]).abs().max().item()
        log(f"  use_gt_eval={gt}: max|diff| generated {diff:.3g} (tol "
            f"{TOL_SLICE}), dense flow {flow:.3g}, winner_bw mismatch "
            f"{wmis:.3g} (tol {TOL_FLIP})")
        check(diff <= TOL_SLICE and wmis <= TOL_FLIP,
              f"card vs CPU slice over tolerance (gt={gt})")
        worst = max(worst, diff)
    return worst


def all_kernels():
    from c2m_tpu_torch.ops.hopper import (maskwarp_kernel, splat_kernel,
                                          warp_kernels)
    return (warp_kernels.KERNELS + maskwarp_kernel.KERNELS
            + splat_kernel.KERNELS)


def train_batch(cfg, dev, batch_size, seed):
    """A synthetic training batch with all nodes real, as tensors on dev."""
    from c2m_tpu_torch.data.synthetic import make_batch
    batch = make_batch(cfg, batch_size=batch_size, seed=seed,
                       num_objects=cfg.dataset_params.max_objects, device=dev)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def phase_train(cfg, dev, profile: bool):
    """Phase 6: three steps of the train step at the journal config."""
    from c2m_tpu_torch.nn.layers import BatchNorm, SpectralNormConv
    from c2m_tpu_torch.train.state import (GROUPS, create_train_state,
                                           param_group)
    from c2m_tpu_torch.serving import z_dim
    from c2m_tpu_torch.train.model import total_generator_loss
    from c2m_tpu_torch.train.step import make_eval_step, make_train_step
    tp = cfg.train_params
    log(f"[phase 6] train step, journal config at full width and depth: "
        f"batch {tp.batch_size}, {tp.num_predicted_frames} predicted frames "
        f"at {tp.input_size}, compute {tp.dtype}, float32 parameters")
    state = create_train_state(cfg, seed=SEED, device=dev)
    model = state.model
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "parameters must stay float32")
    n_params = sum(p.numel() for p in model.parameters())
    batches = [train_batch(cfg, dev, tp.batch_size, seed) for seed in (11, 12, 13)]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_train_step(cfg)
    for k in all_kernels():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    history, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    counts = {k.name: k.launches for k in all_kernels()}
    peak = torch.cuda.max_memory_allocated()

    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"step {i + 1}: non-finite metrics {bad}")
    want_keys = {"total_gen", "total_image_dis", "total_video_dis",
                 "d_real_image", "d_fake_image", "d_real_video", "d_fake_video",
                 "perceptual", "warped", "kl", "g_gan_image", "g_gan_video"}
    check(want_keys <= set(history[0]), f"metrics lack "
          f"{sorted(want_keys - set(history[0]))}")
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # the three steps saw three batches, so their totals differ anyway: what
    # shows learning is the generator objective of one batch, with the same
    # noise and click, under the weights before and after the three steps
    g = torch.Generator().manual_seed(SEED)
    eps = torch.randn(tp.batch_size, z_dim(cfg), generator=g).to(dev)
    click = torch.zeros(tp.batch_size, cfg.dataset_params.max_objects,
                        device=dev)
    click[:, 0] = 1
    eval_step = make_eval_step(cfg)
    objective = {}
    for when, weights in (("after", after), ("before", before), ("", after)):
        model.load_state_dict(weights)
        if when:
            objective[when] = float(total_generator_loss(
                cfg, eval_step(state, batches[0], eps, click)[1]))
    log(f"  generator objective of batch 1 in eval mode: "
        f"{objective['before']:.4f} before the three steps, "
        f"{objective['after']:.4f} after")
    check(all(np.isfinite(v) for v in objective.values())
          and objective["before"] != objective["after"],
          f"the generator objective did not move: {objective}")
    moved = {g: False for g in GROUPS}
    for name, p in model.named_parameters():
        g = param_group(name)
        changed = not torch.equal(after[name], before[name])
        if g == "frozen":
            check(not changed, f"frozen parameter {name} changed")
        else:
            moved[g] |= changed
    check(all(moved.values()), f"optimizer groups that did not move: {moved}")
    for name, m in model.named_modules():
        if name.startswith("vgg"):
            continue
        if isinstance(m, SpectralNormConv):
            check(not torch.equal(after[name + ".u"], before[name + ".u"]),
                  f"spectral u of {name} did not move")
        if isinstance(m, BatchNorm):
            check(not torch.equal(after[name + ".running_mean"],
                                  before[name + ".running_mean"]),
                  f"running mean of {name} did not move")
    check(state.step == 3, "step count")
    log(f"  {n_params / 1e6:.1f}M parameters; step ms cold {times[0]:.1f}, "
        f"warm {times[1]:.1f}, {times[2]:.1f}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    for i, m in enumerate(history):
        log(f"  step {i + 1}: total_gen {m['total_gen']:.4f}  image D "
            f"{m['total_image_dis']:.4f}  video D {m['total_video_dis']:.4f}  "
            f"perceptual {m['perceptual']:.4f}  warped {m['warped']:.4f}  "
            f"kl {m['kl']:.4f}")
    log(f"  launches over the three steps: {counts}")
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched by the train step")
    if profile:
        profile_window("train_step", lambda: step(state, batches[0]),
                       min(times[1:]))
    return counts


def phase_train_cpu_parity(cfg, dev):
    """Phase 7: float32 train model at batch 1, card (kernels) vs CPU."""
    from c2m_tpu_torch.train.model import C2MTrainModel
    from c2m_tpu_torch.train.state import GROUPS, param_group
    from c2m_tpu_torch.train.step import combined_loss
    from c2m_tpu_torch.serving import z_dim
    cfg32 = copy.deepcopy(cfg)
    cfg32.train_params.dtype = "float32"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[phase 7] float32 train model at batch 1, full width: card (kernels)"
        " vs CPU (plain), one forward+backward, TF32 off")
    torch.manual_seed(SEED)
    cpu_model = C2MTrainModel(cfg32).train()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = train_batch(cfg32, "cpu", 1, 21)
    g = torch.Generator().manual_seed(21)
    eps = torch.randn(1, z_dim(cfg32), generator=g)
    click = torch.zeros(1, cfg32.dataset_params.max_objects)
    click[0, 3] = 1
    results = []
    for model, d in ((cpu_model, torch.device("cpu")), (gpu_model, dev)):
        bt = {k: v.to(d) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, ld, ldi, ldv = model(bt, eps.to(d), click.to(d))
        total, metrics = combined_loss(cfg32, ld, ldi, ldv)
        total.backward()
        grads = {gname: [] for gname in GROUPS}
        for name, p in model.named_parameters():
            if param_group(name) != "frozen":
                check(p.grad is not None, f"{name} got no gradient")
                grads[param_group(name)].append(p.grad.detach().cpu().flatten())
        results.append(({k: float(v.detach()) for k, v in metrics.items()},
                        {k: torch.cat(v).double() for k, v in grads.items()}))
        log(f"  forward+backward on {d.type}: "
            f"{time.perf_counter() - t0:.1f} s")
    (cpu_m, cpu_g), (gpu_m, gpu_g) = results
    worst = 0.0
    for k in sorted(cpu_m):
        rel = abs(cpu_m[k] - gpu_m[k]) / max(abs(cpu_m[k]), 1e-12)
        ok = abs(cpu_m[k] - gpu_m[k]) <= 1e-5 + TOL_LOSS_REL * abs(cpu_m[k])
        log(f"  {k}: cpu {cpu_m[k]:.6g}  card {gpu_m[k]:.6g}  rel {rel:.2g}")
        check(ok, f"loss term {k}: cpu {cpu_m[k]} vs card {gpu_m[k]}")
        worst = max(worst, rel)
    for gname in GROUPS:
        a, b = cpu_g[gname], gpu_g[gname]
        cos = float(a @ b / (a.norm() * b.norm()))
        ratio = float(b.norm() / a.norm())
        log(f"  gradient of group {gname} ({a.numel()} values): cos "
            f"{cos:.6f} (gate > {TOL_GRAD_COS}), |card|/|cpu| {ratio:.5f} "
            f"(gate within {TOL_GRAD_NORM})")
        check(cos > TOL_GRAD_COS and abs(ratio - 1) < TOL_GRAD_NORM,
              f"gradient of {gname}: cos {cos}, norm ratio {ratio}")
    return worst


def profile_window(name: str, fn, warm_ms: float) -> None:
    """torch.profiler over one warm call of fn: device time by operator and
    by kernel, launches and idle share, printed. The profiler slows the host, so the idle share is also
    given against ``warm_ms``, the same call's time without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device-side events (kernels, memcpys) give the busy time; the same
    # time attributed to the operators that launched them gives the split
    # (not the profiler's own ranges, e.g. "Optimizer.step", which cover
    # kernels that are counted already)
    on_device = [e for e in avgs if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in on_device) / 1e3
    launches = sum(e.count for e in on_device)
    check(busy > 0, "the profiler saw no device time")

    def top(events, n):
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in events if e.self_device_time_total > 0),
                      reverse=True)
        return [f"  {ms:9.3f} ms  x{c:<6d} {key[:100]}" for ms, c, key in rows[:n]]

    lines = [f"{name}: device busy {busy:.2f} ms in {launches} device events; "
             f"wall {warm_ms:.2f} ms unprofiled (idle share "
             f"{max(0.0, 1 - busy / warm_ms):.3f}), {wall:.2f} ms under the "
             f"profiler (idle share {max(0.0, 1 - busy / wall):.3f})",
             " device time by operator:"]
    lines += top([e for e in avgs if e.device_type == DeviceType.CPU], 30)
    lines += [" device time by kernel:"] + top(on_device, 30)
    for line in lines:
        log("  [profile] " + line)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one GPU",
              file=sys.stderr)
        return 2
    profile = "--profile" in sys.argv[1:]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from c2m_tpu_torch.config import load_config
    from c2m_tpu_torch.ops import hopper

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[phase 1] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(smi)

    t0 = time.perf_counter()
    lib = hopper.build()
    hopper.library()
    log(f"[phase 2] kernels built from c2m_tpu_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib)}")

    rows = phase_kernels(dev)
    cfg = load_config()                     # configs/c2m_journal_cityscapes.yaml
    serving_counts = phase_serving(cfg, dev, profile)
    phase_cpu_parity(cfg, dev)
    train_counts = phase_train(cfg, dev, profile)
    phase_train_cpu_parity(cfg, dev)
    loaded = {m.split(".")[0] for m in sys.modules}
    check(not loaded & {"jax", "jaxlib", "flax", "optax"}, "JAX was imported")
    check("c2m_tpu" not in loaded, "the JAX package c2m_tpu was imported")

    kernels = []
    for k in all_kernels():
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": serving_counts[k.name] + train_counts[k.name],
                        "launches_serving": serving_counts[k.name],
                        "launches_train": train_counts[k.name],
                        **rows[k.name]})
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
