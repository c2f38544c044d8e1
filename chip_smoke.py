#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: serving and
the train step at the journal config (128x256) and at the long-horizon
config (512x1024), and FlowNet2 on-the-fly flow feeding a train step.

    python3 chip_smoke.py [--profile]

Phases (any failure raises and the script exits non-zero):
  1. torch / CUDA versions and the card's name and power limit;
  2. build the hand-written kernels from c2m_tpu_torch/csrc (nvcc, ctypes);
  3. each kernel against its plain PyTorch version on the card at the
     shapes the paths give it (journal serving: B=12, T=5, N=16, 128x256;
     journal train: 15 folded frames; long horizon: B=4 and B=1, T=10, N=24,
     512x1024, with every decoder skip of K1 at 10 and 40 folded frames;
     FlowNetC's map [30,16,32,256] and the 30 frame pairs of K4's
     confidence), forward and, for K1, backward
     against autograd of the plain version, with median times (CUDA events,
     after warm-up), the least time the card could take (bound) and, where
     one PyTorch call computes the same function (F.grid_sample for K1),
     that call's time. K1 reads one image for the T frames of a clip where
     the paths do (decoder skips, previews, warped loss: ``frames``), and
     is held there to the forward of the repeated image bit for bit. K1
     forward and K4 are held and timed on two kinds of
     flow: independent noise per pixel (the row of record) and a smooth flow
     as a request's dense flow looks; their times are given twice, around
     one call (the wrapper's host time included, as for every kernel) and
     for the device alone (a CUDA graph of 20 launches). K1 backward is
     timed three times (around one call, through autograd, device alone)
     and, device alone, in turns with its first version (route scalar64)
     on the same inputs, which it must not trail; its flow and mask
     gradients, stored without atomics, must repeat bit for bit. Both also
     run once
     at what the paths never give them (every route of K1, unaligned views,
     1-wide images; K4 at flows longer than its halo, ragged sizes, NaN and
     far-out coordinates). K2 and K3 run on the same inputs, equal to each
     other, timed around one call and device alone in turns, with K3's
     passes apart: at both kernels' path shapes, for GT-like, GNN-like and
     window-overflowing thetas, on image-wide objects and with N near K3's
     node limit;
  4. a ServingModel at the journal config's full width
     (configs/c2m_journal_cityscapes.yaml, bfloat16 compute, batch bucket
     12), random weights from a seeded torch.Generator, answering three
     requests: batch 12 with GT thetas, batch 5 padded into the bucket,
     batch 12 on the click path (GNN thetas). Every forward kernel of the
     128x256 path must be launched, and no other;
  5. the same slice in float32 at batch 2: the card (kernels) against the
     CPU (plain versions), TF32 off;
  6. the train step at the journal config, nothing cut: batch 3, bfloat16
     compute with float32 parameters, both discriminators, VGG perceptual
     loss, seeded weights, synthetic scenes with all 16 nodes real; three
     steps through make_train_step. Every metric finite, the generator
     objective of one batch moves between the weights before and after,
     every optimizer group moves and VGG does not, running statistics and
     spectral u move, every kernel of the path (K1 backward included)
     launched;
  7. the train model in float32 at batch 1, TF32 off: one forward+backward
     on the card (kernels) against the CPU (plain versions), same noise and
     click: every loss term and the gradient of each optimizer group;
  8. on-the-fly flow: OnTheFlyFlow (FlowNet2 at its one width, 162M seeded
     parameters, float32) on a journal batch of 3, all 30 frame pairs in
     one call; its outputs replace the batch's precomputed flows and feed
     one train step with use_pre_processed_of: false. K5 launched once per
     call and K4 by the confidence; FlowNet2 card vs CPU in float32 at one
     64x128 pair, TF32 off;
  9. a ServingModel at configs/c2m_long_horizon.yaml, full width and depth
     (512x1024, 1 + 10 frames, 24 nodes, bfloat16 compute), buckets (1, 4):
     batch 4 with GT thetas, batch 1 and batch 3 (padded into 4) on the
     click path. K3 launched and K2 not; latency and peak memory;
 10. the rasterizer alone at one 512x1024 clip, card (K3, K4) vs CPU;
 11. two train steps at the long-horizon config, batch 1 (the YAML's 16 is
     one clip per chip of a 16-chip mesh), with the checks of phase 6; K1
     forward and backward, K3 and K4 launched; step time and peak memory.
With --profile, torch.profiler splits one warm train step and one warm
request of each config by operator and by kernel (printed).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero at once when no
CUDA device is visible. Imports nothing of JAX and nothing of c2m_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import gc
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
LONG_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "c2m_long_horizon.yaml")
LONG_BUCKETS = (1, 4)

# tolerances of kernel vs plain version on the card, and why
TOL_F32 = 1e-5          # same float32 ops; the plain CUDA ops may contract
TOL_BF16 = 2.0 ** -8    # one bf16 rounding of the same float32 value in [0,1]
TOL_SPLAT = 1e-5        # atomics reorder float32 sums of masses <= ~4
TOL_CORR = 1e-5         # the same float32 products summed over 256 channels
                        # in another order; means of order 1
TOL_FLOWNET = 1e-3      # FlowNet2 card vs CPU, float32, TF32 off: ~100 conv
                        # layers summed in other orders; flows of order 1 px
TOL_OCC = 1e-3          # share of occlusion pixels that may differ card vs
                        # CPU: splat atomics at the 0.5 threshold, and the
                        # neighbours of a flipped winner pixel
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


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Median milliseconds of one call on the device alone: ``launches``
    calls recorded into one CUDA graph and replayed, so that the host's time
    to reach the launch (checks, allocation, ctypes) is not in it. For the
    shapes whose kernel is shorter than that host time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, reps=reps, warmup=1) / launches


def kernel_split(fn, names: dict, calls: int = 5) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches, by a
    substring of its name (``names``: label -> substring), from
    torch.profiler over ``calls`` calls after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {label: 0.0 for label in names}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        for label, part in names.items():
            if part in e.key:
                out[label] += e.self_device_time_total / 1e3 / calls
    return out


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


@contextlib.contextmanager
def tf32_off():
    """float32 matmuls and convolutions in full float32 inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def grid_of(flow: torch.Tensor) -> torch.Tensor:
    """The normalized grid for which F.grid_sample(padding_mode='border',
    align_corners=False) computes K1's function."""
    _, h, w, _ = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    sx = (xs[None, None, :] + flow[..., 0]) * (w / (w - 1.0)) - 0.5
    sy = (ys[None, :, None] + flow[..., 1]) * (h / (h - 1.0)) - 0.5
    return torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], dim=-1)


def smooth_flow(g, b, h, w, dev, px: float = 8.0) -> torch.Tensor:
    """A flow as a request's dense flow looks: noise of +-px pixels at 1/16
    of the resolution, bilinearly enlarged to [b, h, w, 2]."""
    import torch.nn.functional as F
    low = (torch.rand(b, 2, max(2, h // 16), max(2, w // 16), generator=g)
           - 0.5) * 2 * px
    return F.interpolate(low.to(dev), size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1).contiguous()


def grid_coords(flow: torch.Tensor) -> torch.Tensor:
    """The pixel grid plus flow [b, h, w, 2]: K4's target coordinates."""
    _, h, w, _ = flow.shape
    xs = torch.arange(w, device=flow.device, dtype=torch.float32)
    ys = torch.arange(h, device=flow.device, dtype=torch.float32)
    base = torch.stack([xs[None].expand(h, w), ys[:, None].expand(h, w)], -1)
    return (base[None] + flow).contiguous()


def splat_check(sk, splat, coords, piled: bool = False):
    """K4 against its plain version on coords: (max |diff|, share of
    0.5-threshold flips, the largest mass, the kernel's output, the two
    callables). TOL_SPLAT is absolute and was set for the masses that
    independent noise leaves, up to ~4: about 20 float32 steps there.
    ``piled``: a smooth flow piles tens of points onto a pixel where it
    converges, and a float32 sum added in another order differs by steps of
    its own size; a pixel of mass m above 4 is then held to the same number
    of steps, TOL_SPLAT * m / 4. The difference returned is absolute either
    way."""
    run = lambda: sk.corresponding_map(coords)                  # noqa: E731
    plain = lambda: sk.corresponding_map_plain(coords)          # noqa: E731
    got, want = run(), plain()
    diff = (got - want).abs()
    tol = torch.full_like(want, TOL_SPLAT)
    if piled:
        tol = tol * (want / 4.0).clamp(min=1.0)
    flips = (splat.clip_mask(got.clamp(0, 1))
             != splat.clip_mask(want.clamp(0, 1))).float().mean().item()
    err, mass = diff.max().item(), want.max().item()
    check(bool((diff <= tol).all()) and flips <= TOL_FLIP,
          f"splat {list(coords.shape)}: max|diff| {err} at masses up to "
          f"{mass} / flips {flips} over tolerance")
    return err, flips, mass, got, run, plain


def odd_cases(dev, g):
    """K1 forward and K4 once (untimed) at what the paths never give them:
    every route of K1 (channel counts that do and do not fill 16 bytes,
    1-wide and 1-high images, a view that is not 16-byte aligned), exact
    against the plain version in both types; K4 at flows longer than the
    halo, sizes that are no multiple of the tile or of 4, NaN, infinite and
    far-out coordinates, and coordinates that are not 8-byte aligned."""
    from c2m_tpu_torch.ops import splat
    from c2m_tpu_torch.ops.hopper import splat_kernel as sk
    from c2m_tpu_torch.ops.hopper import warp_kernels as wk
    seen = set()
    shapes = [(2, 17, 33, c) for c in (1, 2, 3, 4, 5, 8, 12, 64, 72, 256, 512)]
    shapes += [(2, 6, 1, 3), (2, 1, 9, 3), (3, 1, 1, 8), (2, 5, 1, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            for aligned in (True, False):
                n = int(np.prod(shape))
                buf = torch.rand(n + 1, generator=g).to(dtype).to(dev)
                img = buf[0 if aligned else 1:][:n].view(shape)
                flow = ((torch.rand(*shape[:3], 2, generator=g) - 0.5) * 16
                        ).to(dev)
                mask = torch.rand(*shape[:3], 1, generator=g).to(dev)
                check(img.is_contiguous()
                      and (img.data_ptr() % 16 == 0) == aligned, "odd view")
                seen.add(wk.resample_route(dtype, shape, aligned))
                for m in (None, mask):
                    got = (wk.resample(img, flow) if m is None
                           else wk.resample_masked(img, flow, m))
                    want = wk.resample_plain(img, flow, m)
                    err = (got.float() - want.float()).abs().max().item()
                    check(err == 0.0, f"K1 {dtype} {shape} aligned={aligned} "
                          f"masked={m is not None}: max|diff| {err} != 0")
    # every route by name on one shape each takes, the 64-bit one included
    img = torch.rand(2, 17, 33, 4, generator=g).to(dev)
    flow = ((torch.rand(2, 17, 33, 2, generator=g) - 0.5) * 16).to(dev)
    want = wk.resample_plain(img, flow, None)
    for route in wk.ROUTES:
        check(torch.equal(wk._launch(img, flow, None, route=route), want),
              f"K1 route {route} differs from the plain version")
    check(seen == {"vec", "pixel", "scalar"}, f"K1 routes seen: {seen}")
    log(f"  K1 forward, {len(shapes)} odd shapes x 2 types x (un)aligned x "
        f"(un)masked and each of the routes {sorted(wk.ROUTES)} by name: "
        f"max|diff| 0")

    tw, th = sk.TILE
    for b, h, w, px in ((2, 50, 70, 3.0), (2, 50, 70, 4.0 * sk.HALO),
                        (1, th + 1, tw + 4, 10.0), (3, 2 * th, 2 * tw, 40.0),
                        (2, 7, 5, 2.0)):
        flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 2 * px).to(dev)
        coords = grid_coords(flow)
        splat_check(sk, splat, coords)
        # coordinates that add nothing, whatever they hold
        clean = sk.corresponding_map(coords)
        dirty = coords.clone()
        dirty[0, 3, 4] = float("nan")
        dirty[0, 5, 3, 0] = float("inf")
        dirty[0, 6, 2, 1] = -1e30
        dirty[-1, 2, 1] = torch.tensor([3e9, 1.0], device=dev)
        lost = coords.clone()
        for bi, y, x in ((0, 3, 4), (0, 5, 3), (0, 6, 2), (b - 1, 2, 1)):
            lost[bi, y, x] = -5.0                # off the image: adds nothing
        err = (sk.corresponding_map(dirty)
               - sk.corresponding_map(lost)).abs().max().item()
        check(err <= TOL_SPLAT and bool(torch.isfinite(clean).all()),
              f"K4 [{b},{h},{w}]: NaN / infinite / far coordinates added "
              f"{err}")
        buf = torch.zeros(coords.numel() + 1, device=dev)
        odd = buf[1:].view(coords.shape).copy_(coords)
        check(odd.data_ptr() % 8 != 0, "odd view")
        splat_check(sk, splat, odd)
    log("  K4, flows shorter and longer than the halo, ragged sizes, NaN / "
        "infinite / far-out and unaligned coordinates: within tolerance")


def phase_kernels(dev):
    """Phase 3: kernel vs plain version at the two paths' shapes."""
    import torch.nn.functional as F
    from c2m_tpu_torch.ops import splat
    from c2m_tpu_torch.ops.hopper import correlation_kernel as ck
    from c2m_tpu_torch.ops.hopper import maskwarp_banded as mb
    from c2m_tpu_torch.ops.hopper import maskwarp_kernel as mk
    from c2m_tpu_torch.ops.hopper import splat_kernel as sk
    from c2m_tpu_torch.ops.hopper import warp_kernels as wk
    g = torch.Generator().manual_seed(SEED)
    rows = {}

    def inputs(dtype, shape, masked, frames=1):
        """An image of shape[0] / frames rows; flow and mask of shape[0]."""
        b, h, w, c = shape
        img = torch.rand(b // frames, h, w, c, generator=g).to(dtype).to(dev)
        flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 16).to(dev)
        mask = torch.rand(b, h, w, 1, generator=g).to(dev) if masked else None
        return img, flow, mask

    def resample_fns(img, flow, mask, frames=1):
        """The kernel, its plain version and the library call (yardstick
        only, the port never calls it: the warp without the mask product,
        grid, NCHW view and the image repeated for its frames made
        beforehand) on one set of inputs."""
        if mask is not None:
            run = lambda: wk.resample_masked(img, flow, mask,   # noqa: E731
                                             frames=frames)
        else:
            run = lambda: wk.resample(img, flow, frames=frames)  # noqa: E731
        plain = lambda: wk.resample_plain(img, flow, mask,      # noqa: E731
                                          frames)
        grid = grid_of(flow).to(img.dtype)
        nchw = img.repeat_interleave(frames, 0).permute(0, 3, 1, 2)
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear",  # noqa: E731
                                    padding_mode="border", align_corners=False)
        return run, plain, lib

    def resample_case(kernel, dtype, shape, masked, role, frames=1):
        """K1 forward at the output shape ``shape``, the image passed once
        for ``frames`` rows of it."""
        img, flow, mask = inputs(dtype, shape, masked, frames)
        run, plain, lib = resample_fns(img, flow, mask, frames)
        err = (run().float() - plain().float()).abs().max().item()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        if frames > 1:
            # exactly what the repeated image gives at frames=1
            rep = img.repeat_interleave(frames, 0)
            same = torch.equal(run(), resample_fns(rep, flow, mask)[0]())
            check(same, f"{kernel.name} {shape} frames={frames} differs from "
                  f"the repeated image")
        ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib)
        # the same image and mask under a smooth flow, as a request's dense
        # flow looks (the noise above stays the row of record)
        s_run, s_plain, s_lib = resample_fns(
            img, smooth_flow(g, shape[0], shape[1], shape[2], dev), mask,
            frames)
        s_err = (s_run().float() - s_plain().float()).abs().max().item()
        smooth = {"max_abs_err": s_err, "ms": time_ms(s_run),
                  "library_ms": time_ms(s_lib), "device_ms": device_ms(s_run),
                  "library_device_ms": device_ms(s_lib)}
        dev_ms, lib_dev_ms = device_ms(run), device_ms(lib)
        out_bytes = nbytes(img) * frames
        n = int(np.prod(shape))
        pix = n // shape[3]
        bd = bound(nbytes(img, flow, mask) + out_bytes, 16 * pix + 10 * n)
        log(f"  {kernel.name} {role} {list(shape)} frames={frames} "
            f"masked={masked} route {wk.resample_route(dtype, shape)}: "
            f"max|diff| {err:.3g} (tol {tol:.3g})  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  grid_sample {lib_ms:.4f} ms  bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})  device alone: "
            f"kernel {dev_ms:.4f}  grid_sample {lib_dev_ms:.4f};  smooth "
            f"flow: max|diff| {s_err:.3g}  kernel {smooth['ms']:.4f} ms  "
            f"grid_sample {smooth['library_ms']:.4f} ms  device alone: "
            f"kernel {smooth['device_ms']:.4f}  grid_sample "
            f"{smooth['library_device_ms']:.4f}")
        check(err <= tol and s_err <= tol,
              f"{kernel.name} {shape}: max|diff| {err}, {s_err} > {tol}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "device_ms": dev_ms,
                "library_device_ms": lib_dev_ms, "shape": list(shape),
                "frames": frames, "layout": wk.resample_route(dtype, shape),
                **bd, "smooth": smooth}

    def backward_case(kernel, dtype, shape, masked, needs, role, frames=1):
        """K1's gradients (needs: which of image, flow, mask) at the output
        shape ``shape``, the image passed once for ``frames`` rows, against
        autograd of the plain version and against F.grid_sample's (on the
        image repeated for its frames, the sum over them included)."""
        img, flow, mask = inputs(dtype, shape, masked, frames)
        gout = torch.randn(shape, generator=g).to(dtype).to(dev)
        names = [n for n, need in zip(("image", "flow", "mask"), needs) if need]
        route = wk.resample_backward_route(dtype, shape)

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
            return (wk.resample_masked(i, f, m, frames=frames) if masked
                    else wk.resample(i, f, frames=frames))

        def plain_fn(i, f, m):
            return wk.resample_plain(i, f, m, frames)

        def lib_fn(i, f, m):
            out = F.grid_sample(i.repeat_interleave(frames, 0).permute(
                0, 3, 1, 2), grid_of(f).to(dtype), mode="bilinear",
                padding_mode="border", align_corners=False).permute(0, 2, 3, 1)
            return out * m.to(dtype) if m is not None else out

        run, plain, lib = (grads_of(kernel_fn), grads_of(plain_fn),
                           grads_of(lib_fn))
        # the forward that the backward differentiates, on the same inputs
        with torch.no_grad():
            fwd_err = (kernel_fn(img, flow, mask).float()
                       - plain_fn(img, flow, mask).float()
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
        # same through autograd, as the train step reaches it; the first
        # version of the kernel (route scalar64) on the same inputs
        def direct(r=None):
            return wk._launch_backward(gout, img, flow, mask, *needs, frames,
                                       route=r)

        first, again = direct(), direct()
        if route != "scalar64":
            # the flow and mask gradients are stored, not accumulated: equal
            # run to run
            for k in (1, 2):
                check(first[k] is None or torch.equal(first[k], again[k]),
                      f"{kernel.name} {shape}: gradient {k} differs between "
                      f"two runs")
        ms, autograd_ms = time_ms(direct), time_ms(run)
        plain_ms, lib_ms = time_ms(plain, reps=10), time_ms(lib)
        old = lambda: direct("scalar64")                        # noqa: E731
        turns = [device_ms(old), device_ms(direct), device_ms(direct),
                 device_ms(old)]
        dev_ms, old_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        # the wrapper's device work by kernel: the zero-fill, the kernel, the
        # cast
        parts = {"fill": "Fill", "kernel": "resample_bwd", "cast": "copy"}
        split, old_split = kernel_split(direct, parts), kernel_split(old, parts)
        n = int(np.prod(shape))
        pix = n // shape[3]
        need_taps = needs[1] or needs[2]
        moved = (nbytes(gout, flow, mask) + (nbytes(img) if need_taps else 0)
                 + (nbytes(img) if needs[0] else 0)
                 + (nbytes(flow) if needs[1] else 0)
                 + (nbytes(mask) if needs[2] else 0))
        bd = bound(moved, 16 * pix + 25 * n)
        log(f"  {kernel.name} {role} {list(shape)} frames={frames} route "
            f"{route} grads {names}: kernel {ms:.4f} ms ({autograd_ms:.4f} "
            f"through autograd; device alone {dev_ms:.4f}, first version "
            f"{old_ms:.4f} in turns {[round(t, 4) for t in turns]}; by "
            f"kernel {({k: round(v, 4) for k, v in split.items()})}, first "
            f"version's "
            f"{({k: round(v, 4) for k, v in old_split.items()})})  plain "
            f"autograd {plain_ms:.4f} ms  grid_sample backward {lib_ms:.4f} "
            f"ms  bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        check(dev_ms <= 1.1 * old_ms, f"{kernel.name} {shape} frames={frames}"
              f": device alone {dev_ms} slower than its first version "
              f"{old_ms}")
        return {"max_abs_err": worst, "ms": ms, "autograd_ms": autograd_ms,
                "device_ms": dev_ms, "first_version_device_ms": old_ms,
                "device_by_kernel_ms": split,
                "first_version_by_kernel_ms": old_split,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "shape": list(shape), "frames": frames, "layout": route,
                "err": "max |diff| over the largest reference gradient", **bd}

    log("[phase 3] kernels vs plain versions on the card")
    odd_cases(dev, g)
    # the journal config's four decoder skips (the appearance features of
    # a clip, passed once for its 5 frames): with the bottleneck, the five
    # bf16 launches of a request (60 folded frames) or a step (15)
    skips = [(32, 64, 64), (16, 32, 128), (8, 16, 256), (4, 8, 512)]
    serving_skips = [
        resample_case(wk.RESAMPLE_BF16, torch.bfloat16, (60, *hwc), True,
                      "decoder skip", frames=5) for hwc in skips]
    for hwc in skips:
        resample_case(wk.RESAMPLE_F32, torch.float32, (60, *hwc), True,
                      "decoder skip", frames=5)
    rows["resample_bf16"] = resample_case(
        wk.RESAMPLE_BF16, torch.bfloat16, (60, 16, 32, 256), True,
        "generator bottleneck")
    rows["resample_bf16"]["serving_skips"] = serving_skips
    resample_case(wk.RESAMPLE_F32, torch.float32, (60, 16, 32, 256), True,
                  "generator bottleneck")
    rows["resample_f32"] = resample_case(
        wk.RESAMPLE_F32, torch.float32, (60, 128, 256, 3), False, "previews",
        frames=5)

    # K1 forward at the train step's shapes (batch 3 x 5 frames folded)
    train = {}
    rows["resample_bf16"]["train_skips"] = [
        resample_case(wk.RESAMPLE_BF16, torch.bfloat16, (15, *hwc), True,
                      "train decoder skip", frames=5) for hwc in skips]
    train["resample_bf16"] = resample_case(
        wk.RESAMPLE_BF16, torch.bfloat16, (15, 16, 32, 256), True,
        "train generator bottleneck")
    train["resample_f32"] = resample_case(
        wk.RESAMPLE_F32, torch.float32, (15, 128, 256, 3), False,
        "train warped loss and previews", frames=5)

    # K1 backward at the same shapes; the skips also at frames=1 (the image
    # repeated for its frames, as callers passed it before frames existed)
    rows["resample_bwd_bf16"] = backward_case(
        wk.RESAMPLE_BWD_BF16, torch.bfloat16, (15, 16, 32, 256), True,
        (True, True, True), "generator bottleneck")
    rows["resample_bwd_bf16"]["train_skips"] = [
        backward_case(wk.RESAMPLE_BWD_BF16, torch.bfloat16, (15, *hwc), True,
                      (True, False, False), "decoder skip", frames)
        for frames in (5, 1) for hwc in skips]
    rows["resample_bwd_bf16"]["unmasked"] = backward_case(
        wk.RESAMPLE_BWD_BF16, torch.bfloat16, (15, 16, 32, 256), False,
        (True, True, False), "unmasked")
    rows["resample_bwd_f32"] = backward_case(
        wk.RESAMPLE_BWD_F32, torch.float32, (15, 128, 256, 3), False,
        (False, True, False), "warped loss", frames=5)
    rows["resample_bwd_f32"]["bottleneck"] = backward_case(
        wk.RESAMPLE_BWD_F32, torch.float32, (15, 16, 32, 256), True,
        (True, True, True), "generator bottleneck")
    rows["resample_bwd_f32"]["flow_consistency"] = backward_case(
        wk.RESAMPLE_BWD_F32, torch.float32, (15, 128, 256, 2), False,
        (True, True, False), "flow consistency")

    def k2_and_k3(args, tol, label):
        """K2 and K3 on the same inputs: K3 equal to K2, both within
        ``tol`` of the plain winner; times around one call, and device
        alone in turns (K2, K3, K3, K2); K3's passes apart (torch.profiler,
        device time by kernel); the (tile, node) pairs and tiles K3
        visits."""
        b, h, w = args[0].shape
        n, t = args[3].shape[1:3]
        k2 = lambda: mk.warp_masks_winner(*args)                # noqa: E731
        k3 = lambda: mb.warp_masks_winner_banded(*args)         # noqa: E731
        plain = lambda: mk.warp_masks_winner_plain(*args)       # noqa: E731
        winner = k3()
        frac = (winner != plain()).float().mean().item()
        check(torch.equal(winner, k2()), f"{label}: K3 differs from K2")
        check(frac <= tol, f"{label}: mismatch vs plain {frac} > {tol}")
        windows = mb.source_windows_plain(
            args[3], h, w, boxes=mb.node_boxes_plain(*args[:3]))
        tiles = mb.tile_masks_plain(*args)
        k2_ms, k3_ms = time_ms(k2), time_ms(k3)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        turns = [device_ms(k2), device_ms(k3), device_ms(k3), device_ms(k2)]
        passes = kernel_split(k3, {"memsets": "Memset", "boxes": "node_boxes",
                                   "tiles": "warp_masks_tiles"})
        live = int((~windows["skip"]).sum().item())
        out = {"k2_ms": k2_ms, "k3_ms": k3_ms, "plain_ms": plain_ms,
               "k2_device_ms": (turns[0] + turns[3]) / 2,
               "k3_device_ms": (turns[1] + turns[2]) / 2,
               "k3_passes_ms": passes, "mismatch_vs_plain": frac,
               "pairs_visited": live, "pairs": windows["skip"].numel(),
               "tiles_visited": int(tiles["tiles"].numel()),
               "tiles": int(tiles["masks"].shape[0]),
               "windows_over_budget": int(windows["gather"].sum().item()),
               "shape": [b, n, t, h, w]}
        log(f"  {label} [{b},{n},{t},{h},{w}]: winner mismatch vs plain "
            f"{frac:.3g} (tol {tol:.3g}), K3 vs K2 0; K3 visits {live} of "
            f"{out['pairs']} (tile, node) pairs in {out['tiles_visited']} of "
            f"{out['tiles']} tiles, {out['windows_over_budget']} regions "
            f"over {mb.WIN_MAX} pixels; around a call K2 {k2_ms:.4f} ms  K3 "
            f"{k3_ms:.4f} ms; device alone K2 {out['k2_device_ms']:.4f}  K3 "
            f"{out['k3_device_ms']:.4f} (in turns "
            f"{[round(x, 4) for x in turns]}); K3's passes "
            f"{ {k: round(v, 4) for k, v in passes.items()} }; plain "
            f"{plain_ms:.4f} ms")
        return out

    def winner_bound(args, live, tiles):
        """Per output pixel 6 operations for its base coordinates; per
        (node, tile) ~60 for the window; where the window meets the node's
        box ~30 per pixel of the tile (this run's maps and thetas: a tile
        pays nothing per pixel for a node it cannot touch); one compare per
        (source pixel, node) for the boxes. Bytes: inputs read, winner
        written."""
        b, h, w = args[0].shape
        n, t = args[3].shape[1:3]
        return bound(nbytes(*args) + 4 * b * t * h * w,
                     b * n * h * w + 6 * b * t * h * w + 60 * n * tiles
                     + live * 30 * mb.TILE[0] * mb.TILE[1])

    def maskwarp_case(b, role):
        """K2 at [B, N, H, W] x [B, N, T, 6] = [b, 16, 128, 256] x [b, 16, 5, 6],
        K3 on the same inputs."""
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
        both = k2_and_k3(args, TOL_FLIP, f"warp_masks_winner {role}")
        # per output pixel 6 operations for its base coordinates, and per
        # valid node ~30 (affine, source coordinate, bilinear weights,
        # interpolation)
        n_valid = int(args[2].sum().item()) * t * h * w
        bd = bound(nbytes(*args) + 4 * b * t * h * w,
                   6 * b * t * h * w + 30 * n_valid)
        log(f"  warp_masks_winner {role}: bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})  no single library call")
        return {"max_abs_err": both["mismatch_vs_plain"], "ms": both["k2_ms"],
                "device_ms": both["k2_device_ms"],
                "plain_ms": both["plain_ms"], "library_ms": None,
                "shape": both["shape"], "k3": both,
                "err": "winner mismatch fraction", **bd}

    def splat_case(b, role, h=128, w=256):
        """K4 at [b, h, w, 2] coords: the base grid plus a +-10 px flow of
        independent noise (the row of record), then plus a smooth flow."""
        flow = ((torch.rand(b, h, w, 2, generator=g) - 0.5) * 20).to(dev)
        err, flips, mass, got, run, plain = splat_check(
            sk, splat, grid_coords(flow))
        ms, plain_ms = time_ms(run), time_ms(plain)
        s_err, s_flips, s_mass, _, s_run, _ = splat_check(
            sk, splat, grid_coords(smooth_flow(g, b, h, w, dev)), piled=True)
        smooth = {"max_abs_err": s_err, "flips": s_flips, "max_mass": s_mass,
                  "ms": time_ms(s_run), "device_ms": device_ms(s_run),
                  "tol": f"{TOL_SPLAT} x max(1, mass / 4)"}
        dev_ms = device_ms(run)
        bd = bound(nbytes(flow, got), 14 * got.numel())
        log(f"  corresponding_map {role} [{b},{h},{w},2]: max|diff| {err:.3g} "
            f"(tol {TOL_SPLAT}, masses up to {mass:.3g}), 0.5-threshold flips "
            f"{flips:.3g} (tol "
            f"{TOL_FLIP})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})  no single library "
            f"call  device alone: {dev_ms:.4f};  smooth flow: max|diff| "
            f"{s_err:.3g} at masses up to {s_mass:.3g} (tol {TOL_SPLAT} x "
            f"max(1, mass / 4)), flips {s_flips:.3g}  kernel "
            f"{smooth['ms']:.4f} ms  device alone: {smooth['device_ms']:.4f}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "device_ms": dev_ms,
                "shape": [b, h, w, 2], "flips": flips, "max_mass": mass, **bd,
                "smooth": smooth}

    def banded_case(b, kind, n=24, t=10, h=512, w=1024):
        """K3 at [b, n, h, w] x [b, n, t, 6] (the long-horizon map: 24 nodes,
        10 frames, 512x1024) on :func:`banded_inputs` of ``kind``, against
        the plain winner and against K2 on the same inputs."""
        args = banded_inputs(b, kind, dev, n, t, h, w)
        tol = 0.0 if kind == "gt" else TOL_FLIP
        both = k2_and_k3(args, tol, f"warp_masks_banded {kind}")
        check((both["windows_over_budget"] > 0) == (kind == "zoom"),
              f"K3 {kind} B={b}: {both['windows_over_budget']} windows over "
              f"the budget")
        bd = winner_bound(args, both["pairs_visited"], both["tiles"])
        log(f"  warp_masks_banded {kind}: bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})  no single library call")
        return {"max_abs_err": both["mismatch_vs_plain"], "ms": both["k3_ms"],
                "device_ms": both["k3_device_ms"],
                "plain_ms": both["plain_ms"], "library_ms": None,
                "thetas": kind, **both, "err": "winner mismatch fraction",
                **bd}

    def correlation_case(shape, role):
        """K5 at FlowNetC's grid (max displacement 20, stride 2)."""
        md, stride = 20, 2
        a = torch.randn(shape, generator=g).to(dev)
        b = torch.randn(shape, generator=g).to(dev)
        run = lambda: ck.correlation(a, b, md, stride)          # noqa: E731
        plain = lambda: ck.correlation_plain(a, b, md, stride)  # noqa: E731
        got = run()
        err = (got - plain()).abs().max().item()
        ms, plain_ms = time_ms(run), time_ms(plain, reps=3, warmup=1)
        # 2 C operations per (pixel, displacement) pair that stays inside
        # the image; pairs that leave it are zeros and cost nothing
        bsz, h, w, c = shape
        steps = range(-md, md + 1, stride)
        ny = sum(1 for y in range(h) for d in steps if 0 <= y + d < h)
        nx = sum(1 for x in range(w) for d in steps if 0 <= x + d < w)
        bd = bound(nbytes(a, b, got), 2 * c * bsz * ny * nx)
        log(f"  correlation {role} {list(shape)} -> {list(got.shape)}: "
            f"max|diff| {err:.3g} (tol {TOL_CORR})  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})  no single library call")
        check(err <= TOL_CORR, f"correlation {shape}: max|diff| {err}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "shape": list(shape), **bd}

    rows["warp_masks_winner"] = maskwarp_case(12, "serving")
    train["warp_masks_winner"] = maskwarp_case(3, "train")
    rows["corresponding_map"] = splat_case(60, "serving")
    train["corresponding_map"] = splat_case(15, "train")
    # a forward kernel's row is its serving shape's; its check and times at
    # the train step's shape ride along under "train"
    for name, case in train.items():
        rows[name]["train"] = case

    # K3: its row is the long-horizon request's shape (bucket 4) with
    # GNN-like thetas; the other cases ride along
    rows["warp_masks_banded"] = banded_case(4, "gnn")
    # the other cases; then where the size rule's two kernels meet: image-
    # wide objects at both map sizes, and N near K3's node limit
    rows["warp_masks_banded"]["cases"] = [
        banded_case(4, "gt"), banded_case(4, "zoom"), banded_case(1, "gt"),
        banded_case(1, "gnn"), banded_case(1, "zoom"),
        banded_case(1, "wide"), banded_case(3, "wide", 16, 5, 128, 256),
        banded_case(1, "gnn", mb.NODES_MAX - 8, 5, 128, 256)]
    # K5: the journal train batch's 30 frame pairs, and one 512x1024 pair
    rows["correlation"] = correlation_case((30, 16, 32, 256), "on-the-fly")
    rows["correlation"]["cases"] = [
        correlation_case((2, 64, 128, 256), "512x1024 pairs")]
    # K4 at the on-the-fly call's 30 frame pairs (FlowNet2's confidence)
    rows["corresponding_map"]["onthefly"] = splat_case(30, "onthefly")
    # K1 and K4 at the long-horizon shapes: 10 folded frames per clip in
    # the train step, 40 in a bucket-4 request; the four decoder skips and
    # the bottleneck are the five bf16 launches of a request or a step
    long_skips = [(128, 256, 64), (64, 128, 128), (32, 64, 256),
                  (16, 32, 512)]
    for b, role in ((10, "long_horizon_train"), (40, "long_horizon_serving")):
        rows["resample_bf16"][role + "_skips"] = [
            resample_case(wk.RESAMPLE_BF16, torch.bfloat16, (b, *hwc), True,
                          role + " decoder skip", frames=10)
            for hwc in long_skips]
        rows["resample_bf16"][role] = resample_case(
            wk.RESAMPLE_BF16, torch.bfloat16, (b, 64, 128, 256), True, role)
        rows["resample_f32"][role] = resample_case(
            wk.RESAMPLE_F32, torch.float32, (b, 512, 1024, 3), False, role,
            frames=10)
        rows["corresponding_map"][role] = splat_case(b, role, 512, 1024)
    rows["resample_bwd_bf16"]["long_horizon_train_skips"] = [
        backward_case(wk.RESAMPLE_BWD_BF16, torch.bfloat16, (10, *hwc), True,
                      (True, False, False), "long_horizon_train decoder skip",
                      frames)
        for frames in (10, 1) for hwc in long_skips]
    rows["resample_bwd_bf16"]["long_horizon_train"] = backward_case(
        wk.RESAMPLE_BWD_BF16, torch.bfloat16, (10, 64, 128, 256), True,
        (True, True, True), "long_horizon_train")
    rows["resample_bwd_f32"]["long_horizon_train"] = backward_case(
        wk.RESAMPLE_BWD_F32, torch.float32, (10, 512, 1024, 3), False,
        (False, True, False), "long_horizon_train", frames=10)
    return rows


def banded_inputs(b, kind, dev, n=24, t=10, h=512, w=1024):
    """Instance map, ids, valid and thetas of the mask warp at
    [b, n, h, w] x [b, n, t, 6]: objects of 1/8-1/4 of the map each side.
    kind: 'gt' axis-aligned half-integer pixel translations (no sample near
    the threshold: 0 mismatches), 'gnn' small scale, shear and translation
    noise, 'zoom' as 'gnn' with node 0 covering the middle of the map,
    rotated by 1 rad and zoomed out 6x, so that its regions exceed
    mb.WIN_MAX pixels (a strong zoom-out: taps far apart), 'wide' as 'gnn' on
    image-wide objects (a band of rows and a column across the map per
    node: every tile's window meets every box, so K3 skips nothing)."""
    rng = np.random.RandomState(SEED)
    inst = np.zeros((b, h, w), np.float32)
    for bi in range(b):
        for k in range(n):
            bh, bw = rng.randint(h // 8, h // 4), rng.randint(w // 8, w // 4)
            y0, x0 = rng.randint(0, h - bh), rng.randint(0, w - bw)
            inst[bi, y0:y0 + bh, x0:x0 + bw] = 26001 + k
    ids = np.tile(26001 + np.arange(n, dtype=np.int32), (b, 1))
    if kind == "wide":
        for k in range(n):
            inst[:, (k * h) // n:((k + 1) * h) // n, :] = 26001 + k
        for k in range(n):
            inst[:, :, (k * w) // n] = 26001 + k
    th = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (b, n, t, 1))
    if kind == "gt":
        th[..., 2] = (rng.randint(-40, 41, (b, n, t)) + 0.5) * 2.0 / w
        th[..., 5] = (rng.randint(-20, 21, (b, n, t)) + 0.5) * 2.0 / h
    else:
        th[..., 0] += rng.randn(b, n, t) * 0.05
        th[..., 4] += rng.randn(b, n, t) * 0.05
        th[..., 1] = rng.randn(b, n, t) * 0.03
        th[..., 3] = rng.randn(b, n, t) * 0.03
        th[..., 2] = rng.randn(b, n, t) * 0.1
        th[..., 5] = rng.randn(b, n, t) * 0.1
    if kind == "zoom":
        c, sn = 6 * np.cos(1.0), 6 * np.sin(1.0)
        th[:, 0] = np.array([c, -sn, 0.1, sn, c, -0.05], np.float32)
        inst[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = ids[0, 0]
    return [torch.as_tensor(a, device=dev)
            for a in (inst, ids, np.ones((b, n), bool), th)]


def layouts_in(row) -> list:
    """The kernel layouts (the routes inside one kernel's source, as
    ``resample_route`` names them) that phase 3 ran, from a kernel's row."""
    found = set()

    def walk(x):
        if isinstance(x, dict):
            if isinstance(x.get("layout"), str):
                found.add(x["layout"])
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(row)
    return sorted(found)


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


def requests(cfg, dev, sizes=(BUCKET, 5, BUCKET)):
    """One request per entry of ``sizes``: synthetic scenes with every
    object node real, a latent and one click per clip."""
    from c2m_tpu_torch.data.synthetic import make_batch
    from c2m_tpu_torch.serving import z_dim
    n = cfg.dataset_params.max_objects
    out = []
    for seed, bs in enumerate(sizes, start=1):
        batch = make_batch(cfg, batch_size=bs, seed=seed, num_objects=n,
                           device=dev)
        g = torch.Generator().manual_seed(100 + seed)
        z = torch.randn(bs, z_dim(cfg), generator=g).numpy()
        click = np.zeros((bs, n), np.float32)
        click[np.arange(bs), torch.randint(0, n, (bs,), generator=g).numpy()] = 1
        out.append((batch, z, click))
    return out


def expect_launched(counts, launched, where):
    """Exactly the kernels in ``launched`` ran on this path."""
    for name, c in counts.items():
        check((c > 0) == (name in launched),
              f"kernel {name}: {c} launches on {where}")


# the kernels of each path (K2 serves maps up to 128x256 x 12, K3 above)
FORWARD_128 = {"resample_f32", "resample_bf16", "warp_masks_winner",
               "corresponding_map"}
FORWARD_512 = {"resample_f32", "resample_bf16", "warp_masks_banded",
               "corresponding_map"}
BACKWARD = {"resample_bwd_f32", "resample_bwd_bf16"}


def serve(phase, cfg, dev, buckets, plan, launched, profile):
    """A ServingModel pair (GT thetas / click path) around one seeded model
    answers one request per entry (batch size, GT thetas?) of ``plan``.
    Returns the launch counts."""
    from c2m_tpu_torch.models.c2m import DTYPES
    from c2m_tpu_torch.serving import ServingModel
    kernels = all_kernels()
    model = build_model(cfg).to(dev).use_compute_dtype(
        DTYPES[cfg.train_params.dtype])
    gt = ServingModel(model, buckets, use_gt_eval=True)
    click_path = ServingModel(model, buckets, use_gt_eval=False)
    sizes = [bs for bs, _ in plan]
    reqs = requests(cfg, dev, sizes)
    h, w = cfg.test_params.input_size
    tpred = cfg.test_params.num_predicted_frames
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    warm_ms = {}
    for i, (batch, z, click) in enumerate(reqs):
        bs = z.shape[0]
        server = gt if plan[i][1] else click_path
        name = (f"batch {bs} in bucket {gt.bucket_for(bs)}, "
                + ("GT thetas" if server is gt else "click path (GNN thetas)"))
        times = []
        for _ in range(3):               # cold (cuDNN plans), then warm
            t0 = time.perf_counter()
            out = server(batch, z, click)
            times.append((time.perf_counter() - t0) * 1e3)
        warm_ms[i] = min(times[1:])
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
    log(f"  launches over the {len(reqs)} requests (3 calls each): {counts}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # serving differentiates nothing: the backward kernels stay at 0
    expect_launched(counts, launched, f"the serving path of {phase}")
    if profile:
        profile_window(f"request ({phase})", lambda: gt(*reqs[0]), warm_ms[0])
    # padded request == the same rows served alone in a bucket of their own
    i = next(i for i, bs in enumerate(sizes) if bs not in buckets)
    server = gt if plan[i][1] else click_path
    solo = ServingModel(model, (sizes[i],),
                        use_gt_eval=server.use_gt_eval)(*reqs[i])
    padded = server(*reqs[i])
    pad_err = float(np.abs(solo["generated"] - padded["generated"]).max())
    log(f"  padded vs unpadded batch {sizes[i]}: max|diff| generated "
        f"{pad_err:.3g} (tol {TOL_PAD:.3g})")
    check(pad_err <= TOL_PAD, f"padded rows differ by {pad_err} > {TOL_PAD}")
    return counts


def phase_serving(cfg, dev, profile: bool = False):
    """Phase 4: the journal serving path through ServingModel."""
    log(f"[phase 4] ServingModel, journal config at full width, bucket "
        f"{BUCKET}, compute {cfg.train_params.dtype} (cast at use), float32 "
        f"parameters")
    return serve("the journal config", cfg, dev, (BUCKET,),
                 ((BUCKET, True), (5, True), (BUCKET, False)), FORWARD_128,
                 profile)


def phase_long_serving(cfg, dev, profile: bool = False):
    """Phase 9: the long-horizon serving path."""
    tp = cfg.test_params
    log(f"[phase 9] ServingModel, long-horizon config at full width and "
        f"depth: {tp.input_size}, {tp.num_predicted_frames} predicted frames, "
        f"{cfg.dataset_params.max_objects} nodes, buckets {LONG_BUCKETS}, "
        f"compute {cfg.train_params.dtype}")
    return serve("the long-horizon config", cfg, dev, LONG_BUCKETS,
                 ((4, True), (1, False), (3, False)), FORWARD_512, profile)


def phase_cpu_parity(cfg, dev):
    """Phase 5: float32 slice at batch 2, card (kernels) vs CPU (plain)."""
    from c2m_tpu_torch.data.synthetic import make_batch
    from c2m_tpu_torch.serving import z_dim
    cfg32 = copy.deepcopy(cfg)
    cfg32.train_params.dtype = "float32"
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
    from c2m_tpu_torch.ops.hopper import (correlation_kernel, maskwarp_banded,
                                          maskwarp_kernel, splat_kernel,
                                          warp_kernels)
    return (warp_kernels.KERNELS + maskwarp_kernel.KERNELS
            + maskwarp_banded.KERNELS + splat_kernel.KERNELS
            + correlation_kernel.KERNELS)


def train_batch(cfg, dev, batch_size, seed):
    """A synthetic training batch with all nodes real, as tensors on dev."""
    from c2m_tpu_torch.data.synthetic import make_batch
    batch = make_batch(cfg, batch_size=batch_size, seed=seed,
                       num_objects=cfg.dataset_params.max_objects, device=dev)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def phase_train(cfg, dev, profile: bool, phase: int = 6,
                what: str = "journal config", steps: int = 3,
                launched=frozenset(FORWARD_128 | BACKWARD)):
    """Phases 6 and 11: ``steps`` steps of the train step at ``cfg``."""
    from c2m_tpu_torch.nn.layers import BatchNorm, SpectralNormConv
    from c2m_tpu_torch.train.state import (GROUPS, create_train_state,
                                           param_group)
    from c2m_tpu_torch.serving import z_dim
    from c2m_tpu_torch.train.model import total_generator_loss
    from c2m_tpu_torch.train.step import make_eval_step, make_train_step
    tp = cfg.train_params
    log(f"[phase {phase}] train step, {what} at full width and depth: "
        f"batch {tp.batch_size}, {tp.num_predicted_frames} predicted frames "
        f"at {tp.input_size}, compute {tp.dtype}, float32 parameters")
    state = create_train_state(cfg, seed=SEED, device=dev)
    model = state.model
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "parameters must stay float32")
    n_params = sum(p.numel() for p in model.parameters())
    batches = [train_batch(cfg, dev, tp.batch_size, 11 + i)
               for i in range(steps)]
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
    # the steps saw different batches, so their totals differ anyway: what
    # shows learning is the generator objective of one batch, with the same
    # noise and click, under the weights before and after the steps
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
        f"{objective['before']:.4f} before the {steps} steps, "
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
    check(state.step == steps, "step count")
    log(f"  {n_params / 1e6:.1f}M parameters; step ms cold {times[0]:.1f}, "
        f"warm {', '.join(f'{t:.1f}' for t in times[1:])}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    for i, m in enumerate(history):
        log(f"  step {i + 1}: total_gen {m['total_gen']:.4f}  image D "
            f"{m['total_image_dis']:.4f}  video D {m['total_video_dis']:.4f}  "
            f"perceptual {m['perceptual']:.4f}  warped {m['warped']:.4f}  "
            f"kl {m['kl']:.4f}")
    log(f"  launches over the {steps} steps: {counts}")
    expect_launched(counts, launched, f"the train step of the {what}")
    if profile:
        profile_window(f"train_step ({what})",
                       lambda: step(state, batches[0]), min(times[1:]))
    return counts


def phase_long_train(cfg, dev, profile: bool):
    """Phase 11: two train steps at the long-horizon config, one clip per
    step (the YAML's batch 16 is one clip per chip of a 16-chip mesh)."""
    cfg = copy.deepcopy(cfg)
    cfg.train_params.batch_size = 1
    return phase_train(cfg, dev, profile, phase=11,
                       what="long-horizon config", steps=2,
                       launched=frozenset(FORWARD_512 | BACKWARD))


def smooth_frames(n, h, w, seed):
    """[n, h, w, 3] frames in [0, 1]: sums of low-frequency sinusoids."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((n, h, w, 3), 0.5, np.float32)
    for i in range(n):
        for c in range(3):
            for _ in range(3):
                fy, fx, ph = rng.rand() * 0.2, rng.rand() * 0.2, rng.rand() * 6
                out[i, ..., c] += np.sin(ys * fy + xs * fx + ph) / 6
    return out


def phase_onthefly(cfg, dev):
    """Phase 8: FlowNet2 on-the-fly flow feeding one train step."""
    from c2m_tpu_torch.models.flownet2 import compute_flow_and_conf
    from c2m_tpu_torch.train.flow_onthefly import OnTheFlyFlow
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.train.step import make_train_step
    cfg = copy.deepcopy(cfg)
    cfg.train_params.use_pre_processed_of = False
    tp = cfg.train_params
    pairs = tp.batch_size * (2 * tp.num_predicted_frames
                             + tp.num_input_frames - 1)
    t0 = time.perf_counter()
    otf = OnTheFlyFlow(tp.num_input_frames, tp.num_predicted_frames,
                       device=dev)
    n_params = sum(p.numel() for p in otf.model.parameters())
    log(f"[phase 8] on-the-fly flow: FlowNet2, {n_params / 1e6:.1f}M seeded "
        f"parameters (built in {time.perf_counter() - t0:.1f} s), float32, "
        f"{pairs} frame pairs of {tp.input_size} per call, feeding one train "
        f"step with use_pre_processed_of: false")
    batch = train_batch(cfg, dev, tp.batch_size, 31)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    times = []
    for _ in range(4):                   # cold (cuDNN plans), then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows = otf(batch["video"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_call = {k.name: k.launches // 4 for k in kernels}
    check(per_call["correlation"] == 1 and per_call["corresponding_map"] == 1,
          f"on-the-fly call launched {per_call}")
    for key, val in flows.items():
        # the journal batch carries the backward entries only (use_fw_of is
        # false there); a forward entry has its backward twin's shape
        want = batch[key.replace("_fw_", "_bw_")].shape
        check(val.shape == want, f"{key}: {tuple(val.shape)} is not the "
              f"batch's precomputed entry's shape {tuple(want)}")
        check(bool(torch.isfinite(val).all()), f"{key}: not finite")
        if key.endswith("occ"):
            check(float(val.min()) >= 0 and float(val.max()) <= 1,
                  f"{key} outside [0, 1]")
    check({"target_bw_of", "target_bw_occ", "target_fw_of", "target_fw_occ"}
          == set(flows), f"on-the-fly keys {sorted(flows)}")
    log(f"  call ms cold {times[0]:.1f}, warm "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}; |flow| up to "
        f"{float(flows['target_bw_of'].abs().max()):.3f} px; launches per "
        f"call: correlation {per_call['correlation']}, corresponding_map "
        f"{per_call['corresponding_map']}")

    # the trainer's order: batch.update(flows), then the step
    batch.update(flows)
    state = create_train_state(cfg, seed=SEED, device=dev)
    metrics = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    bad = [k for k, v in metrics.items() if not np.isfinite(float(v))]
    check(not bad, f"train step on on-the-fly flows: non-finite {bad}")
    counts = {k.name: k.launches for k in kernels}
    log(f"  one train step on these flows: total_gen "
        f"{float(metrics['total_gen']):.4f}, flow_reconstruction "
        f"{float(metrics['flow_reconstruction']):.4f}; launches over the 4 "
        f"calls and the step: {counts}")
    expect_launched(counts, FORWARD_128 | BACKWARD | {"correlation"},
                    "the on-the-fly path")

    # FlowNet2 alone, card (K5, K4) vs CPU (plain versions), float32
    frames = torch.from_numpy(smooth_frames(2, 64, 128, SEED)) * 2 - 1
    with tf32_off(), torch.no_grad():
        got = compute_flow_and_conf(otf.model, frames[:1].to(dev),
                                    frames[1:].to(dev))
        cpu_model = copy.deepcopy(otf.model).cpu()
        want = compute_flow_and_conf(cpu_model, frames[:1], frames[1:])
    err_flow = (got[0].cpu() - want[0]).abs().max().item()
    err_conf = (got[1].cpu() - want[1]).abs().max().item()
    log(f"  FlowNet2 at one 64x128 pair, card vs CPU, TF32 off: max|diff| flow "
        f"{err_flow:.3g} of up to {want[0].abs().max().item():.3g} px, "
        f"confidence {err_conf:.3g} (tol {TOL_FLOWNET} both)")
    check(err_flow <= TOL_FLOWNET and err_conf <= TOL_FLOWNET,
          f"FlowNet2 card vs CPU: flow {err_flow}, confidence {err_conf}")
    return counts


def phase_long_raster_parity(cfg, dev):
    """Phase 10: the rasterizer at one long-horizon clip, card vs CPU."""
    from c2m_tpu_torch.ops.raster import banded, generate_sparse_motion
    tp = cfg.train_params
    h, w = tp.input_size
    n, t = cfg.dataset_params.max_objects, tp.num_predicted_frames
    check(banded(1, n, t, h, w), "one long-horizon clip must route to K3")
    log(f"[phase 10] rasterizer alone at [1,{n},{t},{h},{w}]: card (K3, K4) "
        f"vs CPU (plain versions)")
    rng = np.random.RandomState(SEED)
    inst = np.zeros((1, h, w, 1), np.float32)
    for k in range(n):
        bh, bw = rng.randint(h // 8, h // 4), rng.randint(w // 8, w // 4)
        y0, x0 = rng.randint(0, h - bh), rng.randint(0, w - bw)
        inst[0, y0:y0 + bh, x0:x0 + bw, 0] = 26001 + k
    ids = 26001 + np.arange(n, dtype=np.int32)[None]
    th = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (1, n, t, 1))
    th += (rng.randn(1, n, t, 6) * np.array([.05, .03, .1, .03, .05, .1])
           ).astype(np.float32)
    args = (inst, ids, np.ones((1, n), bool), th)
    outs = []
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        out = generate_sparse_motion(*(torch.as_tensor(a, device=d)
                                       for a in args))
        outs.append({k: v.cpu() for k, v in out.items()})
        log(f"  on {torch.device(d).type}: {time.perf_counter() - t0:.1f} s")
    cpu, gpu = outs
    same = cpu["winner_bw"] == gpu["winner_bw"]
    wmis = 1.0 - same.float().mean().item()
    flow = ((cpu["sparse_motion_bw"] - gpu["sparse_motion_bw"]).abs()
            .amax(dim=-1)[same].max().item())
    occ = max((cpu[k] != gpu[k]).float().mean().item()
              for k in ("sparse_occ_bw", "sparse_occ_fw"))
    log(f"  winner_bw mismatch {wmis:.3g} (tol {TOL_FLIP}), sparse flow "
        f"max|diff| {flow:.3g} px where the winner agrees (tol 1e-3), "
        f"occlusion mismatch {occ:.3g} (tol {TOL_OCC})")
    check(wmis <= TOL_FLIP and flow <= 1e-3 and occ <= TOL_OCC,
          "rasterizer card vs CPU over tolerance at 512x1024")


def phase_train_cpu_parity(cfg, dev):
    """Phase 7: float32 train model at batch 1, card (kernels) vs CPU."""
    from c2m_tpu_torch.train.model import C2MTrainModel
    from c2m_tpu_torch.train.state import GROUPS, param_group
    from c2m_tpu_torch.train.step import combined_loss
    from c2m_tpu_torch.serving import z_dim
    cfg32 = copy.deepcopy(cfg)
    cfg32.train_params.dtype = "float32"
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

    def release():
        """Hand a finished phase's cached blocks back, so that the next
        phase's peak memory is its own."""
        gc.collect()
        torch.cuda.empty_cache()

    rows = phase_kernels(dev)
    release()
    cfg = load_config()                     # configs/c2m_journal_cityscapes.yaml
    counts = {"serving": phase_serving(cfg, dev, profile)}
    with tf32_off():
        phase_cpu_parity(cfg, dev)
    release()
    counts["train"] = phase_train(cfg, dev, profile)
    with tf32_off():
        phase_train_cpu_parity(cfg, dev)
    release()
    counts["onthefly"] = phase_onthefly(cfg, dev)
    release()
    long_cfg = load_config(LONG_YAML)
    counts["long_serving"] = phase_long_serving(long_cfg, dev, profile)
    release()
    phase_long_raster_parity(long_cfg, dev)
    counts["long_train"] = phase_long_train(long_cfg, dev, profile)
    loaded = {m.split(".")[0] for m in sys.modules}
    check(not loaded & {"jax", "jaxlib", "flax", "optax"}, "JAX was imported")
    check("c2m_tpu" not in loaded, "the JAX package c2m_tpu was imported")

    # launches: the sum over the five paths, each counted from 0 just
    # before the path was driven; the comparisons of phase 3 are not in it
    kernels = []
    for k in all_kernels():
        by_path = {f"launches_{path}": c[k.name] for path, c in counts.items()}
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": sum(by_path.values()), **by_path,
                        **rows[k.name], "layouts": layouts_in(rows[k.name])})
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
