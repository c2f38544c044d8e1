#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check
what they compute: serving and the train step at the journal config
(128x256) and at the long-horizon config (512x1024), FlowNet2 on-the-fly
flow feeding a train step, the program around the step (trainer,
checkpoint and resume, evaluator, serving artifact) at the journal config,
the KITTI and SPADE generator variants, the trainer over a NCCL process
group, the evaluation's metric nets (InceptionV3, I3D, YOLOv3) with the
evaluator and entry points that run them, the preprocessing chain, the
tools (reference-checkpoint conversion, artifact export and the synthetic
dataset on disk), and the patch route of the float32 convolutions.

    python3 chip_smoke.py

It checks values, never times: the port's performance is measured by
``perfbench/run.py``. Each kernel against its plain version is
``tests/test_torch_kernels_cuda.py`` (cuda-marked); phase 3 runs that
file's cases at the paths' shapes. Wall-clock lines only say how long a
call or a phase took.

Phases (any failure raises and the script exits non-zero):
  1. torch / CUDA versions and the card's name and power limit;
  2. build the hand-written kernels from c2m_tpu_torch/csrc (nvcc, ctypes);
  3. each kernel against its plain version at every shape the paths give
     it: the ``PATH_*`` cases of tests/test_torch_kernels_cuda.py (K1
     forward and backward, K2, K3, K4, K5), TF32 off;
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
     click path. K3 launched and K2 not; peak memory;
 10. the rasterizer alone at one 512x1024 clip, card (K3, K4) vs CPU;
 11. two train steps at the long-horizon config, batch 1 (the YAML's 16 is
     one clip per chip of a 16-chip mesh), with the checks of phase 6; K1
     forward and backward, K3 and K4 launched; peak memory;
 12. train -> checkpoint -> resume -> eval -> export at the journal config's
     full width, in a temporary directory, on synthetic clips made by the
     port's SyntheticDataset on the card and held in host memory: a
     Trainer takes 4 steps of an epoch of 8 with print, display, sampled
     eval and save firing (K1 forward and backward, K2, K4 launched; one
     sampled eval alone launches K1, K2, K4); a second run takes 2 steps
     and saves, and a fresh Trainer with continue_train resumes: the
     checkpoint round trip bit for bit, the resumed steps on the unbroken
     run's batches, lrs and generator state, their metrics within a
     multiple of the card's own spread (steps 3 and 4 taken three times
     from the saved state); the rest of the epoch and a second one with the
     cadences off; the Evaluator over 2 val batches of 12 (files written,
     FID / FVD NaN without embedders) and a second pass that loads the
     saved clicks; export_artifact -> ServingModel.from_artifact against
     the trained model's inference; one trainer step with on-the-fly
     FlowNet2 flow (K5 launched);
 13. the generator variants at full width: configs/c2m_kitti.yaml as
     shipped (the warped-image encoder branch) and the journal config with
     use_spade set in code (FlowEmbedder + SPADE decoder). First the
     image warp through K1's frames=5 against the repeated image, bit for
     bit (output and flow gradient). For each: a ServingModel at bucket 12
     on the three requests of phase 4 (padded rows in float32 within
     TOL_PAD_F32, a row-mixing control beyond it), three
     train steps at batch 3 with the checks of phase 6 (K1, K2, K4 and K1's
     backward launched on each path), the variant's own branch holding
     non-zero gradients, export_artifact -> ServingModel.from_artifact equal
     to the trained model's inference bit for bit, and float32 inference at
     batch 1 card vs CPU under the structural gate (TOL_VARIANT_*);
 14. two Trainer steps at the journal config inside a NCCL process group of
     one rank (the gradient all-reduce, the norms' global sums and the
     metrics' mean run, counted) against the same steps with no group:
     step 1's metrics bit for bit, step 2's within a multiple of the
     spread of three runs with no group (step 2 carries step 1's backward,
     which the card does not repeat bit for bit); a failed NCCL init fails
     the run;
 15. the metric nets at full input size, seeded weights whose BatchNorm
     statistics come from one batch of val frames, written by the bridge
     into npz files of the JAX converters' format and read back bit for
     bit: InceptionV3 [2,299,299,3], I3D [2,5,224,224,3] (both endpoints)
     and YOLOv3 [1,416,416,3] card vs CPU in float32 (TF32 off) within
     TOL_NET; the Evaluator with the three nets from INCEPTION_WEIGHTS /
     I3D_WEIGHTS / YOLO_WEIGHTS over 2 val batches of 12 (K1, K2, K4
     launched; the detector on 2 x 2 x 12 last frames; finite FID and
     FVD), and peak memory; eval_torch.py as a subprocess on a saved
     checkpoint and the synthetic val set, and yolo_detect_torch.py on
     two frames (a .txt and a .png each);
 16. the preprocessing chain, seeded weights (BatchNorm statistics from one
     forward of the inputs each net then sees, residual branches damped:
     damp_residuals_) through the bridge into npz files of the JAX
     converters' format, read back bit for bit: Panoptic-DeepLab card vs
     CPU in float32 (TF32 off) at [1,512,1024,3] on all three heads within
     TOL_PRE_NET, postprocess card vs CPU equal map for map, then at
     Cityscapes' full frame [1,1024,2048,3] on the card: semantic ids,
     centers, peak memory, the share of semantic pixels TF32 changes;
     SiamRPN++ features and heads card vs CPU, one tracker card vs CPU
     over 9 frames of 1024x2048 (the same anchors, boxes within TOL_BOX
     px) and evaluate_tracker (OPE) with it; then the CLIs as subprocesses
     on a synthetic city of 30 raw 1024x2048 frames with a moving car:
     generate_segmentation (2 frames), generate_trajectories (9 rows with
     the crafted motion), tools/preprocess_images.py and generate_lists.py
     to the journal 128x256, precompute_flow at the journal config (K5 and
     K4, 2(T-1) launches each, counted in its process: the kernels line's
     launches_preprocess), the port's get_training_set and one Trainer step
     on the clip, evaluate_cityscapes on the crafted maps (IoU 1.0).
     Both nets also run undamped (ROADMAP C4): card vs CPU within
     TOL_F64_MULTIPLE x the larger of the two sides' float32 errors, each
     against a float64 copy of the net on its own side (Panoptic-DeepLab at
     [1,512,1024,3], SiamRPN++'s heads and four trackers over the 9
     frames), the multiple printed;
 17. the tools at the journal config's full width: a seeded train model
     written as a reference checkpoint (``latest_c2m_model.pth.tar``
     layout, tests/torch_reference_layout.py), ``convert_c2m`` and
     ``export_serving --batch-sizes 12`` as subprocesses, the job dir
     equal to the seeded model tensor for tensor, one request served from
     the artifact on the card (K1, K2, K4 counted) equal bit for bit to the
     seeded model served directly; ``make_synthetic_dataset`` on the card
     (one K2 and two K4 launches a clip, counted in its process), its tree
     held to the same tool's run on the CPU (other files byte for byte,
     flows and occlusions within phase 10's gates), then eval_torch.py on
     the converted job dir and train_torch.py for 2 steps, both reading
     that tree from disk; upfirdn2d and bias_act card vs CPU;
 18. the patch route of the float32 convolutions (nn/layers.conv_route) at
     the journal config in float32, TF32 off: a ServingModel with buckets
     1 and 12 answers a request of each size with every Conv / Conv3d call
     recorded: every call takes the patch route, and a 12-clip request
     launches the gather; at each conv shape of those requests the gather
     kernel against its plain version (bit for bit, first and last chunk)
     and the patch conv against the cuDNN conv within TOL_PATCH_CONV, both
     against float64 (printed);
 19. the patch route's backward (nn/layers.PatchConv) in the float32 train
     step at the journal config, TF32 off: one step with every Conv /
     Conv3d call recorded: a trained conv's call must take cuDNN, every
     other call (VGG19) the patch route, and each of those whose input
     needs a gradient and whose output reaches a loss one
     ``patch_backward``, with the adjoint kernel launched; at each conv
     shape of that step the forward, input gradient and weight gradient
     (where the step needs them) on cuDNN and on the patch route, each
     side within TOL_PATCH_CONV of float64.

The line before the last is a JSON object with each kernel's name, source
and launches by path; the last line is {"ok": true, "device": {...}}.
Exits non-zero at once when no CUDA device is visible. Imports nothing of
JAX and nothing of c2m_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from c2m_tpu_torch.device import full_float32
from c2m_tpu_torch.ops.hopper import all_kernels

BUCKET = 12
SEED = 0
LONG_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "c2m_long_horizon.yaml")
LONG_BUCKETS = (1, 4)
KITTI_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "c2m_kitti.yaml")

# tolerances of the card against the CPU, and why
TOL_FLOWNET = 1e-3      # FlowNet2 card vs CPU, float32, TF32 off: ~100 conv
                        # layers summed in other orders; flows of order 1 px
TOL_OCC = 1e-3          # share of occlusion pixels that may differ card vs
                        # CPU: splat atomics at the 0.5 threshold, and the
                        # neighbours of a flipped winner pixel
TOL_FLIP = 1e-4         # share of {0,1} pixels allowed to flip at a threshold
TOL_SLICE = 5e-4        # generated frames, card vs CPU (float32 conv sums)
TOL_PAD = 2.0 ** -9     # padded vs unpadded rows: cuDNN may pick other bf16
                        # conv algorithms per batch size; one bf16 ulp at 0.5
# train model, card vs CPU in float32 (TF32 off): loss terms relative (plus
# 1e-5 abs); gradients per optimizer group by the noise class of train-mode
# BatchNorm backward under float32 reassociation (cos, norm ratio)
TOL_LOSS_REL = 1e-3
TOL_GRAD_COS = 0.9995
TOL_GRAD_NORM = 0.02
# a resumed run's steps 3 and 4 against the unbroken run's, relative per
# metric: both start from the state saved at step 2, and step 4's metrics
# carry step 3's backward, which the card does not repeat bit for bit (K1
# backward's float atomics, cuDNN's weight gradients). The gate is a
# multiple of the spread measured in the same call (steps 3 and 4 taken
# three times from the saved state, worst pair) plus a floor. The spread of
# one step grows 3-4x a step after it (NVIDIA H100 80GB HBM3, 700 W), so a
# comparison with a run that forked earlier would need another gate. Phase
# 14 gates its step 2 (after step 1's backward) the same way, by the spread
# of its own runs at that step: phase 12's spread at step 4, on other clips
# and weights, read 0.0038-0.0054 in three calls; in a fourth the gate it
# set was below the 0.0111 by which phase 14's step 2 differed.
TOL_RESUME_FACTOR = 5.0
TOL_RESUME_FLOOR = 1e-5
# the KITTI and SPADE models, card vs CPU in float32: the structural gate of
# tests/test_c2m_converter.py (the full-resolution image warp flips bilinear
# floor() where the flows differ in the last bits; InstanceNorm spreads a
# flipped pixel over its map): max |d| and the share of pixels off by more
# than TOL_VARIANT_PIXEL
TOL_VARIANT_MAX = 1e-2
TOL_VARIANT_PIXEL = 1e-3
TOL_VARIANT_SHARE = 0.05
# the variants' padded vs unpadded rows in float32, TF32 off, on one card:
# rows are independent, so only the conv algorithms cuDNN picks per batch
# size differ (SPADE 1.37e-6, KITTI 1.19e-7 on an NVIDIA H100 80GB HBM3 at
# 700 W); a control that mixes the rows through batch statistics must
# exceed the gate
TOL_PAD_F32 = 1e-4
# the metric nets (phase 15), card vs CPU in float32 with TF32 off, max |d|
# relative to the largest CPU output: ~95 (InceptionV3), ~115 (I3D) and 75
# (YOLOv3) conv + BatchNorm layers, the same float32 sums in other orders
# (cuDNN against the CPU's kernels), BatchNorm statistics set so the
# activations stay of order 1; YOLOv3's box sizes (exp of a logit) as logs.
# Read 2.38e-5 / 1.08e-5 (embedding), 4.27e-6 (logits) / 1.64e-5 on an
# NVIDIA H100 80GB HBM3 at 700 W: the gate is 4x the largest
TOL_NET = 1e-4
# the preprocessing nets (phase 16), card vs CPU in float32 with TF32 off,
# max |d| relative to the largest CPU output: Panoptic-DeepLab (~300 conv +
# BatchNorm layers, HRNet's fusions summing up to four branches) on all
# three heads, SiamRPN++'s features and heads (residual branches damped,
# damp_residuals_); the same float32 sums in other orders
TOL_PRE_NET = 1e-4
# the tracker's boxes card vs CPU, px: the heads' float32 differences
# (~1e-5 of outputs of order 5) scaled by the anchors (64-184 px) over
# scale_z, carried from frame to frame
TOL_BOX = 1e-3
# the undamped preprocessing nets and tracker (phase 16, ROADMAP C4), card vs
# CPU, each side in float32 against its own float64 forward: if the card
# computes the CPU's function, the triangle inequality bounds card - CPU by
# the two sides' float32 errors together, so by 2x the larger; a card that
# computed another function would part from the CPU in float64 as well and
# exceed it. 3x leaves room for the two float64 results' own rounding and
# for each error being taken relative to its own side's outputs
TOL_F64_MULTIPLE = 3.0


def log(msg: str) -> None:
    print(msg, flush=True)


def release_memory() -> None:
    """Hand a finished phase's cached blocks back, so that the next phase's
    peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def load_test_module(name: str):
    """``tests/<name>.py`` loaded by its path: a ``tests`` package installed
    on the machine would shadow the repository's tests directory, which has
    no __init__.py."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the seeding helpers the CPU parity tests share (torch only)
_SEEDED = load_test_module("torch_seeded_nets")
calibrate_bn_, damp_residuals_, Pair = (_SEEDED.calibrate_bn_,
                                        _SEEDED.damp_residuals_, _SEEDED.Pair)


# the kernel cases at the paths' shapes (phase 3) and the smooth flow they
# and phase 13 share
_KERNEL_CASES = load_test_module("test_torch_kernels_cuda")
smooth_flow = _KERNEL_CASES.smooth_flow


def phase_kernels(dev) -> None:
    """Phase 3: each hand-written kernel against its plain version at every
    shape the paths give it, the ``PATH_*`` cases of
    tests/test_torch_kernels_cuda.py run with their own assertions: K1
    forward on noise and smooth flows and K1 backward, K4 on both flows,
    K2 and K3 under every kind of thetas, K5 in float32 and bfloat16."""
    log("[phase 3] the kernels against their plain versions at the paths' "
        "shapes")
    k = _KERNEL_CASES
    cases = (
        [(k.test_resample_kernel_at_the_paths_shapes,
          {"case": c, "flow_kind": f})
         for c in k.PATH_RESAMPLE for f in k.FLOW_KINDS]
        + [(k.test_resample_backward_at_the_paths_shapes, {"case": c})
           for c in k.PATH_RESAMPLE_BWD]
        + [(k.test_splat_kernel_matches_plain,
            {"shape": s, "px": 10.0, "flow_kind": f})
           for s in k.PATH_SPLAT for f in k.FLOW_KINDS]
        + [(k.test_banded_winner_kernel_matches_plain_and_k2,
            {"shape": s, "kind": kind})
           for s in k.PATH_WINNER for kind in k.WINNER_KINDS]
        + [(k.test_correlation_kernel_matches_plain,
            {"shape": s, "md": md, "stride": st, "dtype": dt})
           for s, md, st in k.PATH_CORRELATION
           for dt in (torch.float32, torch.bfloat16)])
    t0 = time.perf_counter()
    with full_float32():
        for test, args in cases:
            try:
                test(dev, **args)
            except AssertionError as e:
                check(False, f"{test.__name__} {args}: {e}")
    log(f"  {len(cases)} cases passed in {time.perf_counter() - t0:.1f} s")
    release_memory()


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


def serve(phase, cfg, dev, buckets, plan, launched, structural=False):
    """A ServingModel pair (GT thetas / click path) around one seeded model
    answers one request per entry (batch size, GT thetas?) of ``plan``.
    Returns the launch counts. Padded rows are held to their unpadded
    serving within TOL_PAD; with ``structural`` (the generator variants)
    they are held in float32, TF32 off, within TOL_PAD_F32, a control whose
    norms mix the rows (batch statistics) must exceed TOL_PAD_F32, and the
    bfloat16 difference is printed: the variants' outputs spread over
    [0.2, 0.9] and their bfloat16 stacks carry the conv algorithm cuDNN
    picks per batch size into differences of one or two bfloat16 spacings
    over many pixels (SPADE on an NVIDIA H100 80GB HBM3: 0.0045 max, 8.8%
    of pixels above 1e-3)."""
    from c2m_tpu_torch.models.c2m import DTYPES
    from c2m_tpu_torch.serving import ServingModel
    model = build_model(cfg).to(dev).use_compute_dtype(
        DTYPES[cfg.train_params.dtype])
    gt = ServingModel(model, buckets, use_gt_eval=True)
    click_path = ServingModel(model, buckets, use_gt_eval=False)
    sizes = [bs for bs, _ in plan]
    reqs = requests(cfg, dev, sizes)
    h, w = cfg.test_params.input_size
    tpred = cfg.test_params.num_predicted_frames
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
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
    counts = read_launches()
    log(f"  launches over the {len(reqs)} requests (3 calls each): {counts}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # serving differentiates nothing: the backward kernels stay at 0
    expect_launched(counts, launched, f"the serving path of {phase}")
    # padded request == the same rows served alone in a bucket of their own
    i = next(i for i, bs in enumerate(sizes) if bs not in buckets)
    server = gt if plan[i][1] else click_path
    solo = ServingModel(model, (sizes[i],),
                        use_gt_eval=server.use_gt_eval)(*reqs[i])
    padded = server(*reqs[i])
    d = np.abs(solo["generated"] - padded["generated"])
    pad_err = float(d.max())
    if structural:
        log(f"  padded vs unpadded batch {sizes[i]} in {cfg.train_params.dtype}"
            f": max|diff| generated {pad_err:.3g}, share of pixels off by "
            f"more than {TOL_VARIANT_PIXEL}: "
            f"{float((d > TOL_VARIANT_PIXEL).mean()):.3g} (not gated)")
        model32 = build_model(cfg).to(dev)
        servers = [ServingModel(model32, sizes_,
                                use_gt_eval=server.use_gt_eval)
                   for sizes_ in ((sizes[i],), buckets)]
        errs = {}
        for mixed in (False, True):
            model32.train(mixed)        # train mode: batch statistics
            with full_float32():
                solo, padded = (srv(*reqs[i])["generated"] for srv in servers)
            errs[mixed] = float(np.abs(solo - padded).max())
        log(f"  the same in float32, TF32 off: max|diff| generated "
            f"{errs[False]:.3g} (tol {TOL_PAD_F32}); control with the rows "
            f"mixed by batch statistics {errs[True]:.3g} (must exceed it)")
        check(errs[False] <= TOL_PAD_F32,
              f"padded rows differ by {errs[False]} > {TOL_PAD_F32}")
        check(errs[True] > TOL_PAD_F32,
              f"the row-mixing control stays under the gate: {errs[True]}")
        return counts
    log(f"  padded vs unpadded batch {sizes[i]}: max|diff| generated "
        f"{pad_err:.3g} (tol {TOL_PAD:.3g})")
    check(pad_err <= TOL_PAD, f"padded rows differ by {pad_err} > {TOL_PAD}")
    return counts


def phase_serving(cfg, dev):
    """Phase 4: the journal serving path through ServingModel."""
    log(f"[phase 4] ServingModel, journal config at full width, bucket "
        f"{BUCKET}, compute {cfg.train_params.dtype} (cast at use), float32 "
        f"parameters")
    return serve("the journal config", cfg, dev, (BUCKET,),
                 ((BUCKET, True), (5, True), (BUCKET, False)), FORWARD_128)


def phase_long_serving(cfg, dev):
    """Phase 9: the long-horizon serving path."""
    tp = cfg.test_params
    log(f"[phase 9] ServingModel, long-horizon config at full width and "
        f"depth: {tp.input_size}, {tp.num_predicted_frames} predicted frames, "
        f"{cfg.dataset_params.max_objects} nodes, buckets {LONG_BUCKETS}, "
        f"compute {cfg.train_params.dtype}")
    return serve("the long-horizon config", cfg, dev, LONG_BUCKETS,
                 ((4, True), (1, False), (3, False)), FORWARD_512)


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


def reset_launches():
    """Every kernel's launch count to 0, just before a path is driven."""
    for k in all_kernels():
        k.launches = 0


def read_launches():
    """Every kernel's launch count, just after a path was driven."""
    return {k.name: k.launches for k in all_kernels()}


def train_batch(cfg, dev, batch_size, seed):
    """A synthetic training batch with all nodes real, as tensors on dev."""
    from c2m_tpu_torch.data.synthetic import make_batch
    batch = make_batch(cfg, batch_size=batch_size, seed=seed,
                       num_objects=cfg.dataset_params.max_objects, device=dev)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def phase_train(cfg, dev, phase: int = 6,
                what: str = "journal config", steps: int = 3,
                launched=frozenset(FORWARD_128 | BACKWARD), then=None):
    """Phases 6, 11 and 13: ``steps`` steps of the train step at ``cfg``;
    ``then(state)`` runs once the checks have passed."""
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
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    history, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    counts = read_launches()
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
    if then is not None:
        then(state)
    return counts


def phase_long_train(cfg, dev):
    """Phase 11: two train steps at the long-horizon config, one clip per
    step (the YAML's batch 16 is one clip per chip of a 16-chip mesh)."""
    cfg = copy.deepcopy(cfg)
    cfg.train_params.batch_size = 1
    return phase_train(cfg, dev, phase=11,
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
    reset_launches()
    times = []
    for _ in range(4):                   # cold (cuDNN plans), then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows = otf(batch["video"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_call = {name: c // 4 for name, c in read_launches().items()}
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
    counts = read_launches()
    log(f"  one train step on these flows: total_gen "
        f"{float(metrics['total_gen']):.4f}, flow_reconstruction "
        f"{float(metrics['flow_reconstruction']):.4f}; launches over the 4 "
        f"calls and the step: {counts}")
    expect_launched(counts, FORWARD_128 | BACKWARD | {"correlation"},
                    "the on-the-fly path")

    # FlowNet2 alone, card (K5, K4) vs CPU (plain versions), float32
    frames = torch.from_numpy(smooth_frames(2, 64, 128, SEED)) * 2 - 1
    with full_float32(), torch.no_grad():
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


class Held:
    """A dataset's clips made once and held in host memory, as a dataset
    read from disk hands them out: the loader's threads only collate and
    pin them."""

    def __init__(self, dataset):
        self.items = [dataset[i] for i in range(len(dataset))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]



def tensors_of(obj, prefix=""):
    """Every tensor inside a state_dict-like tree, by its path."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from tensors_of(v, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from tensors_of(v, f"{prefix}/{i}")


def same_tree(a, b, what):
    """Bit for bit: every tensor (on any device) and every other leaf."""
    ta, tb = dict(tensors_of(a)), dict(tensors_of(b))
    check(ta.keys() == tb.keys(), f"{what}: tensor paths differ")
    for path, x in ta.items():
        y = tb[path]
        check(x.dtype == y.dtype and x.shape == y.shape
              and torch.equal(x.cpu(), y.cpu()), f"{what}{path} differs")
    if isinstance(a, dict):
        for k in a:
            if not isinstance(a[k], (torch.Tensor, dict, list, tuple)):
                check(a[k] == b[k], f"{what}/{k}: {a[k]} vs {b[k]}")
    return len(ta)


def state_tree(state):
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "generator": state.generator.get_state(), "step": state.step}


def rel_diff(x: float, y: float) -> float:
    return abs(x - y) / max(abs(y), 1e-6)


def spread_of(samples) -> dict:
    """Per metric, the largest relative difference between two of
    ``samples`` (dicts metric -> value of the same step, taken again)."""
    return {k: max(rel_diff(a[k], b[k]) for i, a in enumerate(samples)
                   for b in samples[:i])
            for k in samples[0]}


def metrics_of(history, steps):
    return {h["step"]: {k: float(v) for k, v in h["metrics"].items()}
            for h in history if h["step"] in steps}


def phase_program(cfg, dev):
    """Phase 12: train -> checkpoint -> resume -> eval -> export, through
    the port's Trainer, checkpoints, Evaluator and serving artifact, in a
    temporary directory."""
    import shutil
    import tempfile
    from c2m_tpu_torch.data.dataset import SyntheticDataset
    t_phase = time.perf_counter()
    cfg = copy.deepcopy(cfg)
    cfg.dataset_params.dataset = "synthetic"
    tp, vz = cfg.train_params, cfg.visualizer_params
    # every cadence fires within the first four steps of an epoch of eight
    vz.print_freq, vz.display_freq, vz.save_latest_freq = 1, 2, 2
    tp.eval_freq = 3
    vz.tf_log = False
    cfg.checkpoint_params.save_epoch_freq = 1000
    tbs = cfg.test_params.batch_size
    log(f"[phase 12] train -> checkpoint -> resume -> eval -> export at the "
        f"journal config's full width: Trainer at batch {tp.batch_size}, "
        f"{tp.dtype} compute, SyntheticDataset clips (1-4 objects of "
        f"{cfg.dataset_params.max_objects} nodes); Evaluator at batch {tbs}")
    t0 = time.perf_counter()
    train_set = Held(SyntheticDataset(cfg, n=8 * tp.batch_size, device=dev))
    val_set = Held(SyntheticDataset(cfg, n=2 * tbs, seed_offset=10_000,
                                    device=dev))
    log(f"  {len(train_set)} training and {len(val_set)} val clips made on "
        f"the card in {time.perf_counter() - t0:.1f} s, held in host memory")
    root = tempfile.mkdtemp(prefix="c2m_program_")
    try:
        counts = program_steps(cfg, dev, root, train_set, val_set)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def program_steps(cfg, dev, root, train_set, val_set):
    """Phase 12's runs in ``root``; returns the launch counts by run."""
    import shutil
    from c2m_tpu_torch.data.loader import DataLoader, collate
    from c2m_tpu_torch.eval.evaluator import Evaluator
    from c2m_tpu_torch.serving import ServingModel, export_artifact, z_dim
    from c2m_tpu_torch.train.trainer import Trainer, device_batch
    from c2m_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_payload, restore_state,
                                                save_checkpoint, saved_steps)
    tp, vz = cfg.train_params, cfg.visualizer_params
    n_max = cfg.dataset_params.max_objects
    counts = {}

    # 1. the unbroken run: four steps of an epoch of eight, in two calls of
    # fit; the save at step 2 is the one a resumed run starts from
    job_a = os.path.join(root, "unbroken")
    t0 = time.perf_counter()
    a = Trainer(cfg, train_set, val_set, job_dir=job_a, device=dev)
    log(f"  Trainer built in {time.perf_counter() - t0:.1f} s "
        f"({a.steps_per_epoch} steps per epoch)")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.fit(num_epochs=1, max_steps=2)
    torch.cuda.synchronize()
    ms_a = (time.perf_counter() - t0) * 1e3
    check(saved_steps(job_a) == [2], f"saves {saved_steps(job_a)}")
    with open(os.path.join(job_a, "iter.txt")) as f:
        check(f.read() == "1,2", "iter.txt after two steps of epoch 1")

    # 2. the broken run's job dir: the unbroken run's after the save at step
    # 2, as a run stopped there leaves it; a fresh Trainer resumes from it
    job_b = os.path.join(root, "resumed")
    shutil.copytree(job_a, job_b)
    path = checkpoint_path(job_b, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(job_b, a.state, 1, 2)             # the same step again
    save_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    payload = load_payload(job_b)
    load_ms = (time.perf_counter() - t0) * 1e3
    saved = {k: payload[k] for k in ("model", "optimizer", "scheduler",
                                     "generator", "step")}
    n_saved = same_tree(state_tree(a.state), saved, "saved vs trained state")
    resumed_cfg = copy.deepcopy(cfg)
    resumed_cfg.train_params.continue_train = True
    t0 = time.perf_counter()
    c = Trainer(resumed_cfg, train_set, val_set, job_dir=job_b, device=dev)
    resume_ms = (time.perf_counter() - t0) * 1e3
    check((c.start_epoch, c.epoch_iter, c.total_iter) == (1, 2, 2),
          f"resumed at epoch {c.start_epoch}, batch {c.epoch_iter}, step "
          f"{c.total_iter}")
    n_loaded = same_tree(state_tree(c.state), saved, "loaded vs saved state")
    log(f"  checkpoint round trip bit for bit: {n_saved} tensors saved equal "
        f"the trained state, {n_loaded} loaded equal the saved (model, Adam "
        f"with {len(c.state.optimizer.param_groups)} groups, LambdaLR, "
        f"generator); save {save_ms:.1f} ms, load {load_ms:.1f} ms, "
        f"{size / 2 ** 30:.3f} GiB on disk; Trainer(continue_train) built "
        f"and restored in {resume_ms:.1f} ms")

    # the unbroken run goes on: steps 3 and 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.fit(num_epochs=1, max_steps=4)
    torch.cuda.synchronize()
    ms_a += (time.perf_counter() - t0) * 1e3
    counts["program"] = read_launches()
    check(a.total_iter == 4 and a.state.step == 4, "the unbroken run's steps")
    m_a = metrics_of(a.history, {3, 4})
    idx_a = {h["step"]: h["indices"] for h in a.history}
    lr_a = {h["step"]: h["lr"] for h in a.history}
    gen_a = a.state.generator.get_state().clone()
    for step, m in m_a.items():
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"unbroken step {step}: non-finite {bad}")
    with open(os.path.join(job_a, "loss_log.txt")) as f:
        printed = len(f.read().splitlines())
    images = os.listdir(os.path.join(job_a, "web", "images"))
    shown = sum(name.startswith("train_") for name in images)
    sampled = sum(name.startswith("eval_") for name in images)
    check(printed == 4 and shown > 0 and sampled > 0
          and saved_steps(job_a) == [2, 4],
          f"cadences: {printed} printed, {shown} display images, {sampled} "
          f"eval images, saves at {saved_steps(job_a)}")
    log(f"  unbroken run: 4 steps in {ms_a:.1f} ms with every cadence firing "
        f"({printed} loss lines, display and sampled-eval galleries, saves "
        f"at steps {saved_steps(job_a)}); launches {counts['program']}")
    expect_launched(counts["program"], FORWARD_128 | BACKWARD,
                    "the trainer's steps and cadences")
    reset_launches()
    check(a._generate_eval(1) is not None, "no sampled eval")
    torch.cuda.synchronize()
    counts["program_eval"] = read_launches()
    expect_launched(counts["program_eval"], FORWARD_128,
                    "one mid-train sampled eval")
    log(f"  one mid-train sampled eval (val batch of {cfg.test_params.batch_size}"
        f"): launches {counts['program_eval']}")

    # the card's own spread: steps 3 and 4 taken three times from the saved
    # state; step 4's metrics carry step 3's backward. The resumed run and
    # the unbroken run's steps 3-4 start from that same state, so they may
    # differ by as much, and no more.
    c.loader.set_epoch(1, 2)
    order = c.loader.batch_indices()[:2]
    check([o.tolist() for o in order] == [idx_a[3], idx_a[4]],
          f"the resumed epoch's batches {order} are not the unbroken run's "
          f"{idx_a[3]}, {idx_a[4]}")
    batches = [device_batch(collate([train_set[int(i)] for i in o]), dev)
               for o in order]
    repeats = []
    for _ in range(3):
        restore_state(c.state, payload)
        ms = [c.train_step(c.state, bt) for bt in batches]
        repeats.append({3 + i: {k: float(v) for k, v in m.items()}
                        for i, m in enumerate(ms)})
    restore_state(c.state, payload)
    c.fit(num_epochs=1, max_steps=4)
    check(c.total_iter == 4 and c.state.step == 4, "the resumed run's steps")
    check(torch.equal(c.state.generator.get_state(), gen_a),
          "the generator after the resumed steps differs from the unbroken "
          "run's")
    m_c = metrics_of(c.history, {3, 4})
    check({h["step"]: h["indices"] for h in c.history} ==
          {s: idx_a[s] for s in (3, 4)}, "the resumed steps took other batches")
    check({h["step"]: h["lr"] for h in c.history} ==
          {s: lr_a[s] for s in (3, 4)}, "the resumed steps took other lrs")

    same3 = all(r[3] == repeats[0][3] for r in repeats)
    spread = spread_of([r[4] for r in repeats])
    worst_spread = max(spread.values())
    tol = TOL_RESUME_FACTOR * worst_spread + TOL_RESUME_FLOOR
    rel = {(step, k): rel_diff(m_c[step][k], v)
           for step in (3, 4) for k, v in m_a[step].items()}

    def worst_of(step):
        key = max((k for s_, k in rel if s_ == step),
                  key=lambda k: rel[(step, k)])
        return f"{rel[(step, key)]:.3g} ({key})"
    log(f"  the card's spread, steps 3 and 4 taken {len(repeats)} times from "
        f"the saved state: step 3's metrics "
        f"{'equal' if same3 else 'differ'}; step 4's worst relative "
        f"difference {worst_spread:.3g} ({max(spread, key=spread.get)}) over "
        f"{len(spread)} metrics")
    log(f"  resumed vs unbroken: batches {idx_a[3]}, {idx_a[4]} and lrs "
        f"equal, generator state equal; worst relative metric difference "
        f"step 3 {worst_of(3)}, step 4 {worst_of(4)} (tol "
        f"{TOL_RESUME_FACTOR} x spread + {TOL_RESUME_FLOOR} = {tol:.3g})")
    bad = {key: v for key, v in rel.items() if v > tol}
    check(not bad, f"resumed steps differ from the unbroken run's beyond "
          f"{tol:.3g}: {bad}")
    del c, batches, payload, saved
    release_memory()

    # 3. the rest of epoch 1 and epoch 2 of the unbroken run, the cadences
    # off
    vz.print_freq = vz.display_freq = vz.save_latest_freq = 10 ** 9
    tp.eval_freq = 10 ** 9
    a.fit(num_epochs=2)
    torch.cuda.synchronize()
    rest = [h for h in a.history if h["step"] > 4]
    check(a.total_iter == 4 + len(rest) == 2 * a.steps_per_epoch
          and all(np.isfinite(float(v)) for h in rest
                  for v in h["metrics"].values()),
          f"the rest of epoch 1 and epoch 2: {a.total_iter} steps")
    log(f"  the rest of epoch 1 and epoch 2, cadences off: {len(rest)} more "
        f"steps, every metric finite")
    release_memory()

    # 4. the evaluator: two val batches of test_params.batch_size, clicks
    # saved, then a second pass that loads them
    ecfg = copy.deepcopy(cfg)
    ecfg.test_params.save_index_user_guidance = True
    ecfg.test_params.load_index_user_guidance = False
    job_e = os.path.join(root, "eval")
    loader = DataLoader(val_set, batch_size=ecfg.test_params.batch_size,
                        shuffle=False, num_workers=2, drop_last=False)
    passes = []
    for load in (False, True):
        ecfg.test_params.load_index_user_guidance = load
        ev = Evaluator(ecfg, a.state.model, job_e)
        g = torch.Generator().manual_seed(ecfg.test_params.seed + int(load))
        clicks = []
        for bi, batch in enumerate(loader):
            out = ev.evaluate_batch(batch, bi, g)
            ev.save_samples(batch, out, bi)
            ev.fetch_metrics_data(batch, out)
            clicks.append(out["click_mask"])
            check(out["generated"].shape[0] == len(batch["video"])
                  and np.isfinite(out["generated"]).all(),
                  f"eval batch {bi}: generated {out['generated'].shape}")
        results = ev.generate_metrics()
        ev.write_metrics(results)
        passes.append((clicks, results))
    files = set(os.listdir(ev.out_dir))
    want = {f"b{bi:05d}_s{s}_{kind}" for bi in range(2) for s in range(2)
            for kind in ("gen.gif", "real.gif", "gen.png", "flow.png",
                         "occ.png")}
    want |= {"results.txt", "index_user_guidance_00000.npy",
             "index_user_guidance_00001.npy"}
    check(want <= files, f"evaluator files missing: {sorted(want - files)}")
    check(os.path.exists(os.path.join(ev.out_dir, "web", "index.html")),
          "no evaluator HTML")
    results = passes[0][1]
    check(np.isfinite(results["trajectory_mse_theta"])
          and np.isnan(results["fid"]) and np.isnan(results["fvd"]),
          f"evaluator results {results}")
    check(all(np.array_equal(x, y) for x, y in zip(passes[0][0],
                                                    passes[1][0])),
          "the second pass did not reproduce the saved clicks")
    log(f"  evaluator over 2 val batches of {ecfg.test_params.batch_size}: "
        f"results {results}; the second pass reproduced the saved clicks")

    # 5. export the trained generator, serve it, hold it to the model
    art = os.path.join(root, "artifact")
    t0 = time.perf_counter()
    export_artifact(art, cfg, a.state.model, batch_sizes=(cfg.test_params.batch_size,))
    export_ms = (time.perf_counter() - t0) * 1e3
    server = ServingModel.from_artifact(art, device=dev, use_gt_eval=True)
    batch = next(iter(loader))
    g = torch.Generator().manual_seed(SEED)
    z = torch.randn(len(batch["video"]), z_dim(cfg), generator=g)
    click = torch.zeros(len(batch["video"]), n_max)
    click[:, 2] = 1
    got = server(batch, z.numpy(), click.numpy())
    model = a.state.model.eval()
    want = model.inference(device_batch(batch, dev), z.to(dev),
                           click.to(dev), use_gt_eval=True)
    err = float((torch.from_numpy(got["generated"])
                 - want["generated"].float().cpu()).abs().max())
    log(f"  exported in {export_ms:.1f} ms "
        f"({os.path.getsize(os.path.join(art, 'variables.npz')) / 2 ** 20:.1f}"
        f" MiB of variables); ServingModel.from_artifact on the card vs the "
        f"trained model's inference on the same z and clicks: max|diff| "
        f"generated {err:.3g} (tol {TOL_PAD:.3g})")
    check(err <= TOL_PAD, f"served artifact differs by {err}")
    del a, server, model, want
    release_memory()

    # 6. one trainer step with on-the-fly FlowNet2 flow
    fcfg = copy.deepcopy(cfg)
    fcfg.train_params.use_pre_processed_of = False
    t0 = time.perf_counter()
    d = Trainer(fcfg, train_set, None, job_dir=os.path.join(root, "otf"),
                device=dev)
    built = time.perf_counter() - t0
    reset_launches()
    d.fit(num_epochs=1, max_steps=1)
    torch.cuda.synchronize()
    counts["program_onthefly"] = read_launches()
    m = {k: float(v) for k, v in d.history[-1]["metrics"].items()}
    check(all(np.isfinite(v) for v in m.values()), f"on-the-fly step {m}")
    expect_launched(counts["program_onthefly"],
                    FORWARD_128 | BACKWARD | {"correlation"},
                    "a trainer step with on-the-fly flow")
    log(f"  Trainer with use_pre_processed_of: false (FlowNet2 built in "
        f"{built:.1f} s): one step, total_gen {m['total_gen']:.4f}; "
        f"launches {counts['program_onthefly']}")
    del d
    release_memory()
    return counts


# the generator variants (phase 13): the KITTI YAML as shipped, and the
# journal config with the SPADE generator (no YAML of the repo sets it);
# the parameters of each variant's own branch, which must get gradients;
# the embedder's finest map (its up_0) conditions no SPADE block, so no
# gradient reaches up_0 (none in the JAX package either)
VARIANT_BRANCHES = {"kitti": ("first_warped", "down_warped_", "pre_decode"),
                    "spade": ("flowembedder",)}
NO_GRADIENT = "c2m.generator.flowembedder.up_0."


def variant_configs(cfg):
    from c2m_tpu_torch.config import load_config
    spade = copy.deepcopy(cfg)
    spade.model_params.generator.use_spade = True
    return {"kitti": load_config(KITTI_YAML), "spade": spade}


def check_branch_gradients(state, name):
    """After a step, every module of the variant's branch holds finite,
    non-zero gradients (they stay until the next step clears them)."""
    for branch in VARIANT_BRANCHES[name]:
        grads = [p.grad for n, p in state.model.named_parameters()
                 if n.startswith(f"c2m.generator.{branch}")
                 and not n.startswith(NO_GRADIENT)]
        check(grads and all(g is not None for g in grads),
              f"{name}: {branch} got no gradient")
        peak = max(float(g.abs().max()) for g in grads)
        check(np.isfinite(peak) and peak > 0,
              f"{name}: {branch} gradient max|g| {peak}")
        log(f"  {name}: {len(grads)} tensors of {branch}* hold gradients, "
            f"max|g| {peak:.3g}")


def export_and_serve(state, vcfg, dev, name):
    """The trained variant exported and served from its artifact: equal to
    the trained model's own inference, bit for bit."""
    import shutil
    import tempfile
    from c2m_tpu_torch.serving import ServingModel, export_artifact
    from c2m_tpu_torch.train.trainer import device_batch
    art = tempfile.mkdtemp(prefix=f"c2m_{name}_artifact_")
    try:
        t0 = time.perf_counter()
        export_artifact(art, vcfg, state.model, batch_sizes=(BUCKET,))
        export_ms = (time.perf_counter() - t0) * 1e3
        server = ServingModel.from_artifact(art, device=dev, use_gt_eval=True)
        check(server.model.generator.p.use_spade
              == vcfg.model_params.generator.use_spade
              and server.model.generator.kitti == (name == "kitti"),
              f"{name}: the artifact rebuilt another variant")
        batch, z, click = requests(vcfg, dev, (BUCKET,))[0]
        got = server(batch, z, click)["generated"]
        model = state.model.eval()
        with torch.inference_mode():
            want = model.inference(device_batch(batch, dev),
                                   torch.as_tensor(z, device=dev),
                                   torch.as_tensor(click, device=dev),
                                   use_gt_eval=True)["generated"]
        err = float(np.abs(got - want.float().cpu().numpy()).max())
        log(f"  {name}: exported in {export_ms:.1f} ms; the artifact served "
            f"at bucket {BUCKET} vs the trained model's inference: max|diff| "
            f"generated {err:.3g} (must be 0)")
        check(err == 0.0, f"{name}: served artifact differs by {err}")
    finally:
        shutil.rmtree(art, ignore_errors=True)


def variant_cpu_parity(vcfg, dev, name):
    """Float32 inference at batch 1, card (kernels) vs CPU (plain versions),
    under the structural gate of the variants: the full-resolution image
    warp flips bilinear floor() where the dense flows differ in the last
    bits, and InstanceNorm spreads a flip over its map."""
    from c2m_tpu_torch.data.synthetic import make_batch
    from c2m_tpu_torch.serving import z_dim
    cfg32 = copy.deepcopy(vcfg)
    cfg32.train_params.dtype = "float32"
    cpu_model = build_model(cfg32)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    n = cfg32.dataset_params.max_objects
    batch = make_batch(cfg32, batch_size=1, seed=17, num_objects=n,
                       device=dev)
    g = torch.Generator().manual_seed(17)
    z = torch.randn(1, z_dim(cfg32), generator=g)
    click = torch.zeros(1, n)
    click[0, 2] = 1
    outs = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        bt = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
        with torch.inference_mode():
            o = model.inference(bt, z.to(d), click.to(d), True)
        outs.append({k: v.float().cpu() for k, v in o.items()})
    cpu, gpu = outs
    d = (cpu["generated"] - gpu["generated"]).abs()
    worst, share = float(d.max()), float((d > TOL_VARIANT_PIXEL).float().mean())
    flow = float((cpu["dense_motion_bw"] - gpu["dense_motion_bw"]).abs().max())
    log(f"  {name}: float32 at batch 1, card vs CPU: max|diff| generated "
        f"{worst:.3g} (tol {TOL_VARIANT_MAX}), share of pixels off by more "
        f"than {TOL_VARIANT_PIXEL}: {share:.3g} (tol {TOL_VARIANT_SHARE}); "
        f"dense flow {flow:.3g}")
    check(worst < TOL_VARIANT_MAX and share < TOL_VARIANT_SHARE,
          f"{name}: card vs CPU beyond the structural gate")


def image_warp_reads_once(dev):
    """The variants' image warp passes each source image once for its T
    frames (K1's ``frames``): output and flow gradient equal, bit for bit,
    to the warp of the T-fold repeated image, at the request's and the
    step's shapes (phase 3 holds both against the plain version: the
    resample cases of tests/test_torch_kernels_cuda.py)."""
    from c2m_tpu_torch.ops.hopper.warp_kernels import resample
    g = torch.Generator().manual_seed(23)
    t, h, w = 5, 128, 256
    for b in (BUCKET * t, 3 * t):
        src = torch.rand(b // t, h, w, 3, generator=g).to(dev)
        flow = smooth_flow(g, b, h, w, dev)
        grad = torch.rand(b, h, w, 3, generator=g).to(dev)
        outs = []
        for image, frames in ((src.repeat_interleave(t, dim=0), 1), (src, t)):
            f = flow.clone().requires_grad_()
            out = resample(image, f, frames)
            out.backward(grad)
            outs.append((out.detach(), f.grad))
        (out1, g1), (out_t, g_t) = outs
        err = max(float((out1 - out_t).abs().max()),
                  float((g1 - g_t).abs().max()))
        log(f"  image warp [{b},{h},{w},3] with frames={t} against the "
            f"repeated image: max|diff| output and flow gradient {err:.3g} "
            f"(must be 0)")
        check(err == 0.0, f"frames={t} image warp differs by {err}")


def phase_variants(cfg, dev):
    """Phase 13: the KITTI and the SPADE model at full width: serving,
    three train steps, export -> serve, card vs CPU."""
    log("[phase 13] the generator variants")
    image_warp_reads_once(dev)
    counts = {}
    for name, vcfg in variant_configs(cfg).items():
        t_phase = time.perf_counter()
        gp = vcfg.model_params.generator
        log(f"[phase 13] the {name} model at full width: dataset "
            f"{vcfg.dataset_params.dataset!r}, use_spade {gp.use_spade}, "
            f"{vcfg.train_params.input_size}, compute "
            f"{vcfg.train_params.dtype}")
        counts[f"{name}_serving"] = serve(
            f"the {name} model", vcfg, dev, (BUCKET,),
            ((BUCKET, True), (5, True), (BUCKET, False)), FORWARD_128,
            structural=True)
        release_memory()

        def then(state, vcfg=vcfg, name=name):
            check_branch_gradients(state, name)
            export_and_serve(state, vcfg, dev, name)
        counts[f"{name}_train"] = phase_train(
            vcfg, dev, phase=13, what=f"{name} model", steps=3,
            then=then)
        release_memory()
        with full_float32():
            variant_cpu_parity(vcfg, dev, name)
        release_memory()
        log(f"  the {name} model took {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_nccl(cfg, dev):
    """Phase 14: two Trainer steps at the journal config with a NCCL process
    group of one rank (the gradient all-reduce, the norms' global sums and
    the metrics' mean all run) against the same two steps with no group,
    taken three times: step 1 bit for bit, step 2 within a multiple of the
    three runs' own spread at step 2 (it carries step 1's backward, which
    the card does not repeat bit for bit)."""
    import shutil
    import socket
    import tempfile
    import torch.distributed as dist
    from c2m_tpu_torch.data.dataset import SyntheticDataset
    from c2m_tpu_torch.parallel import mesh
    from c2m_tpu_torch.train.trainer import Trainer
    cfg = copy.deepcopy(cfg)
    cfg.dataset_params.dataset = "synthetic"
    tp, vz = cfg.train_params, cfg.visualizer_params
    vz.print_freq = vz.display_freq = vz.save_latest_freq = 10 ** 9
    tp.eval_freq = 10 ** 9
    vz.tf_log = False
    cfg.checkpoint_params.save_epoch_freq = 1000
    log(f"[phase 14] Trainer over NCCL at world size 1 against no process "
        f"group: two steps at the journal config, batch {tp.batch_size}")
    train_set = Held(SyntheticDataset(cfg, n=2 * tp.batch_size,
                                      seed_offset=20_000, device=dev))
    calls = {"global_sums": 0, "all_reduce_gradients": 0, "mean_metrics": 0}
    originals = {k: getattr(mesh, k) for k in calls}

    def counted(name):
        def f(*args, **kwargs):
            calls[name] += mesh.is_live()
            return originals[name](*args, **kwargs)
        return f
    root = tempfile.mkdtemp(prefix="c2m_nccl_")
    runs = []
    try:
        for k in calls:
            setattr(mesh, k, counted(k))
        for i, live in enumerate((False, False, False, True)):
            if live:
                with socket.socket() as sock:
                    sock.bind(("localhost", 0))
                    port = sock.getsockname()[1]
                t0 = time.perf_counter()
                mesh.init(0, 1, dev, init_method=f"tcp://localhost:{port}")
                check(mesh.is_live() and dist.get_backend() == "nccl"
                      and mesh.world_size() == 1, "no NCCL group of one rank")
                log(f"  init_process_group('nccl', tcp://localhost:{port}, "
                    f"world size 1) in {time.perf_counter() - t0:.2f} s")
            try:
                trainer = Trainer(cfg, train_set, None,
                                  job_dir=os.path.join(root, str(i)),
                                  device=dev)
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.fit(num_epochs=1, max_steps=2)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                runs.append((metrics_of(trainer.history, {1, 2}),
                             read_launches(), ms))
                del trainer
            finally:
                if live:
                    mesh.shutdown()
        check(not mesh.is_live(), "the process group outlived phase 14")
    finally:
        for k, f in originals.items():
            setattr(mesh, k, f)
        shutil.rmtree(root, ignore_errors=True)
    *alones, (grouped, counts, ms_grouped) = runs
    alone = alones[0][0]
    log(f"  collectives in the grouped run: {calls}; 2 steps in "
        f"{ms_grouped:.1f} ms against "
        f"{', '.join(f'{r[2]:.1f}' for r in alones)} ms alone")
    check(calls["all_reduce_gradients"] == 2 and calls["mean_metrics"] == 2
          and calls["global_sums"] > 0, f"collectives not run: {calls}")
    check(all(r[0][1] == alone[1] for r in alones),
          "step 1 with no group differs from run to run")
    same1 = grouped[1] == alone[1]
    spread = spread_of([r[0][2] for r in alones])
    worst_spread = max(spread.values())
    tol = TOL_RESUME_FACTOR * worst_spread + TOL_RESUME_FLOOR
    rel2 = {k: rel_diff(grouped[2][k], v) for k, v in alone[2].items()}
    worst = max(rel2, key=rel2.get)
    log(f"  step 1 metrics {'bit-equal' if same1 else 'DIFFER'}; step 2: the "
        f"{len(alones)} runs with no group spread by {worst_spread:.3g} "
        f"({max(spread, key=spread.get)}), the grouped run's worst relative "
        f"difference {rel2[worst]:.3g} ({worst}; tol {TOL_RESUME_FACTOR} x "
        f"spread + {TOL_RESUME_FLOOR} = {tol:.3g})")
    check(same1, f"step 1 under NCCL differs: {grouped[1]} vs {alone[1]}")
    check(rel2[worst] <= tol, f"step 2 under NCCL differs beyond the "
          f"spread of the runs with no group ({tol:.3g}): {rel2}")
    expect_launched(counts, FORWARD_128 | BACKWARD,
                    "the trainer's steps under NCCL")
    release_memory()
    return counts


def seeded_net_(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights from a torch.Generator: kernels U(+-1/sqrt(fan_in)),
    BatchNorm scales 1 +- 0.1, biases +- 0.1."""
    g = torch.Generator().manual_seed(seed)

    def u(shape, bound):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() > 1:
                p.copy_(u(p.shape, p[0].numel() ** -0.5))
            elif name.endswith("bn.weight"):
                p.copy_(1 + u(p.shape, 0.1))
            else:
                p.copy_(u(p.shape, 0.1))
    return net


def net_error(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |d| relative to the largest reference output; YOLOv3's box
    sizes (exp of a logit times an anchor) compared as logs."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    if name != "yolov3":
        return rel(got, want)
    return max(rel(got[..., :2], want[..., :2]), rel(got[..., 4:], want[..., 4:]),
               rel(got[..., 2:4].log(), want[..., 2:4].log()))


def round_trip(net, to_jax, from_jax, path: str, name: str) -> dict:
    """The net's state through the bridge into an npz of the JAX
    converters' format and back, bit for bit; returns the state read back."""
    from c2m_tpu_torch.utils import convert
    state = {k: v.cpu() for k, v in net.state_dict().items()}
    convert.write_variables_npz(path, to_jax(state))
    back = from_jax(convert.read_variables_npz(path))
    same = all(torch.equal(back[k], v) for k, v in state.items()
               if not k.endswith("num_batches_tracked"))
    check(same, f"{name}: the npz round trip is not bit for bit")
    return back


def phase_metric_nets(cfg, dev, smi: str) -> dict:
    """Phase 15: InceptionV3, I3D and YOLOv3 at full input size: seeded
    weights through the bridge's npz (bit for bit), card vs CPU, the
    Evaluator with the nets, eval_torch.py and yolo_detect_torch.py as
    subprocesses."""
    import shutil
    import tempfile
    from c2m_tpu_torch.data.dataset import SyntheticDataset
    from c2m_tpu_torch.eval import i3d, inception, yolov3
    from c2m_tpu_torch.eval.detection_metric import pad_416
    from c2m_tpu_torch.ops.warp import resize_bilinear
    from c2m_tpu_torch.utils import convert
    t_phase = time.perf_counter()
    cfg = copy.deepcopy(cfg)
    cfg.dataset_params.dataset = "synthetic"
    tbs = cfg.test_params.batch_size
    log(f"[phase 15] the metric nets at full input size: InceptionV3 (FID), "
        f"I3D (FVD), YOLOv3 (detection metric); the Evaluator and "
        f"eval_torch.py with them at the journal config, val batch {tbs}")
    torch.cuda.reset_peak_memory_stats()
    val_set = Held(SyntheticDataset(cfg, n=2 * tbs, seed_offset=10_000,
                                    device=dev))
    videos = np.stack([c["video"] for c in val_set.items])  # [24,6,128,256,3]
    nif = cfg.train_params.num_input_frames
    pred = videos[:, nif:]

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    with torch.no_grad(), full_float32():
        frames = on_card(pred[:8].reshape(-1, *pred.shape[2:]))
        clips = on_card(pred[:8])
        inputs = {  # calibration batches, then the card-vs-CPU inputs
            "inception": (resize_bilinear(frames[:16] * 2 - 1, (299, 299)),
                          resize_bilinear(frames[-2:] * 2 - 1, (299, 299))),
            "i3d": (resize_bilinear(clips[:4] * 2 - 1, (224, 224)),
                    resize_bilinear(clips[-2:] * 2 - 1, (224, 224))),
            "yolov3": (on_card(pad_416(np.concatenate(
                [videos[:4, -1], pred[:4, -1]]))),
                       on_card(pad_416(videos[-1:, -1]))),
        }
    nets = {"inception": (inception.InceptionV3Pool3, inception.load_inception,
                          "INCEPTION_WEIGHTS"),
            "i3d": (i3d.InceptionI3d, i3d.load_i3d, "I3D_WEIGHTS"),
            "yolov3": (yolov3.YoloV3, yolov3.load_yolov3, "YOLO_WEIGHTS")}
    root = tempfile.mkdtemp(prefix="c2m_nets_")
    env = {}
    try:
        for seed, (name, (cls, load, var)) in enumerate(nets.items()):
            calib, x = inputs[name]
            net = seeded_net_(cls(), SEED + seed).to(dev).eval()
            with full_float32():
                calibrate_bn_(net, calib)
            path = os.path.join(root, f"{name}.npz")
            round_trip(net, getattr(convert, f"{name}_to_jax"),
                       getattr(convert, f"{name}_from_jax"), path, name)
            env[var] = path
            card, cpu = load(path, dev), load(path, "cpu")
            endpoints = ("embedding", "logits") if name == "i3d" else (None,)
            for ep in endpoints:
                kw = {} if ep is None else {"endpoint": ep}
                with torch.no_grad(), full_float32():
                    got = card(x, **kw).cpu()
                    want = cpu(x.cpu(), **kw)
                err = net_error(name, got, want)
                log(f"  {name}{'' if ep is None else ' ' + ep}: "
                    f"{sum(p.numel() for p in card.parameters()) / 1e6:.1f}M "
                    f"parameters, npz round trip bit for bit; card vs CPU "
                    f"{tuple(x.shape)} -> {tuple(want.shape)}: max|d| / "
                    f"max|CPU| {err:.3g} (tol {TOL_NET}); |CPU| max "
                    f"{float(want.abs().max()):.4g}")
                check(bool(torch.isfinite(want).all()) and err <= TOL_NET,
                      f"{name} card vs CPU: {err}")
            del net, card, cpu
            release_memory()
        counts = metric_net_evaluator(cfg, dev, root, val_set, env)
        log(f"  peak memory of phase 15 in this process "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        metric_net_entry_points(cfg, root, val_set, env, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(smi)
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    release_memory()
    return counts


def metric_net_evaluator(cfg, dev, root, val_set, env):
    """The Evaluator with the three nets built from the variables, over 2
    val batches; returns the launch counts of its inference."""
    from c2m_tpu_torch.data.loader import DataLoader
    from c2m_tpu_torch.eval.evaluator import Evaluator
    from c2m_tpu_torch.train.state import create_train_state
    tbs = cfg.test_params.batch_size
    state = create_train_state(cfg, seed=SEED, device=dev)
    loader = DataLoader(val_set, batch_size=tbs, shuffle=False, num_workers=2,
                        drop_last=False)
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        ev = Evaluator(cfg, state.model, os.path.join(root, "eval"))
        built = time.perf_counter() - t0
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(set(ev.metric_nets) == {"fid", "fvd", "detector"},
          f"the Evaluator built {ev.metric_nets}")
    g = torch.Generator().manual_seed(cfg.test_params.seed)
    reset_launches()
    for bi, batch in enumerate(loader):
        out = ev.evaluate_batch(batch, bi, g)
        ev.save_samples(batch, out, bi)
        ev.fetch_metrics_data(batch, out)
    torch.cuda.synchronize()
    counts = read_launches()
    expect_launched(counts, FORWARD_128, "the Evaluator with the metric nets")
    results = ev.generate_metrics()
    gt = len(ev._det["gt_detected"])
    log(f"  Evaluator with the nets (built in {built:.1f} s) over 2 val "
        f"batches of {tbs}: the detector ran on {ev.detector_frames} last "
        f"frames, {gt} ground-truth detections matched; FID and FVD over "
        f"{2 * tbs * 5} frames / {4 * tbs} videos; results {results}; "
        f"launches {counts}")
    check(ev.detector_frames == 2 * 2 * tbs,
          f"the detector ran on {ev.detector_frames} frames")
    check(np.isfinite(results["fid"]) and np.isfinite(results["fvd"]),
          f"FID / FVD not finite: {results}")
    check(("detection_f1" in results) == (gt > 0),
          f"detection keys against {gt} matches: {results}")
    del ev, state
    release_memory()
    return counts


def metric_net_entry_points(cfg, root, val_set, env, dev) -> None:
    """eval_torch.py on a job dir with a saved checkpoint and the three
    variables set, then yolo_detect_torch.py on two synthetic frames; both
    as the subprocesses a user starts."""
    import yaml
    from PIL import Image
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.utils.checkpoint import save_checkpoint
    here = os.path.dirname(os.path.abspath(__file__))
    job = os.path.join(root, "job")
    save_checkpoint(job, create_train_state(cfg, seed=SEED, device=dev), 0, 0)
    release_memory()
    yml = os.path.join(root, "synthetic.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "eval_torch.py"), "--config", yml,
         "--job-dir", job, "--max-batches", "2"], cwd=here,
        env=dict(os.environ, **env), capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"eval_torch.py failed: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    nets = next((ln for ln in lines if ln.startswith("metric nets:")), "")
    ran = next((ln for ln in lines if ln.startswith("detector ran on")), "")
    with open(os.path.join(job, "eval", "results.txt")) as f:
        results = {k: float(v) for k, v in
                   (ln.split(": ") for ln in f.read().splitlines())}
    # the synthetic val set holds 8 clips (as the JAX package's): at test
    # batch 12 one batch of 8
    clips = min(8, 2 * cfg.test_params.batch_size)
    log(f"  eval_torch.py --max-batches 2 as a subprocess in {wall:.1f} s: "
        f"{nets!r}; {ran!r}; results.txt {results}")
    check(all(k in nets for k in ("fid: InceptionV3", "fvd: I3D",
                                  "detector: YOLOv3")), f"nets: {nets}")
    check(ran.startswith(f"detector ran on {2 * clips} last frames"),
          f"detector: {ran}")
    check(np.isfinite(results["fid"]) and np.isfinite(results["fvd"]),
          f"eval_torch.py results {results}")
    matched = int(ran.split("; ")[1].split()[0])
    check(("detection_f1" in results) == (matched > 0),
          f"detection keys against {matched} matches: {results}")

    src, out = os.path.join(root, "frames"), os.path.join(root, "detect")
    os.makedirs(src)
    for i in range(2):
        Image.fromarray((val_set.items[i]["video"][-1] * 255).astype(
            np.uint8)).save(os.path.join(src, f"frame{i}.png"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "yolo_detect_torch.py"),
         "--image-folder", src, "--weights", env["YOLO_WEIGHTS"], "--out",
         out], cwd=here, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"yolo_detect_torch.py failed: {proc.stderr[-3000:]}")
    files = sorted(os.listdir(out))
    log(f"  yolo_detect_torch.py on 2 frames of 128x256 in "
        f"{time.perf_counter() - t0:.1f} s: {files}; "
        f"{' / '.join(proc.stdout.split(chr(10))[:2])}")
    check(files == ["frame0.png", "frame0.txt", "frame1.png", "frame1.txt"],
          f"yolo_detect_torch.py wrote {files}")


# -- phase 16: the preprocessing chain ----------------------------------------

PRE_FULL = (1024, 2048)          # Cityscapes' frame
PRE_PARITY = (512, 1024)         # Panoptic-DeepLab card vs CPU
PRE_CITY = "syntown"
PRE_CAR_IID = 13001              # car trainId 13 * 1000 + 1
TOOLS = "c2m_tpu_torch.tools."
# the tracked box (h, w): a car some 40 m away in a Cityscapes frame. A box
# is cropped at about 1.8x its size and scaled to 127 px, so a smaller box
# is magnified more and the heads' float32 differences move its boxes less
PRE_BOX = (36, 48)


def pre_car_box(f):
    """The synthetic city's car in raw frame f: x, y, w, h (2048x1024)."""
    return 240 + 16 * f, 320, 320, 192


def bn_scales_near_one_(net: torch.nn.Module, seed: int) -> None:
    """Every BatchNorm scale := 1 +- 0.1. ``seeded_net_`` does that for
    parameters named ``bn.weight``; the preprocessing nets keep their
    checkpoints' names (``bn1``, a Sequential's ``1``)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.weight.copy_(
                    1 + (torch.rand(mod.weight.shape, generator=g) * 2 - 1)
                    * 0.1)


def float64_error(net: torch.nn.Module, args, got) -> float:
    """max |got - net(args) in float64| over max |float64 output|, the
    worst over the outputs, on the card: the float32 error of ``got``."""
    ref = copy.deepcopy(net).double()
    with torch.no_grad():
        want = ref(*[a.double() for a in args])
    del ref
    return rel_max(got, want)


def rel_max(got, want) -> float:
    """max |got - want| over max |want|, the worst over the outputs (a dict
    or a sequence of tensors, on any devices), in float64."""
    got = list(got.values()) if isinstance(got, dict) else list(got)
    want = list(want.values()) if isinstance(want, dict) else list(want)
    return max(float((g.cpu().double() - w.cpu().double()).abs().max()
                     / w.cpu().double().abs().max())
               for g, w in zip(got, want))


def f64_sides(name: str, card: torch.nn.Module, cpu: torch.nn.Module, args,
              dev) -> None:
    """One net card (float32, TF32 off) vs CPU within TOL_F64_MULTIPLE x
    the larger of the two sides' float32 errors, each against a float64
    copy of the net on its own side (ROADMAP C4)."""
    with torch.no_grad(), full_float32():
        c32 = card(*[a.to(dev) for a in args])
        p32 = cpu(*args)
        c64 = copy.deepcopy(card).double()(*[a.to(dev).double() for a in args])
        p64 = copy.deepcopy(cpu).double()(*[a.double() for a in args])
    d, e_card, e_cpu = rel_max(c32, p32), rel_max(c32, c64), rel_max(p32, p64)
    worst = max(e_card, e_cpu)
    log(f"  {name}, card vs CPU, TF32 off: max|d| / max|CPU| {d:.3g}; "
        f"float32 against float64 on the card {e_card:.3g}, on the CPU "
        f"{e_cpu:.3g}; card vs CPU in float64 {rel_max(c64, p64):.3g}; the "
        f"difference is {d / worst:.3g}x the larger float32 error (gate "
        f"{TOL_F64_MULTIPLE}x)")
    check(d <= TOL_F64_MULTIPLE * worst,
          f"{name}: card vs CPU {d} > {TOL_F64_MULTIPLE} x {worst}")


def float64_tracker(net: torch.nn.Module):
    """A SiamRPNTracker over a float64 copy of SiamRPN++: its float32 crops
    go in as float64, and its box arithmetic stays in float64."""
    from c2m_tpu_torch.models.siamrpn import SiamRPNTracker

    class Float64Tracker(SiamRPNTracker):
        @torch.no_grad()
        def _features(self, patch):
            return self.model.features(torch.from_numpy(
                patch.astype(np.float64))[None].to(self.device))
    return Float64Tracker(copy.deepcopy(net).double())


def centers_of(center: torch.Tensor, threshold: float = 0.1) -> int:
    """The peaks ``postprocess`` keeps before its top_k cut: a 7x7 max-pool
    NMS above the threshold."""
    heat = center[..., 0]
    pooled = torch.nn.functional.max_pool2d(heat[None, None], 7, stride=1,
                                            padding=3)[0, 0]
    return int(((heat >= pooled) & (heat > threshold)).sum())


def preprocess_panoptic(dev, root: str) -> str:
    """Panoptic-DeepLab: seeded weights through the bridge, card vs CPU at
    PRE_PARITY on all three heads, postprocess card vs CPU, then the full
    frame on the card; returns the npz path."""
    from c2m_tpu_torch.models.panoptic_deeplab import (PanopticDeepLab,
                                                       postprocess)
    from c2m_tpu_torch.ops.warp import resize_bilinear
    from c2m_tpu_torch.tools.generate_segmentation import MEAN, STD
    from c2m_tpu_torch.utils import convert
    frames = (smooth_frames(2, *PRE_FULL, SEED + 16) - MEAN) / STD
    x_full = torch.from_numpy(frames.astype(np.float32))
    net = seeded_net_(PanopticDeepLab(), SEED + 16)
    bn_scales_near_one_(net, SEED + 16)
    damp_residuals_(net)
    net = net.to(dev).eval()
    with full_float32():
        calibrate_bn_(net, x_full[:1].to(dev))
    path = os.path.join(root, "panoptic.npz")
    back = round_trip(net, convert.panoptic_to_jax, convert.panoptic_from_jax,
                      path, "Panoptic-DeepLab")
    cpu = PanopticDeepLab()
    cpu.load_state_dict(back)
    cpu.eval()
    n_params = sum(p.numel() for p in net.parameters())
    with torch.no_grad(), full_float32():
        x = resize_bilinear(x_full[1:], PRE_PARITY)
        got = net(x.to(dev))
        t0 = time.perf_counter()
        want = cpu(x)
        cpu_s = time.perf_counter() - t0
        f64 = float64_error(net, (x.to(dev),), got)
    errs = {k: float((got[k].cpu() - want[k]).abs().max()
                     / want[k].abs().max()) for k in want}
    log(f"  Panoptic-DeepLab (HRNet-48), {n_params / 1e6:.1f}M seeded "
        f"parameters, npz round trip bit for bit; card vs CPU at "
        f"[1,{PRE_PARITY[0]},{PRE_PARITY[1]},3], TF32 off (CPU "
        f"{cpu_s:.1f} s): max|d| / max|CPU| "
        + ", ".join(f"{k} {v:.3g} (|CPU| max "
                    f"{float(want[k].abs().max()):.3g})"
                    for k, v in errs.items()) + f" (tol {TOL_PRE_NET}); "
        f"the card's float32 against float64 {f64:.3g}")
    check(all(torch.isfinite(v).all() for v in want.values())
          and max(errs.values()) <= TOL_PRE_NET,
          f"Panoptic-DeepLab card vs CPU: {errs}")
    heads = [got[k][0] for k in ("semantic", "center", "offset")]
    sem_c, inst_c = postprocess(*heads)
    sem_h, inst_h = postprocess(*[h.cpu() for h in heads])
    check(torch.equal(sem_c.cpu(), sem_h) and torch.equal(inst_c.cpu(),
                                                          inst_h),
          "postprocess on the card differs from the CPU's")
    log(f"  postprocess card vs CPU on the card's heads at "
        f"{PRE_PARITY[0]}x{PRE_PARITY[1]}: both maps equal; "
        f"{centers_of(heads[1])} centers, "
        f"{len(torch.unique(inst_h[inst_h > 0]))} instances")
    del cpu, got, want
    release_memory()

    # C4: the same net undamped, held by each side's float64 error
    undamped = seeded_net_(PanopticDeepLab(), SEED + 16)
    bn_scales_near_one_(undamped, SEED + 16)
    undamped = undamped.to(dev).eval()
    with full_float32():
        calibrate_bn_(undamped, x_full[:1].to(dev))
    cpu = PanopticDeepLab()
    cpu.load_state_dict({k: v.cpu() for k, v in undamped.state_dict().items()})
    f64_sides("Panoptic-DeepLab undamped at "
              f"[1,{PRE_PARITY[0]},{PRE_PARITY[1]},3]", undamped, cpu.eval(),
              (x,), dev)
    del undamped, cpu
    release_memory()

    # the full frame on the card
    x = x_full[1:].to(dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), full_float32():
        out = net(x)
        heads = [out[k][0] for k in ("semantic", "center", "offset")]
        sem32 = out["semantic"].argmax(-1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            sem_tf32 = net(x)["semantic"].argmax(-1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    flipped = float((sem_tf32 != sem32).float().mean())
    sem, inst = postprocess(*heads)
    log(f"  full frame [1,{PRE_FULL[0]},{PRE_FULL[1]},3] on the card, float32 "
        f"TF32 off: postprocess gives {centers_of(heads[1])} centers above "
        f"0.1, {len(torch.unique(inst[inst > 0]))} instances; peak memory "
        f"{peak:.2f} GiB; with TF32 on {flipped:.3g} of the semantic pixels "
        f"change class")
    check(bool((sem >= 0).all() and (sem < 19).all()), "semantic ids")
    del net, x, out, heads
    release_memory()
    return path


def synthetic_video(n: int, seed: int):
    """(n uint8 frames [H, W, 3] at PRE_FULL, the moving box's xywh per
    frame): a textured PRE_BOX moving 6 px right and 2 px down per frame
    over a smooth background."""
    rng = np.random.RandomState(seed)
    bg = (smooth_frames(1, *PRE_FULL, seed)[0] * 160 + 40).astype(np.uint8)
    h, w = PRE_BOX
    tex = rng.randint(120, 255, (h, w, 3)).astype(np.uint8)
    frames, gt = [], []
    for f in range(n):
        img = bg.copy()
        x = PRE_FULL[1] * 7 // 16 + 6 * f
        y = PRE_FULL[0] * 3 // 8 + 2 * f
        img[y:y + h, x:x + w] = tex
        frames.append(img)
        gt.append([float(x), float(y), float(w), float(h)])
    return frames, gt


def preprocess_siamrpn(dev, root: str) -> str:
    """SiamRPN++: seeded weights through the bridge, features and heads card
    vs CPU, one tracker card vs CPU over 9 frames of the full frame, the OPE
    benchmark with the card tracker; returns the npz path."""
    from c2m_tpu_torch.eval.tracker_benchmark import evaluate_tracker
    from c2m_tpu_torch.models.siamrpn import (SiamRPNpp, SiamRPNTracker,
                                              TrackConfig, get_subwindow)
    from c2m_tpu_torch.utils import convert
    frames, gt = synthetic_video(9, SEED + 17)
    c = TrackConfig()
    pos = np.array([gt[0][0] + (gt[0][2] - 1) / 2,
                    gt[0][1] + (gt[0][3] - 1) / 2])
    s_z = np.sqrt((gt[0][2] + c.context_amount * sum(gt[0][2:]))
                  * (gt[0][3] + c.context_amount * sum(gt[0][2:])))
    avg = frames[0].mean(axis=(0, 1))
    z = torch.from_numpy(get_subwindow(frames[0], pos, c.exemplar_size,
                                       round(s_z), avg))[None]
    xs = torch.from_numpy(get_subwindow(
        frames[1], pos, c.instance_size,
        round(s_z * c.instance_size / c.exemplar_size), avg))[None]
    # the weights' seed was picked for the tracker's top-two pscore
    # margins, checked and printed below, so that card and CPU picking the
    # same anchors means something; its box stays near PRE_BOX's size over
    # the 9 frames
    net = seeded_net_(SiamRPNpp(), SEED + 18)
    bn_scales_near_one_(net, SEED + 18)
    damp_residuals_(net)
    net = net.to(dev).eval()
    with full_float32():
        calibrate_bn_(Pair(net), (z.to(dev), xs.to(dev)))
    path = os.path.join(root, "siamrpn.npz")
    back = round_trip(net, convert.siamrpn_to_jax, convert.siamrpn_from_jax,
                      path, "SiamRPN++")
    cpu = SiamRPNpp()
    cpu.load_state_dict(back)
    cpu.eval()
    with torch.no_grad(), full_float32():
        zf, xf = net.features(z.to(dev)), net.features(xs.to(dev))
        heads = net.heads(zf, xf)
        got = list(zf) + list(xf) + list(heads)
        f64 = float64_error(net, (z.to(dev), xs.to(dev)), heads)
        zf, xf = cpu.features(z), cpu.features(xs)
        want = list(zf) + list(xf) + list(cpu.heads(zf, xf))
    errs = [float((g.cpu() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    log(f"  SiamRPN++ (atrous ResNet-50), "
        f"{sum(p.numel() for p in net.parameters()) / 1e6:.1f}M seeded "
        f"parameters, npz round trip bit for bit; card vs CPU, TF32 off: "
        f"features 127 {max(errs[:3]):.3g}, features 255 {max(errs[3:6]):.3g},"
        f" cls {errs[6]:.3g}, loc {errs[7]:.3g} of the largest CPU output "
        f"(tol {TOL_PRE_NET}); the card's heads in float32 against float64 "
        f"{f64:.3g}")
    check(max(errs) <= TOL_PRE_NET, f"SiamRPN++ card vs CPU: {errs}")

    # one tracker, card vs CPU, over the 9 frames
    trackers = {"card": SiamRPNTracker(net), "cpu": SiamRPNTracker(cpu)}
    boxes = {k: [] for k in trackers}
    bests = {k: [] for k in trackers}
    margins = []
    with full_float32():
        for name, tr in trackers.items():
            tr.init(frames[0], gt[0])
            for f in range(1, 9):
                out = tr.track(frames[f])
                if name == "cpu":
                    top = np.sort(tr.pscore)[-2:]
                    margins.append(float(top[1] - top[0]))
                boxes[name].append(out["bbox"])
                bests[name].append(tr.best)
    d_box = float(np.abs(np.array(boxes["card"])
                         - np.array(boxes["cpu"])).max())
    log(f"  tracker on 9 frames of {PRE_FULL[1]}x{PRE_FULL[0]}, card vs CPU: "
        f"anchors {bests['card']} / {bests['cpu']}, boxes max|d| "
        f"{d_box:.3g} px (tol {TOL_BOX}), smallest top-two pscore margin "
        f"{min(margins):.3g}")
    check(min(margins) > 1e-3, f"fixture fault: pscore margins {margins}")
    check(bests["card"] == bests["cpu"] and d_box <= TOL_BOX,
          f"tracker card vs CPU: anchors {bests}, boxes {d_box}")

    # C4: the same net undamped, held by each side's float64 error, the
    # heads on the first pair and four trackers (card / CPU, float32 /
    # float64) over the 9 frames
    undamped = seeded_net_(SiamRPNpp(), SEED + 18)
    bn_scales_near_one_(undamped, SEED + 18)
    undamped = undamped.to(dev).eval()
    with full_float32():
        calibrate_bn_(Pair(undamped), (z.to(dev), xs.to(dev)))
    cpu_u = SiamRPNpp()
    cpu_u.load_state_dict({k: v.cpu() for k, v in
                           undamped.state_dict().items()})
    cpu_u.eval()
    f64_sides("SiamRPN++ heads undamped", undamped, cpu_u, (z, xs), dev)
    runs = {"card32": SiamRPNTracker(undamped), "cpu32": SiamRPNTracker(cpu_u),
            "card64": float64_tracker(undamped),
            "cpu64": float64_tracker(cpu_u)}
    ub = {k: [] for k in runs}
    with full_float32():
        for name, tr in runs.items():
            tr.init(frames[0], gt[0])
            for f in range(1, 9):
                ub[name].append(tr.track(frames[f])["bbox"])
    ub = {k: np.array(v) for k, v in ub.items()}
    d_u = float(np.abs(ub["card32"] - ub["cpu32"]).max())
    e_card = float(np.abs(ub["card32"] - ub["card64"]).max())
    e_cpu = float(np.abs(ub["cpu32"] - ub["cpu64"]).max())
    worst = max(e_card, e_cpu)
    log(f"  undamped tracker over the 9 frames, card vs CPU: boxes max|d| "
        f"{d_u:.3g} px; float32 against float64 on the card {e_card:.3g} px, "
        f"on the CPU {e_cpu:.3g} px; card vs CPU in float64 "
        f"{float(np.abs(ub['card64'] - ub['cpu64']).max()):.3g} px; the "
        f"difference is {d_u / max(worst, 1e-300):.3g}x the larger float32 "
        f"error (gate {TOL_F64_MULTIPLE}x)")
    check(d_u <= TOL_F64_MULTIPLE * worst,
          f"undamped tracker card vs CPU {d_u} px > {TOL_F64_MULTIPLE} x "
          f"{worst}")
    del undamped, cpu_u, runs
    release_memory()

    with full_float32():
        res = evaluate_tracker(SiamRPNTracker(net),
                               [{"frames": frames, "gt": gt}])
    log(f"  evaluate_tracker (OPE) on the 9-frame video with the card "
        f"tracker: {res}")
    check(all(np.isfinite(v) for v in res.values()), f"OPE {res}")
    del net, cpu, trackers
    release_memory()
    return path


def paint_city(root: str) -> None:
    """30 raw frames of PRE_FULL (road / sky gradient, a car moving right
    16 px a frame) with their crafted trainId and instance maps, as
    tests/test_preprocess_chain.py paints its scene; and the frame-0 label
    ids for the Cityscapes evaluator."""
    from PIL import Image
    h, w = PRE_FULL
    dirs = {d: os.path.join(root, d, PRE_CITY)
            for d in ("raw", "gt_semantic", "gt_instance")}
    for d in dirs.values():
        os.makedirs(d)
    base = np.zeros((h, w, 3), np.uint8)
    base[:h // 2] = (70, 130, 180)
    base[h // 2:] = (90, 90, 90)
    for f in range(30):
        img = base.copy()
        x, y, bw, bh = pre_car_box(f)
        img[y:y + bh, x:x + bw] = (220, 40, 40)
        sem = np.zeros((h, w), np.uint8)
        sem[:h // 2] = 10
        sem[y:y + bh, x:x + bw] = 13
        inst = np.zeros((h, w), np.uint16)
        inst[y:y + bh, x:x + bw] = PRE_CAR_IID
        stem = f"{PRE_CITY}_000000_{f:06d}"
        Image.fromarray(img).save(os.path.join(
            dirs["raw"], f"{stem}_leftImg8bit.png"), compress_level=1)
        Image.fromarray(sem).save(os.path.join(
            dirs["gt_semantic"], f"{stem}_ssmask.png"), compress_level=1)
        Image.fromarray(inst).save(os.path.join(
            dirs["gt_instance"], f"{stem}_gtFine_instanceIds.png"),
            compress_level=1)
        if f == 0:
            ids = np.where(sem == 10, 23, np.where(sem == 13, 26, 7))
            for sub, name in (("gt_eval", "gtFine_labelIds"),
                              ("pred_eval", "pred")):
                os.makedirs(os.path.join(root, sub, PRE_CITY))
                Image.fromarray(ids.astype(np.uint8)).save(os.path.join(
                    root, sub, PRE_CITY, f"{stem}_{name}.png"))
            # gtFine instanceIds carry label ids: 26 * 1000 + 1 for the car
            Image.fromarray(np.where(inst > 0, 26001, ids).astype(
                np.uint16)).save(os.path.join(
                    root, "gt_eval", PRE_CITY,
                    f"{stem}_gtFine_instanceIds.png"))


def run_cli(args, here: str, what: str, timeout: int = 600):
    """A CLI as the subprocess a user starts; -> (stdout, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=here,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} failed: {proc.stderr[-3000:]}")
    return proc.stdout, wall


def preprocess_chain(cfg, dev, root: str, weights: dict) -> dict:
    """Raw frames -> segmentation -> trajectories -> 128x256 frames and maps
    -> precomputed flows -> the port's training set -> one Trainer step, the
    port's CLIs as subprocesses; then evaluate_cityscapes on the crafted
    maps. Returns the kernel launches of precompute_flow's process."""
    from PIL import Image
    import yaml
    from c2m_tpu_torch.data.dataset import get_training_set
    from c2m_tpu_torch.data.flow_io import read_flow
    from c2m_tpu_torch.train.trainer import Trainer
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    paint_city(root)
    log(f"  painted a city of 30 raw {PRE_FULL[1]}x{PRE_FULL[0]} frames with "
        f"its maps in {time.perf_counter() - t0:.1f} s")
    def j(*parts):
        return os.path.join(root, *parts)

    out, wall = run_cli(["-m", TOOLS + "generate_segmentation",
                         "--images-root", j("raw"), "--out-semantic",
                         j("seg_semantic"), "--out-instance",
                         j("seg_instance"), "--weights", weights["panoptic"],
                         "--limit", "2"], here, "generate_segmentation")
    sem_files = sorted(os.listdir(j("seg_semantic", PRE_CITY)))
    inst_files = sorted(os.listdir(j("seg_instance", PRE_CITY)))
    check(sem_files == [f"{PRE_CITY}_000000_{f:06d}_ssmask.png"
                        for f in range(2)]
          and inst_files == [f"{PRE_CITY}_000000_{f:06d}_gtFine_instanceIds"
                             ".png" for f in range(2)],
          f"generate_segmentation wrote {sem_files} / {inst_files}")
    sem = np.array(Image.open(j("seg_semantic", PRE_CITY, sem_files[0])))
    inst = np.array(Image.open(j("seg_instance", PRE_CITY, inst_files[0])))
    check(sem.shape == inst.shape == PRE_FULL and sem.dtype == np.uint8
          and sem.max() <= 18 and all(11 <= v // 1000 <= 18
                                      for v in np.unique(inst[inst > 0])),
          "generate_segmentation's file contract")
    log(f"  generate_segmentation on 2 frames of {PRE_FULL[1]}x"
        f"{PRE_FULL[0]}: {wall:.1f} s as a subprocess; uint8 trainIds up to "
        f"{sem.max()}, {len(np.unique(inst[inst > 0]))} instances in frame 0")

    out, wall = run_cli(["-m", TOOLS + "generate_trajectories",
                         "--images-root", j("raw"), "--instance-root",
                         j("gt_instance"), "--out", j("tracking"),
                         "--weights", weights["siamrpn"], "--score-thresh",
                         "0", "--cover-thresh", "0", "--limit", "1"], here,
                        "generate_trajectories")
    txt = j("tracking", PRE_CITY, f"{PRE_CITY}_000000_000000_{PRE_CAR_IID}.txt")
    with open(txt) as f:
        rows = f.read().splitlines()
    want = [f"{float(x)},{float(y)},{float(w - 1)},{float(h - 1)},"
            f"{PRE_CAR_IID}" for x, y, w, h in map(pre_car_box, range(9))]
    check(rows == want, f"trajectory rows {rows}")
    log(f"  generate_trajectories on one clip (1 object, 9 frames): "
        f"{wall:.1f} s as a subprocess; 9 rows with the crafted motion")

    h, w = cfg.train_params.input_size
    t0 = time.perf_counter()
    for src, dst, nearest in (("raw", "train_images", False),
                              ("gt_semantic", "train_semantic", True),
                              ("gt_instance", "train_instance", True)):
        run_cli([os.path.join(here, "tools", "preprocess_images.py"),
                 "--src", j(src), "--dst", j(dst), "--height", str(h),
                 "--width", str(w)] + (["--nearest"] if nearest else []),
                here, "preprocess_images.py")
    run_cli([os.path.join(here, "tools", "generate_lists.py"),
             "--tracking-root", j("tracking"), "--out",
             j("cityscapes_train.txt")], here, "generate_lists.py")
    log(f"  frames and maps to {w}x{h}, data list: "
        f"{time.perf_counter() - t0:.1f} s (tools/preprocess_images.py, "
        f"tools/generate_lists.py)")

    cfg = copy.deepcopy(cfg)
    dp = cfg.dataset_params
    dp.root, dp.dataset = root, "cityscapes"
    for split in ("train", "val"):
        for field, value in (("images_path", "train_images"),
                             ("data_list", "cityscapes_train.txt"),
                             ("segmasks_path", "train_semantic"),
                             ("instances_path", "train_instance"),
                             ("tracking_path", "tracking"),
                             ("bw_of_path", "bw_of"), ("bw_occ_path", "bw_occ"),
                             ("fw_of_path", "fw_of"),
                             ("fw_occ_path", "fw_occ")):
            setattr(dp, f"{split}_{field}", value)
    yml = j("chain.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    t = cfg.train_params.num_frames
    out, wall = run_cli(["-m", TOOLS + "precompute_flow", "--config",
                         yml, "--limit", "1"], here, "precompute_flow")
    line = next(ln for ln in out.splitlines()
                if ln.startswith("kernel launches: "))
    counts = json.loads(line[len("kernel launches: "):])
    flows = [os.path.join(j(kind, PRE_CITY), f) for kind in ("bw_of", "fw_of")
             for f in sorted(os.listdir(j(kind, PRE_CITY)))]
    check(len(flows) == 2 * (t - 1), f"{len(flows)} flow files")
    check(all(np.isfinite(read_flow(p)).all() and read_flow(p).shape
              == (h, w, 2) for p in flows), "a flow file is not finite")
    log(f"  precompute_flow at the journal config ({t} frames, {w}x{h}) on "
        f"one clip: {wall:.1f} s as a subprocess; {len(flows)} .flow files, "
        f"finite; launches in its process {counts}")
    # FlowNet2 runs float32, TF32 off, under no_grad: its convs take the
    # patch route's gather (nn/layers.conv_route)
    expect_launched(counts, {"correlation", "corresponding_map",
                             "conv_patches"}, "precompute_flow")
    # one compute_flow_and_conf call over the run of clips' 2(T-1) pairs a
    # clip (tools/precompute_flow.batch_flows): one clip here
    check(counts["correlation"] == counts["corresponding_map"] == 1,
          f"precompute_flow launches {counts}, not one of K5 and K4")

    cfg.train_params.batch_size = 1
    cfg.train_params.workers = 0
    train_set = get_training_set(cfg)
    item = train_set[0]
    check(len(train_set) == 1 and int(item["node_mask"].sum()) == 1
          and int(item["inst_ids"][0]) == PRE_CAR_IID,
          "the training set over the chain's output")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train_set, job_dir=j("job"), device=dev)
    trainer.fit(num_epochs=1, max_steps=1)
    torch.cuda.synchronize()
    metrics = {k: float(v) for k, v in trainer.history[-1]["metrics"].items()}
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    check(not bad, f"the Trainer step on the chain's clip: non-finite {bad}")
    log(f"  get_training_set loads the clip (1 tracked node); one Trainer "
        f"step on it in {time.perf_counter() - t0:.1f} s (Trainer built): "
        f"total_gen {metrics['total_gen']:.4f}")
    del trainer
    release_memory()

    res_path = j("eval.json")
    out, wall = run_cli(["-m", TOOLS + "evaluate_cityscapes", "pixel",
                         "--gt-dir", j("gt_eval"), "--pred-dir",
                         j("pred_eval"), "--out", res_path], here,
                        "evaluate_cityscapes")
    with open(res_path) as f:
        res = json.load(f)
    present = {k: res["classScores"][k] for k in ("road", "sky", "car")}
    log(f"  evaluate_cityscapes pixel on the crafted frame-0 maps against "
        f"themselves: {wall:.1f} s; IoU {present}, iIoU car "
        f"{res['classInstScores']['car']}")
    check(all(v == 1.0 for v in present.values()), f"IoU {present}")
    return counts


def phase_preprocess(cfg, dev, smi: str) -> dict:
    """Phase 16: the preprocessing chain on the card."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    log("[phase 16] the preprocessing chain: Panoptic-DeepLab segmentation, "
        "SiamRPN++ tracking and its OPE benchmark, FlowNet2 flow precompute "
        "(K5, K4) and the Cityscapes evaluator, through the port's CLIs")
    root = tempfile.mkdtemp(prefix="c2m_pre_")
    try:
        weights = {"panoptic": preprocess_panoptic(dev, root),
                   "siamrpn": preprocess_siamrpn(dev, root)}
        counts = preprocess_chain(cfg, dev, root, weights)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(smi)
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    release_memory()
    return counts


# -- phase 17: reference checkpoint -> job dir -> artifact; the dataset tools -

# upfirdn2d / bias_act card vs CPU: the same float32 products summed in
# another order (at most 4x4 taps, then one activation)
TOL_UPFIRDN = 1e-5


def tool_args(cfg) -> dict:
    """The journal config's YAML path and the dataset tree's size."""
    from c2m_tpu_torch.config import JOURNAL
    tp = cfg.train_params
    return {"config": JOURNAL, "h": tp.input_size[0], "w": tp.input_size[1],
            "frames": tp.num_frames, "objects": cfg.dataset_params.max_objects}


def reference_checkpoint(cfg, path: str) -> dict:
    """A seeded C2MTrainModel (phase 4's generator weights, GATv2's lin_r
    biases zero as the reference has none) written as a reference
    ``.pth.tar``; -> its state_dict."""
    from c2m_tpu_torch.train.state import create_train_state
    layout = load_test_module("torch_reference_layout")
    model = create_train_state(cfg, seed=SEED + 17, device="cpu").model
    model.c2m.load_state_dict(build_model(cfg).state_dict())
    sd = model.state_dict()
    for k, v in sd.items():
        if ".lin_r." in k and k.endswith(".bias"):
            v.zero_()
    layout.save_reference(path, sd, cfg)
    return sd


def tools_checkpoint(cfg, dev, root: str, here: str) -> tuple:
    """convert_c2m and export_serving as subprocesses; one request served
    from the artifact against the seeded model served directly, bit for
    bit. -> (the converted job dir, the request's launch counts)."""
    from c2m_tpu_torch.models.c2m import DTYPES, C2MGenerator
    from c2m_tpu_torch.serving import ServingModel
    from c2m_tpu_torch.utils.checkpoint import load_payload
    a = tool_args(cfg)
    ckpt = os.path.join(root, "latest_c2m_model.pth.tar")
    t0 = time.perf_counter()
    sd = reference_checkpoint(cfg, ckpt)
    n_values = sum(v.numel() for v in sd.values())
    log(f"  a seeded train model ({n_values / 1e6:.1f}M values) written as a "
        f"reference checkpoint "
        f"({os.path.getsize(ckpt) / 2 ** 20:.1f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    job = os.path.join(root, "job")
    _, wall = run_cli(["-m", TOOLS + "convert_c2m", "--checkpoint", ckpt,
                       "--config", a["config"], "--out", job], here,
                      "convert_c2m")
    saved = load_payload(job)
    same = set(saved["model"]) == set(sd) and all(
        torch.equal(saved["model"][k], v) for k, v in sd.items())
    log(f"  convert_c2m as a subprocess in {wall:.1f} s: job dir at step "
        f"{saved['step']}, epoch {saved['epoch']}; every tensor equal to the "
        f"seeded model's: {same}")
    check(same and saved["step"] == 0, "convert_c2m's job dir differs from "
          "the seeded model")
    del saved
    art = os.path.join(root, "artifact")
    _, wall = run_cli(["-m", TOOLS + "export_serving", "--config",
                       a["config"], "--job-dir", job, "--out", art,
                       "--batch-sizes", str(BUCKET)], here, "export_serving")
    log(f"  export_serving --batch-sizes {BUCKET} as a subprocess in "
        f"{wall:.1f} s: {sorted(os.listdir(art))}")

    (req,) = requests(cfg, dev, sizes=(BUCKET,))
    server = ServingModel.from_artifact(art, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    got = server(*req)
    torch.cuda.synchronize()
    counts = read_launches()
    expect_launched(counts, FORWARD_128, "the exported artifact's request")
    direct = C2MGenerator(cfg)
    direct.load_state_dict({k[len("c2m."):]: v for k, v in sd.items()
                            if k.startswith("c2m.")})
    direct = ServingModel(direct.to(dev).use_compute_dtype(
        DTYPES[cfg.train_params.dtype]), (BUCKET,))
    want = direct(*req)
    gen = got["generated"]
    equal = np.array_equal(gen, want["generated"])
    log(f"  the artifact served on the card: batch {BUCKET}, generated "
        f"{list(gen.shape)} in [{gen.min():.3f}, {gen.max():.3f}], equal bit "
        f"for bit to the seeded model served directly: {equal} (max|d| "
        f"{float(np.abs(gen - want['generated']).max()):.3g}); launches "
        f"{counts}")
    check(equal and bool(np.isfinite(gen).all()),
          "the converted and exported model serves other frames")
    del server, direct
    release_memory()
    return job, counts


def synthetic_card_vs_cpu(card: str, cpu: str, a: dict, clips: int) -> None:
    """make_synthetic_dataset again, in this process with ``--device cpu``
    (the plain versions of K2 and K4), into ``cpu``: the same files, byte
    for byte but for the rasterized ones, which are held to phase 10's card
    vs CPU gates (flow support and occlusions flipping on at most TOL_FLIP
    and TOL_OCC of the pixels, flows within 1e-3 px where both have one)."""
    from PIL import Image
    from c2m_tpu_torch.data.flow_io import read_flow
    from c2m_tpu_torch.tools import make_synthetic_dataset as tool
    t0 = time.perf_counter()
    check(tool.main(["--root", cpu, "--clips", str(clips), "--height",
                     str(a["h"]), "--width", str(a["w"]), "--frames",
                     str(a["frames"]), "--max-objects", str(a["objects"]),
                     "--device", "cpu"]) == 0, "make_synthetic_dataset on CPU")
    wall = time.perf_counter() - t0

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)
    files = tree(card)
    check(files == tree(cpu), "make_synthetic_dataset: card and CPU trees "
          "hold other files")
    flows = occs = 0
    support = flow = occ = 0.0
    for f in files:
        x, y = os.path.join(card, f), os.path.join(cpu, f)
        if f.endswith(".flow"):
            got, want = read_flow(x), read_flow(y)
            same = (got != 0).any(-1) == (want != 0).any(-1)
            support = max(support, 1.0 - float(same.mean()))
            flow = max(flow, float(np.abs(got - want).max(-1)[same].max(
                initial=0.0)))
            flows += 1
        elif "occlusion" in f:
            got, want = np.array(Image.open(x)), np.array(Image.open(y))
            check(got.shape == want.shape, f"occlusion {f}: {got.shape}")
            occ = max(occ, float(np.mean(got != want)))
            occs += 1
        else:
            with open(x, "rb") as p, open(y, "rb") as q:
                check(p.read() == q.read(), f"make_synthetic_dataset: {f} "
                      f"differs card vs CPU")
    log(f"  make_synthetic_dataset --device cpu in this process in {wall:.1f} "
        f"s: {len(files)} files, the same names; {len(files) - flows - occs} "
        f"byte-equal to the card's; over {flows} .flow files support "
        f"mismatch {support:.3g} (tol {TOL_FLIP}), flow max|diff| "
        f"{flow:.3g} px where both have one (tol 1e-3); over {occs} occlusion"
        f" PNGs mismatch {occ:.3g} (tol {TOL_OCC})")
    check(flows > 0 and occs > 0, "make_synthetic_dataset wrote no rasters")
    check(support <= TOL_FLIP and flow <= 1e-3 and occ <= TOL_OCC,
          "make_synthetic_dataset card vs CPU over the raster gates")


def tools_dataset(cfg, dev, root: str, here: str, job: str) -> dict:
    """make_synthetic_dataset as a subprocess on the card (K2 and K4
    counted in its process), then eval_torch.py on the converted job dir and
    train_torch.py for 2 steps, both reading that tree from disk. -> the
    dataset tool's launch counts."""
    import yaml
    from c2m_tpu_torch.utils.checkpoint import latest_step
    a = tool_args(cfg)
    data = os.path.join(root, "data")
    clips = 2 * cfg.train_params.batch_size       # two train steps
    out, wall = run_cli(["-m", TOOLS + "make_synthetic_dataset", "--root",
                         data, "--clips", str(clips), "--height", str(a["h"]),
                         "--width", str(a["w"]), "--frames", str(a["frames"]),
                         "--max-objects", str(a["objects"])], here,
                        "make_synthetic_dataset")
    line = next(ln for ln in out.splitlines()
                if ln.startswith("kernel launches: "))
    counts = json.loads(line[len("kernel launches: "):])
    n = sum(len(files) for _, _, files in os.walk(data))
    log(f"  make_synthetic_dataset: {clips} clips a split at {a['w']}x"
        f"{a['h']}, {a['frames']} frames, {a['objects']} objects, as a "
        f"subprocess in {wall:.1f} s: {n} files; launches in its process "
        f"{counts}")
    expect_launched(counts, {"warp_masks_winner", "corresponding_map"},
                    "make_synthetic_dataset")
    check(counts["warp_masks_winner"] == 2 * clips
          and counts["corresponding_map"] == 4 * clips,
          f"make_synthetic_dataset launches {counts}: not one K2 and two K4 "
          f"a clip")
    synthetic_card_vs_cpu(data, os.path.join(root, "data_cpu"), a, clips)

    dcfg = copy.deepcopy(cfg)
    dcfg.dataset_params.root = data
    dcfg.checkpoint_params.save_epoch_freq = 1
    yml = os.path.join(root, "synthetic_tree.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(dcfg.to_dict(), f)
    out, wall = run_cli([os.path.join(here, "eval_torch.py"), "--config", yml,
                         "--job-dir", job, "--max-batches", "1"], here,
                        "eval_torch.py")
    with open(os.path.join(job, "eval", "results.txt")) as f:
        results = dict(ln.split(": ") for ln in f.read().splitlines())
    log(f"  eval_torch.py on the converted job dir over the tree's val split "
        f"as a subprocess in {wall:.1f} s: results.txt {results}")
    check("batch 0 done" in out and "trajectory_mse_theta" in results,
          f"eval_torch.py on the converted job dir: {out[-2000:]}")
    tjob = os.path.join(root, "train_job")
    out, wall = run_cli([os.path.join(here, "train_torch.py"), "--config",
                         yml, "--job-dir", tjob, "--num-epochs", "1",
                         "--max-steps", "2"], here, "train_torch.py")
    with open(os.path.join(tjob, "iter.txt")) as f:
        it = f.read()
    log(f"  train_torch.py --max-steps 2 on the tree as a subprocess in "
        f"{wall:.1f} s: saved step {latest_step(tjob)}, iter.txt {it}")
    check(latest_step(tjob) == 2 and it == "1,2",
          f"train_torch.py on the tree: step {latest_step(tjob)}, {it}")
    return counts


def tools_upfirdn(dev) -> None:
    """upfirdn2d (2x up with a 4x4 filter, 2x down) and bias_act (every
    activation) at a StyleGAN2 layer's size, card vs CPU."""
    from c2m_tpu_torch.ops.upfirdn import _ACTS, bias_act, upfirdn2d
    g = torch.Generator().manual_seed(SEED + 17)
    x = torch.randn(4, 128, 128, 64, generator=g)
    k = torch.rand(4, 4, generator=g)
    k /= k.sum()
    errs = {}
    with full_float32():
        for name, args in (("up", dict(up=2, pad=(2, 1))),
                           ("down", dict(down=2, pad=(1, 1)))):
            want = upfirdn2d(x, k, **args)
            got = upfirdn2d(x.to(dev), k.to(dev), **args)
            errs[f"upfirdn2d {name} {list(got.shape)}"] = float(
                (got.cpu() - want).abs().max())
        b = torch.randn(64, generator=g)
        for act in sorted(_ACTS):
            got = bias_act(x.to(dev), b.to(dev), act, clamp=256.0)
            errs[f"bias_act {act}"] = float(
                (got.cpu() - bias_act(x, b, act, clamp=256.0)).abs().max())
    log("  upfirdn2d / bias_act on [4,128,128,64], card vs CPU max|d|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {TOL_UPFIRDN})")
    check(max(errs.values()) <= TOL_UPFIRDN, f"upfirdn card vs CPU: {errs}")


def phase_tools(cfg, dev, smi: str) -> dict:
    """Phase 17: a reference checkpoint through convert_c2m and
    export_serving to a served request, the dataset tool feeding eval and
    train, and upfirdn; -> the launch counts of the artifact's request and
    of make_synthetic_dataset's process."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    log("[phase 17] the tools: a reference checkpoint -> convert_c2m -> "
        "export_serving -> a served request; make_synthetic_dataset (K2, K4) "
        "-> eval_torch.py and train_torch.py from disk; upfirdn")
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="c2m_tools_")
    try:
        job, served = tools_checkpoint(cfg, dev, root, here)
        made = tools_dataset(cfg, dev, root, here, job)
        tools_upfirdn(dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(smi)
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    release_memory()
    return {"tools_serving": served, "tools_dataset": made}


# -- phase 18: the patch route of the float32 convolutions --------------------

# the patch conv against the cuDNN conv, float32 with TF32 off, at every
# serving shape: max |diff| over the largest |output|. Two float32 sums of
# K <= 14256 products in other orders (cuDNN's FFT rounds more than a
# direct sum; both read under 1e-5 against float64 at these shapes)
TOL_PATCH_CONV = 1e-4


@contextlib.contextmanager
def on_route(route: str):
    """Every Conv / Conv3d call inside takes ``route`` ("cudnn" or
    "patch"), whatever ``layers.conv_route`` would pick: the same modules on
    either route, for the comparisons of phases 18 and 19 (float32 only)."""
    from c2m_tpu_torch.nn import layers
    real = layers.conv_route
    layers.conv_route = lambda *a: route
    try:
        yield
    finally:
        layers.conv_route = real


def record_convs(model):
    """Forward pre-hooks on every Conv / Conv3d of ``model`` appending
    (module name, module, input shape) to the returned list; -> (list,
    handles)."""
    from c2m_tpu_torch.nn.layers import Conv, Conv3d
    calls, handles = [], []
    for name, m in model.named_modules():
        if isinstance(m, (Conv, Conv3d)):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: calls.append(
                    (name, mod, tuple(args[0].shape)))))
    return calls, handles


def patch_shape_row(name, mod, shape, dev) -> dict:
    """One serving conv shape: the gather kernel vs its plain version on
    the first and the last chunk, the patch conv vs cuDNN vs float64."""
    from c2m_tpu_torch.nn import layers
    from c2m_tpu_torch.ops.hopper import patches_kernel as pk
    g = torch.Generator(device=dev).manual_seed(SEED + len(shape))
    x = torch.randn(shape, generator=g, device=dev)
    kernel, stride, pad = tuple(mod.kernel_size), mod.stride, mod.pad
    b, *spatial, c = shape
    outs = [pk.out_size(n, k, s_, p) for n, k, s_, p in
            zip(spatial, kernel, stride, pad)]
    n_rows, k_all = b * int(np.prod(outs)), c * int(np.prod(kernel))
    chunk = min(n_rows, max(1, layers.PATCH_BYTES // (4 * k_all)))
    equal = True
    for row0 in sorted({0, n_rows - chunk}):
        got = pk.conv_patches(x, kernel, stride, pad, mod.pad_mode, row0,
                              chunk)
        want = pk.conv_patches_plain(x, kernel, stride, pad, mod.pad_mode,
                                     row0, chunk)
        equal = equal and torch.equal(got, want)
        del got, want
    with torch.no_grad(), on_route("cudnn"):
        cudnn = mod(x)
        xp = layers.pad_spatial(x.double(), [(p, p) for p in pad],
                                mod.pad_mode)
        conv = (torch.nn.functional.conv2d if len(kernel) == 2
                else torch.nn.functional.conv3d)
        exact = conv(xp.movedim(-1, 1), mod.weight.double(),
                     None if mod.bias is None else mod.bias.double(),
                     stride).movedim(1, -1)
        del xp
    with torch.inference_mode():
        patch = layers.patch_conv(*layers._operands(mod, x), stride, pad,
                                  mod.pad_mode)
    scale = float(exact.abs().max())
    errs = {"patch_vs_cudnn": float((patch - cudnn).abs().max()) / scale,
            "patch_vs_f64": float((patch.double() - exact).abs().max())
            / scale,
            "cudnn_vs_f64": float((cudnn.double() - exact).abs().max())
            / scale}
    del patch, cudnn, exact
    log(f"  {name[:44]:44s} {list(shape)} k{list(kernel)} s{list(stride)} "
        f"F{mod.out_channels}: {-(-n_rows // chunk)} chunk(s); err "
        f"patch-cuDNN {errs['patch_vs_cudnn']:.2e}, vs f64 patch "
        f"{errs['patch_vs_f64']:.2e} cuDNN {errs['cudnn_vs_f64']:.2e}; "
        f"gather == plain {equal}")
    check(equal, f"{name} {shape}: the gather kernel differs from its plain "
          f"version")
    check(errs["patch_vs_cudnn"] <= TOL_PATCH_CONV,
          f"{name} {shape}: patch conv vs cuDNN {errs['patch_vs_cudnn']}")
    return errs


def phase_patch_conv(cfg, dev):
    """Phase 18 (module docstring). -> the launch counts of the served
    requests."""
    from c2m_tpu_torch.models.c2m import DTYPES
    from c2m_tpu_torch.nn import layers
    from c2m_tpu_torch.ops.hopper import patches_kernel as pk
    from c2m_tpu_torch.serving import ServingModel
    t_phase = time.perf_counter()
    cfg32 = copy.deepcopy(cfg)
    cfg32.train_params.dtype = "float32"
    log("[phase 18] the patch route of the float32 convolutions at the "
        "journal config, TF32 off: routes, the gather kernel, patch vs "
        "cuDNN vs float64 per shape")
    model = build_model(cfg32).to(dev).use_compute_dtype(
        DTYPES[cfg32.train_params.dtype])
    server = ServingModel(model, (1, BUCKET), use_gt_eval=False)
    reqs = requests(cfg32, dev, sizes=(1, BUCKET))
    calls, handles = record_convs(model)
    routes, recorded = {}, []
    reset_launches()
    with full_float32():
        for batch, z, click in reqs:
            bs = z.shape[0]
            server(batch, z, click)                     # warm
            torch.cuda.synchronize()
            calls.clear()
            before, launches = dict(layers.CONV_CALLS), \
                pk.CONV_PATCHES.launches
            server(batch, z, click)
            torch.cuda.synchronize()
            routes[bs] = {k: layers.CONV_CALLS[k] - before[k] for k in before}
            routes[bs]["gather_launches"] = pk.CONV_PATCHES.launches - launches
            recorded += calls
            log(f"  request of {bs} clip(s): {len(calls)} conv calls, "
                f"{routes[bs]}")
    for h in handles:
        h.remove()
    counts = read_launches()
    check(all(v["cudnn"] == 0 and v["patch"] > 0 for v in routes.values())
          and routes[BUCKET]["gather_launches"] > 0,
          f"a float32 request's convs did not all take the patch route: "
          f"{routes}")

    # one row per conv geometry and input shape
    shapes = {}
    for name, mod, shape in recorded:
        shapes.setdefault((mod.in_channels, mod.out_channels,
                           tuple(mod.kernel_size), mod.stride, mod.pad,
                           mod.pad_mode, shape), (name, mod, shape))
    worst = {}
    with full_float32():
        for name, mod, shape in shapes.values():
            for k, v in patch_shape_row(name, mod, shape, dev).items():
                worst[k] = max(worst.get(k, 0.0), v)
            release_memory()
    log(f"  {len(shapes)} conv shapes, worst over them: {worst}")
    del server, model
    release_memory()
    log(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 19: the patch route's backward in the float32 train step -----------

def record_train_convs(model):
    """Forward hooks on every Conv / Conv3d of ``model`` appending (module
    name, module, input shape, grad mode, input needs a gradient, weight
    needs a gradient) to the returned list, and adding the name of a call
    whose output a backward reached to the returned set; -> (list, set,
    handles)."""
    from c2m_tpu_torch.nn.layers import Conv, Conv3d
    calls, reached, handles = [], set(), []

    def hook(mod, args, out, name):
        grad = torch.is_grad_enabled()
        calls.append((name, mod, tuple(args[0].shape), grad,
                      grad and args[0].requires_grad,
                      grad and mod.weight.requires_grad))
        if out.requires_grad:
            key = len(calls) - 1
            out.register_hook(lambda g: reached.add(key))

    for name, m in model.named_modules():
        if isinstance(m, (Conv, Conv3d)):
            handles.append(m.register_forward_hook(
                lambda mod, args, out, name=name: hook(mod, args, out,
                                                       name)))
    return calls, reached, handles


def train_shape_row(name, mod, shape, need_x, need_w, dev) -> dict:
    """One conv shape of the float32 train step: the output, input
    gradient and weight gradient (each where the step needs it) on cuDNN
    and on the patch route, each side's gap against float64."""
    import torch.nn.functional as F
    from c2m_tpu_torch.nn import layers
    g = torch.Generator(device=dev).manual_seed(SEED + 19 + len(shape))
    x = torch.randn(shape, generator=g, device=dev)
    kernel, stride, pad, mode = (tuple(mod.kernel_size), mod.stride, mod.pad,
                                 mod.pad_mode)
    conv = F.conv2d if len(kernel) == 2 else F.conv3d
    w, b = mod.weight.detach(), mod.bias.detach()

    def cudnn_conv(x_, w_, b_):
        xp = layers.pad_spatial(x_, [(p, p) for p in pad], mode)
        return conv(xp.movedim(-1, 1), w_, b_, stride).movedim(1, -1)

    def patch_conv(x_, w_, b_):
        return layers.PatchConv.apply(x_, w_, b_, stride, pad, mode)

    y_shape = cudnn_conv(x[:1], w, b).shape[1:]
    gy = torch.randn(shape[0], *y_shape, generator=g, device=dev)

    def outputs(side_conv, dtype):
        """The output and the gradients the step needs, in ``dtype``."""
        ops = {"x": x.to(dtype, copy=True).requires_grad_(need_x),
               "w": w.to(dtype, copy=True).requires_grad_(need_w),
               "b": b.to(dtype, copy=True).requires_grad_(need_w)}
        y = side_conv(*ops.values())
        wrt = {k: t for k, t in ops.items() if t.requires_grad}
        got = dict(zip(wrt, torch.autograd.grad(y, list(wrt.values()),
                                                gy.to(dtype)))) if wrt else {}
        return {"y": y.detach(), **got}

    # float64 on the card, cuDNN's arithmetic: the yardstick of both sides
    want = outputs(cudnn_conv, torch.float64)
    row = {}
    for side, side_conv in (("cudnn", cudnn_conv), ("patch", patch_conv)):
        got = outputs(side_conv, torch.float32)
        row[side] = {k: float((got[k].double() - v).abs().max()
                              / v.abs().max().clamp_min(1e-30))
                     for k, v in want.items()}
        del got
    log(f"  {name[:40]:40s} {list(shape)} k{list(kernel)} s{list(stride)} "
        f"F{mod.out_channels} x{int(need_x)}w{int(need_w)}: vs f64 "
        + "; ".join(f"{side} " + " ".join(f"{k} {v:.2e}" for k, v in
                                          gaps.items())
                    for side, gaps in row.items()))
    for side, side_gaps in row.items():
        for k, v in side_gaps.items():
            check(v <= TOL_PATCH_CONV, f"{name} {shape}: {side} {k} against "
                  f"float64 {v}")
    return row


def phase_patch_backward(cfg, dev):
    """Phase 19 (module docstring). -> the launch counts of one step."""
    from c2m_tpu_torch.nn import layers
    from c2m_tpu_torch.train.state import create_train_state
    from c2m_tpu_torch.train.step import make_train_step
    t_phase = time.perf_counter()
    cfg32 = copy.deepcopy(cfg)
    cfg32.train_params.dtype = "float32"
    log("[phase 19] the patch route's backward in the float32 train step "
        "at the journal config, TF32 off: routes, the adjoint kernel, patch "
        "and cuDNN vs float64 per shape")
    state = create_train_state(cfg32, seed=SEED, device=dev)
    batch = train_batch(cfg32, dev, cfg32.train_params.batch_size, 11)
    step = make_train_step(cfg32)
    calls, reached, handles = record_train_convs(state.model)
    with full_float32():
        step(state, batch)                              # warm
        torch.cuda.synchronize()
        calls.clear()
        reached.clear()
        before = dict(layers.CONV_CALLS)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
    counts = read_launches()
    for h in handles:
        h.remove()
    routed = {k: layers.CONV_CALLS[k] - before[k] for k in before}
    # a trained conv's grad-enabled call stays on cuDNN; a frozen conv's
    # (VGG19) and every no_grad call take the patch route, and its backward
    # runs where the input needs a gradient and the output reaches a loss
    trained = [c[0] for c in calls if c[5]]
    unused = [c[0] for i, c in enumerate(calls)
              if (c[4] or c[5]) and i not in reached]
    backward = sum(1 for i, c in enumerate(calls)
                   if c[4] and not c[5] and i in reached)
    log(f"  one float32 train step (TF32 off): {len(calls)} Conv / Conv3d "
        f"calls ({sum(1 for c in calls if not c[3])} without grad, "
        f"{len(trained)} of trained convs with grad), routes {routed}; "
        f"{len(unused)} calls that need a gradient reach no loss (no "
        f"backward runs): {unused}; gather launches "
        f"{counts['conv_patches']}, adjoint launches "
        f"{counts['conv_patches_adjoint']}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    check(routed["cudnn"] == len(trained)
          and routed["patch"] == len(calls) - len(trained)
          and routed["patch_backward"] == backward
          and counts["conv_patches_adjoint"] > 0,
          f"the train step's routes: {routed}, {len(trained)} trained convs "
          f"with grad, {backward} frozen-conv backwards")
    del state, batch
    release_memory()

    seen, worst = set(), {}
    with full_float32():
        for i, (name, mod, shape, grad, need_x, need_w) in enumerate(calls):
            # a backward runs only where the output reaches a loss
            need_x, need_w = need_x and i in reached, need_w and i in reached
            key = (mod.in_channels, mod.out_channels, tuple(mod.kernel_size),
                   mod.stride, mod.pad, mod.pad_mode, shape, need_x, need_w)
            if key in seen:
                continue
            seen.add(key)
            row = train_shape_row(name, mod, shape, need_x, need_w, dev)
            for side, gaps in row.items():
                worst[side] = max(worst.get(side, 0.0), *gaps.values())
            release_memory()
    log(f"  {len(seen)} conv shapes, worst gap against float64 over output "
        f"and gradients: {worst}")
    log(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one GPU",
              file=sys.stderr)
        return 2
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
    phase_kernels(dev)

    cfg = load_config()                     # configs/c2m_journal_cityscapes.yaml
    counts = {"serving": phase_serving(cfg, dev)}
    with full_float32():
        phase_cpu_parity(cfg, dev)
    release_memory()
    counts["train"] = phase_train(cfg, dev)
    with full_float32():
        phase_train_cpu_parity(cfg, dev)
    release_memory()
    counts["onthefly"] = phase_onthefly(cfg, dev)
    release_memory()
    long_cfg = load_config(LONG_YAML)
    counts["long_serving"] = phase_long_serving(long_cfg, dev)
    release_memory()
    phase_long_raster_parity(long_cfg, dev)
    counts["long_train"] = phase_long_train(long_cfg, dev)
    release_memory()
    counts.update(phase_program(cfg, dev))
    release_memory()
    counts.update(phase_variants(cfg, dev))
    counts["nccl"] = phase_nccl(cfg, dev)
    counts["metric_eval"] = phase_metric_nets(cfg, dev, smi)
    counts["preprocess"] = phase_preprocess(cfg, dev, smi)
    counts.update(phase_tools(cfg, dev, smi))
    counts["patch_conv"] = phase_patch_conv(cfg, dev)
    counts["patch_train"] = phase_patch_backward(cfg, dev)
    loaded = {m.split(".")[0] for m in sys.modules}
    check(not loaded & {"jax", "jaxlib", "flax", "optax"}, "JAX was imported")
    check("c2m_tpu" not in loaded, "the JAX package c2m_tpu was imported")

    # launches: the sum over the paths, each counted from 0 just before the
    # path was driven
    kernels = []
    for k in all_kernels():
        by_path = {f"launches_{path}": c[k.name] for path, c in counts.items()}
        kernels.append({"name": k.name, "source": k.source,
                        "launches": sum(by_path.values()), **by_path})
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
