"""Precompute the backward / forward optical flows and occlusion maps of
every clip with FlowNet2: the port of ``tools/precompute_flow.py``.

The training loader reads precomputed ``.flow`` files and occlusion PNGs
(cityscapes.py:216-261). For each clip of the split's data list and each
frame i in 1..T-1 of it, with ``src`` the last input frame:

- backward flow and confidence = ``compute_flow_and_conf(frame_i, src)``,
- forward flow and confidence = ``compute_flow_and_conf(src, frame_i)``,

written under the config's ``{split}_{bw,fw}_of_path`` /
``{split}_{bw,fw}_occ_path`` with the config's suffixes and frame i's
index, the occlusion PNG at ``(conf * 255).astype(uint8)`` (a truncation,
as the JAX tool writes it). Frames are read by ``data/cityscapes.
load_image`` at the config's ``input_size``, in [0, 1] as the JAX tool
passes them. The clips go through :func:`batch_flows` in runs of the
config's ``train_params.batch_size`` (the last run may be shorter): the
run's 2(T-1) pairs a clip in ``compute_flow_and_conf`` calls of at most
``PAIR_PIXELS_PER_CALL`` pair pixels, so one launch of the FlowNetC
correlation kernel and one of the confidence splat on the card a call (one
call a run at the journal's 128x256, one pair a call at 512x1024); on the
card the tool ends with a line ``kernel launches: {json}``, every
hand-written kernel's launches in this process.
The net runs in full float32 (TF32 off), so the files are those of the
float32 reference.

  python -m c2m_tpu_torch.tools.precompute_flow [--config YAML]
      [--root DIR] [--split train|val] [--weights flownet2.npz]
      [--limit N] [--device cpu]

``--weights``: the npz that ``train/flow_onthefly.OnTheFlyFlow`` reads
(the converted parameter tree of ``tools/convert_flownet2.py``). Without
it the weights are PyTorch's default init from seed 0 and the flows are
noise.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch
from PIL import Image

from c2m_tpu_torch import trace
from c2m_tpu_torch.config import JOURNAL, load_config
from c2m_tpu_torch.data.cityscapes import load_image, shift_frame_index
from c2m_tpu_torch.data.flow_io import write_flow
from c2m_tpu_torch.device import full_float32, resolve_device, to_host
from c2m_tpu_torch.models.flownet2 import compute_flow_and_conf
from c2m_tpu_torch.ops.hopper import all_kernels
from c2m_tpu_torch.train.flow_onthefly import OnTheFlyFlow


# The most frame pairs' pixels that one ``compute_flow_and_conf`` call
# takes: the published run of 3 clips, 30 pairs, at 128x256. FlowNet2's
# activations grow with pairs x H x W (the fusion net's 82-channel input
# at full resolution alone is 328 bytes a pixel), so a longer run or a
# larger frame goes through in chunks of pairs under it: at 512x1024 one
# pair a call.
PAIR_PIXELS_PER_CALL = 30 * 128 * 256


def pairs_per_call(h: int, w: int) -> int:
    """How many HxW frame pairs one ``compute_flow_and_conf`` call takes:
    as many as fit ``PAIR_PIXELS_PER_CALL``, and at least one."""
    return max(1, PAIR_PIXELS_PER_CALL // (h * w))


def clip_flows(model, frames, nif: int):
    """frames: the clip's T frames, each [1, H, W, 3] on the net's device ->
    [(i, kind, flow [H, W, 2], conf [H, W]) numpy] for i in 1..T-1, kind
    'bw' then 'fw'."""
    src = frames[nif - 1]
    out = []
    with torch.no_grad(), full_float32():
        for i in range(1, len(frames)):
            for kind, (a, b) in (("bw", (frames[i], src)),
                                 ("fw", (src, frames[i]))):
                flow, conf = compute_flow_and_conf(model, a, b)
                out.append((i, kind, flow[0].cpu().numpy(),
                            conf[0, ..., 0].cpu().numpy()))
    return out


def batch_flows(model, frames: np.ndarray, nif: int) -> Dict[str, np.ndarray]:
    """frames: a batch of clips, numpy [B, T, H, W, 3] in [0, 1] ->
    {'bw_of', 'fw_of': [B, T-1, H, W, 2], 'bw_occ', 'fw_occ': [B, T-1, H, W]}
    numpy float32. Entry i-1 of a clip is its frame i, for i in 1..T-1, with
    ``src`` the clip's frame ``nif - 1``: the backward flow and confidence
    of ``compute_flow_and_conf(frame_i, src)`` and the forward ones of
    ``(src, frame_i)``, each occlusion from its own pair (the trainer's
    ``OnTheFlyFlow`` crosses them). The batch's 2(T-1)B pairs go through
    ``compute_flow_and_conf`` without gradient, in full float32, in calls
    of ``pairs_per_call(H, W)`` pairs (one call for the published run of 3
    clips at 128x256). The outputs come back through ``device.to_host``:
    in page-locked host memory from the card, with one wait on the stream.

    Spans (``trace``): ``c2m.flow.request`` around the calls, inside it
    ``c2m.flow.h2d`` (the frames' upload), the model's
    ``c2m.flow.inference`` (one a call) and ``c2m.flow.output`` (the copies to the host,
    counting ``pinned_bytes`` and ``pageable_bytes``)."""
    device = next(model.parameters()).device
    with trace.span("c2m.flow.request"):
        with trace.span("c2m.flow.h2d"):
            video = torch.as_tensor(np.ascontiguousarray(frames, np.float32),
                                    device=device)
        b, t, h, w, _ = video.shape
        later = video[:, 1:]
        src = video[:, nif - 1:nif].expand_as(later)
        # pairs in (kind, clip, frame) order: backward, then forward
        im1 = torch.cat([later, src]).reshape(-1, h, w, 3)
        im2 = torch.cat([src, later]).reshape(-1, h, w, 3)
        n = pairs_per_call(h, w)
        with torch.no_grad(), full_float32():
            parts = [compute_flow_and_conf(model, im1[k:k + n], im2[k:k + n])
                     for k in range(0, len(im1), n)]
        flow, conf = (p[0] if len(p) == 1 else torch.cat(p)
                      for p in zip(*parts))
        with trace.span("c2m.flow.output"):
            host = to_host({"of": flow.reshape(2, b, t - 1, h, w, 2),
                            "occ": conf.reshape(2, b, t - 1, h, w)}, device)
    return {f"{kind}_{key}": host[key][k]
            for k, kind in enumerate(("bw", "fw")) for key in ("of", "occ")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=JOURNAL)
    ap.add_argument("--root", default=None, help="override dataset root")
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--weights", default=None,
                    help="converted FlowNet2 weights (.npz of "
                         "tools/convert_flownet2.py); random init otherwise "
                         "(the flows are then garbage)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.root:
        cfg.dataset_params.root = args.root
    dp = cfg.dataset_params
    pre = args.split
    root = dp.root
    size = cfg.train_params.input_size
    nif = cfg.train_params.num_input_frames
    t = cfg.train_params.num_frames

    with open(os.path.join(root, getattr(dp, f"{pre}_data_list"))) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    if args.limit:
        names = names[:args.limit]

    model = OnTheFlyFlow(nif, cfg.train_params.num_predicted_frames,
                         weights_path=args.weights, device=dev).model
    if args.weights:
        print(f"loaded weights from {args.weights}")
    else:
        print("WARNING: no weights given — flows are from a random-init net")

    images_root = os.path.join(root, getattr(dp, f"{pre}_images_path"))
    run = cfg.train_params.batch_size
    for first in range(0, len(names), run):
        clips = names[first:first + run]
        frames = np.stack([np.stack([load_image(
            os.path.join(images_root, shift_frame_index(name, i)), size)
            for i in range(t)]) for name in clips])
        out = batch_flows(model, frames, nif)
        for j, name in enumerate(clips):
            stem = name[:-15]
            for i in range(1, t):
                for kind in ("bw", "fw"):
                    of_dir = os.path.join(
                        root, getattr(dp, f"{pre}_{kind}_of_path"))
                    occ_dir = os.path.join(
                        root, getattr(dp, f"{pre}_{kind}_occ_path"))
                    of_path = os.path.join(of_dir, shift_frame_index(
                        stem + getattr(dp, f"{kind}_of_suffix"), i))
                    occ_path = os.path.join(occ_dir, shift_frame_index(
                        stem + getattr(dp, f"{kind}_occ_suffix"), i))
                    write_flow(of_path, out[f"{kind}_of"][j, i - 1])
                    os.makedirs(os.path.dirname(occ_path), exist_ok=True)
                    Image.fromarray((out[f"{kind}_occ"][j, i - 1] * 255)
                                    .astype(np.uint8)).save(occ_path)
            print(f"[{first + j + 1}/{len(names)}] {name}", flush=True)
    if dev.type == "cuda":
        print("kernel launches: " + json.dumps(
            {k.name: k.launches for k in all_kernels()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
