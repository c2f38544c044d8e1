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
passes them. A clip of T frames makes 2(T-1) calls, each one launch of
the FlowNetC correlation kernel and one of the confidence splat on the
card; on the card the tool ends with a line ``kernel launches: {json}``,
every hand-written kernel's launches in this process. The net runs in full
float32 (TF32 off), so the files are those of the float32 reference.

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

import numpy as np
import torch
from PIL import Image

from c2m_tpu_torch.config import JOURNAL, load_config
from c2m_tpu_torch.data.cityscapes import load_image, shift_frame_index
from c2m_tpu_torch.data.flow_io import write_flow
from c2m_tpu_torch.device import full_float32, resolve_device
from c2m_tpu_torch.models.flownet2 import compute_flow_and_conf
from c2m_tpu_torch.ops.hopper import all_kernels
from c2m_tpu_torch.train.flow_onthefly import OnTheFlyFlow


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
    for clip_i, name in enumerate(names):
        frames = [torch.from_numpy(load_image(
            os.path.join(images_root, shift_frame_index(name, i)), size)
        )[None].to(dev) for i in range(t)]
        stem = name[:-15]
        for i, kind, flow, conf in clip_flows(model, frames, nif):
            of_dir = os.path.join(root, getattr(dp, f"{pre}_{kind}_of_path"))
            occ_dir = os.path.join(root,
                                   getattr(dp, f"{pre}_{kind}_occ_path"))
            of_path = os.path.join(of_dir, shift_frame_index(
                stem + getattr(dp, f"{kind}_of_suffix"), i))
            occ_path = os.path.join(occ_dir, shift_frame_index(
                stem + getattr(dp, f"{kind}_occ_suffix"), i))
            write_flow(of_path, flow)
            os.makedirs(os.path.dirname(occ_path), exist_ok=True)
            Image.fromarray((conf * 255).astype(np.uint8)).save(occ_path)
        print(f"[{clip_i + 1}/{len(names)}] {name}", flush=True)
    if dev.type == "cuda":
        print("kernel launches: " + json.dumps(
            {k.name: k.launches for k in all_kernels()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
