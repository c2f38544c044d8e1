"""Write a synthetic Cityscapes-layout dataset to disk: the port of
``tools/make_synthetic_dataset.py``.

The directory and file contract the loaders read (the journal config's
paths and suffixes): resized RGB frame sequences, ``*_ssmask.png``
semantic maps, ``*_gtFine_instanceIds.png`` 16-bit instance maps,
per-object trajectory txts, backward / forward ``.flow`` files with their
occlusion PNGs, and the data lists; ``--style kitti`` / ``mvtid`` name the
files as those loaders expect.

  python -m c2m_tpu_torch.tools.make_synthetic_dataset --root DIR
      [--clips 4] [--height 128] [--width 256] [--frames 6]
      [--splits train val] [--max-objects 8]
      [--style cityscapes|kitti|mvtid] [--dataset-type drone] [--device cpu]

Each clip is the port's ``data/synthetic.make_batch`` (the JAX package's
numpy scenes, draw for draw) at batch 1 and seed ``1000 * (split == val) +
clip``. Its flows and occlusions come from the port's rasterizer
(``ops/raster.generate_sparse_motion``), on the card unless ``--device cpu``
is given: one mask-warp kernel (K2) launch and two splat kernel (K4)
launches per clip, the forward flows from the same call as the backward
ones (the JAX tool rasterizes a second time for them). On the card the
tool ends with a line ``kernel launches: {json}``, every hand-written
kernel's launches in this process. Instance maps are written from a uint16
array (values checked to fit): the bytes the JAX tool's 32-bit ``I`` image
gives, without that mode, which Pillow deprecates.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image

from c2m_tpu_torch.config import Config, check
from c2m_tpu_torch.data.cityscapes import TRAJ_FULL_H, TRAJ_FULL_W
from c2m_tpu_torch.data.flow_io import write_flow
from c2m_tpu_torch.data.synthetic import make_batch
from c2m_tpu_torch.device import resolve_device
from c2m_tpu_torch.ops.hopper import all_kernels
from c2m_tpu_torch.tools import write_instance_png


def save_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def dataset_config(args) -> Config:
    cfg = Config()
    cfg.dataset_params.max_objects = args.max_objects
    cfg.train_params.input_size = [args.height, args.width]
    cfg.train_params.num_predicted_frames = \
        args.frames - cfg.train_params.num_input_frames
    # the forward flows are written whatever the config trains on, so that
    # use_fw_of configs read the same tree
    cfg.train_params.use_fw_of = True
    dp = cfg.dataset_params
    if args.style == "kitti":
        # KITTI names its maps and flows after the frame plus a suffix
        dp.segmask_suffix = "_ssmask.png"
        dp.instance_suffix = "_instanceIds.png"
        dp.bw_of_suffix = "_flow_backward.flow"
        dp.bw_occ_suffix = "_occlusion_bw.png"
        dp.fw_of_suffix = "_flow_forward.flow"
        dp.fw_occ_suffix = "_occlusion_fw.png"
    if args.style == "mvtid":
        dp.segmask_suffix = "gtFine_labelIds.png"
        dp.instance_suffix = "gtFine_instanceIds.png"
        dp.bw_of_suffix = "flow_backward.flow"
        dp.bw_occ_suffix = "occlusion_bw.png"
    return check(cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--clips", type=int, default=4)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--splits", nargs="+", default=["train", "val"])
    ap.add_argument("--max-objects", type=int, default=8)
    ap.add_argument("--style", default="cityscapes",
                    choices=["cityscapes", "kitti", "mvtid"],
                    help="on-disk naming: cityscapes 6-digit mid-name frame "
                         "indices; kitti 10-digit trailing indices; mvtid "
                         "name-list .jpg scenes")
    ap.add_argument("--dataset-type", default="drone",
                    help="mvtid only: the <dataset_type>/<split> path segment")
    ap.add_argument("--device", default=None,
                    help="torch device of the rasterizer (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataset_config(args)
    dp = cfg.dataset_params
    h, w = args.height, args.width

    for split in args.splits:
        pre = split
        names = []
        for ci in range(args.clips):
            batch = make_batch(cfg, batch_size=1,
                               seed=1000 * (split == "val") + ci, device=dev)
            city = "synthcity"
            base_frame = 19 + ci * 30
            if args.style == "kitti":
                scene = f"drive{ci:04d}"

                def stem_of(i, tail):
                    return (f"{scene}/{base_frame + i:010d}"
                            + (tail if tail.startswith(("_", ".")) else
                               "" if not tail else "_" + tail))
                first = f"{scene}/{base_frame:010d}.png"

                def img_name(i):
                    return f"{scene}/{base_frame + i:010d}.png"
            elif args.style == "mvtid":
                scene = f"scene{ci:04d}"

                def stem_of(i, tail):
                    return (f"{scene}/frame_{base_frame + i:04d}"
                            + ("_" + tail if tail else ""))
                first = f"{scene}/frame_{base_frame:04d}.jpg"

                def img_name(i):
                    return f"{scene}/frame_{base_frame + i:04d}.jpg"
            else:
                def stem_of(i, tail):
                    return f"{city}/{city}_{ci:06d}_{base_frame + i:06d}_{tail}"
                first = (f"{city}/{city}_{ci:06d}_{base_frame:06d}"
                         "_leftImg8bit.png")

                def img_name(i):
                    return stem_of(i, "leftImg8bit.png")
            names.append(first)

            def root_of(kind):
                base = os.path.join(args.root, getattr(dp, f"{pre}_{kind}_path"))
                if args.style == "mvtid":
                    # MVTID layout: <root>/<dataset_type>/<dir>/<split>
                    rel = os.path.relpath(base, args.root)
                    return os.path.join(args.root, args.dataset_type, rel,
                                        split)
                return base

            video = batch["video"][0]
            inst = batch["instance_mask"][0]
            bg = batch["bg_mask"][0]
            fg = batch["fg_mask"][0]
            for i in range(args.frames):
                rgb = (video[i] * 255).astype(np.uint8)
                save_png(os.path.join(root_of("images"), img_name(i)), rgb)
                # semantic trainId map from the one-hot channels
                seg = np.argmax(bg[i], axis=-1).astype(np.uint8)
                fg_any = fg[i].max(axis=-1) > 0
                seg[fg_any] = np.argmax(fg[i], axis=-1)[fg_any] + 11
                save_png(os.path.join(root_of("segmasks"),
                                      stem_of(i, dp.segmask_suffix)), seg)
                path = os.path.join(root_of("instances"),
                                    stem_of(i, dp.instance_suffix))
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_instance_png(path, inst[i, ..., 0].astype(np.int32))
                if i >= 1:
                    for kind in ("bw", "fw"):
                        write_flow(os.path.join(
                            root_of(f"{kind}_of"),
                            stem_of(i, getattr(dp, f"{kind}_of_suffix"))),
                            batch[f"target_{kind}_of"][0, i - 1])
                        occ = (batch[f"target_{kind}_occ"][0, i - 1, ..., 0]
                               * 255).astype(np.uint8)
                        save_png(os.path.join(
                            root_of(f"{kind}_occ"),
                            stem_of(i, getattr(dp, f"{kind}_occ_suffix"))), occ)

            # trajectory txts: per object, x,y,w,h,iid per frame in 2048x1024
            n_real = int(batch["num_real_nodes"][0])
            for ni in range(n_real):
                iid = int(batch["inst_ids"][0, ni])
                lines = []
                for i in range(args.frames):
                    mask = inst[i, ..., 0] == iid
                    if not mask.any():
                        lines = []
                        break
                    ys, xs = np.nonzero(mask)
                    x0, x1 = xs.min(), xs.max() + 1
                    y0, y1 = ys.min(), ys.max() + 1
                    lines.append(
                        f"{x0 / w * TRAJ_FULL_W},{y0 / h * TRAJ_FULL_H},"
                        f"{(x1 - x0) / w * TRAJ_FULL_W},"
                        f"{(y1 - y0) / h * TRAJ_FULL_H},{iid}")
                if lines:
                    tpath = os.path.join(root_of("tracking"),
                                         stem_of(0, f"{iid}.txt"))
                    os.makedirs(os.path.dirname(tpath), exist_ok=True)
                    with open(tpath, "w") as f:
                        f.write("\n".join(lines))

        listpath = os.path.join(args.root, getattr(dp, f"{pre}_data_list"))
        os.makedirs(os.path.dirname(listpath) or ".", exist_ok=True)
        with open(listpath, "w") as f:
            f.write("\n".join(names))
        print(f"[{split}] wrote {len(names)} clips under {args.root}",
              flush=True)
    if dev.type == "cuda":
        print("kernel launches: " + json.dumps(
            {k.name: k.launches for k in all_kernels()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
