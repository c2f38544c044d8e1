"""Semantic and instance maps with Panoptic-DeepLab (HRNet-48): the port of
``tools/generate_segmentation.py``.

Reference: panoptic_deeplab/tools/generate_segmentation.py:133-306. For
every ``*leftImg8bit.png`` under ``--images-root`` it writes, under the
same relative path, a uint8 ``*_ssmask.png`` semantic trainId map into
``--out-semantic`` and a ``*_gtFine_instanceIds.png`` instance map (thing
classes 11..18 as ``trainId * 1000 + k``; 16-bit grayscale, as the JAX
tool's 32-bit map is stored) into ``--out-instance``.
Each frame is resized (PIL bicubic, with ``--size H W``), normalized with
the ImageNet mean and deviation and run alone; ``postprocess`` runs on the
net's device.

The net runs in full float32 (TF32 off): the maps are decisions (an
argmax over 19 classes, centers above a threshold, the nearest center of
each vote), and TF32's 10-bit mantissas move some of them against the
float32 reference; ``chip_smoke.py`` phase 16 prints the share of semantic
pixels that change.

  python -m c2m_tpu_torch.tools.generate_segmentation --images-root <dir>
      --out-semantic <dir> --out-instance <dir> [--weights W]
      [--size 1024 2048] [--limit N] [--device cpu]

``--weights``: the npz of ``tools/convert_panoptic.py`` (``params`` and
``batch_stats``), or the torch checkpoint itself (``.pth`` / ``.pt``, a
``state_dict`` entry or the dict itself), loaded strictly. Without it the
weights are PyTorch's default init from seed 0 and the maps are noise.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from c2m_tpu_torch.device import full_float32, resolve_device
from c2m_tpu_torch.models.panoptic_deeplab import PanopticDeepLab, postprocess
from c2m_tpu_torch.tools import write_instance_png
from c2m_tpu_torch.utils.convert import panoptic_from_jax, read_variables_npz

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_state(path: str):
    """A weights file -> the port's ``PanopticDeepLab`` state_dict: the JAX
    converter's npz through the bridge, or a torch checkpoint as it is
    (a ``module.`` prefix of DataParallel is dropped)."""
    if path.endswith(".npz"):
        return panoptic_from_jax(read_variables_npz(path))
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def build_model(weights: Optional[str], device) -> PanopticDeepLab:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = PanopticDeepLab()
    if weights:
        model.load_state_dict(load_state(weights), strict=True)
    return model.to(device).eval()


def frame_paths(images_root: str, limit: Optional[int] = None):
    paths = []
    for root, _, files in os.walk(images_root):
        for f in sorted(files):
            if f.endswith("leftImg8bit.png"):
                paths.append(os.path.join(root, f))
    return paths[:limit] if limit else paths


def segment(model: PanopticDeepLab, path: str, size=None):
    """One frame -> (semantic, instance) int32 numpy maps."""
    img = Image.open(path).convert("RGB")
    if size:
        img = img.resize((size[1], size[0]), Image.BICUBIC)
    x = (np.asarray(img, np.float32) / 255.0 - MEAN) / STD
    dev = next(model.parameters()).device
    with torch.no_grad(), full_float32():
        out = model(torch.from_numpy(x)[None].to(dev))
        sem, inst = postprocess(out["semantic"][0], out["center"][0],
                                out["offset"][0])
    return sem.cpu().numpy(), inst.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images-root", required=True)
    ap.add_argument("--out-semantic", required=True)
    ap.add_argument("--out-instance", required=True)
    ap.add_argument("--weights", default=None,
                    help="npz of tools/convert_panoptic.py or the torch "
                         "checkpoint; random init produces garbage maps")
    ap.add_argument("--size", type=int, nargs=2, default=None,
                    help="resize input to H W before inference")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build_model(args.weights, dev)
    if not args.weights:
        print("WARNING: random-init segmenter — convert weights for real use")

    paths = frame_paths(args.images_root, args.limit)
    for i, path in enumerate(paths):
        sem, inst = segment(model, path, args.size)
        rel = os.path.relpath(path, args.images_root)
        sem_path = os.path.join(args.out_semantic,
                                rel.replace("leftImg8bit.png", "ssmask.png"))
        inst_path = os.path.join(args.out_instance,
                                 rel.replace("leftImg8bit.png",
                                             "gtFine_instanceIds.png"))
        os.makedirs(os.path.dirname(sem_path), exist_ok=True)
        os.makedirs(os.path.dirname(inst_path), exist_ok=True)
        Image.fromarray(sem.astype(np.uint8)).save(sem_path)
        write_instance_png(inst_path, inst)
        print(f"[{i + 1}/{len(paths)}] {rel}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
