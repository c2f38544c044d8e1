#!/usr/bin/env python3
"""Standalone YOLOv3 detection over an image folder with the PyTorch port
(counterpart of ``tools/yolo_detect.py``; reference
src/modules/networks/yolo_v3/detect.py).

  python3 yolo_detect_torch.py --image-folder samples/ --weights yolov3.weights \
      [--class-path coco.names] [--conf-thres 0.8] [--nms-thres 0.4] \
      [--img-size 416] [--out output] [--device cuda|cpu]

Same contract: pad each image to a square, resize it to ``--img-size``, run
the COCO YOLOv3 (``c2m_tpu_torch/eval/yolov3.py``), NMS, map the boxes back
to the original frame, and write per image under ``--out`` a
``<name>.txt`` with one ``cls conf x1 y1 x2 y2`` row per detection and a
``<name>.png`` with the boxes drawn. Weights: a darknet ``.weights`` binary
or an npz of the JAX YOLOv3 variables. Runs on the card unless ``--device
cpu`` is given; the net in float32 with TF32 off.
"""

import argparse
import glob
import os
import sys

import numpy as np
from PIL import Image, ImageDraw

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pad_to_square_resize(img: np.ndarray, size: int):
    """Zero-pad H/W to square (split evenly, reference datasets.py
    ``pad_to_square``), bilinear-resize to (size, size). Returns the image
    and the (pad_y, pad_x, square) geometry needed to invert the mapping."""
    h, w = img.shape[:2]
    s = max(h, w)
    py, px = (s - h) // 2, (s - w) // 2
    sq = np.zeros((s, s, 3), np.float32)
    sq[py:py + h, px:px + w] = img
    out = np.asarray(Image.fromarray(
        (sq * 255).astype(np.uint8)).resize((size, size), Image.BILINEAR),
        np.float32) / 255.0
    return out, (py, px, s)


def rescale_boxes(boxes: np.ndarray, geom, img_size: int) -> np.ndarray:
    """Map [x1,y1,x2,y2] from the padded-square model frame back to the
    original image (reference utils.py ``rescale_boxes``)."""
    py, px, s = geom
    scale = s / img_size
    out = boxes.copy()
    out[:, [0, 2]] = boxes[:, [0, 2]] * scale - px
    out[:, [1, 3]] = boxes[:, [1, 3]] * scale - py
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("c2m-tpu-torch yolo detect")
    ap.add_argument("--image-folder", required=True)
    ap.add_argument("--weights", required=True,
                    help=".weights darknet binary or converted .npz")
    ap.add_argument("--class-path", default=None,
                    help="one class name per line (COCO order)")
    ap.add_argument("--conf-thres", type=float, default=0.8)
    ap.add_argument("--nms-thres", type=float, default=0.4)
    ap.add_argument("--img-size", type=int, default=416)
    ap.add_argument("--out", default="output")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch
    from c2m_tpu_torch.device import full_float32, resolve_device
    from c2m_tpu_torch.eval.yolov3 import load_yolov3, non_max_suppression

    device = resolve_device(args.device)
    names = None
    if args.class_path:
        names = [ln.strip() for ln in open(args.class_path) if ln.strip()]
    model = load_yolov3(args.weights, device)
    os.makedirs(args.out, exist_ok=True)

    paths = sorted(p for p in glob.glob(os.path.join(args.image_folder, "*"))
                   if p.lower().endswith((".png", ".jpg", ".jpeg")))
    for path in paths:
        pil = Image.open(path).convert("RGB")
        img = np.asarray(pil, np.float32) / 255.0
        x, geom = pad_to_square_resize(img, args.img_size)
        with torch.no_grad(), full_float32():
            pred = model(torch.from_numpy(x[None]).to(device))[0]
        det = non_max_suppression(pred.cpu().numpy(), args.conf_thres,
                                  args.nms_thres)
        stem = os.path.splitext(os.path.basename(path))[0]
        draw = ImageDraw.Draw(pil)
        rows = []
        if det is not None and len(det):
            boxes = rescale_boxes(det[:, :4], geom, args.img_size)
            for (x1, y1, x2, y2), d in zip(boxes, det):
                conf, cls = float(d[4]), int(d[6])
                label = names[cls] if names and cls < len(names) else str(cls)
                rows.append(f"{label} {conf:.4f} "
                            f"{x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f}")
                draw.rectangle([x1, y1, x2, y2], outline=(255, 64, 64),
                               width=2)
                draw.text((x1 + 2, y1 + 2), f"{label} {conf:.2f}",
                          fill=(255, 64, 64))
        with open(os.path.join(args.out, stem + ".txt"), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        pil.save(os.path.join(args.out, stem + ".png"))
        print(f"{path}: {len(rows)} detections")
    return 0


if __name__ == "__main__":
    sys.exit(main())
