"""Cityscapes benchmark evaluation CLI: pixel-level semantic labeling
(IoU / iIoU) and instance-level segmentation (AP / AP50).

File conventions match cityscapesScripts (the evaluation tooling the
reference pip-installs, SURVEY.md 2.8): ground truth is found recursively
under --gt-dir as ``*_gtFine_labelIds.png`` (pixel mode, with
``*_gtFine_instanceIds.png`` siblings enabling the iIoU scores) or
``*_gtFine_instanceIds.png`` (instance mode); each gt file's prediction is
located in --pred-dir by its ``{city}_{seq}_{frame}`` stem, as upstream's
getPrediction does. Instance predictions are the upstream txt format — one
``relMaskPath labelID confidence`` line per predicted instance, mask paths
relative to the txt file, nonzero mask pixels = the instance
(evalInstanceLevelSemanticLabeling.py:15-29).

Usage:
  python -m c2m_tpu_torch.tools.evaluate_cityscapes pixel --gt-dir \
      gtFine/val --pred-dir results/ [--no-iiou] [--out results.json]
  python -m c2m_tpu_torch.tools.evaluate_cityscapes instance --gt-dir \
      gtFine/val --pred-dir results/ [--out results.json]

The port of ``tools/evaluate_cityscapes.py``; the scoring itself lives in
c2m_tpu_torch/eval/cityscapes_eval.py, the port's copy of the JAX
package's numpy evaluators.
"""

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
from PIL import Image

from c2m_tpu_torch.eval import cityscapes_eval as ce


def _stem(gt_path):
    """{city}_{seq}_{frame} prediction-search key of a gt file."""
    parts = gt_path.name.split("_")
    if len(parts) < 4:
        raise SystemExit(f"unexpected gt filename {gt_path.name}")
    return "_".join(parts[:3])


def _find_pred(pred_dir, stem, suffix):
    hits = sorted(pred_dir.rglob(f"{stem}*{suffix}"))
    if not hits:
        raise SystemExit(f"no {suffix} prediction for {stem} in {pred_dir}")
    if len(hits) > 1:
        raise SystemExit(f"ambiguous predictions for {stem}: {hits}")
    return hits[0]


def _load(path):
    return np.array(Image.open(path))


def _fmt(score):
    return "   nan" if math.isnan(score) else f"{score:6.4f}"


def run_pixel(args):
    gt_files = sorted(Path(args.gt_dir).rglob("*_gtFine_labelIds.png"))
    if not gt_files:
        raise SystemExit(f"no *_gtFine_labelIds.png under {args.gt_dir}")
    pred_dir = Path(args.pred_dir)
    pairs, inst_gts = [], []
    for gt_f in gt_files:
        pairs.append((_load(_find_pred(pred_dir, _stem(gt_f), ".png")),
                      _load(gt_f)))
        inst_f = gt_f.with_name(
            gt_f.name.replace("labelIds", "instanceIds"))
        if not args.no_iiou:
            if not inst_f.exists():
                raise SystemExit(
                    f"{inst_f} missing — rerun with --no-iiou to score "
                    f"IoU only")
            inst_gts.append(_load(inst_f))
    res = ce.evaluate_pixel_level(pairs, inst_gts if inst_gts else None)
    print(f"evaluated {len(pairs)} image pairs")
    print("classes:")
    for name, iou in res["classScores"].items():
        line = f"  {name:<16} IoU {_fmt(iou)}"
        if "classInstScores" in res and name in res["classInstScores"]:
            line += f"   iIoU {_fmt(res['classInstScores'][name])}"
        print(line)
    print("categories:")
    for name, iou in res["categoryScores"].items():
        line = f"  {name:<16} IoU {_fmt(iou)}"
        if "categoryInstScores" in res and name in res["categoryInstScores"]:
            line += f"   iIoU {_fmt(res['categoryInstScores'][name])}"
        print(line)
    print(f"mean IoU (classes)    {_fmt(res['averageScoreClasses'])}")
    print(f"mean IoU (categories) {_fmt(res['averageScoreCategories'])}")
    if "averageScoreInstClasses" in res:
        print(f"mean iIoU (classes)    "
              f"{_fmt(res['averageScoreInstClasses'])}")
        print(f"mean iIoU (categories) "
              f"{_fmt(res['averageScoreInstCategories'])}")
    return res


def run_instance(args):
    gt_files = sorted(Path(args.gt_dir).rglob("*_gtFine_instanceIds.png"))
    if not gt_files:
        raise SystemExit(f"no *_gtFine_instanceIds.png under {args.gt_dir}")
    pred_dir = Path(args.pred_dir)
    gts, preds = [], []
    for gt_f in gt_files:
        gts.append(_load(gt_f))
        txt = _find_pred(pred_dir, _stem(gt_f), ".txt")
        image_preds = []
        for ln in txt.read_text().splitlines():
            if not ln.strip():
                continue
            try:
                rel, label_id, conf = ln.split()
            except ValueError:
                raise SystemExit(f"bad prediction line in {txt}: {ln!r}")
            # Mask paths come from the txt: resolve relative to it but
            # refuse anything escaping the prediction root (absolute paths
            # or ..), matching upstream readPredInfo's containment check.
            mask_path = (txt.parent / rel).resolve()
            if not mask_path.is_relative_to(pred_dir.resolve()):
                raise SystemExit(
                    f"prediction mask path {rel!r} in {txt} resolves "
                    f"outside the prediction dir {pred_dir}")
            mask = np.array(Image.open(mask_path).convert("L"))
            image_preds.append({"mask": mask != 0,
                                "label_id": int(label_id),
                                "confidence": float(conf)})
        preds.append(image_preds)
    res = ce.evaluate_instance_level(gts, preds)
    print(f"evaluated {len(gts)} images")
    for name, s in res["classes"].items():
        print(f"  {name:<16} AP {_fmt(s['ap'])}   AP50 {_fmt(s['ap50%'])}")
    print(f"all AP   {_fmt(res['allAp'])}")
    print(f"all AP50 {_fmt(res['allAp50%'])}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("pixel", "instance"):
        p = sub.add_parser(mode)
        p.add_argument("--gt-dir", required=True)
        p.add_argument("--pred-dir", required=True)
        p.add_argument("--out", help="write full result JSON here")
        if mode == "pixel":
            p.add_argument("--no-iiou", action="store_true",
                           help="skip the instance-weighted scores")
    args = ap.parse_args(argv)
    res = run_pixel(args) if args.mode == "pixel" else run_instance(args)
    if args.out:
        res = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in res.items()}
        Path(args.out).write_text(json.dumps(res, indent=2))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
