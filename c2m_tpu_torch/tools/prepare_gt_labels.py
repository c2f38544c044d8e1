"""Cityscapes ground-truth preparation, polygon JSON -> label / instance
images: the port of ``tools/prepare_gt_labels.py``.

The reference workflow pip-installs cityscapesScripts, whose preparation
stage renders the ``*_gtFine_polygons.json`` annotations into the
``*_labelTrainIds.png`` / ``*_instanceTrainIds.png`` rasters; the JAX tool
carries that one capability, and this is its copy, with the port's label
table (``c2m_tpu_torch/data/labels.py``). Semantics, as there:

- cityscapesScripts/preparation/json2labelImg.py:50-110 (createLabelImage):
  polygons drawn in annotation order (later wins), background = the
  'unlabeled' value for the encoding, deleted objects skipped, unknown
  labels ending in 'group' retried without the suffix, negative ids skipped;
- json2instanceImg.py:84-155 (createInstanceImage): per-class instance
  counters; polygons of classes with instances get id*1000+counter unless
  the annotation was a 'group' label or the encoded id is the 255 ignore
  value;
- createTrainIdLabelImgs.py:38-67 / createTrainIdInstanceImgs.py:42-71:
  glob gtFine/<split>/<city>/*_gt*_polygons.json and write siblings with
  _polygons.json replaced by _labelTrainIds.png / _instanceTrainIds.png.

The instance image is drawn into a 32-bit ``I`` image as there, and written
from a uint16 array (values checked to fit): the same PNG bytes, without
saving an ``I`` image, which Pillow deprecates.

  python -m c2m_tpu_torch.tools.prepare_gt_labels CITYSCAPES_ROOT
      [--encoding ids|trainIds] [--kinds label instance] [--device cpu]

This tool draws polygons with PIL on the host and places nothing on a
device: ``--device`` accepts ``cpu`` alone, and refuses any other value.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
from PIL import Image, ImageDraw

from c2m_tpu_torch.data.labels import LABELS
from c2m_tpu_torch.tools import write_instance_png

NAME_TO_LABEL = {l.name: l for l in LABELS}
# cityscapesScripts' ignore trainId; also the background fill for trainIds
IGNORE = 255


def _encoded_id(label, encoding: str) -> int:
    if encoding == "ids":
        return label.id
    if encoding == "trainIds":
        return label.trainId
    raise ValueError(f"unknown encoding {encoding!r}")


def _resolve(label_name: str):
    """Label lookup with the 'group' suffix retry (json2labelImg.py:84-88).

    Returns (label, is_group); raises KeyError for genuinely unknown names.
    """
    if label_name in NAME_TO_LABEL:
        return NAME_TO_LABEL[label_name], False
    if label_name.endswith("group"):
        base = label_name[: -len("group")]
        if base in NAME_TO_LABEL:
            return NAME_TO_LABEL[base], True
    raise KeyError(f"Label '{label_name}' not known.")


def _iter_objects(ann: dict):
    for obj in ann.get("objects", []):
        if obj.get("deleted", 0):
            continue
        poly = [tuple(pt) for pt in obj["polygon"]]
        yield obj["label"], poly


def create_label_image(ann: dict, encoding: str = "trainIds") -> Image.Image:
    """Render the semantic label image (json2labelImg.py:50-110)."""
    size = (ann["imgWidth"], ann["imgHeight"])
    background = _encoded_id(NAME_TO_LABEL["unlabeled"], encoding)
    img = Image.new("L", size, background)
    drawer = ImageDraw.Draw(img)
    for name, polygon in _iter_objects(ann):
        label, _ = _resolve(name)
        # negative ids (e.g. license plate) are never drawn
        if label.id < 0:
            continue
        drawer.polygon(polygon, fill=_encoded_id(label, encoding))
    return img


def create_instance_image(ann: dict, encoding: str = "trainIds"
                          ) -> Image.Image:
    """Render the instance-id image (json2instanceImg.py:84-155).

    Thing polygons encode as class_id*1000 + per-class running counter;
    'group' polygons and ignore-class polygons keep the plain class id.
    """
    size = (ann["imgWidth"], ann["imgHeight"])
    background = _encoded_id(NAME_TO_LABEL["unlabeled"], encoding)
    img = Image.new("I", size, background)
    drawer = ImageDraw.Draw(img)
    counters = {l.name: 0 for l in LABELS if l.has_instances}
    for name, polygon in _iter_objects(ann):
        label, is_group = _resolve(name)
        val = _encoded_id(label, encoding)
        if label.has_instances and not is_group and val != IGNORE:
            val = val * 1000 + counters[label.name]
            counters[label.name] += 1
        if val < 0:
            continue
        drawer.polygon(polygon, fill=val)
    return img


def json_to_label_img(in_json: str, out_img: str,
                      encoding: str = "trainIds") -> None:
    with open(in_json) as f:
        ann = json.load(f)
    create_label_image(ann, encoding).save(out_img)


def json_to_instance_img(in_json: str, out_img: str,
                         encoding: str = "trainIds") -> None:
    with open(in_json) as f:
        ann = json.load(f)
    write_instance_png(out_img, np.array(create_instance_image(ann, encoding)))


def prepare(cityscapes_root: str, kinds=("label", "instance"),
            encoding: str = "trainIds", verbose: bool = True) -> int:
    """Batch driver over gtFine polygon jsons (createTrainIdLabelImgs.py:38-67).

    Returns the number of annotation files processed.
    """
    pattern = os.path.join(cityscapes_root, "gtFine", "*", "*",
                           "*_gt*_polygons.json")
    files = sorted(glob.glob(pattern))
    suffix = {"ids": "Ids", "trainIds": "TrainIds"}[encoding]
    for i, f in enumerate(files):
        if "label" in kinds:
            json_to_label_img(f, f.replace("_polygons.json",
                                           f"_label{suffix}.png"), encoding)
        if "instance" in kinds:
            json_to_instance_img(
                f, f.replace("_polygons.json", f"_instance{suffix}.png"),
                encoding)
        if verbose and (i + 1) % 50 == 0:
            print(f"  {i + 1}/{len(files)}", flush=True)
    return len(files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cityscapes_root",
                    help="dataset root containing gtFine/<split>/<city>/")
    ap.add_argument("--encoding", choices=["ids", "trainIds"],
                    default="trainIds")
    ap.add_argument("--kinds", nargs="+", choices=["label", "instance"],
                    default=["label", "instance"])
    ap.add_argument("--device", choices=["cpu"], default=None,
                    help="cpu or none: the tool places nothing on a device, "
                         "so any other value is refused")
    args = ap.parse_args(argv)
    n = prepare(args.cityscapes_root, tuple(args.kinds), args.encoding)
    print(f"processed {n} annotation files")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
