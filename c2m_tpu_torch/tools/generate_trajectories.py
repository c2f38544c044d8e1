"""Object trajectories: instance extraction -> SiamRPN++ tracking ->
instance re-matching -> one trajectory txt per object; the port of
``tools/generate_trajectories.py``, whose host functions below are copied
as they stand (``tests/test_torch_preprocess_tools.py`` holds them to the
originals).

The reference's three-stage glue
(trajectory_generation_scripts/{generate_json,test,generate_trajectory}_
cityscapes.py) in one CLI with the same semantics:

- clips: consecutive 30-frame groups per city dir; the first 9 frames are
  the tracked window;
- objects: instance ids > 1000 in the first frame's
  ``*_gtFine_instanceIds.png``, rows from 800/1024 of the height down
  zeroed (the ego-vehicle hood);
- tracking: one SiamRPN++ tracker per object, all on one ``SiamRPNpp`` on
  the device; a track is dropped when best_score < 0.95 or the bbox
  degenerates;
- matching: per frame, the tracked bbox against the instance masks (class
  match, coverage >= 0.8, best by coverage then area); only full 9-frame
  tracks are kept;
- output: ``<out>/<city>/<stem>_<iid>.txt`` with ``x,y,w,h,iid`` per frame
  in full-resolution coordinates, what the training loader reads.

The net runs in full float32 (TF32 off): the anchor each frame picks is an
argmax, and the boxes are those of the float32 reference.

  python -m c2m_tpu_torch.tools.generate_trajectories --images-root <dir>
      --instance-root <dir> --out <dir> [--weights W] [--limit N]
      [--score-thresh S] [--cover-thresh C] [--device cpu]

``--weights``: the npz of ``tools/convert_siamrpn.py``, or pysot's torch
checkpoint itself (``.pth`` / ``.pt``), loaded strictly. Without it the
weights are PyTorch's default init from seed 0 and the tracks are noise
(``--score-thresh 0 --cover-thresh 0`` let such a smoke run keep them).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from c2m_tpu_torch.device import full_float32, resolve_device
from c2m_tpu_torch.models.siamrpn import SiamRPNpp, SiamRPNTracker
from c2m_tpu_torch.utils.convert import read_variables_npz, siamrpn_from_jax

CLIP_LEN = 30
TRACK_LEN = 9
SCORE_THRESH = 0.95
COVER_THRESH = 0.8
HOOD_ROW_FRAC = 800 / 1024  # rows below this fraction are zeroed


def list_clips(images_root):
    clips = []
    for city in sorted(os.listdir(images_root)):
        frames = sorted(os.listdir(os.path.join(images_root, city)))
        for j in range(len(frames) // CLIP_LEN):
            clip = [os.path.join(images_root, city, f)
                    for f in frames[j * CLIP_LEN:(j + 1) * CLIP_LEN]]
            clips.append((city, clip[:TRACK_LEN]))
    return clips


def instance_path(instance_root, city, image_path, instance_suffix):
    name = os.path.basename(image_path).replace("leftImg8bit.png",
                                                instance_suffix)
    return os.path.join(instance_root, city, name)


def extract_instances(inst_file):
    """[(mask, bbox(x,y,w,h), cls, iid)] from an instance map."""
    arr = np.array(Image.open(inst_file))
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = arr.copy()
    arr[int(arr.shape[0] * HOOD_ROW_FRAC):] = 0
    out = []
    for iid in np.unique(arr):
        if iid <= 1000:
            continue
        mask = (arr == iid).astype(np.float32)
        ys, xs = np.nonzero(mask)
        tx = xs.max() - xs.min()
        ty = ys.max() - ys.min()
        if tx > 0 and ty > 0:
            out.append((mask, [float(xs.min()), float(ys.min()),
                               float(tx), float(ty)], int(iid) // 1000,
                        int(iid)))
    return out


def bbox_covers(mask_src, bbox_tgt):
    h, w = mask_src.shape
    x, y, tw, th = bbox_tgt
    cover = np.zeros_like(mask_src)
    cover[max(int(y), 0):max(int(y + th), 0),
          max(int(x), 0):max(int(x + tw), 0)] = 1
    denom = mask_src.sum()
    return float((cover * mask_src).sum() / denom) if denom else 0.0


def match_instance(instances, bbox_tgt, cls_tgt, cover_thresh=COVER_THRESH):
    """generate_trajectory:153-181 — best coverage >= 0.8 with class match."""
    best_idx, best = -1, (cover_thresh, -1.0)
    for i, (mask, bbox, cls, _) in enumerate(instances):
        if cls != cls_tgt or not np.all(np.array(bbox[2:]) > 0):
            continue
        cov = bbox_covers(mask, bbox_tgt)
        if cov >= cover_thresh:
            area = cov * mask.sum()
            if (cov, area) > best:
                best, best_idx = (cov, area), i
    return best_idx


def track_clip(frames, inst_lists, make_tracker, score_thresh=SCORE_THRESH,
               cover_thresh=COVER_THRESH, track_len=TRACK_LEN):
    """Track every first-frame instance through the clip and re-match.

    The testable core of the reference's three-stage glue
    (trajectory_generation_scripts/test_cityscapes.py:99-105 +
    generate_trajectory_cityscapes.py:121-260):
    - a track dies when best_score < score_thresh or the bbox degenerates;
    - each tracked bbox is re-matched to the frame's instances (class match +
      coverage >= cover_thresh, best by (coverage, area)); the MATCHED
      instance bbox/iid is what gets written, not the raw tracker box;
    - only complete track_len-frame tracks are kept (9-frame rule).

    frames: list of HxWx3 uint8 arrays; inst_lists: per-frame
    ``extract_instances`` output; make_tracker: (frame, bbox) -> object with
    ``.track(frame) -> {"best_score", "bbox"}``.
    Returns {iid: [row_str, ...]} with "x,y,w,h,iid" rows.
    """
    tracks = {}
    for mask, bbox, cls, iid in inst_lists[0]:
        tracker = make_tracker(frames[0], bbox)
        boxes = [bbox]
        ok = True
        for f in range(1, track_len):
            out = tracker.track(frames[f])
            if out["best_score"] < score_thresh or \
                    np.all(np.array(out["bbox"]) <= 0):
                ok = False
                break
            boxes.append(out["bbox"])
        if not ok:
            continue
        rows = [f"{','.join(f'{v}' for v in bbox)},{iid}"]
        for f in range(1, track_len):
            idx = match_instance(inst_lists[f], boxes[f], cls, cover_thresh)
            if idx < 0:
                ok = False
                break
            m_bbox = inst_lists[f][idx][1]
            m_iid = inst_lists[f][idx][3]
            rows.append(f"{','.join(f'{v}' for v in m_bbox)},{m_iid}")
        if ok and len(rows) == track_len:
            tracks[iid] = rows
    return tracks


def load_state(path: str):
    """A weights file -> the port's ``SiamRPNpp`` state_dict: the JAX
    converter's npz through the bridge, or pysot's checkpoint as it is."""
    if path.endswith(".npz"):
        return siamrpn_from_jax(read_variables_npz(path))
    ckpt = torch.load(path, map_location="cpu")
    return ckpt.get("state_dict", ckpt)


def build_model(weights, device) -> SiamRPNpp:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SiamRPNpp()
    if weights:
        model.load_state_dict(load_state(weights), strict=True)
    return model.to(device).eval()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images-root", required=True,
                    help="full-res leftImg8bit sequence dir (one subdir per "
                         "city)")
    ap.add_argument("--instance-root", required=True)
    ap.add_argument("--instance-suffix", default="gtFine_instanceIds.png")
    ap.add_argument("--out", required=True, help="tracking txt output root")
    ap.add_argument("--weights", default=None,
                    help="npz of tools/convert_siamrpn.py or pysot's "
                         "checkpoint")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--score-thresh", type=float, default=SCORE_THRESH,
                    help="track-kill threshold (reference 0.95, "
                         "test_cityscapes.py:99-105); relax only for "
                         "random-init smoke runs")
    ap.add_argument("--cover-thresh", type=float, default=COVER_THRESH,
                    help="instance-matching coverage (reference 0.8, "
                         "generate_trajectory_cityscapes.py:153-181)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    model = build_model(args.weights, resolve_device(args.device))
    if not args.weights:
        print("WARNING: random-init tracker — convert pysot weights for real "
              "use")

    clips = list_clips(args.images_root)
    if args.limit:
        clips = clips[:args.limit]
    kept = 0
    for ci, (city, clip) in enumerate(clips):
        inst_lists = [extract_instances(
            instance_path(args.instance_root, city, p, args.instance_suffix))
            for p in clip]
        frames = [np.array(Image.open(p).convert("RGB")) for p in clip]
        stem = os.path.basename(clip[0])[:-16]  # strip _leftImg8bit.png

        def make_tracker(frame0, bbox):
            tracker = SiamRPNTracker(model)
            tracker.init(frame0, bbox)
            return tracker

        with full_float32():
            tracks = track_clip(frames, inst_lists, make_tracker,
                                score_thresh=args.score_thresh,
                                cover_thresh=args.cover_thresh)
        for iid, rows in tracks.items():
            out_dir = os.path.join(args.out, city)
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{stem}_{iid}.txt"), "w") as fh:
                fh.write("\n".join(rows))
            kept += 1
        print(f"[{ci + 1}/{len(clips)}] {stem}: kept so far {kept}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
