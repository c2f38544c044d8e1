"""The port's copy of ``c2m_tpu/data/cityscapes.py``, held to the original by
``tests/test_torch_data.py``.

Cityscapes / KITTI / MVTID clip datasets -> padded dense numpy samples.

Reference: src/datasets/{cityscapes.py, kitti.py, kitti_dataset.py, mvtid.py}.
A sample is a T-frame clip (1 input + Tp predicted): RGB frames, 11 bg + 9 fg
one-hot semantic channels, raw instance-id map, per-object trajectories
(-> node features + GT affine thetas), and precomputed backward (optionally
forward) flow + occlusion.

TPU-native differences:
- filenames: the reference shifts frame indices by slicing fixed character
  offsets per file kind (cityscapes.py:20-29); we parse the trailing
  ``_{frame:06d}_`` group with a regex — same arithmetic, no magic offsets.
- graphs: PyG ``Data`` with permutation edge lists -> fixed-size padded node
  arrays [N_max, ...] + validity mask (edges are implicit: fully connected).
- KITTI differs from Cityscapes only in path templates (SURVEY.md §2.2); the
  same class handles both via the name template. MVTID uses explicit
  name-list-driven frames (mvtid.py) — handled by the generic frame shifting
  since its names also end in ``_{frame}``-style indices.

Trajectory txts (trajectory_generation_scripts/generate_trajectory_*.py):
one file per tracked object, ``x,y,w,h,instance_id`` per frame in full-res
(2048x1024 Cityscapes) coordinates.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.data.flow_io import read_flow

# Full-res coordinate frame of the trajectory txts (cityscapes.py:109-115).
TRAJ_FULL_W = 2048
TRAJ_FULL_H = 1024

_FRAME_RE = re.compile(r"^(.*_)(\d{6})(_[^/]*)$")
_KITTI_FRAME_RE = re.compile(r"\d{10}")


def shift_frame_index(name: str, delta: int) -> str:
    """Shift the frame-index group of a filename by ``delta``.

    Cityscapes: the middle 6-digit group, aachen_000001_000019_leftImg8bit.png
    +2 -> ..._000021_... (reference slices fixed offsets, cityscapes.py:20-29).
    KITTI: the LAST 10-digit group, drive0001/0000000019.png +2 ->
    .../0000000021.png (reference slices [-14:-4] / [-29:-19],
    kitti.py:20-28, 239-246) — matching the last 10-digit run generalizes the
    same arithmetic to any suffix.
    """
    head, tail = os.path.split(name)
    m = _FRAME_RE.match(tail)
    if m:
        idx = int(m.group(2)) + delta
        return os.path.join(head, f"{m.group(1)}{idx:06d}{m.group(3)}")
    runs = list(_KITTI_FRAME_RE.finditer(tail))
    if runs:
        m = runs[-1]
        idx = int(m.group(0)) + delta
        return os.path.join(head, f"{tail[:m.start()]}{idx:010d}{tail[m.end():]}")
    raise ValueError(f"cannot parse frame index from {name!r}")


def _resize(img: Image.Image, size: Tuple[int, int], nearest: bool) -> Image.Image:
    return img.resize((size[1], size[0]),
                      Image.NEAREST if nearest else Image.BICUBIC)


def load_image(path: str, size) -> np.ndarray:
    img = _resize(Image.open(path).convert("RGB"), size, nearest=False)
    return np.asarray(img, np.float32) / 255.0


def load_seg(path: str, size) -> Tuple[np.ndarray, np.ndarray]:
    """-> (fg one-hot [H,W,9] classes 11..19, bg one-hot [H,W,11] classes 0..10)."""
    arr = np.asarray(_resize(Image.open(path), size, nearest=True))
    if arr.ndim == 3:
        arr = arr[..., 0]
    fg = np.stack([(arr == i) for i in range(11, 20)], axis=-1).astype(np.float32)
    bg = np.stack([(arr == i) for i in range(0, 11)], axis=-1).astype(np.float32)
    return fg, bg


def load_instance(path: str, size) -> np.ndarray:
    """Raw instance ids (class*1000 + idx), [H, W, 1] float32."""
    arr = np.asarray(_resize(Image.open(path), size, nearest=True))
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.float32)[..., None]


def load_occlusion(path: str, size) -> np.ndarray:
    arr = np.asarray(_resize(Image.open(path), size, nearest=True), np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = arr / 255.0 if arr.max() > 1.5 else arr
    return np.where(arr > 0.5, 1.0, 0.0).astype(np.float32)[..., None]


def _resize_bilinear_np(x: np.ndarray, size) -> np.ndarray:
    """numpy bilinear resize (torch align_corners=False semantics) — the
    loader must never touch the accelerator (host decode path)."""
    h, w = x.shape[:2]
    nh, nw = size

    def axis_weights(out_size, in_size):
        src = np.maximum((np.arange(out_size) + 0.5) * in_size / out_size - 0.5,
                         0.0)
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        hi = np.clip(lo + 1, 0, in_size - 1)
        return lo, hi, (src - lo).astype(x.dtype)

    ylo, yhi, wy = axis_weights(nh, h)
    xlo, xhi, wx = axis_weights(nw, w)
    rows = x[ylo] + (x[yhi] - x[ylo]) * wy[:, None, None]
    return rows[:, xlo] + (rows[:, xhi] - rows[:, xlo]) * wx[None, :, None]


def load_flow_resized(path: str, size) -> np.ndarray:
    """Flow resized to ``size``; values scaled by size[0]/h (the reference
    scales BOTH channels by the height ratio, cityscapes.py:216-227)."""
    flow = read_flow(path)
    h, w = flow.shape[:2]
    if (h, w) != tuple(size):
        flow = _resize_bilinear_np(flow, size) * (size[0] / h)
    return flow.astype(np.float32)


def load_scene_nodes(tracking_prefix: str, num_frames: int, size,
                     num_input_frames: int, n_max: int,
                     lambda_traj: float = 1.0) -> Dict[str, np.ndarray]:
    """Parse per-object trajectory txts into padded node tensors.

    Mirrors ``load_scene_info`` (cityscapes.py:79-193): node features
    [cy, cx (in -1..1), bh, bw, onehot19(class)], GT theta per predicted frame
    [sx, 0, dx, 0, sy, dy] from bbox scale + barycenter displacement, padded
    ROIs, instance ids; ``lambda_traj`` amplifies test-time x-displacement
    (cityscapes.py:124-140). Objects beyond n_max are dropped (ragged -> padded).
    """
    tpred = num_frames - num_input_frames
    nodes_x = np.zeros((n_max, 23), np.float32)
    thetas = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (n_max, tpred, 1))
    rois = np.zeros((n_max, 4), np.float32)
    rois_src = np.zeros((n_max, 4), np.float32)
    rois_target_last = np.zeros((n_max, 4), np.float32)
    inst_ids = np.zeros((n_max,), np.int32)
    track_ids = np.zeros((num_frames, n_max), np.int32)
    target_bary = np.zeros((n_max, tpred, 2), np.float32)
    node_mask = np.zeros((n_max,), bool)

    files = sorted(glob.glob(tracking_prefix + "*.txt"))
    n_real = 0
    for path in files:
        if n_real >= n_max:
            break
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()][:num_frames]
        if len(lines) < num_frames:
            continue
        ni = n_real
        src_bary = None
        src_size = None
        ok = True
        for idx, line in enumerate(lines):
            parts = line.split(",")
            x, y, w_box, h_box = (float(parts[0]), float(parts[1]),
                                  float(parts[2]), float(parts[3]))
            iid = int(float(parts[-1]))
            x_l = x / TRAJ_FULL_W * size[1]
            x_r = (x + w_box) / TRAJ_FULL_W * size[1]
            y_t = y / TRAJ_FULL_H * size[0]
            y_b = (y + h_box) / TRAJ_FULL_H * size[0]
            bbox = np.array([h_box / TRAJ_FULL_H, w_box / TRAJ_FULL_W])  # (y, x)

            if idx >= num_input_frames and lambda_traj > 1.0:
                # test-time displacement amplification (cityscapes.py:124-140)
                src_line = lines[num_input_frames - 1].split(",")
                xs_l = float(src_line[0]) / TRAJ_FULL_W * size[1]
                xs_r = (float(src_line[0]) + float(src_line[2])) / TRAJ_FULL_W * size[1]
                x_center_start = (xs_l + xs_r) / 2
                x_center = (x_l + x_r) / 2
                x_disp = (x_center - x_center_start) * lambda_traj
                x_l = x_l - (x_center - x_center_start) + x_disp
                x_r = x_r - (x_center - x_center_start) + x_disp

            cx = ((x_l + x_r) / 2) / size[1] * 2 - 1
            cy = ((y_t + y_b) / 2) / size[0] * 2 - 1
            if idx < num_input_frames:
                onehot = np.eye(19, dtype=np.float32)[iid // 1000]
                nodes_x[ni] = np.concatenate([[cy, cx, bbox[0], bbox[1]], onehot])
                rois_src[ni] = [x_l, y_t, x_r, y_b]
                rois[ni] = [max(x_l - 15, 0), max(y_t - 10, 0),
                            min(x_r + 15, size[1]), min(y_b + 10, size[0])]
                inst_ids[ni] = iid
                src_bary = np.array([cy, cx])
                src_size = bbox
            else:
                disp = src_bary - np.array([cy, cx])      # (dy, dx)
                with np.errstate(divide="ignore", invalid="ignore"):
                    scale = np.where(bbox > 0, src_size / bbox, 1.0)
                if not np.all(np.isfinite(scale)):
                    ok = False
                thetas[ni, idx - num_input_frames] = [
                    scale[1], 0.0, disp[1], 0.0, scale[0], disp[0]]
                target_bary[ni, idx - num_input_frames] = [cy, cx]
                rois_target_last[ni] = [x_l, y_t, x_r, y_b]
            track_ids[idx, ni] = iid
        if ok:
            node_mask[ni] = True
            n_real += 1
        else:
            nodes_x[ni] = 0
            track_ids[:, ni] = 0

    return {
        "nodes_x": nodes_x,
        "targets_theta": thetas,
        "rois_padded": rois,
        "rois_source": rois_src,
        "rois_target_last": rois_target_last,
        "inst_ids": inst_ids,
        "node_mask": node_mask,
        "num_real_nodes": np.int32(n_real),
        "track_ids": track_ids,
        "targets_barycenter": target_bary,
    }


class ClipDataset:
    """Filesystem-backed clip dataset with the reference's directory contract
    (config/c2m_journal_cityscapes.yaml:4-30, README.md:50-78)."""

    def __init__(self, cfg: Config, split: str = "train",
                 lambda_traj: Optional[float] = None):
        dp = cfg.dataset_params
        tp = cfg.train_params
        pre = "train" if split == "train" else "val"
        self.cfg = cfg
        self.split = split
        self.size = tuple(tp.input_size if split == "train"
                          else cfg.test_params.input_size)
        self.num_frames = tp.num_frames
        self.num_input_frames = tp.num_input_frames
        self.use_fw_of = tp.use_fw_of
        self.n_max = dp.max_objects
        self.lambda_traj = (lambda_traj if lambda_traj is not None else
                            (cfg.test_params.lambda_traj if split != "train" else 1.0))
        root = dp.root
        self.images_root = os.path.join(root, getattr(dp, f"{pre}_images_path"))
        self.segmask_root = os.path.join(root, getattr(dp, f"{pre}_segmasks_path"))
        self.instance_root = os.path.join(root, getattr(dp, f"{pre}_instances_path"))
        self.tracking_root = os.path.join(root, getattr(dp, f"{pre}_tracking_path"))
        self.bw_occ_root = os.path.join(root, getattr(dp, f"{pre}_bw_occ_path"))
        self.bw_of_root = os.path.join(root, getattr(dp, f"{pre}_bw_of_path"))
        self.fw_occ_root = os.path.join(root, getattr(dp, f"{pre}_fw_occ_path"))
        self.fw_of_root = os.path.join(root, getattr(dp, f"{pre}_fw_of_path"))
        self.segmask_suffix = dp.segmask_suffix
        self.instance_suffix = dp.instance_suffix
        self.bw_occ_suffix = dp.bw_occ_suffix
        self.bw_of_suffix = dp.bw_of_suffix
        self.fw_occ_suffix = dp.fw_occ_suffix
        self.fw_of_suffix = dp.fw_of_suffix
        datalist = os.path.join(root, getattr(dp, f"{pre}_data_list"))
        with open(datalist) as f:
            self.names = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.names)

    def _stem(self, name: str) -> str:
        """Cityscapes strips the 'leftImg8bit.png' tail (reference
        cityscapes name[0:-15]); KITTI-style names keep everything before the
        extension (kitti.py name[0:-4])."""
        if name.endswith("leftImg8bit.png"):
            return name[:-15]
        return name[: name.rfind(".")] if "." in name else name

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        stem = self._stem(name)
        t = self.num_frames
        size = self.size

        video = np.stack([load_image(
            os.path.join(self.images_root, shift_frame_index(name, i)), size)
            for i in range(t)])
        fg, bg = zip(*[load_seg(
            os.path.join(self.segmask_root,
                         shift_frame_index(stem + self.segmask_suffix, i)), size)
            for i in range(t)])
        instance = np.stack([load_instance(
            os.path.join(self.instance_root,
                         shift_frame_index(stem + self.instance_suffix, i)), size)
            for i in range(t)])

        nodes = load_scene_nodes(os.path.join(self.tracking_root, stem), t, size,
                                 self.num_input_frames, self.n_max,
                                 self.lambda_traj)
        track_ids = nodes.pop("track_ids")
        # tracking mask: union of tracked instances per frame (cityscapes.py:196-200)
        tracking_mask = np.stack([
            np.isin(instance[i, ..., 0], track_ids[i][track_ids[i] != 0])
            for i in range(t)]).astype(np.float32)[..., None]

        sample: Dict[str, np.ndarray] = {
            "video": video.astype(np.float32),
            "bg_mask": np.stack(bg),
            "fg_mask": np.stack(fg),
            "instance_mask": instance,
            "tracking_mask": tracking_mask,
            **nodes,
        }

        if self.cfg.train_params.use_pre_processed_of:
            bw_of, bw_occ, fw_of, fw_occ = [], [], [], []
            for i in range(1, t):
                bw_of.append(load_flow_resized(
                    os.path.join(self.bw_of_root,
                                 shift_frame_index(stem + self.bw_of_suffix, i)),
                    size))
                bw_occ.append(load_occlusion(
                    os.path.join(self.bw_occ_root,
                                 shift_frame_index(stem + self.bw_occ_suffix, i)),
                    size))
                if self.use_fw_of:
                    fw_of.append(load_flow_resized(
                        os.path.join(self.fw_of_root,
                                     shift_frame_index(stem + self.fw_of_suffix, i)),
                        size))
                    fw_occ.append(load_occlusion(
                        os.path.join(self.fw_occ_root,
                                     shift_frame_index(stem + self.fw_occ_suffix, i)),
                        size))
            sample["target_bw_of"] = np.stack(bw_of)
            sample["target_bw_occ"] = np.stack(bw_occ)
            if self.use_fw_of:
                sample["target_fw_of"] = np.stack(fw_of)
                sample["target_fw_occ"] = np.stack(fw_occ)

        sample["name"] = name  # carried outside the device batch
        return sample
