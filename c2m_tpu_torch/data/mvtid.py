"""The port's copy of ``c2m_tpu/data/mvtid.py``, held to the original by
``tests/test_torch_data.py``.

MVTID (drone/infrastructure) dataset variant.

Reference: src/datasets/mvtid.py — unlike Cityscapes/KITTI, frames are
enumerated from per-scene sorted directory listings (name-list driven, .jpg)
instead of frame-index arithmetic, and every asset root gains a
``<dataset_type>/<split>`` path segment. Node/flow/seg handling is shared
with ClipDataset.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.data.cityscapes import (ClipDataset, load_image, load_instance,
                                     load_occlusion, load_flow_resized,
                                     load_scene_nodes, load_seg)


class MvtidDataset(ClipDataset):
    def __init__(self, cfg: Config, split: str = "train",
                 dataset_type: str = "drone", lambda_traj=None):
        super().__init__(cfg, split=split, lambda_traj=lambda_traj)
        self.dataset_type = dataset_type
        # re-root every asset dir with the dataset_type/split layout
        for attr in ("images_root", "segmask_root", "instance_root",
                     "tracking_root", "bw_occ_root", "bw_of_root",
                     "fw_occ_root", "fw_of_root"):
            base = getattr(self, attr)
            root = cfg.dataset_params.root
            rel = os.path.relpath(base, root)
            setattr(self, attr, os.path.join(root, dataset_type, rel, split))
        self._frame_lists = self._index_frames()

    def _index_frames(self) -> Dict[str, List[str]]:
        """first-frame name -> consecutive frame relpaths (mvtid.py:250-271)."""
        out = {}
        per_scene: Dict[str, List[str]] = {}
        for name in self.names:
            scene = os.path.dirname(name)
            if scene not in per_scene:
                scene_dir = os.path.join(self.images_root, scene)
                per_scene[scene] = sorted(
                    f for f in os.listdir(scene_dir) if f.endswith(".jpg"))
            frames = per_scene[scene]
            start = frames.index(os.path.basename(name))
            clip = frames[start:start + self.num_frames]
            if len(clip) == self.num_frames:
                out[name] = [os.path.join(scene, f) for f in clip]
        return out

    def _stem(self, name: str) -> str:
        return name[:-4]  # strip .jpg

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        frames = self._frame_lists[name]
        size = self.size
        t = self.num_frames

        video = np.stack([load_image(os.path.join(self.images_root, f), size)
                          for f in frames])
        fg, bg = zip(*[load_seg(
            os.path.join(self.segmask_root, f[:-4] + "_" + self.segmask_suffix),
            size) for f in frames])
        instance = np.stack([load_instance(
            os.path.join(self.instance_root,
                         f[:-4] + "_" + self.instance_suffix), size)
            for f in frames])

        nodes = load_scene_nodes(
            os.path.join(self.tracking_root, self._stem(name)), t, size,
            self.num_input_frames, self.n_max, self.lambda_traj)
        track_ids = nodes.pop("track_ids")
        tracking_mask = np.stack([
            np.isin(instance[i, ..., 0], track_ids[i][track_ids[i] != 0])
            for i in range(t)]).astype(np.float32)[..., None]

        sample = {
            "video": video.astype(np.float32),
            "bg_mask": np.stack(bg),
            "fg_mask": np.stack(fg),
            "instance_mask": instance,
            "tracking_mask": tracking_mask,
            **nodes,
        }
        if self.cfg.train_params.use_pre_processed_of:
            bw_of, bw_occ = [], []
            for f in frames[1:]:
                bw_of.append(load_flow_resized(
                    os.path.join(self.bw_of_root, f[:-4] + "_" + self.bw_of_suffix),
                    size))
                bw_occ.append(load_occlusion(
                    os.path.join(self.bw_occ_root,
                                 f[:-4] + "_" + self.bw_occ_suffix), size))
            sample["target_bw_of"] = np.stack(bw_of)
            sample["target_bw_occ"] = np.stack(bw_occ)
        sample["name"] = name
        return sample
