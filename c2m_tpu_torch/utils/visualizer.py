"""The port's copy of ``c2m_tpu/utils/visualizer.py``, held to the original by
``tests/test_torch_evaluator.py``.

Training/eval visualization & logging.

Reference: src/utils/visualizer.py — TensorBoard scalars, stdout loss lines,
``loss_log.txt``, GNN trajectory text logs, dominate-HTML galleries of the
visual streams, gif/png dumps. TensorBoard here is optional (gated import);
everything else is dependency-free.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
from PIL import Image

from c2m_tpu_torch.utils.flow_color import flow_video_to_color
from c2m_tpu_torch.utils.html import HTMLGallery


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def video_strip(video: np.ndarray) -> np.ndarray:
    """[T, H, W, C] -> one horizontal strip [H, T*W, 3] uint8."""
    if video.shape[-1] == 1:
        video = np.repeat(video, 3, axis=-1)
    return _to_uint8(np.concatenate(list(video), axis=1))


def save_gif(path: str, video: np.ndarray, fps: int = 3) -> None:
    frames = [Image.fromarray(_to_uint8(f if f.shape[-1] == 3
                                        else np.repeat(f, 3, -1)))
              for f in video]
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def visual_streams(batch: Dict[str, np.ndarray], out: Dict[str, np.ndarray],
                   sample: int = 0) -> Dict[str, np.ndarray]:
    """The reference's 17 visual streams (trainer/base.py:147-189), as
    [T, H, W, 3] uint8-able arrays for one batch element."""
    nif = batch["video"].shape[1] - out["generated"].shape[1]

    def flow(v):
        return flow_video_to_color(np.asarray(v)) / 255.0

    streams = {
        "source_frames": batch["video"][sample, :nif],
        "target_frames": batch["video"][sample, nif:],
        "predicted_frames": out["generated"][sample],
        "predicted_frames_sparse": out["generated_sparse"][sample],
        "predicted_frames_sparse_occ": out["generated_sparse_occ"][sample],
        "pred_dense_motion_bw": flow(out["dense_motion_bw"][sample]),
        "pred_occlusion_bw": out["occlusion_bw"][sample],
        "pred_sparse_motion_bw": flow(out["sparse_motion_bw"][sample]),
        "pred_sparse_occ_bw": out["sparse_occ_bw"][sample],
        "pred_sparse_motion_bin": out["sparse_motion_bin"][sample],
        "tracking_mask": batch.get("tracking_mask",
                                   np.zeros_like(batch["video"][..., :1]))[sample],
    }
    if "target_bw_of" in batch:
        streams["gt_target_bw_of"] = flow(batch["target_bw_of"][sample])
        streams["gt_target_bw_occ"] = batch["target_bw_occ"][sample]
    # fw streams when use_fw_of (the reference's full 17-stream set,
    # base.py:147-189)
    for key, src in (("pred_dense_motion_fw", out), ("pred_occlusion_fw", out),
                     ("pred_sparse_motion_fw", out), ("pred_sparse_occ_fw", out),
                     ("gt_target_fw_of", batch), ("gt_target_fw_occ", batch)):
        ref_key = key.replace("pred_", "").replace("gt_target", "target")
        ref_key = {"dense_motion_fw": "dense_motion_fw",
                   "occlusion_fw": "occlusion_fw",
                   "sparse_motion_fw": "sparse_motion_fw",
                   "sparse_occ_fw": "sparse_occ_fw",
                   "target_fw_of": "target_fw_of",
                   "target_fw_occ": "target_fw_occ"}[ref_key]
        if ref_key in src and src[ref_key] is not None:
            v = src[ref_key][sample]
            streams[key] = flow(v) if v.shape[-1] == 2 else v
    return streams


class Visualizer:
    """Loss logging + HTML gallery (reference visualizer.py:18-177)."""

    def __init__(self, job_dir: str, use_html: bool = True, tf_log: bool = False,
                 refresh: int = 1):
        self.job_dir = job_dir
        self.web_dir = os.path.join(job_dir, "web")
        self.log_path = os.path.join(job_dir, "loss_log.txt")
        self.traj_path = os.path.join(job_dir, "trajectory_log.txt")
        self.use_html = use_html
        os.makedirs(job_dir, exist_ok=True)
        if use_html:
            self.gallery = HTMLGallery(self.web_dir, title=job_dir, refresh=refresh)
        self.tb = None
        if tf_log:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(os.path.join(job_dir, "tb"))
            except Exception:
                self.tb = None

    def log_losses(self, epoch: int, it: int, losses: Dict[str, float],
                   t_per_iter: float) -> None:
        parts = " ".join(f"{k}: {float(v):.4f}" for k, v in sorted(losses.items()))
        line = f"(epoch: {epoch}, iters: {it}, time: {t_per_iter:.3f}) {parts}"
        print(line, flush=True)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")
        if self.tb is not None:
            for k, v in losses.items():
                self.tb.add_scalar(f"loss/{k}", float(v), it)

    def log_trajectories(self, epoch: int, it: int, thetas: np.ndarray,
                         targets: np.ndarray, node_mask: np.ndarray,
                         tag: str = "train") -> None:
        """GNN predicted-vs-GT theta text log (visualizer.py:134-177)."""
        with open(self.traj_path, "a") as f:
            f.write(f"[{tag}] epoch {epoch} iter {it}\n")
            b, n = node_mask.shape
            for bi in range(b):
                for ni in range(n):
                    if not node_mask[bi, ni]:
                        continue
                    f.write(f"  b{bi} n{ni} pred_dx={thetas[bi, ni, :, 2].round(4)}"
                            f" gt_dx={targets[bi, ni, :, 2].round(4)}\n")

    def display_results(self, batch, out, epoch: int, it: int,
                        max_samples: int = 1, tag: str = "train") -> None:
        if not self.use_html:
            return
        for s in range(min(max_samples, out["generated"].shape[0])):
            streams = visual_streams(batch, out, sample=s)
            ims, txts, links = [], [], []
            for name, vid in streams.items():
                fname = f"{tag}_e{epoch:04d}_i{it:07d}_s{s}_{name}.png"
                Image.fromarray(video_strip(np.asarray(vid))).save(
                    os.path.join(self.gallery.img_dir, fname))
                ims.append(fname)
                txts.append(name)
                links.append(fname)
            self.gallery.add_header(f"[{tag}] epoch {epoch}, iter {it}, "
                                    f"sample {s}")
            self.gallery.add_images(ims, txts, links)
        self.gallery.save()
