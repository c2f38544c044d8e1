"""Synthetic driving-scene clips without JAX: the port's own copy of the
numpy scene code of ``c2m_tpu/data/synthetic.py``.

Scenes: moving rectangles ("cars", thing-class ids) over a striped
background; GT thetas from the same bbox arithmetic as the real loader; the
target flows and occlusions are rasterized from those thetas by the port's
``generate_sparse_motion``, so the streams are mutually consistent. The
numpy random stream is the JAX package's, draw for draw
(``tests/test_torch_config.py`` compares the two batches key by key).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.device import resolve_device
from c2m_tpu_torch.ops.raster import generate_sparse_motion

THING_CLASS_MIN = 11  # cityscapes thing classes are trainIds 11..18


def make_batch(cfg: Config, batch_size: int = None, seed: int = 0,
               num_objects: int = None, device=None) -> Dict[str, np.ndarray]:
    """One batch of synthetic clips as numpy arrays (same arguments and the
    same numpy random stream as ``c2m_tpu.data.synthetic.make_batch``). The
    target flows are rasterized by the port on ``device``: the card when
    None (an error without one), ``"cpu"`` on request."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    tp = cfg.train_params
    h, w = tp.input_size
    t = tp.num_frames
    tpred = tp.num_predicted_frames
    nif = tp.num_input_frames
    n_max = cfg.dataset_params.max_objects
    b = batch_size or tp.batch_size

    video = np.zeros((b, t, h, w, 3), np.float32)
    bg_mask = np.zeros((b, t, h, w, 11), np.float32)
    fg_mask = np.zeros((b, t, h, w, 9), np.float32)
    instance = np.zeros((b, t, h, w, 1), np.float32)
    nodes_x = np.zeros((b, n_max, 23), np.float32)
    targets_theta = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32),
                            (b, n_max, tpred, 1))
    node_mask = np.zeros((b, n_max), bool)
    inst_ids = np.zeros((b, n_max), np.int32)
    rois = np.zeros((b, n_max, 4), np.float32)
    rois_target_last = np.zeros((b, n_max, 4), np.float32)
    num_real = np.zeros((b,), np.int32)

    # static background: horizontal stripes of bg classes (road/sky/etc)
    stripe = (np.arange(h) * 11 // h).astype(np.int32)
    for bi in range(b):
        for cls in range(11):
            bg_mask[bi, :, stripe == cls, :, cls] = 1.0
        video[bi] = (stripe[None, :, None, None] / 11.0) * 0.5 + 0.2
        video[bi, ..., 1] += 0.05  # slight channel variation

        n_obj = num_objects if num_objects is not None else rng.randint(1, min(4, n_max) + 1)
        num_real[bi] = n_obj
        for ni in range(n_obj):
            cls = rng.randint(THING_CLASS_MIN, 19)       # thing trainId 11..18
            iid = cls * 1000 + ni + 1
            bh = rng.randint(h // 8, h // 4)
            bw = rng.randint(w // 8, w // 4)
            y0 = rng.randint(0, h - bh - 1)
            x0 = rng.randint(0, w - bw - 1)
            vx = rng.randint(-w // 16, w // 16 + 1)      # pixels over the clip
            vy = rng.randint(-h // 16, h // 16 + 1)

            for ti in range(t):
                # object drifts linearly; clamp inside the frame
                dx = int(round(vx * ti / max(t - 1, 1)))
                dy = int(round(vy * ti / max(t - 1, 1)))
                yy0 = np.clip(y0 + dy, 0, h - bh - 1)
                xx0 = np.clip(x0 + dx, 0, w - bw - 1)
                instance[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, 0] = iid
                fg_mask[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, :] = 0
                fg_mask[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, cls - 11] = 1
                bg_mask[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, :] = 0
                video[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, :] = rng.rand(3) * 0.6 + 0.2

                if ti == nif - 1:
                    # node features at the last input frame (cityscapes.py:141-150)
                    cy = (yy0 + bh / 2) / h * 2 - 1
                    cx = (xx0 + bw / 2) / w * 2 - 1
                    onehot = np.eye(19)[cls]
                    nodes_x[bi, ni] = np.concatenate(
                        [[cy, cx, bh / h, bw / w], onehot])
                    inst_ids[bi, ni] = iid
                    rois[bi, ni] = [max(xx0 - 15, 0), max(yy0 - 10, 0),
                                    min(xx0 + bw + 15, w), min(yy0 + bh + 10, h)]
                    src_cy, src_cx = cy, cx
                if ti >= nif:
                    # GT theta: scale = src_size/size (==1 here), displacement
                    # = src_barycenter - barycenter (cityscapes.py:153-159)
                    cy = (yy0 + bh / 2) / h * 2 - 1
                    cx = (xx0 + bw / 2) / w * 2 - 1
                    targets_theta[bi, ni, ti - nif] = [
                        1.0, 0.0, src_cx - cx, 0.0, 1.0, src_cy - cy]
                    rois_target_last[bi, ni] = [xx0, yy0, xx0 + bw, yy0 + bh]
            node_mask[bi, ni] = True

    # consistent target flows: rasterize the GT thetas with the port's own
    # rasterizer (kernels K2 and K4 on the card, plain versions on the CPU)
    with torch.no_grad():
        sparse = generate_sparse_motion(
            torch.as_tensor(instance[:, nif - 1], device=device),
            torch.as_tensor(inst_ids, device=device),
            torch.as_tensor(node_mask, device=device),
            torch.as_tensor(targets_theta, device=device))
    target_bw_of = sparse["sparse_motion_bw"].cpu().numpy()
    target_bw_occ = sparse["sparse_occ_bw"].cpu().numpy()
    target_fw_of = sparse["sparse_motion_fw"].cpu().numpy()
    target_fw_occ = sparse["sparse_occ_fw"].cpu().numpy()

    batch = {
        "video": video,
        "bg_mask": bg_mask,
        "fg_mask": fg_mask,
        "instance_mask": instance,
        "target_bw_of": target_bw_of,
        "target_bw_occ": target_bw_occ,
        "nodes_x": nodes_x,
        "targets_theta": targets_theta,
        "node_mask": node_mask,
        "num_real_nodes": num_real,
        "inst_ids": inst_ids,
        "rois_padded": rois,
        "rois_target_last": rois_target_last,
    }
    if tp.use_fw_of:
        batch["target_fw_of"] = target_fw_of
        batch["target_fw_occ"] = target_fw_occ
    return batch
