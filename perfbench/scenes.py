"""The benchmark's scene generator: a frozen copy of
``c2m_tpu_torch/data/synthetic.make_batch`` at commit ef9a2dc.

Moving rectangles ("cars", thing-class ids) over a striped background; GT
thetas from the loader's bbox arithmetic. Three departures from the copy:

- the number of objects of each clip is given (the traffic draws it), not
  drawn here;
- ``frames`` limits the frames whose pixels are written (a served clip
  uploads its input frames only); positions and thetas are those of the
  whole clip either way;
- the target flows and occlusions are rasterized from the GT thetas by the
  plain reference rasterizer (``perfbench.reference.ops.raster``), never by
  the port's kernels, and only when ``with_targets``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

THING_CLASS_MIN = 11  # cityscapes thing classes are trainIds 11..18


def make_clips(cfg, objects: Sequence[int], seed: int,
               frames: Optional[int] = None, with_targets: bool = True,
               device="cpu") -> Dict[str, np.ndarray]:
    """len(objects) clips, clip i with objects[i] real nodes, as numpy
    arrays (the layout of ``make_batch``). ``cfg`` is a reference config
    (``perfbench.reference.config``)."""
    rng = np.random.RandomState(seed)
    tp = cfg.train_params
    h, w = tp.input_size
    t = tp.num_frames
    tpred = tp.num_predicted_frames
    nif = tp.num_input_frames
    n_max = cfg.dataset_params.max_objects
    b = len(objects)
    tf = t if frames is None else frames

    video = np.zeros((b, tf, h, w, 3), np.float32)
    bg_mask = np.zeros((b, tf, h, w, 11), np.float32)
    fg_mask = np.zeros((b, tf, h, w, 9), np.float32)
    instance = np.zeros((b, tf, h, w, 1), np.float32)
    inst_src = np.zeros((b, h, w, 1), np.float32)
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

        n_obj = int(objects[bi])
        if not 1 <= n_obj <= n_max:
            raise ValueError(f"{n_obj} objects in a clip of at most {n_max}")
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
                colour = rng.rand(3) * 0.6 + 0.2
                if ti < tf:
                    instance[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, 0] = iid
                    fg_mask[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, :] = 0
                    fg_mask[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, cls - 11] = 1
                    bg_mask[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, :] = 0
                    video[bi, ti, yy0:yy0 + bh, xx0:xx0 + bw, :] = colour

                if ti == nif - 1:
                    inst_src[bi, yy0:yy0 + bh, xx0:xx0 + bw, 0] = iid
                    # node features at the last input frame
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
                    # GT theta: scale 1, displacement = source barycenter -
                    # barycenter
                    cy = (yy0 + bh / 2) / h * 2 - 1
                    cx = (xx0 + bw / 2) / w * 2 - 1
                    targets_theta[bi, ni, ti - nif] = [
                        1.0, 0.0, src_cx - cx, 0.0, 1.0, src_cy - cy]
                    rois_target_last[bi, ni] = [xx0, yy0, xx0 + bw, yy0 + bh]
            node_mask[bi, ni] = True

    batch = {
        "video": video,
        "bg_mask": bg_mask,
        "fg_mask": fg_mask,
        "instance_mask": instance,
        "nodes_x": nodes_x,
        "targets_theta": targets_theta,
        "node_mask": node_mask,
        "num_real_nodes": num_real,
        "inst_ids": inst_ids,
        "rois_padded": rois,
        "rois_target_last": rois_target_last,
    }
    if with_targets:
        from perfbench.reference.ops.raster import generate_sparse_motion
        with torch.no_grad():
            sparse = generate_sparse_motion(
                torch.as_tensor(inst_src, device=device),
                torch.as_tensor(inst_ids, device=device),
                torch.as_tensor(node_mask, device=device),
                torch.as_tensor(targets_theta, device=device))
        batch["target_bw_of"] = sparse["sparse_motion_bw"].cpu().numpy()
        batch["target_bw_occ"] = sparse["sparse_occ_bw"].cpu().numpy()
        if tp.use_fw_of:
            batch["target_fw_of"] = sparse["sparse_motion_fw"].cpu().numpy()
            batch["target_fw_occ"] = sparse["sparse_occ_fw"].cpu().numpy()
    return batch


def stratified(rng: np.random.RandomState, low: int, high: int,
               count: int) -> np.ndarray:
    """``count`` whole numbers in [low, high], each value as often as the
    count allows (cycles of the whole range, the last one cut), in an order
    drawn from ``rng``: a uniform mix whose make-up every seed shares."""
    span = np.arange(low, high + 1)
    reps = -(-count // len(span))
    values = np.concatenate([rng.permutation(span) for _ in range(reps)])
    return values[:count]
