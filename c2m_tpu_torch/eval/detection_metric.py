"""The port of ``c2m_tpu/eval/detection_metric.py``: the metric copied
(``tests/test_torch_evaluator.py`` holds the copy to the original) and
``make_yolo_detector`` over the port's YOLOv3 (``eval/yolov3.py``).

Detection-trajectory metric: "is the clicked object detected where the
click asked for it?"

Reference: src/utils/utils_yolov3.py:12-169 — run YOLOv3 on the last GT and
generated frames, match detections to the clicked object's target box
(>=50% overlap, utils_yolov3.py:12-28), and score the barycenter MSE of the
matched detection in the generated frame vs GT, normalized by the commanded
displacement; plus detection hit counts (F1/accuracy inputs).

The detector is a callable (images [B, H, W, 3] in [0,1]) ->
list per image of [x1, y1, x2, y2, conf, cls_conf, cls] arrays (or None).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from c2m_tpu_torch.device import full_float32, resolve_device


def _overlap(a, b) -> Optional[float]:
    """>=50%-of-a overlap test (utils_yolov3.py:12-28); boxes (y1,x1,y2,x2)."""
    height = float(a[2] - a[0] + 1)
    width = float(a[3] - a[1] + 1)
    dx = min(a[3], b[3]) - max(a[1], b[1])
    dy = min(a[2], b[2]) - max(a[0], b[0])
    if dx >= 0 and dy >= 0 and dx * dy > 0.5 * height * width:
        return dx * dy
    return None


def find_best_detection(target_box_yx, detections, h, w):
    """Largest-overlap detection covering the target box
    (utils_yolov3.py:31-49). target_box_yx: (y1, x1, y2, x2)."""
    best, best_area = None, -1.0
    for det in detections:
        x1, y1, x2, y2 = det[:4]
        if not np.all(np.array([x1, y1, x2, y2]) > 0):
            continue
        if (y2 - y1) * (x2 - x1) < h * w * 0.01:
            continue
        area = _overlap(target_box_yx, [y1, x1, y2, x2])
        if area is not None and area > best_area:
            best, best_area = det, area
    return best


def compute_detection(detector: Callable, gt_frames: np.ndarray,
                      gen_frames: np.ndarray, batch: Dict[str, np.ndarray],
                      click_idx: np.ndarray,
                      rois_target_last: np.ndarray) -> Dict[str, list]:
    """gt/gen_frames: [B, H, W, 3] last frames; click_idx: [B] node index;
    rois_target_last: [B, N, 4] (x1, y1, x2, y2) target-frame boxes."""
    b, h, w = gt_frames.shape[:3]
    det_gt = detector(gt_frames)
    det_gen = detector(gen_frames)
    mse, mse_norm, gt_hits, pred_hits = [], [], [], []
    for bi in range(b):
        ni = int(click_idx[bi])
        if not batch["node_mask"][bi, ni]:
            continue
        x1, y1, x2, y2 = rois_target_last[bi, ni]
        if (y2 - y1) * (x2 - x1) < 0.005 * w * h:
            continue
        target_yx = [y1, x1, y2, x2]
        gt_cy, gt_cx = (y1 + y2) / 2, (x1 + x2) / 2
        start_cy = (batch["nodes_x"][bi, ni, 0] + 1) / 2 * h
        start_cx = (batch["nodes_x"][bi, ni, 1] + 1) / 2 * w
        if det_gt[bi] is None:
            continue
        hit = find_best_detection(target_yx, det_gt[bi], h, w)
        if hit is None:
            continue
        gt_hits.append(1)
        if det_gen[bi] is None:
            continue
        pred = find_best_detection(target_yx, det_gen[bi], h, w)
        if pred is None:
            continue
        pred_hits.append(1)
        py = (pred[1] + pred[3]) / 2
        px = (pred[0] + pred[2]) / 2
        err = np.sqrt((py - gt_cy) ** 2 + (px - gt_cx) ** 2)
        norm = np.sqrt((start_cy - gt_cy) ** 2 + (start_cx - gt_cx) ** 2)
        norm = norm if norm > 0 else 1.0
        mse.append(float(err))
        mse_norm.append(float(err / (norm + 1e-6)))
    return {"mse": mse, "mse_normalized": mse_norm,
            "gt_detected": gt_hits, "pred_detected": pred_hits}


def pad_416(images: np.ndarray) -> np.ndarray:
    """YOLOv3's input as the reference makes it (utils_yolov3.py:80-86): a
    top-left copy of [B, H, W, 3] into 416x416 zeros, cropped at 416."""
    b, h, w = images.shape[:3]
    pad = np.zeros((b, 416, 416, 3), np.float32)
    pad[:, :min(h, 416), :min(w, 416)] = images[:, :416, :416]
    return pad


def make_yolo_detector(weights_path: Optional[str] = None,
                       conf_thresh: float = 0.5, nms_thresh: float = 0.4,
                       device=None) -> Optional[Callable]:
    """A detector callable from the port's YOLOv3 with the weights of
    ``weights_path`` (an npz of the JAX variables, or a darknet
    ``.weights``); None without a path. Each call pads its images to
    416x416 (:func:`pad_416`), runs the net on ``device`` (the card when
    None) in float32 with TF32 off, and applies NMS on the host."""
    if not weights_path:
        return None
    import torch
    from c2m_tpu_torch.eval.yolov3 import load_yolov3, non_max_suppression
    device = resolve_device(device)
    model = load_yolov3(weights_path, device)

    def detect(images: np.ndarray):
        x = torch.from_numpy(pad_416(images)).to(device)
        with torch.no_grad(), full_float32():
            preds = model(x).cpu().numpy()
        return [non_max_suppression(p, conf_thresh, nms_thresh) for p in preds]

    return detect
