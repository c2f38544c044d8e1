"""The port's copy of ``c2m_tpu/eval/tracker_benchmark.py``, over the port's
region library (``c2m_tpu_torch/native``), held to the original by
``tests/test_torch_preprocess_tools.py``.

Tracker evaluation toolkit (OPE success/precision).

Reference: pysot/toolkit — VOT/OPE-style benchmarking built on the Cython
region library (SURVEY.md §2.7/2.8). Overlap comes from c2m_tpu_torch.native
(rect/polygon IoU); success = AUC of the IoU-threshold curve, precision =
fraction of frames whose center error is under 20 px.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from c2m_tpu_torch.native import rect_iou


def success_curve(pred_boxes: Sequence, gt_boxes: Sequence,
                  thresholds: np.ndarray = None) -> np.ndarray:
    thresholds = (np.arange(0, 1.05, 0.05) if thresholds is None
                  else thresholds)
    ious = np.array([rect_iou(p, g) for p, g in zip(pred_boxes, gt_boxes)])
    return np.array([(ious > t).mean() for t in thresholds])


def precision_curve(pred_boxes: Sequence, gt_boxes: Sequence,
                    thresholds: np.ndarray = None) -> np.ndarray:
    thresholds = np.arange(0, 51, 1) if thresholds is None else thresholds
    pred = np.asarray(pred_boxes, np.float64)
    gt = np.asarray(gt_boxes, np.float64)
    pc = pred[:, :2] + pred[:, 2:] / 2
    gc = gt[:, :2] + gt[:, 2:] / 2
    dist = np.linalg.norm(pc - gc, axis=1)
    return np.array([(dist <= t).mean() for t in thresholds])


def evaluate_tracker(tracker, videos: List[Dict]) -> Dict[str, float]:
    """OPE evaluation: init on frame 0's gt box, track the rest.

    videos: [{"frames": [np.ndarray...], "gt": [xywh...]}]
    Returns mean success AUC and precision@20px.
    """
    aucs, precs = [], []
    for video in videos:
        frames, gt = video["frames"], video["gt"]
        tracker.init(frames[0], gt[0])
        preds = [gt[0]]
        for f in frames[1:]:
            preds.append(tracker.track(f)["bbox"])
        sc = success_curve(preds, gt)
        pc = precision_curve(preds, gt)
        aucs.append(float(np.trapezoid(sc, dx=0.05) / 1.0))
        precs.append(float(pc[20]))
    return {"success_auc": float(np.mean(aucs)),
            "precision@20": float(np.mean(precs))}
