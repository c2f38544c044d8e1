"""Evaluator: sampled inference of a trained model over the val set, sample
dumps and metrics (port of ``c2m_tpu/eval/evaluator.py``; reference
src/evaluator/evaluator.py).

Per batch: ``inference`` with fresh z ~ N(0, 1) and clicks, both drawn from
a generator the caller passes, the clicks saved to or loaded from
``index_user_guidance_<batch>.npy`` in the JAX evaluator's format (int32
node indices [B]); gifs, pngs, flow and occlusion strips, and an HTML page
of the strips (which the JAX evaluator does not write); the FID / FVD
inputs (FVD's doubled by the time-flip concat, evaluator.py:275-282), the
GT-theta trajectory MSE and, with a detector, the detection-trajectory
metric; ``results.txt``.

The metric nets are built as the JAX evaluator builds them, from weights
files named by environment variables, whenever the caller passes no
callable of its own (``fid_embedder(images [N, H, W, 3]) -> [N, D]``,
``fvd_embedder(videos [N, T, H, W, 3]) -> [N, D]``, ``detector`` as in
``detection_metric``; a callable passed wins):

- ``INCEPTION_WEIGHTS``: an npz of ``tools/convert_inception.py`` ->
  InceptionV3 pool3 for FID (batches of 16, ``x * 2 - 1``, resized to
  299x299); without it torchvision's checkpoint in the local torch hub
  cache, if there (``fid.inception_embedder``; no download);
- ``I3D_WEIGHTS``: an npz of ``tools/convert_i3d.py`` -> I3D for FVD
  (batches of 16 videos, ``x * 2 - 1``, frames resized to 224x224,
  endpoint ``"embedding"``);
- ``YOLO_WEIGHTS``: an npz of the JAX YOLOv3 variables or a darknet
  ``.weights`` -> the detector of the detection metric
  (``detection_metric.make_yolo_detector``).

The nets run on the evaluator's device in eval mode and in float32 with
TF32 off inside their calls (restored after): a metric value is compared
across runs and papers, and the reference computes it in full float32.
Without a net FID / FVD read NaN and no detection metric is written, as
the JAX evaluator does without weights. ``metric_nets`` names what was
built; ``detector_frames`` counts the frames the detector was handed. The
detection F1 and accuracy are sklearn's ``f1_score`` /
``accuracy_score`` of the paired binary lists, computed here without
sklearn.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from c2m_tpu_torch.config import Config
from c2m_tpu_torch.eval import fid as fid_mod
from c2m_tpu_torch.eval.detection_metric import (compute_detection,
                                                 make_yolo_detector)
from c2m_tpu_torch.models.sparse_motion import sample_click_indices
from c2m_tpu_torch.parallel import mesh
from c2m_tpu_torch.serving import z_dim
from c2m_tpu_torch.train.trainer import device_batch, host_arrays
from c2m_tpu_torch.utils.flow_color import flow_video_to_color
from c2m_tpu_torch.utils.html import HTMLGallery
from c2m_tpu_torch.utils.visualizer import save_gif, video_strip


def binary_f1(gt: List[int], pred: List[int]) -> float:
    """sklearn ``f1_score(gt, pred)`` for {0, 1} labels (0.0 where it is
    undefined, as sklearn's default)."""
    g, p = np.asarray(gt) == 1, np.asarray(pred) == 1
    tp = int(np.sum(g & p))
    denom = 2 * tp + int(np.sum(~g & p)) + int(np.sum(g & ~p))
    return 2.0 * tp / denom if denom else 0.0


class Evaluator:
    def __init__(self, cfg: Config, model, job_dir: str,
                 detector: Optional[Callable] = None,
                 fid_embedder: Optional[Callable] = None,
                 fvd_embedder: Optional[Callable] = None):
        """``model``: a ``C2MTrainModel`` or ``C2MGenerator`` with its
        weights, on its device (None for the metrics alone)."""
        self.cfg = cfg
        self.model = model.eval() if model is not None else None
        self.device = (next(model.parameters()).device if model is not None
                       else torch.device("cpu"))
        self.job_dir = job_dir
        self.metric_nets: Dict[str, str] = {}
        if detector is None:
            path = os.environ.get("YOLO_WEIGHTS")
            detector = make_yolo_detector(path, device=self.device)
            if detector is not None:
                self.metric_nets["detector"] = f"YOLOv3 from {path}"
        self.detector = (None if detector is None
                         else self._counting(detector))
        self.detector_frames = 0
        self.fid_embedder = (fid_embedder if fid_embedder is not None
                             else self._fid_embedder())
        self.fvd_embedder = (fvd_embedder if fvd_embedder is not None
                             else self._fvd_embedder())
        self.out_dir = os.path.join(job_dir, "eval")
        os.makedirs(self.out_dir, exist_ok=True)
        self.gallery = HTMLGallery(os.path.join(self.out_dir, "web"),
                                   title="eval", refresh=0)
        self._real_frames: List[np.ndarray] = []
        self._fake_frames: List[np.ndarray] = []
        self._real_videos: List[np.ndarray] = []
        self._fake_videos: List[np.ndarray] = []
        self._traj_sq_err: List[float] = []
        self._det: Dict[str, list] = {"mse": [], "mse_normalized": [],
                                      "gt_detected": [], "pred_detected": []}

    # -- the metric nets ------------------------------------------------------

    def _counting(self, detector: Callable) -> Callable:
        """The detector, adding the frames each call is handed to
        ``detector_frames``."""
        def detect(images):
            self.detector_frames += len(images)
            return detector(images)
        return detect

    def _fid_embedder(self) -> Optional[Callable]:
        """InceptionV3 from ``INCEPTION_WEIGHTS``, else torchvision's
        weights in the local hub cache, else None."""
        from c2m_tpu_torch.eval.inception import load_inception
        path = os.environ.get("INCEPTION_WEIGHTS", "")
        if path and os.path.exists(path):
            self.metric_nets["fid"] = f"InceptionV3 from {path}"
            return fid_mod.embedder(load_inception(path, self.device),
                                    (299, 299))
        embed = fid_mod.inception_embedder(device=self.device)
        if embed is not None:
            self.metric_nets["fid"] = (
                f"InceptionV3 from {fid_mod.hub_inception_checkpoint()}")
        return embed

    def _fvd_embedder(self) -> Optional[Callable]:
        """I3D from ``I3D_WEIGHTS``, else None."""
        from c2m_tpu_torch.eval.i3d import load_i3d
        path = os.environ.get("I3D_WEIGHTS", "")
        if not (path and os.path.exists(path)):
            return None
        self.metric_nets["fvd"] = f"I3D from {path}"
        return fid_mod.embedder(load_i3d(path, self.device), (224, 224),
                                endpoint="embedding")

    # -- inference ----------------------------------------------------------

    def _guidance_path(self, idx: int) -> str:
        return os.path.join(self.out_dir, f"index_user_guidance_{idx:05d}.npy")

    def click_mask_for(self, batch, batch_idx: int,
                       generator: torch.Generator) -> torch.Tensor:
        """Load or sample per-clip click indices (evaluator.py:82-84,
        99-113) -> the click mask [B, N] on the model's device; rows of
        clips without real nodes are zero."""
        tcfg = self.cfg.test_params
        n_max = batch["node_mask"].shape[1]
        num_real = torch.as_tensor(np.asarray(batch["num_real_nodes"]))
        path = self._guidance_path(batch_idx)
        if tcfg.load_index_user_guidance and os.path.exists(path):
            idx = torch.from_numpy(np.load(path)).long()
        else:
            idx, _ = sample_click_indices(num_real, n_max, generator)
            if tcfg.save_index_user_guidance and mesh.is_main():
                np.save(path, idx.numpy().astype(np.int32))
        mask = torch.nn.functional.one_hot(idx, n_max).float()
        return (mask * (num_real > 0)[:, None].float()).to(self.device)

    def evaluate_batch(self, batch: Dict[str, np.ndarray], batch_idx: int,
                       generator: torch.Generator) -> Dict[str, np.ndarray]:
        """Sampled inference on one val batch (host arrays in, host arrays
        out); z first, then the clicks, from ``generator``. Conditioning by
        ``test_params.use_gt_eval`` (the reference builds its eval model
        from test_params, src/test.py:53-54)."""
        dev = device_batch(batch, self.device)
        b = dev["video"].shape[0]
        z = torch.randn(b, z_dim(self.cfg), generator=generator)
        click = self.click_mask_for(batch, batch_idx, generator)
        out = self.model.inference(dev, z.to(self.device), click,
                                   self.cfg.test_params.use_gt_eval)
        return host_arrays(out)

    # -- sample dumps (evaluator.py:185-224) ---------------------------------

    def save_samples(self, batch, out, batch_idx: int, max_samples: int = 2):
        """Gifs, pngs and a page of the first samples; rank 0 alone writes
        under a process group."""
        if not mesh.is_main():
            return
        from PIL import Image
        nif = self.cfg.train_params.num_input_frames
        for s in range(min(max_samples, out["generated"].shape[0])):
            tag = f"b{batch_idx:05d}_s{s}"
            gen = np.concatenate([batch["video"][s, :nif], out["generated"][s]])
            save_gif(os.path.join(self.out_dir, f"{tag}_gen.gif"), gen)
            save_gif(os.path.join(self.out_dir, f"{tag}_real.gif"),
                     batch["video"][s])
            Image.fromarray(video_strip(out["generated"][s])).save(
                os.path.join(self.out_dir, f"{tag}_gen.png"))
            Image.fromarray(video_strip(
                flow_video_to_color(out["dense_motion_bw"][s]) / 255.0)).save(
                os.path.join(self.out_dir, f"{tag}_flow.png"))
            Image.fromarray(video_strip(out["occlusion_bw"][s])).save(
                os.path.join(self.out_dir, f"{tag}_occ.png"))
            # the page lists the strips: they sit in out_dir, two levels
            # above the gallery's images/ directory that its links start in
            self.gallery.add_header(f"batch {batch_idx}, sample {s}")
            names = [f"{tag}_gen.png", f"{tag}_flow.png", f"{tag}_occ.png"]
            self.gallery.add_images([os.path.join("..", "..", n) for n in names],
                                    ["generated", "dense flow", "occlusion"],
                                    [os.path.join("..", "..", n) for n in names])
        self.gallery.save()

    # -- metric accumulation (evaluator.py:268-293) ---------------------------

    def fetch_metrics_data(self, batch, out):
        nif = self.cfg.train_params.num_input_frames
        real = batch["video"][:, nif:]
        fake = out["generated"]
        self._real_frames.append(real.reshape(-1, *real.shape[2:]))
        self._fake_frames.append(fake.reshape(-1, *fake.shape[2:]))
        # FVD inputs doubled by time-flip concat (evaluator.py:275-282)
        self._real_videos.append(np.concatenate([real, real[:, ::-1]], axis=0))
        self._fake_videos.append(np.concatenate([fake, fake[:, ::-1]], axis=0))
        # trajectory MSE of clicked-object barycenters via GT thetas vs
        # predicted thetas (always available; the detector-based variant
        # below additionally needs a detector)
        err = ((out["thetas"] - batch["targets_theta"]) ** 2)[..., [2, 5]]
        mask = batch["node_mask"][..., None, None]
        self._traj_sq_err.append(float((err * mask).sum()
                                       / max(mask.sum() * err.shape[-2] * 2, 1)))
        if self.detector is not None:
            click_idx = np.argmax(np.asarray(out["click_mask"]), axis=1)
            res = compute_detection(
                self.detector, np.asarray(real[:, -1]),
                np.asarray(fake[:, -1]), batch, click_idx,
                np.asarray(batch["rois_target_last"]))
            for k in self._det:
                self._det[k].extend(res[k])

    # -- final metrics (evaluator.py:295-325) ---------------------------------

    def generate_metrics(self) -> Dict[str, float]:
        results: Dict[str, float] = {}
        if self._traj_sq_err:
            results["trajectory_mse_theta"] = float(np.mean(self._traj_sq_err))
        if self.fid_embedder is not None and self._real_frames:
            real = np.concatenate(self._real_frames)
            fake = np.concatenate(self._fake_frames)
            results["fid"] = fid_mod.compute_fid(self.fid_embedder(real),
                                                 self.fid_embedder(fake))
        else:
            results["fid"] = float("nan")  # no InceptionV3 embedder
        if self.fvd_embedder is not None and self._real_videos:
            real = np.concatenate(self._real_videos)
            fake = np.concatenate(self._fake_videos)
            results["fvd"] = fid_mod.compute_fid(self.fvd_embedder(real),
                                                 self.fvd_embedder(fake))
        else:
            results["fvd"] = float("nan")  # no I3D embedder
        if self._det["gt_detected"]:
            # detection metrics over PAIRED per-object binary lists, exactly
            # as the reference (evaluator.py:295-298): pred misses are
            # zero-padded to gt length, then f1/accuracy.
            gt = list(self._det["gt_detected"])
            pred = list(self._det["pred_detected"])
            pred.extend([0] * (len(gt) - len(pred)))
            results["detection_f1"] = binary_f1(gt, pred)
            results["detection_accuracy"] = float(
                np.mean(np.asarray(gt) == np.asarray(pred)))
            results["gt_detection"] = float(sum(gt))
            results["pred_detection"] = float(sum(pred))
        if self._det["mse"]:
            # barycenter trajectory MSE of matched detections
            # (evaluator.py:318-321)
            results["detection_mse"] = float(np.mean(self._det["mse"]))
            results["detection_mse_normalized"] = float(
                np.mean(self._det["mse_normalized"]))
        return results

    def write_metrics(self, results: Dict[str, float]) -> str:
        """``results.txt`` (rank 0 alone writes it under a process group)."""
        path = os.path.join(self.out_dir, "results.txt")
        if not mesh.is_main():
            return path
        with open(path, "w") as f:
            for k, v in results.items():
                f.write(f"{k}: {v}\n")
        return path
