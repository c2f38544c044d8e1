"""Bucketed, padded serving of ``C2MGenerator.inference`` (port of
``c2m_tpu/serving.py``'s ``ServingModel``).

Same contract as the JAX server: a request of batch b runs in the smallest
bucket >= b, zero-padded in and sliced out; a batch above the largest
bucket raises ValueError; ``outputs=`` selects the returned tensors
(KeyError on an unknown name); results come back as numpy on the host.

A model comes from a config plus JAX variables (nested, or the
'/'-flattened layout of an artifact's ``variables.npz``), from an artifact
directory (``variables.npz`` + ``meta.json`` + ``config.yaml``; the
``.stablehlo`` files are the JAX server's and are ignored), or as a built
``C2MGenerator``. Conv stacks run in ``train_params.dtype``. ``device=None``
means the card, and an error where there is none; ``"cpu"`` must be asked
for.

:func:`export_artifact` writes such a directory from a port model (the
counterpart of ``c2m_tpu/serving.export_artifact``): the generator's
weights in the JAX layout, so that either package serves them. It writes
no ``.stablehlo`` files, and its ``meta.json`` says so with
``"platforms": []``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from c2m_tpu_torch import trace
from c2m_tpu_torch.device import resolve_device, to_host
from c2m_tpu_torch.models.c2m import DTYPES, C2MGenerator
from c2m_tpu_torch.parallel import mesh
from c2m_tpu_torch.utils.convert import (flatten, from_jax_variables,
                                         to_jax_variables)

_FORMAT_VERSION = 1

# what ``C2MGenerator.inference`` reads of a request: the per-frame streams
# up to the last input frame, and the node arrays. The target frames, flows
# and occlusions of a request are never uploaded (0.6 GB per 512x1024 clip
# of 11 frames against 50 MB).
_FRAME_STREAMS = ("video", "bg_mask", "fg_mask", "instance_mask")
_TARGET_STREAMS = ("target_bw_of", "target_bw_occ", "target_fw_of",
                   "target_fw_occ")


def load_variables(path: str) -> Dict[str, np.ndarray]:
    """A serving artifact's ``variables.npz`` -> flat {'a/b/c': array}
    (bfloat16 leaves were stored as float32 and stay float32 here)."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files if k != "__dtypes__"}


def generator_variables(state_dict: Mapping[str, torch.Tensor], cfg) -> Dict:
    """A ``C2MTrainModel`` or ``C2MGenerator`` state_dict -> the JAX
    ``C2MGenerator`` tree ({'params', 'batch_stats'}, numpy float32): of a
    train model only the generator ``c2m``, as
    ``c2m_tpu.serving.generator_variables`` selects it (discriminators and
    VGG are not served)."""
    if any(k.startswith("c2m.") for k in state_dict):
        state_dict = {k[len("c2m."):]: v for k, v in state_dict.items()
                      if k.startswith("c2m.")}
    return to_jax_variables(state_dict, cfg)


def export_artifact(out_dir: str, cfg, model: torch.nn.Module,
                    batch_sizes: Sequence[int] = (1,)) -> None:
    """Write a serving artifact directory (``variables.npz``, ``meta.json``,
    ``config.yaml``; format version 1) from ``model``, a ``C2MTrainModel``
    or ``C2MGenerator``. ``ServingModel.from_artifact`` reads it back, and
    so does the JAX package's loader of ``variables.npz``. Under a
    process group rank 0 alone writes it."""
    import yaml
    if not mesh.is_main():
        return
    os.makedirs(out_dir, exist_ok=True)
    flat = flatten(generator_variables(model.state_dict(), cfg))
    # the JAX writer's layout: '/'-joined paths plus a JSON map of the
    # leaves stored as float32 in place of bfloat16 (none: parameters and
    # statistics are float32)
    np.savez(os.path.join(out_dir, "variables.npz"),
             __dtypes__=json.dumps({}), **flat)
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    meta = {
        "format_version": _FORMAT_VERSION,
        "batch_sizes": sorted(int(b) for b in batch_sizes),
        "platforms": [],
        "z_dim": z_dim(cfg),
        "max_objects": int(cfg.dataset_params.max_objects),
        "input_size": list(cfg.test_params.input_size),
        "num_predicted_frames": int(cfg.test_params.num_predicted_frames),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def z_dim(cfg) -> int:
    enc = cfg.model_params.motion_estimator.dense_motion_encoder
    return int(enc.out_channel_bg + enc.out_channel_fg)


class ServingModel:
    """Serves padded/bucketed inference from one ``C2MGenerator``.

    Every request returns fresh, writable numpy arrays. On the card they
    come back in page-locked host memory, which PyTorch's caching host
    allocator recycles once the caller drops them; on the CPU they are
    the model's output tensors as numpy."""

    def __init__(self, model: C2MGenerator, batch_sizes: Sequence[int] = (1,),
                 use_gt_eval: Optional[bool] = None):
        self.model = model.eval()
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self.batch_sizes = sorted(int(b) for b in batch_sizes)
        self.use_gt_eval = (self.cfg.test_params.use_gt_eval
                            if use_gt_eval is None else bool(use_gt_eval))

    @classmethod
    def from_variables(cls, cfg, variables: Mapping,
                       batch_sizes: Sequence[int] = (1,), device=None,
                       use_gt_eval: Optional[bool] = None) -> "ServingModel":
        """C2MGenerator(cfg) with the JAX ``variables`` (a ``C2MGenerator``
        tree), in eval mode on ``device`` (None: the card), conv stacks in
        ``train_params.dtype``."""
        device = resolve_device(device)
        model = C2MGenerator(cfg)
        model.load_state_dict(from_jax_variables(variables, cfg))
        model.to(device).use_compute_dtype(DTYPES[cfg.train_params.dtype])
        return cls(model, batch_sizes, use_gt_eval)

    @classmethod
    def from_artifact(cls, artifact_dir: str, device=None,
                      use_gt_eval: Optional[bool] = None) -> "ServingModel":
        from c2m_tpu_torch.config import load_config
        device = resolve_device(device)
        with open(os.path.join(artifact_dir, "meta.json")) as f:
            meta = json.load(f)
        if meta["format_version"] != _FORMAT_VERSION:
            raise ValueError(f"artifact format {meta['format_version']} != "
                             f"{_FORMAT_VERSION}")
        cfg = load_config(os.path.join(artifact_dir, "config.yaml"))
        variables = load_variables(os.path.join(artifact_dir, "variables.npz"))
        return cls.from_variables(cfg, variables, meta["batch_sizes"], device,
                                  use_gt_eval)

    def bucket_for(self, batch_size: int) -> int:
        for bs in self.batch_sizes:
            if bs >= batch_size:
                return bs
        raise ValueError(f"request batch {batch_size} exceeds largest bucket "
                         f"{self.batch_sizes[-1]}")

    @staticmethod
    def _pad_to(tree: Mapping, bucket: int, batch_size: int):
        if bucket == batch_size:
            return dict(tree)

        def pad(arr):
            arr = np.asarray(arr)
            return np.pad(arr, [(0, bucket - batch_size)]
                          + [(0, 0)] * (arr.ndim - 1))
        return {k: pad(v) for k, v in tree.items()}

    def __call__(self, batch: Mapping[str, np.ndarray], z_m, click, rng=None,
                 outputs: Optional[Sequence[str]] = None
                 ) -> Dict[str, np.ndarray]:
        """Run sampled inference on one request. ``rng`` is accepted for
        call compatibility with the JAX server; inference draws nothing.
        Spans (``trace``): ``c2m.serve.request`` around the call, inside it
        ``prepare``, ``h2d``, ``inference`` and ``output``; ``output``
        counts ``pinned_bytes`` and ``pageable_bytes`` returned."""
        with trace.span("c2m.serve.request"):
            with trace.span("c2m.serve.prepare"):
                bs = int(np.shape(next(iter(batch.values())))[0])
                bucket = self.bucket_for(bs)
                nif = self.cfg.train_params.num_input_frames
                arrays = {k: (np.asarray(v)[:, :nif] if k in _FRAME_STREAMS
                              else v)
                          for k, v in batch.items()
                          if k != "names" and k not in _TARGET_STREAMS}
                arrays["__z"] = np.asarray(z_m, np.float32)
                arrays["__click"] = np.asarray(click, np.float32)
                arrays = {k: np.ascontiguousarray(v) for k, v in
                          self._pad_to(arrays, bucket, bs).items()}
            with trace.span("c2m.serve.h2d"):
                dev = {k: torch.as_tensor(v, device=self.device)
                       for k, v in arrays.items()}
            z, ck = dev.pop("__z"), dev.pop("__click")
            with trace.span("c2m.serve.inference"), torch.inference_mode():
                out = self.model.inference(dev, z, ck, self.use_gt_eval)
            with trace.span("c2m.serve.output"):
                if outputs is not None:
                    missing = set(outputs) - set(out)
                    if missing:
                        raise KeyError(f"unknown outputs {sorted(missing)} "
                                       f"(available: {sorted(out)})")
                    out = {k: out[k] for k in outputs}
                out = {k: v[:bs].float() if v.is_floating_point()
                       else v[:bs] for k, v in out.items()}
                return to_host(out, self.device)
