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
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from c2m_tpu_torch.device import resolve_device
from c2m_tpu_torch.models.c2m import DTYPES, C2MGenerator
from c2m_tpu_torch.utils.convert import from_jax_variables

_FORMAT_VERSION = 1


def load_variables(path: str) -> Dict[str, np.ndarray]:
    """A serving artifact's ``variables.npz`` -> flat {'a/b/c': array}
    (bfloat16 leaves were stored as float32 and stay float32 here)."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files if k != "__dtypes__"}


def z_dim(cfg) -> int:
    enc = cfg.model_params.motion_estimator.dense_motion_encoder
    return int(enc.out_channel_bg + enc.out_channel_fg)


class ServingModel:
    """Serves padded/bucketed inference from one ``C2MGenerator``."""

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
        model.to(device).set_compute_dtype(DTYPES[cfg.train_params.dtype])
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
        call compatibility with the JAX server; inference draws nothing."""
        bs = int(np.shape(next(iter(batch.values())))[0])
        bucket = self.bucket_for(bs)
        arrays = {k: v for k, v in batch.items() if k != "names"}
        arrays["__z"] = np.asarray(z_m, np.float32)
        arrays["__click"] = np.asarray(click, np.float32)
        arrays = self._pad_to(arrays, bucket, bs)
        dev = {k: torch.as_tensor(np.ascontiguousarray(v), device=self.device)
               for k, v in arrays.items()}
        z, ck = dev.pop("__z"), dev.pop("__click")
        with torch.inference_mode():
            out = self.model.inference(dev, z, ck, self.use_gt_eval)
        if outputs is not None:
            missing = set(outputs) - set(out)
            if missing:
                raise KeyError(f"unknown outputs {sorted(missing)} "
                               f"(available: {sorted(out)})")
            out = {k: out[k] for k in outputs}
        return {k: (v[:bs].float() if v.is_floating_point() else v[:bs])
                .cpu().numpy() for k, v in out.items()}
