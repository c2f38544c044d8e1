"""FID: the Frechet distance between InceptionV3 pool3 activation
statistics (port of ``c2m_tpu/eval/fid.py``; reference src/utils/fid.py).

The distance math is the JAX module's, copied (numpy and scipy only;
``tests/test_torch_evaluator.py`` holds the copy to the original); FVD is
the same distance over I3D embeddings. :func:`embedder` turns either net
into the embedder the evaluator calls (batches, ``x * 2 - 1``, bilinear
resize, the net in float32 with TF32 off on its device).
:func:`inception_embedder` is the counterpart of the JAX module's
torchvision fallback: torchvision's pretrained InceptionV3 when its
checkpoint is already in the local torch hub cache
(``torch.hub.get_dir()/checkpoints/inception_v3_google-*.pth``), loaded
into the port's ``InceptionV3Pool3``; it never downloads, and without the
file it returns None.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from c2m_tpu_torch.device import full_float32, resolve_device


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (fid.py:112-190)."""
    diff = mu1 - mu2
    covmean = np.asarray(linalg.sqrtm(sigma1.dot(sigma2)))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid(real_acts: np.ndarray, fake_acts: np.ndarray) -> float:
    return frechet_distance(*activation_statistics(real_acts),
                            *activation_statistics(fake_acts))


def embedder(net: torch.nn.Module, size: Tuple[int, int],
             batch_size: int = 16, **net_kw) -> Callable:
    """fn(images [N, H, W, 3] or videos [N, T, H, W, 3] in [0, 1], numpy)
    -> [N, D] numpy, as the JAX evaluator embeds for FID and FVD: batches
    of ``batch_size`` on the net's device, mapped to [-1, 1], each frame
    resized bilinearly (align_corners=False) to ``size``, then
    ``net(x, **net_kw)``. The net runs in float32 with TF32 off, so the
    value compares across runs and papers as the reference's full-float32
    one."""
    from c2m_tpu_torch.ops.warp import resize_bilinear
    device = next(net.parameters()).device

    def embed(x: np.ndarray) -> np.ndarray:
        outs = []
        with torch.no_grad(), full_float32():
            for i in range(0, len(x), batch_size):
                v = torch.from_numpy(np.ascontiguousarray(
                    x[i:i + batch_size], np.float32)).to(device)
                v = resize_bilinear(v * 2.0 - 1.0, size)
                outs.append(net(v, **net_kw).cpu().numpy())
        return np.concatenate(outs)

    return embed


def hub_inception_checkpoint() -> Optional[str]:
    """torchvision's InceptionV3 checkpoint in the local torch hub cache,
    or None."""
    found = sorted(glob.glob(os.path.join(
        torch.hub.get_dir(), "checkpoints", "inception_v3_google-*.pth")))
    return found[-1] if found else None


def inception_embedder(batch_size: int = 16, device=None
                       ) -> Optional[Callable]:
    """fn(images [N, H, W, 3] in [0, 1]) -> [N, 2048] from torchvision's
    pretrained weights in the hub cache, on ``device`` (the card when
    None); None when the file is not there. The JAX fallback resizes
    before ``x * 2 - 1``; bilinear weights sum to 1, so :func:`embedder`'s
    order is the same function up to rounding."""
    path = hub_inception_checkpoint()
    if path is None:
        return None
    from c2m_tpu_torch.eval.inception import InceptionV3Pool3
    net = InceptionV3Pool3()
    state = torch.load(path, map_location="cpu", weights_only=True)
    net.load_state_dict({k: v for k, v in state.items()
                         if not k.startswith(("AuxLogits.", "fc."))})
    net = net.to(resolve_device(device)).eval()
    return embedder(net, (299, 299), batch_size)
