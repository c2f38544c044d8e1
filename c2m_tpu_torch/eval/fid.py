"""The Frechet distance math of ``c2m_tpu/eval/fid.py`` (copied; numpy and
scipy only), used for FID over InceptionV3 pool3 activations and for FVD
over I3D embeddings (``c2m_tpu/eval/i3d.compute_fvd`` is the same
distance). The embedders themselves are not here: the evaluator takes them
as callables. ``tests/test_torch_evaluator.py`` holds the copy to the
original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import linalg


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
