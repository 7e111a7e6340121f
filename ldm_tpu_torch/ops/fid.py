"""Frechet distance metrics for sample quality: the port's own copy of
ldm_tpu/ops/fid.py (numpy, float64 on the host), the same arithmetic line
for line, so its results equal the JAX package's bit for bit.

No pretrained Inception weights are available offline, so the features are
pluggable: flattened (pooled) pixels (:func:`pixel_fid`) or the trained
classifier's pooled embedding (:func:`classifier_fid`, with
``ResNetTrainer.features`` as ``apply_fn``).  The matrix square root uses
``eigh`` of symmetrized PSD products.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def _stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    feats = np.asarray(feats, np.float64).reshape(len(feats), -1)
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray,
                     cov2: np.ndarray) -> float:
    """||mu1-mu2||^2 + Tr(c1 + c2 - 2 (c1 c2)^(1/2)), clipped at 0."""
    diff = mu1 - mu2
    # (c1 c2)^(1/2) has the trace of (c1^(1/2) c2 c1^(1/2))^(1/2)
    s1 = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(s1 @ cov2 @ s1)
    fid = float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(inner))
    return max(fid, 0.0)


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu1, c1 = _stats(real)
    mu2, c2 = _stats(fake)
    return frechet_distance(mu1, c1, mu2, c2)


def pixel_fid(real: np.ndarray, fake: np.ndarray, max_dims: int = 256) -> float:
    """FID over raw pixels (uint8 or float NHWC, scaled by 1/255), average-
    pooled down to at most ``max_dims`` dimensions."""
    def prep(x):
        x = np.asarray(x, np.float64).reshape(len(x), -1) / 255.0
        d = x.shape[1]
        if d > max_dims:
            stride = -(-d // max_dims)
            pad = (-d) % stride
            if pad:
                x = np.pad(x, ((0, 0), (0, pad)), mode="edge")
            x = x.reshape(len(x), -1, stride).mean(-1)
        return x

    return fid_from_features(prep(real), prep(fake))


def classifier_features(apply_fn: Callable, images_m11: np.ndarray) -> np.ndarray:
    """The classifier's pooled features of images in [-1, 1], as numpy."""
    return np.asarray(apply_fn(images_m11))


def classifier_fid(apply_fn: Callable, real_m11: np.ndarray, fake_m11: np.ndarray) -> float:
    """FID with the trained classifier's pooled features as the embedding."""
    return fid_from_features(classifier_features(apply_fn, real_m11),
                             classifier_features(apply_fn, fake_m11))
