"""FID in the port (the counterpart of ``enarf_gan_tpu/eval_lib/fid.py``):
images in [0, 255] resized to 299² bilinear, InceptionV3 pool3 features,
dataset statistics cached to an ``.npz`` (keys ``mu`` and ``sigma``, so
that either package reads the other's cache), the Fréchet distance.

Weights: ``INCEPTION_WEIGHTS_NPZ`` (or the ``weights_npz`` argument) names
an npz exported by ``data_preprocess/export_inception_weights.py`` or the
seeded set ``random[:<seed>]``; there is no other source, and without one
the extractor raises. FID values compare only within one weight set.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch import DEFAULT_DEVICE
from enarf_gan_tpu_torch.eval_lib import inception

FeatureExtractor = Callable[[np.ndarray], np.ndarray]  # (B,3,299,299)[0,255]→(B,D)


def resize_bilinear_299(imgs: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) [0, 255] → (B, 3, 299, 299) float32 on the same
    device: bilinear with half-pixel centres, and the triangle filter
    widened to the scale when it shrinks, as ``jax.image.resize(...,
    "bilinear")`` does (``antialias``; enlarging, it is plain bilinear)."""
    return F.interpolate(imgs.float(), size=(299, 299), mode="bilinear",
                         align_corners=False, antialias=True)


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||² + Tr(S1 + S2 - 2 sqrt(S1 S2)) by scipy's sqrtm, again
    with eps on the diagonals where the square root is not finite."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # without ``disp``: newer scipy has no such argument (the square root
    # is the same)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def load_or_compute_dataset_stats(
        cache_path: str, feature_iter: Callable[[], Iterable[np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray]:
    """The dataset's (mu, sigma) from ``cache_path``, or computed from
    ``feature_iter()``'s feature batches and written there."""
    if os.path.exists(cache_path):
        data = np.load(cache_path)
        return data["mu"], data["sigma"]
    feats = np.concatenate(list(feature_iter()), axis=0)
    mu, sigma = compute_statistics(feats)
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez(cache_path, mu=mu, sigma=sigma)
    return mu, sigma


def weights_source(weights_npz: Optional[str] = None) -> str:
    """The weight set: the argument, else ``INCEPTION_WEIGHTS_NPZ``."""
    return weights_npz or os.environ.get("INCEPTION_WEIGHTS_NPZ", "")


def make_inception_extractor(weights_npz: Optional[str] = None,
                             batch_size: int = 64,
                             device=DEFAULT_DEVICE) -> FeatureExtractor:
    """InceptionV3 pool3 features on ``device`` from the weight set of
    ``weights_source(weights_npz)``: an existing npz or ``random[:<seed>]``.
    Raises without one (FID compares only within a weight set, so nothing
    is substituted)."""
    source = weights_source(weights_npz)
    if source and (os.path.exists(source) or inception.is_random(source)):
        return inception.make_extractor(source, batch_size, device)
    raise RuntimeError(
        "No InceptionV3 weights available for FID. Export with "
        "data_preprocess/export_inception_weights.py on a connected "
        "machine and set INCEPTION_WEIGHTS_NPZ.")


def fid_between(features_fake: np.ndarray, mu_real: np.ndarray,
                sigma_real: np.ndarray) -> float:
    mu_f, sigma_f = compute_statistics(features_fake)
    return frechet_distance(mu_f, sigma_f, mu_real, sigma_real)
