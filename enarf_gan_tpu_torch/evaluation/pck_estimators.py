"""2-D pose estimators for the PCK evaluation (the port's counterpart of
``evaluation/pck_estimators.py``).

``StubEstimator`` reads images the way a real estimator does and places
its keypoints without a model, so that the estimate → PCK chain runs
anywhere; its numbers compare with nothing published. The reference
protocol's mmdet + mmpose HRNet and the ViTPose alternative need packages
and checkpoints that neither the repository nor the card holds (ROADMAP
Queue 1, item 5); here they raise.
"""
from __future__ import annotations

import numpy as np

WAITING = ("the {} estimator waits for its packages and checkpoints, "
           "which the repository does not hold (ROADMAP Queue 1, item 5); "
           "use --estimator projected or stub")


class StubEstimator:
    """Deterministic image-only estimator: ``num_keypoints`` keypoints on a
    ring of radius min(H, W) / 8 around the brightness-weighted centroid of
    the image."""

    def __init__(self, num_keypoints: int):
        self.num_keypoints = num_keypoints

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """(B, 3, H, W) [-1, 1] → (B, K, 2) keypoints."""
        B, _, H, W = imgs.shape
        lum = imgs.mean(axis=1) + 1.0
        total = lum.sum(axis=(1, 2)) + 1e-8
        ys = (lum.sum(axis=2) * np.arange(H)).sum(axis=1) / total
        xs = (lum.sum(axis=1) * np.arange(W)).sum(axis=1) / total
        ang = 2 * np.pi * np.arange(self.num_keypoints) / self.num_keypoints
        ring = np.stack([np.cos(ang), np.sin(ang)], axis=1) * (min(H, W) / 8)
        return np.stack([xs, ys], axis=1)[:, None, :] + ring[None]


class MMPoseEstimator:
    """mmdet person detector + mmpose top-down keypoints (the reference
    protocol): not on the port yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(WAITING.format("mmpose"))


class VitPoseEstimator:
    """ViTPose keypoints from a local checkpoint: not on the port yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(WAITING.format("vitpose"))
