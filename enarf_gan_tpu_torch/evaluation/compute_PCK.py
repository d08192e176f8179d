"""PCK of the GAN on the port (the counterpart of
``evaluation/compute_PCK.py``).

    python -m enarf_gan_tpu_torch.evaluation.compute_PCK \
        --config configs/enarfgan_train/AIST/config.yml \
        --default_config configs/enarfgan_train/default.yml \
        [--num_sample 10000] [--batch_size 4] [--truncation 0.4] [--thr 0.5]
        [--estimator projected|stub] [--device cpu]

Renders poses of the pose prior (loader seed 0; z, the fine sampler and
the background from a ``torch.Generator`` seeded 0) through the latest
snapshot under ``<out_root>/result/<out>`` on the card (``--device`` names
another device), and scores PCK@thr with the shoulders' distance as the
norm. ``projected`` needs no estimator: a joint counts as found where the
rendered mask exceeds 0.5 at its rounded projection, else it is moved by
the image size. ``stub`` runs ``StubEstimator`` on the images. Writes
``pck_<estimator>.txt`` there. The reference protocol's mmpose and the
ViTPose alternative wait for their checkpoints and raise.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, use_full_float32
from enarf_gan_tpu_torch.config import yaml_config
from enarf_gan_tpu_torch.data.datasets import HumanPoseDataset
from enarf_gan_tpu_torch.data.loader import DataLoader, infinite_batches
from enarf_gan_tpu_torch.evaluation import pck_estimators
from enarf_gan_tpu_torch.evaluation.common import (load_generator,
                                                   out_dir_of, render_batch)


def keypoint_pck_accuracy(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
                          thr: float, normalize: np.ndarray):
    """PCK: the share of keypoints with ||pred - gt|| / normalize < thr.

    pred, gt: (N, K, 2); mask: (N, K) bool; normalize: (N, 2).
    Returns (accuracy of each keypoint (K,), -1 where none is valid; their
    mean; the count of keypoints with a valid one)."""
    N, K, _ = pred.shape
    norm = np.where(normalize <= 0, 1e6, normalize)
    dist = np.linalg.norm((pred - gt) / norm[:, None, :], axis=-1)
    valid = mask.astype(bool) & (normalize > 0).all(axis=1)[:, None]
    acc_per_kpt = np.full(K, -1.0)
    for k in range(K):
        v = valid[:, k]
        if v.any():
            acc_per_kpt[k] = (dist[v, k] < thr).mean()
    have = acc_per_kpt >= 0
    avg = acc_per_kpt[have].mean() if have.any() else 0.0
    cnt = int(have.sum())
    return acc_per_kpt, float(avg), cnt


def interocular_distance(gt: np.ndarray, left_eye: int = 1,
                         right_eye: int = 2) -> np.ndarray:
    """(N, K, 2) → (N, 2): the distance of two keypoints, twice."""
    d = np.linalg.norm(gt[:, left_eye] - gt[:, right_eye], axis=-1)
    return np.stack([d, d], axis=1)


def projected_keypoints(mask: np.ndarray, pose_2d: np.ndarray,
                        size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The estimator-free rule on one batch: (pred, gt) where gt is the
    projected joints (B, K, 2) and pred each joint itself where the
    rendered mask (B, H, W) exceeds 0.5 at its rounded projection, else
    the joint moved by ``size``."""
    xi = np.clip(pose_2d[..., 0].round().astype(int), 0, size - 1)
    yi = np.clip(pose_2d[..., 1].round().astype(int), 0, size - 1)
    hit = mask[np.arange(len(mask))[:, None], yi, xi] > 0.5
    return np.where(hit[..., None], pose_2d, pose_2d + size), pose_2d


def make_estimator(name: str, num_keypoints: int, vitpose_dir: str = ""):
    """The estimator of ``--estimator``; None for ``projected``."""
    if name == "mmpose":
        return pck_estimators.MMPoseEstimator()
    if name == "vitpose":
        return pck_estimators.VitPoseEstimator(vitpose_dir)
    if name == "stub":
        return pck_estimators.StubEstimator(num_keypoints=num_keypoints)
    return None


def evaluate(config, device=DEFAULT_DEVICE, num_sample: int = 10000,
             batch_size: int = 4, truncation: float = 0.4, thr: float = 0.5,
             estimator: str = "projected", vitpose_dir: str = "") -> float:
    """PCK@thr of the config's latest snapshot, written to
    ``pck_<estimator>.txt``; returns it."""
    size = config.dataset.image_size
    pose_ds = HumanPoseDataset(size=size,
                               data_root=config.dataset.train.data_root,
                               num_repeat_in_epoch=1)
    est = make_estimator(estimator, pose_ds[0]["pose_2d"].shape[0],
                         vitpose_dir)
    gen = load_generator(config, pose_ds.num_bone, pose_ds.parents,
                         pose_ds.canonical_pose, device)
    rng = torch.Generator(device=device).manual_seed(0)
    loader = infinite_batches(DataLoader(pose_ds, batch_size, shuffle=True,
                                         drop_last=True, seed=0))
    preds, gts = [], []
    n_done = 0
    for batch in loader:
        img, mask, _ = render_batch(gen, batch, rng, truncation)
        if est is not None:
            preds.append(est(img.clamp(-1, 1).cpu().numpy()))
            gts.append(batch["pose_2d"])
        else:
            pred, gt = projected_keypoints(mask.cpu().numpy(),
                                           np.asarray(batch["pose_2d"]), size)
            preds.append(pred)
            gts.append(gt)
        n_done += batch_size
        if n_done >= num_sample:
            break
    preds = np.concatenate(preds)[:num_sample]
    gts = np.concatenate(gts)[:num_sample]
    norm = interocular_distance(gts, 16, 17)   # the shoulders
    _, pck, _ = keypoint_pck_accuracy(preds, gts,
                                      np.ones(preds.shape[:2], bool), thr,
                                      norm)
    path = os.path.join(out_dir_of(config), f"pck_{estimator}.txt")
    with open(path, "w") as f:
        f.write(f"{pck}")
    print(path, pck)
    return pck


def main(argv: Optional[Sequence[str]] = None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/AIST/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--num_sample", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--truncation", type=float, default=0.4)
    parser.add_argument("--thr", type=float, default=0.5)
    parser.add_argument("--estimator",
                        choices=["mmpose", "vitpose", "projected", "stub"],
                        default="projected")
    parser.add_argument("--vitpose_dir", type=str, default="",
                        help="local ViTPose checkpoint (--estimator vitpose)")
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)
    use_full_float32()
    return evaluate(yaml_config(args.config, args.default_config),
                    torch.device(args.device), args.num_sample,
                    args.batch_size, args.truncation, args.thr,
                    args.estimator, args.vitpose_dir)


if __name__ == "__main__":
    main()
