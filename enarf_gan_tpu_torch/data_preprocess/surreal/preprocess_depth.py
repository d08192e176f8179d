"""SURREAL → NARF_GAN_depth_cache (the port's counterpart of
``data_preprocess/surreal/preprocess_depth.py``).

    python -m enarf_gan_tpu_torch.data_preprocess.surreal.preprocess_depth \
        --data_path <dir> [--write_path data/surreal] [--smpl_dir smpl_data] \
        [--device cpu]

Each clip's first depth map (``*_depth.mat``) as disparity (below 0.1,
the void beyond 10 m, set to 0), cropped and rebased with the spine crop
of ``preprocess.py`` (whose pose, computed on the GPU unless ``--device``
names another device, it stores beside): the ground truth of
``SurrealPoseDepthDataset`` and ``evaluation.compute_depth``.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device
from enarf_gan_tpu_torch.data.cache import save_cache_npz

from .preprocess import (IMG_SIZE, load_smpl_models, pose_and_crop,
                         read_annotation)


def first_frame_disparity(video_path: str) -> np.ndarray:
    """(240, 320) inverse depth of the clip's first frame, void zeroed."""
    import scipy.io
    depth = scipy.io.loadmat(video_path[:-4] + "_depth.mat",
                             squeeze_me=True)["depth_1"]
    with np.errstate(divide="ignore"):
        disparity = np.where(depth > 0, 1.0 / depth, 0.0)
    return np.where(disparity >= 0.1, disparity, 0.0).astype(np.float32)


def preprocess_clip(disparity, annot, smpl_model, device=DEFAULT_DEVICE):
    """The clip's first disparity map and ``read_annotation``'s parse →
    (disparity (128, 128), K (3, 3), pose (24, 4, 4)), or None if the
    clip's crop is missing or leaves the frame."""
    import cv2
    crop, A_new, K, _ = pose_and_crop(annot, smpl_model, device)
    if crop is None:
        return None
    x1, x2, y1, y2 = crop
    if x1 < 0 or y1 < 0 or x2 > disparity.shape[1] or y2 > disparity.shape[0]:
        return None
    resized = cv2.resize(disparity[y1:y2, x1:x2], (IMG_SIZE, IMG_SIZE),
                         interpolation=cv2.INTER_NEAREST)
    return resized, K.astype(np.float32), A_new[0].astype(np.float32)


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/surreal")
    parser.add_argument("--smpl_dir", type=str, default="smpl_data")
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)

    import cv2  # noqa: F401  (the image stage: raise before any work)
    device = resolve_device(args.device)
    smpl_models = load_smpl_models(args.smpl_dir)
    videos = sorted(glob.glob(f"{args.data_path}/*/*/*/*.mp4"))
    print(len(videos), "videos")

    disparities, intrinsics, poses = [], [], []
    for path in videos:
        try:  # a clip with broken files is reported and skipped
            annot = read_annotation(path)
            model = smpl_models[annot["gender"]]
            disparity = first_frame_disparity(path)
        except Exception as e:
            print("invalid data:", path, e)
            continue
        item = preprocess_clip(disparity, annot, model, device)
        if item is None:
            print("invalid data:", path)
            continue
        disparity, K, pose = item
        disparities.append(disparity)
        intrinsics.append(K)
        poses.append(pose)

    out_dir = os.path.join(args.write_path, "NARF_GAN_depth_cache")
    save_cache_npz(out_dir, disparity=np.stack(disparities),
                   camera_intrinsic=np.stack(intrinsics),
                   smpl_pose=np.stack(poses))
    canon_src = os.path.join(args.smpl_dir, "neutral_canonical.npy")
    if os.path.exists(canon_src):
        np.save(os.path.join(out_dir, "canonical.npy"), np.load(canon_src))
    print("wrote", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
