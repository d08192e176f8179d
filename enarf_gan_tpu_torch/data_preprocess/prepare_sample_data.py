"""A demo's ``sample_data.npz`` from a dataset cache (the port's
counterpart of ``data_preprocess/prepare_sample_data.py``; numpy only).

    python -m enarf_gan_tpu_torch.data_preprocess.prepare_sample_data \
        --data_root <cache dir> --out <dir> [--num 20] [--stride 1]

Takes every ``stride``-th item, at most ``num``: its pose in the camera
and world frames, bone lengths and pixel intrinsics.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from enarf_gan_tpu_torch.data.cache import load_cache
from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--num", type=int, default=20)
    parser.add_argument("--stride", type=int, default=1)
    args = parser.parse_args(argv)

    data = load_cache(args.data_root)
    smpl_pose = np.asarray(data["smpl_pose"])
    intr = np.asarray(data["camera_intrinsic"])
    idx = np.arange(0, len(smpl_pose), args.stride)[:args.num]

    pose_world = smpl_pose[idx]
    if "camera_rotation" in data:
        extr = np.tile(np.eye(4, dtype=np.float64), (len(idx), 1, 1))
        extr[:, :3, :3] = np.asarray(data["camera_rotation"])[idx]
        extr[:, :3, 3:] = np.asarray(data["camera_translation"])[idx]
        pose_cam = np.matmul(extr[:, None], pose_world)
    else:
        pose_cam = pose_world

    coord = pose_world[:, :, :3, 3]
    bl = np.linalg.norm(coord[:, 1:] - coord[:, SMPL_PARENTS[1:]],
                        axis=2)[:, :, None]

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "sample_data.npz")
    np.savez(path,
             pose_3d=pose_cam.astype(np.float32),
             pose_to_camera=pose_cam.astype(np.float32),
             pose_to_world=pose_world.astype(np.float32),
             bone_length=bl.astype(np.float32),
             intrinsics=intr[idx].astype(np.float32))
    print("wrote", path, len(idx), "samples")
    return path


if __name__ == "__main__":
    main()
