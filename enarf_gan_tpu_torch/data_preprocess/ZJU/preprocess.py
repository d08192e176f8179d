"""ZJU-MoCap → cache.npz (the port's counterpart of
``data_preprocess/ZJU/preprocess.py``).

    python -m enarf_gan_tpu_torch.data_preprocess.ZJU.preprocess \
        --data_path <dir with CoreView_*> [--write_path data/ZJU_DSO] \
        [--smpl_dir smpl_data] [--person_id 313 --n_train_frame N \
         --n_test_frame M --training_views 0,6] [--device cpu]

Two stages a cache. The pose stage (``pose_stage``) needs no cv2: one
batched call on the GPU (``--device`` names another device) does the SMPL
forward kinematics of every frame with its own betas, and the root
transform of each frame (``Rh`` by ``cv2.Rodrigues``'s formula, ``Th``).
The image stage reads, undistorts and resizes each view with cv2 on the
host: cameras from annots.npy (T/1000), 512² images with the intrinsics
rebased, the background masked and the mask as alpha. Caches: train,
novel view and novel pose (every 30th frame).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device
from enarf_gan_tpu_torch.data.cache import save_cache_npz
from enarf_gan_tpu_torch.geometry.smpl import (rvec_to_matrix,
                                               smpl_pose_transforms)

IMAGE_SIZE = 512


def pose_stage(model: Dict[str, np.ndarray], params: List[Dict],
               device=DEFAULT_DEVICE) -> np.ndarray:
    """Each frame's ``new_params`` (poses (1, 72), shapes (1, n_betas), Rh,
    Th) → (F, 24, 4, 4) float32 pose_to_world = [R(Rh) | Th] @ SMPL(poses,
    shapes), in one batched call on ``device``."""
    device = resolve_device(device)
    to = lambda x, dtype: torch.as_tensor(  # noqa: E731
        np.asarray(x, dtype), device=device)
    poses = np.stack([np.asarray(p["poses"]).reshape(72) for p in params])
    shapes = np.stack([np.asarray(p["shapes"]).reshape(-1) for p in params])
    A = smpl_pose_transforms(
        to(shapes, np.float32), to(poses, np.float32),
        to(model["v_template"], np.float32),
        to(model["shapedirs"], np.float32),
        to(model["J_regressor"], np.float32), model["parents"])
    trans = torch.eye(4, dtype=torch.float64, device=device).repeat(
        len(params), 1, 1)
    trans[:, :3, :3] = rvec_to_matrix(
        to(np.stack([np.asarray(p["Rh"]).reshape(3) for p in params]),
           np.float64))
    trans[:, :3, 3] = to(np.stack([np.asarray(p["Th"]).reshape(3)
                                   for p in params]), np.float64)
    return (trans[:, None] @ A.double()).float().cpu().numpy()


def read_annots(dir_path, person_id):
    annot = np.load(f"{dir_path}/CoreView_{person_id}/annots.npy",
                    allow_pickle=True)
    cams = annot[()]["cams"]
    K = np.array(cams["K"])
    R = np.array(cams["R"])
    T = np.array(cams["T"]) / 1000
    D = np.array(cams["D"])
    image_paths = annot[()]["ims"]
    return K, R, T, D, image_paths, len(K)


def save_cache(dir_path, write_path, smpl_model, person_id, n_frame, views,
               image_paths, K, R, T, D, prefix="train", start_frame_idx=0,
               interval=1, device=DEFAULT_DEVICE):
    import cv2

    frame_ids = list(range(start_frame_idx, start_frame_idx + n_frame,
                           interval))
    offset = 1 if person_id in ("313", "315") else 0
    params = [np.load(f"{dir_path}/CoreView_{person_id}/new_params/"
                      f"{frame_id + offset}.npy", allow_pickle=True)[()]
              for frame_id in frame_ids]
    poses_to_world = pose_stage(smpl_model, params, device)

    imgs, intr, rots, trans_l, poses, frame_id_l = [], [], [], [], [], []
    for frame_id, pose_to_world in zip(frame_ids, poses_to_world):
        for view in views:
            img_path = image_paths[frame_id]["ims"][view]
            image = cv2.imread(f"{dir_path}/CoreView_{person_id}/{img_path}")
            image = cv2.undistort(image, K[view], D[view])
            mask = cv2.imread(
                f"{dir_path}/CoreView_{person_id}/mask/{img_path[:-3]}png")
            mask = cv2.undistort(mask, K[view], D[view])

            h = image.shape[0]
            image = cv2.resize(image, (IMAGE_SIZE, IMAGE_SIZE),
                               interpolation=cv2.INTER_AREA)
            mask = cv2.resize(mask, (IMAGE_SIZE, IMAGE_SIZE),
                              interpolation=cv2.INTER_NEAREST)[:, :, :1]
            K_new = K[view].copy()
            K_new[:2] *= IMAGE_SIZE / h
            image = image * (mask > 0)
            image = np.concatenate([image[:, :, ::-1],
                                    (mask > 0).astype("uint8") * 255], axis=-1)
            imgs.append(image.transpose(2, 0, 1).astype(np.uint8))
            intr.append(K_new.astype(np.float32))
            rots.append(R[view].astype(np.float32))
            trans_l.append(T[view].astype(np.float32))
            poses.append(pose_to_world)
            frame_id_l.append(frame_id)

    out_dir = f"{write_path}/CoreView_{person_id}/{prefix}_cache_{n_frame}"
    save_cache_npz(out_dir, imgs=np.stack(imgs),
                   camera_intrinsic=np.stack(intr),
                   camera_rotation=np.stack(rots),
                   camera_translation=np.stack(trans_l).reshape(-1, 3, 1),
                   smpl_pose=np.stack(poses),
                   frame_id=np.array(frame_id_l, np.int64))
    print("wrote", out_dir)
    return out_dir


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/ZJU_DSO")
    parser.add_argument("--smpl_dir", type=str, default="smpl_data")
    # one subject at a time (default: the three shipped subjects)
    parser.add_argument("--person_id", type=str, default=None)
    parser.add_argument("--n_train_frame", type=int, default=None)
    parser.add_argument("--n_test_frame", type=int, default=None)
    parser.add_argument("--training_views", type=str, default=None,
                        help="comma-separated view ids")
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)

    model = dict(np.load(os.path.join(args.smpl_dir, "SMPL_NEUTRAL.npz")))
    configs = [
        {"person_id": "313", "n_train_frame": 1176, "n_test_frame": 294,
         "training_view": [0, 6, 12, 18]},
        {"person_id": "315", "n_train_frame": 1748, "n_test_frame": 437,
         "training_view": [0, 6, 12, 18]},
        {"person_id": "386", "n_train_frame": 516, "n_test_frame": 130,
         "training_view": [0, 6, 12, 18]},
    ]
    if args.person_id is not None:
        configs = [{
            "person_id": args.person_id,
            "n_train_frame": args.n_train_frame or 4,
            "n_test_frame": args.n_test_frame or 2,
            "training_view": [int(v) for v in
                              (args.training_views or "0").split(",")],
        }]
    for conf in configs:
        pid = conf["person_id"]
        K, R, T, D, image_paths, n_cam = read_annots(args.data_path, pid)
        train_views = conf["training_view"]
        test_views = [i for i in range(n_cam) if i not in train_views]
        common = dict(image_paths=image_paths, K=K, R=R, T=T, D=D,
                      device=args.device)
        save_cache(args.data_path, args.write_path, model, pid,
                   conf["n_train_frame"], train_views, prefix="train",
                   **common)
        save_cache(args.data_path, args.write_path, model, pid,
                   conf["n_train_frame"], test_views,
                   prefix="test_novel_view", interval=30, **common)
        save_cache(args.data_path, args.write_path, model, pid,
                   conf["n_test_frame"], test_views, prefix="test_novel_pose",
                   interval=30, start_frame_idx=conf["n_train_frame"],
                   **common)


if __name__ == "__main__":
    main()
