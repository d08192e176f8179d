"""NeuralActor → cache.npz (the port's counterpart of
``data_preprocess/NeuralActor/preprocess.py``; numpy and cv2 on the host,
no forward kinematics).

    python -m enarf_gan_tpu_torch.data_preprocess.NeuralActor.preprocess \
        --data_path <dir> [--write_path data/NeuralActor] [--n_process 5] \
        [--person_id lan --n_train_frame N --n_test_frame M --n_camera C]

Each camera's video is decoded by a worker process (one pool of
``n_process`` for the run); the background is
white (a pixel is foreground where ||rgb - 255|| >= 18). The joints_RT
json of each frame gives the per-joint world transforms, the txt files the
cameras. Train and test caches, each also as a debug cache of every 10th
frame.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
from typing import Optional, Sequence

import numpy as np

from enarf_gan_tpu_torch.data.cache import save_cache_npz


def get_mask_from_rgb(image):
    if image.shape[0] != 3 or image.max() <= 250:
        raise ValueError("expected a (3, H, W) frame on a white background")
    return np.linalg.norm(image.astype("float") - 255, axis=0) >= 18


class ReadSingleVideo:
    def __init__(self, dir_path, person_id, split, n_frame, interval):
        self.dir_path = dir_path
        self.person_id = person_id
        self.split = split
        self.n_frame = n_frame
        self.interval = interval

    def __call__(self, cam_id):
        import cv2
        count = 0
        frames = []
        cap = cv2.VideoCapture(
            f"{self.dir_path}/{self.person_id}/{self.split}/rgb_video/"
            f"{cam_id:0>3}.avi")
        try:
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                if count % self.interval == 0:
                    frame = frame.transpose(2, 0, 1)[::-1]  # BGR→RGB, CHW
                    mask = get_mask_from_rgb(frame)
                    frame = frame * mask + 255 * (1 - mask)
                    frames.append(frame.astype("uint8"))
                count += 1
        finally:
            cap.release()
        print(f"Video {cam_id} is done ({len(frames)} frames)")
        return frames


def read_frames(dir_path, n_camera, person_id, split, n_frame, interval,
                pool):
    """Every kept frame, camera-major within a frame; ``pool`` (a
    ``multiprocessing`` pool) decodes one camera's video a task."""
    rsv = ReadSingleVideo(dir_path, person_id, split, n_frame, interval)
    per_cam = pool.map(rsv, range(n_camera))
    out = []
    for i in range(len(per_cam[0])):
        for cam_id in range(n_camera):
            out.append(per_cam[cam_id][i])
    return np.stack(out)


def save_cache(dir_path, write_path, person_id, n_camera, n_frame,
               pool, prefix="train", start_frame_idx=0, interval=1,
               debug=False):
    if debug:
        interval = 10
    split = "training" if prefix == "train" else "testing"
    frames = read_frames(dir_path, n_camera, person_id, split, n_frame,
                         interval, pool)

    intrinsics = np.array(
        [np.loadtxt(f"{dir_path}/{person_id}/intrinsic/0_train_{i:0>4}.txt")
         for i in range(n_camera)])
    extrinsics = np.array(
        [np.linalg.inv(np.loadtxt(
            f"{dir_path}/{person_id}/pose/0_train_{i:0>4}.txt"))
         for i in range(n_camera)])

    smpl_pose = []
    for frame_id in range(0, n_frame, interval):
        with open(f"{dir_path}/{person_id}/{split}/"
                  f"transform_smoth3e-2_withmotion/{frame_id:0>6}.json") as f:
            data = json.load(f)
        joints_RT = np.array(data["joints_RT"])
        rotation = np.array(data["rotation"])
        joints = np.array(data["joints"])
        joint_rot = np.matmul(rotation.T,
                              joints_RT.transpose(2, 0, 1)[:, :3, :3])
        jt = np.concatenate([joint_rot, joints[:, :, None]], axis=-1)
        jt = np.concatenate([jt, np.tile([[[0, 0, 0, 1]]], (24, 1, 1))],
                            axis=1)
        smpl_pose.append(jt)
    smpl_pose = np.array(smpl_pose)

    n_kept = len(smpl_pose)
    intrinsics = np.tile(intrinsics, (n_kept, 1, 1))
    extrinsics = np.tile(extrinsics, (n_kept, 1, 1))
    smpl_pose = np.repeat(smpl_pose, n_camera, axis=0)
    frame_id = np.repeat(np.arange(0, n_frame, interval), n_camera,
                         axis=0) + start_frame_idx

    out_dir = (f"{write_path}/{person_id}/"
               f"{prefix}{'_debug' * debug}_cache_{n_frame}")
    save_cache_npz(out_dir, imgs=frames,
                   camera_intrinsic=intrinsics.astype(np.float32),
                   camera_rotation=extrinsics[:, :3, :3].astype(np.float32),
                   camera_translation=extrinsics[:, :3, 3:].astype(np.float32),
                   smpl_pose=smpl_pose.astype(np.float32),
                   frame_id=frame_id.astype(np.int64))
    print("wrote", out_dir)
    return out_dir


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/NeuralActor")
    parser.add_argument("--n_process", type=int, default=5)
    # one subject at a time (default: lan and marc)
    parser.add_argument("--person_id", type=str, default=None)
    parser.add_argument("--n_train_frame", type=int, default=None)
    parser.add_argument("--n_test_frame", type=int, default=None)
    parser.add_argument("--n_camera", type=int, default=None)
    args = parser.parse_args(argv)

    configs = [
        {"person_id": "lan", "n_train_frame": 33605, "n_test_frame": 14235,
         "n_camera": 11},
        {"person_id": "marc", "n_train_frame": 38194, "n_test_frame": 23062,
         "n_camera": 12},
    ]
    if args.person_id is not None:
        configs = [{"person_id": args.person_id,
                    "n_train_frame": args.n_train_frame or 4,
                    "n_test_frame": args.n_test_frame or 2,
                    "n_camera": args.n_camera or 2}]
    with multiprocessing.get_context("spawn").Pool(args.n_process) as pool:
        for conf in configs:
            for debug in (False, True):
                save_cache(args.data_path, args.write_path, conf["person_id"],
                           conf["n_camera"], conf["n_train_frame"], pool,
                           prefix="train", debug=debug)
                save_cache(args.data_path, args.write_path, conf["person_id"],
                           conf["n_camera"], conf["n_test_frame"], pool,
                           prefix="test",
                           start_frame_idx=conf["n_train_frame"],
                           interval=10, debug=debug)


if __name__ == "__main__":
    main()
