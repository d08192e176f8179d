"""AIST++ → cache.npz (the port's counterpart of
``data_preprocess/AIST/preprocess.py``).

    python -m enarf_gan_tpu_torch.data_preprocess.AIST.preprocess \
        --data_path <video dir> --annotation_path <dir> \
        [--write_path data/aist++] [--smpl_dir smpl_data] \
        [--person_ids 7,8] [--n_per_person 3000] [--device cpu]

Needs the ``aist_plusplus`` SDK (from the AIST++ release). For each video
(decoded at 3 fps) the pose stage (``view_pose_stage``) runs on the GPU
(``--device`` names another device): the SMPL forward kinematics of every
60 fps motion frame at zero betas (``smpl_forward``), scaled and
translated, and the aligned crop's geometry (``crop_geometry``): the
joints projected into the view, whether all of them lie in the image, a
square of side 600·focal/1500 centred on the root joint and the
intrinsics rebased to its 128² resize.
The image stage undistorts, reflect-pads, crops and resizes each frame
with cv2 on the host. Frames with a joint outside the image are dropped;
each dancer keeps ``n_per_person`` evenly spaced frames, in units of 100
(metres), and the dancers' caches are merged into ``all_all``.
"""
from __future__ import annotations

import argparse
import glob
import os
from contextlib import redirect_stdout
from typing import Optional, Sequence

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device
from enarf_gan_tpu_torch.data.cache import save_cache_npz
from enarf_gan_tpu_torch.geometry.smpl import rvec_to_matrix, smpl_forward

ALGO = "aligned_crop"
CROP_SIZE = 600
SAVE_SIZE = 128
STANDARD_FOCAL = 1500
N_PER_PERSON = 3000


def crop_side(intrinsic) -> int:
    """The crop's side in pixels: CROP_SIZE at a focal of STANDARD_FOCAL,
    rounded down to an even number."""
    focal = (intrinsic[0, 0] + intrinsic[1, 1]) / 2
    return int(CROP_SIZE * focal / STANDARD_FOCAL) // 2 * 2


def crop_geometry(pose, rot, trans, intrinsic, height, width,
                  device=DEFAULT_DEVICE):
    """The aligned crop of N frames of one view, on ``device`` in float64.

    pose (N, 24, 4, 4) world transforms; rot (3, 3), trans (3, 1) and
    intrinsic (3, 3) the camera. Returns (validity (N,) bool: every joint
    inside the ``height`` x ``width`` image; top_left (N, 2) int64: the
    crop's corner, floor of the root joint's pixel less half the side, and
    (0, 0) where not valid; intrinsics (N, 3, 3) float64 shifted to the
    corner and scaled to the SAVE_SIZE² resize)."""
    device = resolve_device(device)
    f64 = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float64), device=device)
    side = crop_side(intrinsic)
    K = f64(intrinsic)
    cam = f64(rot) @ f64(pose[:, :, :3, 3:]) + f64(trans)  # (N, 24, 3, 1)
    px = K @ cam
    joints_2d = px[..., :2, 0] / px[..., 2:, 0]            # (N, 24, 2)
    valid = ((joints_2d.amin(dim=(1, 2)) >= 0)
             & (joints_2d[..., 0].amax(dim=1) < width)
             & (joints_2d[..., 1].amax(dim=1) < height))
    corner = torch.floor(joints_2d[:, 0]).long() - side // 2
    top_left = torch.where(valid[:, None], corner, 0)
    out = K.expand(len(pose), 3, 3).clone()
    out[:, :2, 2] -= top_left
    out[:, :2] /= side / SAVE_SIZE
    return valid.cpu().numpy(), top_left.cpu().numpy(), out.cpu().numpy()


def crop_frame(img, top_left, side):
    """The ``side``-pixel square at ``top_left`` (reflect-padded where it
    leaves the image), resized bicubic to SAVE_SIZE², BGR → RGB."""
    import cv2
    h, w, _ = img.shape
    x1, y1 = (int(v) for v in top_left)
    grow = ((max(0, -y1), max(0, y1 + side - h)),
            (max(0, -x1), max(0, x1 + side - w)), (0, 0))
    padded = np.pad(img, grow, mode="reflect")
    crop = padded[max(0, y1):max(0, y1) + side,
                  max(0, x1):max(0, x1) + side]
    return cv2.resize(crop, (SAVE_SIZE, SAVE_SIZE),
                      interpolation=cv2.INTER_CUBIC)[:, :, ::-1]


def view_pose_stage(smpl_model, smpl_poses, smpl_scaling, smpl_trans,
                    rmat, tvec, camera_mat, video_len, height, width,
                    device=DEFAULT_DEVICE):
    """The device work of one video (one camera view of a sequence): the
    forward kinematics of the sequence's whole 60 fps motion (T, 72) at
    zero betas, scaled and translated, kept at the video's 3 fps frames
    (frame i shows motion frame (i + 1) * 20 - 1), and ``crop_geometry``
    of those frames in the view. Returns (pose (video_len, 24, 4, 4),
    validity, top_left, intrinsics)."""
    A = smpl_forward(smpl_model, smpl_poses.reshape(-1, 24, 3), None, device)
    A[:, :, :3, 3] *= smpl_scaling
    A[:, :, :3, 3] += smpl_trans[:, None]
    A = A[19:20 * video_len:20]
    return (A,) + crop_geometry(A, rmat, tvec, camera_mat, height, width,
                                device)


def read_frames(video_dir, aist_dataset, smpl_model, person_id,
                n_per_person=N_PER_PERSON, device=DEFAULT_DEVICE):
    import cv2
    from aist_plusplus import utils
    from aist_plusplus.loader import AISTDataset

    paths = sorted(glob.glob(f"{video_dir}/*_d{person_id:0>2}_*.mp4"))
    vids, intrs, valids, rmats, tvecs, smpls = [], [], [], [], [], []
    for video_path in paths:
        video_name = os.path.splitext(os.path.basename(video_path))[0]
        seq_name, view = AISTDataset.get_seq_name(video_name)
        view_idx = AISTDataset.VIEWS.index(view)
        env_name = aist_dataset.mapping_seq2env[seq_name]
        cgroup = AISTDataset.load_camera_group(aist_dataset.camera_dir,
                                               env_name)
        with open(os.devnull, "w") as devnull, redirect_stdout(devnull):
            frames3fps = utils.ffmpeg_video_read(video_path, 3)[:, :, :, ::-1]

        cam = cgroup.cameras[view_idx]
        camera_mat = cam.matrix
        rmat = rvec_to_matrix(torch.as_tensor(
            np.asarray(cam.rvec, np.float64).reshape(1, 3)))[0].numpy()
        tvec = cam.tvec[:, None]
        dist = cam.dist

        motion = AISTDataset.load_motion(aist_dataset.motion_dir, seq_name)
        video_len = len(frames3fps)
        A, validity, top_left, intri = view_pose_stage(
            smpl_model, *motion, rmat, tvec, camera_mat, video_len,
            *frames3fps.shape[1:3], device)
        rmats.append(np.tile(rmat, (video_len, 1, 1)))
        tvecs.append(np.tile(tvec, (video_len, 1, 1)))
        smpls.append(A)
        side = crop_side(camera_mat)
        fr = []
        for i in range(video_len):
            frame = cv2.undistort(frames3fps[i], camera_mat, dist)
            fr.append(crop_frame(frame, top_left[i], side) if validity[i]
                      else np.zeros((SAVE_SIZE, SAVE_SIZE, 3), np.uint8))
        vids.append(np.array(fr))
        intrs.append(intri)
        valids.append(validity)

    video = np.concatenate(vids)
    intrinsic = np.concatenate(intrs)
    validity = np.concatenate(valids)
    rmat = np.concatenate(rmats)
    tvec = np.concatenate(tvecs)
    smpl = np.concatenate(smpls)

    video, intrinsic = video[validity], intrinsic[validity]
    rmat, tvec, smpl = rmat[validity], tvec[validity], smpl[validity]
    idx = np.linspace(0, len(video) - 1, n_per_person, dtype=int)
    video, intrinsic = video[idx], intrinsic[idx]
    rmat, tvec, smpl = rmat[idx], tvec[idx].copy(), smpl[idx].copy()
    tvec /= 100
    smpl[:, :, :3, 3] /= 100
    return video, rmat, tvec, smpl, intrinsic


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/aist++")
    parser.add_argument("--annotation_path", type=str, required=True)
    parser.add_argument("--smpl_dir", type=str, default="smpl_data")
    parser.add_argument("--person_ids", type=str, default=None,
                        help="comma-separated dancer ids (default: all 30)")
    parser.add_argument("--n_per_person", type=int, default=N_PER_PERSON)
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)

    from aist_plusplus.loader import AISTDataset

    smpl_model = dict(np.load(os.path.join(args.smpl_dir, "SMPL_MALE.npz")))
    aist_dataset = AISTDataset(args.annotation_path)
    cache_root = (f"{args.write_path}/cache{SAVE_SIZE}_{ALGO}_"
                  f"fl{STANDARD_FOCAL}")

    person_ids = np.concatenate([np.arange(7, 31), np.arange(1, 7)]) \
        if args.person_ids is None else \
        [int(p) for p in args.person_ids.split(",")]
    merged = {}
    for pid in person_ids:
        video, rmat, tvec, smpl, intrinsic = read_frames(
            args.data_path, aist_dataset, smpl_model, pid,
            args.n_per_person, args.device)
        arrays = dict(imgs=video.transpose(0, 3, 1, 2).astype(np.uint8),
                      camera_intrinsic=intrinsic.astype(np.float32),
                      camera_rotation=rmat.astype(np.float32),
                      camera_translation=tvec.astype(np.float32),
                      smpl_pose=smpl.astype(np.float32))
        save_cache_npz(f"{cache_root}/{pid:0>2}", **arrays)
        for k, v in arrays.items():
            merged.setdefault(k, []).append(v)
        print(f"person {pid}: {len(video)} frames")

    merged = {k: np.concatenate(v) for k, v in merged.items()}
    out = f"{cache_root}/all_all"
    save_cache_npz(out, **merged)
    canon = os.path.join(args.smpl_dir, "male_canonical.npy")
    if os.path.exists(canon):
        np.save(os.path.join(out, "canonical.npy"), np.load(canon))
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
