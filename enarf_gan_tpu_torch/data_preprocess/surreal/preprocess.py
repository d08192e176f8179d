"""SURREAL → VAE_cache (the port's counterpart of
``data_preprocess/surreal/preprocess.py``).

    python -m enarf_gan_tpu_torch.data_preprocess.surreal.preprocess \
        --data_path <dir> [--write_path data/surreal] [--smpl_dir smpl_data] \
        [--device cpu]

Each clip's first frame and its segmentation mask (cv2 and scipy on the
host), and its SMPL pose: the forward kinematics on the GPU (``--device``
names another device), rotated by zrot, shifted to the joints3D
annotation, axes permuted ([1, 2, 0] and negated), then the 180² crop
around the hips resized to 128² with K = [[600, 0, 160], [0, 600, 120]]
rebased.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device
from enarf_gan_tpu_torch.data.cache import save_cache_npz
from enarf_gan_tpu_torch.geometry.smpl import smpl_forward

IMG_SIZE = 128
CROP_SIZE = 180
K_FULL = np.array([[600, 0, 160], [0, 600, 120], [0, 0, 1]], dtype=np.float64)


def load_smpl_models(smpl_dir):
    models = {}
    for gender in ("male", "female"):
        path = os.path.join(smpl_dir, f"SMPL_{gender.upper()}.npz")
        if os.path.exists(path):
            models[gender] = dict(np.load(path))
    if not models:
        raise FileNotFoundError(
            f"no SMPL_*.npz under {smpl_dir}; run convert_smpl_pkl.py first")
    return models


def first_video_frame(video_path):
    """Frame 0 of a SURREAL clip (BGR uint8, 240x320)."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    try:
        ok, frame = cap.read()
    finally:
        cap.release()
    return frame if ok else None


def foreground_mask(video_path):
    """Person mask of frame 0 from the clip's ``*_segm.mat`` sidecar."""
    import scipy.io
    segm = scipy.io.loadmat(video_path[:-4] + "_segm.mat", squeeze_me=True)
    return segm["segm_1"] > 0


def read_frame(video_path, return_mask=False):
    frame = first_video_frame(video_path)
    if frame is None or not return_mask:
        return frame, None
    mask = foreground_mask(video_path)
    return frame * mask[:, :, None], mask


def read_annotation(video_path):
    """The clip's ``*_info.mat``, parsed on the host: gender, pose (1, 24,
    3), betas (1, n), zrot, and the joints3D and camLoc annotation (None
    where the clip has no joints3D). A broken or incomplete sidecar raises
    here, before any device work."""
    import scipy.io
    annot = scipy.io.loadmat(video_path[:-4] + "_info.mat")
    joints3D = annot["joints3D"]
    return {"gender": ["female", "male"][int(annot["gender"][0, 0])],
            "poses": annot["pose"][:, 0].reshape(1, 24, 3),
            "betas": annot["shape"][None, :, 0],
            "zrot": float(annot["zrot"][0, 0]),
            "joints3D": joints3D[:, :, 0] if joints3D.ndim == 3 else None,
            "camLoc": annot["camLoc"]}


def pose_and_crop(annot, smpl_model, device=DEFAULT_DEVICE):
    """The clip's posed skeleton in the camera frame and its crop →
    (crop (x1, x2, y1, y2), pose (1, 24, 4, 4), rebased K, the joints in
    pixels), or Nones where the clip has no joints3D. ``annot`` is
    ``read_annotation``'s, ``smpl_model`` the model of its gender."""
    if annot["joints3D"] is None:
        return (None,) * 4
    zrot = annot["zrot"]
    A = smpl_forward(smpl_model, annot["poses"], annot["betas"], device)
    trans = np.array([[np.cos(zrot), -np.sin(zrot), 0, 0],
                      [np.sin(zrot), np.cos(zrot), 0, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]])
    A_new = np.matmul(trans, A)
    j3D = (annot["joints3D"] - annot["camLoc"]).mean(axis=1)
    j3D = j3D * np.array([1, -1, 1])
    j3D = j3D[[0, 2, 1]]
    shift = j3D - A_new[0, :, :3, 3].mean(axis=0)
    A_new[:, :, :3, 3] += shift
    A_new = A_new[:, :, [1, 2, 0, 3]] * np.array([-1, -1, -1, 1])[:, None]

    pose_3d = A_new[0, :, :3, 3:]
    pose_2d = np.matmul(K_FULL, pose_3d)
    pose_2d = pose_2d[:, :2, 0] / pose_2d[:, 2:, 0]
    center = pose_2d[[1, 2]].mean(axis=0).astype(int)
    x1, y1 = center[0] - CROP_SIZE // 2, center[1] - CROP_SIZE // 2
    crop = (x1, x1 + CROP_SIZE, y1, y1 + CROP_SIZE)
    resized_K = K_FULL.copy()
    resized_K[:2, 2] -= np.array([x1, y1])
    resized_K[:2] *= IMG_SIZE / CROP_SIZE
    return crop, A_new, resized_K, pose_2d


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--write_path", type=str, default="data/surreal")
    parser.add_argument("--smpl_dir", type=str, default="smpl_data")
    parser.add_argument("--segmentation", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="store the mask as a fourth channel "
                        "(VAE_cache; --no-segmentation: GAN_cache)")
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)

    import cv2
    device = resolve_device(args.device)
    smpl_models = load_smpl_models(args.smpl_dir)
    videos = sorted(glob.glob(f"{args.data_path}/*/*/*/*.mp4"))
    print(len(videos), "videos")

    imgs, poses, intrinsics = [], [], []
    for path in videos:
        try:  # a clip with broken files is reported and skipped
            frame, mask = read_frame(path, args.segmentation)
            annot = read_annotation(path)
            model = smpl_models[annot["gender"]]
        except Exception as e:
            print("invalid data:", path, e)
            continue
        crop, A_new, K, _ = pose_and_crop(annot, model, device)
        if crop is None or frame is None:
            print("invalid data:", path)
            continue
        x1, x2, y1, y2 = crop
        if x1 < 0 or y1 < 0 or x2 > frame.shape[1] or y2 > frame.shape[0]:
            print("crop out of bounds:", path)
            continue
        cropped = frame[y1:y2, x1:x2]
        resized = cv2.resize(cropped, (IMG_SIZE, IMG_SIZE),
                             interpolation=cv2.INTER_AREA)
        img = resized[:, :, ::-1].transpose(2, 0, 1)  # BGR→RGB, CHW
        if args.segmentation and mask is not None:
            m = cv2.resize(mask[y1:y2, x1:x2].astype("uint8"),
                           (IMG_SIZE, IMG_SIZE),
                           interpolation=cv2.INTER_NEAREST)
            img = np.concatenate([img, m[None] * 255], axis=0)
        imgs.append(img.astype(np.uint8))
        poses.append(A_new[0].astype(np.float32))
        intrinsics.append(K.astype(np.float32))

    name = "VAE_cache" if args.segmentation else "GAN_cache"
    out_dir = os.path.join(args.write_path, name)
    save_cache_npz(out_dir, imgs=np.stack(imgs),
                   camera_intrinsic=np.stack(intrinsics),
                   smpl_pose=np.stack(poses))
    canon_src = os.path.join(args.smpl_dir, "neutral_canonical.npy")
    if os.path.exists(canon_src):
        np.save(os.path.join(out_dir, "canonical.npy"), np.load(canon_src))
    print("wrote", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
