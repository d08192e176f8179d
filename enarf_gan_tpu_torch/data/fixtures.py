"""Synthetic articulated scene and dataset cache in numpy (port of
``enarf_gan_tpu/data/fixtures.py`` and ``__graft_entry__._tiny_scene``).

A deterministic 24-joint SMPL-topology skeleton, smooth per-joint motion and
a camera ring: enough to drive the renderer without a dataset, and, with
bone-mask images, to train on (``make_synthetic_human_cache``).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from enarf_gan_tpu_torch.data.cache import save_cache_npz
from enarf_gan_tpu_torch.data.mask2d import (SMPLProperty, add_blank_part,
                                             create_mask, pose_to_image_coord)
from enarf_gan_tpu_torch.geometry.smpl import (SMPL_PARENTS,
                                               canonical_pose_from_rest_joints,
                                               rigid_transform, rodrigues)


def synthetic_rest_joints(seed: int = 0) -> np.ndarray:
    """Plausible 24-joint rest skeleton (meters), deterministic."""
    rs = np.random.RandomState(seed)
    joints = np.zeros((24, 3), np.float32)
    for j in range(1, 24):
        offset = rs.uniform(-0.12, 0.12, 3).astype(np.float32)
        offset[1] += 0.08  # grow roughly upward
        joints[j] = joints[SMPL_PARENTS[j]] + offset
    return joints


def synthetic_pose_sequence(rest_joints: np.ndarray, n_frames: int,
                            seed: int = 1) -> np.ndarray:
    """(n_frames, 24, 4, 4) world transforms: the rest pose with smooth
    per-joint rotations about y."""
    rs = np.random.RandomState(seed)
    amp = rs.uniform(0, 0.4, 24).astype(np.float32)
    phase = rs.uniform(0, 2 * np.pi, 24).astype(np.float32)
    poses = []
    for f in range(n_frames):
        angle = amp * np.sin(2 * np.pi * f / max(n_frames, 1) + phase)
        aa = np.zeros((24, 3), np.float32)
        aa[:, 1] = angle
        rots = rodrigues(aa)
        poses.append(rigid_transform(rots[None], rest_joints[None],
                                     SMPL_PARENTS)[0])
    return np.stack(poses).astype(np.float32)


def camera_ring(n_camera: int, radius: float = 1.2,
                height: float = 0.0) -> np.ndarray:
    """(n_camera, 4, 4) world→camera extrinsics looking at the origin."""
    outs = []
    for i in range(n_camera):
        theta = 2 * np.pi * i / max(n_camera, 1)
        cam_pos = np.array([radius * np.sin(theta), height,
                            -radius * np.cos(theta)], np.float32)
        z_axis = -cam_pos / np.linalg.norm(cam_pos)
        up = np.array([0, 1, 0], np.float32)
        x_axis = np.cross(up, z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        R = np.stack([x_axis, y_axis, z_axis])
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = R
        E[:3, 3] = -R @ cam_pos
        outs.append(E)
    return np.stack(outs)


def tiny_scene(B: int, size: int, focal_scale: float = 1.2):
    """B posed frames seen from a camera ring, as the JAX bench builds them.

    Returns (pose_to_camera (B, 24, 4, 4), pose_to_world (B, 24, 4, 4),
    bone_length (B, 23, 1), inv_intrinsics (3, 3), canonical_pose
    (24, 4, 4), intrinsics (3, 3)), all float32 numpy.
    """
    rest = synthetic_rest_joints()
    world = synthetic_pose_sequence(rest, B)
    extr = camera_ring(B)
    pose_cam = np.einsum("bij,bkjl->bkil", extr, world).astype(np.float32)
    pose_cam[:, :, 3, :] = [0, 0, 0, 1]
    focal = size * focal_scale
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                 np.float32)
    coord = world[:, :, :3, 3]
    bl = np.linalg.norm(coord[:, 1:] - coord[:, SMPL_PARENTS[1:]],
                        axis=2)[:, :, None].astype(np.float32)
    canonical = canonical_pose_from_rest_joints(rest)
    return (pose_cam, world.astype(np.float32), bl, np.linalg.inv(K),
            canonical, K)


def make_synthetic_human_cache(data_root: str, size: int = 64,
                               n_frames: int = 4, n_camera: int = 3,
                               seed: int = 0) -> Dict:
    """Write a cache.npz of the synthetic articulated human seen from a
    camera ring, and its canonical.npy.

    Images are bone-mask renderings (grey in the mask, the mask as alpha):
    consistent across views, enough to overfit and to test the data path.
    """
    rest = synthetic_rest_joints(seed)
    world_poses = synthetic_pose_sequence(rest, n_frames, seed + 1)
    extrinsics = camera_ring(n_camera)
    focal = size * 1.2
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                 np.float32)
    hpp = SMPLProperty()
    imgs, intr, poses, rots, trans, frame_ids = [], [], [], [], [], []
    for f in range(n_frames):
        for c in range(n_camera):
            pose_cam = extrinsics[c][None] @ world_poses[f]
            jpi = pose_to_image_coord(pose_cam, K)
            jm, jp = add_blank_part(pose_cam[None], jpi)
            _, mask, _, _ = create_mask(hpp, jm, jp, size,
                                        thickness=max(size / 64, 1.0))
            gray = (mask * 200).astype(np.uint8)
            imgs.append(np.stack([gray, gray, gray,
                                  (mask * 255).astype(np.uint8)]))
            intr.append(K)
            poses.append(world_poses[f])
            rots.append(extrinsics[c][:3, :3])
            trans.append(extrinsics[c][:3, 3:])
            frame_ids.append(f)
    save_cache_npz(data_root, imgs=np.stack(imgs),
                   camera_intrinsic=np.stack(intr), smpl_pose=np.stack(poses),
                   camera_rotation=np.stack(rots),
                   camera_translation=np.stack(trans),
                   frame_id=np.array(frame_ids, np.int64))
    canonical = canonical_pose_from_rest_joints(rest)
    np.save(os.path.join(data_root, "canonical.npy"), canonical)
    return {"canonical_pose": canonical, "n_frames": n_frames,
            "n_camera": n_camera, "rest_joints": rest}
