"""Synthetic articulated scene and dataset cache in numpy (port of
``enarf_gan_tpu/data/fixtures.py`` and ``__graft_entry__._tiny_scene``).

A deterministic 24-joint SMPL-topology skeleton, smooth per-joint motion and
a camera ring: enough to drive the renderer without a dataset, and, with
bone-mask images, to train on (``make_synthetic_human_cache``); with
disparity maps, to score the depth evaluation (``make_synthetic_depth_cache``);
and a tiny SMPL model to run the preprocessing on (``make_synthetic_smpl_npz``).
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
                                               rigid_transform_plain,
                                               rodrigues_plain)


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
        rots = rodrigues_plain(aa)
        poses.append(rigid_transform_plain(rots[None], rest_joints[None],
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


def make_synthetic_smpl_npz(path: str, seed: int = 0, n_betas: int = 2,
                            n_vertices: int = 96) -> Dict:
    """Write a synthetic SMPL-like model npz (the keys of
    ``data_preprocess/convert_smpl_pkl.py``): ``n_vertices`` vertices in 24
    contiguous blocks, one around each rest joint, and a non-negative,
    row-normalised regressor that averages each joint's block, corrected so
    that it returns the synthetic rest skeleton at zero betas. The default
    96 (4 a joint) is the JAX package's fixture, value for value; SMPL's
    6,890 gives a model at full size."""
    rs = np.random.RandomState(seed + 7)
    rest = synthetic_rest_joints(seed)
    V = n_vertices
    owner = np.arange(V) * 24 // V                    # the block's joint
    v_template = (rest[owner]
                  + rs.uniform(-0.02, 0.02, (V, 3))).astype(np.float32)
    J_regressor = np.zeros((24, V), np.float32)
    J_regressor[owner, np.arange(V)] = 1 / np.bincount(owner)[owner]
    v_template += (rest - J_regressor @ v_template)[owner]
    shapedirs = rs.uniform(-0.01, 0.01, (V, 3, n_betas)).astype(np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, v_template=v_template, shapedirs=shapedirs,
             J_regressor=J_regressor, parents=np.asarray(SMPL_PARENTS))
    return {"rest_joints": rest, "n_vertices": V}


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


def make_synthetic_depth_cache(data_root: str, size: int = 64,
                               n_items: int = 4, seed: int = 0) -> Dict:
    """Write a SURREAL-style depth cache (the NARF_GAN_depth_cache layout of
    ``data_preprocess/surreal/preprocess_depth.py``) and its canonical.npy:
    each item's disparity map, intrinsics and SMPL pose in the camera frame
    (SURREAL's poses are camera-space), from a camera ring around the
    synthetic skeleton."""
    rest = synthetic_rest_joints(seed)
    world_poses = synthetic_pose_sequence(rest, n_items, seed + 1)
    extrinsics = camera_ring(n_items)
    focal = size * 1.2
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                 np.float32)
    hpp = SMPLProperty()
    disps, poses = [], []
    for i in range(n_items):
        pose_cam = extrinsics[i][None] @ world_poses[i]
        jpi = pose_to_image_coord(pose_cam, K)
        jm, jp = add_blank_part(pose_cam[None], jpi)
        disparity, _, _, _ = create_mask(hpp, jm, jp, size,
                                         thickness=max(size / 64, 1.0))
        disps.append(disparity.astype(np.float32))
        poses.append(pose_cam.astype(np.float32))
    save_cache_npz(data_root, disparity=np.stack(disps),
                   camera_intrinsic=np.stack([K] * n_items),
                   smpl_pose=np.stack(poses))
    canonical = canonical_pose_from_rest_joints(rest)
    np.save(os.path.join(data_root, "canonical.npy"), canonical)
    return {"canonical_pose": canonical, "n_items": n_items}
