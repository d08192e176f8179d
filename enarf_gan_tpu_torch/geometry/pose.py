"""Skeleton re-rooting, rotation and interpolation (port of
``enarf_gan_tpu/geometry/pose.py``).

``transform_pose`` and the rotations run on tensors; the canonical-pose
registration (``transform_canonical_pose``) and ``interpolate_pose`` are
host-side numpy (and scipy), as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

HEAD_ID = 15  # SMPL head joint, used by origin_location == "center+head"


def transform_pose(pose_to_camera: torch.Tensor, bone_length: torch.Tensor,
                   origin_location: str, parent_id
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-root per-joint frames (B, J, 4, 4) to one frame per bone.

    "center": child rotation; "center_fixed": parent rotation; both with the
    translation at the midpoint of child and parent. "center+head" appends
    the head frame and a unit bone length.
    """
    parent = torch.as_tensor(np.asarray(parent_id)[1:], dtype=torch.long,
                             device=pose_to_camera.device)
    child_t = pose_to_camera[:, 1:, :, 3:]
    parent_t = pose_to_camera[:, parent, :, 3:]
    mid_t = (child_t + parent_t) / 2
    if origin_location == "center":
        out = torch.cat([pose_to_camera[:, 1:, :, :3], mid_t], dim=-1)
    elif origin_location == "center_fixed":
        out = torch.cat([pose_to_camera[:, parent, :, :3], mid_t], dim=-1)
    elif origin_location == "center+head":
        bone_length = torch.cat(
            [bone_length, bone_length.new_ones((bone_length.shape[0], 1, 1))],
            dim=1)
        base = torch.cat([pose_to_camera[:, parent, :, :3], mid_t], dim=-1)
        out = torch.cat([base, pose_to_camera[:, HEAD_ID][:, None]], dim=1)
    else:
        raise ValueError(f"unknown origin_location {origin_location!r}")
    return out, bone_length


def transform_canonical_pose(pose: np.ndarray, parent_id: np.ndarray,
                             origin_location: str
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(24, 4, 4) canonical joint transforms → (re-rooted frames (K, 4, 4),
    bone lengths (K,)), float32."""
    parent_id = np.asarray(parent_id)
    coord = pose[:, :3, 3]
    length = np.linalg.norm(coord[1:] - coord[parent_id[1:]], axis=1)
    mid = (pose[1:, :, 3:] + pose[parent_id[1:], :, 3:]) / 2
    if origin_location == "center":
        out = np.concatenate([pose[1:, :, :3], mid], axis=-1)
    elif origin_location == "center_fixed":
        out = np.concatenate([pose[parent_id[1:], :, :3], mid], axis=-1)
    elif origin_location == "center+head":
        length = np.concatenate([length, np.ones(1)])
        base = np.concatenate([pose[parent_id[1:], :, :3], mid], axis=-1)
        out = np.concatenate([base, pose[HEAD_ID][None]], axis=0)
    else:
        raise ValueError(f"unknown origin_location {origin_location!r}")
    return out.astype(np.float32), length.astype(np.float32)


def rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Rotations about y as (B, 4, 4)."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([c, z, -s, z,
                     z, o, z, z,
                     s, z, c, z,
                     z, z, z, o], dim=-1)
    return R.reshape(theta.shape[0], 4, 4)


def rotate_pose(pose_3d: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Rotate (B, J, 4, 4) poses by (B, 4, 4) about their mean joint. The
    products are sums of elementwise products, exact in the tensors' dtype
    whatever the TF32 switch (JAX's are at ``Precision.HIGHEST``)."""
    center = torch.zeros_like(pose_3d[:, :1])
    center[:, 0, :3, 3:] = pose_3d[:, :, :3, 3:].mean(dim=1)
    centred = pose_3d - center
    rotated = (R[:, None, :, :, None] * centred[:, :, None, :, :]).sum(dim=3)
    return rotated + center


def rotate_pose_by_angle(pose_3d: torch.Tensor, angle: torch.Tensor
                         ) -> torch.Tensor:
    return rotate_pose(pose_3d, rotation_matrix(angle))


def rotate_pose_randomly(generator: torch.Generator, pose_3d: torch.Tensor
                         ) -> torch.Tensor:
    """Each pose about y by an angle drawn uniformly from [0, 2π) with
    ``generator`` (on the poses' device)."""
    angle = torch.rand(pose_3d.shape[0], generator=generator,
                       dtype=pose_3d.dtype, device=pose_3d.device) * (2 * np.pi)
    return rotate_pose_by_angle(pose_3d, angle)


def interpolate_pose(pose_3d: np.ndarray, parents: np.ndarray, num: int = 100,
                     loop: bool = True) -> np.ndarray:
    """Slerp of each joint's rotation relative to its parent, and linear
    translations, among key poses (num_pose, J, 4, 4) → (num, J, 4, 4);
    ``loop`` returns from the last key pose to the first."""
    from scipy.spatial.transform import Rotation as R
    from scipy.spatial.transform import Slerp

    num_pose, num_parts, _, _ = pose_3d.shape
    parent_mat = pose_3d[:, parents[1:]]
    parent_mat = np.concatenate(
        [np.tile(np.eye(4)[None, None], (num_pose, 1, 1, 1)), parent_mat],
        axis=1)
    child = np.einsum("pjik,pjkl->pjil", np.linalg.inv(parent_mat), pose_3d)

    interp_rel = []
    for i in range(num_parts):
        if loop:
            key_rots = np.concatenate(
                [child[:, i, :3, :3], child[:1, i, :3, :3]], axis=0)
            key_times = np.arange(num_pose + 1)
            times = np.arange(num) * num_pose / num
            trans = np.concatenate([
                np.linspace(child[j, i, :3, 3],
                            child[(j + 1) % num_pose, i, :3, 3],
                            num // num_pose, endpoint=False)
                for j in range(num_pose)], axis=0)
        else:
            key_rots = child[:, i, :3, :3]
            key_times = np.arange(num_pose)
            times = np.arange(num) * (num_pose - 1) / (num - 1)
            trans = np.concatenate([
                np.linspace(child[j, i, :3, 3], child[j + 1, i, :3, 3],
                            num // (num_pose - 1), endpoint=True)
                for j in range(num_pose - 1)], axis=0)
        rots = Slerp(key_times, R.from_matrix(key_rots))(times).as_matrix()
        mat = np.concatenate([rots, trans[:, :, None]], axis=2)
        mat = np.concatenate([mat, np.tile([[[0, 0, 0, 1]]], (num, 1, 1))],
                             axis=1)
        interp_rel.append(mat)
    interp_rel = np.array(interp_rel)  # (J, num, 4, 4)

    out = []
    for i in range(num):
        pose = []
        for j in range(num_parts):
            mat = np.eye(4) if parents[j] == -1 else pose[parents[j]]
            pose.append(mat @ interp_rel[j, i])
        out.append(np.stack(pose))
    return np.stack(out)
