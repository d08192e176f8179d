"""SMPL forward kinematics in PyTorch (port of
``enarf_gan_tpu/geometry/smpl.py``), with its float64 numpy plain version.

``smpl_pose_transforms`` gives each joint's absolute 4x4 transform: the
rotation accumulated along the kinematic chain and, as translation, the
posed joint. It runs on the device its tensors lie on and computes in
float64, so no TF32 switch can change it (JAX pins its products to
``Precision.HIGHEST``). It regresses the joints without forming the shaped
vertices: the joint regressor is linear, so it regresses the template and
each shape direction once and blends the betas at the 24 joints, where
JAX forms (B, 6890, 3) vertices for every pose. ``smpl_forward`` is the
numpy entry point of the preprocessing scripts.

``rvec_to_matrix`` is the root rotation of a capture (``cv2.Rodrigues``'s
formula, float64); ``rodrigues`` is SMPL's, which adds ``eps`` before the
norm. The two differ by about ``eps`` and stay apart.

SMPL models are plain ``.npz`` files (``v_template``, ``shapedirs``,
``J_regressor``, ``parents``), as ``data_preprocess/convert_smpl_pkl.py``
writes them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device

# SMPL kinematic tree
SMPL_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
                         12, 13, 14, 16, 17, 18, 19, 20, 21])


def _skew(axis: torch.Tensor) -> torch.Tensor:
    """(N, 3) → (N, 3, 3) cross-product matrices."""
    rx, ry, rz = axis.unbind(1)
    zeros = torch.zeros_like(rx)
    return torch.stack([zeros, -rz, ry,
                        rz, zeros, -rx,
                        -ry, rx, zeros], dim=1).reshape(-1, 3, 3)


def rodrigues(axis_angle: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (N, 3) → rotation matrices (N, 3, 3), SMPL's form:
    the angle is the norm of ``axis_angle + eps``."""
    angle = torch.linalg.norm(axis_angle + eps, dim=1, keepdim=True)
    K = _skew(axis_angle / angle)
    cos = torch.cos(angle)[:, :, None]
    sin = torch.sin(angle)[:, :, None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + sin * K + (1 - cos) * (K @ K)


def rvec_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (N, 3) → (N, 3, 3) in float64 by
    ``cv2.Rodrigues``'s formula: θ = |r|, R = cos θ I + (1 - cos θ) k kᵀ
    + sin θ [k]×, and the identity where θ is below float64's epsilon."""
    rvec = rvec.to(torch.float64)
    theta = torch.linalg.norm(rvec, dim=1)
    small = theta < np.finfo(np.float64).eps
    k = rvec / torch.where(small, 1.0, theta)[:, None]
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    eye = torch.eye(3, dtype=torch.float64, device=rvec.device)
    R = c * eye + (1 - c) * k[:, :, None] * k[:, None, :] + s * _skew(k)
    return torch.where(small[:, None, None], eye, R)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor
                 ) -> torch.Tensor:
    """(B, n_betas) x (V, 3, n_betas) → (B, V, 3) displacements."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor
                    ) -> torch.Tensor:
    """(J, V) x (B, V, 3) → (B, J, 3)."""
    return torch.einsum("jv,bvk->bjk", J_regressor, vertices)


def rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                    parents: np.ndarray) -> torch.Tensor:
    """Kinematic chain: (B, J, 3, 3) local rotations and (B, J, 3) rest
    joints → (B, J, 4, 4) absolute transforms (translation = posed
    joints)."""
    parents = np.asarray(parents)
    B, J = joints.shape[:2]
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]],
                    dim=1)
    top = torch.cat([rot_mats, rel[:, :, :, None]], dim=3)
    bottom = rot_mats.new_tensor([0, 0, 0, 1]).expand(B, J, 1, 4)
    local = torch.cat([top, bottom], dim=2)
    chains = [local[:, 0]]
    for j in range(1, J):
        chains.append(chains[parents[j]] @ local[:, j])
    return torch.stack(chains, dim=1)


def smpl_pose_transforms(betas: torch.Tensor, full_pose: torch.Tensor,
                         v_template: torch.Tensor, shapedirs: torch.Tensor,
                         J_regressor: torch.Tensor,
                         parents: Optional[np.ndarray] = None,
                         pose2rot: bool = True) -> torch.Tensor:
    """SMPL forward pass → (B, J, 4, 4) joint transforms in
    ``full_pose``'s dtype, computed in float64 on the tensors' device.

    betas (B, n_betas); full_pose (B, J*3) axis-angle (``pose2rot``) or
    (B, J, 3, 3) rotations; v_template (V, 3); shapedirs (V, 3, n_betas);
    J_regressor (J, V). The joints are the regressed template plus the
    betas blended over the regressed shape directions: the same sums as
    regressing each pose's shaped vertices, in another order, and no
    (B, V, 3) array.
    """
    if parents is None:
        parents = SMPL_PARENTS
    f64 = torch.float64
    B = full_pose.shape[0]
    regressed = vertices2joints(
        J_regressor.to(f64),
        torch.cat([v_template.to(f64)[None],
                   shapedirs.to(f64).permute(2, 0, 1)]))  # (1 + L, J, 3)
    joints = regressed[0] + blend_shapes(betas.to(f64),
                                         regressed[1:].permute(1, 2, 0))
    pose = full_pose.to(f64)
    if pose2rot:
        rot_mats = rodrigues(pose.reshape(-1, 3)).reshape(B, -1, 3, 3)
    else:
        rot_mats = pose.reshape(B, -1, 3, 3)
    return rigid_transform(rot_mats, joints, parents).to(full_pose.dtype)


def smpl_forward(model: Dict[str, np.ndarray], poses: np.ndarray,
                 betas: Optional[np.ndarray] = None,
                 device=DEFAULT_DEVICE) -> np.ndarray:
    """Numpy in and out: (B, 24, 3) or (B, 72) axis-angle poses and (B,
    n_betas) betas (zeros when None) of the SMPL ``model`` (the npz's
    arrays) → (B, 24, 4, 4) float32 joint transforms, computed on
    ``device`` (the GPU unless the caller names another; no fallback)."""
    device = resolve_device(device)
    poses = np.asarray(poses, np.float32).reshape(len(poses), -1)
    if betas is None:
        betas = np.zeros((len(poses), model["shapedirs"].shape[-1]),
                         np.float32)
    to = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    A = smpl_pose_transforms(
        to(np.asarray(betas, np.float32)), to(poses), to(model["v_template"]),
        to(model["shapedirs"]), to(model["J_regressor"]), model["parents"])
    return A.cpu().numpy()


def move_to_origin(bone_pose: torch.Tensor, scale: float = 0.5
                   ) -> torch.Tensor:
    """JAX's ``move_to_origin``, expression for expression. Its hip index
    ``out[:, [1, 2], :3, 3]`` puts the hips' axis first (numpy's rule for
    advanced indices split by a slice; torch puts it second, hence the
    transpose), so the mean runs over the batch: a batch of 2 has its
    first skeleton shifted by the batch's mean left hip and its second by
    the mean right hip, scaled, and any other batch size raises. No script
    of either package calls it (ROADMAP Queue 3)."""
    left_hip, right_hip = 1, 2
    out = bone_pose.clone()
    hips = out[:, [left_hip, right_hip], :3, 3].transpose(0, 1)  # (2, B, 3)
    trans = hips.mean(dim=1, keepdim=True)
    out[:, :, :3, 3] = (out[:, :, :3, 3] - trans) * scale
    return out


def axis_transformation(bone_pose: torch.Tensor,
                        axis_transformation=(1, -1, -1)) -> torch.Tensor:
    """Flip the coordinate axes of (J, 4, 4) transforms in place: their
    first three rows, times ``axis_transformation``."""
    bone_pose[:, :3] *= bone_pose.new_tensor(axis_transformation)[None, :,
                                                                 None]
    return bone_pose


def canonical_pose_from_rest_joints(rest_joints: np.ndarray) -> np.ndarray:
    """Zero-pose canonical transforms: identity rotations, translations =
    joints centered on the mean of the two hips."""
    J = rest_joints.shape[0]
    pose = np.tile(np.eye(4, dtype=np.float32)[None], (J, 1, 1))
    pose[:, :3, 3] = rest_joints - rest_joints[[1, 2]].mean(axis=0,
                                                            keepdims=True)
    return pose.astype(np.float32)


# --- plain versions, in numpy (dtype kept; the fixtures and the tests) ---

def rodrigues_plain(axis_angle: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """``rodrigues`` in numpy."""
    angle = np.linalg.norm(axis_angle + eps, axis=1, keepdims=True)
    axis = axis_angle / angle
    cos = np.cos(angle)[:, :, None]
    sin = np.sin(angle)[:, :, None]
    rx, ry, rz = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = np.zeros_like(rx)
    K = np.stack([zeros, -rz, ry,
                  rz, zeros, -rx,
                  -ry, rx, zeros], axis=1).reshape(-1, 3, 3)
    eye = np.eye(3, dtype=axis_angle.dtype)[None]
    return eye + sin * K + (1 - cos) * (K @ K)


def rigid_transform_plain(rot_mats: np.ndarray, joints: np.ndarray,
                          parents: np.ndarray) -> np.ndarray:
    """``rigid_transform`` in numpy."""
    parents = np.asarray(parents)
    B, J = joints.shape[:2]
    rel = np.concatenate(
        [joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]], axis=1)
    top = np.concatenate([rot_mats, rel[:, :, :, None]], axis=3)
    bottom = np.broadcast_to(np.array([0, 0, 0, 1], rot_mats.dtype),
                             (B, J, 1, 4))
    local = np.concatenate([top, bottom], axis=2)
    chains = [local[:, 0]]
    for j in range(1, J):
        chains.append(chains[parents[j]] @ local[:, j])
    return np.stack(chains, axis=1)


def smpl_pose_transforms_plain(betas, full_pose, v_template, shapedirs,
                               J_regressor, parents=None) -> np.ndarray:
    """The forward pass in float64 numpy, the textbook way: each distinct
    row of betas shapes the vertices, the regressor takes the joints from
    them. (B, J, 4, 4) float64."""
    if parents is None:
        parents = SMPL_PARENTS
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    betas, full_pose = f64(betas), f64(full_pose)
    v_template, shapedirs = f64(v_template), f64(shapedirs)
    V, _, L = shapedirs.shape
    rows, which = np.unique(betas.reshape(len(betas), L), axis=0,
                            return_inverse=True)
    v_shaped = v_template[None] + (rows @ shapedirs.reshape(V * 3, L).T
                                   ).reshape(-1, V, 3)
    joints = (f64(J_regressor) @ v_shaped)[which.reshape(-1)]
    B = len(full_pose)
    rot_mats = rodrigues_plain(full_pose.reshape(-1, 3)).reshape(B, -1, 3, 3)
    return rigid_transform_plain(rot_mats, joints, parents)


def rvec_to_matrix_plain(rvec: np.ndarray) -> np.ndarray:
    """``rvec_to_matrix`` in float64 numpy."""
    rvec = np.asarray(rvec, np.float64)
    theta = np.linalg.norm(rvec, axis=1)
    small = theta < np.finfo(np.float64).eps
    k = rvec / np.where(small, 1.0, theta)[:, None]
    c, s = np.cos(theta)[:, None, None], np.sin(theta)[:, None, None]
    kx, ky, kz = k[:, 0], k[:, 1], k[:, 2]
    zeros = np.zeros_like(kx)
    K = np.stack([zeros, -kz, ky, kz, zeros, -kx, -ky, kx, zeros],
                 axis=1).reshape(-1, 3, 3)
    R = c * np.eye(3) + (1 - c) * k[:, :, None] * k[:, None, :] + s * K
    return np.where(small[:, None, None], np.eye(3), R)
