"""2-D bone-mask rasterizer in numpy (the port's own copy of
``enarf_gan_tpu/data/mask2d.py``).

Produces the skeleton masks the pose-prior dataset feeds the GAN's
bone-guided loss (behavioral spec: reference dataset/utils_3d.py:5-70 and
dataset/dataset.py:12-25,76-78). The outputs are a wire format the loss
depends on, so the *predicates* match the reference exactly (same capsule
inequality, same depth interpolation); the implementation is restructured
around a vectorized capsule-rasterization helper.
"""
from __future__ import annotations

import numpy as np


class SMPLProperty:
    """Bone topology constants for mask drawing (reference dataset/dataset.py:12-25)."""

    def __init__(self):
        self.is_blank = np.array([0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
                                  1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1])
        self.num_bone = 19
        self.prev_seq = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 11, 9, 10,
                         11, 12, 13, 16, 17, 18, 20, 21, 22, 23, 24, 25]
        self.num_joint = self.num_bone
        self.num_not_blank_bone = int(np.sum(self.is_blank == 0))
        self.valid_keypoints = [i for i in range(len(self.is_blank))
                                if i not in self.prev_seq or self.is_blank[i] == 0]
        self.num_valid_keypoints = len(self.valid_keypoints)


def pose_to_image_coord(pose_to_camera: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """(n_joint, 4, 4) + (3, 3) → (1, 3, n_joint) image coords (reference utils_3d.py:5-10)."""
    coord = pose_to_camera[:, :3, 3]
    coord = coord / coord[:, 2:3]
    coord = coord.transpose()[None]
    return np.matmul(intrinsics, coord)


def add_blank_part(joint_mat_camera: np.ndarray, joint_pos_image: np.ndarray):
    """Insert duplicated joints for blank parts (reference dataset/dataset.py:76-78)."""
    idx = [0, 0] + list(range(10)) + [9, 9] + list(range(10, 24))
    return joint_mat_camera[:, idx], joint_pos_image[:, :, idx]


def _rasterize_capsules(starts_2d: np.ndarray, ends_2d: np.ndarray,
                        pixels: np.ndarray, thickness: float):
    """Coverage of every pixel by every thick 2-D segment ("capsule").

    A pixel c is covered by segment (a→b) when its projection parameter
    lies in [0, 1] and its perpendicular distance is within ``thickness``.
    Both tests are evaluated in the cross-multiplied form
    ``proj² ≥ |ab|²·(|ac|² − th²)`` so degenerate/borderline pixels resolve
    identically to the reference rasterizer (utils_3d.py:26-35).

    Args:
        starts_2d / ends_2d: (P, 2) segment endpoints in pixel coords.
        pixels: (n_pix, 2) pixel centers.
    Returns:
        covered: (P, n_pix) float {0,1}; seg_param: (P, n_pix) unclamped
        projection parameter along each segment (0 at start, 1 at end).
    """
    seg_vec = starts_2d - ends_2d                            # (P, 2), b - a
    rel = pixels[None] - ends_2d[:, None]                    # (P, n_pix, 2)
    proj = np.einsum("pni,pi->pn", rel, seg_vec)             # ac·ab
    seg_len2 = (seg_vec ** 2).sum(axis=1)[:, None]           # |ab|²
    dist2 = (rel ** 2).sum(axis=2)                           # |ac|²
    covered = ((0 <= proj) * (proj <= seg_len2)
               * (proj ** 2 >= seg_len2 * (dist2 - thickness ** 2))
               * (seg_len2 > 1e-8))
    seg_param = proj / (seg_len2 + 1e-10)
    return covered, seg_param


def _perspective_disparity(seg_param: np.ndarray, z_end: np.ndarray,
                           z_start: np.ndarray, covered: np.ndarray):
    """Per-pixel inverse depth along each covered segment.

    The image-space parameter is perspective-corrected back to a 3-D
    parameter before interpolating camera z (reference utils_3d.py:38-44).
    """
    num = seg_param * z_end[:, None]
    t3d = num / (num + (1 - seg_param) * z_start[:, None])
    z = z_end[:, None] * (1 - t3d) + z_start[:, None] * t3d
    return 1 / (z + 1e-8) * covered


def _keypoint_boxes(points_2d: np.ndarray, size: int, thickness: float):
    """One square box mask per keypoint, clipped to the image (vectorized)."""
    lo = np.ceil(points_2d - thickness).astype(int)          # (V, 2) x,y
    hi = np.ceil(points_2d + thickness).astype(int)
    xs = np.arange(size)
    on = (hi[:, 0:1] >= 0) & (hi[:, 1:2] >= 0)               # (V, 1)
    in_x = (xs[None] >= np.maximum(lo[:, 0:1], 0)) & (xs[None] < hi[:, 0:1])
    in_y = (xs[None] >= np.maximum(lo[:, 1:2], 0)) & (xs[None] < hi[:, 1:2])
    return (in_y[:, :, None] & in_x[:, None, :] & on[:, :, None]
            ).astype(np.float64)


def create_mask(hpp: SMPLProperty, joint_mat_camera: np.ndarray,
                joint_pos_image: np.ndarray, size: int, thickness: float = 1.5):
    """Rasterize thick 2-D bone segments into mask / disparity channels.

    Args:
        joint_mat_camera: (1, n_joint28, 4, 4) camera-frame transforms
            (after add_blank_part).
        joint_pos_image: (1, 3, n_joint28) projected joints.
    Returns:
        (disparity (S,S), mask (S,S), part_bone_disparity (P,S,S),
         keypoint_mask (V,S,S)) — all float32.
    """
    prev = np.asarray(hpp.prev_seq)
    # each bone i>0 is the segment from its parent joint to joint i
    ends = joint_pos_image[0, :2, 1:].transpose(1, 0)            # (P, 2)
    starts = joint_pos_image[0, :2][:, prev[1:]].transpose(1, 0)
    z_ends = joint_mat_camera[0, 1:, :3, 3][:, 2]
    z_starts = joint_mat_camera[0][prev[1:], :3, 3][:, 2]

    gx, gy = np.meshgrid(np.arange(size), np.arange(size))
    pixels = np.stack([gx, gy], axis=2).reshape(-1, 2)           # (S*S, 2)

    covered, seg_param = _rasterize_capsules(starts, ends, pixels, thickness)
    part_disp = _perspective_disparity(seg_param, z_ends, z_starts, covered)

    disparity = part_disp.max(axis=0).reshape(size, size)
    mask = np.clip(covered.sum(axis=0), 0, 1).reshape(size, size)

    # blank bones contribute to their parent's part channel
    owner = np.array([prev[i] if hpp.is_blank[i] else i
                      for i in hpp.prev_seq if i >= 0])
    part_bone_disparity = np.array(
        [part_disp[owner == o].max(axis=0) for o in sorted(set(owner))]
    ).reshape(-1, size, size)

    keypoints = joint_pos_image[0, :2].transpose(1, 0)[hpp.valid_keypoints]
    keypoint_mask = _keypoint_boxes(keypoints, size, thickness)

    return (disparity.astype(np.float32), mask.astype(np.float32),
            part_bone_disparity.astype(np.float32),
            keypoint_mask.astype(np.float32))
