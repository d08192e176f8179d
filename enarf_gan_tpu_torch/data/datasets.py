"""Datasets over the on-disk cache, in numpy (the port's own copy of the
DSO datasets of ``enarf_gan_tpu/data/datasets.py``).

Items as the reference builds them: images normalised to [-1, 1],
pose_to_camera = extrinsic @ pose_to_world, bone lengths from the parent
joints, the mask from the alpha channel (or the not-white pixels), virtual
epochs of ``num_repeat_in_epoch`` passes. What only the GAN reads (bone
masks, random flips of images without bone parameters, the pose-prior and
depth datasets) comes with the GAN slice.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from enarf_gan_tpu_torch.data.cache import load_cache
from enarf_gan_tpu_torch.data.mask2d import SMPLProperty
from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS


def normalize_images(imgs: np.ndarray) -> np.ndarray:
    """uint8 → float32 in [-1, 1]: x / 127.5 - 1."""
    return np.asarray(imgs).astype(np.float32) / 127.5 - 1


def mask_from_alpha(alpha: np.ndarray) -> np.ndarray:
    return np.asarray(alpha).astype(np.float32) / 255.0


class HumanDatasetBase:
    def __init__(self, config, size=128, return_bone_params=True,
                 num_repeat_in_epoch=100, load_camera_intrinsics=False,
                 return_mask=False, **_):
        self.size = size
        self.num_repeat_in_epoch = num_repeat_in_epoch
        self.return_bone_params = return_bone_params
        self.return_mask = return_mask
        self.data_root = config.data_root
        self.config = config
        self.load_camera_intrinsics = load_camera_intrinsics
        self.parents = SMPL_PARENTS
        if return_bone_params:
            self.hpp = SMPLProperty()
            self.num_bone = 24
            self.num_bone_param = self.num_bone - 1
            self.num_valid_keypoints = self.hpp.num_valid_keypoints

    def __len__(self):
        return len(self.imgs) * self.num_repeat_in_epoch

    def get_bone_length(self, pose):
        coord = pose[:, :3, 3]
        length = np.linalg.norm(coord[1:] - coord[self.parents[1:]], axis=1)
        return length[:, None]

    def get_image(self, i):
        return self.imgs[i]

    def get_intrinsic(self, i):
        return self.intrinsics[i]

    def preprocess_img(self, img):
        return normalize_images(img)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        i = i % len(self.imgs)
        out: Dict[str, np.ndarray] = {}
        img = self.get_image(i)
        if img.shape[0] == 4:              # the alpha channel is the mask
            out["mask"] = mask_from_alpha(img[3]) if img.dtype == np.uint8 \
                else img[3].astype("float32")
            img = img[:3]
        elif self.return_mask:
            out["mask"] = (img != 255).any(axis=0).astype("float32")
        out.update({"img": self.preprocess_img(img),
                    "idx": np.int64(self.data_idx[i])})

        if self.return_bone_params:
            pose_to_camera = self.pose_to_camera[i].copy()
            pose_to_camera[:, 3, 3] = 1
            pose_to_world = self.pose_to_world[i].copy()
            pose_to_world[:, 3, 3] = 1
            bone_length = self.get_bone_length(pose_to_world)
            intrinsics = self.get_intrinsic(i)
            pose_2d = np.matmul(intrinsics, pose_to_camera[:, :3, 3:])
            pose_2d = (pose_2d[:, :2, 0] / pose_2d[:, 2:, 0]).astype("float32")
            out["pose_2d"] = pose_2d
            out["pose_3d"] = pose_to_camera.astype("float32")
            out["pose_3d_world"] = pose_to_world.astype("float32")
            out["bone_length"] = bone_length.astype("float32")
            out["intrinsics"] = intrinsics.astype("float32")
            out["pose_to_camera"] = out["pose_3d"]
            out["pose_to_world"] = out["pose_3d_world"]
        return out


class HumanDataset(HumanDatasetBase):
    def __init__(self, config, size=128, return_bone_params=True,
                 num_repeat_in_epoch=100, load_camera_intrinsics=True,
                 return_mask=False, **kwargs):
        super().__init__(config, size, return_bone_params,
                         num_repeat_in_epoch, load_camera_intrinsics,
                         return_mask)
        self.focal_length = getattr(config, "focal_length", None)
        self.load_cache_data()
        self.data_idx = np.arange(len(self.imgs))

    def load_cache_data(self):
        data = load_cache(self.data_root)
        self.imgs = data["img"]
        if self.return_bone_params:
            self.intrinsics = data["camera_intrinsic"] \
                if self.load_camera_intrinsics else None
            self.inv_intrinsics = np.linalg.inv(self.intrinsics) \
                if self.intrinsics is not None else None
            self.pose_to_world = data["smpl_pose"]
            n = len(self.imgs)
            extr = np.broadcast_to(np.eye(4, dtype=np.float64), (n, 4, 4)).copy()
            if "camera_rotation" in data:
                self.camera_rotation = data["camera_rotation"]
                extr[:, :3, :3] = data["camera_rotation"]
                extr[:, :3, 3:] = data["camera_translation"]
                self.pose_to_camera = np.matmul(extr[:, None],
                                                self.pose_to_world)
            else:
                self.pose_to_camera = self.pose_to_world
            canon = os.path.join(self.data_root, "canonical.npy")
            if os.path.exists(canon):
                self.canonical_pose = np.load(canon)
            if "frame_id" in data:
                self.frame_id = data["frame_id"]

    def get_intrinsic(self, i):
        if self.focal_length is None:
            return self.intrinsics[i]
        return np.array([[self.focal_length, 0, self.size / 2],
                         [0, self.focal_length, self.size / 2],
                         [0, 0, 1]], dtype="float32")


class SSODataset(HumanDataset):
    """The DSO dataset: adds the frame time and the camera rotation, and
    always the foreground mask (the photometric mask loss needs it)."""

    def __init__(self, *args, **kwargs):
        kwargs["return_mask"] = True
        super().__init__(*args, **kwargs)

    def __getitem__(self, i):
        out = super().__getitem__(i)
        i = i % len(self.imgs)
        out["frame_id"] = np.int64(self.frame_id[i])
        out["frame_time"] = np.float32(min(self.frame_id[i]
                                           / self.config.n_frames, 1))
        out["camera_rotation"] = self.camera_rotation[i].astype("float32")
        return out
