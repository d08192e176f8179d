"""On-disk dataset cache (the port's own copy of
``enarf_gan_tpu/data/cache.py``).

``cache.npz`` holds imgs uint8 (N, C, H, W) (C = 4 with the mask as
alpha), camera_intrinsic (N, 3, 3), smpl_pose (N, 24, 4, 4) and, optional,
camera_rotation (N, 3, 3), camera_translation (N, 3, 1), frame_id (N,) and
disparity (N, H, W). The reference's ``cache.pickle`` with blosc-packed
images is read too where ``blosc`` is installed (imported only then).
``load_sample_data`` reads the demo's poses and cameras (``sample_data``).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np


class ImageStore:
    """Per-image access over a stacked array or a list of blosc packs."""

    def __init__(self, packed_list=None, array=None):
        if (packed_list is None) == (array is None):
            raise ValueError("give packed_list or array")
        self._packed = packed_list
        self._array = array

    def __len__(self):
        return len(self._packed) if self._packed is not None \
            else len(self._array)

    def __getitem__(self, i) -> np.ndarray:
        if self._packed is not None:
            import blosc
            return blosc.unpack_array(self._packed[i])
        return self._array[i]


def load_cache(data_root: str) -> Dict:
    """Load a dataset cache directory (cache.npz, or cache.pickle)."""
    npz_path = os.path.join(data_root, "cache.npz")
    pkl_path = os.path.join(data_root, "cache.pickle")
    if os.path.exists(npz_path):
        out = dict(np.load(npz_path, allow_pickle=False))
        if "imgs" in out:
            out["img"] = ImageStore(array=out["imgs"])
        if "disparity" in out:
            out["disparity"] = ImageStore(array=out["disparity"])
        return out
    if os.path.exists(pkl_path):
        with open(pkl_path, "rb") as f:
            out = dict(pickle.load(f))
        if "img" in out:
            out["img"] = ImageStore(packed_list=out["img"])
        if isinstance(out.get("disparity"), list):
            out["disparity"] = ImageStore(packed_list=out["disparity"])
        return out
    raise FileNotFoundError(f"no cache.npz or cache.pickle under {data_root}")


def save_cache_npz(data_root: str, **arrays) -> str:
    os.makedirs(data_root, exist_ok=True)
    path = os.path.join(data_root, "cache.npz")
    np.savez_compressed(path, **arrays)
    return path


def load_sample_data(path: str):
    """The demo's samples, a list of dicts (pose_3d, bone_length,
    intrinsics, ...): a pickled list of dicts, or an ``.npz`` of stacked
    arrays (``path`` with or without the suffix)."""
    if path.endswith(".npz") or os.path.exists(path + ".npz"):
        p = path if path.endswith(".npz") else path + ".npz"
        data = dict(np.load(p))
        n = len(next(iter(data.values())))
        return [{k: v[i] for k, v in data.items()} for i in range(n)]
    with open(path, "rb") as f:
        return pickle.load(f)
