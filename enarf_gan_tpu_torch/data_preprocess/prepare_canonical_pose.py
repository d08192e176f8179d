"""Zero-pose canonical joint transforms → ``{gender}_canonical.npy`` (the
port's counterpart of ``data_preprocess/prepare_canonical_pose.py``).

    python -m enarf_gan_tpu_torch.data_preprocess.prepare_canonical_pose \
        --smpl_dir smpl_data --out_dir smpl_data [--device cpu]

For each of ``SMPL_{MALE,FEMALE,NEUTRAL}.npz`` found, the forward
kinematics at zero pose and zero betas on the GPU (``--device`` names
another device), the translations centred on the mean of the two hips.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from enarf_gan_tpu_torch import DEFAULT_DEVICE
from enarf_gan_tpu_torch.geometry.smpl import smpl_forward


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--smpl_dir", type=str, default="smpl_data",
                        help="directory with SMPL_{GENDER}.npz models")
    parser.add_argument("--out_dir", type=str, default="smpl_data")
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)

    written = []
    for gender in ["MALE", "FEMALE", "NEUTRAL"]:
        path = os.path.join(args.smpl_dir, f"SMPL_{gender}.npz")
        if not os.path.exists(path):
            print(f"skip {gender}: {path} not found")
            continue
        model = dict(np.load(path))
        A = smpl_forward(model, np.zeros((1, 24 * 3), np.float32),
                         device=args.device)[0]
        A[:, :3, 3] -= A[[1, 2], :3, 3].mean(axis=0, keepdims=True)
        out = os.path.join(args.out_dir, f"{gender.lower()}_canonical.npy")
        np.save(out, A.astype(np.float32))
        print("wrote", out)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
