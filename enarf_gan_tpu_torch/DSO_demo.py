"""DSO full-image demo of the port (the counterpart of ``DSO_demo.py``).

    python -m enarf_gan_tpu_torch.DSO_demo \
        --config configs/DSO_demo/ZJU/313_denarf.yml \
        --default_config configs/DSO_demo/default.yml [--render_bs 16384]

Loads the latest snapshot under ``<out_root>/result/<out>`` (written by
``enarf_gan_tpu_torch.train_DSO``), renders every sample of
``<sample_path>/sample_data.pickle`` (or ``sample_data.npz``: pose_3d,
bone_length and intrinsics of each sample) at frame time 1 on the card
(``--device`` names another device), and writes ``samples/NNNN.png``
there. The canonical pose comes from the config's ``canonical_pose_path``
(default ``smpl_data/neutral_canonical.npy``).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, use_full_float32
from enarf_gan_tpu_torch.config import yaml_config
from enarf_gan_tpu_torch.data.cache import load_sample_data
from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu_torch.models.generator import (make_dso_full_renderer,
                                                  register_canonical_pose)
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training import dso
from enarf_gan_tpu_torch.utils.logging import encode_png


def demo(config, device=DEFAULT_DEVICE, render_bs: int = 16384
         ) -> List[str]:
    """Render every sample of the config's ``sample_path`` with the latest
    snapshot; returns the paths of the PNGs written."""
    size = config.dataset.image_size
    config.generator_params.nerf_params.render_bs = render_bs
    canonical_pose = np.load(config.get("canonical_pose_path",
                                        "smpl_data/neutral_canonical.npy"))
    gen = dso.build_generator(config, 24, SMPL_PARENTS, device)
    register_canonical_pose(gen, canonical_pose,
                            gen.nerf_params.origin_location, SMPL_PARENTS)
    pickled = os.path.join(config.sample_path, "sample_data.pickle")
    samples = load_sample_data(
        pickled if os.path.exists(pickled)
        else os.path.join(config.sample_path, "sample_data.npz"))
    out_dir = os.path.join(config.out_root, "result", config.out)
    snap = ckpt.latest_checkpoint(out_dir)
    if snap is None:
        raise FileNotFoundError(f"model not loaded: no snapshot in {out_dir}")
    gen.load_state_dict(ckpt.load_checkpoint(snap, map_location=device)["gen"])

    bg_color = config.dataset.bg_color
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.asarray(x, np.float32)[None]).to(device)
    frame_time = torch.ones(1, device=device)
    save_dir = os.path.join(out_dir, "samples")
    os.makedirs(save_dir, exist_ok=True)
    renderer = make_dso_full_renderer(gen, size, ray_batchsize=render_bs)
    paths = []
    for idx, sample in enumerate(samples):
        color, mask, _ = renderer(
            to(sample["pose_3d"]),
            to(np.linalg.inv(np.asarray(sample["intrinsics"], np.float32))),
            frame_time, to(sample["bone_length"]),
            generator=torch.Generator(device=device).manual_seed(idx))
        img = (color + bg_color * (1 - mask)).cpu().numpy()
        img = np.clip(img.transpose(1, 2, 0) * 127.5 + 127.5, 0, 255) \
            .astype(np.uint8)
        paths.append(os.path.join(save_dir, f"{idx:0>4}.png"))
        with open(paths[-1], "wb") as f:
            f.write(encode_png(img))
    print(f"Images are saved to {save_dir}")
    return paths


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--default_config", type=str,
                        default="configs/DSO_demo/default.yml")
    parser.add_argument("--render_bs", type=int, default=16384)
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)
    use_full_float32()
    return demo(yaml_config(args.config, args.default_config),
                torch.device(args.device), args.render_bs)


if __name__ == "__main__":
    main()
