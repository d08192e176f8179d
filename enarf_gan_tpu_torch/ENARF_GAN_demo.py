"""ENARF-GAN sampling demo of the port (the counterpart of
``ENARF_GAN_demo.py``).

    python -m enarf_gan_tpu_torch.ENARF_GAN_demo \
        --config configs/enarfgan_demo/AIST/enarfgan.yml \
        --default_config configs/enarfgan_demo/default.yml \
        [--truncation 0.4] [--num_samples 10] [--black_bg] [--mesh]
        [--mesh_voxel_size 0.003] [--seed 0] [--device cpu]

Loads the latest snapshot under ``<out_root>/result/<out>`` (written by
``enarf_gan_tpu_torch.train_ENARF_GAN``), and for each sample of
``<sample_path>/sample_data.pickle`` (or ``sample_data.npz``:
pose_to_camera, pose_to_world, bone_length and intrinsics of each sample)
draws z, renders the image at ``--truncation`` on the card (``--device``
names another device) and writes ``samples/img_NNNN.png`` and
``samples/mask_NNNN.png`` there; with ``--mesh`` also the sample's mesh
(marching tetrahedra on a voxel grid of ``--mesh_voxel_size``) rasterised
at 512², ``samples/mesh_NNNN.png``. The canonical pose comes from the
config's ``canonical_pose_path`` (default
``smpl_data/neutral_canonical.npy``). Only the generator is built: the
demo configs name no discriminator.
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
from enarf_gan_tpu_torch.mesh.extract import gan_create_mesh
from enarf_gan_tpu_torch.mesh.raster import render_mesh_image
from enarf_gan_tpu_torch.models.generator import register_canonical_pose
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training import gan
from enarf_gan_tpu_torch.utils.logging import encode_png

MESH_RENDER_SIZE = 512


def _write_png(path: str, rgb: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
    return path


def demo(config, device=DEFAULT_DEVICE, truncation: float = 0.4,
         num_samples: int = 10, black_bg: bool = False, mesh: bool = False,
         mesh_voxel_size: float = 0.003, seed: int = 0) -> List[str]:
    """Sample the latest snapshot at the config's poses; returns the paths
    of the PNGs written."""
    size = config.dataset.image_size
    canonical_pose = np.load(config.get("canonical_pose_path",
                                        "smpl_data/neutral_canonical.npy"))
    gen = gan.build_generator(config, 24, SMPL_PARENTS, device)
    register_canonical_pose(gen, canonical_pose,
                            gen.nerf_params.origin_location, SMPL_PARENTS)
    sample_path = config.get("sample_path") or ""
    for name in ("sample_data.pickle", "sample_data.npz"):
        if os.path.exists(os.path.join(sample_path, name)):
            samples = load_sample_data(os.path.join(sample_path, name))
            break
    else:
        raise FileNotFoundError(f"no sample_data under {sample_path!r}")
    out_dir = os.path.join(config.out_root, "result", config.out)
    snap = ckpt.latest_checkpoint(out_dir)
    if snap is None:
        raise FileNotFoundError(f"model not loaded: no snapshot in {out_dir}")
    ckpt.load_gen_state_dict(
        gen, ckpt.load_checkpoint(snap, map_location=device)["gen"])

    save_dir = os.path.join(out_dir, "samples")
    os.makedirs(save_dir, exist_ok=True)
    z_dim = int(config.generator_params.z_dim)
    rng = torch.Generator(device=device).manual_seed(seed)
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.asarray(x, np.float32)[None]).to(device)
    paths = []
    for idx in range(min(num_samples, len(samples))):
        sample = samples[idx]
        z = torch.randn((1, z_dim * 4), generator=rng, device=device)
        pose, bl = to(sample["pose_to_camera"]), to(sample["bone_length"])
        intrinsics = np.asarray(sample["intrinsics"], np.float32)
        with torch.no_grad():
            img, mask, _ = gen(pose, to(sample["pose_to_world"]), bl, z,
                               to(np.linalg.inv(intrinsics)),
                               truncation_psi=truncation,
                               black_bg_if_possible=black_bg, generator=rng)
        arr = np.clip(img[0].cpu().numpy().transpose(1, 2, 0) * 127.5 + 127.5,
                      0, 255).astype(np.uint8)
        paths.append(_write_png(os.path.join(save_dir, f"img_{idx:0>4}.png"),
                                arr))
        marr = np.clip(mask[0].cpu().numpy() * 255, 0, 255).astype(np.uint8)
        paths.append(_write_png(os.path.join(save_dir, f"mask_{idx:0>4}.png"),
                                np.repeat(marr[:, :, None], 3, axis=2)))
        if mesh:
            verts, faces = gan_create_mesh(gen, pose, bl, z,
                                           voxel_size=mesh_voxel_size,
                                           truncation_psi=truncation)
            print(f"sample {idx}: mesh of {verts.shape[0]} vertices, "
                  f"{faces.shape[0]} faces")
            paths.append(_write_png(
                os.path.join(save_dir, f"mesh_{idx:0>4}.png"),
                render_mesh_image(verts, faces, intrinsics, img_size=size,
                                  render_size=MESH_RENDER_SIZE)))
    print(f"Images are saved to {save_dir}")
    return paths


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_demo/default.yml")
    parser.add_argument("--truncation", type=float, default=0.4)
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--black_bg", action="store_true")
    parser.add_argument("--mesh", action="store_true",
                        help="also extract and rasterise a mesh per sample")
    parser.add_argument("--mesh_voxel_size", type=float, default=0.003,
                        help="marching-tetrahedra voxel size")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)
    use_full_float32()
    return demo(yaml_config(args.config, args.default_config),
                torch.device(args.device), truncation=args.truncation,
                num_samples=args.num_samples, black_bg=args.black_bg,
                mesh=args.mesh, mesh_voxel_size=args.mesh_voxel_size,
                seed=args.seed)


if __name__ == "__main__":
    main()
