"""What the evaluation scripts share: the snapshot's generator, and a
batch of poses rendered through it."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from enarf_gan_tpu_torch.models.generator import (TriNARFGenerator,
                                                  register_canonical_pose)
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training import gan


def out_dir_of(config) -> str:
    return os.path.join(config.out_root, "result", config.out)


def truncation_suffix(truncation: float) -> str:
    """The metric file's suffix: none at truncation 1, else _trunc<t>."""
    return "" if truncation == 1 else f"_trunc{truncation}"


def load_generator(config, num_bone: int, parents, canonical_pose,
                   device, iteration: int = -1) -> TriNARFGenerator:
    """The config's generator alone on ``device``, its canonical pose
    registered and the weights of the latest snapshot (or
    ``snapshot_<iteration>.pth`` for an iteration above 0) loaded; raises
    without it. The discriminator is not built: scoring needs none."""
    out_dir = out_dir_of(config)
    path = ckpt.latest_checkpoint(out_dir) if iteration <= 0 else \
        os.path.join(out_dir, f"snapshot_{iteration}.pth")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained model is not loading: no snapshot "
            f"{'' if iteration <= 0 else f'of iteration {iteration} '}"
            f"in {out_dir}")
    gen = gan.build_generator(config, num_bone, parents, device)
    register_canonical_pose(gen, np.asarray(canonical_pose),
                            gen.nerf_params.origin_location, gen.parent_id)
    ckpt.load_gen_state_dict(
        gen, ckpt.load_checkpoint(path, map_location=device)["gen"])
    return gen


@torch.no_grad()
def render_batch(gen: TriNARFGenerator, batch: Dict[str, np.ndarray],
                 rng: torch.Generator, truncation: float = 1.0,
                 **forward_kw):
    """Render a loader's batch of poses (pose_to_camera, pose_to_world,
    bone_length, intrinsics) from z of ``rng`` (then the fine sampler's and
    the background's draws, from the same generator): the forward's
    (image, mask, aux) on the generator's device."""
    device = next(gen.parameters()).device
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)  # noqa: E731
    B = len(batch["bone_length"])
    z = torch.randn((B, gen.z_dim * 4), generator=rng, device=device)
    inv_k = np.linalg.inv(np.asarray(batch["intrinsics"], np.float32))
    return gen(to(batch["pose_to_camera"]), to(batch["pose_to_world"]),
               to(batch["bone_length"]), z, to(inv_k),
               truncation_psi=truncation, generator=rng, **forward_kw)
