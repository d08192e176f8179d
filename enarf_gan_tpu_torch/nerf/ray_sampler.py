"""Ray samplers (port of the full-image grid of
``enarf_gan_tpu/nerf/ray_sampler.py``; the training samplers come with DSO
training)."""
from __future__ import annotations

from typing import Tuple

import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE


def image_grid_coords(render_size: int, patch_size: int, batchsize: int,
                      dtype=torch.float32, device=DEFAULT_DEVICE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Homogeneous pixel-centre coordinates of a full image grid.

    Returns (grid (B, P, P, 2) in [-1, 1], homo_img (B, 1, 3, P*P)).
    """
    ar = torch.arange(patch_size, dtype=dtype, device=device)
    y, x = torch.meshgrid(ar, ar, indexing="ij")
    rays = torch.stack([x, y], dim=2)[None]                # (1, P, P, 2)
    rays = render_size * (rays + 0.5) / patch_size
    rays = rays.expand(batchsize, patch_size, patch_size, 2)
    grid = rays / (render_size / 2) - 1
    flat = rays.reshape(batchsize, -1, 2).permute(0, 2, 1)  # (B, 2, P*P)
    ones = torch.ones((batchsize, 1, patch_size * patch_size), dtype=dtype,
                      device=device)
    homo = torch.cat([flat, ones], dim=1).reshape(batchsize, 1, 3, -1)
    return grid, homo
