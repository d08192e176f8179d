"""Ray samplers (port of ``enarf_gan_tpu/nerf/ray_sampler.py``).

* ``image_grid_coords``: every pixel centre of a full image;
* ``mask_based_sampler``: rays biased to the dilated foreground mask
  (max-pool of width 129 + uniform noise + top-k), the DSO training sampler
  of the exact path;
* ``patch_based_sampler``: the same at the granularity of whole PxP pixel
  patches, for the patch-tiled path.

The uniform noise comes from a ``torch.Generator`` or is given as
``noise`` (the tests feed JAX's draws); ``torch.topk(sorted=True)`` keeps
``lax.top_k``'s order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


DILATE = 64     # reference ray_sampler.py:24: a max-pool of width 129


def _maxpool2d_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W) max pool, stride 1, padding k // 2 with -inf; separable
    (a row pass then a column pass), which gives the same maxima."""
    pad = k // 2
    x = F.max_pool2d(x[:, None], (1, k), stride=1, padding=(0, pad))
    return F.max_pool2d(x, (k, 1), stride=1, padding=(pad, 0))[:, 0]


def _uniform(shape, noise: Optional[torch.Tensor],
             generator: Optional[torch.Generator], device) -> torch.Tensor:
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise must be {tuple(shape)}, got "
                             f"{tuple(noise.shape)}")
        return noise.to(device)
    if generator is None:
        raise ValueError("the sampler needs noise or a generator")
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def _homogeneous(ray_idx: torch.Tensor, w: int) -> torch.Tensor:
    """Flat pixel indices (B, n) → pixel centres (B, 1, 3, n)."""
    B, n = ray_idx.shape
    x = (ray_idx % w).float()
    y = torch.div(ray_idx, w, rounding_mode="floor").float()
    rays = torch.stack([x, y], dim=1) + 0.5                # (B, 2, n)
    ones = torch.ones((B, 1, n), dtype=rays.dtype, device=rays.device)
    return torch.cat([rays, ones], dim=1).reshape(B, 1, 3, n)


def mask_based_sampler(mask: torch.Tensor, ray_batchsize: int,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``ray_batchsize`` pixels biased to the dilated foreground mask.

    Args:
        mask: (B, H, W) in [0, 1].
        noise: (B, H*W) uniforms in [0, 1), or None to draw them from
            ``generator``.
    Returns:
        (ray_idx (B, n) int64 flat pixel indices, homo_img (B, 1, 3, n)).
    """
    B, h, w = mask.shape
    n = min(ray_batchsize, h * w)     # small images take every ray
    dilated = _maxpool2d_same(mask.float(), DILATE * 2 + 1)
    scores = dilated.reshape(B, h * w)
    scores = scores + _uniform(scores.shape, noise, generator, mask.device)
    ray_idx = torch.topk(scores, n, dim=1, sorted=True).indices
    return ray_idx, _homogeneous(ray_idx, w)


def patch_based_sampler(mask: torch.Tensor, ray_batchsize: int, P: int,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``ray_batchsize // P²`` whole PxP pixel patches biased to the
    dilated foreground mask (a patch scores the maximum dilated value of its
    pixels).

    The budget rounds down to whole patches (at least one) and is capped at
    the image's patch count. ``noise``: (B, n_patches of the image) uniforms
    or None to draw them from ``generator``.
    Returns (ray_idx (B, n) int64 flat pixel indices in patch-major order,
    homo_img (B, 1, 3, n)).
    """
    B, h, w = mask.shape
    if h % P or w % P:
        raise ValueError(f"image {h}x{w} is not whole {P}x{P} patches")
    n_patch = min(max(ray_batchsize // (P * P), 1), (h // P) * (w // P))
    dilated = _maxpool2d_same(mask.float(), DILATE * 2 + 1)
    ps = dilated.reshape(B, h // P, P, w // P, P).amax(dim=(2, 4)) \
        .reshape(B, -1)
    ps = ps + _uniform(ps.shape, noise, generator, mask.device)
    pidx = torch.topk(ps, n_patch, dim=1, sorted=True).indices   # (B, np)
    py = torch.div(pidx, w // P, rounding_mode="floor")
    px = pidx % (w // P)
    d = torch.arange(P, device=mask.device)
    yy = py[:, :, None, None] * P + d.view(1, 1, P, 1)
    xx = px[:, :, None, None] * P + d.view(1, 1, 1, P)
    ray_idx = (yy * w + xx).reshape(B, -1)                 # (B, np*P*P)
    return ray_idx, _homogeneous(ray_idx, w)
