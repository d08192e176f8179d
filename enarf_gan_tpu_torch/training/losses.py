"""Training losses (port of the photometric half of
``enarf_gan_tpu/training/losses.py``; the GAN losses come with the GAN
slice)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def gather_pixels(img: torch.Tensor, ray_idx: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W) + flat pixel indices (B, n) → (B, C, n)."""
    B, C, H, W = img.shape
    idx = ray_idx.long()[:, None, :].expand(B, C, ray_idx.shape[-1])
    return img.reshape(B, C, H * W).gather(2, idx)


def photometric_loss(ray_idx: torch.Tensor, nerf_color: torch.Tensor,
                     nerf_mask: torch.Tensor, img: torch.Tensor,
                     mask: Optional[torch.Tensor], loss_type: str = "mse",
                     color_coef: float = 1.0, mask_coef: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth pixels at the sampled rays against the render:
    (color loss, mask loss). ``loss_type`` "mse", or "mae" (absolute error
    floored at 0.01)."""
    sampled_color = gather_pixels(img, ray_idx)
    if loss_type == "mse":
        loss_color = ((sampled_color - nerf_color) ** 2).mean() * color_coef
    elif loss_type == "mae":
        loss_color = torch.clamp_min((sampled_color - nerf_color).abs(),
                                     0.01).mean() * color_coef
    else:
        raise ValueError(loss_type)
    if mask is not None:
        B = mask.shape[0]
        sampled_mask = mask.reshape(B, -1).gather(1, ray_idx.long())
        loss_mask = ((sampled_mask - nerf_mask) ** 2).mean() * mask_coef
    else:
        loss_mask = torch.zeros((), device=nerf_color.device)
    return loss_color, loss_mask
