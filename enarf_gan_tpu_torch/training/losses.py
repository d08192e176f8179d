"""Training losses (port of ``enarf_gan_tpu/training/losses.py``): the
adversarial losses and R1, the bone-guided mask losses of the GAN, and the
photometric loss of DSO."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


# ----------------------------- adversarial ----------------------------- #

def adv_loss_dis(real: torch.Tensor, fake: torch.Tensor, adv_loss_type: str,
                 tmp: float = 1.0) -> torch.Tensor:
    if adv_loss_type == "hinge":
        return F.relu(1 - real).mean() + F.relu(1 + fake).mean()
    if adv_loss_type == "ce":
        return F.softplus(-real * tmp).mean() + F.softplus(fake * tmp).mean()
    raise ValueError(f"{adv_loss_type} is not supported")


def adv_loss_gen(fake: torch.Tensor, adv_loss_type: str,
                 tmp: float = 1.0) -> torch.Tensor:
    if adv_loss_type == "hinge":
        return -fake.mean()
    if adv_loss_type == "ce":
        return F.softplus(-fake * tmp).mean()
    raise ValueError(f"{adv_loss_type} is not supported")


def r1_penalty(dis: Callable[[torch.Tensor], torch.Tensor],
               real_img: torch.Tensor) -> torch.Tensor:
    """R1 gradient penalty ||d D(x) / dx||², batch mean; differentiable in
    D's parameters (the gradient is taken with ``create_graph``)."""
    x = real_img.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(dis(x).sum(), x, create_graph=True)
    return (grad.reshape(x.shape[0], -1) ** 2).sum(dim=1).mean()


# --------------------------- bone-guided mask --------------------------- #

def push_to_background(fake_mask: torch.Tensor,
                       background_ratio: float = 0.3) -> torch.Tensor:
    """The bottom ``background_ratio`` of the fake mask's values, pushed
    towards 0 (their mean square)."""
    if background_ratio <= 0:
        return fake_mask.new_zeros(())
    flat = fake_mask.reshape(-1)
    k = int(flat.shape[0] * background_ratio)
    bottom = torch.topk(flat, k, largest=False, sorted=False).values
    return (bottom ** 2).mean()


def nerf_bone_loss(fake_mask: torch.Tensor,
                   bone_mask: torch.Tensor) -> torch.Tensor:
    """The rendered mask must cover the bone mask (max-pooled down to the
    render's size)."""
    if fake_mask.dim() != bone_mask.dim():
        raise ValueError("fake and bone masks differ in rank")
    if fake_mask.shape[-1] != bone_mask.shape[-1]:
        rate = bone_mask.shape[-1] // fake_mask.shape[-1]
        bone_mask = F.max_pool2d(bone_mask[:, None], rate, rate)[:, 0]
    binary = (bone_mask > 0.5).to(fake_mask.dtype)
    return ((1 - fake_mask) ** 2 * binary).sum() / binary.sum()


def nerf_patch_loss(fake_mask: torch.Tensor, bone_mask: torch.Tensor,
                    background_ratio: float = 0.3,
                    coef: float = 10.0) -> torch.Tensor:
    return (push_to_background(fake_mask, background_ratio)
            + nerf_bone_loss(fake_mask, bone_mask)) * coef


def triplane_l2_reg(tri_plane_feature: torch.Tensor) -> torch.Tensor:
    return (tri_plane_feature ** 2).mean()


# ----------------------------- photometric ----------------------------- #


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
