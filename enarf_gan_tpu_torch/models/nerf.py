"""Unarticulated NeRF baselines (port of ``enarf_gan_tpu/models/nerf.py``):
``MLPNeRF`` and ``TriPlaneNeRF``, single-frame models with no bones. No
generator or config reaches them; they complete the model family. Both
return the raw density logit, zero outside the unit cube, as the JAX
models do. Their heads are ``TriPlaneNARF``'s (``density_fc``, ``mlp``);
``MLPNeRF``'s ``density_mlp`` keeps the JAX model's flax paths
(``EqualConv1d_{i}``) and ``TriPlaneNeRF``'s StyleGAN2 is ``generator``,
the JAX name.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device
from enarf_gan_tpu_torch.geometry.encoding import (in_cube,
                                                   positional_encoding,
                                                   to_local)
from enarf_gan_tpu_torch.models.narf import NARFParams, _DensityColorHeads
from enarf_gan_tpu_torch.nn.layers import MLP
from enarf_gan_tpu_torch.nn.stylegan2 import StyleGAN2Generator
from enarf_gan_tpu_torch.ops.triplane import sample_feature


class MLPNeRF(_DensityColorHeads):
    """PE of the frame-local position → an 8-layer ``MLP`` → the heads."""

    def __init__(self, params: NARFParams, z_dim: int, z2_dim: int,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        p = self.params = params
        hidden = p.hidden_size
        self.density_mlp = MLP(3 * p.num_frequency_for_position * 2, hidden,
                               hidden, num_layers=8, skips=(4,),
                               device=device)
        self._init_heads(hidden, hidden // 2, z2_dim, device)

    def density_color(self, position, pose_to_camera, z, z_rend,
                      ray_direction=None):
        """position (B, 3, n), pose_to_camera (B, 1, 4, 4) → (density
        (B, 1, n), color (B, 3, n) | None)."""
        local = to_local(position, pose_to_camera)            # (B, 3, n)
        enc = positional_encoding(local,
                                  self.params.num_frequency_for_position)
        density, color = self.heads(self.density_mlp(enc), z_rend,
                                    ray_direction)
        return density * in_cube(local).any(dim=1, keepdim=True), color


class TriPlaneNeRF(_DensityColorHeads):
    """One feature tri-plane (constant, or a StyleGAN2's from z) sampled at
    the frame-local position → the heads."""

    def __init__(self, params: NARFParams, z_dim: int, z2_dim: int,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        p = self.params = params
        ts = p.tri_plane_size
        if p.constant_triplane:
            self.tri_plane = nn.Parameter(torch.empty(1, p.feat_dim * 3, ts,
                                                      ts, device=device))
        else:
            self.generator = StyleGAN2Generator(
                size=ts, z_dim=z_dim, style_dim=p.w_dim, n_mlp=8,
                out_channels=p.feat_dim * 3, channel_max=max(p.w_dim, 64),
                device=device)
        self._init_heads(p.feat_dim, 64, z2_dim, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if hasattr(self, "tri_plane"):
            with torch.no_grad():
                self.tri_plane.zero_()

    def compute_tri_plane_feature(self, z, truncation_psi=1.0):
        """(B, F*3, ts, ts) planes."""
        if self.params.constant_triplane:
            return self.tri_plane.expand(z.shape[0], -1, -1, -1)
        return self.generator(z, truncation_psi=truncation_psi)

    def density_color(self, position, pose_to_camera, tri_plane_feature,
                      z_rend, ray_direction=None):
        """position (B, 3, n), pose_to_camera (B, 1, 4, 4), planes from
        ``compute_tri_plane_feature`` → (density (B, 1, n), color (B, 3, n)
        | None)."""
        local = to_local(position, pose_to_camera)            # (B, 3, n)
        validity = in_cube(local)                             # (B, 1, n)
        masked = torch.where(validity, local, torch.full_like(local, 2.0))
        feature = sample_feature(tri_plane_feature, masked,
                                 clamp_mask=self.params.clamp_mask)
        density, color = self.heads(feature, z_rend, ray_direction)
        return density * validity, color
