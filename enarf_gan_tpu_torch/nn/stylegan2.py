"""StyleGAN2 generator: mapping + skip-architecture synthesis (port of the
generator half of ``enarf_gan_tpu/nn/stylegan2.py``).

It serves as the deformation-flow generator of the DSO model
(``models/narf.py``). Parameters carry the reference's stylegan2-ada names
(``mapping.fc0.weight``, ``synthesis.b4.const``, ``synthesis.b8.conv0.weight``,
``synthesis.b8.conv0.affine.weight``, ``synthesis.b8.torgb.bias``, ...).

Up-convolutions keep the reference's orientation: the weight is used as a
stride-2 transposed convolution, which is the JAX package's lhs-dilated
convolution with the kernel flipped in both spatial axes (the flip that
``export_reference_state_dict`` applies).

Not ported yet (ROADMAP Queue 1, item 6): noise inputs, style mixing,
truncation, the background crop, the discriminator and the pretrained
background.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from enarf_gan_tpu_torch import DEFAULT_DEVICE

from enarf_gan_tpu_torch.nn.layers import EqualLinear, _normal_, pixel_norm
from enarf_gan_tpu_torch.ops.upfirdn import make_blur_kernel, upfirdn2d

BLUR_KERNEL = (1, 3, 3, 1)


def channels_dict(channel_multiplier: int = 2, channel_max: int = 512) -> dict:
    """Per-resolution channel counts, capped at ``channel_max``."""
    base = {4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier}
    return {k: min(v, channel_max) for k, v in base.items()}


class MappingNetwork(nn.Module):
    """z (+ conditioning c) → w: pixel norm, then ``num_layers``
    equalized layers at learning-rate multiplier 0.01."""

    def __init__(self, z_dim: int, style_dim: int, num_layers: int = 8,
                 c_dim: int = 0, device=DEFAULT_DEVICE):
        super().__init__()
        self.c_dim = c_dim
        if c_dim > 0:
            self.embed = EqualLinear(c_dim, style_dim, device=device)
        in_dim = z_dim + (style_dim if c_dim > 0 else 0)
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"fc{i}", EqualLinear(
                in_dim if i == 0 else style_dim, style_dim, lr_mul=0.01,
                activation=True, device=device))

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        h = pixel_norm(z, dim=1)
        if self.c_dim > 0:
            if c is None or c.shape[1] != self.c_dim:
                raise ValueError(f"mapping needs conditioning of width "
                                 f"{self.c_dim}")
            h = torch.cat([h, pixel_norm(self.embed(c), dim=1)], dim=1)
        for i in range(self.num_layers):
            h = getattr(self, f"fc{i}")(h)
        return h


class _ModulatedConv2d(nn.Module):
    """Style-modulated kxk conv (weight (out, in, k, k) and ``affine``),
    demodulated by rsqrt(sum of squares), optionally a 2x up-conv + blur."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 kernel_size: int = 3, demodulate: bool = True,
                 upsample: bool = False, device=DEFAULT_DEVICE):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k,
                                               device=device))
        self.affine = EqualLinear(style_dim, in_channels, bias_init=1.0,
                                  device=device)
        self.kernel_size, self.demodulate, self.upsample = k, demodulate, upsample
        self.scale = 1 / math.sqrt(in_channels * k * k)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)

    def modulated_conv(self, x: torch.Tensor, style_w: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        s = self.affine(style_w)                            # (B, C)
        x = x * s[:, :, None, None]
        w = self.weight * self.scale
        if self.upsample:
            y = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        else:
            y = F.conv2d(x, w, padding=k // 2)
        if self.demodulate:
            d = torch.rsqrt(torch.einsum("oikl,bi->bo", w ** 2, s ** 2) + 1e-8)
            y = y * d[:, :, None, None]
        if self.upsample:
            kernel = make_blur_kernel(BLUR_KERNEL, upsample_factor=2)
            p = kernel.shape[0] - 2 - (k - 1)
            y = upfirdn2d(y, kernel, pad=((p + 1) // 2 + 1, p // 2 + 1))
        return y


class StyledConv2d(_ModulatedConv2d):
    """Modulated conv + bias + LeakyReLU(0.2)*sqrt(2), no noise input."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 kernel_size: int = 3, upsample: bool = False,
                 device=DEFAULT_DEVICE):
        super().__init__(in_channels, out_channels, style_dim, kernel_size,
                         upsample=upsample, device=device)
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, style_w: torch.Tensor) -> torch.Tensor:
        y = self.modulated_conv(x, style_w) + self.bias[None, :, None, None]
        return F.leaky_relu(y, 0.2) * 2 ** 0.5


class ToRGB(_ModulatedConv2d):
    """1x1 modulated conv (no demodulation) + bias, plus the upsampled skip."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 device=DEFAULT_DEVICE):
        super().__init__(in_channels, out_channels, style_dim, 1,
                         demodulate=False, device=device)
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, style_w: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.modulated_conv(x, style_w) + self.bias[None, :, None, None]
        if skip is not None:
            kernel = make_blur_kernel(BLUR_KERNEL, upsample_factor=2)
            p = kernel.shape[0] - 2
            y = y + upfirdn2d(skip, kernel, up=2,
                              pad=((p + 1) // 2 + 1, p // 2))
        return y


class _SynthesisBlock(nn.Module):
    """One resolution: ``conv0`` (2x up, absent at 4²) or ``const`` (4²),
    ``conv1`` and ``torgb``."""

    def __init__(self, res: int, in_ch: int, out_ch: int, out_channels: int,
                 style_dim: int, device=DEFAULT_DEVICE):
        super().__init__()
        if res == 4:
            self.const = nn.Parameter(torch.empty(1, out_ch, 4, 4, device=device))
        else:
            self.conv0 = StyledConv2d(in_ch, out_ch, style_dim, upsample=True,
                                      device=device)
        self.conv1 = StyledConv2d(out_ch, out_ch, style_dim, device=device)
        self.torgb = ToRGB(out_ch, out_channels, style_dim, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if hasattr(self, "const"):
            _normal_(self.const, generator)


class SynthesisNetwork(nn.Module):
    """Skip-architecture synthesis; blocks ``b4``, ``b8``, ... ``b{size}``."""

    def __init__(self, size: int, style_dim: int, out_channels: int = 3,
                 channel_max: int = 512, device=DEFAULT_DEVICE):
        super().__init__()
        ch = channels_dict(channel_max=channel_max)
        self.log_size = int(math.log2(size))
        prev = ch[4]
        for res_log in range(2, self.log_size + 1):
            res = 2 ** res_log
            setattr(self, f"b{res}", _SynthesisBlock(
                res, prev, ch[res], out_channels, style_dim, device=device))
            prev = ch[res]

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, n_latent, style_dim) → (B, out_channels, size, size)."""
        b4 = self.b4
        out = b4.const.expand(latent.shape[0], -1, -1, -1)
        out = b4.conv1(out, latent[:, 0])
        skip = b4.torgb(out, latent[:, 1])
        i = 1
        for res_log in range(3, self.log_size + 1):
            blk = getattr(self, f"b{2 ** res_log}")
            out = blk.conv0(out, latent[:, i])
            out = blk.conv1(out, latent[:, i + 1])
            skip = blk.torgb(out, latent[:, i + 2], skip)
            i += 2
        return skip


class StyleGAN2Generator(nn.Module):
    """Mapping + synthesis, one style for every layer."""

    def __init__(self, size: int, z_dim: int, style_dim: int, n_mlp: int,
                 out_channels: int = 3, c_dim: int = 0, channel_max: int = 512,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.mapping = MappingNetwork(z_dim, style_dim, n_mlp, c_dim=c_dim,
                                      device=device)
        self.synthesis = SynthesisNetwork(size, style_dim, out_channels,
                                          channel_max, device=device)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        w = self.mapping(z, c)
        return self.synthesis(w[:, None].expand(-1, self.synthesis.n_latent, -1))
