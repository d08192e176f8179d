"""StyleGAN2: mapping, skip-architecture synthesis and the discriminator
(port of ``enarf_gan_tpu/nn/stylegan2.py``).

Three generators of the models are StyleGAN2s, under two sets of names:

* ``StyleGAN2Generator`` (stylegan2-ada names: ``mapping.fc0.weight``,
  ``synthesis.b4.const``, ``synthesis.b8.conv0.weight``,
  ``synthesis.b8.conv0.affine.weight``, ``synthesis.b8.torgb.bias``, ...):
  the tri-plane generator of the GAN and the deformation-flow generator of
  the DSO model, both without noise inputs and with one style for every
  layer;
* ``BackgroundGenerator`` (the reference's rosinality names: ``style.1``,
  ``input.input``, ``conv1.conv.weight`` (1, out, in, k, k),
  ``conv1.noise.weight``, ``convs.0``, ``to_rgbs.0``, ...): the GAN's
  learned background, with noise inputs, style mixing and the crop of its
  twice-wide canvas.

Up-convolutions keep the reference's orientation: the weight is used as a
stride-2 transposed convolution, which is the JAX package's lhs-dilated
convolution with the kernel flipped in both spatial axes (the flip that
``export_reference_state_dict`` applies).

Both mappings keep ``w_avg``, the centre of truncation, as a buffer outside
the state dict (reference checkpoints do not hold it; ``interop`` carries
JAX's). Truncation is the JAX package's always-applied lerp
``w_avg + psi * (w - w_avg)``; ``update_w_avg`` moves ``w_avg`` towards the
batch's mean w (beta 0.995) before it is applied.

Random draws are arguments: the background's noise (one (B, 1, H, W) tensor
a styled conv, in the JAX package's order) and its crop offsets, or a
``torch.Generator`` that draws them.

``PretrainedStyleGAN`` is the frozen stylegan2-church background: a
``BackgroundGenerator`` under ``gen`` (rosinality's names, so a converted
``g_ema`` loads by name, ``training/checkpoint.py::
load_pretrained_background``), cropped to the image.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device

from enarf_gan_tpu_torch.nn.layers import (EqualConv2d, EqualLinear, _normal_,
                                           init_parameters, pixel_norm)
from enarf_gan_tpu_torch.ops.upfirdn import make_blur_kernel, upfirdn2d

BLUR_KERNEL = (1, 3, 3, 1)
W_AVG_BETA = 0.995


def channels_dict(channel_multiplier: int = 2, channel_max: int = 512) -> dict:
    """Per-resolution channel counts, capped at ``channel_max``."""
    base = {4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier}
    return {k: min(v, channel_max) for k, v in base.items()}


def _track_and_truncate(w: torch.Tensor, w_avg: torch.Tensor,
                        update_w_avg: bool, truncation_psi) -> torch.Tensor:
    """Optionally move ``w_avg`` (in place) towards the batch's mean w, then
    lerp w towards it by ``truncation_psi`` (1 keeps w)."""
    if update_w_avg:
        with torch.no_grad():
            mean_w = w.detach().mean(dim=0)
            w_avg.copy_(mean_w + (w_avg - mean_w) * W_AVG_BETA)
    return w_avg[None] + truncation_psi * (w - w_avg[None])


def _modulated_conv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                    demodulate: bool, upsample: bool) -> torch.Tensor:
    """x (B, C, H, W) scaled by the style s (B, C), convolved with the
    scaled weight w (out, C, k, k), demodulated by rsqrt(sum of squares);
    with ``upsample`` a 2x transposed conv followed by the FIR blur."""
    k = w.shape[-1]
    x = x * s[:, :, None, None]
    if upsample:
        y = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
    else:
        y = F.conv2d(x, w, padding=k // 2)
    if demodulate:
        d = torch.rsqrt(torch.einsum("oikl,bi->bo", w ** 2, s ** 2) + 1e-8)
        y = y * d[:, :, None, None]
    if upsample:
        kernel = make_blur_kernel(BLUR_KERNEL, upsample_factor=2)
        p = kernel.shape[0] - 2 - (k - 1)
        y = upfirdn2d(y, kernel, pad=((p + 1) // 2 + 1, p // 2 + 1))
    return y


def _upsample_skip(skip: torch.Tensor) -> torch.Tensor:
    kernel = make_blur_kernel(BLUR_KERNEL, upsample_factor=2)
    p = kernel.shape[0] - 2
    return upfirdn2d(skip, kernel, up=2, pad=((p + 1) // 2 + 1, p // 2))


def _lrelu(y: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(y, 0.2) * 2 ** 0.5


# --------------------------------------------------------------------- #
# stylegan2-ada names: the tri-plane and flow generators
# --------------------------------------------------------------------- #

class MappingNetwork(nn.Module):
    """z (+ conditioning c) → w: pixel norm, then ``num_layers``
    equalized layers at learning-rate multiplier 0.01; truncation towards
    ``w_avg``."""

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
        self.register_buffer("w_avg", torch.zeros(style_dim, device=device),
                             persistent=False)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                update_w_avg: bool = False, truncation_psi=1.0
                ) -> torch.Tensor:
        h = pixel_norm(z, dim=1)
        if self.c_dim > 0:
            if c is None or c.shape[1] != self.c_dim:
                raise ValueError(f"mapping needs conditioning of width "
                                 f"{self.c_dim}")
            h = torch.cat([h, pixel_norm(self.embed(c), dim=1)], dim=1)
        for i in range(self.num_layers):
            h = getattr(self, f"fc{i}")(h)
        return _track_and_truncate(h, self.w_avg, update_w_avg,
                                   truncation_psi)


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
        self.demodulate, self.upsample = demodulate, upsample
        self.scale = 1 / math.sqrt(in_channels * k * k)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)

    def modulated_conv(self, x: torch.Tensor, style_w: torch.Tensor) -> torch.Tensor:
        return _modulated_conv(x, self.weight * self.scale,
                               self.affine(style_w), self.demodulate,
                               self.upsample)


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
        return _lrelu(self.modulated_conv(x, style_w)
                      + self.bias[None, :, None, None])


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
            y = y + _upsample_skip(skip)
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

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi=1.0, update_w_avg: bool = False
                ) -> torch.Tensor:
        w = self.mapping(z, c, update_w_avg=update_w_avg,
                         truncation_psi=truncation_psi)
        return self.synthesis(w[:, None].expand(-1, self.synthesis.n_latent, -1))


# --------------------------------------------------------------------- #
# rosinality names: the learned background
# --------------------------------------------------------------------- #

class _NoiseInjection(nn.Module):
    def __init__(self, device=DEFAULT_DEVICE):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()


class _RosModulatedConv2d(nn.Module):
    """Modulated conv with the weight (1, out, in, k, k) and ``modulation``."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 kernel_size: int, demodulate: bool = True,
                 upsample: bool = False, device=DEFAULT_DEVICE):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(1, out_channels, in_channels,
                                               k, k, device=device))
        self.modulation = EqualLinear(style_dim, in_channels, bias_init=1.0,
                                      device=device)
        self.demodulate, self.upsample = demodulate, upsample
        self.scale = 1 / math.sqrt(in_channels * k * k)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)

    def forward(self, x: torch.Tensor, style_w: torch.Tensor) -> torch.Tensor:
        return _modulated_conv(x, self.weight[0] * self.scale,
                               self.modulation(style_w), self.demodulate,
                               self.upsample)


class _RosStyledConv(nn.Module):
    """Modulated conv, + noise_weight * noise, + bias (1, C, 1, 1), lrelu."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 upsample: bool = False, device=DEFAULT_DEVICE):
        super().__init__()
        self.conv = _RosModulatedConv2d(in_channels, out_channels, style_dim,
                                        3, upsample=upsample, device=device)
        self.noise = _NoiseInjection(device=device)
        self.bias = nn.Parameter(torch.empty(1, out_channels, 1, 1,
                                             device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, style_w, noise: Optional[torch.Tensor] = None):
        y = self.conv(x, style_w)
        if noise is not None:
            y = y + self.noise.weight * noise
        return _lrelu(y + self.bias)


class _RosToRGB(nn.Module):
    def __init__(self, in_channels: int, style_dim: int, out_channels: int = 3,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.conv = _RosModulatedConv2d(in_channels, out_channels, style_dim,
                                        1, demodulate=False, device=device)
        self.bias = nn.Parameter(torch.empty(1, out_channels, 1, 1,
                                             device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, style_w, skip: Optional[torch.Tensor] = None):
        y = self.conv(x, style_w) + self.bias
        if skip is not None:
            y = y + _upsample_skip(skip)
        return y


class _ConstantInput(nn.Module):
    def __init__(self, channels: int, hw: Tuple[int, int],
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channels, *hw, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.input, generator)


class BackgroundGenerator(nn.Module):
    """The GAN's learned background (the JAX ``StyleGAN2Generator`` with
    noise; with ``crop_background`` its constant is 4x8 and the canvas
    twice as wide, cropped to ``size``² at random in training and at the
    centre otherwise).

    ``forward(styles, inject_index=None, truncation_psi=1, noise=None,
    crop=None, train=False, generator=None)``: ``styles`` is one z or two
    (mixed at ``inject_index``, n_latent // 2 by default); ``noise`` one
    tensor a styled conv (``noise_shapes``) or None for none, unless
    ``generator`` draws it; ``crop`` the (y0, x0) of the training crop, or
    drawn from ``generator`` in training.
    """

    def __init__(self, size: int, style_dim: int, n_mlp: int,
                 out_channels: int = 3, crop_background: bool = False,
                 channel_max: int = 512, device=DEFAULT_DEVICE):
        super().__init__()
        ch = channels_dict(channel_max=channel_max)
        self.size, self.crop_background = size, crop_background
        self.log_size = int(math.log2(size))
        self.style = nn.ModuleDict({
            str(i + 1): EqualLinear(style_dim, style_dim, lr_mul=0.01,
                                    activation=True, device=device)
            for i in range(n_mlp)})
        self.register_buffer("w_avg", torch.zeros(style_dim, device=device),
                             persistent=False)
        self.const_hw = (4, 8 if crop_background else 4)
        self.input = _ConstantInput(ch[4], self.const_hw, device=device)
        self.conv1 = _RosStyledConv(ch[4], ch[4], style_dim, device=device)
        self.to_rgb1 = _RosToRGB(ch[4], style_dim, out_channels, device=device)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        prev = ch[4]
        for res_log in range(3, self.log_size + 1):
            c = ch[2 ** res_log]
            self.convs.append(_RosStyledConv(prev, c, style_dim, upsample=True,
                                             device=device))
            self.convs.append(_RosStyledConv(c, c, style_dim, device=device))
            self.to_rgbs.append(_RosToRGB(c, style_dim, out_channels,
                                          device=device))
            prev = c

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    def noise_shapes(self, B: int) -> List[Tuple[int, ...]]:
        """The (B, 1, H, W) shape of each styled conv's noise, in order:
        ``conv1``, then ``convs.0``, ``convs.1``, ..."""
        h, w = self.const_hw
        shapes = [(B, 1, h, w)]
        for r in range(3, self.log_size + 1):
            f = 2 ** (r - 2)
            shapes += [(B, 1, h * f, w * f)] * 2
        return shapes

    def mapping(self, z: torch.Tensor, update_w_avg: bool = False,
                truncation_psi=1.0) -> torch.Tensor:
        h = pixel_norm(z, dim=1)
        for i in range(len(self.style)):
            h = self.style[str(i + 1)](h)
        return _track_and_truncate(h, self.w_avg, update_w_avg,
                                   truncation_psi)

    def forward(self, styles: Sequence[torch.Tensor],
                inject_index: Optional[int] = None, truncation_psi=1.0,
                noise: Optional[Sequence[torch.Tensor]] = None,
                crop: Optional[Tuple[int, int]] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n_latent = self.n_latent
        B = styles[0].shape[0]
        ws = [self.mapping(s, truncation_psi=truncation_psi) for s in styles]
        if len(ws) < 2:
            latent = ws[0][:, None].expand(-1, n_latent, -1)
        else:
            if inject_index is None:
                inject_index = n_latent // 2
            latent = torch.cat(
                [ws[0][:, None].expand(-1, inject_index, -1),
                 ws[1][:, None].expand(-1, n_latent - inject_index, -1)],
                dim=1)
        if noise is None and generator is not None:
            noise = [torch.randn(s, generator=generator,
                                 device=generator.device).to(ws[0].device)
                     for s in self.noise_shapes(B)]
        noise = list(noise) if noise is not None \
            else [None] * (1 + len(self.convs))
        out = self.input.input.expand(B, -1, -1, -1)
        out = self.conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for j, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * j](out, latent[:, i], noise[2 * j + 1])
            out = self.convs[2 * j + 1](out, latent[:, i + 1], noise[2 * j + 2])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        if not self.crop_background:
            return skip
        size = self.size
        if crop is None and train and generator is not None:
            crop = tuple(int(torch.randint(0, m + 1, (), generator=generator,
                                           device=generator.device))
                         for m in (skip.shape[2] - size, skip.shape[3] - size))
        if train and crop is not None:
            y0, x0 = crop
            return skip[:, :, y0:y0 + size, x0:x0 + size]
        return skip[:, :, :, size // 2: size * 3 // 2]


class PretrainedStyleGAN(nn.Module):
    """The frozen stylegan2-church background (the JAX
    ``PretrainedStyleGAN``): a rosinality generator ``gen`` of
    ``gen_size``² (``n_mlp`` 8, noise inputs) whose one style is the
    concatenation of the styles it is given. Its full canvas is cropped to
    ``size``²: at random in training (``crop`` = (y0, x0), or drawn from
    ``generator``), else the top ``size`` rows and the centre ``size``
    columns. Its parameters take no gradient."""

    def __init__(self, size: int, gen_size: int = 256, style_dim: int = 512,
                 n_mlp: int = 8, channel_max: int = 512,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.size = size
        self.gen = BackgroundGenerator(gen_size, style_dim, n_mlp, 3,
                                       channel_max=channel_max, device=device)
        self.requires_grad_(False)

    @property
    def n_latent(self) -> int:
        return self.gen.n_latent

    def forward(self, styles: Sequence[torch.Tensor], inject_index: int,
                noise: Optional[Sequence[torch.Tensor]] = None,
                crop: Optional[Tuple[int, int]] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        img = self.gen([torch.cat(list(styles), dim=1)],
                       inject_index=inject_index, noise=noise,
                       generator=generator)
        size = self.size
        if crop is None and train and generator is not None:
            crop = tuple(int(torch.randint(0, m + 1, (), generator=generator,
                                           device=generator.device))
                         for m in (img.shape[2] - size, img.shape[3] - size))
        if train and crop is not None:
            y0, x0 = crop
            return img[:, :, y0:y0 + size, x0:x0 + size]
        c = img.shape[3] // 2
        return img[:, :, :size, c - size // 2: c + size // 2]


# --------------------------------------------------------------------- #
# discriminator
# --------------------------------------------------------------------- #

class ConvLayer(nn.Module):
    """EqualConv2d with an optional FIR-blur 2x downsample before it, then
    bias + LeakyReLU(0.2)*sqrt(2) (``activate``) or the conv's own bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, downsample: bool = False,
                 activate: bool = True, use_bias: bool = True,
                 device=DEFAULT_DEVICE):
        super().__init__()
        k = kernel_size
        self.downsample, self.activate = downsample, activate
        stride, padding = (2, 0) if downsample else (1, k // 2)
        self.conv = EqualConv2d(in_channels, out_channels, k, stride, padding,
                                use_bias=use_bias and not activate,
                                device=device)
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) \
            if activate and use_bias else None
        self.pad = (((4 - 2) + (k - 1) + 1) // 2, ((4 - 2) + (k - 1)) // 2)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = upfirdn2d(x, make_blur_kernel(BLUR_KERNEL), pad=self.pad)
        y = self.conv(x)
        if self.activate:
            if self.bias is not None:
                y = y + self.bias[None, :, None, None]
            y = _lrelu(y)
        return y


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3, device=device)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               device=device)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              activate=False, use_bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(x))
        return (h + self.skip(x)) / math.sqrt(2)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator with optional minibatch-std; twice
    differentiable (R1). Parameters carry the JAX module's names with dots
    (``from_rgb.conv.weight``, ``res{i}.conv1.bias``, ``final_linear0.*``);
    ``interop.load_flax_discriminator`` loads the JAX one's. Weights are
    drawn from ``generator`` (seed 0 when none is given)."""

    def __init__(self, size: int, in_dim: int = 3, minibatch_std: bool = True,
                 stddev_group: int = 4, channel_max: int = 512,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        ch = channels_dict(channel_max=channel_max)
        self.minibatch_std, self.stddev_group = minibatch_std, stddev_group
        log_size = int(math.log2(size))
        self.from_rgb = ConvLayer(in_dim, ch[size], 1, device=device)
        self.res_logs = list(range(log_size, 2, -1))
        prev = ch[size]
        for i in self.res_logs:
            setattr(self, f"res{i}", ResBlock(prev, ch[2 ** (i - 1)],
                                              device=device))
            prev = ch[2 ** (i - 1)]
        self.final_conv = ConvLayer(prev + (1 if minibatch_std else 0), ch[4],
                                    3, device=device)
        self.final_linear0 = EqualLinear(ch[4] * 4 * 4, ch[4], activation=True,
                                         device=device)
        self.final_linear1 = EqualLinear(ch[4], 1, device=device)
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.from_rgb(x)
        for i in self.res_logs:
            h = getattr(self, f"res{i}")(h)
        B, C, H, W = h.shape
        if self.minibatch_std:
            # group-major, as the JAX reshape (group, -1, 1, C, H, W)
            group = min(B, self.stddev_group)
            var = h.reshape(group, -1, 1, C, H, W).var(dim=0, correction=0)
            std = torch.sqrt(var + 1e-8).mean(dim=(2, 3, 4))   # (B//g, 1)
            std = std[:, :, None, None].repeat(group, 1, H, W)  # (B, 1, H, W)
            h = torch.cat([h, std], dim=1)
        h = self.final_conv(h).reshape(B, -1)
        return self.final_linear1(self.final_linear0(h))
