"""Equalized-LR and modulated layers (port of ``enarf_gan_tpu/nn/layers.py``).

Parameters are stored under the reference's names and shapes (the names
``export_reference_state_dict`` writes), so a reference-named state dict
loads with ``load_state_dict(strict=True)``:

* ``StyledConv1d``: ``conv.weight`` (1, out, in, 1), ``conv.modulation.*``,
  ``bias`` (1, out, 1);
* ``EqualLinear``: ``weight`` (out, in), ``bias`` (out,);
* ``MLP`` and ``GroupedConv1dReLUSelector``: ``EqualConv1d_{i}.weight``
  (groups, out/g, in/g), ``.bias`` (out,), the JAX modules' flax paths.

Equalized learning rate: weights are drawn from N(0, 1)/lr_mul and scaled at
run time by ``lr_mul / sqrt(fan_in)``. ``reset_parameters(generator)``
draws a module's own parameters as the JAX initializers do, from an explicit
``torch.Generator`` on the CPU.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from enarf_gan_tpu_torch import DEFAULT_DEVICE


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bias (along the last axis) + LeakyReLU(0.2) * sqrt(2)."""
    return F.leaky_relu(x + bias, 0.2) * 2 ** 0.5


def pixel_norm(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x ** 2, dim=dim, keepdim=True) + eps)


def _normal_(p: torch.Tensor, generator: torch.Generator, std: float = 1.0):
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator) * std)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` as the JAX package initializes it."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class EqualLinear(nn.Module):
    """Equalized linear layer, optionally with the fused leaky ReLU."""

    def __init__(self, in_dim: int, out_dim: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: bool = False,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, device=device))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))
        self.bias_init, self.lr_mul, self.activation = bias_init, lr_mul, activation
        self.scale = lr_mul / math.sqrt(in_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator, 1.0 / self.lr_mul)
        with torch.no_grad():
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias * self.lr_mul
        y = x @ (self.weight * self.scale).t()
        if self.activation:
            return fused_leaky_relu(y, b)
        return y + b


class EqualConv2d(nn.Module):
    """Equalized kxk conv over (B, C, H, W); weight (out, in, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 device=DEFAULT_DEVICE):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) \
            if use_bias else None
        self.stride, self.padding = stride, padding
        self.scale = 1 / math.sqrt(in_channels * k * k)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.scale, self.bias,
                        stride=self.stride, padding=self.padding)


class EqualConv1d(nn.Module):
    """Equalized grouped 1x1 conv over (B, C, n); weight (groups, out/g, in/g)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 1,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.groups = groups
        in_per, out_per = in_channels // groups, out_channels // groups
        self.weight = nn.Parameter(torch.empty(groups, out_per, in_per,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.bias_init, self.lr_mul = bias_init, lr_mul
        self.scale = lr_mul / math.sqrt(in_per)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator, 1.0 / self.lr_mul)
        with torch.no_grad():
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, n = x.shape
        g = self.groups
        y = torch.einsum("bgin,goi->bgon", x.reshape(B, g, C // g, n),
                         self.weight * self.scale)
        return y.reshape(B, -1, n) + self.bias[None, :, None]


class ModulatedConv1d(nn.Module):
    """Per-sample style-modulated 1x1 conv over (B, C, n), demodulated by
    the L2 norm of each modulated weight row (eps 1e-12)."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, out_channels, in_channels, 1,
                                               device=device))
        self.modulation = EqualLinear(style_dim, in_channels, bias_init=1.0,
                                      device=device)
        self.scale = 1 / math.sqrt(in_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        s = self.modulation(style)                          # (B, C)
        wmod = (self.weight[0, :, :, 0] * self.scale)[None] * s[:, None, :]
        norm = torch.sqrt(torch.sum(wmod ** 2, dim=2, keepdim=True))
        wmod = wmod / norm.clamp_min(1e-12)
        return torch.bmm(wmod, x)                           # (B, out, n)


class StyledConv1d(nn.Module):
    """ModulatedConv1d + bias + LeakyReLU(0.2)*sqrt(2)."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.conv = ModulatedConv1d(in_channels, out_channels, style_dim,
                                    device=device)
        self.bias = nn.Parameter(torch.empty(1, out_channels, 1, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.conv(x, style) + self.bias, 0.2) * 2 ** 0.5


class StyledMLP(nn.Module):
    """Stack of StyledConv1d, kept in ``layers`` as the reference names it."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 style_dim: int = 512, num_layers: int = 3,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            StyledConv1d(dims[i], dims[i + 1], style_dim, device=device)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, z)
        return x


class MLP(nn.Module):
    """EqualConv1d stack with skip concatenations of the input before the
    layers named in ``skips`` (not the first). No nonlinearity between layers: the
    reference's MLP has none, and the JAX package keeps that for parity.
    Its layers are ``EqualConv1d_{i}``, the JAX module's flax names."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 3, skips: Tuple[int, ...] = (),
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.skips = tuple(skips)
        self.num_layers = num_layers
        for i in range(num_layers):
            cin = in_dim if i == 0 else hidden_dim + in_dim * (i in self.skips)
            cout = out_dim if i == num_layers - 1 else hidden_dim
            self.add_module(f"EqualConv1d_{i}",
                            EqualConv1d(cin, cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            if i and i in self.skips:
                h = torch.cat([h, x], dim=1)
            h = getattr(self, f"EqualConv1d_{i}")(h)
        return h


class GroupedConv1dReLUSelector(nn.Module):
    """Per-bone selector: grouped EqualConv1d (``hidden_per_bone``
    channels a bone) → ReLU → grouped EqualConv1d to one logit a bone.
    Its layers keep the JAX module's names, ``EqualConv1d_0`` and
    ``EqualConv1d_1``, which the reference key map uses
    (``nerf.selector.EqualConv1d_0.weight``)."""

    def __init__(self, in_dim: int, num_bone: int, hidden_per_bone: int = 10,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.EqualConv1d_0 = EqualConv1d(in_dim, hidden_per_bone * num_bone,
                                         groups=num_bone, device=device)
        self.EqualConv1d_1 = EqualConv1d(hidden_per_bone * num_bone, num_bone,
                                         groups=num_bone, device=device)

    def forward(self, encoded_p: torch.Tensor) -> torch.Tensor:
        return self.EqualConv1d_1(torch.relu(self.EqualConv1d_0(encoded_p)))
