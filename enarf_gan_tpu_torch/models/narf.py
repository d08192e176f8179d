"""Articulated NeRF models (port of ``enarf_gan_tpu/models/narf.py``):
``TriPlaneNARF`` and the MLP baselines ``MLPNARF``.

``TriPlaneNARF`` ports every variant of the JAX model: planes a StyleGAN2
generates (``tri_plane_gen``, the GAN's and the default), constant planes
(``constant_triplane``), constant planes warped by a generated flow
(``deformation_field``), generated features over constant mask planes
(``constant_trimask``) and generated features weighted by a selector MLP
(``selector_mlp``). On the candidate-sparse path (the default, and
``constant_trimask``) the planes are sampled through the unirow kernels
(``ops/unirow.py``) or, for ``tile_patch`` models on the patch-tiled
renderer, the patch-window kernels (``ops/tilewin.py``); both read the
texel table of ``ops/unirow.py::pack_texels`` in the planes'
``plane_sample_dtype``: bf16 for both paths, float32 (the default, where
the JAX package samples its quad tables, ``ops/quadtable.py``) for the
unirow path. Off it (``no_selector``, ``selector_mlp``,
``max_bones_per_point >= num_bone``) every bone is sampled densely
through ``F.grid_sample`` (``ops/triplane.py``), as JAX samples it through
XLA.

Parameter and buffer names are the reference's (``tri_plane``,
``tri_plane_gen.*``, ``generator.*``, ``flow_generator.*``,
``selector.*``, ``mlp.layers.*``, ``density_fc.*``, ``canonical_pose``,
``canonical_bone_length``), so the state dict that
``export_reference_state_dict`` writes for the JAX model loads strictly;
``MLPNARF``'s ``density_mlp`` and ``deformation_field``, which that map
leaves out, keep the JAX model's flax paths
(``interop.flax_mlp_narf_state``). The JAX ``_DensityColorHeads``
submodule's layers sit on the model itself, where the reference names
them.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import NamedTuple

import torch
import torch.nn as nn

from enarf_gan_tpu_torch import DEFAULT_DEVICE, resolve_device
from enarf_gan_tpu_torch.geometry.encoding import (
    in_cube, multi_part_positional_encoding, positional_encoding, to_local)
from enarf_gan_tpu_torch.nn.layers import (MLP, GroupedConv1dReLUSelector,
                                           StyledConv1d, StyledMLP)
from enarf_gan_tpu_torch.nn.stylegan2 import StyleGAN2Generator
from enarf_gan_tpu_torch.ops.activation import density_relu
from enarf_gan_tpu_torch.ops.grid_sample import grid_sample_2d
from enarf_gan_tpu_torch.ops.tilewin import (pack_tilewin_texels,
                                             sample_tilewin_fused,
                                             select_patch_slots)
from enarf_gan_tpu_torch.ops.triplane import (sample_triplane_part_prob,
                                              sample_weighted_feature,
                                              select_candidate_bones)
from enarf_gan_tpu_torch.ops.unirow import (MASK_BLOCK, pack_texels,
                                            sample_candidates_unirow)


def _ablate_stage() -> str:
    """Measurement-only stand-ins for a frame's split into stages (the JAX
    ``_ablate_stage``; ``tools/frame_ablate.py``):

    ENARF_ABLATE=sampler  on the candidate path the planes are not packed
                          (``pack_planes`` and ``pack_planes_tiled`` return
                          an ``AblatedTable``) and the sampler's outputs are
                          cheap functions of the candidate positions, so
                          neither the candidate rows or plan nor kernel 1
                          or 2 run (JAX's XLA drops them as dead code);
    ENARF_ABLATE=heads    the heads' outputs are a slice of the feature.

    Never set in training or evaluation: warns once a process."""
    stage = os.environ.get("ENARF_ABLATE", "")
    if stage and not _ablate_stage._warned:
        _ablate_stage._warned = True
        warnings.warn(
            f"ENARF_ABLATE={stage!r} is set: sampler/head outputs are "
            "REPLACED with cheap stand-ins in every entry point. This is a "
            "bench-decomposition mode — unset it for any real run.",
            stacklevel=2)
    return stage


_ablate_stage._warned = False


class AblatedTable(NamedTuple):
    """What ``pack_planes`` (in a 1-tuple) and ``pack_planes_tiled`` return
    under ENARF_ABLATE=sampler: nothing packed, only what the sampler's
    stand-in reads."""
    feat_dim: int


def _ablated_feature(f0: torch.Tensor, feat_dim: int) -> torch.Tensor:
    """The stand-in feature (B, F, n): the candidates' mean position
    (B, 3, n) tiled over the channels, as JAX's ``jnp.tile``."""
    return f0.repeat(1, (feat_dim + 2) // 3, 1)[:, :feat_dim]


@dataclasses.dataclass(frozen=True)
class NARFParams:
    """Static model hyper-parameters (the fields of the JAX ``NARFParams``)."""
    origin_location: str = "center_fixed"
    coordinate_scale: float = 3.0
    hidden_size: int = 256
    Nc: int = 48
    Nf: int = 64
    render_bs: int = 16384
    num_frequency_for_position: int = 10
    num_frequency_for_other: int = 4
    view_dependent: bool = True
    model_type: str = "narf"
    multiply_density_with_triplane_weight: bool = False
    clamp_mask: bool = False
    constant_triplane: bool = False
    constant_trimask: bool = False
    constant_trimask_lr_mul: float = 1.0
    deformation_field: bool = False
    selector_mlp: bool = False
    no_selector: bool = False
    time_conditional: bool = True
    pose_conditional: bool = False
    tri_plane_size: int = 256
    feat_dim: int = 32
    w_dim: int = 512
    max_bones_per_point: int = 4
    plane_sample_dtype: str = "float32"
    tile_patch: int = 0
    tile_coarse_corners: bool = False

    @classmethod
    def from_config(cls, nerf_params, view_dependent=None) -> "NARFParams":
        """From a merged config's ``generator_params.nerf_params`` (a dict
        or an object with attributes), with the JAX package's defaults. The
        reference's config key ``multiply_density_with_triplane_wieght``
        keeps its spelling."""
        def get(k, d):
            if hasattr(nerf_params, "get"):
                return nerf_params.get(k, d)
            return getattr(nerf_params, k, d)

        if view_dependent is None:
            view_dependent = not get("no_ray_direction", False)
        return cls(
            origin_location=get("origin_location", "center_fixed"),
            coordinate_scale=float(get("coordinate_scale", 1)),
            hidden_size=int(get("hidden_size", 256)),
            Nc=int(get("Nc", 48)),
            Nf=int(get("Nf", 64)),
            render_bs=int(get("render_bs", 16384)),
            num_frequency_for_position=int(get("num_frequency_for_position",
                                               10)),
            num_frequency_for_other=int(get("num_frequency_for_other", 4)),
            view_dependent=view_dependent,
            model_type=get("model_type", "narf"),
            multiply_density_with_triplane_weight=bool(
                get("multiply_density_with_triplane_wieght", False)),
            clamp_mask=bool(get("clamp_mask", False)),
            constant_triplane=bool(get("constant_triplane", False)),
            constant_trimask=bool(get("constant_trimask", False)),
            constant_trimask_lr_mul=float(get("constant_trimask_lr_mul", 1)),
            deformation_field=bool(get("deformation_field", False)),
            selector_mlp=bool(get("selector_mlp", False)),
            no_selector=bool(get("no_selector", False)),
            max_bones_per_point=int(get("max_bones_per_point", 4)),
            plane_sample_dtype=get("plane_sample_dtype", "float32"),
            time_conditional=bool(get("time_conditional", False)),
            pose_conditional=bool(get("pose_conditional", False)),
            tri_plane_size=int(get("tri_plane_size", 256)),
            feat_dim=int(get("feat_dim", 32)),
            w_dim=int(get("w_dim", 512)),
            tile_patch=int(get("tile_patch", 0)),
            tile_coarse_corners=bool(get("tile_coarse_corners", False)),
        )


def params_use_candidate_sampling(params: NARFParams, model_num_bone: int) -> bool:
    """Whether the candidate-sparse tri-plane-mask path weights the parts
    (the default); the selector variants and max_bones_per_point >= K
    sample every bone densely."""
    return (params.max_bones_per_point < model_num_bone
            and not params.no_selector and not params.selector_mlp)


def _repeat_ray_dir_encoding(feature, ray_direction, num_frequency: int):
    """PE(ray_dir) broadcast from n rays to the n*S samples of ``feature``."""
    enc = positional_encoding(ray_direction, num_frequency)  # (B, 3*2L, n)
    factor = feature.shape[-1] // enc.shape[-1]
    return torch.repeat_interleave(enc, factor, dim=2)


class _DensityColorHeads(nn.Module):
    """The density and color heads every NARF and NeRF model ends in (the
    JAX ``_DensityColorHeads``): ``density_fc`` and the color ``mlp`` sit
    on the model itself, where the reference names them."""

    def _init_heads(self, in_dim: int, hidden: int, z2_dim: int,
                    device) -> None:
        p = self.params
        if p.view_dependent:
            self.density_fc = StyledConv1d(in_dim, 1, z2_dim, device=device)
            self.mlp = StyledMLP(in_dim + 3 * p.num_frequency_for_other * 2,
                                 hidden, 3, style_dim=z2_dim, device=device)
        else:
            self.mlp = StyledMLP(in_dim, hidden, 4, style_dim=z2_dim,
                                 device=device)

    def heads(self, feature, z_rend, ray_direction):
        """The raw density logit and tanh color (None without a ray
        direction on a view-dependent model)."""
        p = self.params
        if p.view_dependent:
            density = self.density_fc(feature, z_rend)
            if ray_direction is None:
                return density, None
            enc = _repeat_ray_dir_encoding(feature, ray_direction,
                                           p.num_frequency_for_other)
            color = torch.tanh(self.mlp(torch.cat([feature, enc], dim=1),
                                        z_rend))
            return density, color
        cd = self.mlp(feature, z_rend)
        return cd[:, 3:], torch.tanh(cd[:, :3])


def _check_packed(table) -> None:
    if isinstance(table, AblatedTable):
        raise ValueError("these planes were packed under ENARF_ABLATE="
                         "sampler, which no longer holds: pack them again")


class TriPlaneNARF(_DensityColorHeads):
    """Tri-plane articulated NeRF with per-bone mask planes."""

    def __init__(self, params: NARFParams, z_dim: int, z2_dim: int,
                 num_bone: int, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        p = self.params = params
        self.num_bone = num_bone
        ts = p.tri_plane_size
        fch = p.feat_dim * 3
        mch = num_bone * 3
        if p.selector_mlp and not p.no_selector and (
                p.constant_triplane or p.constant_trimask
                or p.deformation_field):
            raise ValueError(
                "selector_mlp with constant_triplane, constant_trimask or "
                "deformation_field: the JAX model builds no selector there "
                "and cannot run it")
        c_dim = p.num_frequency_for_other * 2 * num_bone

        def sg(out_channels):
            return StyleGAN2Generator(
                size=ts, z_dim=z_dim, style_dim=p.w_dim, n_mlp=8,
                out_channels=out_channels, c_dim=c_dim,
                channel_max=max(p.w_dim, 64), device=device)

        # the JAX branch order; the generators keep the reference's names
        if p.constant_triplane:
            self.tri_plane = nn.Parameter(torch.empty(1, fch + mch, ts, ts,
                                                      device=device))
        elif p.constant_trimask:
            self.generator = sg(fch)
            self.tri_plane = nn.Parameter(torch.empty(1, mch, ts, ts,
                                                      device=device))
        elif p.deformation_field:
            self.tri_plane = nn.Parameter(torch.empty(1, fch + mch, ts, ts,
                                                      device=device))
            self.flow_generator = sg(2 * 3)
        elif p.selector_mlp:
            self.generator = sg(fch)
            self.selector = GroupedConv1dReLUSelector(
                num_bone * 3 * p.num_frequency_for_position * 2, num_bone,
                device=device)
        else:
            self.tri_plane_gen = sg(fch + mch)
        self._init_heads(p.feat_dim, 64, z2_dim, device)
        self.register_buffer("canonical_pose",
                             torch.zeros(num_bone, 4, 4, device=device))
        self.register_buffer("canonical_bone_length",
                             torch.ones(num_bone, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if hasattr(self, "tri_plane"):
            with torch.no_grad():
                self.tri_plane.zero_()

    @property
    def plane_generator(self):
        """The StyleGAN2 whose output the planes are made of (the flow
        generator for ``deformation_field``), or None for constant
        planes."""
        for name in ("tri_plane_gen", "generator", "flow_generator"):
            if hasattr(self, name):
                return getattr(self, name)
        return None

    # ------------------------------------------------------------------ #
    def encode_bone_length(self, bone_length: torch.Tensor) -> torch.Tensor:
        """(B, K, 1) → (B, K*2L) conditioning."""
        enc = multi_part_positional_encoding(
            bone_length, self.params.num_frequency_for_other, self.num_bone)
        return enc[:, :, 0]

    def compute_tri_plane_feature(self, z: torch.Tensor,
                                  bone_length: torch.Tensor,
                                  truncation_psi=1.0,
                                  update_w_avg: bool = False) -> torch.Tensor:
        """z + PE(bone length) → (B, (F+K)*3, ts, ts) feature planes.
        ``truncation_psi`` and ``update_w_avg`` go to the mapping network
        of the generated variants."""
        p = self.params
        B = bone_length.shape[0]
        ts = p.tri_plane_size
        if p.constant_triplane:
            return self.tri_plane.expand(B, -1, -1, -1)
        c = self.encode_bone_length(bone_length)
        if p.constant_trimask:
            feat = self.generator(z, c=c, truncation_psi=truncation_psi,
                                  update_w_avg=update_w_avg)
            mask = (self.tri_plane * p.constant_trimask_lr_mul).expand(
                B, -1, -1, -1)
            return torch.cat([feat, mask], dim=1)
        if p.deformation_field:
            return self._warped_planes(z, c, truncation_psi, update_w_avg)
        if p.selector_mlp:
            feat = self.generator(z, c=c, truncation_psi=truncation_psi,
                                  update_w_avg=update_w_avg)
            zeros = feat.new_zeros(B, self.num_bone * 3, ts, ts)
            return torch.cat([feat, zeros], dim=1)
        return self.tri_plane_gen(z, c=c, truncation_psi=truncation_psi,
                                  update_w_avg=update_w_avg)

    def _warped_planes(self, z, c, truncation_psi, update_w_avg):
        """The constant feature planes warped by a generated flow field."""
        p = self.params
        B = c.shape[0]
        ts = p.tri_plane_size
        planes = self.tri_plane.expand(B, -1, -1, -1)
        flow = self.flow_generator(z, c=c, truncation_psi=truncation_psi,
                                   update_w_avg=update_w_avg)
        flow = flow.reshape(B * 3, 2, ts, ts).permute(0, 2, 3, 1)  # (3B,ts,ts,2)
        ar = torch.arange(ts, dtype=flow.dtype, device=flow.device)
        gy, gx = torch.meshgrid(ar, ar, indexing="ij")
        grid = torch.stack([gx, gy], dim=2) + 0.5           # pixels
        grid = (grid[None] + flow) / (ts / 2) - 1           # [-1, 1]
        fch = p.feat_dim * 3
        feat_planes = planes[:, :fch].reshape(B * 3, p.feat_dim, ts, ts)
        warped = grid_sample_2d(feat_planes, grid.reshape(B * 3, -1, 2))
        warped = warped.reshape(B, fch, ts, ts)
        return torch.cat([warped, planes[:, fch:]], dim=1)

    # ------------------------------------------------------------------ #
    def to_local_and_canonical(self, points, pose_to_camera, bone_length):
        """Camera points (B, 3, n) → per-bone local (B, K*3, n) and
        canonical (B, K, 3, n) coordinates."""
        bs, K = pose_to_camera.shape[:2]
        local_flat = to_local(points, pose_to_camera)
        local = local_flat.reshape(bs, K, 3, -1)
        scale = (self.canonical_bone_length[None, :, None]
                 / bone_length / self.params.coordinate_scale)   # (B, K, 1)
        canonical = local * scale[:, :, :, None]
        cR = self.canonical_pose[:, :3, :3]
        ct = self.canonical_pose[:, :3, 3:]
        canonical = torch.einsum("kij,bkjn->bkin", cR, canonical) + ct[None]
        return local_flat, canonical

    def uses_candidate_sampling(self) -> bool:
        return params_use_candidate_sampling(self.params, self.num_bone)

    def supports_tiled_sampling(self) -> bool:
        """tile_patch only accelerates the candidate-sparse tri-plane-mask
        path; the selector variants render through the exact renderer."""
        return self.params.tile_patch > 0 and self.uses_candidate_sampling()

    @property
    def texel_dtype(self) -> torch.dtype:
        """The texel table's type: bf16 for ``plane_sample_dtype``
        "bfloat16", float32 otherwise (the JAX package's rule)."""
        return torch.bfloat16 if self.params.plane_sample_dtype == "bfloat16" \
            else torch.float32

    def _check_unirow(self) -> None:
        p = self.params
        if p.feat_dim > 32 or self.num_bone > MASK_BLOCK:
            raise NotImplementedError(
                "the texel samplers take feat_dim <= 32 and <= 32 bones (the "
                "JAX package's quad tables beyond that are ROADMAP Queue 2, "
                "item 3)")

    def pack_planes(self, tri_plane_feature: torch.Tensor):
        """Pack planes once per frame into the unirow sampler's texel
        table (``ops/unirow.py::pack_texels``, bf16 or float32 by
        ``plane_sample_dtype``; the JAX package packs quad rows, or for
        float32 planes quad tables), as a 1-tuple (the JAX package's
        packed-table convention). Off the candidate path the dense
        samplers read the planes themselves, which come back unchanged."""
        if not self.uses_candidate_sampling():
            return tri_plane_feature
        self._check_unirow()
        if _ablate_stage() == "sampler":
            return (AblatedTable(self.params.feat_dim),)
        return (pack_texels(tri_plane_feature, self.params.feat_dim,
                            self.num_bone, dtype=self.texel_dtype),)

    def calc_weight(self, tri_plane_weights, position, position_validity):
        """Part probabilities (B, K, n) off the candidate path: 1/K with
        ``no_selector``, the selector's softmax over the multi-part PE of
        the positions with ``selector_mlp``, else the product of the mask
        planes' sigmoids. ``tri_plane_weights``: (B*K, 3, H, W);
        ``position``: (B, K, 3, n), invalid at 2."""
        p = self.params
        bs, K, _, n = position.shape
        if p.no_selector:
            return torch.full((bs, K, n), 1.0 / K, dtype=position.dtype,
                              device=position.device)
        if p.selector_mlp:
            enc = multi_part_positional_encoding(
                position.reshape(bs, K * 3, n), p.num_frequency_for_position,
                K)
            return torch.softmax(self.selector(enc), dim=1)
        return sample_triplane_part_prob(tri_plane_weights, position,
                                         position_validity, mode="prod",
                                         clamp_mask=p.clamp_mask)

    def _canonical_validity(self, position, pose_to_camera, bone_length):
        """Canonical coordinates (B, K, 3, n) and whether each point lies
        in each bone's cube (B, K, n)."""
        local, canonical = self.to_local_and_canonical(position, pose_to_camera,
                                                       bone_length)
        return canonical, in_cube(local) & (canonical.abs() < 1).all(dim=2)

    def _density_color(self, feature, weight_max, validity, z_rend,
                       ray_direction):
        """Heads on the sampled feature (under ENARF_ABLATE=heads a slice
        of it); density zero outside every cube."""
        if _ablate_stage() == "heads":
            density, color = feature[:, :1], feature[:, 1:4]
        else:
            density, color = self.heads(feature, z_rend, ray_direction)
        if self.params.multiply_density_with_triplane_weight:
            density = density_relu(density) * (10 * weight_max)
        else:
            density = density_relu(density) * 10
        return density * validity.any(dim=1, keepdim=True), color

    def density_color(self, position, pose_to_camera, bone_length,
                      tri_plane_feature, z_rend, ray_direction=None):
        """Density + color at camera-frame positions.

        Args:
            position: (B, 3, n); pose_to_camera: (B, K, 4, 4) re-rooted bone
                frames with translations scaled by coordinate_scale;
            bone_length: (B, K, 1); tri_plane_feature: planes
                (B, (F+K)*3, ts, ts) or what ``pack_planes`` made of them;
            z_rend: (B, z2_dim); ray_direction: (B, 3, n_rays) or None.
        Returns:
            (density (B, 1, n), color (B, 3, n) | None). (The JAX function's
            per-candidate weights feed only the GAN's losses and come with
            the GAN slice.)

        On the candidate path the M most central valid bones of each point
        are sampled by the unirow kernels; off it (``no_selector``,
        ``selector_mlp``, max_bones_per_point >= K) every bone is sampled
        densely from the raw planes (``ops/triplane.py``).
        """
        p = self.params
        K = self.num_bone
        ts = p.tri_plane_size
        canonical, validity = self._canonical_validity(
            position, pose_to_camera, bone_length)
        if not self.uses_candidate_sampling():
            if isinstance(tri_plane_feature, tuple):
                raise ValueError("packed sampling tables need the candidate "
                                 "path")
            bs, n = position.shape[0], position.shape[2]
            fch = p.feat_dim * 3
            masked_pos = torch.where(validity[:, :, None], canonical,
                                     torch.full_like(canonical, 2.0))
            weight = self.calc_weight(
                tri_plane_feature[:, fch:].reshape(bs * K, 3, ts, ts),
                masked_pos, validity)
            feature = sample_weighted_feature(
                p.feat_dim, tri_plane_feature[:, :fch], masked_pos, weight,
                validity, clamp_mask=p.clamp_mask)
            weight_max = weight.amax(dim=1, keepdim=True)     # (B, 1, n)
            return self._density_color(feature, weight_max, validity, z_rend,
                                       ray_direction)
        if isinstance(tri_plane_feature, tuple):
            (table,) = tri_plane_feature
        else:
            (table,) = self.pack_planes(tri_plane_feature)
        cand_idx, cand_valid, cand_pos = select_candidate_bones(
            canonical, validity, p.max_bones_per_point)
        if _ablate_stage() == "sampler":
            feature = _ablated_feature(cand_pos.mean(dim=2).permute(0, 2, 1),
                                       p.feat_dim)
            cand_w = torch.sigmoid(cand_pos.sum(dim=3))        # (B, n, M)
        else:
            _check_packed(table)
            feature, cand_w = sample_candidates_unirow(
                table, cand_pos, cand_idx, cand_valid, p.feat_dim, K, ts, ts,
                clamp_mask=p.clamp_mask)
        weight_max = (cand_w * cand_valid).amax(dim=2)[:, None]   # (B, 1, n)
        return self._density_color(feature, weight_max, validity, z_rend,
                                   ray_direction)

    def pack_planes_tiled(self, tri_plane_feature: torch.Tensor):
        """Pack planes once per frame for the patch-window path: the texel
        table of ``pack_planes`` with F, K and the plane size
        (``ops/tilewin.py::pack_tilewin_texels``; the JAX package packs
        window tables, ``pack_tilewin``)."""
        if not self.uses_candidate_sampling():
            raise ValueError(
                "tile_patch needs the candidate-sparse tri-plane-mask path "
                "(not no_selector / selector_mlp / max_bones_per_point >= "
                "num_bone)")
        if _ablate_stage() == "sampler":
            return AblatedTable(self.params.feat_dim)
        if self.texel_dtype != torch.bfloat16:
            raise NotImplementedError(
                "the patch-tiled sampler takes bf16 planes (the JAX package "
                "rounds float32 planes' window tables to bf16); float32 with "
                "tile_patch is ROADMAP Queue 2, item 3")
        return pack_tilewin_texels(tri_plane_feature, self.params.feat_dim,
                                   self.num_bone)

    def density_color_tiled(self, position, pose_to_camera, bone_length,
                            tables, z_rend, n_patch: int, m: int, S: int,
                            ray_direction=None, with_stats: bool = False):
        """Patch-window path of ``density_color``.

        Same math as the candidate branch, but candidates are chosen per
        (pixel patch, sample) and the tri-plane reads share one 8x8-texel
        window per (patch, sample, slot, plane). ``position`` (B, 3, n) is in
        tiled point order ((patch*m + member)*S + sample), see
        ``nerf/tiled.py``; ``tables`` come from ``pack_planes_tiled``.
        Returns (density (B, 1, n), color (B, 3, n) | None), plus the
        sampler's stats ({"clamped": share}) with ``with_stats``.
        """
        p = self.params
        B, _, n = position.shape
        canonical, validity = self._canonical_validity(
            position, pose_to_camera, bone_length)
        slot_idx, cand_pos, cand_valid = select_patch_slots(
            canonical, validity, n_patch, m, S, p.max_bones_per_point)
        if _ablate_stage() == "sampler":
            feature = _ablated_feature(cand_pos.mean(dim=2).reshape(B, 3, n),
                                       tables.feat_dim)
            cand_w = torch.sigmoid(cand_pos.sum(dim=1))   # (B, Mp, np, m, S)
            out = (feature, cand_w,
                   {"clamped": torch.zeros((), device=position.device)})
        else:
            _check_packed(tables)
            # the fine pass (m = 16) takes ENARF_TILEWIN_KERNEL's
            # formulation; the coarse-corner pass (m = 4) stays on the hat
            # kernel, as the JAX one never reached the matrix modes
            out = sample_tilewin_fused(tables, cand_pos, slot_idx,
                                       cand_valid, clamp_mask=p.clamp_mask,
                                       with_stats=with_stats,
                                       mode=None if m == 16 else "hat")
        feature, cand_w = out[0], out[1]
        weight_max = (cand_w * cand_valid).amax(dim=1).reshape(B, 1, n)
        density, color = self._density_color(feature, weight_max, validity,
                                             z_rend, ray_direction)
        if with_stats:
            return density, color, out[2]
        return density, color


class MLPNARF(_DensityColorHeads):
    """The MLP NARF baselines of the DSO default config: ``model_type``
    "narf" (an 8-layer ``MLP`` on the selector-weighted multi-part PE of
    the bone-local positions), "tnarf" (a ``StyledMLP`` on it, styled by
    z) and "dnarf" (a deformation ``MLP`` on the PE and z moves the local
    positions first, then the ``MLP`` on their plain PE). The density stays
    the raw logit, as the JAX model keeps it (the reference's import
    shadowing selects the head that does not activate it). No kernel: the
    work is plain PyTorch."""

    def __init__(self, params: NARFParams, z_dim: int, z2_dim: int,
                 num_bone: int, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        p = self.params = params
        self.num_bone = num_bone
        hidden = p.hidden_size
        in_dim = num_bone * 3 * p.num_frequency_for_position * 2
        self.selector = GroupedConv1dReLUSelector(in_dim, num_bone,
                                                  device=device)
        if p.model_type == "dnarf":
            self.deformation_field = MLP(in_dim + z_dim, hidden, num_bone * 3,
                                         num_layers=8, skips=(4,),
                                         device=device)
            self.density_mlp = MLP(in_dim, hidden, hidden, num_layers=8,
                                   skips=(4,), device=device)
        elif p.model_type == "tnarf":
            self.density_mlp = StyledMLP(in_dim, hidden, hidden,
                                         style_dim=z_dim, num_layers=8,
                                         device=device)
        elif p.model_type == "narf":
            self.density_mlp = MLP(in_dim, hidden, hidden, num_layers=8,
                                   skips=(4,), device=device)
        else:
            raise ValueError(f"unknown model_type {p.model_type!r}")
        self._init_heads(hidden, hidden // 2, z2_dim, device)

    def supports_tiled_sampling(self) -> bool:
        return False

    def density_color(self, position, pose_to_camera, bone_length, z, z_rend,
                      ray_direction=None):
        """Density (the raw logit, zero outside every bone's cube) and color
        at camera-frame positions (B, 3, n) from z (B, z_dim), for the
        re-rooted bone frames ``pose_to_camera`` (B, K, 4, 4);
        ``bone_length`` is unused, as in the JAX model. Returns (density
        (B, 1, n), color (B, 3, n) | None)."""
        p = self.params
        K, L = self.num_bone, p.num_frequency_for_position
        local = to_local(position, pose_to_camera)            # (B, K*3, n)
        validity = in_cube(local)                             # (B, K, n)
        enc = multi_part_positional_encoding(local, L, K)     # (B, K*3*2L, n)
        prob = torch.softmax(self.selector(enc), dim=1)       # (B, K, n)
        B, C, n = enc.shape
        # the PE scaled by its bone's probability: the JAX model repeats
        # prob to the PE's channels, a broadcast multiplies the same numbers
        # without that copy
        enc = (enc.reshape(B, K, C // K, n) * prob[:, :, None]).reshape(B, C, n)
        if p.model_type == "dnarf":
            zz = z[:, :, None].expand(-1, -1, n)
            local = local + self.deformation_field(torch.cat([enc, zz], dim=1))
            enc = multi_part_positional_encoding(local, L, K)
        if p.model_type == "tnarf":
            feature = self.density_mlp(enc, z)
        else:
            feature = self.density_mlp(enc)
        density, color = self.heads(feature, z_rend, ray_direction)
        return density * validity.any(dim=1, keepdim=True), color
