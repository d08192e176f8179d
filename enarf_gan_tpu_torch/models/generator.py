"""Image-level generators and their full-image renderers (port of
``enarf_gan_tpu/models/generator.py``).

``DSONARFGenerator.forward`` is the DSO training render: a ray batch
sampled from the foreground mask, rendered differentiably.
``make_dso_full_renderer`` returns a function that renders one full frame
from a pose, the camera intrinsics and a frame time.
``TriNARFGenerator.forward`` is the GAN's image: the whole pixel grid of a
pose rendered from a latent z, over a StyleGAN2 background (learned, or
the frozen pretrained one) or a black one;
``make_gan_full_renderer`` returns a function that renders one full
foreground frame from a pose and a z (sampling, with truncation). All take
the patch-tiled path for ``tile_patch`` models and the exact one otherwise.
The JAX package's ``variables`` and ``rng`` arguments become the module's
own weights and an explicit ``torch.Generator`` (or the draws themselves:
the fine sampler's, given per ray chunk, and the background's noise and
crop).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from enarf_gan_tpu_torch import DEFAULT_DEVICE
from enarf_gan_tpu_torch.geometry.encoding import scalar_positional_encoding
from enarf_gan_tpu_torch.geometry.pose import (transform_canonical_pose,
                                               transform_pose)
from enarf_gan_tpu_torch.models.narf import NARFParams, TriPlaneNARF
from enarf_gan_tpu_torch.nerf.ray_sampler import (image_grid_coords,
                                                  mask_based_sampler,
                                                  patch_based_sampler)
from enarf_gan_tpu_torch.nerf.rendering import (Draws, RenderConfig,
                                                draw_fine_uniforms,
                                                render_entire_img, render_rays)
from enarf_gan_tpu_torch.nerf.tiled import (render_entire_img_tiled,
                                            render_rays_tiled,
                                            tile_permutation)
from enarf_gan_tpu_torch.nn.layers import init_parameters
from enarf_gan_tpu_torch.nn.stylegan2 import (BackgroundGenerator,
                                              PretrainedStyleGAN)


def _model_num_bone(num_bone: int, origin_location: str) -> int:
    return num_bone - 1 if origin_location in ("center", "center_fixed") else num_bone


def pose_encoding(pose: torch.Tensor) -> torch.Tensor:
    """Root-relative rotations → (B, (J-1)*9)."""
    rot = pose[:, 1:, :3, :3]
    root = pose[:, :1, :3, :3].expand_as(rot)
    enc = torch.einsum("bkji,bkjl->bkil", root, rot)       # root^T @ rot
    return enc.reshape(enc.shape[0], -1)


class _TriPlaneGenerator(nn.Module):
    """What the DSO and GAN generators share: the pose transform, the
    render config and the calls into their tri-plane NARF ``self.nerf``."""

    @property
    def model_num_bone(self) -> int:
        return _model_num_bone(self.num_bone, self.nerf_params.origin_location)

    def transform_pose(self, pose_to_camera, bone_length):
        return transform_pose(pose_to_camera, bone_length,
                              self.nerf_params.origin_location, self.parent_id)

    def render_cfg(self) -> RenderConfig:
        p = self.nerf_params
        return RenderConfig(Nc=p.Nc, Nf=p.Nf,
                            coordinate_scale=p.coordinate_scale,
                            view_dependent=p.view_dependent,
                            tile_coarse_corners=p.tile_coarse_corners)

    def compute_tri_plane_feature(self, z, bone_length_t, truncation_psi=1.0,
                                  update_w_avg: bool = False):
        return self.nerf.compute_tri_plane_feature(
            z, bone_length_t, truncation_psi, update_w_avg)

    def pack_planes(self, planes):
        return self.nerf.pack_planes(planes)

    def pack_planes_tiled(self, planes):
        return self.nerf.pack_planes_tiled(planes)

    def nerf_density_color(self, points, pose_scaled, bone_length_t,
                           z_or_planes, z_rend, ray_direction):
        return self.nerf.density_color(points, pose_scaled, bone_length_t,
                                       z_or_planes, z_rend, ray_direction)

    def nerf_density_color_tiled(self, points, pose_scaled, bone_length_t,
                                 tables, z_rend, n_patch, m, S,
                                 ray_direction=None, with_stats=False):
        return self.nerf.density_color_tiled(
            points, pose_scaled, bone_length_t, tables, z_rend, n_patch, m,
            S, ray_direction, with_stats)


class DSONARFGenerator(_TriPlaneGenerator):
    """Dynamic-scene-overfitting generator: time (and/or pose) conditioned
    tri-plane NARF (the JAX ``use_triplane=True`` model; the MLP baselines
    are ROADMAP Queue 1, item 5). Weights are drawn from ``generator``
    (seed 0 when none is given) as the JAX initializers draw them, and
    built on ``device``: the GPU unless the caller names another.
    ``ray_batchsize`` is the rays an image of a training batch renders."""

    def __init__(self, nerf_params: NARFParams, num_bone: int,
                 parent_id: Sequence[int], device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 ray_batchsize: int = 4096):
        super().__init__()
        self.nerf_params = nerf_params
        self.num_bone = num_bone
        self.ray_batchsize = ray_batchsize
        self.parent_id = tuple(int(x) for x in parent_id)
        self.nerf = TriPlaneNARF(nerf_params, z_dim=self.z_dim,
                                 z2_dim=self.z_dim,
                                 num_bone=self.model_num_bone, device=device)
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    @property
    def z_dim(self) -> int:
        z = 0
        if self.nerf_params.time_conditional:
            z += 20
        if self.nerf_params.pose_conditional:
            z += (self.num_bone - 1) * 9
        return z

    def get_latents(self, frame_time: torch.Tensor,
                    pose_to_camera: torch.Tensor) -> torch.Tensor:
        """PE(frame_time) ⊕ pose encoding."""
        zs = []
        if self.nerf_params.time_conditional:
            zs.append(scalar_positional_encoding(frame_time, 10))
        if self.nerf_params.pose_conditional:
            zs.append(pose_encoding(pose_to_camera))
        if not zs:
            raise ValueError("DSO model needs time and/or pose conditioning")
        return torch.cat(zs, dim=1)

    def forward(self, pose_to_camera, camera_pose, mask, frame_time,
                bone_length, inv_intrinsics, background: Optional[float] = None,
                ray_noise: Optional[torch.Tensor] = None,
                draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None):
        """The training render of a batch (the JAX ``__call__``).

        Samples ``ray_batchsize`` rays an image from the dilated mask (B, H,
        W): whole 4x4 patches on the tiled path, pixels on the exact one;
        packs the planes once; renders the rays; composites over
        ``background`` (-1 when None). Random numbers: the sampler's noise
        (``ray_noise``: (B, H*W) exact, (B, patches of the image) tiled) and
        the fine sampler's (u, jitter) pair (``draws``: each (B*n, Nf) exact,
        (B*n_patch, Nf) tiled), or both from ``generator``.
        Returns (color (B, 3, n), mask (B, n), ray_idx (B, n)).
        """
        if generator is None and (ray_noise is None or draws is None):
            raise ValueError("the training render needs ray_noise and draws, "
                             "or a generator")
        z = self.get_latents(frame_time, pose_to_camera)
        pose_t, bl_t = self.transform_pose(pose_to_camera, bone_length)
        B = mask.shape[0]
        Nf = self.nerf_params.Nf
        if self.nerf.supports_tiled_sampling():
            P = self.nerf_params.tile_patch
            ray_idx, img_coord = patch_based_sampler(
                mask, self.ray_batchsize, P, noise=ray_noise,
                generator=generator)
            tables = self.pack_planes_tiled(
                self.compute_tri_plane_feature(z, bl_t))

            def fn_t(points, ray_dir, pose_scaled, n_patch, m, S):
                return self.nerf_density_color_tiled(
                    points, pose_scaled, bl_t, tables, z, n_patch, m, S,
                    ray_dir)

            if draws is None:
                draws = draw_fine_uniforms(
                    B * ray_idx.shape[1] // (P * P), Nf, generator,
                    mask.device)
            color, nerf_mask, _, _ = render_rays_tiled(
                fn_t, img_coord, pose_t, inv_intrinsics, self.render_cfg(), P,
                draws, camera_pose=camera_pose)
        else:
            ray_idx, img_coord = mask_based_sampler(
                mask, self.ray_batchsize, noise=ray_noise, generator=generator)
            cond = self.pack_planes(self.compute_tri_plane_feature(z, bl_t))

            def fn(points, ray_dir, pose_scaled):
                return self.nerf_density_color(points, pose_scaled, bl_t,
                                               cond, z, ray_dir)

            if draws is None:
                draws = draw_fine_uniforms(B * ray_idx.shape[1], Nf,
                                           generator, mask.device)
            color, nerf_mask, _, _ = render_rays(
                fn, img_coord, pose_t, inv_intrinsics, self.render_cfg(),
                draws, camera_pose=camera_pose)
        if background is None:
            background = -1.0
        color = color + background * (1 - nerf_mask[:, None])
        return color, nerf_mask, ray_idx


def _recomputed_in_backward(fn):
    """``fn`` with its activations recomputed in the backward pass (the
    JAX package's ``jax.checkpoint`` of the GAN's per-point network): only
    its inputs are kept between the passes. Nothing inside may draw at
    random."""
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return run


class TriNARFGenerator(_TriPlaneGenerator):
    """Pose-conditioned GAN generator: a tri-plane NARF foreground whose
    planes a StyleGAN2 generates from z and the bone lengths, over a
    background: the learned StyleGAN2 (``BackgroundGenerator``), the
    frozen stylegan2-church one (``pretrained_background``,
    ``PretrainedStyleGAN`` of ``pretrained_bg_size``², its weights from
    ``training/checkpoint.py::load_pretrained_background``) or, with
    ``black_background``, none (black, -1). The tri-plane NARF takes 2
    z_dim of z, its heads z_dim, the learned background z_dim (the
    pretrained one z background and z render). Weights are drawn from
    ``generator`` (seed 0 when none is given) and built on ``device``: the
    GPU unless the caller names another. ``train_ray_chunk`` is the rays of
    every image rendered at a time in the forward."""

    def __init__(self, nerf_params: NARFParams, size: int, num_bone: int,
                 parent_id: Sequence[int], z_dim: int = 256,
                 crop_background: bool = False,
                 black_background: bool = False,
                 pretrained_background: bool = False,
                 background_ratio: float = 0.7, channel_max: int = 512,
                 pretrained_bg_size: int = 256,
                 train_ray_chunk: int = 4096, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nerf_params = nerf_params
        self.size, self.num_bone, self.z_dim = size, num_bone, z_dim
        self.parent_id = tuple(int(x) for x in parent_id)
        self.black_background = black_background
        self.background_ratio = background_ratio
        self.train_ray_chunk = train_ray_chunk
        self.nerf = TriPlaneNARF(nerf_params, z_dim=z_dim * 2, z2_dim=z_dim,
                                 num_bone=self.model_num_bone, device=device)
        if pretrained_background and not black_background:
            self.background_generator = PretrainedStyleGAN(
                size, gen_size=pretrained_bg_size, style_dim=z_dim * 2,
                channel_max=channel_max, device=device)
        elif not black_background:
            self.background_generator = BackgroundGenerator(
                size, style_dim=z_dim, n_mlp=4, out_channels=3,
                crop_background=crop_background, channel_max=channel_max,
                device=device)
        init_parameters(self, generator or torch.Generator().manual_seed(0))

    def split_z(self, z: torch.Tensor):
        """z (B, 4 z_dim) → (z nerf (2 z_dim), z render, z background); a
        black-background model splits z in three and has no z background
        (None), as the JAX one."""
        if self.black_background:
            zd = z.shape[1] // 3
            return z[:, :zd * 2], z[:, zd * 2:], None
        zd = z.shape[1] // 4
        return z[:, :zd * 2], z[:, zd * 2: zd * 3], z[:, zd * 3:]

    def background(self, z_bg, z_rend, noise=None, crop=None,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """The background image, its styles mixed at n_latent - 4
        (``BackgroundGenerator`` or ``PretrainedStyleGAN`` for ``noise``,
        ``crop``, ``generator``)."""
        bg = self.background_generator
        return bg([z_bg, z_rend], inject_index=bg.n_latent - 4, noise=noise,
                  crop=crop, train=train, generator=generator)

    def fine_draw_rows(self, B: int) -> int:
        """Rows of the fine sampler's (u, jitter) pair for a batch of B:
        one a patch on the tiled path, one a ray on the exact one."""
        n = self.size * self.size
        if self.nerf.supports_tiled_sampling():
            return B * n // self.nerf_params.tile_patch ** 2
        return B * n

    def forward(self, pose_to_camera, pose_to_world, bone_length, z,
                inv_intrinsics, truncation_psi=1.0,
                black_bg_if_possible: bool = False,
                return_disparity: bool = False, train: bool = False,
                draws: Optional[Draws] = None, noise=None, crop=None,
                generator: Optional[torch.Generator] = None):
        """Generate images of the poses from z (the JAX ``__call__``).

        Renders every pixel (``train_ray_chunk`` rays of each image at a
        time; tiled in patch-major order on the tiled path) and composites
        over the background. In ``train`` mode the tri-plane mapping
        updates its ``w_avg``, the background is cropped at random, and
        the per-point network is recomputed in backward. Random numbers:
        the fine sampler's ``draws`` ((u, jitter), each
        ``fine_draw_rows(B)`` x Nf, batch-major; by chunk on the tiled path
        as ``render_rays_tiled`` splits them), the background's ``noise``
        and ``crop``, or what of them is missing from ``generator``. With
        ``black_bg_if_possible`` (or a ``black_background`` model) the
        background is black, -1, and draws nothing.
        Returns (image (B,3,H,W), fg_mask (B,H,W), aux) with aux holding
        fine_weights / fine_depth (raster ray order), tri_plane_feature,
        fg_color, bg_color, and with ``return_disparity`` disparity
        (B,H,W), the renderer's times ``coordinate_scale``.
        """
        B = pose_to_camera.shape[0]
        device = pose_to_camera.device
        if draws is None:
            if generator is None:
                raise ValueError("the GAN forward needs draws or a generator")
            draws = draw_fine_uniforms(self.fine_draw_rows(B),
                                       self.nerf_params.Nf, generator, device)
        _, img_coord = image_grid_coords(self.size, self.size, B,
                                         device=device)
        z_nerf, z_rend, z_bg = self.split_z(z)
        pose_t, bl_t = self.transform_pose(pose_to_camera, bone_length)
        planes = self.compute_tri_plane_feature(z_nerf, bl_t, truncation_psi,
                                                update_w_avg=train)
        chunk = self.train_ray_chunk or None
        cfg = self.render_cfg()
        if self.nerf.supports_tiled_sampling():
            P = self.nerf_params.tile_patch
            perm = torch.from_numpy(tile_permutation(self.size, P)).to(device)
            tables = self.pack_planes_tiled(planes)

            def fn_t(points, ray_dir, pose_scaled, n_patch, m, S):
                return self.nerf_density_color_tiled(
                    points, pose_scaled, bl_t, tables, z_rend, n_patch, m, S,
                    ray_dir)

            if train:
                fn_t = _recomputed_in_backward(fn_t)
            fg_color, fg_mask, disparity, raux = render_rays_tiled(
                fn_t, img_coord[..., perm], pose_t, inv_intrinsics, cfg, P,
                draws, ray_chunk=chunk)
            inv = torch.argsort(perm)
            fg_color, fg_mask = fg_color[:, :, inv], fg_mask[:, inv]
            disparity = disparity[:, inv]
            raux = {k: v[:, :, inv] for k, v in raux.items()}
        else:
            packed = self.pack_planes(planes)

            def fn(points, ray_dir, pose_scaled):
                return self.nerf_density_color(points, pose_scaled, bl_t,
                                               packed, z_rend, ray_dir)

            if train:
                fn = _recomputed_in_backward(fn)
            fg_color, fg_mask, disparity, raux = render_rays(
                fn, img_coord, pose_t, inv_intrinsics, cfg, draws,
                ray_chunk=chunk)
        fg_color = fg_color.reshape(B, 3, self.size, self.size)
        fg_mask = fg_mask.reshape(B, self.size, self.size)
        if self.black_background or black_bg_if_possible:
            bg_color = fg_color.new_tensor(-1.0)
        else:
            if noise is None and generator is None:
                raise ValueError("the background needs noise or a generator")
            bg_color = self.background(z_bg, z_rend, noise=noise, crop=crop,
                                       train=train, generator=generator)
        rendered = fg_color + (1 - fg_mask[:, None]) * bg_color
        aux = {"fine_weights": raux["fine_weights"],
               "fine_depth": raux["fine_depth"],
               "tri_plane_feature": planes,
               "fg_color": fg_color, "bg_color": bg_color}
        if return_disparity:
            aux["disparity"] = (disparity.reshape(B, self.size, self.size)
                                * self.nerf_params.coordinate_scale)
        return rendered, fg_mask, aux


def register_canonical_pose(gen: _TriPlaneGenerator, canonical_pose: np.ndarray,
                            origin_location: str, parent_id) -> _TriPlaneGenerator:
    """Fill the canonical-pose buffers from a (24, 4, 4) canonical pose."""
    canon, length = transform_canonical_pose(np.asarray(canonical_pose),
                                             np.asarray(parent_id),
                                             origin_location)
    nerf = gen.nerf
    with torch.no_grad():
        nerf.canonical_pose.copy_(torch.from_numpy(canon))
        nerf.canonical_bone_length.copy_(torch.from_numpy(length))
    return gen


@torch.no_grad()
def dso_render_entire_img(gen: DSONARFGenerator, pose_to_camera, inv_intrinsics,
                          frame_time, bone_length, camera_pose=None,
                          render_size: int = 128,
                          ray_batchsize: Optional[int] = None,
                          draws: Optional[Sequence[Draws]] = None,
                          generator: Optional[torch.Generator] = None):
    """Full-image DSO inference: planes computed and packed once per frame,
    then the chunked ray render. Returns (color (3,H,W), mask (H,W),
    disparity (H,W))."""
    z = gen.get_latents(frame_time, pose_to_camera)
    pose_t, bl_t = gen.transform_pose(pose_to_camera, bone_length)
    cond = gen.pack_planes(gen.compute_tri_plane_feature(z, bl_t))

    def fn(points, ray_dir, pose_scaled):
        return gen.nerf_density_color(points, pose_scaled, bl_t, cond, z,
                                      ray_dir)

    rb = ray_batchsize or gen.nerf_params.render_bs
    return render_entire_img(fn, pose_t, inv_intrinsics, gen.render_cfg(),
                             render_size, ray_batchsize=rb,
                             camera_pose=camera_pose, draws=draws,
                             generator=generator)


@torch.no_grad()
def dso_render_entire_img_tiled(gen: DSONARFGenerator, pose_to_camera,
                                inv_intrinsics, frame_time, bone_length,
                                camera_pose=None, render_size: int = 128,
                                ray_batchsize: Optional[int] = None,
                                draws: Optional[Sequence[Draws]] = None,
                                generator: Optional[torch.Generator] = None):
    """Patch-tiled full-image DSO inference (nerf/tiled.py +
    ops/tilewin.py): planes computed and packed into the texel table once per
    frame, then the chunked patch render. Same outputs as
    ``dso_render_entire_img`` up to the sampling-pattern change. ``draws``
    holds one (u, jitter) pair per chunk, each (patches per chunk, Nf)."""
    P = gen.nerf_params.tile_patch
    z = gen.get_latents(frame_time, pose_to_camera)
    pose_t, bl_t = gen.transform_pose(pose_to_camera, bone_length)
    tables = gen.pack_planes_tiled(gen.compute_tri_plane_feature(z, bl_t))

    def fn(points, ray_dir, pose_scaled, n_patch, m, S):
        return gen.nerf_density_color_tiled(points, pose_scaled, bl_t, tables,
                                            z, n_patch, m, S, ray_dir)

    rb = ray_batchsize or gen.nerf_params.render_bs
    return render_entire_img_tiled(fn, pose_t, inv_intrinsics,
                                   gen.render_cfg(), render_size, P,
                                   ray_batchsize=rb, camera_pose=camera_pose,
                                   draws=draws, generator=generator)


def make_dso_full_renderer(gen: DSONARFGenerator, render_size: int,
                           ray_batchsize: Optional[int] = None):
    """Full-image DSO renderer:
    ``render(pose_to_camera, inv_intrinsics, frame_time, bone_length,
    camera_pose=None, draws=None, generator=None)`` → (color, mask,
    disparity). Models with ``tile_patch`` on the candidate-sparse path
    render through the patch-tiled renderer, all others through the exact
    one, as the JAX factory routes them. Fine-sampler uniforms come from
    ``draws`` (one (u, jitter) pair per chunk: (rays, Nf) on the exact
    path, (patches, Nf) on the tiled one) or from ``generator``.
    Pixel-unit intrinsics and the whole image only, as the demo and
    ``validate`` render; the JAX package's normalized-intrinsics and crop
    options have no caller in the port."""
    full = dso_render_entire_img_tiled if gen.nerf.supports_tiled_sampling() \
        else dso_render_entire_img

    def render(pose_to_camera, inv_intrinsics, frame_time, bone_length,
               camera_pose=None, draws=None, generator=None):
        return full(
            gen, pose_to_camera, inv_intrinsics, frame_time, bone_length,
            camera_pose=camera_pose, render_size=render_size,
            ray_batchsize=ray_batchsize, draws=draws, generator=generator)

    return render


@torch.no_grad()
def gan_render_entire_img(gen: TriNARFGenerator, pose_to_camera, bone_length,
                          z, inv_intrinsics, truncation_psi=1.0,
                          render_size: Optional[int] = None,
                          ray_batchsize: Optional[int] = None,
                          draws: Optional[Sequence[Draws]] = None,
                          generator: Optional[torch.Generator] = None):
    """Full-image GAN foreground of batch item 0: planes generated from z
    (truncated towards ``w_avg`` by ``truncation_psi``) and packed once,
    then the chunked render, tiled for ``tile_patch`` models. ``draws``
    holds one (u, jitter) pair per chunk (rays of the chunk, or patches on
    the tiled path, x Nf), or ``generator`` draws them. Returns (color
    (3,H,W), mask (H,W), disparity (H,W))."""
    z_nerf, z_rend, _ = gen.split_z(z)
    pose_t, bl_t = gen.transform_pose(pose_to_camera, bone_length)
    planes = gen.compute_tri_plane_feature(z_nerf, bl_t, truncation_psi)
    cfg = gen.render_cfg()
    rb = ray_batchsize or gen.nerf_params.render_bs
    size = render_size or gen.size
    if gen.nerf.supports_tiled_sampling():
        tables = gen.pack_planes_tiled(planes)

        def fn_t(points, ray_dir, pose_scaled, n_patch, m, S):
            return gen.nerf_density_color_tiled(points, pose_scaled, bl_t,
                                                tables, z_rend, n_patch, m, S,
                                                ray_dir)

        return render_entire_img_tiled(fn_t, pose_t, inv_intrinsics, cfg,
                                       size, gen.nerf_params.tile_patch,
                                       ray_batchsize=rb, draws=draws,
                                       generator=generator)
    packed = gen.pack_planes(planes)

    def fn(points, ray_dir, pose_scaled):
        return gen.nerf_density_color(points, pose_scaled, bl_t, packed,
                                      z_rend, ray_dir)

    return render_entire_img(fn, pose_t, inv_intrinsics, cfg, size,
                             ray_batchsize=rb, draws=draws,
                             generator=generator)


def make_gan_full_renderer(gen: TriNARFGenerator,
                           render_size: Optional[int] = None,
                           ray_batchsize: Optional[int] = None):
    """Full-image GAN foreground renderer:
    ``render(pose_to_camera, bone_length, z, inv_intrinsics,
    truncation_psi=1.0, draws=None, generator=None)`` → (color, mask,
    disparity) of batch item 0 (``gan_render_entire_img``)."""

    def render(pose_to_camera, bone_length, z, inv_intrinsics,
               truncation_psi=1.0, draws=None, generator=None):
        return gan_render_entire_img(
            gen, pose_to_camera, bone_length, z, inv_intrinsics,
            truncation_psi=truncation_psi, render_size=render_size,
            ray_batchsize=ray_batchsize, draws=draws, generator=generator)

    return render
