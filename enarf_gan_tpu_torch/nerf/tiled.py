"""Patch-tiled volume rendering, the renderer of the patch-window sampler
(port of ``enarf_gan_tpu/nerf/tiled.py``).

Differences from ``nerf/rendering.py`` (the exact path):

* rays are processed in PxP pixel patches (a fixed tile permutation of the
  image grid);
* the coarse depth range [dmin, dmax] is pooled over each patch's valid
  rays, so all member rays share one set of Nc bin depths;
* the fine pass importance-samples one depth set per patch from the
  patch-pooled (valid-ray mean) coarse transmittance weights.

Both bound the across-ray spread of a patch's tri-plane texels, so that
``ops/tilewin.py`` reads one shared window per (patch, sample, bone, plane).
They change the sampling pattern, not the radiance field: the tiled frame
agrees with the exact one at the metric level, not bitwise.

The model plugs in as ``fn(points (B,3,n), ray_dir|None, pose_scaled,
n_patch, m, S) -> (density (B,1,n), color (B,3,n)|None)``, n = n_patch*m*S
in tiled point order; m is P*P, or 4 on the coarse pass with
``tile_coarse_corners``. Random draws: the fine sampler's (u, jitter) pair,
each (B * patches, Nf), one row per patch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from enarf_gan_tpu_torch.nerf.ray_sampler import image_grid_coords
from enarf_gan_tpu_torch.nerf.rendering import (Draws, RenderConfig,
                                                _linspace, _smooth_pad_weights,
                                                decide_frustum_range,
                                                draw_fine_uniforms,
                                                fine_sample_depths)


def tile_permutation(size: int, P: int) -> np.ndarray:
    """perm[i] = raster ray index of the i-th ray in patch-major order."""
    if size % P:
        raise ValueError(f"image size {size} is not a multiple of P={P}")
    idx = np.arange(size * size).reshape(size, size)
    return idx.reshape(size // P, P, size // P, P) \
        .transpose(0, 2, 1, 3).reshape(-1)


def _pool_patch(v: torch.Tensor, m: int, reduce, neutral: float,
                valid: torch.Tensor) -> torch.Tensor:
    """Reduce (B, np*m) member values → (B, np) over valid members."""
    B, n = v.shape
    vv = torch.where(valid, v, torch.full_like(v, neutral))
    return reduce(vv.reshape(B, n // m, m), dim=2)


def render_rays_tiled(fn, image_coord, pose_to_camera, inv_intrinsics,
                      cfg: RenderConfig, P: int, draws: Draws,
                      camera_pose=None, pose_prescaled: bool = False,
                      frustum=None, ray_chunk: Optional[int] = None):
    """Render rays already in patch-major order (m = P*P members a patch).

    ``draws`` is the fine sampler's (u, jitter) pair, each (B*n_patch, Nf).
    ``ray_chunk`` renders fixed-size chunks of whole patches one after the
    other, with the same results. Returns (color (B,3,n), mask (B,n),
    disparity (B,n)). The coarse pass runs without gradients; the fine pass
    is differentiable, so this is also the training render. (The JAX
    function's aux outputs feed only the GAN's losses and come with the GAN
    slice.)
    """
    B, _, _, n = image_coord.shape
    m = P * P
    n_patch = n // m
    if n_patch * m != n:
        raise ValueError(f"{n} rays are not whole {P}x{P} patches")
    if cfg.coordinate_scale != 1 and not pose_prescaled:
        pose_to_camera = pose_to_camera.clone()
        pose_to_camera[:, :, :3, 3] *= cfg.coordinate_scale
    if ray_chunk is not None and n > ray_chunk:
        if frustum is not None:
            raise ValueError("a precomputed frustum cannot be chunked")
        chunk = ray_chunk - ray_chunk % m
        if chunk <= 0 or n % chunk:
            raise ValueError(f"ray_chunk {ray_chunk} does not split {n} rays "
                             f"into whole patches")
        pc = chunk // m
        u, jitter = (d.reshape(B, n_patch, -1) for d in draws)
        outs = [render_rays_tiled(
            fn, image_coord[..., lo:lo + chunk], pose_to_camera,
            inv_intrinsics, cfg, P,
            (u[:, lo // m:lo // m + pc].reshape(B * pc, -1),
             jitter[:, lo // m:lo // m + pc].reshape(B * pc, -1)),
            camera_pose=camera_pose, pose_prescaled=True)
            for lo in range(0, n, chunk)]
        return tuple(torch.cat(x, dim=-1) for x in zip(*outs))

    Nc, Nf = cfg.Nc, cfg.Nf
    if frustum is None:
        frustum = decide_frustum_range(image_coord, pose_to_camera,
                                       inv_intrinsics, cfg.near_plane,
                                       cfg.far_plane)
    dmin, dmax, ray_direction, validity = frustum   # (B,1,1,n) / (B,3,n)

    # patch-pooled depth range over valid member rays
    val = validity.reshape(B, n)
    big = 1e9
    dmin_p = _pool_patch(dmin.reshape(B, n), m, torch.amin, big, val)
    dmax_p = _pool_patch(dmax.reshape(B, n), m, torch.amax, -big, val)
    any_valid = dmin_p < big
    dmin_p = torch.where(any_valid, dmin_p,
                         torch.full_like(dmin_p, cfg.near_plane))  # (B, np)
    dmax_p = torch.where(any_valid, dmax_p,
                         torch.full_like(dmax_p, cfg.far_plane))

    if cfg.view_dependent:
        if camera_pose is None:
            raise ValueError("view-dependent rendering needs camera_pose")
        rd = ray_direction / torch.linalg.norm(ray_direction, dim=1,
                                               keepdim=True)
        rot = camera_pose[:, :3, :3] if camera_pose.shape[-1] == 4 \
            else camera_pose
        ray_dir_world = torch.einsum("bji,bjn->bin", rot, rd)
    else:
        ray_dir_world = None

    # ---- coarse pass: Nc patch-common bin midpoints ----
    bins = _linspace(dmin_p.new_zeros(()), dmin_p.new_ones(()), Nc + 1) \
        .reshape(1, 1, Nc + 1)
    cd = dmin_p[:, :, None] * (1 - bins) + dmax_p[:, :, None] * bins
    cd_mid = (cd[..., 1:] + cd[..., :-1]) / 2               # (B, np, Nc)
    rd3 = ray_direction.reshape(B, 3, n_patch, m)
    valm = val.reshape(B, n_patch, m)
    if cfg.tile_coarse_corners and P >= 3:
        # the coarse density only steers the patch-pooled importance
        # weights; the patch's 4 corner rays pool to nearly the same
        corners = [0, P - 1, (P - 1) * P, P * P - 1]
        rd3c, valc = rd3[..., corners], valm[..., corners]
    else:
        rd3c, valc = rd3, valm
    mc = rd3c.shape[-1]
    pts_c = rd3c[..., None] * cd_mid[:, None, :, None, :]   # (B,3,np,mc,Nc)
    with torch.no_grad():
        coarse_density, _ = fn(pts_c.reshape(B, 3, -1), None, pose_to_camera,
                               n_patch, mc, Nc)

    # per-ray transmittance weights at the common bins, pooled per patch
    dens = coarse_density.reshape(B, 1, n_patch, mc, Nc)
    delta = (cd[..., 1:] - cd[..., :-1])[:, None, :, None, :]
    dd = dens * delta * cfg.render_scale
    T_i = torch.exp(-(torch.cumsum(dd, dim=4) - dd))
    w_ray = T_i * (1 - torch.exp(-dd))                      # (B,1,np,mc,Nc)
    vmem = valc[:, None, :, :, None].to(w_ray.dtype)
    w_sum = (w_ray * vmem).sum(dim=3)
    w_cnt = vmem.sum(dim=3).clamp(min=1.0)
    w_patch = _smooth_pad_weights((w_sum / w_cnt).reshape(B * n_patch, Nc))

    # ---- fine pass: Nf patch-common importance depths ----
    fb = fine_sample_depths(w_patch, Nf, Nc, *draws).reshape(B, n_patch, Nf)
    fd = dmin_p[:, :, None] * (1 - fb) + dmax_p[:, :, None] * fb  # (B,np,Nf)
    pts_f = rd3[..., None] * fd[:, None, :, None, :]        # (B,3,np,m,Nf)
    fine_density, fine_color = fn(pts_f.reshape(B, 3, -1), ray_dir_world,
                                  pose_to_camera, n_patch, m, Nf)

    # ---- composite (the math of nerf/rendering.py::render_rays) ----
    fine_depth = fd[:, None, :, None, :].expand(B, 1, n_patch, m, Nf) \
        .reshape(B, 1, n, Nf)
    fine_color = fine_color.reshape(B, 3, n, Nf)[..., :Nf - 1]
    fine_density = fine_density.reshape(B, 1, n, Nf)[..., :Nf - 1]
    delta_f = fine_depth[..., 1:] - fine_depth[..., :-1]
    dd = fine_density * delta_f * cfg.render_scale
    T_i = torch.exp(-(torch.cumsum(dd, dim=3) - dd))
    weights = T_i * (1 - torch.exp(-dd))
    depth_mid = fine_depth[..., :-1]
    color = torch.sum(weights * fine_color, dim=3)          # (B, 3, n)
    mask = torch.sum(weights, dim=3).reshape(B, n)
    disparity = torch.sum(weights / depth_mid, dim=3).reshape(B, n)

    valid1 = validity.reshape(B, 1, n)
    color = torch.where(valid1, color, torch.zeros_like(color))
    mask = torch.where(valid1[:, 0], mask, torch.zeros_like(mask))
    disparity = torch.where(valid1[:, 0], disparity,
                            torch.zeros_like(disparity))
    return color, mask, disparity


def render_entire_img_tiled(fn, pose_to_camera, inv_intrinsics,
                            cfg: RenderConfig, render_size: int, P: int,
                            ray_batchsize: int = 16384, camera_pose=None,
                            draws: Optional[Sequence[Draws]] = None,
                            generator: Optional[torch.Generator] = None):
    """Full-image render of batch item 0 in chunks of whole patches.

    Patches holding a valid ray are rendered first, and chunks holding no
    valid ray are not rendered (their rays are zero either way); finding
    them costs one host read a frame. ``draws`` holds one (u, jitter) pair
    per chunk, each (patches per chunk, Nf); without it the pairs come from
    ``generator``. Returns (color (3,H,W), mask (H,W), disparity (H,W)).
    """
    size = render_size
    m = P * P
    device = pose_to_camera.device
    perm = torch.from_numpy(tile_permutation(size, P)).to(device)
    _, img_coord = image_grid_coords(size, size, 1, device=device)
    img_coord = img_coord[..., perm]                        # patch-major rays
    n = size * size
    pose_to_camera = pose_to_camera[:1].clone()             # batch-1 renderer
    if inv_intrinsics.dim() == 3:
        inv_intrinsics = inv_intrinsics[:1]
    if camera_pose is not None:
        camera_pose = camera_pose[:1]
    if cfg.coordinate_scale != 1:
        pose_to_camera[:, :, :3, 3] *= cfg.coordinate_scale

    chunk = max(min(ray_batchsize, n) // m, 1) * m
    n_chunks = -(-n // chunk)
    if draws is None:
        if generator is None:
            raise ValueError("render_entire_img_tiled needs draws or a "
                             "generator")
        draws = [draw_fine_uniforms(chunk // m, cfg.Nf, generator, device)
                 for _ in range(n_chunks)]
    if len(draws) != n_chunks:
        raise ValueError(f"{len(draws)} draws for {n_chunks} chunks")

    dmin, dmax, ray_dir, validity = decide_frustum_range(
        img_coord, pose_to_camera, inv_intrinsics, cfg.near_plane,
        cfg.far_plane)
    patch_valid = validity.reshape(n // m, m).any(dim=1)
    p_order = torch.argsort((~patch_valid).to(torch.uint8), stable=True)
    ray_order = (p_order[:, None] * m
                 + torch.arange(m, device=device)).reshape(-1)
    n_valid = int(patch_valid.sum()) * m     # the frame's one host sync

    color = torch.zeros((3, n), device=device)
    mask = torch.zeros(n, device=device)
    disp = torch.zeros(n, device=device)
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, n)
        if lo >= n_valid:
            break                            # only invalid patches remain
        sel = ray_order[lo:hi]
        u, jitter = draws[c]
        pc = (hi - lo) // m
        frustum = (dmin[..., sel], dmax[..., sel], ray_dir[..., sel],
                   validity[..., sel])
        col, msk, dsp = render_rays_tiled(
            fn, img_coord[..., sel], pose_to_camera, inv_intrinsics, cfg, P,
            (u[:pc], jitter[:pc]), camera_pose=camera_pose,
            pose_prescaled=True, frustum=frustum)
        rays = perm[sel]                     # raster index of each ray
        color[:, rays] = col[0]
        mask[rays] = msk[0]
        disp[rays] = dsp[0]
    return (color.reshape(3, size, size), mask.reshape(size, size),
            disp.reshape(size, size))
