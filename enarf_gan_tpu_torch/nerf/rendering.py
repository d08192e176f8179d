"""Volume rendering: frustum clipping, coarse→fine sampling, compositing
(port of ``enarf_gan_tpu/nerf/rendering.py``).

The model plugs in as a closure ``density_color_fn(points (B,3,m),
ray_dir (B,3,n)|None, pose_scaled) -> (density (B,1,m), color (B,3,m)|None)``.

Random draws: ``fine_sample_depths`` takes its bin uniforms ``u`` and
in-bin ``jitter`` as tensors, which ``draw_fine_uniforms`` draws from an
explicit ``torch.Generator``. ``render_entire_img`` takes one (u, jitter)
pair per ray chunk, each (chunk, Nf), applied to the rays of that chunk in
valid-first order, so a caller can feed the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

SQRT3 = 3.0 ** 0.5
N_DEPTH_PROBE = 32
Draws = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    Nc: int = 48
    Nf: int = 64
    near_plane: float = 0.3
    far_plane: float = 5.0
    render_scale: float = 1.0
    coordinate_scale: float = 1.0
    view_dependent: bool = False
    tile_coarse_corners: bool = False   # nerf/tiled.py: coarse pass on the
                                        # patch's 4 corner rays


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace`` with tensor end points, computed as JAX does
    (start*(1-t) + stop*t, last point exactly ``stop``)."""
    t = torch.arange(num - 1, dtype=torch.float32, device=start.device) / (num - 1)
    return torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])


def decide_frustum_range(image_coord: torch.Tensor, pose_to_camera: torch.Tensor,
                         inv_intrinsics: torch.Tensor, near_plane: float,
                         far_plane: float):
    """Per-ray [near, far] from the ray's intersections with the per-bone
    [-1, 1]^3 cubes, probed at 32 depths.

    Args: image_coord (B, 1, 3, n) homogeneous pixels; pose_to_camera
    (B, K, 4, 4); inv_intrinsics (3, 3) or (B, 3, 3).
    Returns: depth_min, depth_max (B, 1, 1, n); ray_direction (B, 3, n);
    validity (B, 1, 1, n) bool. Near and far of the probe come from the
    joints of the whole batch; rays that miss every cube fall back to the
    configured planes.
    """
    B, _, _, n = image_coord.shape
    joints_z = pose_to_camera[:, :, 2, 3]
    near = torch.clamp(joints_z.min() - SQRT3, min=near_plane)
    far = torch.clamp(joints_z.max() + SQRT3, min=far_plane)

    R = pose_to_camera[:, :, :3, :3]
    t = pose_to_camera[:, :, :3, 3:]
    coords = image_coord.reshape(B, 3, n)
    if inv_intrinsics.dim() == 2:
        ray_direction = torch.einsum("ij,bjn->bin", inv_intrinsics, coords)
    else:
        ray_direction = torch.einsum("bij,bjn->bin", inv_intrinsics, coords)

    depths = _linspace(near, far, N_DEPTH_PROBE)           # (S,)
    pts = ray_direction[:, None, :, :, None] * depths      # (B, 1, 3, n, S)
    pts = pts - t[:, :, :, :, None]                        # (B, K, 3, n, S)
    local = torch.einsum("bkji,bkjns->bkins", R, pts)
    inside = (local.abs() <= 1).all(dim=2)                 # (B, K, n, S)

    large = 1e3
    dmin = torch.where(inside, depths, torch.full_like(depths, large)).amin(3)
    dmax = torch.where(inside, depths, torch.full_like(depths, -large)).amax(3)
    dmin = dmin.amin(1)[:, None, None, :]                  # (B, 1, 1, n)
    dmax = dmax.amax(1)[:, None, None, :]

    validity = dmin != large
    dmin = torch.where(validity, dmin, torch.full_like(dmin, near_plane))
    dmax = torch.where(dmax != -large, dmax, torch.full_like(dmax, far_plane))
    dmin = dmin.clamp_min(near_plane)
    return dmin, dmax, ray_direction, validity


def coarse_sample(image_coord, pose_to_camera, inv_intrinsics,
                  near_plane: float = 0.3, far_plane: float = 5.0,
                  Nc: int = 64, camera_pose=None, view_dependent: bool = False,
                  frustum=None):
    """Uniform bin midpoints per ray.

    Returns (coarse_depth (B,1,n,Nc+1), ray_dir_world (B,3,n)|None,
    coarse_points (B,3,n*Nc), validity (B,1,1,n), depth_min/max (B,1,n),
    start/end (B,3,n)).
    """
    B = image_coord.shape[0]
    if frustum is None:
        frustum = decide_frustum_range(image_coord, pose_to_camera,
                                       inv_intrinsics, near_plane, far_plane)
    dmin, dmax, ray_direction, validity = frustum
    if view_dependent:
        if camera_pose is None:
            raise ValueError("view-dependent rendering needs camera_pose")
        rd = ray_direction / torch.linalg.norm(ray_direction, dim=1,
                                               keepdim=True)
        rot = camera_pose[:, :3, :3] if camera_pose.shape[-1] == 4 else camera_pose
        ray_dir_world = torch.einsum("bji,bjn->bin", rot, rd)
    else:
        ray_dir_world = None

    dmin2 = dmin[:, 0]                                     # (B, 1, n)
    dmax2 = dmax[:, 0]
    start = dmin2 * ray_direction                          # (B, 3, n)
    end = dmax2 * ray_direction
    bins = _linspace(dmin.new_zeros(()), dmin.new_ones(()), Nc + 1) \
        .reshape(1, 1, 1, Nc + 1)
    coarse_depth = dmin2[..., None] * (1 - bins) + dmax2[..., None] * bins
    pts = start[..., None] * (1 - bins) + end[..., None] * bins
    pts = (pts[..., 1:] + pts[..., :-1]) / 2
    coarse_points = pts.reshape(B, 3, -1)
    return (coarse_depth, ray_dir_world, coarse_points, validity,
            dmin2, dmax2, start, end)


def _smooth_pad_weights(weights: torch.Tensor) -> torch.Tensor:
    """Max-of-neighbours smoothing + 0.01 floor over (R, Nc) weights."""
    w = torch.nn.functional.pad(weights, (1, 1))
    return (torch.maximum(w[:, :-2], w[:, 1:-1]) +
            torch.maximum(w[:, 1:-1], w[:, 2:])) / 2 + 0.01


def draw_fine_uniforms(R: int, Nf: int, generator: torch.Generator,
                       device) -> Draws:
    """(u, jitter), each (R, Nf) uniform in [0, 1), from ``generator``."""
    u = torch.rand((R, Nf), generator=generator, device=generator.device)
    jitter = torch.rand((R, Nf), generator=generator, device=generator.device)
    return u.to(device), jitter.to(device)


def fine_sample_depths(weights: torch.Tensor, Nf: int, Nc: int,
                       u: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Importance-sample Nf sorted bin positions in [0, 1] from (R, Nc)
    weights: inverse-CDF bin pick with uniforms ``u``, plus in-bin
    ``jitter`` (both (R, Nf))."""
    cdf = torch.cumsum(weights, dim=1)
    cdf = cdf / cdf[:, -1:]
    idx = (cdf[:, None, :] < u[:, :, None]).sum(dim=2)    # (R, Nf)
    bins = (idx.to(weights.dtype) + jitter) / Nc
    return torch.sort(bins, dim=1).values


def coarse_to_fine_sample(density_fn, image_coord, pose_to_camera,
                          inv_intrinsics, cfg: RenderConfig, draws: Draws,
                          camera_pose=None, frustum=None):
    """Coarse pass → transmittance weights → fine depths and points."""
    B, _, _, n = image_coord.shape
    Nc, Nf = cfg.Nc, cfg.Nf
    (coarse_depth, ray_dir_world, coarse_points, validity,
     dmin, dmax, start, end) = coarse_sample(
        image_coord, pose_to_camera, inv_intrinsics, cfg.near_plane,
        cfg.far_plane, Nc, camera_pose, cfg.view_dependent, frustum=frustum)

    with torch.no_grad():
        coarse_density, _ = density_fn(coarse_points, None, pose_to_camera)

    Np = coarse_depth.shape[-1]  # Nc + 1
    density = coarse_density.reshape(B, 1, n, Nc)[..., :Np - 1]
    delta = coarse_depth[..., 1:] - coarse_depth[..., :-1]
    dd = density * delta * cfg.render_scale
    T_i = torch.exp(-(torch.cumsum(dd, dim=3) - dd))
    weights = (T_i * (1 - torch.exp(-dd))).reshape(B * n, Np - 1)
    weights = _smooth_pad_weights(weights)

    bins = fine_sample_depths(weights, Nf, Nc, *draws).reshape(B, 1, n, Nf)
    fine_depth = dmin[..., None] * (1 - bins) + dmax[..., None] * bins
    fine_points = (start[:, :, :, None] * (1 - bins) +
                   end[:, :, :, None] * bins).reshape(B, 3, n * Nf)
    return fine_depth, fine_points, ray_dir_world, validity


def render_rays(density_color_fn, image_coord, pose_to_camera, inv_intrinsics,
                cfg: RenderConfig, draws: Draws, camera_pose=None,
                frustum=None, pose_prescaled: bool = False):
    """Render one chunk of rays → (color (B,3,n), mask (B,n),
    disparity (B,n)). ``draws`` is the (u, jitter) pair of the fine
    sampler, each (B*n, Nf). The coarse pass runs without gradients; the
    fine pass is differentiable, so this is also the training render.
    (The JAX function's aux outputs, fine weights and depths, feed only the
    GAN's losses and come with the GAN slice.)"""
    B, _, _, n = image_coord.shape
    if cfg.coordinate_scale != 1 and not pose_prescaled:
        pose_to_camera = pose_to_camera.clone()
        pose_to_camera[:, :, :3, 3] *= cfg.coordinate_scale

    fine_depth, fine_points, ray_dir_world, validity = coarse_to_fine_sample(
        density_color_fn, image_coord, pose_to_camera, inv_intrinsics, cfg,
        draws, camera_pose, frustum=frustum)
    fine_density, fine_color = density_color_fn(fine_points, ray_dir_world,
                                                pose_to_camera)
    Np = fine_depth.shape[-1]  # Nf
    fine_color = fine_color.reshape(B, 3, n, Np)[..., :Np - 1]
    fine_density = fine_density.reshape(B, 1, n, Np)[..., :Np - 1]

    delta = fine_depth[..., 1:] - fine_depth[..., :-1]
    dd = fine_density * delta * cfg.render_scale
    T_i = torch.exp(-(torch.cumsum(dd, dim=3) - dd))
    weights = T_i * (1 - torch.exp(-dd))                   # (B, 1, n, Np-1)

    depth_mid = fine_depth[..., :-1]
    color = torch.sum(weights * fine_color, dim=3)         # (B, 3, n)
    mask = torch.sum(weights, dim=3).reshape(B, n)
    disparity = torch.sum(weights / depth_mid, dim=3).reshape(B, n)

    valid = validity.reshape(B, 1, n)
    color = torch.where(valid, color, torch.zeros_like(color))
    mask = torch.where(valid[:, 0], mask, torch.zeros_like(mask))
    disparity = torch.where(valid[:, 0], disparity, torch.zeros_like(disparity))
    return color, mask, disparity


def render_entire_img(density_color_fn, pose_to_camera, inv_intrinsics,
                      cfg: RenderConfig, render_size: int,
                      ray_batchsize: int = 16384, camera_pose=None,
                      draws: Optional[Sequence[Draws]] = None,
                      generator: Optional[torch.Generator] = None):
    """Full-image render of batch item 0 in chunks of ``ray_batchsize`` rays.

    Rays are processed valid-first, and chunks holding no valid ray are not
    rendered (their rays are zero either way). ``draws`` holds one (u,
    jitter) pair per chunk, each (chunk, Nf); without it the pairs come from
    ``generator``. Returns (color (3,H,W), mask (H,W), disparity (H,W)).
    """
    device = pose_to_camera.device
    npix = render_size * render_size
    idx = np.arange(npix)
    xs = (idx % render_size + 0.5).astype(np.float32)
    ys = (idx // render_size + 0.5).astype(np.float32)
    coords = torch.from_numpy(np.stack([xs, ys, np.ones_like(xs)])).to(device)

    chunk = min(ray_batchsize, npix)
    n_chunks = -(-npix // chunk)
    if draws is None:
        if generator is None:
            raise ValueError("render_entire_img needs draws or a generator")
        draws = [draw_fine_uniforms(chunk, cfg.Nf, generator, device)
                 for _ in range(n_chunks)]
    if len(draws) != n_chunks:
        raise ValueError(f"{len(draws)} draws for {n_chunks} chunks")
    p2c = pose_to_camera[:1].clone()
    if cfg.coordinate_scale != 1:
        p2c[:, :, :3, 3] *= cfg.coordinate_scale

    dmin, dmax, ray_dir, validity = decide_frustum_range(
        coords.reshape(1, 1, 3, npix), p2c, inv_intrinsics, cfg.near_plane,
        cfg.far_plane)
    valid1 = validity.reshape(npix)
    order = torch.argsort((~valid1).to(torch.uint8), stable=True)  # valid first
    n_valid = int(valid1.sum())          # the frame's one host sync

    color = torch.zeros((1, 3, npix), device=device)
    mask = torch.zeros((1, npix), device=device)
    disp = torch.zeros((1, npix), device=device)
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, npix)
        if lo >= n_valid:
            break                        # only invalid rays remain
        sel = order[lo:hi]
        u, jitter = draws[c]
        frustum = (dmin[..., sel], dmax[..., sel], ray_dir[..., sel],
                   validity[..., sel])
        col, msk, dsp = render_rays(
            density_color_fn, coords[:, sel].reshape(1, 1, 3, -1), p2c,
            inv_intrinsics, cfg, (u[:hi - lo], jitter[:hi - lo]),
            camera_pose, frustum=frustum, pose_prescaled=True)
        color[..., sel] = col
        mask[..., sel] = msk
        disp[..., sel] = dsp
    return (color.reshape(3, render_size, render_size),
            mask.reshape(render_size, render_size),
            disp.reshape(render_size, render_size))
