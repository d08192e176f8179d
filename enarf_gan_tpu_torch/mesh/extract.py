"""Mesh extraction from density fields (port of
``enarf_gan_tpu/mesh/extract.py``).

The density is evaluated on a voxel grid around the body centre in chunks
of points made on the device from their linear index, and the float32
volume stays there; at the demo's default voxel of 0.003 it is a 667³ grid
(297 M points, 1.19 GB). The iso-surface is marching tetrahedra (the cube
split into 6 tetrahedra), in torch on the volume's device: the cubes that
the surface crosses are found from the 8 shifted views of the volume, and
only their corners are gathered, in the C order of the JAX function's
cube array, so that vertices and faces come out in the order it gives
them. ``gan_create_mesh`` and ``dso_create_mesh`` pack the planes once per
mesh and evaluate the density without ray directions (kernel 1 or 1f on
the card).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

# the unit cube's corners, bit i of a corner's index the offset on axis i
# (x fastest), and its split into 6 tetrahedra (corner indices)
_CUBE_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                 (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))
_TETS = ((0, 5, 1, 3), (0, 5, 3, 7), (0, 3, 2, 7),
         (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7))
# for each apex of a tetrahedron, its other three corners in order
_OTHERS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def grid_half(voxel_size: float, cube_half: Optional[int] = None) -> int:
    """Half the grid's side in voxels: 1 / voxel_size (the grid spans
    [-1, 1]) unless given."""
    return int(1 / voxel_size) if cube_half is None else cube_half


def density_grid(density_fn: Callable, center: torch.Tensor,
                 voxel_size: float, coordinate_scale: float = 1.0,
                 cube_half: Optional[int] = None, chunk: int = 262144
                 ) -> Tuple[torch.Tensor, np.ndarray]:
    """The density on the cubic grid around ``center``.

    Args:
        density_fn: (1, 3, n) scaled camera-frame points → (1, 1, n)
            density.
        center: (3,) body centre (camera frame, unscaled), on the device
            the points are made on.
        cube_half: half the grid's side in voxels (``grid_half``).
    Returns:
        (volume (D, D, D) float32 on ``center``'s device, its first index
        along x, bins (D,) the grid's offsets from the centre).
    """
    cube_half = grid_half(voxel_size, cube_half)
    bins = np.arange(-cube_half, cube_half + 1) * voxel_size
    D = bins.shape[0]
    n = D ** 3
    out = torch.empty(n, dtype=torch.float32, device=center.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out[s:e] = density_fn(grid_points(
            center, voxel_size, coordinate_scale, cube_half, s, e)
        ).reshape(-1)
    return out.reshape(D, D, D), bins


def grid_points(center: torch.Tensor, voxel_size: float,
                coordinate_scale: float, cube_half: int, start: int,
                stop: int) -> torch.Tensor:
    """Points ``start`` to ``stop`` (linear, C order) of the grid of
    ``density_grid``, (1, 3, stop - start) scaled, made on ``center``'s
    device as the JAX function makes them: float64 offsets rounded to
    float32, then the centre added and the scale applied in float32."""
    D = 2 * cube_half + 1
    idx = torch.arange(start, stop, device=center.device)
    ijk = torch.stack([idx // (D * D), idx // D % D, idx % D])
    pts = ((ijk - cube_half).double() * voxel_size).float()
    return ((pts + center.to(torch.float32).reshape(3, 1))
            * coordinate_scale)[None]


def active_cubes(volume: torch.Tensor, threshold: float) -> torch.Tensor:
    """The linear indices (C order over the (D0-1, D1-1, D2-1) cubes) of
    the cubes with a corner inside (> threshold) and a corner outside:
    the max and the min of the 8 shifted views on either side of it, taken
    as booleans, so that a NaN corner counts as outside, as in JAX."""
    D0, D1, D2 = volume.shape
    any_in = any_out = None
    for dx, dy, dz in _CUBE_CORNERS:
        inside = volume[dx:dx + D0 - 1, dy:dy + D1 - 1, dz:dz + D2 - 1] \
            > threshold
        if any_in is None:
            any_in, any_out = inside, ~inside
        else:
            any_in = any_in | inside
            any_out = any_out | ~inside
    return torch.nonzero((any_in & any_out).reshape(-1)).reshape(-1)


def _interp(threshold, pa, pb, va, vb):
    """Where the iso-surface crosses the edge pa → pb: the crossing's
    fraction in float32, as numpy computes it from float32 values and a
    Python float, the positions in float64."""
    t = (threshold - va) / (vb - va + 1e-12)
    return pa + t.double()[:, None] * (pb - pa)


def _weld(tris: torch.Tensor, spacing: float):
    """Triangles (T, 3, 3) → (vertices, faces): vertices equal to 1e-5
    index units are one, numbered in the lexicographic order of their
    rounded coordinates and placed where their last copy lies (numpy's
    ``np.unique`` and fancy assignment); degenerate faces dropped."""
    verts_flat = tris.reshape(-1, 3)
    keys = torch.round(verts_flat * 1e5).long()
    uniq, idx = torch.unique(keys, dim=0, return_inverse=True)
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.zeros(uniq.shape[0], dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, idx, pos, "amax", include_self=False)
    verts = verts_flat[last]
    faces = idx.reshape(-1, 3)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return (verts * spacing).float(), faces[good]


def marching_tetrahedra(volume, threshold: float, spacing: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iso-surface of ``volume`` (a tensor, or an array taken to the CPU)
    at ``threshold`` (a Python float).

    Returns (vertices (V, 3) float32 in index coordinates * spacing, faces
    (F, 3) int64), on the volume's device, as the JAX function gives them.
    """
    volume = torch.as_tensor(volume)
    device = volume.device
    D0, D1, D2 = volume.shape
    cube = active_cubes(volume, threshold)
    if cube.shape[0] == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=device),
                torch.zeros((0, 3), dtype=torch.int64, device=device))
    origin = torch.stack([cube // ((D1 - 1) * (D2 - 1)),
                          cube // (D2 - 1) % (D1 - 1),
                          cube % (D2 - 1)], dim=1)                  # (C, 3)
    corners = torch.tensor(_CUBE_CORNERS, device=device)
    offsets = (corners[:, 0] * D1 + corners[:, 1]) * D2 + corners[:, 2]
    base = (origin[:, 0] * D1 + origin[:, 1]) * D2 + origin[:, 2]
    corner_val = volume.reshape(-1)[base[:, None] + offsets[None]]  # (C, 8)
    others = torch.tensor(_OTHERS, device=device)

    tri_list = []
    for tet in _TETS:
        tet_t = torch.tensor(tet, device=device)
        p = (origin[:, None, :] + corners[tet_t][None]).double()  # (C, 4, 3)
        v = corner_val[:, tet_t]                                 # (C, 4)
        ins = v > threshold
        n_in = ins.sum(dim=1)
        # one corner inside → one triangle; three inside → one triangle
        # (flipped); two inside → a quad (two triangles)
        for target, flip in ((1, False), (3, True)):
            sel = n_in == target
            if not bool(sel.any()):
                continue
            want = ins[sel] if target == 1 else ~ins[sel]
            apex = torch.argmax(want.to(torch.uint8), dim=1)
            rows = torch.arange(apex.shape[0], device=device)
            ps, vs = p[sel], v[sel]
            oth = others[apex]
            pa, va = ps[rows, apex], vs[rows, apex]
            tri = torch.stack([
                _interp(threshold, pa, ps[rows, oth[:, k]], va,
                        vs[rows, oth[:, k]]) for k in range(3)], dim=1)
            tri_list.append(tri.flip(1) if flip else tri)
        sel = n_in == 2
        if bool(sel.any()):
            # the 2 inside corners first, then the 2 outside, each in order
            order = torch.argsort((~ins[sel]).to(torch.uint8), dim=1,
                                  stable=True)
            ps, vs = p[sel], v[sel]
            r = torch.arange(order.shape[0], device=device)
            i0, i1, o0, o1 = order.unbind(dim=1)

            def edge(a, b):
                return _interp(threshold, ps[r, a], ps[r, b], vs[r, a],
                               vs[r, b])

            e00, e01, e10, e11 = edge(i0, o0), edge(i0, o1), edge(i1, o0), \
                edge(i1, o1)
            tri_list.append(torch.stack([e00, e10, e01], dim=1))
            tri_list.append(torch.stack([e01, e10, e11], dim=1))
    return _weld(torch.cat(tri_list), spacing)


def extract_mesh(density_fn: Callable, center: torch.Tensor,
                 voxel_size: float, mesh_th: float = 15.0,
                 coordinate_scale: float = 1.0,
                 cube_half: Optional[int] = None, chunk: int = 262144
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked density and its iso-surface; vertices in the camera frame,
    on ``center``'s device."""
    vol, _ = density_grid(density_fn, center, voxel_size, coordinate_scale,
                          cube_half, chunk)
    verts, faces = marching_tetrahedra(vol, mesh_th)
    verts = (verts - grid_half(voxel_size, cube_half)) * voxel_size \
        + center.to(torch.float32).reshape(1, 3)
    return verts, faces


def _scaled(pose_t: torch.Tensor, scale: float) -> torch.Tensor:
    out = pose_t.clone()
    out[:, :, :3, 3] *= scale
    return out


@torch.no_grad()
def gan_create_mesh(gen, pose_to_camera, bone_length, z,
                    voxel_size: float = 0.003, mesh_th: float = 15.0,
                    truncation_psi: float = 0.4,
                    cube_half: Optional[int] = None, chunk: int = 262144):
    """Mesh of batch item 0 of a ``TriNARFGenerator``: its planes from z
    (truncated by ``truncation_psi``), packed once, then
    ``extract_mesh``. Returns (vertices (V, 3) float32 in the camera
    frame, faces (F, 3) int64) on the model's device."""
    z_nerf, z_rend, _ = gen.split_z(z)
    pose_t, bl_t = gen.transform_pose(pose_to_camera, bone_length)
    packed = gen.pack_planes(
        gen.compute_tri_plane_feature(z_nerf, bl_t, truncation_psi))
    scale = gen.nerf_params.coordinate_scale
    pose_scaled = _scaled(pose_t, scale)

    def density_fn(points):
        return gen.nerf_density_color(points, pose_scaled, bl_t, packed,
                                      z_rend, None)[0]

    return extract_mesh(density_fn, pose_to_camera[0, 0, :3, 3], voxel_size,
                        mesh_th, scale, cube_half=cube_half, chunk=chunk)


@torch.no_grad()
def dso_create_mesh(gen, pose_to_camera, bone_length, frame_time,
                    voxel_size: float = 0.003, mesh_th: float = 15.0,
                    cube_half: Optional[int] = None, chunk: int = 262144):
    """Mesh of batch item 0 of a ``DSONARFGenerator`` at ``frame_time``:
    its planes packed once (the MLP baselines take z), then
    ``extract_mesh``."""
    z = gen.get_latents(frame_time, pose_to_camera)
    pose_t, bl_t = gen.transform_pose(pose_to_camera, bone_length)
    cond = gen.condition(z, bl_t)
    scale = gen.nerf_params.coordinate_scale
    pose_scaled = _scaled(pose_t, scale)

    def density_fn(points):
        return gen.nerf_density_color(points, pose_scaled, bl_t, cond, z,
                                      None)[0]

    return extract_mesh(density_fn, pose_to_camera[0, 0, :3, 3], voxel_size,
                        mesh_th, scale, cube_half=cube_half, chunk=chunk)
