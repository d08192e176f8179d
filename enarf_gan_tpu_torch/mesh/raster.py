"""Software mesh rasteriser for the demo (port of
``enarf_gan_tpu/mesh/raster.py``).

Z-buffered barycentric rasterisation with a Lambert term from a headlight
at the camera origin, vectorised in torch on the mesh's device where the
JAX package loops over faces in Python: each face is paired with the pixels
of its bounding box (in chunks of faces), the inside test and the depth
are computed for every pair in float64 with the JAX function's arithmetic,
and the z-buffer keeps for each pixel the nearest face, the first in the
far-to-near order among equal depths (``scatter_reduce("amin")`` on the
depth, then on the face's rank), which is what the JAX loop's strict
``<`` keeps. The image is the same up to ties on shared edges.
"""
from __future__ import annotations

import numpy as np
import torch

PAIRS_PER_CHUNK = 1 << 24       # face-pixel pairs tested at a time


def render_mesh_image(verts, faces, intrinsics, img_size: int,
                      render_size: int = 512, base_color=(1.0, 1.0, 1.0)
                      ) -> np.ndarray:
    """Rasterise a camera-frame mesh (``verts`` (V, 3), ``faces`` (F, 3),
    tensors or arrays; computed on ``verts``' device) seen through the
    pixel ``intrinsics`` (3, 3) of an ``img_size``² image, at
    ``render_size``². Returns (render_size, render_size, 3) uint8."""
    R = render_size
    verts = torch.as_tensor(verts)
    device = verts.device
    faces = torch.as_tensor(faces, device=device).long()
    if faces.shape[0] == 0 or verts.shape[0] == 0:
        return np.zeros((R, R, 3), np.uint8)
    K = torch.as_tensor(np.asarray(intrinsics, np.float64).copy(),
                        device=device)
    K[:2] *= R / img_size

    v = verts.double()
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    proj = [K[i, 0] * vx + K[i, 1] * vy + K[i, 2] * vz for i in range(3)]
    w = torch.clamp(proj[2], min=1e-8)
    uv = torch.stack([proj[0] / w, proj[1] / w], dim=1)
    tri_uv = uv[faces]                     # (F, 3, 2)
    tri_z = vz[faces]                      # (F, 3)
    tri_v = v[faces]                       # (F, 3, 3)

    # face normals and the headlight's Lambert term, double-sided
    n = torch.linalg.cross(tri_v[:, 1] - tri_v[:, 0],
                           tri_v[:, 2] - tri_v[:, 0])
    n = n / (torch.linalg.norm(n, dim=1, keepdim=True) + 1e-12)
    center = tri_v.mean(dim=1)
    light = -center / (torch.linalg.norm(center, dim=1, keepdim=True) + 1e-12)
    shade = 0.25 + 0.75 * (n * light).sum(dim=1).abs()

    # each face's pixel box, and the faces the JAX loop skips
    lo = torch.floor(tri_uv.min(dim=1).values).long()
    hi = torch.ceil(tri_uv.max(dim=1).values).long() + 1
    x0, y0 = lo[:, 0].clamp(min=0), lo[:, 1].clamp(min=0)
    x1, y1 = hi[:, 0].clamp(max=R), hi[:, 1].clamp(max=R)
    p0, p1, p2 = tri_uv[:, 0], tri_uv[:, 1], tri_uv[:, 2]
    e1, e2 = p1 - p0, p2 - p0
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    drawn = (x0 < x1) & (y0 < y1) & (tri_z > 0).all(dim=1) \
        & (det.abs() >= 1e-12)
    bw = (x1 - x0).clamp(min=0)
    counts = torch.where(drawn, bw * (y1 - y0).clamp(min=0), 0)
    # the JAX loop's far-to-near order; a face's rank in it breaks ties
    order = torch.argsort(-tri_z.mean(dim=1), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=device)
    z0, z1, z2 = tri_z.unbind(dim=1)

    hits_pix, hits_z, hits_rank = [], [], []
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if ends.numel() else 0
    start_face = 0
    while total and start_face < faces.shape[0]:
        # the faces whose pairs fit in this chunk (at least one face)
        base = int(ends[start_face - 1]) if start_face else 0
        stop = int(torch.searchsorted(ends, base + PAIRS_PER_CHUNK,
                                      right=True))
        stop = max(stop, start_face + 1)
        f = torch.arange(start_face, stop, device=device)
        f = torch.repeat_interleave(f, counts[start_face:stop])
        start_face = stop
        if f.numel() == 0:
            continue
        off = torch.arange(f.shape[0], device=device) \
            - (ends[f] - counts[f] - base)
        px = x0[f] + off % bw[f]
        py = y0[f] + off // bw[f]
        dx = (px.double() + 0.5) - p0[f, 0]
        dy = (py.double() + 0.5) - p0[f, 1]
        w1 = (dx * e2[f, 1] - dy * e2[f, 0]) / det[f]
        w2 = (e1[f, 0] * dy - e1[f, 1] * dx) / det[f]
        w0 = 1 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        zi = w0 * z0[f] + w1 * z1[f] + w2 * z2[f]
        hits_pix.append((py * R + px)[inside])
        hits_z.append(zi[inside])
        hits_rank.append(rank[f][inside])
    img = torch.zeros((R * R, 3), dtype=torch.float64, device=device)
    if hits_pix:
        pix, zi, rk = (torch.cat(x) for x in (hits_pix, hits_z, hits_rank))
        depth = torch.full((R * R,), float("inf"), dtype=torch.float64,
                           device=device)
        depth.scatter_reduce_(0, pix, zi, "amin")
        nearest = zi == depth[pix]
        first = torch.full((R * R,), order.shape[0], dtype=torch.long,
                           device=device)
        first.scatter_reduce_(0, pix[nearest], rk[nearest], "amin")
        covered = first < order.shape[0]
        color = torch.tensor(base_color, dtype=torch.float64, device=device)
        img[covered] = color * shade[order[first[covered]]][:, None]
    img = torch.clamp(img * 255, 0, 255).to(torch.uint8)
    return img.reshape(R, R, 3).cpu().numpy()
