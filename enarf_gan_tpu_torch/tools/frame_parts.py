"""The 128² DSO frame's pieces, timed alone (port of ``tools/bench_parts.py``
and ``tools/bench_tilewin_stages.py``).

On ``bench.py``'s frame (``frame_ablate.bench_frame``), for the exact path
and for the tiled one, each piece on the host clock (REPS calls after a
warm-up, ending in a synchronise) and on the device's (one more call under
``profile_by_class``):

  latents+transform   ``get_latents`` and ``transform_pose``
  tri-plane gen       the flow StyleGAN2 and its warp of the planes
                      (``compute_tri_plane_feature``)
  pack                ``pack_planes`` (``pack_texels``; on float32 planes
                      ``pack_texels_f32``), or on the tiled path
                      ``pack_planes_tiled`` (``pack_tilewin_texels``)
  chunk               one 4096-ray chunk, coarse and fine passes
                      (``render_rays`` / ``render_rays_tiled``), rows 40 on
  density_color       the point network on one chunk's coarse points
                      (exact: 4096 x Nc points uniform in [-1, 1]³, as the
                      JAX tool draws them; tiled: the chunk's coarse-corner
                      pass as it rendered it)
  frustum             each ray's depth range from the bones' cubes,
                      probed at 32 depths, over the whole frame
                      (``decide_frustum_range``)
  frame               the whole frame (``make_dso_full_renderer``)

and the sampler's own stages on the chunk's fine and coarse passes as it
rendered them (every piece is timed on the host clock before the first
profile): exact ``select_candidate_bones``, ``candidate_rows`` and
``unirow_combine`` (kernel 1), or on float32 planes
(``BENCH_PLANE_DTYPE=float32``) ``select_candidate_bones`` and
``sample_f32`` (kernel 1f, from the positions); tiled
``select_patch_slots``, ``texel_plan`` and ``tilewin_combine`` (kernel
2).

    python -m enarf_gan_tpu_torch.tools.frame_parts [--device cpu]

Variables: REPS (3), BENCH_TILED (one path; unset: both), and those of
``frame_ablate``. One JSON line a piece, with the peak memory allocated
while its timed calls ran (the frame's live tensors included).
"""
from __future__ import annotations

import os

import torch

from enarf_gan_tpu_torch.tools import benchkit
from enarf_gan_tpu_torch.tools.frame_ablate import bench_frame


def _chunk(gen, device, size: int, chunk: int, tile_patch: int):
    """``render(fn, pose_t, inv_K)``: one chunk of ``chunk`` rays from row
    40 on (whole patches, in patch order, on the tiled path) through the
    point network ``fn``, with fixed fine-sampler draws."""
    from enarf_gan_tpu_torch.nerf.ray_sampler import image_grid_coords
    from enarf_gan_tpu_torch.nerf.rendering import (draw_fine_uniforms,
                                                    render_rays)
    from enarf_gan_tpu_torch.nerf.tiled import (render_rays_tiled,
                                                tile_permutation)
    _, coords = image_grid_coords(size, size, 1, device=device)
    n = size * size
    cfg = gen.render_cfg()
    if tile_patch:
        m = tile_patch * tile_patch
        perm = torch.from_numpy(tile_permutation(size, tile_patch))
        coords = coords[..., perm.to(device)]
        lo = min(40 // tile_patch * (size // tile_patch) * m, n - chunk)
        draws = draw_fine_uniforms(chunk // m, cfg.Nf,
                                   torch.Generator(device=device)
                                   .manual_seed(1), device)
        coords = coords[..., max(lo, 0):max(lo, 0) + chunk]
        return lambda fn, pose_t, inv_K: render_rays_tiled(
            fn, coords, pose_t, inv_K, cfg, tile_patch, draws)
    lo = min(40 * size, n - chunk)
    coords = coords[..., max(lo, 0):max(lo, 0) + chunk]
    draws = draw_fine_uniforms(coords.shape[-1], cfg.Nf,
                               torch.Generator(device=device).manual_seed(1),
                               device)
    return lambda fn, pose_t, inv_K: render_rays(fn, coords, pose_t, inv_K,
                                                 cfg, draws)


def parts(device, tile_patch: int):
    """The path's pieces: [(piece, fn)]."""
    from enarf_gan_tpu_torch.nerf.ray_sampler import image_grid_coords
    from enarf_gan_tpu_torch.nerf.rendering import decide_frustum_range
    from enarf_gan_tpu_torch.ops import tilewin as tw
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.ops.triplane import select_candidate_bones
    size = benchkit.env_int("BENCH_RENDER_SIZE", 128)
    chunk = min(benchkit.env_int("BENCH_RAY_CHUNK", 4096), size * size)
    frame, gen = bench_frame(device, tile_patch)
    nerf, p = gen.nerf, gen.nerf_params
    pose_cam, _, bl, inv_K = benchkit.scene(
        1, size, device, benchkit.env_float("BENCH_FOCAL_SCALE", 1.2))
    ft = torch.tensor([0.5], device=device)
    with torch.no_grad():
        z = gen.get_latents(ft, pose_cam)
        pose_t, bl_t = gen.transform_pose(pose_cam, bl)
        planes = gen.compute_tri_plane_feature(z, bl_t)
    pack = gen.pack_planes_tiled if tile_patch else gen.pack_planes
    tables = pack(planes)
    render_chunk = _chunk(gen, device, size, chunk, tile_patch)

    calls = []                       # the point network's calls in a chunk
    if tile_patch:
        def fn(points, ray_dir, pose_scaled, n_patch, m, S):
            calls.append((points, pose_scaled, n_patch, m, S))
            return gen.nerf_density_color_tiled(points, pose_scaled, bl_t,
                                                tables, z, n_patch, m, S,
                                                ray_dir)
    else:
        def fn(points, ray_dir, pose_scaled):
            calls.append((points, pose_scaled))
            return gen.nerf_density_color(points, pose_scaled, bl_t, tables,
                                          z, ray_dir)

    with torch.no_grad():
        render_chunk(fn, pose_t, inv_K)
    coarse, fine = calls[0], calls[-1]
    pose_s = coarse[1]

    def latents():
        return gen.get_latents(ft, pose_cam), gen.transform_pose(pose_cam, bl)

    frame_coords = image_grid_coords(size, size, 1, device=device)[1]
    cfg = gen.render_cfg()

    out = [("latents+transform", latents),
           ("tri-plane gen (flow StyleGAN2 + warp)",
            lambda: gen.compute_tri_plane_feature(z, bl_t)),
           ("pack_planes_tiled (pack_tilewin_texels)" if tile_patch
            else "pack_planes (pack_texels_f32)"
            if isinstance(tables[0], unirow.Float32Texels)
            else "pack_planes (pack_texels)", lambda: pack(planes)),
           (f"frustum ({size}² rays x {pose_s.shape[1]} bones x 32 depths)",
            lambda: decide_frustum_range(frame_coords, pose_s, inv_K,
                                         cfg.near_plane, cfg.far_plane)),
           (f"chunk ({chunk} rays, coarse + fine)",
            lambda: render_chunk(fn, pose_t, inv_K))]
    if tile_patch:
        pts, _, n_patch, m, S = coarse
        out.append((f"density_color_tiled coarse pass ({pts.shape[-1]} pts)",
                    lambda: gen.nerf_density_color_tiled(
                        pts, pose_s, bl_t, tables, z, n_patch, m, S)))
        for label, (pts, _, n_patch, m, S) in (("fine", fine),
                                               ("coarse", coarse)):
            canonical, validity = nerf._canonical_validity(pts, pose_s, bl_t)
            slots = tw.select_patch_slots(canonical, validity, n_patch, m, S,
                                          p.max_bones_per_point)
            plan = tw.texel_plan(tables, slots[1], slots[0], slots[2])
            mode = None if m == 16 else "hat"
            out += [
                (f"select_patch_slots {label} (m={m}, S={S})",
                 lambda c=canonical, v=validity, a=(n_patch, m, S):
                 tw.select_patch_slots(c, v, *a, p.max_bones_per_point)),
                (f"texel_plan {label}",
                 lambda s=slots: tw.texel_plan(tables, s[1], s[0], s[2])),
                (f"tilewin_combine {label} (kernel 2)",
                 lambda pl=plan, S=S, mode=mode: tw.tilewin_combine(
                     tables.texels, pl.bases, pl.bones, pl.xt, pl.xs,
                     pl.valid, tables.feat_dim, S, p.clamp_mask, mode=mode))]
    else:
        g = torch.Generator(device="cpu").manual_seed(0)
        pts = (torch.rand((1, 3, chunk * p.Nc), generator=g) * 2 - 1).to(
            device)
        out.append((f"density_color coarse chunk ({pts.shape[-1]} pts)",
                    lambda: gen.nerf_density_color(pts, pose_s, bl_t, tables,
                                                   z, None)))
        (texels,) = tables
        ts = p.tri_plane_size
        for label, (pts, _) in (("fine", fine), ("coarse", coarse)):
            canonical, validity = nerf._canonical_validity(pts, pose_s, bl_t)
            cand = select_candidate_bones(canonical, validity,
                                          p.max_bones_per_point)
            out.append((f"select_candidate_bones {label}",
                        lambda c=canonical, v=validity: select_candidate_bones(
                            c, v, p.max_bones_per_point)))
            if isinstance(texels, unirow.Float32Texels):
                out.append((f"sample_f32 {label} (kernel 1f)",
                            lambda c=cand: unirow.sample_f32(
                                texels, c[2], c[0], c[1], p.feat_dim,
                                p.clamp_mask)))
                continue
            rows = unirow.candidate_rows(cand[2], cand[0], cand[1], ts, ts)
            out += [
                (f"candidate_rows {label}",
                 lambda c=cand: unirow.candidate_rows(c[2], c[0], c[1], ts,
                                                      ts)),
                (f"unirow_combine {label} (kernel 1)",
                 lambda r=rows: unirow.unirow_combine(
                     texels, *r, p.feat_dim, p.clamp_mask))]
    out.append(("frame", lambda: frame(1)))
    return out


def main(argv=None):
    args = benchkit.parser(__doc__).parse_args(argv)
    device = benchkit.resolve(args.device)
    reps = benchkit.env_int("REPS", 3)
    tiled = os.environ.get("BENCH_TILED")
    with torch.no_grad():
        pieces = [(f"tilewin{t}" if t else "exact", piece, fn)
                  for t in ([int(tiled)] if tiled is not None else [0, 4])
                  for piece, fn in parts(device, t)]
        # every piece on the host clock before the first profile: after a
        # torch.profiler session the host's launches may cost more
        timed = []
        for path, piece, fn in pieces:
            fn()                                           # warm-up
            benchkit.reset_peak(device)
            ms, _ = benchkit.host_ms(fn, reps, device)
            timed.append((ms, benchkit.peak_gib(device)))
        return [benchkit.emit(
            "frame_parts", device, path=path, piece=piece, reps=reps,
            ms_host=ms, peak_gib=peak,
            **benchkit.device_profile(fn, device, piece, ms, "call"))
            for (path, piece, fn), (ms, peak) in zip(pieces, timed)]


if __name__ == "__main__":
    main()
