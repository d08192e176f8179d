"""The tilewin coverage contract on a sparse (ZJU-like) frame, on the port.

tests/test_tilewin_sparse.py pins two regimes of the JAX package's tiled
sampler on a 64² frame at focal scale 0.35 (foreground 10-20% of the
pixels): at a low texel-per-pixel ratio (32² planes) tile_patch=4 meets
hard coverage bounds and the slot-selection rescue term cuts the candidate
capacity leak; at a high ratio (128² planes) 4x4 patches overflow the
8-texel window loudly while 2x2 patches stay within bounds. The same
fixture here (the port's scene, pose transform, frustum range, patch
pooling and canonical mapping, which the port's own tests hold to the JAX
package's) goes through the port's ``select_patch_slots``, ``RESCUE_W`` and
texel plan, and is held to the same bounds. Only the geometry matters: the
plan's coverage does not depend on the plane values.
"""
import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.data.fixtures import tiny_scene
from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu_torch.models import generator as tgen
from enarf_gan_tpu_torch.models.narf import NARFParams
from enarf_gan_tpu_torch.nerf.ray_sampler import image_grid_coords
from enarf_gan_tpu_torch.nerf.rendering import decide_frustum_range
from enarf_gan_tpu_torch.nerf.tiled import _pool_patch, tile_permutation
from enarf_gan_tpu_torch.ops import tilewin

# tests/test_tilewin_sparse.py:33-40
SIZE, TS, NC, P = 64, 32, 24, 4
FOCAL_SCALE = 0.35
TS_HIGH = 128
MP = 4
F, K = 32, 23


@pytest.fixture(scope="module")
def scene():
    params = NARFParams(Nc=NC, Nf=32, hidden_size=16, tri_plane_size=TS,
                        render_bs=SIZE * SIZE, coordinate_scale=3.0,
                        view_dependent=False, origin_location="center_fixed",
                        deformation_field=False, constant_triplane=True,
                        time_conditional=True, pose_conditional=False,
                        plane_sample_dtype="bfloat16", tile_patch=P)
    gen = tgen.DSONARFGenerator(params, num_bone=24, parent_id=SMPL_PARENTS,
                                device="cpu")
    pose_cam, _, bl, inv_K, canonical, _ = tiny_scene(
        1, SIZE, focal_scale=FOCAL_SCALE)
    tgen.register_canonical_pose(gen, canonical, "center_fixed",
                                 SMPL_PARENTS)
    with torch.no_grad():
        pose_t, bl_t = gen.transform_pose(torch.from_numpy(pose_cam),
                                          torch.from_numpy(bl))
    pose_scaled = pose_t.clone()
    pose_scaled[:, :, :3, 3] *= 3.0
    return gen, pose_scaled, bl_t, torch.from_numpy(inv_K)


@torch.no_grad()
def patch_points(scene, patch):
    """Patch-major coarse points as nerf/tiled.py's coarse pass builds them
    (tests/test_tilewin_sparse.py:61 ``_patch_points``): (foreground share,
    canonical (1, K, 3, n), validity (1, K, n), n_patch, m)."""
    gen, pose_scaled, bl_t, inv_K = scene
    m = patch * patch
    n = SIZE * SIZE
    n_patch = n // m
    perm = torch.from_numpy(tile_permutation(SIZE, patch))
    _, coord = image_grid_coords(SIZE, SIZE, 1, device="cpu")
    dmin, dmax, ray_dir, validity = decide_frustum_range(
        coord[..., perm], pose_scaled, inv_K, 0.3, 5.0)
    fg = float(validity.float().mean())
    val = validity.reshape(1, n)
    big = 1e9
    dmin_p = _pool_patch(dmin.reshape(1, n), m, torch.amin, big, val)
    dmax_p = _pool_patch(dmax.reshape(1, n), m, torch.amax, -big, val)
    ok = dmin_p < big
    dmin_p = torch.where(ok, dmin_p, torch.full_like(dmin_p, 0.3))
    dmax_p = torch.where(ok, dmax_p, torch.full_like(dmax_p, 5.0))
    bins = torch.linspace(0.0, 1.0, NC + 1).reshape(1, 1, NC + 1)
    cd = dmin_p[:, :, None] * (1 - bins) + dmax_p[:, :, None] * bins
    cd_mid = (cd[..., 1:] + cd[..., :-1]) / 2                # (1, np, NC)
    rd3 = ray_dir.reshape(1, 3, n_patch, m)
    pts = (rd3[..., None] * cd_mid[:, None, :, None, :]).reshape(1, 3, -1)
    canon, point_valid = gen.nerf._canonical_validity(pts, pose_scaled, bl_t)
    return fg, canon, point_valid, n_patch, m


def leak(canon, point_valid, n_patch, m):
    """Capacity leak: members valid for some bone but covered by no slot."""
    _, _, cand_valid = tilewin.select_patch_slots(canon, point_valid, n_patch,
                                                  m, NC, MP)
    valid_any = point_valid.any(dim=1).reshape(1, n_patch, m, NC)
    covered = cand_valid.any(dim=1)
    return float((valid_any & ~covered).sum()) / max(float(valid_any.sum()),
                                                     1.0)


def window_stats(canon, point_valid, n_patch, m, ts):
    """(clamped share of valid fetches, whole-point drop share) of the
    port's slots and texel plan at ``ts``² planes."""
    slot_idx, cand_pos, cand_valid = tilewin.select_patch_slots(
        canon, point_valid, n_patch, m, NC, MP)
    tables = tilewin.pack_tilewin_texels(
        torch.zeros((1, (F + K) * 3, ts, ts)), F, K)
    plan = tilewin.texel_plan(tables, cand_pos, slot_idx, cand_valid,
                              with_stats=True)
    pv = point_valid.any(dim=1).reshape(-1)
    covered = cand_valid.any(dim=1).reshape(-1)
    n_valid = int(pv.sum())
    assert n_valid > 1000, "fixture degenerate: almost no valid points"
    return float(plan.clamped), float((pv & ~covered).sum()) / n_valid


def test_sparse_frame_coverage_bounds(scene, monkeypatch):
    """tests/test_tilewin_sparse.py:187's bounds: 32² planes, 4x4 patches."""
    fg, canon, point_valid, n_patch, m = patch_points(scene, P)
    assert 0.03 < fg < 0.30, f"fixture not sparse: fg={fg:.3f}"
    clamped, _ = window_stats(canon, point_valid, n_patch, m, TS)
    with_rescue = leak(canon, point_valid, n_patch, m)
    monkeypatch.setattr(tilewin, "RESCUE_W", 0.0)
    without = leak(canon, point_valid, n_patch, m)
    assert clamped < 0.01, f"clamped fetch fraction {clamped:.4f} >= 1%"
    assert with_rescue < 0.04, f"candidate-capacity leak {with_rescue:.4f}"
    assert with_rescue < without, (with_rescue, without)


def test_high_texel_ratio_p4_stays_loud_p2_safe(scene):
    """tests/test_tilewin_sparse.py:199's bounds: 128² planes; 4x4 patches
    overflow the window (clamped > 5%, drop < 10%), 2x2 patches do not
    (clamped < 1%, drop < 2%)."""
    fg, canon, point_valid, n_patch, m = patch_points(scene, 4)
    assert 0.03 < fg < 0.30, f"fixture not sparse: fg={fg:.3f}"
    cl4, drop4 = window_stats(canon, point_valid, n_patch, m, TS_HIGH)
    assert cl4 > 0.05, f"P=4 clamped {cl4:.4f}: sparse regime now safe?"
    assert drop4 < 0.10, f"P=4 whole-point drop {drop4:.4f} >= 10%"
    _, canon, point_valid, n_patch, m = patch_points(scene, 2)
    cl2, drop2 = window_stats(canon, point_valid, n_patch, m, TS_HIGH)
    assert cl2 < 0.01, f"P=2 clamped-fetch fraction {cl2:.4f} >= 1%"
    assert drop2 < 0.02, f"P=2 whole-point drop {drop2:.4f} >= 2%"
