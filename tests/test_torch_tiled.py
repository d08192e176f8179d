"""The port's patch-tiled DSO render (nerf/tiled.py, the tiled model path)
against the JAX one, and against the port's own exact render.

Same scene, same perturbed weights through the weight bridge, and JAX's
own fine-sampler draws fed to the port chunk by chunk.

Tolerances:
* density and color at tiled points: the JAX XLA sampler rounds the
  bilinear weights to bf16 and the port keeps them in f32; through the
  heads that stays within 5e-2 of the output's scale, 1e-2 on average (as
  tests/test_torch_models.py bounds the exact sampler);
* the frame: bounded by a high quantile and the mean of |d|, as in
  tests/test_torch_slice.py, because the fine sampler's inverse-CDF bin
  pick is discontinuous and a rare pixel may move;
* tiled against exact: the metric-level bounds of
  tests/test_tiled_render.py:237-240 (the two change the sampling pattern,
  not the radiance field).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.models.generator import dso_render_entire_img_tiled
from enarf_gan_tpu.ops import tilewin as jtw
from enarf_gan_tpu_torch.data.fixtures import tiny_scene
from enarf_gan_tpu_torch.models import generator as tgen
from enarf_gan_tpu_torch.models.narf import NARFParams as TNARFParams
from enarf_gan_tpu_torch.nerf.ray_sampler import image_grid_coords
from enarf_gan_tpu_torch.nerf.tiled import tile_permutation

from _torch_parity import PARENTS, SMALL, build_pair, jax_fine_draws, t

SIZE = 16
CHUNK = 64   # 4 chunks of 4 patches at 16²: the valid-first order and the
             # chunk skip run


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_tile_permutation_and_grid_match_jax():
    from enarf_gan_tpu.nerf.ray_sampler import image_grid_coords as jgrid
    from enarf_gan_tpu.nerf.tiled import tile_permutation as jperm
    np.testing.assert_array_equal(tile_permutation(16, 4), jperm(16, 4))
    for a, b in zip(image_grid_coords(12, 6, 2, device="cpu"),
                    jgrid(12, 6, 2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def tiled_pair():
    return build_pair(size=SIZE, ray_batchsize=CHUNK, tile_patch=4)


def variant(pair, **overrides):
    """The pair's JAX and port models with other hyper-parameters and the
    same weights."""
    gen, variables, port, scene = pair
    jgen = gen.clone(nerf_params=dataclasses.replace(gen.nerf_params,
                                                     **overrides))
    tport = tgen.DSONARFGenerator(
        dataclasses.replace(port.nerf_params, **overrides), num_bone=24,
        parent_id=PARENTS, device="cpu")
    tport.load_state_dict(port.state_dict())
    return jgen, variables, tport, scene


@torch.no_grad()
def test_density_color_tiled_matches_jax(tiled_pair):
    """At the fine pass's 16 members a patch (the coarse-corner pass's 4
    run in the frame tests below)."""
    m = 16
    gen, variables, port, scene = tiled_pair
    pose_cam, _, bl, _, _, _ = scene
    ft = np.array([0.5], np.float32)
    z = gen.apply(variables, jnp.asarray(ft), jnp.asarray(pose_cam),
                  method="get_latents")
    pose_t, bl_t = gen.apply(variables, jnp.asarray(pose_cam),
                             jnp.asarray(bl), method="transform_pose")
    pose_s = np.array(pose_t)
    pose_s[:, :, :3, 3] *= port.nerf_params.coordinate_scale
    # patch-coherent points: one centre near a bone per (patch, sample),
    # the members a few millimetres around it
    rs = np.random.default_rng(0)
    n_patch, S = 6, 8
    centres = pose_s[0, rs.integers(0, 23, (n_patch, 1, S)), :3, 3]
    centres = centres + rs.normal(scale=0.3, size=centres.shape)
    pts = centres + rs.normal(scale=0.01, size=(n_patch, m, S, 3))
    pts = pts.reshape(-1, 3).T[None].astype(np.float32)

    # the planes and tables under jit; the density op by op, as
    # tests/test_torch_models.py runs it (under jit XLA fuses the bone-frame
    # arithmetic, and points on a cube face flip validity)
    planes = jax.jit(lambda v: gen.apply(
        v, z, bl_t, method="compute_tri_plane_feature"))(variables)
    feat, mask = jax.jit(lambda p: tuple(gen.apply(
        variables, p, method="pack_planes_tiled")[:2]))(planes)
    tables = jtw.TilewinTables(feat, mask, jtw._num_bases(planes.shape[-1]),
                               port.nerf_params.feat_dim, 23,
                               planes.shape[-1])
    d_ref, c_ref, aux = gen.apply(
        variables, jnp.asarray(pts), jnp.asarray(pose_s), bl_t, tables, z,
        n_patch, m, S, None, True, method="nerf_density_color_tiled")
    clamped = aux["tilewin_stats"]["clamped"]
    t_tables = port.pack_planes_tiled(t(planes))
    d, c, stats = port.nerf_density_color_tiled(
        t(pts), t(pose_s), t(bl_t), t_tables, t(z), n_patch, m, S,
        with_stats=True)
    assert (np.asarray(d_ref) > 0).mean() > 0.1     # densities not all zero
    for got, ref in ((d, d_ref), (c, c_ref)):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        diff = np.abs(got.numpy() - ref)
        assert diff.max() <= 5e-2 * scale and diff.mean() <= 1e-2 * scale, \
            (diff.max(), diff.mean(), scale)
    np.testing.assert_allclose(float(stats["clamped"]), float(clamped),
                               rtol=1e-6)


@torch.no_grad()
def test_render_rays_tiled_ray_chunk_changes_nothing(tiled_pair):
    """The ray_chunk loop renders whole-patch chunks one after the other,
    with the results of one pass over all rays."""
    from enarf_gan_tpu_torch.nerf.tiled import render_rays_tiled
    _, _, port, scene = tiled_pair
    pose_cam, _, bl, inv_K, _, _ = scene
    z = port.get_latents(t(np.array([0.5])), t(pose_cam))
    pose_t, bl_t = port.transform_pose(t(pose_cam), t(bl))
    tables = port.pack_planes_tiled(
        port.compute_tri_plane_feature(z, bl_t))

    def fn(points, ray_dir, pose_scaled, n_patch, m, S):
        return port.nerf_density_color_tiled(points, pose_scaled, bl_t,
                                             tables, z, n_patch, m, S,
                                             ray_dir)

    _, coords = image_grid_coords(SIZE, SIZE, 1, device="cpu")
    coords = coords[..., torch.from_numpy(tile_permutation(SIZE, 4))]
    g = torch.Generator().manual_seed(5)
    n_patch = SIZE * SIZE // 16
    draws = (torch.rand((n_patch, port.nerf_params.Nf), generator=g),
             torch.rand((n_patch, port.nerf_params.Nf), generator=g))
    cfg = port.render_cfg()
    whole = render_rays_tiled(fn, coords, pose_t, t(inv_K), cfg, 4, draws)
    chunked = render_rays_tiled(fn, coords, pose_t, t(inv_K), cfg, 4, draws,
                                ray_chunk=CHUNK)
    assert float(whole[1].sum()) > 0
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=[False, True],
                ids=["all_members", "coarse_corners"])
def renders(request, tiled_pair):
    gen, variables, port, scene = variant(
        tiled_pair, tile_coarse_corners=request.param)
    pose_cam, _, bl, inv_K, _, _ = scene
    rng = jax.random.PRNGKey(3)
    ft = np.array([0.5], np.float32)
    ref = jax.jit(lambda v, r, pc, ik, f, b: dso_render_entire_img_tiled(
        gen, v, r, pc, ik, f, b, render_size=SIZE, ray_batchsize=CHUNK))(
        variables, rng, jnp.asarray(pose_cam), jnp.asarray(inv_K),
        jnp.asarray(ft), jnp.asarray(bl))
    draws = jax_fine_draws(rng, SIZE * SIZE // CHUNK, CHUNK // 16,
                           gen.nerf_params.Nf)
    render = tgen.make_dso_full_renderer(port, SIZE, ray_batchsize=CHUNK)
    out = render(t(pose_cam), t(inv_K), t(ft), t(bl), draws=draws)
    return [np.asarray(x) for x in ref], [x.numpy() for x in out]


@pytest.mark.parametrize("i,name,q999,mean", [
    (0, "color", 2e-2, 1e-3), (1, "mask", 2e-2, 1e-3),
    (2, "disparity", 2e-2, 1e-3)])
def test_tiled_frame_matches_jax(renders, i, name, q999, mean):
    ref, got = renders[0][i], renders[1][i]
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert np.quantile(d, 0.999) <= q999, (name, np.quantile(d, 0.999))
    assert d.mean() <= mean, (name, d.mean())
    assert d.max() <= 1.0, (name, d.max())


def test_tiled_frame_foreground_is_not_empty(renders):
    # an all-zero mask would make the parity above vacuous
    assert (renders[1][1] > 0.05).sum() > 20, (renders[1][1] > 0.05).sum()


def test_tiled_frame_matches_the_exact_frame(tiled_pair):
    size = 32                     # the weights do not depend on the size
    _, _, port, _ = variant(tiled_pair, render_bs=size * size)
    _, _, exact, _ = variant(tiled_pair, render_bs=size * size, tile_patch=0)
    pose_cam, _, bl, inv_K, _, _ = tiny_scene(1, size)
    args = (t(pose_cam), t(inv_K), t(np.array([0.5])), t(bl))
    c_t, m_t, _ = tgen.make_dso_full_renderer(port, size)(
        *args, generator=torch.Generator().manual_seed(3))
    c_e, m_e, _ = tgen.make_dso_full_renderer(exact, size)(
        *args, generator=torch.Generator().manual_seed(3))
    c_t, m_t, c_e, m_e = (x.numpy() for x in (c_t, m_t, c_e, m_e))
    assert np.isfinite(c_t).all() and np.isfinite(m_t).all()
    assert (m_e > 0.05).sum() > 200, f"degenerate fg: {(m_e > 0.05).sum()}"
    mse = float(((c_t - c_e) ** 2).mean())
    psnr = 20 * np.log10(2.0) - 10 * np.log10(max(mse, 1e-12))
    assert psnr > 24.0, f"tiled vs exact PSNR {psnr:.2f} dB"
    assert float(np.abs(m_t - m_e).mean()) < 0.15


def test_renderer_routes_as_the_jax_factory(monkeypatch):
    """tile_patch models on the candidate path go to the tiled renderer,
    all others to the exact one (enarf_gan_tpu/models/generator.py:480)."""
    called = []
    monkeypatch.setattr(tgen, "dso_render_entire_img_tiled",
                        lambda *a, **k: called.append("tiled"))
    monkeypatch.setattr(tgen, "dso_render_entire_img",
                        lambda *a, **k: called.append("exact"))
    for tile_patch, bones in ((4, 4), (0, 4), (4, 23)):
        gen = tgen.DSONARFGenerator(
            TNARFParams(**{**SMALL, "tile_patch": tile_patch,
                           "max_bones_per_point": bones}),
            num_bone=24, parent_id=PARENTS, device="cpu")
        assert gen.nerf.supports_tiled_sampling() == \
            (tile_patch > 0 and bones < 23)
        tgen.make_dso_full_renderer(gen, SIZE)(None, None, None, None)
    assert called == ["tiled", "exact", "exact"]
