"""The port's mesh extraction and rasteriser (``enarf_gan_tpu_torch/mesh``)
against the JAX package's (``enarf_gan_tpu/mesh``, numpy) on the same
numpy inputs.

Tolerances. Marching tetrahedra: the same faces, and vertices within 1e-6
(both interpolate in float64 from float32 crossings; only which copy of a
welded vertex is kept could differ, by far less). The rasteriser: the
same covered pixels, and at most 0.5% of the pixels of another colour
(ties between faces at one depth, and the last bit of a shade). The GAN's
density grid (float32 planes, the demo's sampling: kernel 1f's plain twin
against JAX's float32 quad tables): within the unirow bounds of
tests/test_unirow.py (rtol and atol 5e-2), and its mesh equal to the one
JAX's marching tetrahedra gives from the port's volume.
"""
import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.mesh import extract, raster

VOXEL, CUBE_HALF, MESH_TH = 0.05, 12, 15.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_volume(D=24, radius=0.35):
    """tests/test_mesh.py's sphere."""
    bins = np.linspace(-1, 1, D)
    x, y, z = np.meshgrid(bins, bins, bins, indexing="ij")
    return (radius ** 2 - (x ** 2 + y ** 2 + z ** 2)).astype(np.float32), bins


def random_volume(D=14, seed=3):
    """A rough seeded volume: many small surfaces, every case of a
    tetrahedron (1, 2 and 3 corners inside) many times."""
    return np.random.default_rng(seed).normal(size=(D, D, D)).astype(
        np.float32)


VOLUMES = {"sphere": (lambda: sphere_volume()[0], 0.0),
           "random": (random_volume, 0.3),
           "empty": (lambda: np.zeros((8, 8, 8), np.float32), 0.5)}


def _same_mesh(got, want):
    verts, faces = (x.cpu().numpy() for x in got)
    np.testing.assert_array_equal(faces, want[1])
    assert verts.dtype == np.float32 and verts.shape == want[0].shape
    np.testing.assert_allclose(verts, want[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_tetrahedra_matches_jax(name):
    from enarf_gan_tpu.mesh.extract import marching_tetrahedra
    make, th = VOLUMES[name]
    vol = make()
    want = marching_tetrahedra(vol, th)
    got = extract.marching_tetrahedra(torch.from_numpy(vol), th)
    _same_mesh(got, want)
    if name != "empty":
        assert len(want[1]) > 100
    else:
        assert len(want[1]) == 0


def test_active_cubes_are_the_crossed_ones():
    vol = random_volume()
    inside = vol > 0.3
    D = vol.shape[0]
    corners = np.stack([inside[dx:dx + D - 1, dy:dy + D - 1, dz:dz + D - 1]
                        for dx, dy, dz in extract._CUBE_CORNERS])
    want = np.flatnonzero(corners.any(0) & (~corners).any(0))
    got = extract.active_cubes(torch.from_numpy(vol), 0.3).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_mesh_matches_jax():
    """One analytic density (a ball of radius 0.3 about the centre) in
    both packages."""
    import jax.numpy as jnp
    from enarf_gan_tpu.mesh.extract import extract_mesh
    center = np.array([0.1, -0.2, 3.0], np.float32)

    def jax_density(points):
        return 100.0 * (jnp.linalg.norm(points - center.reshape(1, 3, 1),
                                        axis=1, keepdims=True) < 0.3)

    def density(points):
        c = torch.from_numpy(center).reshape(1, 3, 1)
        return 100.0 * (torch.linalg.norm(points - c, dim=1,
                                          keepdim=True) < 0.3).float()

    want = extract_mesh(jax_density, center, voxel_size=VOXEL,
                        mesh_th=MESH_TH, cube_half=CUBE_HALF, chunk=4096)
    got = extract.extract_mesh(density, torch.from_numpy(center), VOXEL,
                               MESH_TH, cube_half=CUBE_HALF, chunk=4096)
    assert len(want[1]) > 100
    _same_mesh(got, want)


def _sphere_mesh():
    vol, bins = sphere_volume(D=32)
    from enarf_gan_tpu.mesh.extract import marching_tetrahedra
    verts, faces = marching_tetrahedra(vol, 0.0)
    world = verts * (bins[1] - bins[0]) - 1.0 + np.array([0.1, 0.0, 2.5])
    return world.astype(np.float32), faces


def test_render_mesh_image_matches_jax():
    from enarf_gan_tpu.mesh.raster import render_mesh_image
    verts, faces = _sphere_mesh()
    K = np.array([[150, 0, 32], [0, 150, 32], [0, 0, 1]], np.float32)
    want = render_mesh_image(verts, faces, K, img_size=64, render_size=64)
    with mock_patch(raster, "PAIRS_PER_CHUNK", 500):   # many chunks
        got = raster.render_mesh_image(torch.from_numpy(verts),
                                       torch.from_numpy(faces), K,
                                       img_size=64, render_size=64)
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    covered = want.any(axis=2)
    assert 300 < covered.sum() < 64 * 64
    np.testing.assert_array_equal(got.any(axis=2), covered)
    assert (got != want).any(axis=2).mean() <= 5e-3
    empty = raster.render_mesh_image(torch.zeros((0, 3)),
                                     torch.zeros((0, 3), dtype=torch.long),
                                     K, img_size=64, render_size=32)
    assert empty.shape == (32, 32, 3) and not empty.any()


def test_gan_create_mesh_matches_jax():
    """``gan_create_mesh`` of a tiny GAN on float32 planes: the density
    grid against JAX's (its ``density_grid`` over the density function of
    its ``gan_create_mesh``), the mesh against JAX's marching tetrahedra
    on the port's volume."""
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.mesh.extract import density_grid, marching_tetrahedra
    from _torch_parity import gan_pair_from_port
    jgen, variables, port, scene, z = gan_pair_from_port(
        plane_sample_dtype="float32")
    pose_cam, _, bl, _, _, _ = scene
    psi = 0.7
    # the JAX package's gan_create_mesh up to its density grid
    z_nerf, z_rend, _ = jgen.split_z(jnp.asarray(z))
    pose_t, bl_t = jgen.apply(variables, jnp.asarray(pose_cam),
                              jnp.asarray(bl), method="transform_pose")
    planes = jax.jit(lambda v, z: jgen.apply(
        v, z, bl_t, psi, method="compute_tri_plane_feature"))(variables,
                                                              z_nerf)
    scale = jgen.nerf_params.coordinate_scale
    pose_scaled = pose_t.at[:, :, :3, 3].multiply(scale)
    def density_fn(p):
        return jgen.apply(variables, p, pose_scaled, bl_t, planes, z_rend,
                          None, method="nerf_density_color")[0]

    center = pose_cam[0, 0, :3, 3].copy()
    with jax.disable_jit():
        want_vol, _ = density_grid(density_fn, center, VOXEL, scale,
                                   cube_half=CUBE_HALF,
                                   chunk=(2 * CUBE_HALF + 1) ** 3)

    vols = []
    real = extract.density_grid

    def kept(*a, **k):
        vols.append(real(*a, **k))
        return vols[-1]

    with mock_patch(extract, "density_grid", kept):
        got = extract.gan_create_mesh(
            port, torch.from_numpy(pose_cam), torch.from_numpy(bl),
            torch.from_numpy(z), voxel_size=VOXEL, mesh_th=MESH_TH,
            truncation_psi=psi, cube_half=CUBE_HALF, chunk=4096)
    vol = vols[0][0].numpy()
    assert (vol > MESH_TH).mean() > 0.01 and (vol <= MESH_TH).mean() > 0.5
    np.testing.assert_allclose(vol, want_vol, rtol=5e-2, atol=5e-2)
    verts, faces = marching_tetrahedra(vol, MESH_TH)
    verts = (verts - CUBE_HALF) * VOXEL + center.reshape(1, 3)
    assert len(faces) > 100
    _same_mesh(got, (verts, faces))


def mock_patch(obj, name, value):
    from unittest import mock
    return mock.patch.object(obj, name, value)


def test_dso_create_mesh_matches_jax_extract_mesh():
    """``dso_create_mesh`` of a tiny DSO model (float32 planes, the port's
    seeded weights perturbed) against the JAX package's ``extract_mesh``
    over the same density function (the port's model, called on JAX's
    grid points): the same faces, vertices within 1e-6."""
    import jax.numpy as jnp
    from enarf_gan_tpu.mesh.extract import extract_mesh
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    from enarf_gan_tpu_torch.models import generator as tgen
    from enarf_gan_tpu_torch.models.narf import NARFParams
    from _torch_parity import PARENTS, SMALL
    port = tgen.DSONARFGenerator(
        NARFParams(**{**SMALL, "plane_sample_dtype": "float32"}),
        num_bone=24, parent_id=PARENTS, device="cpu")
    g = torch.Generator().manual_seed(6)   # a seed whose density crosses 10
    with torch.no_grad():
        for p in port.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
    pose_cam, _, bl, _, canonical, _ = tiny_scene(1, 16)
    tgen.register_canonical_pose(port, canonical, "center_fixed", PARENTS)
    pose, blt = torch.from_numpy(pose_cam), torch.from_numpy(bl)
    ft = torch.tensor([0.3])
    with torch.no_grad():
        z = port.get_latents(ft, pose)
        pose_t, bl_t = port.transform_pose(pose, blt)
        cond = port.pack_planes(port.compute_tri_plane_feature(z, bl_t))
        pose_scaled = pose_t.clone()
        pose_scaled[:, :, :3, 3] *= port.nerf_params.coordinate_scale

    def jax_density(points):
        with torch.no_grad():
            d = port.nerf_density_color(
                torch.from_numpy(np.array(points)), pose_scaled, bl_t,
                cond, z, None)[0]
        return jnp.asarray(d.numpy())

    th = 10.0
    want = extract_mesh(jax_density, pose_cam[0, 0, :3, 3].copy(), VOXEL,
                        th, port.nerf_params.coordinate_scale,
                        cube_half=CUBE_HALF, chunk=4096)
    got = extract.dso_create_mesh(port, pose, blt, ft, voxel_size=VOXEL,
                                  mesh_th=th, cube_half=CUBE_HALF,
                                  chunk=4096)
    assert len(want[1]) > 100
    _same_mesh(got, want)

