"""The port's MLP NARF baselines (``models/narf.py::MLPNARF``: narf, tnarf,
dnarf) and the unarticulated baselines (``models/nerf.py``: ``MLPNeRF``,
``TriPlaneNeRF``) against the JAX package's, with the JAX model's perturbed
weights carried across: the reference-named bridge for the selector and
the heads, the flax paths (``interop.flax_mlp_narf_state``) for
``density_mlp`` and ``deformation_field``, which the reference key map
leaves out. Also the DSO training render and its gradients, a full frame,
the mesh, and the DSO model of ``configs/DSO_train/default.yml``.

The MLP models' density bias is raised (``_torch_parity.
lifted_mlp_density``): from the perturbed init their raw logit is negative
everywhere, and a render would show no foreground.

Tolerances. ``density_color`` (the raw density logit included) and the
baselines: 1e-5 of the output's scale, dnarf's 1e-3 (see ``_REL``); JAX
runs them jitted, as there is no discrete choice on this path. The full frame: the bounds of
tests/test_torch_slice.py. The training render and gradients: those of
tests/test_torch_train_parity.py. The mesh's density grid within 1e-5 of
its scale, and its mesh the one JAX's marching tetrahedra give from the
port's grid.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.training.checkpoint import (import_reference_state_dict,
                                               jax_tree_to_dict,
                                               reference_key_map)
from enarf_gan_tpu_torch import interop
from enarf_gan_tpu_torch.models import generator as tgen

from _torch_parity import build_pair, t

MODELS = ("narf", "tnarf", "dnarf")
# configs/DSO_train/default.yml's model at test widths: view-dependent
# heads, "center" origins (23 bones)
MLP = dict(use_triplane=False, view_dependent=True, origin_location="center",
           hidden_size=16, Nc=6, Nf=8)
SIZE, CHUNK = 16, 64
# dnarf's deformation moves the positions before their PE, whose top
# frequency (2^9 pi) turns the move's last-bit rounding into 1e-4 of the
# phase: in float32 both packages sit as far from a float64 run of the
# same model (port / JAX: density 1.27e-3 / 1.26e-3 of a 7.3 scale, color
# 6.2e-4 / 4.7e-4 at this seed)
_REL = {"narf": 1e-5, "tnarf": 1e-5, "dnarf": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return build_pair(size=SIZE, ray_batchsize=CHUNK, model_type=request.param,
                      **MLP)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    d = float(np.abs(got - want).max())
    assert d <= rel * scale, (d, scale)


def _points(pose_s, n_rays=50, S=8, seed=0):
    """Points around the bone centres (most inside some bone's cube; one
    in eight far outside all of them) and ray directions."""
    rs = np.random.default_rng(seed)
    centres = pose_s[0, rs.integers(0, pose_s.shape[1], n_rays * S), :3, 3]
    centres[::8] += 50.0
    pts = (centres + rs.normal(scale=0.3, size=centres.shape)).T[None]
    ray_dir = rs.normal(size=(1, 3, n_rays))
    return pts.astype(np.float32), ray_dir.astype(np.float32)


@pytest.mark.parametrize("shift", [0.0, -4.0])
@torch.no_grad()
def test_mlp_narf_density_color_matches_jax(pair, shift):
    """``shift`` lowers the density bias on both sides, so that the raw
    logit comes out negative at most points: no ReLU, no factor 10."""
    from _torch_parity import lifted_mlp_density
    gen, variables, port, scene = pair
    variables = lifted_mlp_density(variables, shift)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    port.nerf.density_fc.bias.add_(shift)
    pose_cam, _, bl, _, _, _ = scene
    ft = np.array([0.5], np.float32)
    z = port.get_latents(t(ft), t(pose_cam))
    pose_t, bl_t = port.transform_pose(t(pose_cam), t(bl))
    pose_s = pose_t.numpy().copy()
    pose_s[:, :, :3, 3] *= port.nerf_params.coordinate_scale
    pts, ray_dir = _points(pose_s)
    d_ref, c_ref = jax.jit(lambda v, *a: gen.apply(
        v, *a, method="nerf_density_color"))(
        variables, jnp.asarray(pts), jnp.asarray(pose_s),
        jnp.asarray(bl_t.numpy()), jnp.asarray(z.numpy()),
        jnp.asarray(z.numpy()), jnp.asarray(ray_dir))
    d, c = port.nerf_density_color(t(pts), t(pose_s), bl_t, z, z,
                                   t(ray_dir))
    port.load_state_dict(state)
    d_ref = np.asarray(d_ref)
    # the raw logit, zero outside every cube
    inside = d_ref != 0
    assert 0.5 < inside.mean() < 0.9 and np.ptp(d_ref[inside]) > 1e-3
    if shift:
        assert (d_ref < 0).mean() > 0.5
    _close(d, d_ref, _REL[port.nerf_params.model_type])
    _close(c, c_ref, _REL[port.nerf_params.model_type])


def test_mlp_narf_bridge_maps_every_leaf_both_ways(pair):
    """Every leaf of the JAX model reaches the port by a reference name or
    a flax path (the flax-only leaves are exactly density_mlp's and
    deformation_field's), and the port's state dict goes back into JAX
    through ``import_reference_state_dict`` and ``export_flax_mlp_narf``."""
    _, variables, port, _ = pair
    keymap = reference_key_map(variables["params"])
    unmapped = sorted(k for k, (name, _) in keymap.items() if name is None)
    flax_only = [k for k in unmapped
                 if k.split("/")[2] in interop.FLAX_ONLY]
    assert unmapped == flax_only and flax_only
    exported = interop.export_flax_mlp_narf(port.nerf)
    assert sorted("params/nerf/" + k for k in exported) == flax_only
    names = {n for n, _ in keymap.values() if n} | {
        "nerf." + k for k in interop.flax_mlp_narf_state(
            variables["params"]["nerf"])}
    assert names == set(port.state_dict())
    with pytest.raises(RuntimeError, match="Missing key"):
        interop.load_reference_state_dict(
            port, {n: np.zeros(1) for n, _ in keymap.values() if n})
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    zero = jax.tree_util.tree_map(np.zeros_like, jax_tree_to_dict(variables))
    new_vars, report = import_reference_state_dict(sd, zero)
    assert sorted(report["missing"]) == flax_only, report["missing"]
    assert sorted(report["unused"]) == sorted(
        k for k in sd if k.split(".")[1] in interop.FLAX_ONLY)
    for path, v in exported.items():
        node = new_vars["params"]["nerf"]
        *keys, leaf = path.split("/")
        for k in keys:
            node = node[k]
        node[leaf] = v
    a = jax.tree_util.tree_leaves(variables)
    b = jax.tree_util.tree_leaves(new_vars)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("pair", ["narf", "dnarf"], indirect=True)
def test_mlp_narf_full_frame_matches_jax(pair):
    from enarf_gan_tpu.models.generator import dso_render_entire_img
    from _torch_parity import jax_fine_draws
    gen, variables, port, scene = pair
    pose_cam, world, bl, inv_K, _, _ = scene
    cam = world[:, 0, :3, :3]
    rng = jax.random.PRNGKey(3)
    ft = np.array([0.5], np.float32)
    ref = jax.jit(lambda v, r, pc, ik, f, b, c: dso_render_entire_img(
        gen, v, r, pc, ik, f, b, camera_pose=c, render_size=SIZE,
        ray_batchsize=CHUNK))(
        variables, rng, jnp.asarray(pose_cam), jnp.asarray(inv_K),
        jnp.asarray(ft), jnp.asarray(bl), jnp.asarray(cam))
    draws = jax_fine_draws(rng, SIZE * SIZE // CHUNK, CHUNK,
                           gen.nerf_params.Nf)
    render = tgen.make_dso_full_renderer(port, SIZE, ray_batchsize=CHUNK)
    got = render(t(pose_cam), t(inv_K), t(ft), t(bl), camera_pose=t(cam),
                 draws=draws)
    assert (got[1].numpy() > 0.05).sum() > 10       # a real foreground
    for a, b in zip(got, ref):
        d = np.abs(a.numpy() - np.asarray(b)).ravel()
        assert np.quantile(d, 0.999) <= 2e-2 and d.mean() <= 1e-3, \
            (np.quantile(d, 0.999), d.mean())


@pytest.mark.parametrize("pair", ["narf"], indirect=True)
def test_mlp_narf_mesh_matches_jax(pair):
    """``dso_create_mesh`` of the MLP model (z in place of planes): its
    density grid against the JAX model's on the same grid points, and its
    mesh the one JAX's marching tetrahedra give from the port's grid."""
    from unittest import mock
    from enarf_gan_tpu.mesh.extract import density_grid, marching_tetrahedra
    from enarf_gan_tpu_torch.mesh import extract
    gen, variables, port, scene = pair
    pose_cam, _, bl, _, _, _ = scene
    ft = np.array([0.3], np.float32)
    voxel, cube_half = 0.05, 8
    z = gen.apply(variables, jnp.asarray(ft), jnp.asarray(pose_cam),
                  method="get_latents")
    pose_t, bl_t = gen.apply(variables, jnp.asarray(pose_cam),
                             jnp.asarray(bl), method="transform_pose")
    scale = port.nerf_params.coordinate_scale
    pose_s = pose_t.at[:, :, :3, 3].multiply(scale)
    density = jax.jit(lambda v, p: gen.apply(
        v, p, pose_s, bl_t, z, z, None, method="nerf_density_color")[0])
    center = pose_cam[0, 0, :3, 3].copy()
    want_vol, _ = density_grid(lambda p: density(variables, p), center,
                               voxel, scale, cube_half=cube_half,
                               chunk=(2 * cube_half + 1) ** 3)
    want_vol = np.asarray(want_vol)
    th = float(np.quantile(want_vol[want_vol != 0], 0.5))
    assert th > 0
    vols, real = [], extract.density_grid

    def kept(*a, **k):
        vols.append(real(*a, **k))
        return vols[-1]

    with mock.patch.object(extract, "density_grid", kept):
        got = extract.dso_create_mesh(port, t(pose_cam), t(bl), t(ft),
                                      voxel_size=voxel, mesh_th=th,
                                      cube_half=cube_half, chunk=1024)
    vol = vols[0][0].numpy()
    _close(vol, want_vol)
    verts, faces = marching_tetrahedra(vol, th)
    verts = (verts - cube_half) * voxel + center.reshape(1, 3)
    assert len(faces) > 50
    np.testing.assert_array_equal(got[1].numpy(), faces)
    np.testing.assert_allclose(got[0].numpy(), verts, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ #
# the unarticulated baselines
# ------------------------------------------------------------------ #

def _nerf_scene(n=200, seed=0):
    rs = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)[None, None].copy()
    pose[..., :3, 3] = rs.normal(scale=0.1, size=3)
    pts = rs.uniform(-1.3, 1.3, size=(1, 3, n)).astype(np.float32) \
        + pose[0, 0, :3, 3][None, :, None]
    return pose, pts, rs.normal(size=(1, 3, n // 8)).astype(np.float32)


@pytest.mark.parametrize("view_dependent", [False, True])
def test_mlp_nerf_matches_jax(view_dependent):
    from enarf_gan_tpu.models.narf import NARFParams as JNARFParams
    from enarf_gan_tpu.models.nerf import MLPNeRF as JMLPNeRF
    from enarf_gan_tpu_torch.models.narf import NARFParams
    from enarf_gan_tpu_torch.models.nerf import MLPNeRF
    from _torch_parity import perturbed
    kw = dict(hidden_size=16, num_frequency_for_position=6,
              view_dependent=view_dependent)
    pose, pts, rd = _nerf_scene()
    z = np.random.default_rng(1).normal(size=(1, 8)).astype(np.float32)
    rd = rd if view_dependent else None
    jm = JMLPNeRF(params=JNARFParams(**kw), z_dim=8, z2_dim=8)
    args = [jnp.asarray(x) if x is not None else None
            for x in (pts, pose, z, z, rd)]
    variables = perturbed(jax.jit(lambda k, *a: jm.init(
        k, *a, method="density_color"))(jax.random.PRNGKey(0), *args))
    d_ref, c_ref, _ = jax.jit(lambda v, *a: jm.apply(
        v, *a, method="density_color"))(variables, *args)
    port = MLPNeRF(NARFParams(**kw), 8, 8, device="cpu")
    _load_baseline(port, variables)
    d, c = port.density_color(t(pts), t(pose), t(z), t(z),
                              None if rd is None else t(rd))
    d_ref = np.asarray(d_ref)
    assert (d_ref < 0).any() and (d_ref > 0).any() and (d_ref == 0).any()
    _close(d, d_ref)
    _close(c, c_ref)


@pytest.mark.parametrize("constant", [False, True])
def test_triplane_nerf_matches_jax(constant):
    from enarf_gan_tpu.models.narf import NARFParams as JNARFParams
    from enarf_gan_tpu.models.nerf import TriPlaneNeRF as JTriPlaneNeRF
    from enarf_gan_tpu_torch.models.narf import NARFParams
    from enarf_gan_tpu_torch.models.nerf import TriPlaneNeRF
    from _torch_parity import perturbed
    kw = dict(tri_plane_size=16, w_dim=32, feat_dim=8, view_dependent=False,
              constant_triplane=constant, clamp_mask=True)
    pose, pts, _ = _nerf_scene(seed=2)
    z = np.random.default_rng(3).normal(size=(1, 8)).astype(np.float32)
    jm = JTriPlaneNeRF(params=JNARFParams(**kw), z_dim=8, z2_dim=8)

    def both(m, z, pts, pose):
        planes = m.compute_tri_plane_feature(z)
        return planes, m.density_color(pts, pose, planes, z)

    args = [jnp.asarray(x) for x in (z, pts, pose)]
    variables = perturbed(jax.jit(lambda k, *a: jm.init(
        k, *a, method=both))(jax.random.PRNGKey(0), *args))
    planes_ref, (d_ref, c_ref, _) = jax.jit(
        lambda v, *a: jm.apply(v, *a, method=both))(variables, *args)
    port = TriPlaneNeRF(NARFParams(**kw), 8, 8, device="cpu")
    _load_baseline(port, variables)
    with torch.no_grad():
        planes = port.compute_tri_plane_feature(t(z))
        d, c = port.density_color(t(pts), t(pose), planes, t(z))
    _close(planes, planes_ref, 1e-4)     # four modulated resolutions
    d_ref = np.asarray(d_ref)
    assert (d_ref < 0).any() and (d_ref > 0).any() and (d_ref == 0).any()
    _close(d, d_ref, 1e-4 if not constant else 1e-5)
    _close(c, c_ref, 1e-4 if not constant else 1e-5)


def _load_baseline(port, variables):
    """A JAX baseline's weights into the port's: the reference key map of
    the same leaves under a generator's ``nerf``, and the flax paths of
    ``density_mlp``. ``TriPlaneNeRF``'s StyleGAN2 is the map's
    ``nerf.tri_plane_gen`` (no mask planes or selector beside it) and the
    port's ``generator``."""
    from enarf_gan_tpu.training.checkpoint import export_reference_state_dict
    params = variables["params"]
    sd = export_reference_state_dict({"params": {"nerf": params}})
    sd = {k.replace("nerf.tri_plane_gen.", "generator.")
           .replace("nerf.", "", 1): v for k, v in sd.items()}
    sd.update({k: v.numpy() for k, v in
               interop.flax_mlp_narf_state(params).items()})
    port.load_state_dict({k: t(v) for k, v in sd.items()}, strict=True)


# ------------------------------------------------------------------ #
# the training render and its gradients against jax.grad
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """tests/test_torch_train_parity.py's case on the narf MLP model of
    ``configs/DSO_train/default.yml`` (view-dependent heads, "center"
    origins, the "mse" loss) at test widths."""
    from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
    from _torch_parity import dso_train_case, tiny_dso_config
    root = str(tmp_path_factory.mktemp("train_mlp"))
    make_synthetic_human_cache(root, size=32, n_frames=3, n_camera=2)
    raw = tiny_dso_config(root, str(tmp_path_factory.mktemp("out")),
                          no_ray_direction=False, origin_location="center")
    raw["generator_params"]["use_triplane"] = False
    return dso_train_case(raw, (0, 3))


def test_mlp_narf_training_render_matches_jax(case):
    from test_torch_train_parity import test_training_render_matches_jax
    assert type(case["port"].nerf).__name__ == "MLPNARF"
    test_training_render_matches_jax(case)


def test_mlp_narf_train_step_gradients_match_jax(case):
    from test_torch_train_parity import check_gradients
    check_gradients(case, ["nerf.density_mlp.EqualConv1d_0.weight",
                           "nerf.selector.EqualConv1d_0.weight",
                           "nerf.density_fc.bias"])
