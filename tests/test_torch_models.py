"""The port's DSO model against the JAX one, with the JAX model's perturbed
weights carried over by the weight bridge; and the bridge itself.

Tolerances:
* flow StyleGAN and warped planes: float32 convolutions summed in another
  order, through four modulated resolutions: 1e-4 of the output's scale.
* density and color: the JAX unirow combine forms the feature products in
  bf16 and the port in f32 (the bf16 sampler itself is held to 2e-2 / 5e-2
  in test_torch_unirow.py); through the heads that stays within 5e-2 of
  the output's scale, 1e-2 on average.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.training.checkpoint import (export_reference_state_dict,
                                               import_reference_state_dict,
                                               jax_tree_to_dict,
                                               reference_key_map)
from enarf_gan_tpu_torch import interop

from _torch_parity import build_pair, t

CONFIGS = {
    # the slice: deformation field, no view dependence
    "deformation": {},
    # constant planes, view-dependent heads, clamped masks, weighted
    # density, pose conditioning
    "constant_viewdep": dict(deformation_field=False, constant_triplane=True,
                             view_dependent=True, clamp_mask=True,
                             multiply_density_with_triplane_weight=True,
                             pose_conditional=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return build_pair(size=16, ray_batchsize=64, **CONFIGS[request.param])


def _conditioning(gen, variables, port, scene):
    pose_cam, _, bl, _, _, _ = scene
    ft = np.array([0.5], np.float32)
    z = gen.apply(variables, jnp.asarray(ft), jnp.asarray(pose_cam),
                  method="get_latents")
    pose_t, bl_t = gen.apply(variables, jnp.asarray(pose_cam), jnp.asarray(bl),
                             method="transform_pose")
    zt = port.get_latents(t(ft), t(pose_cam))
    np.testing.assert_allclose(zt.numpy(), np.asarray(z), rtol=1e-6, atol=1e-6)
    return z, pose_t, bl_t


def _close_scaled(got, ref, rel, mean_rel=None):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    d = np.abs(got - ref)
    assert d.max() <= rel * scale, (d.max(), scale)
    if mean_rel is not None:
        assert d.mean() <= mean_rel * scale, (d.mean(), scale)


@torch.no_grad()
def test_flow_stylegan_and_planes_match(pair):
    gen, variables, port, scene = pair
    z, pose_t, bl_t = _conditioning(gen, variables, port, scene)
    if port.nerf_params.deformation_field and not port.nerf_params.constant_triplane:
        c = gen.apply(variables, bl_t,
                      method=lambda m, b: m.nerf.encode_bone_length(b))
        flow = gen.apply(variables, z, c, method=lambda m, z, c:
                         m.nerf.flow_generator([z], c=c))
        got = port.nerf.flow_generator(t(z), c=t(c)).numpy()
        _close_scaled(got, flow, 1e-4)
        assert np.abs(np.asarray(flow)).max() > 0.1   # real structure
    planes = gen.apply(variables, z, bl_t, method="compute_tri_plane_feature")
    got = port.compute_tri_plane_feature(t(z), t(bl_t)).numpy()
    _close_scaled(got, planes, 1e-4)


@torch.no_grad()
def test_density_color_matches(pair):
    gen, variables, port, scene = pair
    z, pose_t, bl_t = _conditioning(gen, variables, port, scene)
    scale = port.nerf_params.coordinate_scale
    pose_s = np.array(pose_t)
    pose_s[:, :, :3, 3] *= scale
    rs = np.random.default_rng(0)
    n_rays, S = 50, 8
    # points around the bone centres, so most fall inside some bone's cube
    centres = pose_s[0, rs.integers(0, 23, n_rays * S), :3, 3]
    pts = (centres + rs.normal(scale=0.3, size=centres.shape)).T[None]
    ray_dir = rs.normal(size=(1, 3, n_rays)).astype(np.float32)
    planes = gen.apply(variables, z, bl_t, method="compute_tri_plane_feature")
    d_ref, c_ref = gen.apply(variables, jnp.asarray(pts, jnp.float32),
                             jnp.asarray(pose_s), bl_t, planes, z,
                             jnp.asarray(ray_dir), method="nerf_density_color")
    table = port.pack_planes(t(planes))
    d, c = port.nerf_density_color(t(pts), t(pose_s), t(bl_t), table, t(z),
                                   t(ray_dir))
    assert (np.asarray(d_ref) > 0).mean() > 0.1     # densities not all zero
    _close_scaled(d.numpy(), d_ref, 5e-2, 1e-2)
    _close_scaled(c.numpy(), c_ref, 5e-2, 1e-2)


def test_bridge_maps_every_leaf_and_loads_strictly(pair):
    gen, variables, port, _ = pair
    keymap = reference_key_map(variables["params"], variables["buffers"])
    unmapped = [k for k, (name, _) in keymap.items() if name is None]
    assert not unmapped, unmapped
    names = {name for name, _ in keymap.values()}
    assert names == set(port.state_dict()), \
        sorted(names ^ set(port.state_dict()))
    sd = export_reference_state_dict(variables)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(RuntimeError, match="Missing key"):
        interop.load_reference_state_dict(
            port, {k: v for k, v in sd.items() if k != "nerf.tri_plane"})


def test_bridge_roundtrips_back_into_jax(pair):
    _, variables, port, _ = pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    zero = jax.tree_util.tree_map(np.zeros_like, jax_tree_to_dict(variables))
    new_vars, report = import_reference_state_dict(sd, zero, strict=True)
    assert not report["missing"] and not report["unused"], report
    for coll in ("params", "buffers"):
        a = jax.tree_util.tree_leaves(variables[coll])
        b = jax.tree_util.tree_leaves(new_vars[coll])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_register_canonical_pose_matches_jax(pair):
    from enarf_gan_tpu_torch.models.generator import register_canonical_pose
    from _torch_parity import PARENTS
    _, variables, port, scene = pair
    canonical = scene[4]
    with torch.no_grad():
        port.nerf.canonical_pose.zero_()
        port.nerf.canonical_bone_length.zero_()
    register_canonical_pose(port, canonical, "center_fixed", PARENTS)
    buffers = variables["buffers"]["nerf"]
    np.testing.assert_array_equal(port.nerf.canonical_pose.numpy(),
                                  np.asarray(buffers["canonical_pose"]))
    np.testing.assert_array_equal(port.nerf.canonical_bone_length.numpy(),
                                  np.asarray(buffers["canonical_bone_length"]))


def test_models_default_to_the_gpu():
    """A model built without ``device`` is built on the GPU; without one,
    building it fails instead of falling back to the CPU."""
    from enarf_gan_tpu_torch import DEFAULT_DEVICE
    from enarf_gan_tpu_torch.models import generator as tgen
    from enarf_gan_tpu_torch.models.narf import NARFParams as TNARFParams
    from _torch_parity import PARENTS, SMALL
    assert DEFAULT_DEVICE == torch.device("cuda")

    def build():
        return tgen.DSONARFGenerator(TNARFParams(**SMALL), num_bone=24,
                                     parent_id=PARENTS)

    if torch.cuda.is_available():
        gen = build()
        assert all(p.device.type == "cuda" for p in gen.parameters())
        assert all(b.device.type == "cuda" for b in gen.buffers())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    cpu = tgen.DSONARFGenerator(TNARFParams(**SMALL), num_bone=24,
                                parent_id=PARENTS, device="cpu")
    assert all(p.device.type == "cpu" for p in cpu.parameters())


def test_plane_dtype_picks_the_texel_table():
    """bf16 planes pack a bf16 texel table, float32 planes (the default,
    where the JAX package samples its quad tables) a float32 one; what the
    port does not sample yet raises with its ROADMAP item."""
    from enarf_gan_tpu_torch.models.narf import NARFParams as TNARFParams
    from enarf_gan_tpu_torch.models.narf import TriPlaneNARF
    from _torch_parity import SMALL
    assert TNARFParams().plane_sample_dtype == "float32"
    planes = torch.randn(1, (32 + 23) * 3, 32, 32)
    for dtype, want in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        nerf = TriPlaneNARF(TNARFParams(**{**SMALL,
                                           "plane_sample_dtype": dtype}),
                            16, 8, 23, device="cpu")
        (table,) = nerf.pack_planes(planes)
        assert nerf.texel_dtype == want and table.dtype == want
        assert table.shape == (1, 3, 34, 34, 64)
    tiled = TriPlaneNARF(TNARFParams(**{**SMALL, "tile_patch": 4,
                                        "plane_sample_dtype": "float32"}),
                         16, 8, 23, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 2, item 3"):
        tiled.pack_planes_tiled(planes)
    wide = TriPlaneNARF(TNARFParams(**{**SMALL, "feat_dim": 40}), 16, 8, 23,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 2, item 3"):
        wide.pack_planes(torch.randn(1, (40 + 23) * 3, 32, 32))
