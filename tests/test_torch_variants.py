"""The port's dense tri-plane samplers (``enarf_gan_tpu_torch/ops/
triplane.py``) and the TriPlaneNARF variants off the default path
(``constant_trimask``, ``selector_mlp``, ``no_selector``,
``max_bones_per_point = K``) against the JAX package's, on the same
seeded numpy inputs, with the JAX weights carried across by the bridge.

Tolerances. Samplers: float32 ``F.grid_sample`` against JAX's quad-row
gather, 1e-5 of the output's scale, values and gradients (``jax.grad``
against autograd) alike. The variants' ``density_color`` and a GAN image
of each (against JAX's forward run op by op, ``jax.disable_jit``, with
JAX's draws): on every point and pixel, 1e-5 of the output's scale on the
candidate path of ``constant_trimask`` (bf16 planes, which JAX samples in
float32 here, ``float32_jax_samplers``, as the port's combines do), 5e-5
on the dense path, whose feature sums every bone's three samples (69 a
point) in another order than JAX's gather, before heads that scale the
density by 10. The ``no_selector`` training render and its parameter gradients: the
bounds of tests/test_torch_train_parity.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.ops import triplane as jtp

from enarf_gan_tpu_torch.ops import triplane as ttp

B, K, F, H, W, N = 2, 5, 4, 12, 10, 40


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    d = float(np.abs(got - want).max())
    assert d <= rel * scale, (d, scale)


def _jax(fn, *args, **static):
    """``fn`` of the JAX package jitted (a compile of seconds less than its
    ops one by one): array arguments traced, ints and ``static`` fixed."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def call(*traced):
        full = list(args)
        for i, a in zip(arrays, traced):
            full[i] = a
        return fn(*full, **static)

    return jax.jit(call)(*(args[i] for i in arrays))


def _inputs(seed=0):
    """Planes, positions in [-1.2, 1.2] (a sixth of them at 2, the invalid
    marker), validity and weights."""
    rs = np.random.default_rng(seed)
    feat = rs.normal(size=(B, F * 3, H, W)).astype(np.float32)
    masks = rs.normal(scale=3.0, size=(B * K, 3, H, W)).astype(np.float32)
    pos = rs.uniform(-1.2, 1.2, size=(B, K, 3, N)).astype(np.float32)
    valid = (np.abs(pos) < 1).all(axis=2) & (rs.uniform(size=(B, K, N)) > 0.2)
    pos = np.where(valid[:, :, None], pos, 2.0).astype(np.float32)
    pos[..., :N // 6] = 2.0
    valid[..., :N // 6] = False
    weight = rs.uniform(0.05, 1.0, size=(B, K, N)).astype(np.float32)
    return feat, masks, pos, valid, weight


@pytest.mark.parametrize("reduction,clamp", [("sum", False), ("sum", True),
                                             ("prod", False), ("prod", True)])
def test_sample_feature_matches_jax(reduction, clamp):
    feat, _, pos, _, _ = _inputs()
    p = pos[:, 0]
    want = _jax(jtp.sample_feature, feat, p, reduction=reduction,
                clamp_mask=clamp)
    _close(ttp.sample_feature(_t(feat), _t(p), reduction, clamp), want)
    assert np.abs(np.asarray(want)).max() > 0.1
    with pytest.raises(ValueError, match="reduction"):
        ttp.sample_feature(_t(feat), _t(p), "max")


@pytest.mark.parametrize("mode", ["prod", "sum", "uniform"])
@pytest.mark.parametrize("clamp", [False, True])
def test_sample_triplane_part_prob_matches_jax(mode, clamp):
    _, masks, pos, valid, _ = _inputs(1)
    want = _jax(jtp.sample_triplane_part_prob, masks, pos, valid, mode=mode,
                clamp_mask=clamp)
    got = ttp.sample_triplane_part_prob(_t(masks), _t(pos),
                                        torch.from_numpy(valid), mode, clamp)
    _close(got, want)


@pytest.mark.parametrize("max_bones", [None, 2])
def test_sample_weighted_feature_matches_jax(max_bones):
    """Dense (max_bones None or K: the same branch) and top-M; clamp_mask
    reaches only the feature sum here, which it leaves as it is."""
    feat, _, pos, valid, weight = _inputs(2)
    want = _jax(jtp.sample_weighted_feature, F, feat, pos, weight, valid,
                clamp_mask=True, max_bones=max_bones)
    got = ttp.sample_weighted_feature(F, _t(feat), _t(pos), _t(weight),
                                      torch.from_numpy(valid),
                                      clamp_mask=True, max_bones=max_bones)
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_sample_weighted_feature_topm_matches_jax():
    feat, _, pos, valid, weight = _inputs(3)
    for m in (1, 3):
        want = _jax(jtp.sample_weighted_feature_topm, F, feat, pos, weight,
                    valid, max_bones=m)
        got = ttp.sample_weighted_feature_topm(
            F, _t(feat), _t(pos), _t(weight), torch.from_numpy(valid),
            max_bones=m)
        _close(got, want)


def _candidates(pos, valid, M=3):
    """JAX's candidate selection of the canonical positions."""
    idx, cvalid, cpos = _jax(jtp.select_candidate_bones, pos, valid, M)
    got = ttp.select_candidate_bones(_t(pos), torch.from_numpy(valid), M)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(cvalid))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(cpos))
    return np.array(idx), np.array(cvalid), np.array(cpos)


def test_bilinear_flat_matches_jax():
    rs = np.random.default_rng(4)
    table = rs.normal(size=(3 * H * W,)).astype(np.float32)
    base = (rs.integers(0, 3, size=(6, 7)) * H * W).astype(np.int32)
    x = rs.uniform(-1.5, W + 0.5, size=(6, 7)).astype(np.float32)
    y = rs.uniform(-1.5, H + 0.5, size=(6, 7)).astype(np.float32)
    want = _jax(jtp._bilinear_flat, table, base, x, y, H, W)
    got = ttp._bilinear_flat(_t(table), torch.from_numpy(base).long(), _t(x),
                             _t(y), H, W)
    _close(got, want)


@pytest.mark.parametrize("clamp", [False, True])
def test_candidate_samplers_match_jax(clamp):
    feat, masks, pos, valid, _ = _inputs(5)
    idx, cvalid, cpos = _candidates(pos, valid)
    mask_planes = masks.reshape(B, K * 3, H, W)
    want_w = _jax(jtp.sample_part_prob_candidates, mask_planes, idx, cpos,
                  clamp_mask=clamp)
    got_w = ttp.sample_part_prob_candidates(
        _t(mask_planes), torch.from_numpy(idx), _t(cpos), clamp)
    _close(got_w, want_w)
    want = _jax(jtp.sample_weighted_feature_candidates, F, feat, cpos,
                want_w, cvalid, clamp_mask=clamp)
    got = ttp.sample_weighted_feature_candidates(
        F, _t(feat), _t(cpos), got_w, torch.from_numpy(cvalid), clamp)
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0.1


def _grads_match(jfn, tfn, planes, pos):
    """jax.grad of <f(planes, pos), cotangent> against autograd, both
    arguments."""
    out = np.asarray(jax.jit(jfn)(planes, pos))
    cot = np.random.default_rng(6).normal(size=out.shape).astype(np.float32)
    g_planes, g_pos = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jfn(a, b) * cot), argnums=(0, 1)))(planes, pos)
    tp, tpos = _t(planes).requires_grad_(), _t(pos).requires_grad_()
    (tfn(tp, tpos) * _t(cot)).sum().backward()
    _close(tp.grad, g_planes)
    _close(tpos.grad, g_pos)
    assert np.abs(np.asarray(g_pos)).max() > 0.1


def test_sample_weighted_feature_gradients_match_jax():
    feat, _, pos, valid, weight = _inputs(7)
    jv, jw = jnp.asarray(valid), jnp.asarray(weight)
    tv, tw = torch.from_numpy(valid), _t(weight)
    _grads_match(
        lambda a, b: jtp.sample_weighted_feature(F, a, b, jw, jv),
        lambda a, b: ttp.sample_weighted_feature(F, a, b, tw, tv),
        feat, pos)


@pytest.mark.parametrize("mode", ["prod", "sum"])
def test_sample_triplane_part_prob_gradients_match_jax(mode):
    _, masks, pos, valid, _ = _inputs(8)
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    _grads_match(
        lambda a, b: jtp.sample_triplane_part_prob(a, b, jv, mode),
        lambda a, b: ttp.sample_triplane_part_prob(a, b, tv, mode),
        masks, pos)


# ------------------------------------------------------------------ #
# the variants through TriPlaneNARF.density_color and the GAN forward
# ------------------------------------------------------------------ #

VARIANTS = {"constant_trimask": dict(constant_trimask=True),
            "selector_mlp": dict(selector_mlp=True),
            "no_selector": dict(no_selector=True),
            "dense": dict(max_bones_per_point=23),
            # the dense path's density weighted by the largest part
            # probability, and the mask logits clamped straight-through
            "dense_weighted": dict(max_bones_per_point=23, clamp_mask=True,
                                   multiply_density_with_triplane_weight=True)}
IMAGE_VARIANTS = ("constant_trimask", "selector_mlp", "no_selector", "dense")
# candidate path / dense path: the dense path sums every bone's three
# samples (69 a point) in another order than JAX's quad gather, and the
# density head scales by 10 (2.3e-5 of the color's scale and 4.8e-5 of the
# density's 22.5 at this seed)
_REL = {False: 1e-5, True: 5e-5}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    from _torch_parity import gan_pair_from_port
    jgen, variables, port, scene, z = gan_pair_from_port(
        **VARIANTS[request.param])
    return dict(name=request.param, jgen=jgen, variables=variables,
                port=port, scene=scene, z=z)


def test_variant_takes_its_path(variant):
    """constant_trimask stays on the candidate path (the unirow kernels on
    the card), the others sample every bone densely from raw planes, and
    with ``tile_patch`` only constant_trimask takes the tiled renderer."""
    import dataclasses
    from enarf_gan_tpu_torch.models.narf import TriPlaneNARF
    nerf = variant["port"].nerf
    dense = variant["name"] != "constant_trimask"
    assert nerf.uses_candidate_sampling() != dense
    tiled = TriPlaneNARF(dataclasses.replace(nerf.params, tile_patch=4),
                         16, 8, 23, device="cpu")
    assert tiled.supports_tiled_sampling() != dense
    planes = torch.zeros(1, (32 + 23) * 3, 16, 16)
    packed = nerf.pack_planes(planes)
    if dense:
        assert packed is planes
        with pytest.raises(ValueError, match="candidate"):
            nerf.pack_planes_tiled(planes)
    else:
        assert isinstance(packed, tuple)


def test_variant_density_color_matches_jax(variant):
    from _torch_parity import float32_jax_samplers
    jgen, variables, port = (variant[k] for k in ("jgen", "variables",
                                                  "port"))
    pose_cam, _, bl, _, _, _ = variant["scene"]
    z = variant["z"]
    with torch.no_grad():
        pose_t, bl_t = port.transform_pose(_t(pose_cam), _t(bl))
        z_nerf, z_rend, _ = port.split_z(_t(z))
        got_planes = port.compute_tri_plane_feature(z_nerf, bl_t)
    planes = jgen.apply(variables, jnp.asarray(z_nerf.numpy()),
                        jnp.asarray(bl_t.numpy()), method=lambda m, z, b:
                        m.nerf.compute_tri_plane_feature(z, b))
    _close(got_planes, planes, 1e-4)      # four modulated resolutions
    pose_s = pose_t.numpy().copy()
    pose_s[:, :, :3, 3] *= port.nerf_params.coordinate_scale
    rs = np.random.default_rng(0)
    # points around the bone centres (most lie in one cube, some in two),
    # as many as a chunk of the forward's, whose shapes JAX's op-by-op run
    # then compiles once for both tests
    n = port.train_ray_chunk * port.nerf_params.Nf
    centres = pose_s[0, rs.integers(0, 23, n), :3, 3]
    pts = (centres + rs.normal(scale=0.3, size=centres.shape)).T[None]
    pts = pts.astype(np.float32)
    candidates = variant["name"] == "constant_trimask"
    # the candidate path's reference runs op by op: XLA's fused float32
    # decides near ties of the candidate bones otherwise (a point of 400
    # moved at another draw)
    apply = jax.jit(lambda v, *a: jgen.apply(
        v, *a, method=lambda m, *a: m.nerf.density_color(*a)))
    with float32_jax_samplers(), jax.disable_jit(candidates):
        d_ref, c_ref, _ = apply(
            variables, jnp.asarray(pts), jnp.asarray(pose_s),
            jnp.asarray(bl_t.numpy()), planes, jnp.asarray(z_rend.numpy()))
    with torch.no_grad():
        table = port.nerf.pack_planes(_t(planes))
        d, c = port.nerf.density_color(_t(pts), _t(pose_s), bl_t, table,
                                       z_rend)
    assert (np.asarray(d_ref) > 0).mean() > 0.05     # densities not all zero
    rel = _REL[not candidates]
    _close(d, d_ref, rel)
    _close(c, c_ref, rel)


@pytest.mark.parametrize("variant", IMAGE_VARIANTS, indirect=True)
def test_variant_gan_image_matches_eager_jax(variant):
    """One image of the GAN's training forward against JAX's run op by op,
    with JAX's fine-sampler draws: every pixel of image, mask and
    foreground within the variant's bound. On the black background: the
    background generator is the same module in every variant
    (tests/test_torch_gan_model.py holds it), and JAX's first run of its
    ops takes about 18 s."""
    from _torch_parity import float32_jax_samplers, jax_gan_randoms
    jgen, variables, port = (variant[k] for k in ("jgen", "variables",
                                                  "port"))
    pose_cam, world, bl, inv_K, _, _ = variant["scene"]
    inputs = (pose_cam, world, bl, variant["z"], inv_K)
    rng = jax.random.PRNGKey(5)
    with float32_jax_samplers(), jax.disable_jit():
        (img, mask, aux), _ = jgen.apply(
            variables, rng, *map(jnp.asarray, inputs), train=True,
            black_bg_if_possible=True, mutable=["stats"])
    kept = {k: v.clone() for k, v in port.named_buffers()}
    with torch.no_grad():
        got = port(*map(_t, inputs), train=True, black_bg_if_possible=True,
                   draws=jax_gan_randoms(rng, port, 1)["draws"])
    for name, buf in port.named_buffers():
        buf.copy_(kept[name])
    assert (got[1].numpy() > 0.05).sum() > 20
    for name, a, b in (("image", got[0], img), ("mask", got[1], mask),
                       ("foreground", got[2]["fg_color"], aux["fg_color"])):
        _close(a, b, _REL[variant["name"] != "constant_trimask"])


# ------------------------------------------------------------------ #
# no_selector's DSO training render and gradients against jax.grad
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """tests/test_torch_train_parity.py's case with ``no_selector``:
    constant planes (no StyleGAN for JAX's gradient to compile) sampled
    densely, every bone weighted 1/K."""
    from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
    from _torch_parity import dso_train_case, tiny_dso_config
    root = str(tmp_path_factory.mktemp("train_no_selector"))
    make_synthetic_human_cache(root, size=32, n_frames=3, n_camera=2)
    raw = tiny_dso_config(root, str(tmp_path_factory.mktemp("out")),
                          no_selector=True, constant_triplane=True,
                          deformation_field=False)
    return dso_train_case(raw, (0, 3))


def test_no_selector_training_render_matches_jax(case):
    from test_torch_train_parity import test_training_render_matches_jax
    assert not case["port"].nerf.uses_candidate_sampling()
    test_training_render_matches_jax(case)


def test_no_selector_train_step_gradients_match_jax(case):
    from test_torch_train_parity import check_gradients
    check_gradients(case, ["nerf.tri_plane", "nerf.mlp.layers.0.bias"])
