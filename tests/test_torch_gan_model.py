"""The port's GAN generator (models/generator.py::TriNARFGenerator, its
StyleGAN tri-plane NARF and the full-image renderer) against the JAX
package's, on the exact (tile_patch 0) and the tiled (tile_patch 4, coarse
corners) paths, at the widths of tests/test_models.py.

Same poses and z (numpy, from a seed), the JAX model's perturbed weights
and random w_avg statistics through the weight bridge, and JAX's own draws
(fine sampler a ray chunk, background noise a layer, crop) rebuilt with
its key splits. JAX samples the bf16 planes in float32
(``float32_jax_samplers``), as the port's combines do.

Tolerances. Planes, background and the w_avg update are float32 nets: 1e-4
of the output's scale for the planes (four modulated resolutions, as
tests/test_torch_models.py), 1e-5 for the rest. The frame: the port matches
JAX's forward run op by op (``jax.disable_jit``) to 1e-5 of the output's
scale on every pixel, which one test holds for the first pose of the
batch on each path (the eager forward of one image takes about 20 s).
JAX's jitted forward differs from that same eager forward on about 2% of
the tiled pixels by up to 0.45 (``tests/gan_jax_jit_study.py`` prints
both): XLA's fused float32 arithmetic decides near ties of the discrete
choices otherwise (the candidate bones and patch slots, the fine
sampler's bin pick), and a flip changes a ray, or a 4x4 patch, visibly.
So the other tests compare with the jitted forward and bound the share
of pixels off by more than 1e-4 (a whole patch counted on the tiled
path): 5% exact, 15% tiled (2.1% and 9.4% at this seed), and the mean
|d| of the image by 2e-2. The gradients are compared on a loss over the
pixels that agree: relative L2 error 2e-2 per parameter (as
tests/test_torch_train_parity.py). The exact case's weights also run on
float32 planes (the default sampling of ``config.yml``), against JAX's
float32 quad tables run op by op: 1e-4 of the scale (see that test).

The ``cuda`` tests run the same forward and its gradients through the
kernels (1 and 1b exact, 2 and 2b tiled) and through the plain combine on
the card: share of pixels off by more than 1e-3 at most 2%, parameter
gradients within 1e-2 relative L2 (the kernels add in another order, and a
flipped near-tie moves a ray). They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gan_model.py
"""
from unittest import mock

import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.models import generator as tgen
from enarf_gan_tpu_torch.models.narf import NARFParams, TriPlaneNARF

PATHS = {"exact": dict(tile_patch=0),
         "tiled": dict(tile_patch=4, tile_coarse_corners=True)}
UNSTABLE_SHARE = {"exact": 0.05, "tiled": 0.15}
B, SIZE = 2, 16


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


def _unstable(port, diff):
    """Pixels (B, H, W) off by more than 1e-4; on the tiled path every
    pixel of a patch holding one."""
    bad = diff > 1e-4
    if port.nerf.supports_tiled_sampling():
        P = port.nerf_params.tile_patch
        patch = bad.reshape(B, SIZE // P, P, SIZE // P, P).any(axis=(2, 4))
        bad = np.repeat(np.repeat(patch, P, axis=1), P, axis=2)
    return bad


def _masked_loss(img, mask, w):
    return ((img ** 2).mean(axis=1) * w).sum() / w.sum() \
        + (mask ** 2 * w).sum() / w.sum()


@pytest.fixture(scope="module", params=sorted(PATHS))
def case(request):
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.training.checkpoint import export_reference_state_dict
    from _torch_parity import (build_gan_pair, float32_jax_samplers,
                               jax_gan_randoms)
    path = request.param
    jgen, variables, port, scene, z = build_gan_pair(B=B, size=SIZE,
                                                     **PATHS[path])
    pose_cam, world, bl, inv_K, _, _ = scene
    rng = jax.random.PRNGKey(3)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    args = (rng, jnp.asarray(pose_cam), jnp.asarray(world), jnp.asarray(bl),
            jnp.asarray(z), jnp.asarray(inv_K))

    def loss_fn(params, w):
        (img, mask, aux), mut = jgen.apply(
            {"params": params, **rest}, *args, train=True, mutable=["stats"])
        return _masked_loss(img, mask, w), (
            img, mask, aux["fg_color"], aux["bg_color"],
            aux["tri_plane_feature"], mut["stats"])

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    with float32_jax_samplers():
        (_, ref), _ = step(params, jnp.ones((B, SIZE, SIZE)))
    ref = [np.asarray(x) if not isinstance(x, dict) else x for x in ref]
    randoms = jax_gan_randoms(rng, port, B)
    w_avg_before = port.nerf.tri_plane_gen.mapping.w_avg.clone()
    img, mask, aux = port(_t(pose_cam), _t(world), _t(bl), _t(z), _t(inv_K),
                          train=True, **randoms)
    diff = np.maximum.reduce([
        np.abs(img.detach().numpy() - ref[0]).max(axis=1),
        np.abs(mask.detach().numpy() - ref[1]),
        np.abs(aux["fg_color"].detach().numpy() - ref[2]).max(axis=1)])
    w = (~_unstable(port, diff)).astype(np.float32)
    with float32_jax_samplers():
        (loss, _), grads = step(params, jnp.asarray(w))
    port.zero_grad(set_to_none=True)
    got_loss = _masked_loss(img, mask, torch.from_numpy(w))
    got_loss.backward()
    return dict(path=path, port=port, ref=ref, img=img.detach().numpy(),
                mask=mask.detach().numpy(), aux=aux, diff=diff, w=w,
                loss=(float(got_loss.detach()), float(loss)),
                grads=export_reference_state_dict({**variables,
                                                   "params": grads}),
                w_avg_before=w_avg_before, jgen=jgen, variables=variables,
                scene=scene, z=z)


def test_gan_forward_matches_jax(case):
    port, ref = case["port"], case["ref"]
    scale = lambda x: max(1.0, float(np.abs(x).max()))  # noqa: E731
    planes = case["aux"]["tri_plane_feature"].detach().numpy()
    assert np.abs(planes - ref[4]).max() <= 1e-4 * scale(ref[4])
    bg = case["aux"]["bg_color"].detach().numpy()
    assert np.abs(bg - ref[3]).max() <= 1e-5 * scale(ref[3])
    # the tri-plane mapping's w_avg moved in train mode, as JAX's did
    w_avg = port.nerf.tri_plane_gen.mapping.w_avg.numpy()
    want = np.asarray(ref[5]["nerf"]["generator"]["mapping"]["w_avg"])
    np.testing.assert_allclose(w_avg, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(w_avg, case["w_avg_before"].numpy())
    # ... and the background's did not
    np.testing.assert_allclose(
        port.background_generator.w_avg.numpy(),
        np.asarray(ref[5]["background_generator"]["mapping"]["w_avg"]),
        rtol=0, atol=0)
    # the frame
    assert case["img"].shape == (B, 3, SIZE, SIZE)
    assert case["mask"].shape == (B, SIZE, SIZE)
    assert (case["mask"] > 0.05).sum() > 40          # a real foreground
    share = 1 - case["w"].mean()
    assert share <= UNSTABLE_SHARE[case["path"]], share
    assert np.abs(case["img"] - ref[0]).mean() <= 2e-2


def test_gan_forward_matches_eager_jax_on_every_pixel(case):
    """The training forward of the batch's first pose against JAX's run
    op by op, with JAX's draws: every pixel of image, mask and foreground
    within 1e-5 of the output's scale."""
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu_torch.interop import load_jax_stats
    from _torch_parity import float32_jax_samplers, jax_gan_randoms
    jgen, variables, port = case["jgen"], case["variables"], case["port"]
    kept = {k: v.clone() for k, v in port.named_buffers()}
    load_jax_stats(port, variables["stats"])
    pose_cam, world, bl, inv_K, _, _ = case["scene"]
    inputs = (pose_cam[:1], world[:1], bl[:1], case["z"][:1], inv_K)
    rng = jax.random.PRNGKey(5)
    with float32_jax_samplers(), jax.disable_jit():
        (img, mask, aux), _ = jgen.apply(
            variables, rng, *map(jnp.asarray, inputs), train=True,
            mutable=["stats"])
    with torch.no_grad():
        got = port(*map(_t, inputs), train=True,
                   **jax_gan_randoms(rng, port, 1))
    for name, buf in port.named_buffers():
        buf.copy_(kept[name])
    assert (got[1].numpy() > 0.05).sum() > 20
    for name, a, b in (("image", got[0], img), ("mask", got[1], mask),
                       ("foreground", got[2]["fg_color"], aux["fg_color"])):
        b = np.asarray(b)
        d = np.abs(a.numpy() - b).max()
        assert d <= 1e-5 * max(1.0, float(np.abs(b).max())), (name, d)


@pytest.mark.parametrize("case", ["exact"], indirect=True)
def test_gan_float32_forward_matches_eager_jax(case):
    """The exact case's weights on float32 planes, shaped as
    ``configs/enarfgan_train/AIST/config.yml`` (the default float32
    sampling, the exact sampler, the cropped learned background): the
    training forward of one pose against JAX's run op by op, with JAX's
    draws. JAX samples its float32 quad tables (``ops/quadtable.py``), the
    port its float32 texel table (kernel 1f's plain twin here). Every
    pixel of image, mask and foreground within 1e-4 of the output's scale:
    here the planes carry full float32 mantissas, JAX sums each
    candidate's four corners, its planes and the candidates in another
    order than the port, and the density's exp carries those roundings on
    (1.1e-5 to 1.5e-5 of the scale at two draws of this model)."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import build_gan_pair, jax_gan_randoms
    jgen, variables, port, scene, z = build_gan_pair(
        B=1, size=SIZE, tile_patch=0, plane_sample_dtype="float32",
        variables=case["variables"])
    assert port.nerf.texel_dtype == torch.float32
    pose_cam, world, bl, inv_K, _, _ = scene
    inputs = (pose_cam, world, bl, z, inv_K)
    rng = jax.random.PRNGKey(5)
    with jax.disable_jit():
        (img, mask, aux), _ = jgen.apply(
            variables, rng, *map(jnp.asarray, inputs), train=True,
            mutable=["stats"])
    with torch.no_grad():
        got = port(*map(_t, inputs), train=True,
                   **jax_gan_randoms(rng, port, 1))
    assert (got[1].numpy() > 0.05).sum() > 20
    for name, a, b in (("image", got[0], img), ("mask", got[1], mask),
                       ("foreground", got[2]["fg_color"], aux["fg_color"])):
        b = np.asarray(b)
        d = np.abs(a.numpy() - b).max()
        assert d <= 1e-4 * max(1.0, float(np.abs(b).max())), (name, d)


def test_gan_parameter_gradients_match_jax(case):
    got_loss, ref_loss = case["loss"]
    np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-4)
    ref = case["grads"]
    grads = {k: p.grad for k, p in case["port"].named_parameters()}
    assert set(grads) == set(ref) - {"nerf.canonical_pose",
                                     "nerf.canonical_bone_length"}
    checked = 0
    for name, g in grads.items():
        want = np.asarray(ref[name], np.float32)
        if not np.abs(want).max() > 0:
            assert g is None or float(g.abs().max()) < 1e-6, name
            continue
        err = float(np.linalg.norm(g.numpy() - want) / np.linalg.norm(want))
        assert err <= 2e-2, (name, err)
        checked += 1
    assert checked >= 0.8 * len(grads)
    for part in ("nerf.mlp.", "nerf.tri_plane_gen.", "background_generator."):
        assert any(float(g.abs().sum()) > 0 for k, g in grads.items()
                   if k.startswith(part) and g is not None), part


def test_gan_render_entire_img_matches_jax(case):
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.models.generator import gan_render_entire_img
    from enarf_gan_tpu_torch.interop import load_jax_stats
    from _torch_parity import float32_jax_samplers, jax_fine_draws
    jgen, variables, port = case["jgen"], case["variables"], case["port"]
    load_jax_stats(port, variables["stats"])     # undo the forward's update
    pose_cam, _, bl, inv_K, _, _ = case["scene"]
    z = case["z"][1:]        # the second pose and z: 221 foreground pixels
    rng = jax.random.PRNGKey(9)
    chunk = port.nerf_params.render_bs
    with float32_jax_samplers():
        ref = jax.jit(lambda v, r, p, b, z, k: gan_render_entire_img(
            jgen, v, r, p, b, z, k, truncation_psi=0.7))(
            variables, rng, jnp.asarray(pose_cam[1:]), jnp.asarray(bl[1:]),
            jnp.asarray(z), jnp.asarray(inv_K))
    m = port.nerf_params.tile_patch ** 2 if case["path"] == "tiled" else 1
    draws = jax_fine_draws(rng, SIZE * SIZE // chunk, chunk // m,
                           port.nerf_params.Nf)
    render = tgen.make_gan_full_renderer(port)
    got = render(_t(pose_cam[1:]), _t(bl[1:]), _t(z), _t(inv_K),
                 truncation_psi=0.7, draws=draws)
    assert (got[1].numpy() > 0.05).sum() > 100
    for name, a, b in zip(("color", "mask", "disparity"), got, ref):
        d = np.abs(a.numpy() - np.asarray(b))
        if d.ndim == 3:
            d = d.max(axis=0)
        share = (d > 1e-3).mean()
        assert share <= UNSTABLE_SHARE[case["path"]], (name, share)
        assert d.mean() <= 2e-2, (name, d.mean())


def test_chunked_forward_equals_one_pass():
    """``train_ray_chunk`` changes the order of the work, not the image."""
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    from _torch_parity import GAN_KW, GAN_SMALL, PARENTS
    for path in PATHS.values():
        params = NARFParams(**{**GAN_SMALL, **path})
        gens = [tgen.TriNARFGenerator(params, SIZE, 24, PARENTS,
                                      train_ray_chunk=c, device="cpu",
                                      **GAN_KW) for c in (64, 0)]
        gens[1].load_state_dict(gens[0].state_dict())
        pose_cam, world, bl, inv_K, canonical, _ = tiny_scene(B, SIZE)
        outs = []
        for gen in gens:
            tgen.register_canonical_pose(gen, canonical, "center_fixed",
                                         PARENTS)
            with torch.no_grad():
                outs.append(gen(_t(pose_cam), _t(world), _t(bl),
                                torch.randn(B, 32, generator=torch.Generator(
                                ).manual_seed(0)), _t(inv_K),
                                generator=torch.Generator().manual_seed(1)))
        for a, b in zip(outs[0][:2], outs[1][:2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_pretrained_background_and_variants_build():
    from _torch_parity import GAN_SMALL, PARENTS
    from enarf_gan_tpu_torch.nn.stylegan2 import PretrainedStyleGAN
    # the pretrained background is ported: a frozen PretrainedStyleGAN
    gen = tgen.TriNARFGenerator(NARFParams(**GAN_SMALL), SIZE, 24, PARENTS,
                                z_dim=8, pretrained_background=True,
                                pretrained_bg_size=32, channel_max=16,
                                device="cpu")
    assert isinstance(gen.background_generator, PretrainedStyleGAN)
    assert not any(p.requires_grad
                   for p in gen.background_generator.parameters())
    # every variant builds, its planes generated under the reference's names
    for variant, module in (("constant_trimask", "generator"),
                            ("selector_mlp", "generator"),
                            ("no_selector", "tri_plane_gen"),
                            ("constant_triplane", None),
                            ("deformation_field", "flow_generator")):
        nerf = TriPlaneNARF(NARFParams(**{**GAN_SMALL, variant: True}), 16, 8,
                            23, device="cpu")
        assert nerf.plane_generator is (getattr(nerf, module) if module
                                        else None), variant
    # the selector under variants where the JAX model builds none
    for other in ("constant_triplane", "constant_trimask",
                  "deformation_field"):
        with pytest.raises(ValueError, match="selector_mlp"):
            TriPlaneNARF(NARFParams(**{**GAN_SMALL, "selector_mlp": True,
                                       other: True}), 16, 8, 23,
                         device="cpu")


# ------------------------------------------------------------------ #
# on the card: the kernels against the plain combine
# ------------------------------------------------------------------ #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def plain_combines():
    """The plain PyTorch combines in the kernels' place."""
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel, unirow
    return mock.patch.multiple(
        unirow, unirow_combine=unirow.gather_combine_texels_plain), \
        mock.patch.object(tilewin, "tilewin_combine",
                          lambda *a, mode=None:
                          tilewin_kernel.tilewin_combine_texels_plain(*a))


def card_forward_and_grads(gen, scene, device, seed=3):
    pose_cam, world, bl, inv_K = (_t(x).to(device) for x in scene)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((pose_cam.shape[0], 4 * gen.z_dim), generator=g,
                    device=device)
    gen.zero_grad(set_to_none=True)
    img, mask, _ = gen(pose_cam, world, bl, z, inv_K, train=True,
                       generator=g)
    ((img ** 2).mean() + (mask ** 2).mean()).backward()
    return img.detach(), mask.detach(), {
        k: p.grad.clone() for k, p in gen.named_parameters()
        if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_gan_forward_and_gradients_through_kernels_on_card(cuda_device,
                                                           path):
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    from enarf_gan_tpu_torch.ops import tilewin_kernel, unirow
    from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
    params = NARFParams(**{**dict(Nc=8, Nf=8, hidden_size=16,
                                  tri_plane_size=32, w_dim=32,
                                  coordinate_scale=3.0, view_dependent=False,
                                  plane_sample_dtype="bfloat16"),
                           **PATHS[path]})
    gen = tgen.TriNARFGenerator(params, 32, 24, SMPL_PARENTS, z_dim=8,
                                crop_background=True, channel_max=32,
                                train_ray_chunk=256, device=cuda_device,
                                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(cuda_device))
    pose_cam, world, bl, inv_K, canonical, _ = tiny_scene(2, 32)
    tgen.register_canonical_pose(gen, canonical, "center_fixed",
                                 SMPL_PARENTS)
    scene = (pose_cam, world, bl, inv_K)
    kernels = (tilewin_kernel.KERNEL, tilewin_kernel.KERNEL_BWD) \
        if path == "tiled" else (unirow.KERNEL, unirow.KERNEL_BWD)
    before = [k.launches for k in kernels]
    w_avg = gen.nerf.tri_plane_gen.mapping.w_avg.clone()
    img, mask, grads = card_forward_and_grads(gen, scene, cuda_device)
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert float(mask.max()) > 0.05
    gen.nerf.tri_plane_gen.mapping.w_avg.copy_(w_avg)
    p1, p2 = plain_combines()
    with p1, p2:
        counts = [k.launches for k in kernels]
        img_p, mask_p, grads_p = card_forward_and_grads(gen, scene,
                                                        cuda_device)
        assert [k.launches for k in kernels] == counts
    d = torch.maximum((img - img_p).abs().amax(dim=1), (mask - mask_p).abs())
    assert float((d > 1e-3).float().mean()) <= 0.02
    for name, gp in grads_p.items():
        if float(gp.norm()) == 0:
            continue
        err = float((grads[name] - gp).norm() / gp.norm())
        assert err <= 1e-2, (name, err)
