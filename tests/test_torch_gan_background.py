"""The GAN generator's backgrounds and outputs that the demos and the
evaluation read, against the JAX package's, on the same numpy inputs:
the forward with ``black_bg_if_possible`` and ``return_disparity`` (exact
and tiled paths, JAX's own draws), a ``black_background`` model (z split
in three as JAX's), the frozen ``PretrainedStyleGAN`` (train and eval
crops, JAX's noise and crop) and ``load_pretrained_background`` (one npz
of rosinality names).

The GAN's weights are the port's, seeded and perturbed, carried into JAX
(``_torch_parity.gan_pair_from_port``); JAX samples the bf16 planes in
float32 (``float32_jax_samplers``), as the port's combines do.

Tolerances. The frames: JAX's jitted forward decides near ties of the
discrete choices (candidate bones, patch slots, fine bins) otherwise than
the port and its own eager forward (tests/test_torch_gan_model.py), so as
there the share of pixels off by more than 1e-4 in image, mask or
disparity is bounded (a whole 4x4 patch counted on the tiled path): 10%
exact, 15% tiled (7.0% and 6.3% at this seed: these perturbed weights
flip more near ties than that file's; JAX's eager forward, 30 s here,
agrees on every pixel within 7e-5), and the mean |d| of each by 2e-2; the
black background is -1 exactly. The background networks are float32
nets: 1e-5 of the output's scale. Loaded weights: equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.models import generator as tgen
from enarf_gan_tpu_torch.training import checkpoint as tckpt

PATHS = {"exact": dict(tile_patch=0),
         "tiled": dict(tile_patch=4, tile_coarse_corners=True)}
UNSTABLE_SHARE = {"exact": 0.10, "tiled": 0.15}
B, SIZE = 2, 16
# the pretrained background at test width: a 16² rosinality generator
# cropped to 8²
PRE = dict(size=8, gen_size=16, style_dim=16, channel_max=16)


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


@pytest.fixture(scope="module")
def pair():
    from _torch_parity import gan_pair_from_port
    return gan_pair_from_port(size=SIZE, B=B)


def _unstable(port, diff):
    bad = diff > 1e-4
    if port.nerf.supports_tiled_sampling():
        P = port.nerf_params.tile_patch
        patch = bad.reshape(B, SIZE // P, P, SIZE // P, P).any(axis=(2, 4))
        bad = np.repeat(np.repeat(patch, P, axis=1), P, axis=2)
    return bad


@pytest.mark.parametrize("path", sorted(PATHS))
def test_black_bg_and_disparity_match_jax(pair, path):
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.models.generator import TriNARFGenerator
    from _torch_parity import (GAN_KW, float32_jax_samplers,
                               jax_render_draws)
    jgen0, variables, port0, scene, z = pair
    jgen = TriNARFGenerator(nerf_params=dataclasses.replace(
        jgen0.nerf_params, **PATHS[path]), size=SIZE, num_bone=24,
        parent_id=jgen0.parent_id, train_ray_chunk=128, **GAN_KW)
    port = tgen.TriNARFGenerator(
        dataclasses.replace(port0.nerf_params, **PATHS[path]), SIZE, 24,
        port0.parent_id, train_ray_chunk=128, device="cpu", **GAN_KW)
    port.load_state_dict(port0.state_dict())
    for name, b in port.named_buffers():
        b.copy_(dict(port0.named_buffers())[name])
    pose_cam, world, bl, inv_K, _, _ = scene
    rng = jax.random.PRNGKey(11)
    with float32_jax_samplers():
        img, mask, aux = jax.jit(lambda v, *a: jgen.apply(
            v, *a, truncation_psi=0.7, black_bg_if_possible=True,
            return_disparity=True))(
            variables, rng, *map(jnp.asarray, (pose_cam, world, bl, z,
                                               inv_K)))
    rng_fine, _ = jax.random.split(rng)
    with torch.no_grad():
        got = port(*map(_t, (pose_cam, world, bl, z, inv_K)),
                   truncation_psi=0.7, black_bg_if_possible=True,
                   return_disparity=True,
                   draws=jax_render_draws(rng_fine, port, B, 128))
    g_img, g_mask, g_aux = (x.numpy() if torch.is_tensor(x) else x
                            for x in got)
    assert float(g_aux["bg_color"]) == -1.0 == float(aux["bg_color"])
    fg = g_aux["fg_color"].numpy()
    np.testing.assert_allclose(g_img, fg - (1 - g_mask[:, None]), atol=1e-6)
    disp = g_aux["disparity"].numpy()
    assert disp.shape == (B, SIZE, SIZE) and (disp > 0).any()
    ref = {"image": np.asarray(img), "mask": np.asarray(mask),
           "disparity": np.asarray(aux["disparity"])}
    diff = np.maximum.reduce([
        np.abs(g_img - ref["image"]).max(axis=1),
        np.abs(g_mask - ref["mask"]),
        np.abs(disp - ref["disparity"])])
    assert (g_mask > 0.05).sum() > 40
    assert _unstable(port, diff).mean() <= UNSTABLE_SHARE[path]
    for name, a in (("image", g_img), ("mask", g_mask), ("disparity", disp)):
        assert np.abs(a - ref[name]).mean() <= 2e-2, name


def test_black_background_model(pair):
    """A ``black_background`` model: no background network, z split in
    three as JAX's ``split_z`` splits it, the image over -1 and no draw
    of a background."""
    import jax.numpy as jnp
    from enarf_gan_tpu.models.generator import TriNARFGenerator
    from _torch_parity import GAN_KW
    jgen0, _, port0, scene, _ = pair
    jgen = TriNARFGenerator(nerf_params=jgen0.nerf_params, size=SIZE,
                            num_bone=24, parent_id=jgen0.parent_id,
                            black_background=True, **GAN_KW)
    port = tgen.TriNARFGenerator(port0.nerf_params, SIZE, 24,
                                 port0.parent_id, train_ray_chunk=128,
                                 black_background=True, device="cpu",
                                 **GAN_KW)
    assert not hasattr(port, "background_generator")
    port.load_state_dict({k: v for k, v in port0.state_dict().items()
                          if not k.startswith("background_generator.")})
    z = np.random.RandomState(5).randn(B, 3 * 8).astype(np.float32)
    got = port.split_z(_t(z))
    want = jgen.split_z(jnp.asarray(z))
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pose_cam, world, bl, inv_K, _, _ = scene
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        img, mask, aux = port(*map(_t, (pose_cam, world, bl, z, inv_K)),
                              generator=g)
    assert float(aux["bg_color"]) == -1.0
    torch.testing.assert_close(img, aux["fg_color"] - (1 - mask[:, None]),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pretrained():
    """The JAX ``PretrainedStyleGAN`` (seeded normal weights and w_avg in
    the shapes of its init), the port's with them through the bridge, and
    JAX's eval and train outputs for two styles, with its noise and crop
    keys (one jitted call)."""
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.nn.stylegan2 import PretrainedStyleGAN
    from enarf_gan_tpu_torch.interop import load_flax_pretrained_background
    from enarf_gan_tpu_torch.nn.stylegan2 import PretrainedStyleGAN as TPre
    jmod = PretrainedStyleGAN(**PRE)
    key = jax.random.PRNGKey(0)
    zs = [np.random.RandomState(s).randn(B, 8).astype(np.float32)
          for s in (1, 2)]
    template = jax.eval_shape(lambda k: jmod.init(
        k, list(map(jnp.asarray, zs)), inject_index=2), key)
    leaves, tree = jax.tree_util.tree_flatten(template)
    rs = np.random.RandomState(3)
    variables = jax.tree_util.tree_unflatten(
        tree, [np.asarray(rs.randn(*x.shape), np.float32) for x in leaves])
    port = TPre(**PRE, device="cpu")
    load_flax_pretrained_background(port, variables["params"],
                                    variables["stats"])
    crop_rng, noise_rng = jax.random.split(jax.random.PRNGKey(21))
    inject = port.n_latent - 4
    canvas, size = PRE["gen_size"], PRE["size"]

    def run(v, a, b):
        outs = [jmod.apply(v, [a, b], inject_index=inject, train=train,
                           crop_rng=crop_rng, noise_rng=noise_rng)
                for train in (False, True)]
        # the draws: the synthesis' noise a styled conv, in order, and the
        # training crop (y0, x0)
        noise, r = [], noise_rng
        for shape in port.gen.noise_shapes(B):
            r, k = jax.random.split(r)
            noise.append(jax.random.normal(k, shape, jnp.float32))
        ky, kx = jax.random.split(crop_rng)
        crop = [jax.random.randint(k, (), 0, canvas - size + 1)
                for k in (ky, kx)]
        return outs, noise, crop

    outs, noise, crop = jax.jit(run)(variables, *map(jnp.asarray, zs))
    return (port, zs, [_t(x) for x in noise], tuple(int(c) for c in crop),
            [np.asarray(o) for o in outs])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pretrained_stylegan_matches_jax(pretrained, train):
    port, zs, noise, crop, outs = pretrained
    assert not any(p.requires_grad for p in port.parameters())
    size = PRE["size"]
    with torch.no_grad():
        got = port([_t(z) for z in zs], inject_index=port.n_latent - 4,
                   noise=noise, crop=crop, train=train).numpy()
    want = outs[int(train)]
    assert got.shape == want.shape == (B, 3, size, size)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_pretrained_background_in_generator():
    """``pretrained_background`` builds the frozen background and the
    G step leaves it alone: no gradient reaches it and the optimiser does
    not hold it."""
    from _torch_parity import GAN_KW, GAN_SMALL, PARENTS
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    from enarf_gan_tpu_torch.training.dso import Optimizer
    kw = {k: v for k, v in GAN_KW.items() if k != "crop_background"}
    gen = tgen.TriNARFGenerator(
        tgen.NARFParams(**GAN_SMALL), SIZE, 24, PARENTS,
        pretrained_background=True, pretrained_bg_size=32,
        train_ray_chunk=128, device="cpu", **{**kw, "channel_max": 16})
    pose_cam, world, bl, inv_K, canonical, _ = tiny_scene(1, SIZE)
    tgen.register_canonical_pose(gen, canonical, "center_fixed", PARENTS)
    opt = Optimizer(gen.parameters(), 1e-3)
    bg = set(map(id, gen.background_generator.parameters()))
    assert bg and not bg & set(map(id, opt.params))
    g = torch.Generator().manual_seed(0)
    img, _, aux = gen(*map(_t, (pose_cam, world, bl)),
                      torch.randn(1, 32, generator=g), _t(inv_K),
                      generator=g)
    assert aux["bg_color"].shape == (1, 3, SIZE, SIZE)
    img.square().mean().backward()
    assert all(p.grad is None for p in gen.background_generator.parameters())
    assert gen.nerf.tri_plane_gen.mapping.fc0.weight.grad is not None


def _g_ema(port_bg, seed=0):
    """A converted church checkpoint's arrays for ``port_bg``: rosinality's
    names, the styled convs' biases as its flat ``.activate.bias``
    (``conv1``'s as the reference's (1, C, 1, 1) ``.bias``), and a noise
    buffer that no parameter takes."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in port_bg.gen.named_parameters():
        arr = rs.randn(*p.shape).astype(np.float32)
        if name.startswith("convs.") and name.endswith(".bias"):
            out[name.replace(".bias", ".activate.bias")] = arr.reshape(-1)
        else:
            out[name] = arr
    out["noises.noise_0"] = rs.randn(1, 1, 4, 4).astype(np.float32)
    return out


def test_load_pretrained_background_matches_jax(pretrained, tmp_path):
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.models.generator import TriNARFGenerator
    from enarf_gan_tpu.models.narf import NARFParams
    from enarf_gan_tpu.training import checkpoint as jckpt
    from _torch_parity import GAN_SMALL, PARENTS
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    port_bg = pretrained[0]
    path = tmp_path / "church.npz"
    np.savez(path, **_g_ema(port_bg))
    arrays = dict(np.load(path))
    kw = dict(size=PRE["size"], num_bone=24, parent_id=PARENTS, z_dim=8,
              pretrained_background=True, pretrained_bg_size=PRE["gen_size"],
              channel_max=16)
    jgen = TriNARFGenerator(nerf_params=NARFParams(**GAN_SMALL), **kw)
    pose_cam, world, bl, inv_K, _, _ = tiny_scene(1, PRE["size"])
    key = jax.random.PRNGKey(0)
    template = jax.eval_shape(jgen.init, key, key, *map(jnp.asarray, (
        pose_cam, world, bl, np.zeros((1, 32), np.float32), inv_K)))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   jckpt.jax_tree_to_dict(template))
    want, _ = jckpt.load_pretrained_background(zeros, arrays)
    want = jckpt.export_reference_state_dict(want)
    port = tgen.TriNARFGenerator(tgen.NARFParams(**GAN_SMALL), device="cpu",
                                 **kw)
    report = tckpt.load_pretrained_background(port, arrays)
    assert report["unused"] == ["noises.noise_0"] and not report["missing"]
    got = {k: v.numpy() for k, v in port.state_dict().items()
           if k.startswith("background_generator.")}
    assert set(got) == {k for k in want
                        if k.startswith("background_generator.")}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert not any(p.requires_grad
                   for p in port.background_generator.parameters())
    # a parameter the npz lacks: both raise, and the port loads nothing
    del arrays["to_rgbs.0.conv.weight"]
    with pytest.raises(ValueError, match="unmapped background parameters"):
        jckpt.load_pretrained_background(zeros, arrays)
    before = port.background_generator.gen.to_rgb1.bias.clone()
    arrays["to_rgb1.bias"] = arrays["to_rgb1.bias"] + 1
    with pytest.raises(ValueError, match="unmapped background parameters"):
        tckpt.load_pretrained_background(port, arrays)
    torch.testing.assert_close(port.background_generator.gen.to_rgb1.bias,
                               before, rtol=0, atol=0)
