"""The port's StyleGAN2 pieces of the GAN (nn/stylegan2.py) against the JAX
package's, with the JAX modules' perturbed weights carried over and JAX's
own draws (noise a layer, crop offsets) rebuilt with its key splits.

Tolerances: these are float32 networks on both sides, whose convolutions
and sums run in another order: 1e-5 of the output's scale (outputs,
input gradients and the w_avg update).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.nn import stylegan2 as jsg
from enarf_gan_tpu.training.checkpoint import export_reference_state_dict

from enarf_gan_tpu_torch import interop
from enarf_gan_tpu_torch.nn import stylegan2 as tsg

from _torch_parity import jax_crop, jax_noise, perturbed, t

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _close(got, ref, rel):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    d = np.abs(np.asarray(got) - ref)
    assert d.max() <= rel * scale, (d.max(), scale)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.mark.parametrize("update", [False, True])
def test_mapping_truncation_and_w_avg_match(update):
    rs = np.random.RandomState(0)
    z = rs.randn(6, 16).astype(np.float32)
    c = rs.randn(6, 12).astype(np.float32)
    jm = jsg.MappingNetwork(style_dim=32, num_layers=8, c_dim=12)
    variables = perturbed(jm.init(KEY, jnp.asarray(z), jnp.asarray(c)))
    w_avg = rs.randn(32).astype(np.float32)
    variables = {**variables, "stats": {"w_avg": jnp.asarray(w_avg)}}
    ref, mut = jm.apply(variables, jnp.asarray(z), jnp.asarray(c),
                        update_w_avg=update, truncation_psi=0.7,
                        mutable=["stats"])
    port = tsg.MappingNetwork(16, 32, 8, c_dim=12, device="cpu")
    port.load_state_dict({k.replace("/", "."): t(v) for k, v in
                          interop._flatten(variables["params"]).items()})
    port.w_avg.copy_(t(w_avg))
    with torch.no_grad():
        got = port(t(z), t(c), update_w_avg=update, truncation_psi=0.7)
    _close(got.numpy(), ref, 1e-5)
    np.testing.assert_allclose(port.w_avg.numpy(),
                               np.asarray(mut["stats"]["w_avg"]),
                               rtol=1e-5, atol=1e-6)
    assert update == (not np.allclose(port.w_avg.numpy(), w_avg))


@pytest.fixture(scope="module")
def background():
    """The GAN's background at test width (16², style 8, 32 channels) with
    perturbed weights (noise weights too) and a random w_avg."""
    rs = np.random.RandomState(1)
    z1, z2 = (rs.randn(2, 8).astype(np.float32) for _ in range(2))
    jg = jsg.StyleGAN2Generator(size=16, style_dim=8, n_mlp=4, out_channels=3,
                                crop_background=True, channel_max=32)
    variables = perturbed(jg.init(KEY, [jnp.asarray(z1), jnp.asarray(z2)],
                                  inject_index=2))
    w_avg = rs.randn(8).astype(np.float32)
    variables = {**variables, "stats": {"mapping": {"w_avg": jnp.asarray(w_avg)}}}
    sd = export_reference_state_dict({"params": {
        "background_generator": variables["params"]}})
    port = tsg.BackgroundGenerator(16, style_dim=8, n_mlp=4,
                                   crop_background=True, channel_max=32,
                                   device="cpu")
    interop.load_reference_state_dict(
        port, {k.split(".", 1)[1]: v for k, v in sd.items()})
    port.w_avg.copy_(t(w_avg))
    return jg, variables, port, (z1, z2)


@pytest.mark.parametrize("train,psi", [(False, 1.0), (True, 1.0),
                                       (True, 0.6)])
def test_background_noise_mixing_crop_match(background, train, psi):
    jg, variables, port, (z1, z2) = background
    noise_rng, crop_rng = jax.random.split(jax.random.PRNGKey(5))
    ref = jg.apply(variables, [jnp.asarray(z1), jnp.asarray(z2)],
                   inject_index=2, truncation_psi=psi, noise_rng=noise_rng,
                   crop_rng=crop_rng, train=train)
    crop = jax_crop(crop_rng, 16)
    with torch.no_grad():
        got = port([t(z1), t(z2)], inject_index=2, truncation_psi=psi,
                   noise=jax_noise(noise_rng, port, 2), crop=crop,
                   train=train)
    assert got.shape == (2, 3, 16, 16)
    _close(got.numpy(), ref, 1e-5)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1     # real structure
    # the noise and the styles both matter, so the match is not vacuous
    with torch.no_grad():
        quiet = port([t(z1), t(z2)], inject_index=2, truncation_psi=psi,
                     crop=crop, train=train)
        one = port([t(z1)], truncation_psi=psi,
                   noise=jax_noise(noise_rng, port, 2), crop=crop,
                   train=train)
    assert float((quiet - got).abs().max()) > 1e-3
    assert float((one - got).abs().max()) > 1e-3


def test_background_crop_is_random_in_training_and_central_otherwise(
        background):
    _, _, port, (z1, z2) = background
    g = torch.Generator().manual_seed(0)
    noise = [torch.randn(s, generator=g) for s in port.noise_shapes(2)]
    with torch.no_grad():
        port.crop_background = False
        try:
            canvas = port([t(z1)], noise=noise)
        finally:
            port.crop_background = True
        assert canvas.shape == (2, 3, 16, 32)
        centre = port([t(z1)], noise=noise)
        np.testing.assert_array_equal(centre.numpy(),
                                      canvas[..., 8:24].numpy())
        offsets = set()
        for _ in range(12):
            crop = port([t(z1)], noise=noise, train=True, generator=g)
            hits = [x0 for x0 in range(17)
                    if torch.equal(crop, canvas[..., x0:x0 + 16])]
            assert hits
            offsets.add(hits[0])
        assert len(offsets) > 3, offsets


@pytest.mark.parametrize("mbstd", [False, True])
def test_discriminator_matches(mbstd):
    rs = np.random.RandomState(2)
    x = rs.randn(8, 3, 16, 16).astype(np.float32)
    jd = jsg.Discriminator(size=16, minibatch_std=mbstd, channel_max=32)
    variables = perturbed(jd.init(KEY, jnp.asarray(x)))
    ref = jd.apply(variables, jnp.asarray(x))
    port = tsg.Discriminator(16, minibatch_std=mbstd, channel_max=32,
                             device="cpu")
    interop.load_flax_discriminator(port, _numpy_tree(variables["params"]))
    with torch.no_grad():
        got = port(t(x))
    assert got.shape == (8, 1)
    _close(got.numpy(), ref, 1e-5)
    # input gradients (what R1 differentiates once more)
    gx = jax.grad(lambda x: jd.apply(variables, x).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    port(xt).sum().backward()
    _close(xt.grad.numpy(), gx, 1e-5)


def test_discriminator_bridge_is_strict():
    jd = jsg.Discriminator(size=16, minibatch_std=True, channel_max=32)
    params = _numpy_tree(jd.init(KEY, jnp.zeros((4, 3, 16, 16)))["params"])
    port = tsg.Discriminator(16, channel_max=32, device="cpu")
    flat = interop._flatten(params)
    assert {k.replace("/", ".") for k in flat} == set(port.state_dict())
    flat.pop("final_linear1/bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        interop.load_flax_discriminator(port, flat)
