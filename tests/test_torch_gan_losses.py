"""The port's GAN losses (training/losses.py) against the JAX package's on
the same numpy inputs, and R1 against JAX's ``r1_penalty`` through the
JAX discriminator's weights.

Tolerances: float32 arithmetic on both sides, summed in another order:
1e-5 relative for the losses and R1, and for R1's parameter gradients
(double backward through upfirdn, the fused lrelu and minibatch-std)
1e-5 of each gradient's scale.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.nn.stylegan2 import Discriminator as JDiscriminator
from enarf_gan_tpu.training import losses as jl

from enarf_gan_tpu_torch import interop
from enarf_gan_tpu_torch.nn.stylegan2 import Discriminator
from enarf_gan_tpu_torch.training import losses as tl

from _torch_parity import perturbed, t

RS = np.random.RandomState(0)
REAL = RS.randn(8, 1).astype(np.float32) * 2
FAKE = RS.randn(8, 1).astype(np.float32) * 2
FAKE_MASK = RS.uniform(0, 1, (4, 16, 16)).astype(np.float32)
BONE_MASK = (RS.uniform(0, 1, (4, 32, 32)) > 0.7).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("kind", ["ce", "hinge"])
def test_adversarial_losses_match(kind):
    np.testing.assert_allclose(
        float(tl.adv_loss_dis(t(REAL), t(FAKE), kind)),
        float(jl.adv_loss_dis(jnp.asarray(REAL), jnp.asarray(FAKE), kind)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tl.adv_loss_gen(t(FAKE), kind)),
        float(jl.adv_loss_gen(jnp.asarray(FAKE), kind)), rtol=1e-5)
    with pytest.raises(ValueError):
        tl.adv_loss_gen(t(FAKE), "wgan")


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.7])
def test_push_to_background_matches(ratio):
    np.testing.assert_allclose(
        float(tl.push_to_background(t(FAKE_MASK), ratio)),
        float(jl.push_to_background(jnp.asarray(FAKE_MASK), ratio)),
        rtol=1e-5)


@pytest.mark.parametrize("bone_size", [16, 32])
def test_bone_and_patch_losses_match(bone_size):
    bone = BONE_MASK if bone_size == 32 else BONE_MASK[:, ::2, ::2]
    np.testing.assert_allclose(
        float(tl.nerf_bone_loss(t(FAKE_MASK), t(bone))),
        float(jl.nerf_bone_loss(jnp.asarray(FAKE_MASK), jnp.asarray(bone))),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tl.nerf_patch_loss(t(FAKE_MASK), t(bone), 0.7, coef=10)),
        float(jl.nerf_patch_loss(jnp.asarray(FAKE_MASK), jnp.asarray(bone),
                                 0.7, coef=10)), rtol=1e-5)


def test_triplane_l2_reg_matches():
    planes = RS.randn(2, 12, 8, 8).astype(np.float32)
    np.testing.assert_allclose(float(tl.triplane_l2_reg(t(planes))),
                               float(jl.triplane_l2_reg(jnp.asarray(planes))),
                               rtol=1e-5)


def test_mask_losses_gradients_match():
    bone = jnp.asarray(BONE_MASK)
    ref = jax.grad(lambda m: jl.nerf_patch_loss(m, bone, 0.3, coef=10))(
        jnp.asarray(FAKE_MASK))
    m = t(FAKE_MASK).requires_grad_(True)
    tl.nerf_patch_loss(m, t(BONE_MASK), 0.3, coef=10).backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("mbstd", [False, True])
def test_r1_penalty_and_its_gradients_match(mbstd):
    x = RS.randn(8, 3, 16, 16).astype(np.float32)
    jd = JDiscriminator(size=16, minibatch_std=mbstd, channel_max=32)
    variables = perturbed(jd.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = variables["params"]

    def r1(p):
        return jl.r1_penalty(lambda q, img: jd.apply({"params": q}, img), p,
                             jnp.asarray(x))

    ref, ref_grads = jax.jit(jax.value_and_grad(r1))(params)
    port = Discriminator(16, minibatch_std=mbstd, channel_max=32,
                         device="cpu")
    interop.load_flax_discriminator(
        port, jax.tree_util.tree_map(np.asarray, dict(params)))
    got = tl.r1_penalty(port, t(x))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    assert float(ref) > 0
    flat = interop._flatten(jax.tree_util.tree_map(np.asarray,
                                                   dict(ref_grads)))
    for name, p in port.named_parameters():
        want = flat[name.replace(".", "/")]
        if p.grad is None:        # the last bias: x's gradient lacks it
            assert not np.abs(want).any(), name
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        d = float(np.abs(p.grad.numpy() - want).max())
        assert d <= 1e-5 * scale, (name, d, scale)
