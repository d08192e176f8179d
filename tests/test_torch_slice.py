"""The port's DSO full-image render against the JAX one, end to end.

Same scene, same (perturbed) weights through the weight bridge, and JAX's
own fine-sampler draws fed to the port chunk by chunk in valid-first order.

Tolerance, and why not the max alone: the two packages agree on every
density to float32 rounding (convolutions and sums run in another order),
but the inverse-CDF bin pick of the fine sampler is discontinuous, so an
ulp-level difference can move one fine sample to a neighbouring bin and
change that ray's pixel visibly. Where no bin moves, pixels agree to ~1e-5.
So the frame is bounded by a high quantile and the mean of |Δ|, and the
max only loosely.

The float32 cases render a float32-plane model (the default
``plane_sample_dtype``, 25 of the 28 configs): JAX samples its quad
tables (``ops/quadtable.py``), the port its float32 texel table (kernel
1f's plain twin); same bounds.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.models.generator import dso_render_entire_img
from enarf_gan_tpu_torch.models.generator import make_dso_full_renderer

from _torch_parity import build_pair, jax_fine_draws, t

SIZE = 16
CHUNK = 64   # 4 chunks at 16²: the valid-first order and the chunk skip run


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _renders(**overrides):
    gen, variables, port, scene = build_pair(size=SIZE, ray_batchsize=CHUNK,
                                             **overrides)
    pose_cam, _, bl, inv_K, _, _ = scene
    rng = jax.random.PRNGKey(3)
    ft = np.array([0.5], np.float32)
    ref = jax.jit(lambda v, r, pc, ik, f, b: dso_render_entire_img(
        gen, v, r, pc, ik, f, b, render_size=SIZE, ray_batchsize=CHUNK))(
        variables, rng, jnp.asarray(pose_cam), jnp.asarray(inv_K),
        jnp.asarray(ft), jnp.asarray(bl))
    draws = jax_fine_draws(rng, SIZE * SIZE // CHUNK, CHUNK, gen.nerf_params.Nf)
    render = make_dso_full_renderer(port, SIZE, ray_batchsize=CHUNK)
    out = render(t(pose_cam), t(inv_K), t(ft), t(bl), draws=draws)
    return [np.asarray(x) for x in ref], [x.numpy() for x in out]


@pytest.fixture(scope="module")
def renders():
    return _renders()


@pytest.fixture(scope="module")
def renders_f32():
    return _renders(plane_sample_dtype="float32")


FRAME_BOUNDS = [(0, "color", 2e-2, 1e-3), (1, "mask", 2e-2, 1e-3),
                (2, "disparity", 2e-2, 1e-3)]


@pytest.mark.parametrize("i,name,q999,mean", FRAME_BOUNDS)
def test_slice_matches_jax(renders, i, name, q999, mean):
    ref, got = renders[0][i], renders[1][i]
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert np.quantile(d, 0.999) <= q999, (name, np.quantile(d, 0.999))
    assert d.mean() <= mean, (name, d.mean())
    assert d.max() <= 1.0, (name, d.max())


def test_slice_foreground_is_not_empty(renders):
    # an all-zero mask would make the parity above vacuous
    mask = renders[1][1]
    assert (mask > 0.05).sum() > 20, (mask > 0.05).sum()


@pytest.mark.parametrize("i,name,q999,mean", FRAME_BOUNDS)
def test_slice_float32_matches_jax(renders_f32, i, name, q999, mean):
    test_slice_matches_jax(renders_f32, i, name, q999, mean)


def test_slice_float32_foreground_is_not_empty(renders_f32):
    test_slice_foreground_is_not_empty(renders_f32)
