"""The port's float32 candidate sampling against the JAX package's float32
sampler, ``ops/quadtable.py`` (``pack_quadtable`` +
``sample_candidates_quadtable``, XLA row gathers and autodiff).

The port samples float32 planes from the float32 texel table
(``pack_texels(..., dtype=float32)`` + ``sample_candidates_unirow``; on the
CPU the plain twin of kernels 1f and 1bf).
Tolerances are tests/test_quadtable.py's: part probabilities 2e-5,
features 2e-4, gradients 2e-3 (all float32; the sums run in another
order).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.ops import quadtable as jquad
from enarf_gan_tpu_torch.ops import unirow

CASES = [(16, 16, 32, 23, 64, 4, False), (16, 16, 8, 5, 64, 3, True),
         (8, 12, 4, 23, 33, 4, False), (32, 32, 32, 24, 50, 4, True)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _inputs(H, W, F, K, n, M, seed=0):
    rng = np.random.default_rng(seed)
    B = 2
    planes = rng.normal(size=(B, (F + K) * 3, H, W)).astype(np.float32)
    # in range, on the edges, and far out of range
    pos = rng.uniform(-1.4, 1.4, (B, n, M, 3)).astype(np.float32)
    pos[:, :4] = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                           [-0.999, 0.999, 0.0], [2.0, 2.0, 2.0]],
                          np.float32)[None, :, None, :]
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    return planes, pos, idx, valid


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _jax(planes, pos, idx, valid, F, K, H, W, clamp):
    tables = jquad.pack_quadtable(planes, F, K, jnp.float32)
    return jquad.sample_candidates_quadtable(tables, pos, idx, valid, F, K,
                                             H, W, clamp_mask=clamp)


def _port(planes, pos, idx, valid, F, K, H, W, clamp):
    texels = unirow.pack_texels_f32(planes, F, K)
    assert texels.dtype == torch.float32
    return unirow.sample_candidates_unirow(texels, pos, idx, valid, F, K, H,
                                           W, clamp_mask=clamp)


T = torch.from_numpy


@pytest.mark.parametrize("H,W,F,K,n,M,clamp", CASES)
def test_float32_texel_sampling_matches_jax_quadtable(H, W, F, K, n, M,
                                                      clamp):
    planes, pos, idx, valid = _inputs(H, W, F, K, n, M)
    f_ref, w_ref = _jax(planes, pos, idx, valid, F, K, H, W, clamp)
    feat, w = _port(T(planes), T(pos), T(idx), T(valid), F, K, H, W, clamp)
    assert feat.shape == (2, F, n) and w.shape == (2, n, M)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(feat.numpy(), np.asarray(f_ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("H,F,K,M,clamp", [(8, 4, 6, 3, False),
                                           (16, 32, 23, 4, True)])
def test_float32_sampling_gradients_match_jax(H, F, K, M, clamp):
    """Gradients of a loss of both outputs with respect to the planes and
    the positions: the port's autograd through ``pack_texels`` and the
    plain twin against ``jax.grad`` through the quad tables."""
    planes, pos, idx, valid = _inputs(H, H, F, K, 17, M, seed=2)
    valid[:] = True
    rng = np.random.default_rng(3)
    cf = rng.normal(size=(2, F, 17)).astype(np.float32)
    cw = rng.normal(size=(2, 17, M)).astype(np.float32)

    def jloss(planes, pos):
        f, w = _jax(planes, pos, idx, valid, F, K, H, H, clamp)
        return (f * cf).sum() + (w * cw).sum()

    g_ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(planes),
                                                     jnp.asarray(pos))
    tp = T(planes).requires_grad_(True)
    tq = T(pos).requires_grad_(True)
    f, w = _port(tp, tq, T(idx), T(valid), F, K, H, H, clamp)
    g = torch.autograd.grad((f * T(cf)).sum() + (w * T(cw)).sum(), [tp, tq])
    assert float(g[0].abs().max()) > 0 and float(g[1].abs().max()) > 0
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3)
