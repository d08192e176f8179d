"""The port's unirow sampler against the JAX package: the quad-row layout
of the JAX package (``pack_unirow`` + ``gather_combine_plain``) and the
texel layout the kernels read (``pack_texels`` + the texel twin, which the
sampler runs on the CPU).

Tolerances:
* ``pack_unirow``: bit-equal (the same f32 planes rounded to bf16 once);
  ``pack_texels``: bit-equal to the texels inside ``pack_unirow``.
* sampler vs JAX ``sample_candidates_unirow``: the bounds of
  tests/test_unirow.py (2e-2 for cand_w, 5e-2 for the feature). The JAX
  combine forms the feature products in bf16; the port, like the TPU
  kernel, in f32.
* texel twin vs quad-row twin: the same values gathered and summed in the
  same order, so 1e-6.
* combine vs JAX ``_combine_xla`` on f32 rows: the same f32 algorithm, so
  1e-5 (sums in another order).
* plane and position gradients, texel path vs quad-row path, both with
  float32 tables: the same sums (the four cells of a texel added in another
  order), so 1e-5 relative L2.

The kernels themselves are held to the texel twin in test_torch_kernels.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.ops import unirow as junirow

from enarf_gan_tpu_torch.ops import unirow


def _inputs(H, W, F, K, n, M, B=2, seed=0):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, H, W)).astype(np.float32)
    pos = rng.uniform(-1.4, 1.4, (B, n, M, 3)).astype(np.float32)
    pos[:, :4] = np.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                             [-0.999, 0.999, 0.0], [2.0, 2.0, 2.0]],
                            np.float32)[None, :, None, :]
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    return planes, pos, idx, valid


CASES = [(16, 16, 8, 5, 64, 3, False), (8, 12, 4, 23, 33, 4, True),
         (12, 12, 32, 23, 40, 4, False)]


@pytest.mark.parametrize("H,W,F,K,n,M,clamp", CASES)
def test_pack_unirow_bit_equal(H, W, F, K, n, M, clamp):
    planes = _inputs(H, W, F, K, n, M)[0]
    got = unirow.pack_unirow(torch.from_numpy(planes), F, K)
    ref = np.asarray(junirow.pack_unirow(jnp.asarray(planes), F, K))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  ref.view(np.int16))


@pytest.mark.parametrize("H,W,F,K,n,M,clamp", CASES)
def test_pack_texels_holds_the_quad_rows_texels(H, W, F, K, n, M, clamp):
    """Corner q of quad row (p, t, s) is texel (p, t + q//2, s + q%2): its
    F feature lanes and its 32-lane mask block."""
    planes = torch.from_numpy(_inputs(H, W, F, K, n, M)[0])
    tex = unirow.pack_texels(planes, F, K)
    quad = unirow.pack_unirow(planes, F, K)
    B = planes.shape[0]
    assert tex.dtype == torch.bfloat16
    assert tuple(tex.shape) == (B, 3, H + 2, W + 2, unirow.TEXEL_WIDTH)
    quad = quad.reshape(B, 3, H + 1, W + 1, -1).view(torch.int16)
    tex = tex.view(torch.int16)
    for q in range(4):
        corner = tex[:, :, q // 2:q // 2 + H + 1, q % 2:q % 2 + W + 1]
        assert torch.equal(corner[..., :F], quad[..., q * F:(q + 1) * F])
        mblock = 4 * F + q * unirow.MASK_BLOCK
        assert torch.equal(corner[..., unirow.FEAT_BLOCK:],
                           quad[..., mblock:mblock + unirow.MASK_BLOCK])
    assert not tex[..., F:unirow.FEAT_BLOCK].any()


@pytest.mark.parametrize("layout", ["texels", "quad rows"])
@pytest.mark.parametrize("H,W,F,K,n,M,clamp", CASES)
def test_sampler_matches_jax(H, W, F, K, n, M, clamp, layout):
    """Points on the plane edges and outside them (in the zero padding),
    invalid candidates; the texel path (the port's sampler) is also held to
    the quad-row twin on the same rows."""
    planes, pos, idx, valid = _inputs(H, W, F, K, n, M)
    tp, tpos, tidx, tvalid = (torch.from_numpy(x)
                              for x in (planes, pos, idx, valid))
    quad = unirow.pack_unirow(tp, F, K)
    args = unirow.candidate_rows(tpos, tidx, tvalid, H, W)
    f_quad, w_quad = unirow.gather_combine_plain(quad, *args, F, clamp)
    if layout == "texels":
        f, w = unirow.sample_candidates_unirow(
            unirow.pack_texels(tp, F, K), tpos, tidx, tvalid, F, K, H, W,
            clamp_mask=clamp)
        torch.testing.assert_close(f, f_quad, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(w, w_quad.permute(0, 2, 1), rtol=1e-6,
                                   atol=1e-6)
    else:
        f, w = f_quad, w_quad.permute(0, 2, 1)
    jt = junirow.pack_unirow(jnp.asarray(planes), F, K)
    f_ref, w_ref = junirow.sample_candidates_unirow(
        jt, jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(valid), F, K, H, W,
        clamp_mask=clamp)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=5e-2,
                               atol=5e-2)


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("clamp", [False, True])
def test_texel_gradients_match_quad_rows(clamp):
    """Autograd through pack_texels + the texel twin against autograd
    through pack_unirow + the quad-row twin, both tables in float32: the
    plane and position gradients."""
    H, W, F, K, n, M = 10, 12, 32, 23, 50, 4
    planes, pos, idx, valid = _inputs(H, W, F, K, n, M, seed=4)
    rng = np.random.default_rng(5)
    cf = torch.from_numpy(rng.normal(size=(2, F, n)).astype(np.float32))
    cw = torch.from_numpy(rng.normal(size=(2, M, n)).astype(np.float32))
    grads = []
    for pack, combine in ((unirow.pack_texels,
                           unirow.gather_combine_texels_plain),
                          (unirow.pack_unirow, unirow.gather_combine_plain)):
        tp = torch.from_numpy(planes).requires_grad_(True)
        tpos = torch.from_numpy(pos).requires_grad_(True)
        args = unirow.candidate_rows(tpos, torch.from_numpy(idx),
                                     torch.from_numpy(valid), H, W)
        f, w = combine(pack(tp, F, K, dtype=torch.float32), *args, F, clamp)
        ((f * cf).sum() + (w * cw).sum()).backward()
        grads.append((tp.grad, tpos.grad))
    (gp, gx), (rp, rx) = grads
    assert float(rp.abs().max()) > 0 and float(rx.abs().max()) > 0
    assert _rel_l2(gp, rp) <= 1e-5
    assert _rel_l2(gx, rx) <= 1e-5


@pytest.mark.parametrize("clamp", [False, True])
def test_plain_combine_is_the_f32_algorithm(clamp):
    rng = np.random.default_rng(1)
    B, M, n, F = 2, 3, 40, 8
    RW = unirow.row_width(F)
    g = rng.normal(size=(B, 3, M, n, RW)).astype(np.float32)
    g[..., 4 * F:] *= 3           # mask logits past the clamp range
    wq4 = rng.uniform(0, 1, (B, 4, 3, M, n)).astype(np.float32)
    idx = rng.integers(0, 24, (B, M, n)).astype(np.int32)
    valid = (rng.random((B, M, n)) > 0.3).astype(np.float32)
    f_ref, w_ref = junirow._combine_xla(jnp.asarray(g), jnp.asarray(wq4),
                                        jnp.asarray(idx), jnp.asarray(valid),
                                        F, clamp)
    # a table holding exactly these rows, each read once
    table = torch.from_numpy(g.reshape(B, 3 * M * n, RW))
    rows = torch.arange(3 * M * n, dtype=torch.int32).reshape(1, 3, M, n) \
        .expand(B, 3, M, n)
    f, w = unirow.gather_combine_plain(table, rows, torch.from_numpy(wq4),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(valid), F, clamp)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-5,
                               atol=1e-5)
