"""The port's differentiable combines (kernels 1b and 2b on the card, their
plain twins under autograd here) against the JAX package's VJPs, and
kernel 3's plain twin against JAX's interpret-mode Pallas kernels. Both
samplers read the texel table on the card; the tilewin window tables of the
JAX layout stay as a second, window-twin case.

Tolerances:
* gradients: relative L2 error <= 2e-2 per tensor. The JAX VJPs round the
  row cotangents to bf16 and accumulate the table cotangent in bf16 (the
  port accumulates in float32 and rounds once, at the bf16 table), and the
  JAX XLA tilewin path rounds the bilinear weights to bf16;
  tests/test_unirow.py holds the JAX VJPs to each other at 2e-2.
* kernel 3's formulations: rtol 1e-5, atol 1e-6. Both sides compute in
  float32 from the same bf16 rows and round the same t-weights; they differ
  by at most 2.4e-7 here, where the bf16 rounding of the t-weights alone
  ("dot"/"bdiag" against "vpu") moves the feature by 3e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.ops import tilewin as jtw
from enarf_gan_tpu.ops import tilewin_kernel as jtk
from enarf_gan_tpu.ops import unirow as junirow

from enarf_gan_tpu_torch.ops import tilewin, unirow

REL_L2 = 2e-2
K3_RTOL, K3_ATOL = 1e-5, 1e-6


def rel_l2(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("layout", ["texels", "quad rows"])
@pytest.mark.parametrize("clamp", [False, True])
def test_unirow_gradients_match_jax_vjp(clamp, layout):
    """The JAX VJP through its quad-row table against the port's sampler
    (the texel table, gradients to the planes and positions) and the
    port's quad-row twin (gradients to the table and positions)."""
    rng = np.random.default_rng(11)
    B, H, F, K, n, M = 2, 12, 32, 23, 60, 4
    planes = rng.normal(size=(B, (F + K) * 3, H, H)).astype(np.float32)
    pos = rng.uniform(-1.2, 1.2, (B, n, M, 3)).astype(np.float32)
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    cf = rng.normal(size=(B, F, n)).astype(np.float32)
    cw = rng.normal(size=(B, n, M)).astype(np.float32)

    def jloss(table, p):
        f, w = junirow.sample_candidates_unirow(
            table, p, jnp.asarray(idx), jnp.asarray(valid), F, K, H, H,
            clamp_mask=clamp)
        return (f * cf).sum() + (w * cw).sum()

    p = torch.from_numpy(pos).requires_grad_(True)
    tp = torch.from_numpy(planes).requires_grad_(True)
    if layout == "texels":
        g_planes, g_pos = jax.grad(
            lambda pl, p: jloss(junirow.pack_unirow(pl, F, K), p),
            argnums=(0, 1))(jnp.asarray(planes), jnp.asarray(pos))
        table = unirow.pack_texels(tp, F, K)
        table.retain_grad()
        f, w = unirow.sample_candidates_unirow(
            table, p, torch.from_numpy(idx), torch.from_numpy(valid), F, K,
            H, H, clamp_mask=clamp)
    else:
        jtable = junirow.pack_unirow(jnp.asarray(planes), F, K)
        g_planes, g_pos = jax.grad(jloss, argnums=(0, 1))(jtable,
                                                           jnp.asarray(pos))
        table = unirow.pack_unirow(tp, F, K).detach().requires_grad_(True)
        f, w = unirow.gather_combine_plain(
            table, *unirow.candidate_rows(p, torch.from_numpy(idx),
                                          torch.from_numpy(valid), H, H),
            F, clamp)
        w = w.permute(0, 2, 1)
    ((f * torch.from_numpy(cf)).sum() + (w * torch.from_numpy(cw)).sum()) \
        .backward()
    assert table.grad.dtype == torch.bfloat16
    got = tp.grad if layout == "texels" else table.grad.float()
    assert rel_l2(got.numpy(), _f32(g_planes)) <= REL_L2
    assert rel_l2(p.grad.numpy(), np.asarray(g_pos)) <= REL_L2
    assert float(np.abs(np.asarray(g_pos)).max()) > 0


def _tilewin_inputs(n_patch, S, Mp=3, B=2, ts=16, F=32, K=6, seed=3):
    """Planes and (patch, sample, slot) member positions clustered within
    ~1.5 texels, about 20% invalid (as tests/test_tilewin.py builds them)."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, ts, ts)).astype(np.float32)
    centers = rng.uniform(-0.85, 0.85, (B, 3, Mp, n_patch, 1, S))
    jitter = rng.uniform(-1.5 / ts, 1.5 / ts, (B, 3, Mp, n_patch, 16, S))
    pos = np.clip(centers + jitter, -0.99, 0.99).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, Mp, n_patch, S)).astype(np.int32)
    valid = rng.random((B, Mp, n_patch, 16, S)) < 0.8
    return planes, pos, slot_idx, valid, F, K, ts


@pytest.mark.parametrize("n_patch,S,clamp", [(3, 5, False), (4, 6, True)])
def test_tilewin_gradients_match_jax_vjp(n_patch, S, clamp):
    planes, pos, slot_idx, valid, F, K, ts = _tilewin_inputs(n_patch, S)
    rng = np.random.default_rng(12)
    B, _, Mp = pos.shape[:3]
    cf = rng.normal(size=(B, F, n_patch * 16 * S)).astype(np.float32)
    cw = rng.normal(size=(B, Mp, n_patch, 16, S)).astype(np.float32)

    jt = jtw.pack_tilewin(jnp.asarray(planes), F, K)

    def jloss(feat, mask, p):
        tables = jtw.TilewinTables(feat, mask, jt.nb, F, K, ts)
        f, w = jtw.sample_tilewin_fused(tables, p, jnp.asarray(slot_idx),
                                        jnp.asarray(valid), clamp_mask=clamp)
        return (f.astype(jnp.float32) * cf).sum() + (w * cw).sum()

    g_feat, g_mask, g_pos = jax.grad(jloss, argnums=(0, 1, 2))(
        jt.feat, jt.mask, jnp.asarray(pos))

    tt = tilewin.pack_tilewin(torch.from_numpy(planes), F, K)
    feat = tt.feat.detach().requires_grad_(True)
    mask = tt.mask.detach().requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    f, w = tilewin.sample_tilewin(
        tt._replace(feat=feat, mask=mask), p, torch.from_numpy(slot_idx),
        torch.from_numpy(valid), clamp_mask=clamp)
    ((f * torch.from_numpy(cf)).sum() + (w * torch.from_numpy(cw)).sum()) \
        .backward()
    assert feat.grad.dtype == mask.grad.dtype == torch.bfloat16
    for name, got, ref in (("feat", feat.grad, g_feat),
                           ("mask", mask.grad, g_mask),
                           ("cand_pos", p.grad, g_pos)):
        err = rel_l2(got.float().numpy(), _f32(ref))
        assert err <= REL_L2, (name, err)
    assert float(np.abs(np.asarray(g_pos)).max()) > 0


@pytest.mark.parametrize("n_patch,S,clamp", [(3, 5, False), (4, 6, True)])
def test_tilewin_texel_gradients_match_jax_vjp(n_patch, S, clamp):
    """The texel path (what the card runs: one float32 texel gradient,
    rounded once to bf16, carried to the planes by pack_texels' backward)
    against the JAX VJP through its window tables. The window-table and
    texel-table gradients are of different tables, so both are taken back
    to the planes: through JAX's pack_tilewin and the port's pack_texels."""
    planes, pos, slot_idx, valid, F, K, ts = _tilewin_inputs(n_patch, S)
    rng = np.random.default_rng(12)
    B, _, Mp = pos.shape[:3]
    cf = rng.normal(size=(B, F, n_patch * 16 * S)).astype(np.float32)
    cw = rng.normal(size=(B, Mp, n_patch, 16, S)).astype(np.float32)

    def jloss(pl, p):
        tables = jtw.pack_tilewin(pl, F, K)
        f, w = jtw.sample_tilewin_fused(tables, p, jnp.asarray(slot_idx),
                                        jnp.asarray(valid), clamp_mask=clamp)
        return (f.astype(jnp.float32) * cf).sum() + (w * cw).sum()

    g_planes, g_pos = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(planes),
                                                      jnp.asarray(pos))

    tp = torch.from_numpy(planes).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    tables = tilewin.pack_tilewin_texels(tp, F, K)
    tables.texels.retain_grad()
    f, w = tilewin.sample_tilewin_fused(tables, p, torch.from_numpy(slot_idx),
                                        torch.from_numpy(valid),
                                        clamp_mask=clamp)
    ((f * torch.from_numpy(cf)).sum() + (w * torch.from_numpy(cw)).sum()) \
        .backward()
    assert tables.texels.grad.dtype == torch.bfloat16
    for name, got, ref in (("planes", tp.grad, g_planes),
                           ("cand_pos", p.grad, g_pos)):
        err = rel_l2(got.float().numpy(), _f32(ref))
        assert err <= REL_L2, (name, err)
    assert float(np.abs(np.asarray(g_planes)).max()) > 0


@pytest.mark.parametrize("mode", ["dot", "vpu", "bdiag"])
def test_kernel3_plain_matches_jax_interpret(monkeypatch, mode):
    """U = 128 units (one TB block), Mp = 2 slots, m = 16: the port's
    combine in ``mode`` on the texel table against JAX's interpret-mode
    kernel on the window rows of the same plan."""
    planes, pos, slot_idx, valid, F, K, ts = _tilewin_inputs(
        1, jtk.TB, Mp=2, seed=5)
    B, _, Mp = pos.shape[:3]
    U = jtk.TB
    targs = (torch.from_numpy(pos), torch.from_numpy(slot_idx),
             torch.from_numpy(valid))
    tx = tilewin.pack_tilewin_texels(torch.from_numpy(planes), F, K)
    tplan = tilewin.texel_plan(tx, *targs)
    monkeypatch.setenv("ENARF_TILEWIN_KERNEL", mode)
    f, w = tilewin.tilewin_combine(tx.texels, tplan.bases, tplan.bones,
                                   tplan.xt, tplan.xs, tplan.valid, F, U,
                                   False)

    tt = tilewin.pack_tilewin(torch.from_numpy(planes), F, K)
    plan = tilewin._fused_plan(tt, *targs)
    jt = jtw.pack_tilewin(jnp.asarray(planes), F, K)
    win = jnp.take(jt.feat, jnp.asarray(plan.frows.numpy()).reshape(-1),
                   axis=0).reshape(B, 3, Mp, U, 16, 128)
    mwin = jnp.take(jt.mask, jnp.asarray(plan.mrows.numpy()).reshape(-1),
                    axis=0).reshape(B, 3, Mp, U, 64)
    f_ref, w_ref = jtk.tilewin_combine(
        win, mwin, jnp.asarray(plan.xt.numpy()), jnp.asarray(plan.xs.numpy()),
        jnp.asarray(plan.valid.numpy()), F, clamp_mask=False, interpret=True)
    # the port's (B, F, (patch*16 + j)*S + s) with one patch of S = U units
    # is JAX's (B, U, 16, F); cand_w (B, Mp, 1, 16, U) is JAX's (B, Mp, 16, U)
    def to_jax_layout(feature):
        return feature.reshape(B, F, 16, U).permute(0, 3, 2, 1).numpy()

    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(to_jax_layout(f), f_ref, rtol=K3_RTOL,
                               atol=K3_ATOL)
    np.testing.assert_allclose(w.reshape(B, Mp, 16, U).numpy(),
                               np.asarray(w_ref), rtol=K3_RTOL, atol=K3_ATOL)
    assert float(np.abs(f_ref).max()) > 0.1
    # the other rounding of the t-weights lies far outside the bound, so the
    # comparison above tells "vpu" (float32) from "dot"/"bdiag" (bf16)
    f_other, _ = tilewin.tilewin_combine_plain(
        tt.feat, tt.mask, plan.frows, plan.mrows, plan.xt, plan.xs,
        plan.valid, F, U, False, round_t=mode == "vpu")
    assert float(np.abs(to_jax_layout(f_other) - f_ref).max()) > 100 * K3_ATOL
