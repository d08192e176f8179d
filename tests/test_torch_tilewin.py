"""The port's patch-window sampler (ops/tilewin.py, ops/tilewin_kernel.py)
against the JAX one, on the same numpy inputs.

The card reads the texel table of ``pack_texels`` (``pack_tilewin_texels``,
``texel_plan``, ``tilewin_combine_texels_plain``); the JAX package's window
tables (``pack_tilewin``, ``_fused_plan``, ``tilewin_combine_plain``) stay
as the reference, and the texel path is held to both.

Tolerances:
* packing, texel coordinates, window bases, slot selection and the plan:
  exact (the same f32 arithmetic, bf16 rounding to nearest even on both
  sides, integer argmax with ties to the lowest index);
* the texel twin against the window twin: 1e-6 absolute in float32 (the
  same bf16 values gathered from either layout, summed in the same order;
  they agree bit for bit here);
* the combine against the JAX package: the bounds of
  tests/test_tilewin.py (feature 3e-2, cand_w 2e-2), because the JAX XLA
  path rounds the bilinear weights to bf16 and the Pallas kernel its
  t-weights, where the port keeps them in f32;
* the combine against a float64 numpy evaluation of the TPU kernel's hat
  formula on the same bf16 rows: 1e-5 (only the order of f32 sums
  differs).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.ops import tilewin as jtw
from enarf_gan_tpu_torch.ops import tilewin as ttw
from enarf_gan_tpu_torch.ops import tilewin_kernel as ttk
from enarf_gan_tpu_torch.ops import unirow

TS, F, K = 16, 32, 6
B, MP = 2, 3


def planes_np(ts=TS, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, (F + K) * 3, ts, ts)).astype(np.float32)


def tables_pair(planes):
    feat, mask = jax.jit(lambda p: tuple(jtw.pack_tilewin(p, F, K)[:2]))(
        jnp.asarray(planes))
    ts = planes.shape[-1]
    jt = jtw.TilewinTables(feat, mask, jtw._num_bases(ts), F, K, ts)
    tt = ttw.pack_tilewin(torch.from_numpy(planes), F, K)
    return jt, tt


def clustered_inputs(n_patch, m, s, seed=1, ts=TS, p_valid=0.8):
    """Positions clustered per (patch, sample, slot) within ~1.5 texels
    (tests/test_tilewin.py:132-140), random slot bones, ~20% invalid."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.85, 0.85, (B, 3, MP, n_patch, 1, s))
    jitter = rng.uniform(-1.5 / ts, 1.5 / ts, (B, 3, MP, n_patch, m, s))
    pos = np.clip(centers + jitter, -0.99, 0.99).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, MP, n_patch, s)).astype(np.int32)
    valid = rng.random((B, MP, n_patch, m, s)) < p_valid
    return pos, slot_idx, valid


def as_torch(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def bf16_to_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("ts", [16, 32])
def test_pack_tilewin_is_bit_equal_to_jax(ts):
    jt, tt = tables_pair(planes_np(ts))
    assert (tt.nb, tt.feat_dim, tt.num_bone, tt.size) == \
        (jt.nb, jt.feat_dim, jt.num_bone, jt.size)
    assert tt.feat.dtype == tt.mask.dtype == torch.bfloat16
    assert tuple(tt.feat.shape) == jt.feat.shape
    assert tuple(tt.mask.shape) == jt.mask.shape
    np.testing.assert_array_equal(tt.feat.float().numpy(),
                                  bf16_to_f32(jt.feat))
    np.testing.assert_array_equal(tt.mask.float().numpy(),
                                  bf16_to_f32(jt.mask))


def test_member_texels_and_group_bases_match_jax():
    pos, _, valid = clustered_inputs(4, 16, 5)
    cp = pos.reshape(B, 3, MP, -1)
    want = jtw.member_texels(jnp.asarray(cp), TS)
    got = ttw.member_texels(torch.from_numpy(cp), TS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    py, px = (x.reshape(B, 3, MP, 4, 16, 5) for x in got[:2])
    vm = np.broadcast_to(valid[:, None], py.shape)
    nb = jtw._num_bases(TS)
    want = jtw.group_bases(jnp.asarray(py.numpy()), jnp.asarray(px.numpy()),
                           jnp.asarray(vm), nb)
    got = ttw.group_bases(py, px, torch.from_numpy(vm.copy()), nb)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sep_weights_match_jax():
    rng = np.random.default_rng(3)
    d = rng.integers(-2, 9, (50,)).astype(np.int32)
    f = rng.random(50).astype(np.float32)
    np.testing.assert_array_equal(
        ttw._sep_weights(*as_torch(d, f), ttw.WIN).numpy(),
        np.asarray(jtw._sep_weights(jnp.asarray(d), jnp.asarray(f), jtw.WIN)))


@pytest.mark.parametrize("rescue_w", [jtw.RESCUE_W, 0.0])
def test_select_patch_slots_matches_jax(monkeypatch, rescue_w):
    """Sparse canonical positions (more valid bones than slots), so the
    rescue term changes the choice; with RESCUE_W = 0 as well."""
    monkeypatch.setattr(jtw, "RESCUE_W", rescue_w)
    monkeypatch.setattr(ttw, "RESCUE_W", rescue_w)
    n_patch, m, S, Mp = 6, 16, 5, 2
    rng = np.random.default_rng(4)
    canonical = rng.uniform(-1.5, 1.5, (B, K, 3, n_patch * m * S)) \
        .astype(np.float32)
    validity = (np.abs(canonical) < 1).all(axis=2)
    want = jtw.select_patch_slots(jnp.asarray(canonical),
                                  jnp.asarray(validity), n_patch, m, S, Mp)
    got = ttw.select_patch_slots(*as_torch(canonical, validity), n_patch, m,
                                 S, Mp)
    assert got[0].dtype == torch.int32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rescue_weight_changes_the_slots(monkeypatch):
    n_patch, m, S, Mp = 6, 16, 5, 2
    rng = np.random.default_rng(4)
    canonical = torch.from_numpy(rng.uniform(
        -1.5, 1.5, (B, K, 3, n_patch * m * S)).astype(np.float32))
    validity = (canonical.abs() < 1).all(dim=2)
    with_rescue = ttw.select_patch_slots(canonical, validity, n_patch, m, S,
                                         Mp)
    monkeypatch.setattr(ttw, "RESCUE_W", 0.0)
    without = ttw.select_patch_slots(canonical, validity, n_patch, m, S, Mp)
    assert (with_rescue[0] != without[0]).any()
    # the rescue term covers at least as many valid members
    assert with_rescue[2].sum() >= without[2].sum()


@pytest.mark.parametrize("m", [4, 16])
def test_fused_plan_matches_jax(m):
    jt, tt = tables_pair(planes_np())
    pos, slot_idx, valid = clustered_inputs(4, m, 5)
    g, gm, xt, xs, vf = jtw._fused_plan(jt, jnp.asarray(pos),
                                        jnp.asarray(slot_idx),
                                        jnp.asarray(valid))
    plan = ttw._fused_plan(tt, *as_torch(pos, slot_idx, valid))
    np.testing.assert_array_equal(plan.xt.numpy(), np.asarray(xt))
    np.testing.assert_array_equal(plan.xs.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(plan.valid.numpy(), np.asarray(vf))
    # the rows the port's plan names are the rows JAX gathered
    rows = tt.feat[plan.frows.long()].float().numpy()
    np.testing.assert_array_equal(rows, bf16_to_f32(g))
    mrows = tt.mask[plan.mrows.long()].float().numpy()
    np.testing.assert_array_equal(mrows, bf16_to_f32(gm))


def combine_ref(g, gm, xt, xs, valid, S, clamp_mask):
    """float64 numpy evaluation of the TPU kernel's hat formula on gathered
    bf16 rows: g (B,3,Mp,U,16,128), gm (B,3,Mp,U,64)."""
    Bq, _, Mp, U = gm.shape[:4]
    m = xt.shape[3]
    win = g.astype(np.float64).reshape(Bq, 3, Mp, U, 64, F)
    it = np.arange(8)
    ht = np.maximum(0, 1 - np.abs(it - xt.astype(np.float64)[..., None]))
    hs = np.maximum(0, 1 - np.abs(it - xs.astype(np.float64)[..., None]))
    w64 = (ht[..., :, None] * hs[..., None, :]).reshape(Bq, 3, Mp, m, U, 64)
    feat = np.einsum("bpgmut,bpgutf->bgmuf", w64, win)
    logit = np.einsum("bpgmut,bpgut->bpgmu", w64, gm.astype(np.float64)) \
        * valid[:, None]
    if clamp_mask:
        logit = np.clip(logit, -2, 5)
    cw = (1 / (1 + np.exp(-logit))).prod(axis=1)            # (B,Mp,m,U)
    out = np.einsum("bgmuf,bgmu->bmuf", feat, cw * valid)
    n_patch = U // S
    feature = out.reshape(Bq, m, n_patch, S, F).transpose(0, 4, 2, 1, 3) \
        .reshape(Bq, F, -1)
    cand_w = cw.reshape(Bq, Mp, m, n_patch, S).transpose(0, 1, 3, 2, 4)
    return feature, cand_w


@pytest.mark.parametrize("m,n_patch,s,clamp", [(16, 3, 5, False),
                                              (16, 16, 5, True),
                                              (4, 3, 5, False),
                                              (4, 16, 5, True)])
def test_plain_combine_matches_jax_and_f64_reference(m, n_patch, s, clamp):
    jt, tt = tables_pair(planes_np())
    pos, slot_idx, valid = clustered_inputs(n_patch, m, s)
    jargs = (jnp.asarray(pos), jnp.asarray(slot_idx), jnp.asarray(valid))
    targs = as_torch(pos, slot_idx, valid)
    f_x, w_x, stats = jax.jit(lambda *a: jtw.sample_tilewin(
        jt, *a, clamp_mask=clamp, with_stats=True))(*jargs)
    f_t, w_t, t_stats = ttw.sample_tilewin(tt, *targs, clamp_mask=clamp,
                                           with_stats=True)
    assert f_t.shape == f_x.shape and w_t.shape == w_x.shape
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_x), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_x), rtol=2e-2,
                               atol=2e-2)
    assert float(t_stats["clamped"]) == float(stats["clamped"]) == 0.0

    g, gm, xt, xs, vf = (np.asarray(x) for x in jax.jit(
        lambda *a: jtw._fused_plan(jt, *a))(*jargs))
    f_ref, w_ref = combine_ref(bf16_to_f32(g), bf16_to_f32(gm), xt, xs, vf,
                               s, clamp)
    np.testing.assert_allclose(f_t.numpy(), f_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), w_ref, rtol=0, atol=1e-5)
    # on CPU tensors the wrapper is the plain twin, on the texel table
    f_f, w_f = ttw.sample_tilewin_fused(texel_tables(planes_np()), *targs,
                                        clamp_mask=clamp)
    assert torch.equal(f_f, f_t) and torch.equal(w_f, w_t)


@pytest.mark.parametrize("n_patch,s", [(3, 5), (16, 5)])
def test_plain_combine_matches_jax_pallas_kernel(n_patch, s):
    """The JAX fused path runs the Pallas hat kernel (interpret mode off the
    TPU), at both shapes of tests/test_tilewin.py:116-121."""
    jt, tt = tables_pair(planes_np(seed=9))
    pos, slot_idx, valid = clustered_inputs(n_patch, 16, s, seed=10)
    f_k, w_k = jtw.sample_tilewin_fused(jt, jnp.asarray(pos),
                                        jnp.asarray(slot_idx),
                                        jnp.asarray(valid))
    f_t, w_t = ttw.sample_tilewin(tt, *as_torch(pos, slot_idx, valid))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_k), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_k), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("m", [4, 16])
def test_invalid_members_weigh_sigmoid_zero_cubed(m):
    """An invalid member's mask logit is 0 on every plane, so its cand_w is
    sigma(0)^3 = 0.125 (as on the TPU and in the XLA path), and it adds no
    feature."""
    jt, tt = tables_pair(planes_np())
    pos, slot_idx, valid = clustered_inputs(3, m, 5, p_valid=0.5)
    valid[:, :, 0] = False                     # a whole patch invalid
    f_t, w_t = ttw.sample_tilewin(tt, *as_torch(pos, slot_idx, valid))
    w_x = jax.jit(lambda *a: jtw.sample_tilewin(jt, *a)[1])(
        jnp.asarray(pos), jnp.asarray(slot_idx), jnp.asarray(valid))
    inv = ~valid
    np.testing.assert_array_equal(w_t.numpy()[inv], 0.125)
    np.testing.assert_array_equal(np.asarray(w_x)[inv], 0.125)
    feat = f_t.numpy().reshape(B, F, 3, m, 5)
    assert (feat[:, :, 0] == 0).all()
    assert (np.abs(feat[:, :, 1:]) > 0).any()


def test_clamped_share_matches_jax_when_members_spread():
    """Members spread past a window: the stats report the same clamped
    share as the JAX sampler."""
    jt, tt = tables_pair(planes_np())
    rng = np.random.default_rng(5)
    n_patch, m, s = 3, 16, 5
    pos = rng.uniform(-0.9, 0.9, (B, 3, MP, n_patch, m, s)).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, MP, n_patch, s)).astype(np.int32)
    valid = rng.random((B, MP, n_patch, m, s)) < 0.8
    stats = jtw.sample_tilewin(jt, jnp.asarray(pos), jnp.asarray(slot_idx),
                               jnp.asarray(valid), with_stats=True)[2]
    t_stats = ttw.sample_tilewin(tt, *as_torch(pos, slot_idx, valid),
                                 with_stats=True)[2]
    assert float(stats["clamped"]) > 0.1
    np.testing.assert_allclose(float(t_stats["clamped"]),
                               float(stats["clamped"]), rtol=1e-6)


def test_combine_wrapper_checks_its_inputs():
    tx = ttw.pack_tilewin_texels(torch.from_numpy(planes_np()), F, K)
    pos, slot_idx, valid = clustered_inputs(3, 16, 5)
    plan = ttw.texel_plan(tx, *as_torch(pos, slot_idx, valid))
    args = [tx.texels, plan.bases, plan.bones, plan.xt, plan.xs, plan.valid]
    with pytest.raises(ValueError, match="texel table"):
        ttk.tilewin_combine(tx.texels.float(), *args[1:], F, 5, False)
    with pytest.raises(ValueError, match="bones"):
        ttk.tilewin_combine(*args[:2], plan.bones.long(), *args[3:], F, 5,
                            False)
    with pytest.raises(ValueError, match="does not divide"):
        ttk.tilewin_combine(*args, F, 4, False)


# --------------------------------------------- the texel table (what the card reads)

def spread_inputs(n_patch, m, s, seed=5):
    """Members spread over the plane, past their group's window: more than
    5% of the valid fetches clamped to the window's edge."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.9, 0.9, (B, 3, MP, n_patch, m, s)).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, MP, n_patch, s)).astype(np.int32)
    valid = rng.random((B, MP, n_patch, m, s)) < 0.8
    return pos, slot_idx, valid


def texel_tables(planes):
    return ttw.pack_tilewin_texels(torch.from_numpy(planes), F, K)


def test_pack_tilewin_texels_is_pack_texels():
    planes = planes_np()
    tx = texel_tables(planes)
    assert (tx.feat_dim, tx.num_bone, tx.size) == (F, K, TS)
    assert ttk.num_bases(tx.size) == jtw._num_bases(TS)
    assert torch.equal(tx.texels, unirow.pack_texels(torch.from_numpy(planes),
                                                     F, K))
    with pytest.raises(ValueError, match="at least 8"):
        ttw.pack_tilewin_texels(torch.zeros((1, (F + K) * 3, 6, 6)), F, K)


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("layout", ["clustered", "spread"])
def test_texel_twin_equals_window_twin(layout, m, clamp):
    """The same plan on both layouts: the texel plan's bases and bones name
    the window rows of the window plan, the coordinates are the same, and
    the texel twin gives the window twin's numbers (also with the
    t-weights rounded to bf16, as "dot" and "bdiag" round them), including
    a plan where more than 5% of the fetches are clamped."""
    planes = planes_np()
    tt = ttw.pack_tilewin(torch.from_numpy(planes), F, K)
    tx = texel_tables(planes)
    make = clustered_inputs if layout == "clustered" else spread_inputs
    S = 5
    targs = as_torch(*make(4, m, S))
    pw = ttw._fused_plan(tt, *targs, with_stats=True)
    pt = ttw.texel_plan(tx, *targs, with_stats=True)
    for a, b in ((pt.xt, pw.xt), (pt.xs, pw.xs), (pt.valid, pw.valid),
                 (pt.clamped, pw.clamped)):
        assert torch.equal(a, b)
    assert pt.bases.dtype == pt.bones.dtype == torch.int32
    frows, mrows = ttk.window_rows(pt.bases, pt.bones, TS + 2, TS + 2, tt.nb,
                                   K)
    assert torch.equal(frows, pw.frows) and torch.equal(mrows, pw.mrows)
    if layout == "spread":
        assert float(pt.clamped) > 0.05
    for round_t in (False, True):
        want = ttk.tilewin_combine_plain(tt.feat, tt.mask, pw.frows, pw.mrows,
                                         pw.xt, pw.xs, pw.valid, F, S, clamp,
                                         round_t=round_t)
        got = ttk.tilewin_combine_texels_plain(
            tx.texels, pt.bases, pt.bones, pt.xt, pt.xs, pt.valid, F, S,
            clamp, round_t=round_t)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_windows_from_texels_are_pack_tilewins_rows():
    """Kernel 3's window rows, built from the texel table, are
    ``pack_tilewin``'s (bone k < K's mask rows)."""
    planes = planes_np(ts=32)
    tt = ttw.pack_tilewin(torch.from_numpy(planes), F, K)
    tx = texel_tables(planes)
    nb = ttk.num_bases(tx.size)
    feat, mask = ttk.windows_from_texels(tx.texels, nb)
    assert feat.dtype == mask.dtype == torch.bfloat16
    assert torch.equal(feat, tt.feat)
    nb2 = 3 * nb * nb
    assert torch.equal(mask.reshape(B, 32, nb2, 64)[:, :K].reshape(-1, 64),
                       tt.mask)


@pytest.mark.parametrize("layout,m,clamp", [("clustered", 16, False),
                                            ("clustered", 4, True),
                                            ("spread", 16, True),
                                            ("spread", 4, False)])
def test_texel_sampler_matches_jax(layout, m, clamp):
    """The texel path against the JAX package's XLA path at the window
    path's bounds, with the same clamped share; a member outside its
    group's window reads its clamped texel, as JAX's window rows make it."""
    planes = planes_np()
    jt, _ = tables_pair(planes)
    tx = texel_tables(planes)
    make = clustered_inputs if layout == "clustered" else spread_inputs
    pos, slot_idx, valid = make(5, m, 5)
    f_x, w_x, stats = jax.jit(lambda *a: jtw.sample_tilewin(
        jt, *a, clamp_mask=clamp, with_stats=True))(
        jnp.asarray(pos), jnp.asarray(slot_idx), jnp.asarray(valid))
    targs = as_torch(pos, slot_idx, valid)
    f_t, w_t, t_stats = ttw.sample_tilewin(tx, *targs, clamp_mask=clamp,
                                           with_stats=True)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_x), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_x), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(float(t_stats["clamped"]),
                               float(stats["clamped"]), rtol=1e-6)
    if layout == "spread":
        assert float(stats["clamped"]) > 0.05
    # on CPU tensors the wrapper is the texel twin
    f_f, w_f = ttw.sample_tilewin_fused(tx, *targs, clamp_mask=clamp)
    assert torch.equal(f_f, f_t) and torch.equal(w_f, w_t)


def test_texel_sampler_matches_jax_pallas_kernel():
    """The JAX fused path runs the Pallas hat kernel (interpret mode off the
    TPU), at tests/test_tilewin.py:116's shape."""
    planes = planes_np(seed=9)
    jt, _ = tables_pair(planes)
    pos, slot_idx, valid = clustered_inputs(3, 16, 5, seed=10)
    f_k, w_k = jtw.sample_tilewin_fused(jt, jnp.asarray(pos),
                                        jnp.asarray(slot_idx),
                                        jnp.asarray(valid))
    f_t, w_t = ttw.sample_tilewin_fused(texel_tables(planes),
                                        *as_torch(pos, slot_idx, valid))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_k), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_k), rtol=2e-2,
                               atol=2e-2)


def _read_rows_cols(plan, ts):
    """The largest texel row and column any member of the plan reads (the
    second row and column of its quad), over the whole plan."""
    i, _ = ttk.texel_cells(plan.xt)
    k, _ = ttk.texel_cells(plan.xs)
    b = plan.bases.long()[:, :, :, None, :]
    Wp = ts + 2
    bt, bs = b // Wp % Wp, b % Wp
    return int((bt + i + 1).max()), int((bs + k + 1).max())


@pytest.mark.parametrize("ts", [16, 32])
def test_plan_reads_no_texel_past_the_table(ts):
    """Random plans with invalid members (also off the plane), groups with
    no valid member, and clamped members, many at the planes' far edge: no
    member reads past row or column H+1, the table's last; the members at
    the edge reach it."""
    rng = np.random.default_rng(ts)
    n_patch, m, S = 6, 16, 4
    centers = rng.uniform(-0.9, 1.0, (B, 3, MP, n_patch, 1, S))
    centers[:, :, :, :2] = 0.97                   # at the far edge
    jitter = rng.uniform(-6 / ts, 6 / ts, (B, 3, MP, n_patch, m, S))
    pos = (centers + jitter).astype(np.float32)
    pos[:, :, :, 3] = rng.uniform(-1.6, 1.6, pos[:, :, :, 3].shape)
    slot_idx = rng.integers(0, K, (B, MP, n_patch, S)).astype(np.int32)
    valid = (np.abs(pos) < 1).all(axis=1) & (rng.random(pos[:, 0].shape) < 0.7)
    valid[:, :, 4] = False                        # groups with no valid member
    tx = ttw.pack_tilewin_texels(torch.zeros((B, (F + K) * 3, ts, ts)), F, K)
    plan = ttw.texel_plan(tx, *as_torch(pos, slot_idx, valid),
                          with_stats=True)
    assert float(plan.clamped) > 0.05
    assert ((~valid) & (np.abs(pos) > 1).any(axis=1)).any()
    assert _read_rows_cols(plan, ts) == (ts + 1, ts + 1)


@pytest.mark.parametrize("ts", [8, 16, 33, 256])
def test_no_fraction_rounds_a_member_past_the_table(ts):
    """The plan's xt = (py - bt) + fy is an f32 sum: it could round up to
    the next texel only where the fraction fy has bits below the sum's
    precision, i.e. where the member's top texel py is small. Over every
    window base the plan can pick and members at, and one to five ulps
    below, every texel boundary of the plane and past it (valid or not),
    no member's second row passes H+1."""
    t = np.arange(-3, ts + 4, dtype=np.float32)
    ys = [t]
    for _ in range(5):
        ys.append(np.nextafter(ys[-1], np.float32(-np.inf)))
    y = np.unique(np.concatenate(ys))
    c = torch.from_numpy(((y + np.float32(0.5)) / np.float32(ts / 2)
                          - np.float32(1)).astype(np.float32))
    py, _, fy, _ = ttw.member_texels(torch.stack([c] * 3)[None, :, None], ts)
    bt = torch.arange(0, 2 * (ttk.num_bases(ts) - 1) + 1, 2)
    xt = (py[..., None] - bt).clamp(0, ttk.WIN - 2).float() + fy[..., None]
    i, _ = ttk.texel_cells(xt)
    assert int((bt + i + 1).max()) == ts + 1
