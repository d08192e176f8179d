"""The probes of ``enarf_gan_tpu_torch/tools`` on the CPU: each family's plain
twins against the JAX expressions and interpret-mode Pallas bodies of the
``tools/`` probes they port, the stage twins against numpy statements of
their doctored dataflow, and each module's CLI with ``--device cpu``.

Tolerances:
* gathers (A), the tile gather (B2), transposes and copies: bit-equal;
* B1: the one-hot weights rounded to bf16 as the TPU kernel rounds them,
  then rtol 1e-6 (float32 sums of two exact products);
* B3: rtol 1e-3 (K-long float32 sums in another order, K up to 256);
* C: the full twins against JAX's interpret-mode kernels rtol 1e-5, atol
  1e-6 (as tests/test_torch_backward.py); the doctored twins against numpy
  in float64 rtol 1e-5, atol 1e-5;
* D: rtol 1e-5, atol 1e-5 (float32 sums in another order; sigmoid).
"""
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from enarf_gan_tpu.ops import tilewin as jtw
from enarf_gan_tpu.ops import tilewin_kernel as jtk
from tools.bench_pallas_prims import matmul_chain_kernel, onehot_gather_kernel

from enarf_gan_tpu_torch.ops import tilewin
from enarf_gan_tpu_torch.ops.tilewin_kernel import (HAT_STAGES,
                                                    tilewin_combine_plain)
from enarf_gan_tpu_torch.tools import ablate, constructs, gather, mma

T = torch.from_numpy


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ------------------------------------------------------------------ A

@pytest.mark.parametrize("rows,width,dtype", [
    (8192, 128, np.float32),       # bench_unitable.py's (8192, 128) f32
    (300, 128, "bf16"),            # a bf16 feature row
    (500, 66, np.float32)])        # the 66-lane f32 unitable row
def test_row_gather_plain_matches_jnp_take(rows, width, dtype):
    """bench_unitable.py:66 checks kern_take against jnp.take(axis=0)."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(rows, width)).astype(np.float32)
    idx = rng.integers(0, rows, 1024).astype(np.int32)
    if dtype == "bf16":
        jtab = jnp.asarray(tab).astype(jnp.bfloat16)
        ttab = T(tab).to(torch.bfloat16)
    else:
        jtab, ttab = jnp.asarray(tab), T(tab)
    ref = np.asarray(jnp.take(jtab, jnp.asarray(idx), axis=0)
                     .astype(jnp.float32))
    got = gather.row_gather_plain(ttab, T(idx)).float().numpy()
    np.testing.assert_array_equal(got, ref)
    # the wrapper on a CPU tensor is the twin, and counts no launch
    before = dict(gather.KERNEL.launches_by)
    np.testing.assert_array_equal(
        gather.row_gather(ttab, T(idx), serial_rows=7).float().numpy(), ref)
    assert gather.KERNEL.launches_by == before


@pytest.mark.parametrize("case", ["table", "take2_a", "take2_c", "take2_d",
                                  "gather_lane"])
def test_lane_gather_plain_matches_take_along_axis(case):
    """bench_dyngather2.py:186 and bench_pallas_take2.py:58-89 check their
    kernels against np.take_along_axis."""
    rng = np.random.default_rng(1)
    if case == "table":                  # dg_kernel: (512, 128) f32
        tab = rng.normal(size=(512, 128)).astype(np.float32)
        idx = rng.integers(0, 512, (512, 128)).astype(np.int32)
        ref, mode = np.take_along_axis(tab, idx, 0), "table"
    elif case == "take2_a":              # rows broadcast over the lanes
        tab = _bf16(rng.normal(size=(256, 128)))
        rows = rng.integers(0, 256, 256)
        idx = np.broadcast_to(rows[:, None], (256, 128)).astype(np.int32)
        ref, mode = np.take_along_axis(tab, idx, 0), "table"
        np.testing.assert_array_equal(ref, tab[rows])
    elif case == "take2_c":              # sublane within (G, 8, 128) tiles
        tiles = _bf16(rng.normal(size=(32, 8, 128)))
        sub = rng.integers(0, 8, (32, 8, 128)).astype(np.int32)
        ref = np.take_along_axis(tiles, sub, axis=1).reshape(256, 128)
        tab, idx, mode = tiles.reshape(256, 128), sub.reshape(256, 128), "tile"
    elif case == "take2_d":              # lane gather
        tab = _bf16(rng.normal(size=(256, 128)))
        idx = rng.integers(0, 128, (256, 128)).astype(np.int32)
        ref, mode = np.take_along_axis(tab, idx, axis=-1), "lane"
    else:                                # probe_mosaic_caps.py gather_lane
        tab = rng.normal(size=(128, 256)).astype(np.float32)
        idx = rng.integers(0, 128, (8, 256)).astype(np.int32)
        ref, mode = np.take_along_axis(tab, idx, 0), "table"
    ttab = T(np.array(tab))
    if case.startswith("take2"):
        ttab = ttab.to(torch.bfloat16)
    tidx = T(np.array(idx))
    got = gather.lane_gather_plain(ttab, tidx, mode, 8)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    lib = gather.lane_gather_library(ttab, tidx.long(), mode, 8)
    np.testing.assert_array_equal(lib.float().numpy(), ref)
    np.testing.assert_array_equal(
        gather.lane_gather(ttab, tidx, mode, 8).float().numpy(), ref)


def test_ring_gather_plain_matches_numpy():
    """dma_kernel's per-block sum of its (16, 128) bf16 rows."""
    rng = np.random.default_rng(2)
    tab = _bf16(rng.normal(size=(97, 16, 128)))
    idx = rng.integers(0, 97, 64 * 5).astype(np.int32)
    ref = tab[idx].reshape(5, -1).astype(np.float64).sum(1)
    got = gather.ring_gather(T(tab).to(torch.bfloat16), T(idx), 64, Q=8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * 64 * 2048)


@pytest.mark.parametrize("shape", [(37, 64, 16), (5, 16, 128)])
def test_transpose_plain_matches_swapaxes(shape):
    """relay_kernel's jnp.swapaxes and probe_mosaic_coord_ops.py's swapT
    reference x.T."""
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    ref = np.asarray(jnp.swapaxes(jnp.asarray(x), 1, 2))
    np.testing.assert_array_equal(ref[0], x[0].T)
    np.testing.assert_array_equal(gather.transpose(T(x)).numpy(), ref)


def test_gather_wrappers_refuse_what_the_kernels_do_not_take():
    tab = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="idx"):
        gather.row_gather(tab, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="mode"):
        gather.lane_gather(tab, torch.zeros((2, 4), dtype=torch.int32), "row")
    with pytest.raises(ValueError, match="tile"):
        gather.lane_gather(tab, torch.zeros((3, 4), dtype=torch.int32), "tile")
    with pytest.raises(ValueError, match="bfloat16"):
        gather.ring_gather(tab, torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="divide"):
        gather.ring_gather(tab.to(torch.bfloat16),
                           torch.zeros(5, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="48 KB"):
        gather.transpose(torch.zeros((1, 128, 128)))


# ------------------------------------------------------------------ B

def _pallas_onehot(loc, w, table, G, WIN, dynamic):
    """tools/bench_pallas_prims.py::onehot_gather_kernel in interpret mode."""
    n_tiles = loc.shape[0] // G
    kern = functools.partial(onehot_gather_kernel, G=G, WIN=WIN, LANES=128,
                             dynamic_base=dynamic, n_rows=table.shape[0])
    table_spec = pl.BlockSpec(memory_space=pl.ANY) if dynamic else \
        pl.BlockSpec((WIN, 128), lambda i: (0, 0))
    f = pl.pallas_call(
        kern, grid=(n_tiles,),
        in_specs=[pl.BlockSpec((1, G, 2), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, G, 2), lambda i: (i, 0, 0)), table_spec],
        out_specs=pl.BlockSpec((1, G, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles, G, 128), jnp.float32),
        interpret=True)
    out = f(jnp.asarray(loc.reshape(n_tiles, G, 2)),
            jnp.asarray(w.reshape(n_tiles, G, 2)),
            jnp.asarray(table).astype(jnp.bfloat16))
    return np.asarray(out).reshape(-1, 128)


@pytest.mark.parametrize("mode,G,WIN", [("static", 64, 128),
                                        ("static", 128, 192),
                                        ("dynamic", 64, 128)])
def test_onehot_gather_plain_matches_pallas_interpret(mode, G, WIN):
    g = torch.Generator().manual_seed(4)
    loc, w, tab = mma.b1_inputs(4 * G, G, WIN, mode, "cpu", g)
    if mode == "dynamic":                # a small table keeps interpret quick
        tab = tab[:2048].contiguous()
        loc = (loc % 1024).to(torch.int32)
        loc[::G, 0] = torch.arange(4, dtype=torch.int32) * 512
    loc[1, 1] = loc[1, 0]                # two rows that coincide
    ref = _pallas_onehot(loc.numpy(), w.numpy(), tab.float().numpy(), G, WIN,
                         mode == "dynamic")
    for fn in (mma.onehot_gather_plain, mma.onehot_gather, mma.direct_gather):
        got = fn(loc, w, tab, G, WIN, mode).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    # the TPU kernel's rounding of the weights matters at this tolerance
    unrounded = (tab.float()[loc.long()] * w[..., None]).sum(1).numpy()
    if mode == "static":
        assert np.abs(unrounded - ref).max() > 1e-4


def test_tile_gather_plain_matches_numpy_onehot():
    """bench_dyngather2.py:135 kernel2: one-hot(loc) @ tab[t*512 : +512]."""
    rng = np.random.default_rng(5)
    tab = _bf16(rng.normal(size=(2048, 128)))
    tile = rng.integers(0, 4, 3).astype(np.int32)
    loc = rng.integers(0, 512, 3 * 512).astype(np.int32)
    ref = np.concatenate([np.eye(512)[loc[b * 512:(b + 1) * 512]]
                          @ tab[t * 512:(t + 1) * 512]
                          for b, t in enumerate(tile)])
    got = mma.tile_gather(T(tile), T(loc), T(tab).to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("n,M,K", [(3, 64, 256), (2, 128, 64)])
def test_gemm_plain_matches_pallas_chain_interpret(n, M, K):
    rng = np.random.default_rng(6)
    a = jnp.asarray(rng.random((n, M, K), dtype=np.float32)).astype(jnp.bfloat16)
    b = jnp.asarray(rng.random((K, 128), dtype=np.float32)).astype(jnp.bfloat16)
    f = pl.pallas_call(
        matmul_chain_kernel, grid=(n,),
        in_specs=[pl.BlockSpec((1, M, K), lambda i: (i, 0, 0)),
                  pl.BlockSpec((K, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, M, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, M, 128), jnp.float32),
        interpret=True)
    ref = np.asarray(f(a, b))
    ta = T(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    tb = T(np.array(b.astype(jnp.float32))).to(torch.bfloat16)
    np.testing.assert_allclose(mma.gemm(ta, tb).numpy(), ref, rtol=1e-3)


@pytest.mark.parametrize("batch,M,K", [(4, 128, 64), (8, 32, 16)])
def test_batched_gemm_plain_matches_dot_general(batch, M, K):
    """dot_batched, dot_kshape and bdiag_dot: a batched dot_general with
    float32 accumulation."""
    rng = np.random.default_rng(7)
    a = jnp.asarray(rng.normal(size=(batch, M, K)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(batch, K, 128)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    ref = np.asarray(jax.lax.dot_general(
        a, b, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32))
    got = mma.gemm(T(np.array(a.astype(jnp.float32))).to(torch.bfloat16),
                   T(np.array(b.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_mma_wrappers_refuse_what_the_kernels_do_not_take():
    g = torch.Generator().manual_seed(0)
    loc, w, tab = mma.b1_inputs(128, 64, 128, "static", "cpu", g)
    with pytest.raises(ValueError, match="mode"):
        mma.onehot_gather(loc, w, tab, 64, 128, "sliding")
    with pytest.raises(ValueError, match="divide"):
        mma.onehot_gather(loc, w, tab, 48, 128)
    with pytest.raises(ValueError, match="height"):
        mma.onehot_gather(loc, w, tab, 64, 64)
    with pytest.raises(ValueError, match="bf16"):
        mma.gemm(torch.zeros((1, 16, 16)), torch.zeros((16, 128)))
    with pytest.raises(ValueError, match="tile"):
        mma.tile_gather(torch.zeros(2, dtype=torch.int32),
                        torch.zeros(512, dtype=torch.int32), tab)


# ------------------------------------------------------------------ C

def _plan(U, Mp=2, seed=5):
    """A plan of one patch of U samples (the TB-aligned U the JAX kernels
    take)."""
    rng = np.random.default_rng(seed)
    B, ts, F, K = 1, 16, 32, 6
    planes = rng.normal(size=(B, (F + K) * 3, ts, ts)).astype(np.float32)
    centers = rng.uniform(-0.85, 0.85, (B, 3, Mp, 1, 1, U))
    jitter = rng.uniform(-1.5 / ts, 1.5 / ts, (B, 3, Mp, 1, 16, U))
    pos = np.clip(centers + jitter, -0.99, 0.99).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, Mp, 1, U)).astype(np.int32)
    valid = rng.random((B, Mp, 1, 16, U)) < 0.8
    jt = jtw.pack_tilewin(jnp.asarray(planes), F, K)
    tt = tilewin.pack_tilewin(T(planes), F, K)
    plan = tilewin._fused_plan(tt, T(pos), T(slot_idx), T(valid))
    args = (tt.feat, tt.mask, plan.frows, plan.mrows, plan.xt, plan.xs,
            plan.valid)
    win = jnp.take(jt.feat, jnp.asarray(plan.frows.numpy()).reshape(-1),
                   axis=0).reshape(B, 3, Mp, U, 16, 128)
    mwin = jnp.take(jt.mask, jnp.asarray(plan.mrows.numpy()).reshape(-1),
                    axis=0).reshape(B, 3, Mp, U, 64)
    return args, (win, mwin, jnp.asarray(plan.xt.numpy()),
                  jnp.asarray(plan.xs.numpy()), jnp.asarray(plan.valid.numpy()))


def _to_units(feature, cand_w, m, S):
    """The port's layouts -> (B, m, U, F) and (B, Mp, m, U)."""
    B, F, n = feature.shape
    n_patch = n // (m * S)
    f = feature.reshape(B, F, n_patch, m, S).permute(0, 3, 2, 4, 1) \
        .reshape(B, m, n_patch * S, F)
    w = cand_w.permute(0, 1, 3, 2, 4).reshape(B, cand_w.shape[1], m,
                                              n_patch * S)
    return f.numpy(), w.numpy()


def test_hat_full_twin_matches_jax_hat_kernel_interpret():
    """The TPU hat kernel rounds its t-weights to bf16 for the MXU; kernel 2
    keeps them in float32 (ROADMAP Queue 3). The full twin with that
    rounding matches it; without it, it sits 1e-3 away."""
    U = jtk.TB
    args, jargs = _plan(U)
    f_ref, w_ref = jtk._hat_combine_call(*jargs, 32, clamp_mask=False,
                                         interpret=True)
    f_ref = np.asarray(f_ref).transpose(0, 2, 1, 3)
    f, w = _to_units(*tilewin_combine_plain(*args, 32, U, False, round_t=True,
                                            stage="full"), 16, U)
    np.testing.assert_allclose(f, f_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w, np.asarray(w_ref), rtol=1e-5, atol=1e-6)
    assert float(np.abs(f).max()) > 0.1
    f32, _ = _to_units(*tilewin_combine_plain(*args, 32, U, False), 16, U)
    assert 1e-4 < float(np.abs(f32 - f_ref).max()) < 1e-2


@pytest.mark.parametrize("path", ["dot", "vpu"])
def test_modes_full_twin_matches_jax_interpret(monkeypatch, path):
    U = jtk.TB
    args, jargs = _plan(U, seed=6)
    f, w = ablate.modes_stage_plain(*args, U, False, path, "full")
    monkeypatch.setenv("ENARF_TILEWIN_KERNEL", path)
    f_ref, w_ref = jtk.tilewin_combine(*jargs, 32, clamp_mask=False,
                                       interpret=True)
    f, w = _to_units(f, w, 16, U)
    np.testing.assert_allclose(f, np.asarray(f_ref).transpose(0, 2, 1, 3),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w, np.asarray(w_ref), rtol=1e-5, atol=1e-6)


def _cells(x):
    i = np.minimum(np.floor(x), 6.0)
    return i.astype(np.int64), x - i


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np_inputs(args):
    feat, mask, frows, mrows, xt, xs, valid = (
        a.float().numpy().astype(np.float64) if a.is_floating_point()
        else a.numpy() for a in args)
    return feat.reshape(-1, 64, 32), mask.reshape(-1, 64), frows, mrows, xt, \
        xs, valid


def np_hat_stage(args, stage):
    """Kernel 2's dataflow on the texel table with one stage doctored, in
    float64 numpy: (B, m, U, F) feature and (B, Mp, m, U) cand_w."""
    texels, bases, bones, xt, xs, valid = (
        a.float().numpy().astype(np.float64) if a.is_floating_point()
        else a.numpy() for a in args)
    _, _, Hp, Wp, _ = texels.shape
    tab = texels.reshape(-1, 64)
    i, ft = _cells(xt)                               # (B, 3, Mp, m, U)
    k, fs = _cells(xs)
    if stage == "noweights":
        ft = fs = np.full_like(ft, 0.5)
    b = bases.astype(np.int64)[:, :, :, None, :]
    t00 = b + i * Wp + k
    st = np.where(b // Wp % Hp + i + 1 < Hp, Wp, 0)
    ss = (b % Wp + k + 1 < Wp).astype(np.int64)
    lane = 32 + bones.astype(np.int64)[:, None, :, None, :]
    sg = 0.0
    logit = np.zeros_like(ft)
    for dt, ds, wgt in ((0, 0, (1 - ft) * (1 - fs)), (0, 1, (1 - ft) * fs),
                        (1, 0, ft * (1 - fs)), (1, 1, ft * fs)):
        t = t00 + dt * st + ds * ss
        if stage == "stream":
            v = np.broadcast_to(((b & 255) / 256.0)[..., None],
                                t.shape + (32,))
        elif stage == "nofeat":
            v = np.ones(t.shape + (32,))
        else:
            v = tab[t, :32]
        sg = sg + v * wgt[..., None]
        if stage == "stream":
            logit = logit + (lane - 32) / 256.0 * wgt
        elif stage != "nomask":
            logit = logit + tab[t, np.broadcast_to(lane, t.shape)] * wgt
    cw = _np_sigmoid(logit * valid[:, None]).prod(1)           # (B,Mp,m,U)
    feature = (sg.sum(1) * (cw * valid)[..., None]).sum(1)      # (B,m,U,F)
    return feature, cw


def np_modes_stage(args, path, stage):
    """Kernel 3's matrix dataflow with one stage doctored, in float64
    numpy: D = A @ W over each whole window row (sublane 2t + h, lane
    32q + f), S += sum_{h,q} D ws(4h + q)."""
    feat, mask, frows, mrows, xt, xs, valid = _np_inputs(args)
    B, _, Mp, m, U = xt.shape
    W = feat.reshape(-1, 8, 2, 4, 32)[frows]         # (B,3,Mp,U,t,h,q,f)
    i, ft = _cells(xt)
    k, fs = _cells(xs)
    t = np.arange(8)
    A = (t == i[..., None]) * (1 - ft)[..., None] \
        + (t == i[..., None] + 1) * ft[..., None]
    A = A * valid[:, None, ..., None]
    if path == "dot" and stage != "featD":
        A = _bf16(A).astype(np.float64)
    if stage == "featA":
        A = np.ones_like(A)
    ws = (t == k[..., None]) * (1 - fs)[..., None] \
        + (t == k[..., None] + 1) * fs[..., None]
    if stage == "featB":
        ws = np.ones_like(ws)
    ws = ws.reshape(B, 3, Mp, m, U, 2, 4)
    if stage == "stream":
        s = W[..., 0, 0, 0, :][:, :, :, None] + (xt + xs)[..., None]
    elif stage == "mask":
        s = np.broadcast_to(W.sum((4, 5, 6))[:, :, :, None],
                            (B, 3, Mp, m, U, 32))
    else:
        if stage == "featD":
            D = W.sum(4)[:, :, :, None] + A.sum(-1)[..., None, None, None]
        else:
            D = np.einsum("bpgjut,bpguthqf->bpgjuhqf", A, W)
        s = (D * ws[..., None]).sum((5, 6))
    sg = s.sum(1)                                    # (B, Mp, m, U, F)
    if stage == "feat":
        cw = np.ones((B, Mp, m, U))
    else:
        if stage == "stream":
            logit = np.broadcast_to(mask[mrows, 0][:, :, :, None],
                                    xt.shape).copy()
        else:
            logit = 0.0
            for dt, ds, wgt in ((0, 0, (1 - ft) * (1 - fs)),
                                (0, 1, (1 - ft) * fs),
                                (1, 0, ft * (1 - fs)), (1, 1, ft * fs)):
                cell = (i + dt) * 8 + k + ds
                logit = logit + mask[np.broadcast_to(
                    mrows[:, :, :, None], cell.shape), cell] * wgt
        cw = _np_sigmoid(logit * valid[:, None]).prod(1)
    return (sg * (cw * valid)[..., None]).sum(1), cw


@pytest.mark.parametrize("stage", HAT_STAGES)
def test_hat_stage_twins_match_numpy(stage):
    inputs = ablate.probe_texel_inputs("cpu", U=24, S=8, Mp=2, m=16, seed=1,
                                       per_row=8)
    a6 = inputs[:6]
    f, w = ablate.hat_stage(*a6, 8, False, stage)
    f, w = _to_units(f, w, 16, 8)
    f_ref, w_ref = np_hat_stage(a6, stage)
    np.testing.assert_allclose(f, f_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w, w_ref, rtol=1e-5, atol=1e-5)
    if stage == "nomask":
        np.testing.assert_allclose(w, 0.125, rtol=1e-6)


@pytest.mark.parametrize("path", ablate.PATHS)
@pytest.mark.parametrize("stage", ablate.MODES_STAGES)
def test_modes_stage_twins_match_numpy(path, stage):
    inputs = ablate.probe_inputs("cpu", U=24, S=8, Mp=2, m=16, seed=2)
    a7 = inputs[:7]
    f, w = ablate.modes_stage(*a7, 8, False, path, stage)
    f, w = _to_units(f, w, 16, 8)
    f_ref, w_ref = np_modes_stage(a7, path, stage)
    np.testing.assert_allclose(f, f_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w, w_ref, rtol=1e-5, atol=1e-5)


def test_stage_wrappers_refuse_unknown_stages():
    a7 = ablate.probe_inputs("cpu", U=8, S=8, Mp=1)[:7]
    a6 = ablate.probe_texel_inputs("cpu", U=8, S=8, Mp=1)[:6]
    with pytest.raises(ValueError, match="stage"):
        ablate.hat_stage(*a6, 8, False, "nomxu")
    with pytest.raises(ValueError, match="path"):
        ablate.modes_stage(*a7, 8, False, "bdiag", "full")


# ------------------------------------------------------------------ D

def _jhat(t, x):
    return jnp.maximum(0.0, 1.0 - jnp.abs(t - x))


def jnp_body(name, x, y=None):
    """The bisect probes' kernel bodies, run outside Pallas."""
    f32 = jnp.float32
    iota = jax.lax.broadcasted_iota
    if name in ("load_c", "warm"):
        return x * 2.0
    if name == "hat_bcast":
        i = iota(jnp.int32, x.shape[:2] + (128,), 2).astype(f32)
        return _jhat(i, x).sum(axis=-1, keepdims=True)
    if name == "cat_sub":
        M = x.shape[1]
        x2 = jnp.concatenate([x, x], axis=1)
        return x2[:, :M] + x2[:, M:]
    if name == "lane_slice":
        d = y.astype(f32)
        d0 = jax.lax.slice_in_dim(jnp.concatenate([d, d], axis=1), 0,
                                  x.shape[1], axis=1)
        return sum(jax.lax.slice_in_dim(d0, q * 32, (q + 1) * 32, axis=2)
                   * (x + q) for q in range(4))
    if name == "mask_hat":
        shape = x.shape[:2] + (64,)
        wt = (iota(jnp.int32, shape, 2) // 8).astype(f32)
        ws = (iota(jnp.int32, shape, 2) % 8).astype(f32)
        return (_jhat(wt, x) * _jhat(ws, x)).sum(axis=-1, keepdims=True)
    if name == "block6d":
        acc = 0.0
        for p in range(3):
            for g in range(x.shape[2]):
                acc = acc + x[0, p, g].astype(f32).sum(axis=1)
        return acc
    if name == "concat_mid":
        return jnp.concatenate([x, x], axis=1)
    if name == "reshape_lead":
        return x.reshape(-1, 128)
    if name == "iota_sepw":
        TB, M = x.shape
        sig = iota(jnp.int32, (TB, 2 * M, 16), 2)
        half = (iota(jnp.int32, (TB, 2 * M, 16), 1) // M).astype(f32)
        c = jnp.concatenate([x, x], axis=1)[..., None]
        return jnp.where((sig // 2).astype(f32) == c, 1.0, 0.0) \
            * ((sig % 2).astype(f32) == half)
    if name == "sigmoid_prod":
        cw = jnp.ones_like(x)
        for _ in range(3):
            cw = cw * jax.nn.sigmoid(x)
        return cw
    if name == "multi_out":
        return x * 2.0, x + 1.0
    if name == "grid_6d":
        return x[0, 0, 0].astype(f32).sum(axis=1)
    if name == "reshape_fm":
        return x.reshape(x.shape[0], 32, 64).astype(f32).sum(axis=-1)
    if name == "reshape_tm":
        return x.reshape(x.shape[0], 64, 32).astype(f32).sum(axis=-2)
    if name == "ewr":
        return (x.astype(f32)[:, :, None, :] * y.astype(f32)[:, None, :, :]) \
            .sum(axis=-1)
    if name == "expand":
        xt = jnp.swapaxes(x, 0, 1)
        return xt[:, :, None] + jnp.zeros(xt.shape + (128,), f32)
    if name == "bcast":
        xt = jnp.swapaxes(x, 0, 1)
        xt2 = jnp.concatenate([xt, xt], axis=1)
        lam = iota(jnp.int32, xt2.shape + (128,), 2)
        tt = ((lam % 16) // 2).astype(f32)
        return jnp.maximum(0.0, 1.0 - jnp.abs(tt - xt2[:, :, None]))
    raise ValueError(name)


def _to_jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("name", list(constructs.CONSTRUCTS))
def test_construct_plain_matches_jnp_body(name):
    ins = constructs.construct_inputs(name, "cpu",
                                      torch.Generator().manual_seed(8))
    got = constructs.construct(name, *ins)
    ref = jnp_body(name, *(_to_jnp(t) for t in ins))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=1e-5, atol=1e-5)
    if name == "iota_sepw":
        assert float(got[0].sum()) > 0      # the compare hits


def test_coord_ops_match_probe_numpy_references():
    """probe_mosaic_coord_ops.py:44-64: swapT x.T, expand and bcast."""
    x = np.random.default_rng(0).uniform(0, 7, (16, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        gather.transpose(T(x)[None]).numpy()[0], x.T)
    np.testing.assert_array_equal(
        constructs.construct("expand", T(x)).numpy(),
        np.broadcast_to(x.T[:, :, None], (128, 16, 128)))
    lam = np.arange(128)
    tt = ((lam % 16) // 2).astype(np.float32)
    x2 = np.concatenate([x.T, x.T], axis=1)
    ref = np.maximum(0.0, 1.0 - np.abs(tt[None, None] - x2[..., None]))
    np.testing.assert_allclose(constructs.construct("bcast", T(x)).numpy(),
                               ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(constructs.ROSTERS))
def test_roster_plain_and_refusals(name):
    ins, outs = constructs.roster_args(name, "cpu",
                                       torch.Generator().manual_seed(9))
    got = constructs.roster(name, ins, outs)
    flat = [t.reshape(-1)[:32] for t in ins]
    got = got if isinstance(got, tuple) else (got,)
    np.testing.assert_allclose(got[0].numpy(), sum(flat).numpy(), rtol=1e-6)
    if len(got) == 2:
        np.testing.assert_array_equal(got[1].numpy(), 2 * flat[0].numpy())
    with pytest.raises(ValueError, match="roster"):
        constructs.roster(name, ins + ins[:1], outs)


def test_construct_refuses_wrong_shapes_and_types():
    with pytest.raises(ValueError, match="construct must be"):
        constructs.construct("dot", torch.zeros(2, 2))
    with pytest.raises(ValueError, match="bfloat16"):
        constructs.construct("block6d", torch.zeros((1, 3, 4, 2, 16, 128)))
    with pytest.raises(ValueError, match="two inputs"):
        constructs.construct("ewr", torch.zeros((2, 16, 64),
                                                dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="not the construct's"):
        constructs.construct("load_c", torch.zeros((4, 16, 2)))


# --------------------------------------------------------------- the CLIs

@pytest.mark.parametrize("module", [gather, mma, ablate, constructs])
def test_module_main_runs_the_plain_versions_on_cpu(module, capsys):
    lines = module.main(["--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(printed) == len(lines) >= 5
    for line in printed:
        assert line["device"] == "cpu" and line["finite"], line
        assert line["replaces"].startswith("tools/"), line
        assert "ms" not in line                  # no time from a CPU run
