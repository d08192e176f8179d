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
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from enarf_gan_tpu.ops import tilewin as jtw
from enarf_gan_tpu.ops import tilewin_kernel as jtk
from tools.bench_pallas_prims import matmul_chain_kernel, onehot_gather_kernel

from enarf_gan_tpu_torch.ops import tilewin
from enarf_gan_tpu_torch.ops.tilewin_kernel import (HAT_STAGES,
                                                    tilewin_combine_plain)
from enarf_gan_tpu_torch.tools import ablate, constructs, gather, mma

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



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


def _pallas_rows(kind, tab, idx):
    """tools/bench_unitable.py:48-55 kern_take / kern_dslice (closures there,
    written out here; kern_dslice's loop runs over this index's rows) in
    interpret mode, with the probe's SMEM index and VMEM table specs."""
    n = idx.shape[0]

    def kern_take(idx_ref, tab_ref, out_ref):
        out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)

    def kern_dslice(idx_ref, tab_ref, out_ref):
        def body(i, _):
            out_ref[i, :] = tab_ref[pl.ds(idx_ref[i], 1), :][0]
            return 0
        jax.lax.fori_loop(0, n, body, 0)

    return np.asarray(pl.pallas_call(
        kern_take if kind == "take" else kern_dslice,
        out_shape=jax.ShapeDtypeStruct((n, tab.shape[1]), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(idx), jnp.asarray(tab)))


@pytest.mark.parametrize("kind", ["take", "dslice"])
def test_row_gather_plain_matches_pallas_interpret(kind):
    """A1 (kern_take) and A2 (kern_dslice, a loop of dynamic slices) compute
    one function: the twin and the wrapper on the CPU are bit-equal to the
    TPU kernel at a (64, 128) f32 table and 32 indices."""
    rng = np.random.default_rng(6)
    tab = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, 32).astype(np.int32)
    ref = _pallas_rows(kind, tab, idx)
    np.testing.assert_array_equal(gather.row_gather_plain(T(tab), T(idx)).numpy(),
                                  ref)
    np.testing.assert_array_equal(
        gather.row_gather(T(tab), T(idx),
                          serial_rows=1024 if kind == "dslice" else 0).numpy(),
        ref)


# A1's widths: ROW_WIDTHS' bytes and the ragged ones of the check size
A1_WIDTHS = sorted({w * torch.tensor([], dtype=dt).element_size()
                    for _, dt, w in gather.ROW_WIDTHS}
                   | {4 * w for w in gather.RAGGED_WIDTHS})


def _row_plan_copies(plan, n, row_bytes):
    """The copies a launch of ``plan`` makes, as row_units_kernel walks its
    grid: (output byte offset, output row whose index names the table row,
    byte within that row) of each ``plan.unit``-byte unit."""
    lanes = np.arange(plan.blocks * plan.threads)
    upr, k = row_bytes // plan.unit, plan.units
    e = ((lanes // 32) * 32 * k + lanes % 32)[:, None] + 32 * np.arange(k)
    e = e.ravel()
    e = e[e < n * upr]
    return e * plan.unit, e // upr, (e % upr) * plan.unit


@pytest.mark.parametrize("n", [1, 3, 7, 1000])
@pytest.mark.parametrize("row_bytes", A1_WIDTHS)
def test_row_plan_writes_every_output_byte_once(row_bytes, n):
    """row_units_kernel emulated as it walks ``row_plan``'s grid, at every
    width of the sweep and the ragged ones, with both pointers on 16, 8 and
    4 bytes: 16 bytes a thread in units of the
    widest size the row and pointers allow; every byte of the output is
    written exactly once, from the byte of the table row its index names,
    by units that lie within the row; the grid covers the units with no
    block to spare."""
    rng = np.random.default_rng(n * 7 + row_bytes)
    tab = rng.integers(0, 256, (11, row_bytes), dtype=np.uint8)
    idx = rng.integers(0, 11, n)
    ref = tab[idx].ravel()
    for align in (16, 8, 4):
        plan = gather.row_plan(n, row_bytes, align)
        assert plan.unit == max(u for u in (4, 8, 16)
                                if row_bytes % u == 0 and align % u == 0)
        assert plan.unit * plan.units == 16 and plan.threads == 256
        dst, row, off = _row_plan_copies(plan, n, row_bytes)
        assert (off + plan.unit <= row_bytes).all()
        dst_bytes = (dst[:, None] + np.arange(plan.unit)).ravel()
        src_bytes = ((idx[row] * row_bytes + off)[:, None]
                     + np.arange(plan.unit)).ravel()
        assert (np.bincount(dst_bytes, minlength=n * row_bytes) == 1).all(), \
            plan
        out = np.empty(n * row_bytes, np.uint8)
        out[dst_bytes] = tab.ravel()[src_bytes]
        np.testing.assert_array_equal(out, ref, err_msg=str(plan))
        per_block = plan.threads * plan.units
        units = n * row_bytes // plan.unit
        assert (plan.blocks - 1) * per_block < units <= \
            plan.blocks * per_block, plan


def test_row_plan_at_the_probe_sizes():
    """The plan of each A1 probe: 16 bytes a thread everywhere (two 8-byte
    units at the 8-byte mask quad and at 264 B); the streaming hints from
    128-byte rows on at the 198 MB table and on A4's rows, none at the
    64-byte texel, the mask quad and the launch-bound sizes (512 KB to 1 MB
    out), which keep the grids of the earlier kernel (one 16-byte unit a
    thread on the most blocks)."""
    P = gather.RowPlan
    for row_bytes, unit, hints in ((8, 8, "plain"), (64, 16, "plain"),
                                   (128, 16, "stream"), (256, 16, "stream"),
                                   (264, 8, "stream"), (288, 16, "stream"),
                                   (2048, 16, "stream"),
                                   (4096, 16, "stream")):
        n = int(64e6 // row_bytes)
        assert gather.row_plan(n, row_bytes) == P(
            hints, unit, 16 // unit, -(-n * row_bytes // 16 // 256), 256)
    assert gather.row_plan(147456, 4096) == P("stream", 16, 1, 147456, 256)
    for n, row_bytes, blocks in ((1024, 512, 128), (4096, 256, 256),
                                 (1024, 1024, 256)):
        assert gather.row_plan(n, row_bytes) == P("plain", 16, 1, blocks, 256)


def _pallas_dg(tab, idx, n_blk):
    """tools/bench_gather.py:147-152 dg_kernel (a closure there) in
    interpret mode, with the probe's grid and VMEM block specs."""
    th, L = tab.shape

    def dg_kernel(tab_ref, idx_ref, out_ref):
        # out[i, l] = tab[idx[i, l], l]
        out_ref[:] = jnp.take_along_axis(
            jnp.pad(tab_ref[:], ((0, n_blk - th), (0, 0)))
            if th < n_blk else tab_ref[:],
            idx_ref[:], axis=0)[:n_blk]

    n_blocks = idx.shape[0] // n_blk
    return np.asarray(pl.pallas_call(
        dg_kernel, grid=(n_blocks,),
        in_specs=[pl.BlockSpec((th, L), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((n_blk, L), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((n_blk, L), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((idx.shape[0], L), jnp.float32),
        interpret=True)(jnp.asarray(tab), jnp.asarray(idx)))


def test_lane_gather_plain_matches_dg_kernel_interpret():
    """A3's twin and the wrapper on the CPU are bit-equal to the TPU's
    per-lane gather at a (96, 128) f32 table and a (256, 128) index (two
    grid steps of 128 rows; the table padded to the block as the probe
    pads it)."""
    rng = np.random.default_rng(7)
    tab = rng.normal(size=(96, 128)).astype(np.float32)
    idx = rng.integers(0, 96, (256, 128)).astype(np.int32)
    ref = _pallas_dg(tab, idx, 128)
    np.testing.assert_array_equal(ref, np.take_along_axis(tab, idx, 0))
    np.testing.assert_array_equal(
        gather.lane_gather_plain(T(tab), T(idx)).numpy(), ref)
    np.testing.assert_array_equal(gather.lane_gather(T(tab), T(idx)).numpy(),
                                  ref)


def test_lane_stage_width_fits_shared_memory():
    """The shared-memory design's columns a block: the whole 128-lane row up
    to 227 KB (TH 454 f32, 908 bf16), then halves down to 32 lanes, then
    none; never for the modes whose table has the output's rows."""
    def tx(th, dtype=torch.float32, L=128, mode="table"):
        return gather.lane_stage_tx(torch.empty((th, L), dtype=dtype), mode)
    assert [tx(th) for th in (384, 454, 455, 908, 909, 1816, 1817)] == \
        [32, 32, 16, 16, 8, 8, 0]
    assert [tx(th, torch.bfloat16) for th in (768, 908, 909, 3632, 3633)] == \
        [32, 32, 16, 8, 0]
    assert tx(14528, L=3) == 1 and tx(14529, L=3) == 0 and tx(5, L=256) == 32
    assert tx(8, mode="tile") == 0 and tx(8, mode="lane") == 0


def test_ring_gather_plain_matches_numpy():
    """dma_kernel's per-block sum of its (16, 128) bf16 rows."""
    rng = np.random.default_rng(2)
    tab = _bf16(rng.normal(size=(97, 16, 128)))
    idx = rng.integers(0, 97, 64 * 5).astype(np.int32)
    ref = tab[idx].reshape(5, -1).astype(np.float64).sum(1)
    got = gather.ring_gather(T(tab).to(torch.bfloat16), T(idx), 64, Q=8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * 64 * 2048)


@pytest.mark.parametrize("shape", [(37, 64, 16), (5, 16, 128), (4, 3, 5),
                                   (2, 48, 63)])
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
    with pytest.raises(ValueError, match="2\\*\\*31 matrices"):
        gather.transpose(torch.empty((2 ** 31, 1, 0)))


@pytest.mark.parametrize("NB,R,C,aligned", [
    (2304, 64, 16, True), (2304, 16, 128, True), (1, 64, 16, True),
    (37, 64, 16, True), (37, 16, 128, True), (9, 16, 128, True),
    (7, 64, 16, False), (37, 3, 5, True), (1500, 48, 63, True)])
def test_transpose_plan_covers_every_matrix_once(NB, R, C, aligned):
    """A5's plan: the register kernel at the probes' two shapes when both
    pointers lie on 16 bytes (16-byte loads and stores, no shared memory),
    in one wave of an H100 at the probe size (288 and 576 blocks, 5 an
    SM); the shared-memory tile kernel at every other shape, within 48 KB.
    Enumerating the plan's blocks covers every 4 x 4 block (or matrix)
    exactly once, also where NB is no multiple of a block's share (8
    matrices of (64, 16), 4 of (16, 128)) and the last block is short."""
    plan = gather.transpose_plan(NB, R, C, aligned)
    four = (R, C) in gather.TRANSPOSE4_SHAPES and aligned
    assert plan.kernel == ("tile4" if four else "tile")
    assert plan.kernel in gather.TRANSPOSE_KERNELS
    assert plan.smem_bytes == (0 if four else R * (C + 1) * 4) <= 48 * 1024
    seen = np.zeros((NB, R * C // 16 if four else 1), np.int32)
    for spans in gather.transpose_blocks(plan, NB, R, C):
        for m, w0, w1 in spans:
            seen[m, w0:w1] += 1
    assert (seen == 1).all()
    if four:
        assert plan.groups * 32 == NB * R * C // 16
        assert R * C * 4 % 16 == 0
    if NB == 2304 and four:
        assert plan.blocks == {64: 288, 16: 576}[R] and plan.waves == 1
        assert plan.blocks <= 132 * gather.T4_BLOCKS_PER_SM


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
                                        ("dynamic", 64, 128),
                                        ("static", 48, 80),
                                        ("dynamic", 48, 80)])
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
    for fn in (mma.onehot_gather_plain, mma.onehot_gather):
        got = fn(loc, w, tab, G, WIN, mode).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    # the TPU kernel's rounding of the weights matters at this tolerance
    unrounded = (tab.float()[loc.long()] * w[..., None]).sum(1).numpy()
    if mode == "static":
        assert np.abs(unrounded - ref).max() > 1e-4


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_tile_gather_plain_matches_numpy_onehot(n_blocks):
    """bench_dyngather2.py:135 kernel2: one-hot(loc) @ tab[t*512 : +512]."""
    rng = np.random.default_rng(5)
    tab = _bf16(rng.normal(size=(2048, 128)))
    tile = rng.integers(0, 4, n_blocks).astype(np.int32)
    loc = rng.integers(0, 512, n_blocks * 512).astype(np.int32)
    ref = np.concatenate([np.eye(512)[loc[b * 512:(b + 1) * 512]]
                          @ tab[t * 512:(t + 1) * 512]
                          for b, t in enumerate(tile)])
    got = mma.tile_gather(T(tile), T(loc), T(tab).to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


def _fast_div(n, d):
    """fast_div.cuh's FastDiv: n // d by a multiply and a shift, with the
    host's multiplier and the card's 32-bit high product."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert 0 < m < 1 << 32
    n = np.asarray(n, np.uint64)
    return ((n * np.uint64(m) >> np.uint64(32)) + n) >> np.uint64(s)


@pytest.mark.parametrize("d", [1, 5, 48, 192, 512, 1023, 1024, 4096, 65537])
def test_fast_div_divides_every_index_the_kernels_take(d):
    """The division of pair_rows_kernel (a sample's group) and
    row_units_kernel (a unit's row) is exact for every 32-bit index below
    2**31: checked at both ends, around every multiple of d near them, and
    at random indices."""
    rng = np.random.default_rng(d)
    ends = np.concatenate([np.arange(0, 4096), 2 ** 31 - 1 - np.arange(4096),
                           rng.integers(0, 2 ** 31, 200_000)])
    near = (ends // d * d)[:, None] + np.arange(-1, 2)
    n = np.concatenate([ends, near.ravel()])
    n = n[(n >= 0) & (n < 2 ** 31)]
    np.testing.assert_array_equal(_fast_div(n, d), n // d)


def _pair_rows_emulated(plan, S, G, WIN, mode, loc, w, tab, tile=None):
    """pair_rows_kernel emulated over ``pair_plan``'s grid: the half-warp
    of each sample, the 8 columns a thread loads from each of its rows, its
    group by ``_fast_div``, the dynamic base by ``& ~511`` (a floor, also
    below 0), the weights as ``load_pair`` forms them; then the exchange,
    lane l of a warp storing unit l (4 columns) of each of the warp's two
    samples from lane 16 h + l // 2. Returns the output and how often each
    float32 of it was written."""
    t = np.arange(plan.blocks * plan.threads, dtype=np.int64)
    lane = t % 32
    s = (t // 32) * 2 + lane // 16
    live = s < S
    cols = ((lane % 16) * 8)[:, None] + np.arange(8)
    tab_f = tab.float().numpy()
    vals = np.zeros((t.size, 8), np.float32)       # what each thread holds
    sl, cl = s[live], cols[live]
    if mode == "tile":
        rows = tile.numpy()[sl // mma.TILE].astype(np.int64) * mma.TILE \
            + loc.numpy()[sl]
        vals[live] = tab_f[rows[:, None], cl]
    else:
        lo, wv = loc.numpy().astype(np.int64), w.numpy()
        base = np.zeros_like(sl)
        if mode == "dynamic":
            first = lo.ravel()[2 * _fast_div(sl, G).astype(np.int64) * G]
            base = np.minimum(first, tab.shape[0] - WIN) & ~511
        j0, j1 = lo[sl, 0] - base, lo[sl, 1] - base
        w0, w1 = wv[sl, 0].copy(), wv[sl, 1].copy()
        same = j0 == j1
        w0[same] += w1[same]
        w1[same] = 0
        r16 = lambda x: T(x).to(torch.bfloat16).float().numpy()  # noqa
        w0 = np.where((j0 >= 0) & (j0 < WIN), r16(w0), np.float32(0))
        w1 = np.where((j1 >= 0) & (j1 < WIN), r16(w1), np.float32(0))
        r0 = base + np.clip(j0, 0, WIN - 1)
        r1 = base + np.clip(j1, 0, WIN - 1)
        vals[live] = (w0[:, None] * tab_f[r0[:, None], cl]
                      + w1[:, None] * tab_f[r1[:, None], cl])
    out = np.full((S, N_B), np.nan, np.float32)
    seen = np.zeros((S, N_B), np.int64)
    for h in range(2):
        dst = (t // 32) * 2 + h
        src = t - lane + 16 * h + lane // 2
        part = vals[src].reshape(-1, 2, 4)[np.arange(t.size), lane % 2]
        ok = dst < S
        dcols = (4 * lane)[ok, None] + np.arange(4)
        out[dst[ok, None], dcols] = part[ok]
        np.add.at(seen, (dst[ok, None], dcols), 1)
    return out, seen


N_B = mma.N


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("G,WIN", [(48, 80), (192, 320), (5, 80)])
def test_pair_rows_kernel_emulated_matches_plain(mode, G, WIN):
    """B1's kernel, emulated on ``pair_plan``'s grid, writes every float32
    of the output once and equals the plain twin bit for bit, at groups
    that are no multiple of 64 and windows no multiple of 64, a last block
    and warp left partial (G = 5), rows outside the window and coinciding
    rows, and (dynamic) groups whose first row lies within WIN of the
    table's end."""
    g = torch.Generator().manual_seed(G + WIN)
    S = 3 * G
    loc, w, tab = mma.b1_inputs(S, G, WIN, mode, "cpu", g)
    loc[1, 1] = loc[1, 0]
    loc[2, 0] = -3 if mode == "static" else loc[2, 0] + WIN   # outside
    if mode == "dynamic":
        loc[G, 0] = tab.shape[0] - 7                # capped at n_rows - WIN
    plan = mma.pair_plan(S)
    assert plan.threads == mma.PAIR_THREADS == 16 * mma.PAIR_SAMPLES
    assert (plan.blocks - 1) * mma.PAIR_SAMPLES < S \
        <= plan.blocks * mma.PAIR_SAMPLES
    if G == 5:
        assert S % mma.PAIR_SAMPLES and S % 2     # a partial block and warp
    out, seen = _pair_rows_emulated(plan, S, G, WIN, mode, loc, w, tab)
    assert (seen == 1).all()
    np.testing.assert_array_equal(
        out, mma.onehot_gather_plain(loc, w, tab, G, WIN, mode).numpy())


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_pair_rows_kernel_emulated_matches_tile_plain(n_blocks):
    """B2's kernel (the same kernel, tile mode) emulated on its grid:
    every float32 written once, bit-equal to ``tile_gather_plain``."""
    g = torch.Generator().manual_seed(n_blocks)
    S = n_blocks * mma.TILE
    tile = torch.randint(0, 4, (n_blocks,), generator=g, dtype=torch.int32)
    loc = torch.randint(0, mma.TILE, (S,), generator=g, dtype=torch.int32)
    tab = torch.randn((4 * mma.TILE, N_B), generator=g).to(torch.bfloat16)
    out, seen = _pair_rows_emulated(mma.pair_plan(S), S, mma.TILE, mma.TILE,
                                    "tile", loc, None, tab, tile)
    assert (seen == 1).all()
    np.testing.assert_array_equal(
        out, mma.tile_gather_plain(tile, loc, tab).numpy())


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


@pytest.mark.parametrize("batch,M,K", [(4, 128, 64), (8, 32, 16), (2, 16, 48),
                                       (3, 48, 16), (1, 112, 48)])
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
    with pytest.raises(ValueError, match="fit"):
        mma.onehot_gather(loc, w, tab, 64, 129, "dynamic")
    with pytest.raises(ValueError, match="height"):
        mma.onehot_gather(loc, w, tab, 64, 64)
    with pytest.raises(ValueError, match="bf16"):
        mma.gemm(torch.zeros((1, 16, 16)), torch.zeros((16, 128)))
    with pytest.raises(ValueError, match="tile"):
        mma.tile_gather(torch.zeros(2, dtype=torch.int32),
                        torch.zeros(512, dtype=torch.int32), tab)
    # what the kernels refuse on the card, asked of CPU tensors
    b = torch.zeros((64, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        mma.check_gemm_kernel_inputs(torch.zeros((2, 24, 64),
                                                 dtype=torch.bfloat16), b)
    with pytest.raises(ValueError, match="65535"):
        mma.check_gemm_kernel_inputs(
            torch.empty((65536, 0, 64), dtype=torch.bfloat16), b)
    flat = torch.zeros(2 * 512 * 64 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        mma.check_gemm_kernel_inputs(flat[1:1 + 2 * 512 * 64]
                                     .view(2, 512, 64), b)
    mma.check_gemm_kernel_inputs(flat[8:8 + 2 * 512 * 64].view(2, 512, 64),
                                 b)
    with pytest.raises(ValueError, match="2\\*\\*26"):
        mma.check_pair_kernel_inputs(mma.PAIR_MAX_S, tab, (loc, w))
    words = torch.zeros(2 * 128 + 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="8-byte"):
        mma.check_pair_kernel_inputs(128, tab, (words[1:-1].view(128, 2), w))
    mma.check_pair_kernel_inputs(128, tab, (words[2:].view(128, 2), w))
    rows = torch.zeros(129 * 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):      # 8 bytes off
        mma.check_pair_kernel_inputs(128, rows[4:4 + 128 * 128].view(128, 128))
    mma.check_pair_kernel_inputs(128, rows[8:8 + 128 * 128].view(128, 128))


@pytest.mark.parametrize("batch,M,K,batched", [
    (b, M, K, True) for _, _, b, M, K in mma.B3_BATCHED] + [
    (1, 16, 16, True), (3, 48, 64, True), (1, 128, 64, True),
    (100, 80, 32, True), (8, 16, 32, False), (1, 16, 160, True),
    (1, 128, 240, True), (40, 80, 32, True), (64, 48, 64, True)])
def test_gemm_small_plan_fits_an_h100(batch, M, K, batched):
    """The launch-bound kernel's plan: at least 64 blocks at dot_batched
    (128; the plan asks for ``SMALL_MIN_BLOCKS``), 32 rows a block or 16
    where 32 give fewer blocks or do not fit (K = 240), 4 warps of 16 x 16
    for each 16 rows of a 64-column block, its shared memory (A's rows and
    B's rows at padded pitches) within 48 KB, every row it copies a
    multiple of the 16 bytes of a cp.async, and every output row and
    column written by exactly one block, also where the rows a block do
    not divide M (80 = 2 x 32 + 16, 48 = 32 + 16)."""
    plan = mma.gemm_plan(batch, M, K, batched)
    assert plan == mma.gemm_small_plan(batch, M, K)
    assert plan.kernel == "gemm_small"
    assert plan.block_rows in mma.SMALL_BLOCK_ROWS
    assert plan.warps == plan.block_rows // 16 * 4
    assert plan.smem_bytes == mma.gemm_small_smem_bytes(
        plan.block_rows, K) <= mma.SMALL_SMEM_BYTES
    assert K * 2 % 16 == 0 and mma.SMALL_COLS * 2 % 16 == 0
    # pitches of an odd number of 16-byte units: ldmatrix without conflicts
    assert ((K + 8) * 2 // 16) % 2 == 1
    assert ((mma.SMALL_COLS + 8) * 2 // 16) % 2 == 1
    seen = np.zeros((batch, M, 128), np.int32)
    blocks = list(mma.gemm_small_blocks(plan, batch, M))
    assert len(blocks) == plan.blocks
    for b, m0, n, c0 in blocks:
        assert 0 < n <= plan.block_rows and n % 16 == 0
        seen[b, m0:m0 + n, c0:c0 + mma.SMALL_COLS] += 1
    assert (seen == 1).all()
    assert plan.b_l2_bytes == plan.blocks * K * mma.SMALL_COLS * 2
    if (batch, M, K) == (16, 128, 64):                  # dot_batched
        assert plan.blocks >= 64
    assert plan.blocks >= min(mma.SMALL_MIN_BLOCKS, batch * -(-M // 16) * 2)
    fits32 = mma.gemm_small_smem_bytes(32, K) <= mma.SMALL_SMEM_BYTES
    assert plan.block_rows == (32 if fits32 and M >= 32 and batch * -(
        -M // 32) * 2 >= mma.SMALL_MIN_BLOCKS else 16)


def test_gemm_small_refusals():
    """A walk of at most 128 rows whose operands fit no block goes to the
    TMA kernel, and the wrapper raises on what neither kernel takes."""
    assert mma.gemm_small_plan(1, 16, 1024) is None
    assert mma.gemm_plan(1, 16, 1024, True).kernel == "gemm"
    assert mma.gemm_plan(3, 128, 320, True).kernel == "gemm"
    assert mma.gemm_plan(1, 16, 272, True).kernel == "gemm_small"
    assert mma.gemm_plan(1, 16, 288, True).kernel == "gemm"
    with pytest.raises(ValueError, match="multiples of 16"):
        mma.check_gemm_kernel_inputs(
            torch.zeros((2, 24, 16), dtype=torch.bfloat16),
            torch.zeros((2, 16, 128), dtype=torch.bfloat16))


_B3_SHAPES = ([(n, M, K, False) for n, M, K in mma.B3_CHAINS]
              + [(b, M, K, True) for _, _, b, M, K in mma.B3_BATCHED]
              + list(mma.B3_RAGGED))


@pytest.mark.parametrize("batch,M,K,batched", _B3_SHAPES)
def test_gemm_plan_fits_an_h100(batch, M, K, batched):
    """The TMA kernel's plan at every B3 shape: 4+ ring stages in at most
    227 KB of shared memory, the layout of ``probe_mma.cu``, at least ~18 KB
    of A in flight an SM, and B read from L2 once a block (resident) or
    once a 256-row tile (streamed: half the bytes of A's tiles), which at
    the first chain is half of A's bytes; the launch-bound batched products
    (walks of at most 128 rows) go to the mma.sync kernel."""
    plan = mma.gemm_plan(batch, M, K, batched)
    rows = M if batched else batch * M
    assert plan.kernel == ("gemm_small" if rows <= mma.SMALL_ROWS else "gemm")
    if plan.kernel == "gemm_small":
        assert (batch, M, K, batched) not in _B3_SHAPES[:3]
        return
    nk = -(-K // mma.GEMM_TILE_K)
    assert 4 <= plan.stages <= mma.GEMM_MAX_STAGES
    assert plan.smem_bytes == mma.gemm_smem_bytes(plan.stages,
                                                  plan.b_resident, nk)
    assert plan.smem_bytes <= 232448
    assert plan.a_in_flight >= 18 * 1024
    assert plan.b_resident == (not batched and K <= 256)
    assert plan.tiles == (batch if batched else 1) * -(-rows // 256)
    reads = min(plan.tiles, 132) if plan.b_resident else plan.tiles
    assert plan.b_l2_bytes == reads * K * 128 * 2
    assert plan.b_l2_bytes <= plan.tiles * 256 * K * 2 / 2
    if (batch, M, K) == mma.B3_CHAINS[0]:     # 2,048 tiles x 192 KB
        assert plan.b_l2_bytes == 2048 * 768 * 256 == batch * M * K * 2 // 2


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
        return x.reshape(-1, x.shape[-1])
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


@pytest.mark.parametrize("name,shape", [
    pytest.param(n, None, id=n) for n in constructs.CONSTRUCTS] + [
    pytest.param(n, s, id=f"{n}-{'x'.join(map(str, s))}")
    for n, s in (("reshape_fm", (1, 2048)), ("reshape_fm", (37, 2048)),
                 ("reshape_lead", (3, 5, 7)), ("ewr", (1, 16, 64)),
                 ("ewr", (37, 16, 64)), ("cat_sub", (3, 5, 1)),
                 ("cat_sub", (37, 16, 1)), ("load_c", (3, 5, 1)),
                 ("load_c", (37, 16, 1)), ("warm", (3, 5)),
                 ("warm", (37, 128)))] + [
    pytest.param("concat_mid", s, id=f"concat_mid-{'x'.join(map(str, s))}")
    for s in constructs.CHECK_SHAPES["concat_mid"]])
def test_construct_plain_matches_jnp_body(name, shape):
    """Each construct at its probe's inputs, and the constructs with a
    kernel of their own also at ragged shapes (``shape``: x's, as
    ``constructs.CHECK_SHAPES`` has them)."""
    g = torch.Generator().manual_seed(8)
    if shape is None:
        ins = constructs.construct_inputs(name, "cpu", g)
    else:
        assert shape in constructs.CHECK_SHAPES[name]
        ins = constructs.check_inputs(name, shape, "cpu", g)
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


@pytest.mark.parametrize("name", list(constructs.LIBRARY))
def test_construct_library_call_matches_plain(name):
    """Each construct's one PyTorch call (the probe's library call) equals
    its plain twin at the probe's inputs, within the case's tolerance."""
    case = next(c for c in constructs.cases("cpu") if c.name == f"D {name}")
    torch.testing.assert_close(case.library(), case.plain(), rtol=case.rtol,
                               atol=case.atol)
    assert case.library().dtype == torch.float32
    # on the CPU only LIBRARY's calls: LIBRARY_CARD's exist on the card
    assert {c.name[2:] for c in constructs.cases("cpu")
            if c.library is not None} == set(constructs.LIBRARY)
    assert not set(constructs.LIBRARY_CARD) & set(constructs.LIBRARY)


# one wave of a grid of 256-thread blocks on an H100: 132 SMs of 2,048
# threads
H100_WAVE_256 = 132 * 2048 // 256


@pytest.mark.parametrize("TB", [1, 3, 37, 128, 1000])
def test_reduce_plan_covers_every_output_once(TB):
    """reshape_fm_kernel's grid, enumerated as the kernel walks it: block b
    takes row b, thread t loads the row's 16-byte vector t (the (t % 8)-th
    of output t // 8's 128 bytes), and lane 0 of warp w stores outputs 4w
    .. 4w + 3 of the row as one 16-byte vector. Every vector of the input
    is read once and within it, every output written once, in one wave of
    an H100 (TB blocks)."""
    plan = constructs.reduce_plan(TB)
    assert plan == (TB, 256) and plan.threads == constructs.REDUCE_THREADS
    assert plan.blocks <= H100_WAVE_256
    rows = np.arange(plan.blocks)
    rows = rows[rows < TB]
    t = np.arange(plan.threads)
    assert ((8 * t) // 64 == t // 8).all()       # a lane's 8 bf16: its output
    assert (t // 8 // 4 == t // 32).all()        # an output's lanes: one warp
    loads = (rows[:, None] * 256 + t).ravel()
    assert loads.max() < TB * 2048 * 2 // 16
    assert (np.bincount(loads, minlength=TB * 256) == 1).all()
    stores = (rows[:, None] * 8 + np.arange(plan.threads // 32)).ravel()
    outs = (stores[:, None] * 4 + np.arange(4)).ravel()
    assert (np.bincount(outs, minlength=TB * 32) == 1).all()
    assert outs.max() < TB * 32


@pytest.mark.parametrize("numel", [1, 3, 4, 105, 262144])
def test_copy_plan_covers_every_word_once(numel):
    """vec4_kernel's grid, enumerated as the kernel walks it: thread t of
    block b copies (or doubles) the 16-byte vector b * 256 + t if it lies
    below numel // 4, and threads t < numel % 4 of block 0 the last words.
    Every word is copied once, every vector lies within the tensor, in one wave
    of an H100 (256 blocks at the probe's 262,144 words)."""
    plan = constructs.copy_plan(numel)
    assert plan.threads == constructs.COPY_THREADS == 256
    assert plan.blocks <= H100_WAVE_256
    n4 = numel // 4
    vec = (np.arange(plan.blocks)[:, None] * 256
           + np.arange(plan.threads)).ravel()
    vec = vec[vec < n4]
    words = np.concatenate([(vec[:, None] * 4 + np.arange(4)).ravel(),
                            n4 * 4 + np.arange(numel % 4)])
    assert (np.bincount(words, minlength=numel) == 1).all()
    assert len(words) == numel and (len(vec) == 0 or vec.max() < n4)
    if numel == 262144:
        assert plan == (256, 256)


@pytest.mark.parametrize("M,TB", [(1, 1), (5, 3), (16, 37), (16, 128)])
def test_expand_plan_stores_every_output_vector_once(M, TB):
    """expand_kernel emulated as it walks copy_plan's grid of its output:
    thread t of block b stores vector v = b * 256 + t if v / 32 < TB * M,
    four copies of x[j, tb] with (tb, j) = divmod(v / 32, M). Every vector
    of the (TB, M, 128) output is stored once, a warp's 32 vectors are one
    512-byte row of (tb, j) and read one word, the grid is one wave of an
    H100 (256 blocks at the probe's M 16, TB 128), and the emulation is
    ``construct_plain``'s output bit for bit."""
    g = torch.Generator().manual_seed(M * TB)
    (x,) = constructs.check_inputs("expand", (M, TB), "cpu", g)
    plan = constructs.own_plan("expand", x)
    assert plan == constructs.copy_plan(TB * M * 128)
    assert plan.threads == constructs.COPY_THREADS
    assert plan.blocks <= H100_WAVE_256
    v = (np.arange(plan.blocks)[:, None] * 256
         + np.arange(plan.threads)).ravel()
    row = v // 32
    v, row = v[row < TB * M], row[row < TB * M]
    tb, j = row // M, row % M
    assert (np.bincount(v, minlength=TB * M * 32) == 1).all()
    warps = v.reshape(-1, 32)
    assert (warps[:, 1:] - warps[:, :-1] == 1).all()
    assert (np.ptp(row.reshape(-1, 32), axis=1) == 0).all()
    out = np.empty((TB * M * 32, 4), np.float32)
    out[v] = x.numpy().ravel()[j * TB + tb][:, None]
    assert np.array_equal(out.reshape(TB, M, 128),
                          constructs.construct_plain("expand", x).numpy())
    if (M, TB) == (16, 128):
        assert plan == (256, 256)


@pytest.mark.parametrize("TB,M", [(37, 4), (128, 16), (5, 36), (3, 1),
                                  (37, 3), (2, 5)])
def test_concat_mid_plan_stores_every_output_once(TB, M):
    """concat_mid_kernel emulated as it walks its plan: where M is a
    multiple of 4, copy_plan of the output, thread i of block b storing
    the 16-byte vector v = b * 256 + i of row tb = v / (M / 2), x's vector
    tb M / 4 + (v mod M / 2) mod M / 4; else word_plan, the same map a word
    a thread. Every vector (word) of the output is stored once, the grid is
    one wave of an H100 (4 blocks at the probe's (128, 16)), and the
    emulation is ``construct_plain``'s output bit for bit."""
    g = torch.Generator().manual_seed(TB * M)
    (x,) = constructs.check_inputs("concat_mid", (TB, M), "cpu", g)
    plan = constructs.own_plan("concat_mid", x)
    vec = M % 4 == 0
    w = 4 if vec else 1                         # words a thread
    assert plan == (constructs.copy_plan if vec else constructs.word_plan)(
        2 * TB * M)
    assert plan.threads == constructs.COPY_THREADS
    assert plan.blocks <= H100_WAVE_256
    q = M // w
    i = np.arange(plan.blocks * plan.threads)
    i = i[i < 2 * TB * q]
    tb, c = i // (2 * q), i % (2 * q)
    src = tb * q + np.where(c < q, c, c - q)
    assert (np.bincount(i, minlength=2 * TB * q) == 1).all()
    assert (plan.blocks - 1) * plan.threads < 2 * TB * q
    out = np.empty((2 * TB * q, w), np.float32)
    out[i] = x.numpy().reshape(-1, w)[src]
    assert np.array_equal(out.reshape(TB, 2 * M),
                          constructs.construct_plain("concat_mid", x).numpy())
    if (TB, M) == (128, 16):
        assert plan == (4, 256)


def test_own_kernels_refuse_a_base_off_16_bytes():
    """The constructs with a kernel of their own take inputs on 16 bytes
    only, on either device (their kernels load 16-byte vectors): a
    contiguous view at storage offset 1 raises (ewr's x or y), one 16 bytes
    in runs."""
    lead = torch.randn(3 * 5 * 7 + 4)
    fm = torch.randn(2 * 2048 + 8).to(torch.bfloat16)
    coords = torch.randn(3 * 5 + 4)
    for name, flat, shape, step in (("reshape_lead", lead, (3, 5, 7), 4),
                                    ("reshape_fm", fm, (2, 2048), 8),
                                    ("cat_sub", coords, (3, 5, 1), 4),
                                    ("load_c", coords, (3, 5, 1), 4),
                                    ("warm", coords, (3, 5), 4),
                                    ("expand", coords, (5, 3), 4),
                                    ("concat_mid", coords, (3, 5), 4)):
        n = flat.numel() - step
        with pytest.raises(ValueError, match="16 bytes"):
            constructs.construct(name, flat[1:1 + n].view(shape))
        x = flat[step:].view(shape)
        torch.testing.assert_close(constructs.construct(name, x),
                                   constructs.construct_plain(name, x))
    xf = torch.randn(2 * 16 * 64 + 8).to(torch.bfloat16)
    yf = torch.randn(2 * 32 * 64 + 8).to(torch.bfloat16)
    x, y = xf[8:].view(2, 16, 64), yf[8:].view(2, 32, 64)
    for bad in ((xf[1:1 + x.numel()].view(2, 16, 64), y),
                (x, yf[1:1 + y.numel()].view(2, 32, 64))):
        with pytest.raises(ValueError, match="16 bytes"):
            constructs.construct("ewr", *bad)
    torch.testing.assert_close(constructs.construct("ewr", x, y),
                               constructs.construct_plain("ewr", x, y))


@pytest.mark.parametrize("TB", [1, 3, 37, 128, 1000, 2113])
def test_ewr_plan_gives_every_batch_element_a_warp(TB):
    """ewr_mma_kernel's grid: warp w of block b takes batch element b *
    warps + w, every element gets one warp, the warps past TB lie in the
    last block only, and the grid is one wave of an H100 (132 SMs of 2,048
    threads; 32 blocks an SM at most). The block is the one that
    ``probe_ewr`` launches (``kEwrWarps`` in probe_ops.cu)."""
    plan = constructs.ewr_plan(TB)
    warps = plan.threads // 32
    assert plan.threads % 32 == 0 and warps == constructs.EWR_WARPS
    src = (Path(constructs.__file__).parents[1] / "csrc/probe_ops.cu")
    assert f"constexpr int kEwrWarps = {warps};" in src.read_text()
    elem = (np.arange(plan.blocks)[:, None] * warps
            + np.arange(warps)).ravel()
    assert (np.bincount(elem[elem < TB], minlength=TB) == 1).all()
    assert (elem >= TB).sum() < warps
    assert plan.blocks <= 132 * min(32, 2048 // plan.threads)


@pytest.mark.parametrize("TB", [1, 3, 37])
def test_ewr_fragments_form_every_product_once(TB):
    """ewr_mma_kernel emulated lane by lane in numpy. Its loads as the
    kernel indexes them: lane (g, t) = (lane / 4, lane % 4) of the warp of
    batch element b reads the 16-byte vectors 4c + t (c < 2) of x's rows g
    and g + 8 and of y's rows 8j + g (j < 4). Its fragments on the PTX
    layout of mma.m16n8k16 (A row-major: a0 (g, 2t..2t+1), a1 (g + 8, ..),
    a2 (g, 2t+8..2t+9), a3 (g + 8, ..); B column-major: b0 (k 2t..2t+1,
    n g), b1 (k 2t+8..2t+9, n g); C: c0, c1 (g, 2t..2t+1), c2, c3 (g + 8,
    ..)), k-step 2c + h taking words 2h and 2h + 1 of each vector. Every
    vector lies within its 128-byte row; in each step A's column k and B's
    row k hold the same physical k (one permutation of k for both
    operands); every (b, m, n, k) product is formed once; and C from the
    emulated fragments, stored as the kernel's float2s, equals x @ y.mT
    on the probe's kind of inputs (1e-5)."""
    g_ = torch.Generator().manual_seed(TB)
    x, y = constructs.check_inputs("ewr", (TB, 16, 64), "cpu", g_)
    xv = x.float().numpy().reshape(-1, 8)     # 16-byte vectors (8 bf16)
    yv = y.float().numpy().reshape(-1, 8)
    plan = constructs.ewr_plan(TB)
    warps = plan.threads // 32
    out = np.zeros(TB * 16 * 32, np.float32)
    stored = np.zeros(TB * 16 * 32, int)
    formed = np.zeros((TB, 16, 32, 64), int)
    for b in range(plan.blocks * warps):
        if b >= TB:                           # the warps past TB exit
            continue
        acc = np.zeros((4, 16, 8), np.float32)        # [j] C tile
        for c in range(2):
            # each lane's vectors: (flat vector index) as the kernel has it
            for h in range(2):
                a_k = np.full((16, 16), -1)   # physical k of A[m, kk]
                a_v = np.zeros((16, 16), np.float32)
                b_k = np.full((4, 16, 8), -1)
                b_v = np.zeros((4, 16, 8), np.float32)
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for row, vec in ((g, b * 128 + g * 8 + 4 * c + t),
                                     (g + 8, b * 128 + (g + 8) * 8 + 4 * c
                                      + t)):
                        assert vec // 8 == b * 16 + row   # within its row
                        k = (vec % 8) * 8 + np.arange(8)
                        for w, kk in ((2 * h, 2 * t), (2 * h + 1, 2 * t + 8)):
                            a_k[row, kk:kk + 2] = k[2 * w:2 * w + 2]
                            a_v[row, kk:kk + 2] = xv[vec, 2 * w:2 * w + 2]
                    for j in range(4):
                        vec = b * 256 + (8 * j + g) * 8 + 4 * c + t
                        assert vec // 8 == b * 32 + 8 * j + g
                        k = (vec % 8) * 8 + np.arange(8)
                        for w, kk in ((2 * h, 2 * t), (2 * h + 1, 2 * t + 8)):
                            b_k[j, kk:kk + 2, g] = k[2 * w:2 * w + 2]
                            b_v[j, kk:kk + 2, g] = yv[vec, 2 * w:2 * w + 2]
                assert (a_k >= 0).all() and (b_k >= 0).all()
                perm = a_k[0]                 # this step's 16 physical k
                assert (a_k == perm).all() and (b_k == perm[:, None]).all()
                for j in range(4):
                    formed[b, :, 8 * j:8 * j + 8, perm] += 1
                    acc[j] += a_v @ b_v[j]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(4):
                for row in (g, g + 8):        # (c0, c1), (c2, c3)
                    f2 = b * 256 + row * 16 + 4 * j + t     # float2 index
                    out[2 * f2:2 * f2 + 2] = acc[j, row, 2 * t:2 * t + 2]
                    stored[2 * f2:2 * f2 + 2] += 1
    assert (formed == 1).all()
    assert (stored == 1).all()
    ref = (x.float() @ y.float().mT).numpy()
    np.testing.assert_allclose(out.reshape(TB, 16, 32), ref, rtol=1e-5,
                               atol=1e-5)


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


def test_against_loads_another_tree_and_pairs_its_cases(tmp_path, capsys):
    """``--against DIR``: the other tree's module under its own name, its
    kernel library built from that tree's source under another name, its
    cases paired with these by name and else by the TPU kernel they
    replace; ``--only`` keeps the matching cases."""
    import dataclasses
    import os
    import shutil
    from enarf_gan_tpu_torch.tools import timing
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ("enarf_gan_tpu_torch/tools/gather.py",
                "enarf_gan_tpu_torch/csrc/probe_gather.cu"):
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        shutil.copy(os.path.join(root, rel), tmp_path / rel)
    other = timing.other_tree(gather, str(tmp_path))
    assert other is not gather and other.KERNEL is not gather.KERNEL
    assert other.KERNEL.name == "probe_gather_other"
    assert other.KERNEL.source == str(
        tmp_path / "enarf_gan_tpu_torch/csrc/probe_gather.cu")
    assert other.KERNEL.symbols == gather.KERNEL.symbols
    cpu = torch.device("cpu")
    mine = [c for c in gather.cases(cpu, "check") if c.name.startswith("A2")]
    theirs = [dataclasses.replace(c, name=c.name + " (renamed)")
              for c in other.cases(cpu, "check") if c.name.startswith("A2")]
    theirs[0] = dataclasses.replace(theirs[0], name=mine[0].name)
    pairs = timing.pair_cases(mine, theirs)
    assert [o.name for _, o in pairs] == [mine[0].name, theirs[1].name]
    assert timing.pair_cases(mine, theirs[:1])[1][1] is None
    lines = gather.main(["--device", "cpu", "--only", "^A2 "])
    assert [x["probe"] for x in lines] == [c.name for c in mine]
    capsys.readouterr()


_C_TYPES = {"int": "c_int", "long long": "c_longlong", "int64_t": "c_longlong"}


@pytest.mark.parametrize("module", ["gather", "mma", "constructs"])
def test_entry_points_match_their_c_signatures(module):
    """Each probe library's ctypes argument types are those of its C entry
    point in the source, argument by argument (a pointer as c_void_p), so
    that no call passes too few arguments or cuts a pointer to 32 bits on
    the card."""
    import ctypes
    import re
    lib = {"gather": gather, "mma": mma, "constructs": constructs}[module] \
        .KERNEL
    src = (Path(mma.__file__).parents[1] / "csrc" / lib.source).read_text()
    found = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(lib.symbols) <= set(found)
    for name, argtypes in lib.symbols.items():
        want = []
        for arg in found[name].split(","):
            kind = " ".join(arg.split()[:-1]).replace("const ", "")
            want.append(ctypes.c_void_p if "*" in arg
                        else getattr(ctypes, _C_TYPES[kind]))
        assert list(argtypes) == want, name


def test_against_pairs_a_kernel_the_other_tree_has_beside_its_own():
    """``pair_cases``: a case of the other tree left after the pairing by
    name (there a second kernel of the same function, as B1's direct
    gather was) is paired once more with this tree's case of the same
    inputs, after that case's own pair; ``summarize`` keeps the two pairs
    of that case apart."""
    import dataclasses
    from enarf_gan_tpu_torch.tools import summarize, timing
    cpu = torch.device("cpu")
    mine = [c for c in mma.cases(cpu, "check") if c.name.startswith("B1 ")]
    mine = mine[:3]
    extra = dataclasses.replace(
        mine[1], name="B1 direct two-row gather",
        info={k: mine[1].info[k] for k in ("S", "G", "WIN", "window")})
    pairs = timing.pair_cases(mine, mine + [extra])
    assert [(c.name, o.name) for c, o in pairs] == [
        (mine[0].name, mine[0].name), (mine[1].name, mine[1].name),
        (mine[1].name, extra.name), (mine[2].name, mine[2].name)]
    lines = [{"probe": c.name, "other_probe": o.name, "device_us": 1.0,
              "other_device_us": 2.0} for c, o in pairs]
    out = summarize.summarize(lines)
    assert len(out) == 4 and out[mine[1].name]["below_other"] == 1
    assert out[f"{mine[1].name} | {extra.name}"]["other_probe"] == extra.name


def test_summarize_takes_medians_and_counts_pairs(tmp_path, capsys):
    """tools/summarize.py: per probe over runs, the median and range of
    each µs field, and the runs whose kernel was below the other tree's
    and at or below the library call's."""
    from enarf_gan_tpu_torch.tools import summarize
    runs = [(3.0, 4.0, 3.5), (2.0, 1.0, 2.0), (5.0, 6.0, 4.0)]
    paths = []
    for i, (dev, other, lib) in enumerate(runs):
        paths.append(str(tmp_path / f"run_{i}.jsonl"))
        with open(paths[-1], "w") as f:
            f.write(json.dumps({"probe": "D x", "device_us": dev,
                                "host_us": 10.0 + i, "other_device_us": other,
                                "library_device_us": lib}) + "\n")
            f.write(json.dumps({"probe": "D y", "device_us": 1.0,
                                "host_us": 2.0, "library_device_us": None})
                    + "\n")
    out = summarize.main(paths)
    x, y = out["D x"], out["D y"]
    assert x["runs"] == 3 and x["device_us"] == {"median": 3.0, "min": 2.0,
                                                 "max": 5.0}
    assert x["host_us"]["median"] == 11.0 and x["other_device_us"]["max"] == 6
    assert x["below_other"] == 2 and x["at_or_below_library"] == 2
    assert "library_device_us" not in y and "below_other" not in y
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_warp_rows_study_needs_the_card():
    """tools/warp_rows.py times kernels: without a CUDA device it exits with
    a message and times nothing."""
    from enarf_gan_tpu_torch.tools import warp_rows
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="NVIDIA GPU"):
        warp_rows.main()
