"""Family B of the probes: row gathers and tensor-core products
(``csrc/probe_mma.cu``).

* ``onehot_gather`` (B1): per sample two rows ``loc`` and weights ``w``;
  out[s] = the two rows of the sample's window, weighted as the TPU
  kernel's one-hot row weights them (bf16, summed where the rows coincide,
  0 outside the window), the window being the whole (WIN, 128) bf16 table
  ("static") or WIN rows from a 512-aligned base taken from each group's
  first row ("dynamic"). The TPU multiplied the one-hot rows into the
  window on its matrix unit; here ``pair_rows_kernel`` reads the two rows
  straight from the table (``pair_plan``), and the formulation's time on
  the tensor cores is printed beside (``formulation_ms``).
* ``tile_gather`` (B2): blocks of 512 samples, one row each from the
  512-row tile the block's ``tile`` entry names; the same kernel.
* ``gemm`` (B3): (batch, M, K) @ (K, 128) or (batch, K, 128), bf16 in,
  float32 out, by one of two kernels that ``gemm_plan`` chooses by shape:
  "gemm" (persistent blocks, TMA and wgmma, 256-row tiles) wherever a walk
  over the rows (all of them for a shared B, one batch element's for a
  batched B) has more than 128 rows or the small kernel's operands do not
  fit its shared memory, else "gemm_small" (blocks of 32 or 16 rows of a
  batch element and 64 columns, 16 x 16 a warp, whose operands arrive in
  one round trip, then mma.sync; ``gemm_small_plan``). Library: the
  float32-out product, ``torch.mm(..., out_dtype=
  torch.float32)`` (a shared B) or ``torch.bmm`` (batched); the bf16-out
  ``torch.matmul`` is timed beside it (``library_bf16_out_ms``).

The plain twins compute the same numbers in float32 from the bf16 values
(the one-hot weights rounded to bf16 as the TPU kernel rounds them).

    python -m enarf_gan_tpu_torch.tools.mma [--device cpu]
        [--size main|sweep] [--only REGEX] [--against DIR]
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch.cuda_build import KernelLibrary, raw_stream
from enarf_gan_tpu_torch.tools.gather import H100, SMEM_BYTES
from enarf_gan_tpu_torch.tools.timing import (BF16_FLOPS, HBM_BYTES_PER_S,
                                              Case, run_cli)

SOURCE = "enarf_gan_tpu_torch/csrc/probe_mma.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = KernelLibrary(
    "probe_mma", "probe_pair_rows", [_P] * 5 + [_I] * 6 + [_P],
    keys=("onehot_static", "onehot_dynamic", "tile", "gemm", "gemm_small"),
    symbols={"probe_gemm": [_P] * 3 + [_I] * 6 + [_P],
             "probe_gemm_small": [_P] * 3 + [_I] * 5 + [_P]})
N = 128                      # columns of every table and output
WINDOW_MODES = ("static", "dynamic")
BASE_ALIGN = 512
TILE = 512
PAIR_THREADS = 256         # a block of pair_rows_kernel
PAIR_SAMPLES = PAIR_THREADS // 16   # two samples a warp, 8 columns a thread
PAIR_MAX_S = 2 ** 26       # samples the kernel takes: 32-bit thread indices


def _raise(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check_cuda(*ts):
    for t in ts:
        if t.device != ts[0].device or not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors on one device")


# ------------------------------------------------------------------- B1

def window_bases(loc, G, WIN, n_rows, mode):
    """(S,) int64 slab base of every sample: 0 for "static", else each group
    of G samples' first row, capped at n_rows - WIN and rounded down to a
    multiple of 512."""
    S = loc.shape[0]
    if mode == "static":
        return torch.zeros(S, dtype=torch.long, device=loc.device)
    first = loc[::G, 0].long().clamp(max=n_rows - WIN)
    return ((first // BASE_ALIGN) * BASE_ALIGN).repeat_interleave(G)


def onehot_weights(loc, w, base, WIN):
    """The one-hot row's two nonzeros as the TPU kernel forms them: the
    weights summed where the two rows coincide, rounded to bf16, and 0 for
    a row outside the window. Returns (local rows clamped into the window,
    weights) (S, 2)."""
    j = loc.long() - base[:, None]
    same = j[:, 0] == j[:, 1]
    w0 = torch.where(same, w[:, 0] + w[:, 1], w[:, 0])
    w1 = torch.where(same, torch.zeros_like(w[:, 1]), w[:, 1])
    wb = torch.stack([w0, w1], 1).to(torch.bfloat16).float()
    inside = (j >= 0) & (j < WIN)
    return j.clamp(0, WIN - 1), torch.where(inside, wb, torch.zeros_like(wb))


def onehot_gather_plain(loc, w, tab, G, WIN, mode="static"):
    base = window_bases(loc, G, WIN, tab.shape[0], mode)
    j, wb = onehot_weights(loc, w, base, WIN)
    rows = tab[(base[:, None] + j).reshape(-1)].float().view(-1, 2, N)
    return (rows * wb[..., None]).sum(1)


def _check_b1(loc, w, tab, G, WIN, mode):
    if mode not in WINDOW_MODES:
        raise ValueError(f"mode must be one of {WINDOW_MODES}, got {mode!r}")
    S = loc.shape[0]
    if loc.dtype != torch.int32 or tuple(loc.shape) != (S, 2) or \
            w.dtype != torch.float32 or tuple(w.shape) != (S, 2):
        raise ValueError(f"loc (S, 2) int32 and w (S, 2) float32, got "
                         f"{tuple(loc.shape)} {loc.dtype}, {tuple(w.shape)} "
                         f"{w.dtype}")
    if tab.dtype != torch.bfloat16 or tab.dim() != 2 or tab.shape[1] != N:
        raise ValueError(f"tab must be (rows, {N}) bfloat16, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if G <= 0 or S % G or WIN <= 0 or WIN > tab.shape[0] or \
            (mode == "static" and WIN != tab.shape[0]):
        raise ValueError(f"G={G} must divide S={S}; WIN={WIN} must fit the "
                         f"table (and be its height for a static window)")


class PairPlan(NamedTuple):
    """How ``onehot_gather`` and ``tile_gather`` run on the card:
    ``pair_rows_kernel`` in ``blocks`` blocks of ``threads`` threads, two
    samples a warp, a half-warp each; a thread 8 float32 columns from 16
    bytes of each of its sample's rows, exchanged by shuffles so that each
    store of the warp writes one sample's 512 bytes; no loop. Its stores
    stream (``st.global.cs``) and its table loads carry an L2 evict-last
    policy."""
    blocks: int
    threads: int


def pair_plan(S):
    """The ``PairPlan`` of S samples: ``PAIR_SAMPLES`` a block."""
    return PairPlan(-(-S // PAIR_SAMPLES), PAIR_THREADS)


def check_pair_kernel_inputs(S, tab, pairs=()):
    """Raises on what ``pair_rows_kernel`` does not take: 2**26 samples or
    more (its thread indices are 32-bit), a table that does not start on
    16 bytes (a thread reads 16 bytes of a row) or B1's ``loc`` and ``w``
    (``pairs``) off 8 bytes (a thread reads a sample's pair of rows and of
    weights, 8 bytes each)."""
    if S >= PAIR_MAX_S:
        raise ValueError(f"the kernel takes fewer than 2**26 samples, "
                         f"got {S}")
    if tab.data_ptr() % 16:
        raise ValueError("the kernel takes a table that starts on a 16-byte "
                         "aligned address")
    if any(t.data_ptr() % 8 for t in pairs):
        raise ValueError("the kernel takes loc and w that start on 8-byte "
                         "aligned addresses")


def _pair_rows(loc, w, tile, tab, S, G, WIN, mode, key):
    out = torch.empty((S, N), dtype=torch.float32, device=tab.device)
    _raise(KERNEL.load()(loc.data_ptr(), w.data_ptr(), tile.data_ptr(),
                         tab.data_ptr(), out.data_ptr(), S, G, WIN,
                         tab.shape[0], mode, pair_plan(S).blocks,
                         raw_stream(tab)), "probe_pair_rows")
    KERNEL.count(key)
    return out


def onehot_gather(loc, w, tab, G, WIN, mode="static"):
    """(S, 128) float32: each sample's two rows of its group's (WIN, 128)
    window of tab, weighted as the TPU kernel's one-hot row weights them
    (``onehot_weights``), read straight from the two rows
    (``pair_rows_kernel`` on ``pair_plan``'s grid)."""
    _check_b1(loc, w, tab, G, WIN, mode)
    if not tab.is_cuda:
        return onehot_gather_plain(loc, w, tab, G, WIN, mode)
    _check_cuda(loc, w, tab)
    check_pair_kernel_inputs(loc.shape[0], tab, (loc, w))
    return _pair_rows(loc, w, loc, tab, loc.shape[0], G, WIN,
                      WINDOW_MODES.index(mode), f"onehot_{mode}")


# ------------------------------------------------------------------- B2

def tile_gather_plain(tile, loc, tab):
    rows = tile.long().repeat_interleave(loc.shape[0] // tile.shape[0]) * TILE
    return tab[rows + loc.long()].float()


def tile_gather(tile, loc, tab):
    """(S, 128) float32: sample s of block b (512 a block) is row loc[s] of
    the 512-row tile tile[b] of tab, read straight from the row
    (``pair_rows_kernel``, as ``onehot_gather``)."""
    S = loc.shape[0]
    if loc.dtype != torch.int32 or loc.dim() != 1 or tile.dtype != torch.int32 \
            or tile.dim() != 1 or tile.shape[0] * TILE != S:
        raise ValueError(f"loc (S,) and tile (S / {TILE},) int32, got "
                         f"{tuple(loc.shape)}, {tuple(tile.shape)}")
    if tab.dtype != torch.bfloat16 or tab.dim() != 2 or tab.shape[1] != N \
            or tab.shape[0] % TILE:
        raise ValueError(f"tab must be (k x {TILE}, {N}) bfloat16, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if not tab.is_cuda:
        return tile_gather_plain(tile, loc, tab)
    _check_cuda(tile, loc, tab)
    check_pair_kernel_inputs(S, tab)
    return _pair_rows(loc, loc, tile, tab, S, TILE, TILE, 2, "tile")


# ------------------------------------------------------------------- B3

GEMM_TILE_ROWS = 256       # output rows of a tile of the TMA/wgmma kernel
GEMM_TILE_K = 64           # k of a TMA tile: 128 bytes of bf16
GEMM_MIN_STAGES = 4        # B stays resident only beside this many stages
GEMM_MAX_STAGES = 8
SMALL_ROWS = 128           # a walk of at most this many rows: gemm_small
# a gemm_small block: 32 rows (16 where 32 give fewer than
# SMALL_MIN_BLOCKS blocks, ~132 SMs) x SMALL_COLS columns, a warp 16 rows x
# SMALL_WARP_COLS columns, its operands within SMALL_SMEM_BYTES (a launch
# without an opt-in)
SMALL_BLOCK_ROWS = (32, 16)
SMALL_MIN_BLOCKS = 128
SMALL_COLS = N // 2
SMALL_WARP_COLS = 16
SMALL_SMEM_BYTES = 48 * 1024
_A_STAGE = GEMM_TILE_ROWS * GEMM_TILE_K * 2     # bytes of A a stage
_B_TILE = GEMM_TILE_K * N * 2                   # bytes of a k-tile of B
_C_STAGING = 2 * 128 * 32 * 4                   # a 16 KB box a warpgroup


class GemmPlan(NamedTuple):
    """How ``gemm`` runs a shape: the kernel ("gemm": TMA and wgmma;
    "gemm_small": one cp.async round trip, then mma.sync), the block's
    shared memory and the bytes of B the launch reads from L2. For "gemm":
    its ring stages, whether B is resident in shared memory (a shared B
    whose k-tiles fit beside ``GEMM_MIN_STAGES`` stages) or streamed
    through the ring with A, the 256-row tiles and the bytes of A the ring
    holds an SM. For "gemm_small": the rows of a batch element a block
    takes (and ``SMALL_COLS`` columns), its warps and the blocks."""
    kernel: str
    stages: int = 0
    b_resident: bool = False
    smem_bytes: int = 0
    tiles: int = 0
    a_in_flight: int = 0
    b_l2_bytes: int = 0
    block_rows: int = 0
    warps: int = 0
    blocks: int = 0


def gemm_smem_bytes(stages, resident, nk):
    """A block's dynamic shared memory (``probe_mma.cu::gemm_smem_bytes``):
    1 KB of alignment, the ring, B's nk k-tiles when resident, C's staging,
    the barriers."""
    return (1024 + stages * (_A_STAGE + (0 if resident else _B_TILE))
            + (nk * _B_TILE if resident else 0) + _C_STAGING
            + 8 * (2 * GEMM_MAX_STAGES + 1))


def gemm_small_smem_bytes(block_rows, K):
    """A gemm_small block's dynamic shared memory
    (``probe_mma.cu::small_smem_bytes``): A's rows and B's K rows at
    pitches of K + 8 and ``SMALL_COLS`` + 8 bf16."""
    return block_rows * (K + 8) * 2 + K * (SMALL_COLS + 8) * 2


@functools.lru_cache(maxsize=None)
def gemm_small_plan(batch, M, K):
    """The "gemm_small" ``GemmPlan`` of a (batch, M, K) product (B shared
    or one a batch element), or None where no block's operands fit
    ``SMALL_SMEM_BYTES``: blocks of 32 rows, or 16 where 32 give fewer
    than ``SMALL_MIN_BLOCKS`` blocks, exceed M or do not fit."""
    plans = []
    for r in SMALL_BLOCK_ROWS:
        smem = gemm_small_smem_bytes(r, K)
        if r > max(M, 16) or smem > SMALL_SMEM_BYTES:
            continue
        blocks = batch * -(-M // r) * (N // SMALL_COLS)
        plans.append(GemmPlan(
            "gemm_small", smem_bytes=smem,
            b_l2_bytes=blocks * K * SMALL_COLS * 2, block_rows=r,
            warps=r // 16 * (SMALL_COLS // SMALL_WARP_COLS), blocks=blocks))
    return next((p for p in plans if p.blocks >= SMALL_MIN_BLOCKS),
                plans[-1] if plans else None)


def gemm_small_blocks(plan, batch, M):
    """(batch element, first row, rows, first column) of each block of a
    "gemm_small" launch, in the kernel's order (probe_mma.cu: blockIdx.x
    over row blocks and column halves, blockIdx.y over the batch)."""
    r, h = plan.block_rows, N // SMALL_COLS
    for b in range(batch):
        for x in range(-(-M // r) * h):
            m0 = (x // h) * r
            yield b, m0, min(r, M - m0), (x % h) * SMALL_COLS


@functools.lru_cache(maxsize=None)
def gemm_plan(batch, M, K, b_batched):
    """The ``GemmPlan`` of a product on an H100 (232,448 bytes of shared
    memory a block, 132 SMs: the blocks that each read a resident B)."""
    rows = M if b_batched else batch * M       # a walk: one B's rows
    if rows <= SMALL_ROWS:
        small = gemm_small_plan(batch, M, K)
        if small is not None:
            return small
    walks = batch if b_batched else 1
    nk = -(-K // GEMM_TILE_K)
    tiles = walks * -(-rows // GEMM_TILE_ROWS)
    resident = not b_batched and \
        gemm_smem_bytes(GEMM_MIN_STAGES, True, nk) <= SMEM_BYTES
    stages = min(GEMM_MAX_STAGES,
                 (SMEM_BYTES - gemm_smem_bytes(0, resident, nk))
                 // (_A_STAGE + (0 if resident else _B_TILE)))
    b_reads = min(tiles, H100[0]) if resident else tiles
    return GemmPlan("gemm", stages, resident,
                    gemm_smem_bytes(stages, resident, nk), tiles,
                    stages * _A_STAGE, b_reads * K * N * 2)


def gemm_plain(a, b):
    return torch.matmul(a.float(), b.float())


def check_gemm_kernel_inputs(a, b):
    """Raises on what neither of ``gemm``'s kernels takes: M or K not a
    multiple of 16, more than 65535 batch elements or 2**31 rows, a tensor
    that does not start on 16 bytes (cp.async and the TMA read 16 bytes at
    a time)."""
    batch, M, K = a.shape
    if M % 16 or K % 16 or batch > 65535 or batch * M >= 2 ** 31:
        raise ValueError(f"the kernel takes M and K multiples of 16, at most "
                         f"65535 batch elements and fewer than 2**31 rows, "
                         f"got {tuple(a.shape)}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("the kernel takes tensors that start on 16-byte "
                         "aligned addresses")


def gemm(a, b):
    """(batch, M, K) bf16 @ (K, 128) or (batch, K, 128) bf16 -> (batch, M,
    128) float32, by the kernel ``gemm_plan`` chooses."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.dim() != 3 \
            or b.dim() not in (2, 3) or b.shape[-1] != N \
            or b.shape[-2] != a.shape[2] \
            or (b.dim() == 3 and b.shape[0] != a.shape[0]):
        raise ValueError(f"a (batch, M, K) and b (K, {N}) or (batch, K, {N}), "
                         f"bf16; got {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    batch, M, K = a.shape
    if not a.is_cuda:
        return gemm_plain(a, b)
    _check_cuda(a, b)
    check_gemm_kernel_inputs(a, b)
    batched = b.dim() == 3
    plan = gemm_plan(batch, M, K, batched)
    out = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    if plan.kernel == "gemm":
        err = KERNEL.load("probe_gemm")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, M, K,
            int(batched), plan.stages, int(plan.b_resident), raw_stream(a))
    else:
        err = KERNEL.load("probe_gemm_small")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, M, K,
            int(batched), plan.block_rows, raw_stream(a))
    _raise(err, f"probe_{plan.kernel}")
    KERNEL.count(plan.kernel)
    return out


# ----------------------------------------------------------------- cases

def _nbytes(*ts):
    return float(sum(t.numel() * t.element_size() for t in ts))


def b1_inputs(S, G, WIN, mode, device, g):
    """bench_pallas_prims.py's inputs: each group's rows within WIN - 8 rows
    of a 512-aligned base (dynamic, over 196,608 rows) or of the window."""
    n_rows = 196608 if mode == "dynamic" else WIN
    n_groups = S // G
    loc = torch.randint(0, WIN - 8, (n_groups, G, 2), generator=g,
                        device=device)
    if mode == "dynamic":
        bases = torch.randint(0, (n_rows - WIN) // BASE_ALIGN, (n_groups,),
                              generator=g, device=device) * BASE_ALIGN
        loc = loc + bases[:, None, None]
    w = torch.rand((S, 2), generator=g, device=device)
    tab = torch.rand((n_rows, N), generator=g, device=device).to(torch.bfloat16)
    return loc.reshape(S, 2).to(torch.int32), w, tab


def _pair_info(S):
    plan = pair_plan(S)
    return {"kernel": "pair_rows_kernel", "blocks": plan.blocks,
            "threads": plan.threads, "samples_per_warp": 2,
            "cols_per_thread": 8,
            "hints": "streaming stores, L2 evict-last table loads"}


def group_floor_ms(nbytes, rows, group, n_rows):
    """A case's bytes bound (``nbytes`` over HBM's rate) again with each
    group's distinct rows read from HBM once a group, as they are where the
    table does not stay in L2 from one group that reads a row to the next
    (a 50.3 MB table beside the output's stream): ``rows`` (S, k) the rows
    each sample reads, ``group`` (S,) its group (B2: its block)."""
    per_group = torch.unique(group[:, None] * n_rows + rows).numel()
    extra = (per_group - torch.unique(rows).numel()) * N * 2.0
    return (nbytes + extra) / HBM_BYTES_PER_S * 1e3


def b1_case(S, G, WIN, mode, device, g):
    loc, w, tab = b1_inputs(S, G, WIN, mode, device, g)
    tab_f = tab.float()
    base = window_bases(loc, G, WIN, tab.shape[0], mode)
    j, wb = onehot_weights(loc, w, base, WIN)
    gl = base[:, None] + j
    rows_needed = int(torch.unique(gl).numel())   # the rows the function reads
    # the function's bytes: loc and w, each row it reads once, the float32
    # output
    nbytes = _nbytes(loc, w) + rows_needed * N * 2.0 + S * N * 4.0
    floor = {} if mode == "static" else {"group_floor_ms": group_floor_ms(
        nbytes, gl, torch.arange(S, device=device) // G, tab.shape[0])}
    return Case(
        f"B1 one-hot gather {mode} G={G} WIN={WIN}",
        "tools/bench_pallas_prims.py:73", SOURCE,
        kernel=lambda: onehot_gather(loc, w, tab, G, WIN, mode),
        plain=lambda: onehot_gather_plain(loc, w, tab, G, WIN, mode),
        # one PyTorch call of the same sums: embedding_bag over float32 rows
        library=lambda: F.embedding_bag(gl, tab_f, mode="sum",
                                        per_sample_weights=wb),
        counter=(KERNEL, f"onehot_{mode}"), nbytes=nbytes,
        # the same two bf16 products, summed in float32 in another order
        rtol=1e-6, atol=1e-6,
        info={"S": S, "G": G, "WIN": WIN, "window": mode,
              **_pair_info(S), **floor,
              # the TPU's formulation: the one-hot product on tensor cores
              "formulation_ms": S * WIN * N * 2.0 / BF16_FLOPS * 1e3})


def b2_case(n_blocks, device, g):
    n_rows = 196608
    tile = torch.randint(0, n_rows // TILE, (n_blocks,), generator=g,
                         device=device, dtype=torch.int32)
    loc = torch.randint(0, TILE, (n_blocks * TILE,), generator=g,
                        device=device, dtype=torch.int32)
    tab = torch.randn((n_rows, N), generator=g, device=device).to(torch.bfloat16)
    tab_f = tab.float()
    rows = tile.long().repeat_interleave(TILE) * TILE + loc.long()
    S = n_blocks * TILE
    nbytes = _nbytes(tile, loc) + min(S * N * 2.0, _nbytes(tab)) \
        + S * N * 4.0
    floor = group_floor_ms(nbytes, rows[:, None],
                           torch.arange(S, device=device) // TILE, n_rows)
    return Case(
        f"B2 sorted-tile one-hot gather, {n_blocks} blocks of {TILE}",
        "tools/bench_dyngather2.py:144", SOURCE,
        kernel=lambda: tile_gather(tile, loc, tab),
        plain=lambda: tile_gather_plain(tile, loc, tab),
        # one PyTorch call of the same function: float32 rows by index
        library=lambda: torch.index_select(tab_f, 0, rows),
        extra_library={"bf16_out": lambda: torch.index_select(tab, 0, rows)},
        counter=(KERNEL, "tile"), nbytes=nbytes, rtol=0, atol=0,
        info={"S": S, "blocks_of_512": n_blocks, "tile": TILE,
              **_pair_info(S), "group_floor_ms": floor,
              "formulation_ms": S * TILE * N * 2.0 / BF16_FLOPS * 1e3,
              "also_replaces": "tools/bench_dyngather2.py:115"})


def b3_case(name, replaces, batch, M, K, b_batched, device, g):
    a = torch.randn((batch, M, K), generator=g, device=device).to(torch.bfloat16)
    b = torch.randn(((batch,) if b_batched else ()) + (K, N), generator=g,
                    device=device).to(torch.bfloat16)
    plan = gemm_plan(batch, M, K, b_batched)
    if b_batched:
        library = lambda: torch.bmm(a, b, out_dtype=torch.float32)  # noqa
    else:
        library = lambda: torch.mm(  # noqa: E731
            a.view(-1, K), b, out_dtype=torch.float32).view(batch, M, N)
    return Case(
        name, replaces, SOURCE, kernel=lambda: gemm(a, b),
        plain=lambda: gemm_plain(a, b), library=library,
        extra_library={"bf16_out": lambda: torch.matmul(a, b)},
        counter=(KERNEL, plan.kernel),
        nbytes=_nbytes(a, b) + batch * M * N * 4.0,
        flops=2.0 * batch * M * K * N, rate=BF16_FLOPS,
        # K-long float32 sums of exact bf16 products in another order
        rtol=1e-4, atol=1e-4 * K ** 0.5,
        info={"batch": batch, "M": M, "K": K, "N": N,
              "b": "per batch element" if b_batched else "shared",
              "kernel": plan.kernel, **({
                  "stages": plan.stages, "b_resident": plan.b_resident,
                  "smem_bytes": plan.smem_bytes, "tiles": plan.tiles,
                  "a_in_flight_bytes": plan.a_in_flight,
                  "b_l2_bytes": plan.b_l2_bytes}
                  if plan.kernel == "gemm" else {
                  "block_rows": plan.block_rows, "warps": plan.warps,
                  "blocks": plan.blocks, "smem_bytes": plan.smem_bytes,
                  "b_l2_bytes": plan.b_l2_bytes})})


B1_STATIC = ((512, 768), (256, 768), (512, 1536), (1024, 768), (512, 512))
B1_DYNAMIC = ((512, 768), (1024, 1024))
B3_CHAINS = ((1024, 512, 768), (1024, 512, 256), (256, 1024, 1024))
B3_BATCHED = (("B3 dot_batched (16,128,64) @ (16,64,128)",
               "tools/probe_mosaic_caps.py:98", 16, 128, 64),
              ("B3 dot_kshape (128,32,16) @ (128,16,128)",
               "tools/bisect_kernel_ops.py:95", 128, 32, 16),
              ("B3 bdiag_dot per unit (256,32,16) @ (256,16,128)",
               "tools/bisect_hat_kernel.py:99", 256, 32, 16))
# shapes across the edges of the TMA kernel's tiles (batch, M, K, batched):
# M = tile + 16 and tile - 16 against batched Bs (K = 64 + 16, K = 16), M
# = 16 with a shared B over 3 tiles (resident, K = 2 x 64 + 16), a shared B
# over 134 tiles (more than an H100's 132 SMs; streamed, K = 5 x 64 + 16),
# and a walk of 128 rows, the largest that gemm_small takes
B3_RAGGED = ((3, GEMM_TILE_ROWS + 16, 80, True),
             (2, GEMM_TILE_ROWS - 16, 16, True),
             (40, 16, 144, False),
             (1, 133 * GEMM_TILE_ROWS + 16, 336, False),
             (8, 16, 32, False))


def cases(device, size="main"):
    """B1 at bench_pallas_prims.py's (G, WIN) list (S = 1,179,648), B2 at
    8192 blocks, B3 at the chain and batched shapes. "check" shrinks S,
    blocks and batches; "check" and "sweep" add B3 at the ragged shapes."""
    small = size == "check"
    g = torch.Generator(device=device).manual_seed(1)
    S = 1_179_648 if not small else None
    for mode, shapes in (("static", B1_STATIC), ("dynamic", B1_DYNAMIC)):
        for G, WIN in shapes:
            s = 2 * G if small else S // G * G
            yield b1_case(s, G, WIN, mode, device, g)
    yield b2_case(3 if small else 8192, device, g)
    for n, M, K in B3_CHAINS:
        n = 2 if small else n
        yield b3_case(f"B3 chain ({M}x{K}) @ ({K}x{N}) x{n}",
                      "tools/bench_pallas_prims.py:105", n, M, K, False,
                      device, g)
    for name, replaces, batch, M, K in B3_BATCHED:
        yield b3_case(name, replaces, 3 if small else batch, M, K, True,
                      device, g)
    if size != "main":
        for batch, M, K, batched in B3_RAGGED:
            yield b3_case(f"B3 ragged ({batch},{M},{K}) @ "
                          f"{'batched' if batched else 'shared'} B",
                          "tools/bench_pallas_prims.py:105", batch, M, K,
                          batched, device, g)


def main(argv=None):
    return run_cli(cases, argv, __doc__)


if __name__ == "__main__":
    main()
