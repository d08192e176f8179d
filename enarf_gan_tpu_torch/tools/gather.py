"""Family A of the probes: row and lane gathers (``csrc/probe_gather.cu``).

How fast this card fetches rows by index, by row width, table size and
index order, which bounds kernels 1, 1b, 2 and 2b (they are row gathers
with a little arithmetic). Wrappers, their plain twins and the cases:

* ``row_gather`` (A1): out[i] = tab[idx[i]], rows of any width that is a
  multiple of 4 bytes; plain ``tab[idx]``, library ``torch.index_select``.
  Its grid and cache hints come from ``row_plan``: 16 bytes a thread (one
  16-byte unit, or two or four of 8 or 4 bytes where the width or a
  pointer allows no wider), the streaming hints for wide rows.
  ``row_gather(..., serial_rows=k)`` (A2) walks k rows a warp in turn.
* ``lane_gather`` (A3): out[i, l] = tab[idx[i, l], l] (``mode`` "table"),
  within groups of G rows ("tile"), or tab[i, idx[i, l]] ("lane"); library
  ``torch.gather``. A table of mode "table" whose columns fit a block's
  shared memory is staged there when the index is long enough to pay for
  it (``lane_stage``), else read through L1; the sweep times both.
* ``ring_gather`` (A4): per block the float32 sum of R bf16 rows, staged
  through a ring of Q shared-memory slots by cp.async (``staged=True``) or
  read directly; no one PyTorch call computes it.
* ``transpose`` (A5): a batch of (R, C) float32 matrices transposed, at
  the probes' (64, 16) and (16, 128) in 4 x 4 register blocks (16-byte
  loads and stores), any other shape through a padded shared-memory tile
  (``transpose_plan``); library ``x.transpose(1, 2).contiguous()``.

    python -m enarf_gan_tpu_torch.tools.gather [--device cpu]
        [--size main|sweep] [--only REGEX] [--against DIR]

Index values are not checked (as in any index kernel): they must lie in
the table.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from enarf_gan_tpu_torch.cuda_build import KernelLibrary, raw_stream
from enarf_gan_tpu_torch.tools.timing import (Case, HBM_BYTES_PER_S, L2_BYTES,
                                              run_cli)

SOURCE = "enarf_gan_tpu_torch/csrc/probe_gather.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
KEYS = ("row", "serial", "lane", "lane_smem", "ring", "direct", "transpose")
KERNEL = KernelLibrary(
    "probe_gather", "probe_row_gather", [_P, _P, _P] + [_I] * 5 + [_P],
    keys=KEYS,
    symbols={"probe_row_serial": [_P, _P, _P, _I, _I, _I, _P],
             "probe_lane_gather": [_P, _P, _P] + [_I] * 8 + [_P],
             "probe_ring_gather": [_P, _P, _P] + [_I] * 5 + [_P],
             "probe_transpose": [_P, _P] + [_I] * 5 + [_P]})
SMEM_BYTES = 232448             # a block's shared memory on an H100
# an H100's SMs, shared memory of an SM and of a block: the card A3's
# staging is decided for when the table lies on the CPU (no launch)
H100 = (132, 233472, SMEM_BYTES)
LANE_MODES = ("table", "tile", "lane")
RING_DEPTHS = (2, 4, 8, 16)


def _raise(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check_rows_index(idx):
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be (n,) int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def _check_cuda(*ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


# ------------------------------------------------------------------ A1, A2

def row_gather_plain(tab, idx):
    return tab[idx.long()]


ROW_THREADS = 256          # a block of row_units_kernel
STREAM_BYTES = 128         # rows from here take the streaming hints
SM_THREADS = 2048          # threads an SM holds: one wave of the card


class RowPlan(NamedTuple):
    """How ``row_gather`` runs A1 (``probe_gather.cu::row_units_kernel``):
    the output as a run of ``unit``-byte units, ``units`` of them (16
    bytes) a thread, warp w the 32 ``units`` units from 32 ``units`` w and
    lane l every 32nd from the l-th, in ``blocks`` blocks of ``threads``;
    ``variant`` "stream" reads the table past L1 and writes by streaming
    stores, "plain" by ``__ldg`` and plain stores."""
    variant: str
    unit: int
    units: int
    blocks: int
    threads: int


def row_unit(row_bytes, align=16):
    """The widest unit (16, 8 or 4 bytes) that divides the row and the
    pointers' alignment ``align``."""
    return next(u for u in (16, 8, 4) if row_bytes % u == 0 and align % u == 0)


@functools.lru_cache(maxsize=None)
def row_plan(n, row_bytes, align=16, sms=H100[0]):
    """The ``RowPlan`` of a gather of n rows of ``row_bytes`` (a multiple of
    4) on a card of ``sms`` SMs, with the table and output pointers on
    ``align`` bytes: 16 bytes a thread, one thread each; the streaming
    hints for rows of ``STREAM_BYTES`` and more when the threads outnumber
    one wave of the card (they slowed narrower rows and the launch-bound
    sizes: PERF.md §6, A1)."""
    unit = row_unit(row_bytes, align)
    k = 16 // unit
    threads = -(-n * (row_bytes // unit) // k)
    variant = "stream" if row_bytes >= STREAM_BYTES and \
        threads > sms * SM_THREADS else "plain"
    return RowPlan(variant, unit, k, max(1, -(-threads // ROW_THREADS)),
                   ROW_THREADS)


def row_gather(tab: torch.Tensor, idx: torch.Tensor, serial_rows: int = 0):
    """out (n, *tab.shape[1:]) = tab[idx]; idx (n,) int32. ``serial_rows``
    > 0 runs A2, each warp copying that many rows in turn; else A1 on
    ``row_plan``'s plan. On the card, rows are a multiple of 4 bytes and
    fewer than 2**31, and A1 takes an output of fewer than 2**31 of its
    units (8 GB of 4-byte units, 32 GB of 16-byte ones)."""
    if tab.dim() < 1 or tab.shape[0] == 0:
        raise ValueError(f"tab must have rows, got {tuple(tab.shape)}")
    _check_rows_index(idx)
    if not tab.is_cuda:
        return row_gather_plain(tab, idx)
    _check_cuda(tab, idx)
    row_bytes = tab.numel() // tab.shape[0] * tab.element_size()
    n = idx.shape[0]
    if row_bytes % 4 or n >= 2 ** 31:
        raise ValueError(f"the kernel takes rows of a multiple of 4 bytes, "
                         f"fewer than 2**31 of them, got {row_bytes} B, n={n}")
    out = torch.empty((n,) + tuple(tab.shape[1:]), dtype=tab.dtype,
                      device=tab.device)
    if n == 0:
        return out
    if serial_rows > 0:
        _raise(KERNEL.load("probe_row_serial")(
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes,
            serial_rows, raw_stream(tab)), "probe_row_serial")
        KERNEL.count("serial")
        return out
    off = (tab.data_ptr() | out.data_ptr()) % 16
    align = off & -off if off else 16
    plan = row_plan(n, row_bytes, align, _card(tab.get_device())[0])
    if n * row_bytes // plan.unit >= 2 ** 31:
        raise ValueError(f"the kernel takes fewer than 2**31 units of output, "
                         f"got {n} rows of {row_bytes // plan.unit}")
    _raise(KERNEL.load("probe_row_gather")(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes,
        plan.unit, plan.variant == "stream", plan.blocks, raw_stream(tab)),
        "probe_row_gather")
    KERNEL.count("row")
    return out


# -------------------------------------------------------------------- A3

def lane_gather_plain(tab, idx, mode="table", group=8):
    """The same function by flat indexing."""
    n, L = idx.shape
    lane = torch.arange(L, device=idx.device)
    row = torch.arange(n, device=idx.device)[:, None]
    j = idx.long()
    if mode == "table":
        flat = j * L + lane
    elif mode == "tile":
        flat = ((row // group) * group + j) * L + lane
    else:
        flat = row * L + j
    return tab.reshape(-1)[flat]


def lane_gather_library(tab, idx_long, mode="table", group=8):
    """One ``torch.gather`` call (int64 indices made beforehand)."""
    if mode == "table":
        return torch.gather(tab, 0, idx_long)
    if mode == "tile":
        n, L = idx_long.shape
        return torch.gather(tab.view(n // group, group, L), 1,
                            idx_long.view(n // group, group, L)).view(n, L)
    return torch.gather(tab, 1, idx_long)


def _lane_tx(L):
    """Lane vectors (4 lanes each) a block covers: the row's, up to 32."""
    tx = 1
    while tx < (L + 3) // 4 and tx < 32:
        tx *= 2
    return tx


@functools.lru_cache(maxsize=None)
def _card(index):
    """(SMs, shared memory of an SM, the most a block may ask for) of CUDA
    device ``index``; an H100's for None (a tensor on the CPU)."""
    if index is None:
        return H100
    p = torch.cuda.get_device_properties(index)
    return (p.multi_processor_count, p.shared_memory_per_multiprocessor,
            p.shared_memory_per_block_optin)


def _stage_of(tab, n, mode):
    return _stage(*tab.shape, tab.element_size(), n, mode,
                  _card(tab.get_device() if tab.is_cuda else None))


def lane_stage_tx(tab, mode="table"):
    """Lane vectors a block of the shared-memory design stages: the widest
    power of two up to the row's, at least 8 when it is not the whole row
    (a warp's index loads stay whole 128-byte lines), whose columns of the
    table fit a block's shared memory; 0 where none fits or the mode reads a
    table of the output's rows."""
    return _stage_of(tab, 0, mode)[0]


def lane_stage(tab, idx, mode="table"):
    """The lane vectors a block of ``lane_gather`` stages (``lane_stage_tx``),
    or 0 to read the table through L1: 0 unless the columns fit and each
    block gathers at least as many rows as it stages (fewer are
    launch-bound, and staging only adds to them). Where both designs run,
    staging is the faster on an NVIDIA H100 80GB HBM3 at 700 W (the sweep's
    ", through L1" cases; PERF.md §6)."""
    return _stage_of(tab, idx.shape[0], mode)[1]


@functools.lru_cache(maxsize=None)
def _stage(TH, L, es, n, mode, card):
    """(lane_stage_tx, lane_stage, blocks of the staged design resident at
    once) of a (TH, L) table of ``es``-byte elements and n index rows on a
    ``_card`` (cached: a call is host-bound). A staging block has 1024
    threads, so an SM holds at most 2, and fewer where their columns and
    the 1 KB the card reserves a block outgrow the SM's shared memory."""
    sms, sm_smem, block_smem = card
    if mode != "table":
        return 0, 0, 0
    cols = TH * 4 * es
    tx = _lane_tx(L)
    while tx > 8 and cols * tx > block_smem:
        tx //= 2
    if cols * tx > block_smem:
        return 0, 0, 0
    blocks = sms * max(1, min(2, sm_smem // (cols * tx + 1024)))
    return tx, (tx if n * -(-L // (4 * tx)) >= TH * blocks else 0), blocks


def lane_gather(tab: torch.Tensor, idx: torch.Tensor, mode: str = "table",
                group: int = 8):
    """out (n, L) from a 2-D float32 or bf16 table; idx (n, L) int32. "table":
    tab (TH, L), out[i, l] = tab[idx[i, l], l]; "tile": tab (n, L), rows in
    groups of ``group``; "lane": tab (n, L), out[i, l] = tab[i, idx[i, l]]."""
    if mode not in LANE_MODES:
        raise ValueError(f"mode must be one of {LANE_MODES}, got {mode!r}")
    if tab.dim() != 2 or tab.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tab must be 2-D float32 or bfloat16, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if idx.dim() != 2 or idx.dtype != torch.int32 or idx.shape[1] != tab.shape[1]:
        raise ValueError(f"idx must be (n, {tab.shape[1]}) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    n, L = idx.shape
    if mode != "table" and (tab.shape[0] != n or (mode == "tile" and n % group)):
        raise ValueError(f"mode {mode!r} takes tab of {n} rows (a multiple of "
                         f"group {group}), got {tuple(tab.shape)}")
    if not tab.is_cuda:
        return lane_gather_plain(tab, idx, mode, group)
    return _lane_launch(tab, idx, mode, group, lane_stage(tab, idx, mode))


def _lane_launch(tab, idx, mode, group, stage_tx):
    """A3 on the card, the table read from shared memory (``stage_tx`` lane
    vectors a block, see ``lane_stage_tx``) or through L1 (0)."""
    _check_cuda(tab, idx)
    n, L = idx.shape
    if n >= 2 ** 31 or tab.numel() >= 2 ** 31:
        raise ValueError("shape too large for the kernel")
    out = tab.new_empty((n, L))
    if n == 0 or L == 0:
        return out
    blocks = _stage_of(tab, n, mode)[2] if stage_tx else 0
    _raise(KERNEL.load("probe_lane_gather")(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, L, tab.shape[0],
        tab.element_size(), LANE_MODES.index(mode), group, stage_tx, blocks,
        raw_stream(tab)), "probe_lane_gather")
    KERNEL.count("lane_smem" if stage_tx else "lane")
    return out


# -------------------------------------------------------------------- A4

def ring_gather_plain(tab, idx, R):
    rows = tab.reshape(tab.shape[0], -1)[idx.long()].float()
    return rows.reshape(idx.shape[0] // R, -1).sum(dim=1)


def ring_gather(tab: torch.Tensor, idx: torch.Tensor, R: int, Q: int = 8,
                staged: bool = True):
    """(n / R,) float32: block b sums the bf16 rows idx[b*R : b*R+R] of tab
    (rows of a multiple of 16 bytes); Q rows in flight (2, 4, 8 or 16) when
    staged, else direct loads."""
    if tab.dtype != torch.bfloat16 or tab.dim() < 2:
        raise ValueError(f"tab must be (rows, ...) bfloat16, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    _check_rows_index(idx)
    if R <= 0 or idx.shape[0] % R:
        raise ValueError(f"R={R} must divide the {idx.shape[0]} indices")
    if not tab.is_cuda:
        return ring_gather_plain(tab, idx, R)
    _check_cuda(tab, idx)
    row_bytes = tab[0].numel() * 2
    if row_bytes % 16 or (staged and Q not in RING_DEPTHS) \
            or (staged and Q * row_bytes > SMEM_BYTES):
        raise ValueError(f"the kernel takes rows of a multiple of 16 bytes and "
                         f"Q in {RING_DEPTHS} fitting shared memory, got "
                         f"{row_bytes} B, Q={Q}")
    out = torch.empty(idx.shape[0] // R, dtype=torch.float32, device=tab.device)
    _raise(KERNEL.load("probe_ring_gather")(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), out.shape[0], R, Q,
        row_bytes, int(staged), raw_stream(tab)), "probe_ring_gather")
    KERNEL.count("ring" if staged else "direct")
    return out


# -------------------------------------------------------------------- A5

TRANSPOSE_KERNELS = ("tile", "tile4")      # probe_transpose's `kernel`
TRANSPOSE4_SHAPES = ((64, 16), (16, 128))   # (R, C) of transpose4_kernel
T4_THREADS = 256
T4_GROUPS = 2              # 32-block groups a warp of transpose4_kernel
T4_BLOCKS_PER_SM = 5       # its __launch_bounds__: 48 registers a thread
TILE_THREADS = 256


class TransposePlan(NamedTuple):
    """How ``transpose`` runs a shape: the kernel ("tile4": 4 x 4 register
    blocks, 16-byte loads and stores, at ``TRANSPOSE4_SHAPES``; "tile": a
    block a matrix at a time through a padded shared-memory tile), its
    blocks of ``threads``, its shared memory, and for "tile4" the 32-block
    groups (a 4 x 4 block a thread, ``T4_GROUPS`` groups a warp) and the
    waves of the card the grid takes at ``T4_BLOCKS_PER_SM`` blocks an
    SM."""
    kernel: str
    blocks: int
    threads: int
    smem_bytes: int
    groups: int = 0
    waves: int = 1


@functools.lru_cache(maxsize=None)
def transpose_plan(NB, R, C, aligned=True, sms=H100[0]):
    """The ``TransposePlan`` of NB (R, C) matrices on a card of ``sms``
    SMs, which ``transpose`` passes to ``probe_gather.cu::probe_transpose``;
    ``aligned``: both pointers on 16 bytes."""
    if (R, C) in TRANSPOSE4_SHAPES and aligned:
        groups = NB * (R * C // 16) // 32
        blocks = -(-groups // (T4_THREADS // 32 * T4_GROUPS))
        return TransposePlan("tile4", blocks, T4_THREADS, 0, groups,
                             -(-blocks // (sms * T4_BLOCKS_PER_SM)))
    return TransposePlan("tile", max(1, min(NB, sms * 8)), TILE_THREADS,
                         R * (C + 1) * 4)


def transpose_blocks(plan, NB, R, C):
    """What each block of a ``transpose_plan`` launch writes, in the
    kernel's order: a list a block of (matrix, first, end) ranges of the
    matrix's 4 x 4 blocks ("tile4") or whole matrices ((matrix, 0, 1),
    "tile": block b takes b, b + blocks, ...)."""
    if plan.kernel == "tile":
        return [[(m, 0, 1) for m in range(b, NB, plan.blocks)]
                for b in range(plan.blocks)]
    bpm = R * C // 16
    per_block = plan.threads // 32 * T4_GROUPS * 32
    out = []
    for b in range(plan.blocks):
        u0, u1 = b * per_block, min((b + 1) * per_block, plan.groups * 32)
        spans = []
        while u0 < u1:
            m, w = divmod(u0, bpm)
            end = min(bpm, w + u1 - u0)
            spans.append((m, w, end))
            u0 += end - w
        out.append(spans)
    return out


def transpose_plain(x):
    NB, R, C = x.shape
    perm = torch.arange(R * C, device=x.device).view(R, C).t().reshape(-1)
    return x.reshape(NB, R * C)[:, perm].reshape(NB, C, R)


def transpose(x: torch.Tensor):
    """(NB, R, C) float32 -> (NB, C, R), R * (C + 1) floats at most 48 KB,
    by the kernel ``transpose_plan`` names."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (NB, R, C) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    NB, R, C = x.shape
    if R * (C + 1) * 4 > 48 * 1024:
        raise ValueError(f"the kernel takes R * (C + 1) * 4 <= 48 KB, got "
                         f"{R}x{C}")
    if NB >= 2 ** 31:
        raise ValueError(f"the kernel takes fewer than 2**31 matrices, got "
                         f"{NB}")
    if not x.is_cuda:
        return transpose_plain(x)
    _check_cuda(x)
    out = torch.empty((NB, C, R), dtype=x.dtype, device=x.device)
    if NB == 0:
        return out
    plan = transpose_plan(NB, R, C, (x.data_ptr() | out.data_ptr()) % 16 == 0,
                          _card(x.get_device())[0])
    _raise(KERNEL.load("probe_transpose")(
        x.data_ptr(), out.data_ptr(), NB, R, C,
        TRANSPOSE_KERNELS.index(plan.kernel), plan.blocks, raw_stream(x)),
        "probe_transpose")
    KERNEL.count("transpose")
    return out


# ------------------------------------------------------------------ cases

# row widths of A1: (label, table dtype, elements a row)
ROW_WIDTHS = (("8 B mask quad", torch.bfloat16, 4),
              ("64 B texel", torch.bfloat16, 32),
              ("128 B row", torch.bfloat16, 64),
              ("256 B row", torch.bfloat16, 128),
              ("264 B unitable (66 f32)", torch.float32, 66),
              ("288 B unitable pad (72 f32)", torch.float32, 72),
              ("2 KB (8,128) bf16 tile", torch.bfloat16, 1024),
              ("4 KB (16,128) bf16 window row", torch.bfloat16, 2048))
# ragged widths of the check size (float32 elements a row): rows of 4, 12,
# 20 and 4,100 B, all of 4-byte units
RAGGED_WIDTHS = (1, 3, 5, 1025)
# table sizes of the sweep: in L2, and the main path's tables (PERF.md §3)
TABLE_BYTES = (("8 MB (in L2)", 8e6), ("101 MB (unirow)", 101e6),
               ("142 MB (tilewin masks)", 142e6),
               ("198 MB (tilewin features)", 198e6))


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _table(rows, width, dtype, device, g):
    shape = (rows, width) if isinstance(width, int) else (rows,) + width
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _index(n, hi, device, g, sort=False):
    idx = torch.randint(0, hi, (n,), generator=g, device=device,
                        dtype=torch.int32)
    return torch.sort(idx).values if sort else idx


def _nbytes(*ts):
    return float(sum(t.numel() * t.element_size() for t in ts))


def row_case(name, replaces, tab, idx, serial_rows=0, info=None):
    """A1 (A2 with ``serial_rows``) on ``row_plan``'s plan.
    ``sector_floor_ms``: the time of HBM's traffic when each row read costs
    whole 32-byte sectors (an 8-byte row one sector), beside the bound of
    the bytes the function needs."""
    n, row_bytes = idx.shape[0], tab[0].numel() * tab.element_size()
    out_bytes = n * row_bytes
    table_bytes = tab.numel() * tab.element_size()
    info = dict(info or {}, rows=n, row_bytes=row_bytes,
                table_bytes=table_bytes, fits_l2=table_bytes <= L2_BYTES,
                sector_floor_ms=(n * -(-row_bytes // 32) * 32 + out_bytes
                                 + _nbytes(idx)) / HBM_BYTES_PER_S * 1e3)
    if not serial_rows:
        p = row_plan(n, row_bytes, 16, _sms(tab))
        info.update(variant=p.variant, unit=p.unit, per_thread=p.units,
                    blocks=p.blocks)
    return Case(name, replaces, SOURCE,
                kernel=lambda: row_gather(tab, idx, serial_rows),
                plain=lambda: row_gather_plain(tab, idx),
                library=lambda: torch.index_select(tab, 0, idx),
                counter=(KERNEL, "serial" if serial_rows else "row"),
                nbytes=2.0 * out_bytes + _nbytes(idx), info=info)


def _sms(t):
    return _card(t.get_device() if t.is_cuda else None)[0]


def lane_case(name, replaces, tab, idx, mode="table", group=8, stage=None):
    """``stage`` (the lane vectors a block stages, 0 for L1) runs that design
    in place of the one ``lane_stage`` picks."""
    idx_long = idx.long()
    smem = (lane_stage(tab, idx, mode) if stage is None else stage) > 0
    kernel = (lambda: lane_gather(tab, idx, mode, group)) if stage is None \
        else (lambda: _lane_launch(tab, idx, mode, group, stage))
    return Case(name, replaces, SOURCE, kernel=kernel,
                plain=lambda: lane_gather_plain(tab, idx, mode, group),
                library=lambda: lane_gather_library(tab, idx_long, mode, group),
                counter=(KERNEL, "lane_smem" if smem else "lane"),
                # the table once (what the function needs of it is data
                # dependent; each lane's rows are read at most once), the
                # indices and the output
                nbytes=min(_nbytes(tab), _nbytes(idx) / 4 * tab.element_size())
                + _nbytes(idx) + idx.numel() * tab.element_size(),
                info={"mode": mode, "table": list(tab.shape),
                      "dtype": str(tab.dtype).replace("torch.", ""),
                      "n": idx.shape[0], "memory": "shared" if smem
                      else "L1", "table_bytes": _nbytes(tab)})


def ring_case(name, replaces, tab, idx, R, Q, staged):
    count = idx.shape[0] * tab[0].numel()
    return Case(name, replaces, SOURCE,
                kernel=lambda: ring_gather(tab, idx, R, Q, staged),
                plain=lambda: ring_gather_plain(tab, idx, R),
                counter=(KERNEL, "ring" if staged else "direct"),
                nbytes=idx.shape[0] * tab[0].numel() * 2.0 + _nbytes(idx)
                + idx.shape[0] // R * 4,
                flops=float(count),
                # float32 sums of R rows in another order: 1e-6 a summand
                rtol=1e-5, atol=1e-6 * count / (idx.shape[0] // R),
                info={"R": R, "Q": Q if staged else 0, "staged": staged,
                      "rows": idx.shape[0],
                      "row_bytes": tab[0].numel() * 2,
                      "table_bytes": _nbytes(tab)})


def transpose_case(name, replaces, x):
    plan = transpose_plan(*x.shape, x.data_ptr() % 16 == 0,
                          _card(x.get_device() if x.is_cuda else None)[0])
    return Case(name, replaces, SOURCE, kernel=lambda: transpose(x),
                plain=lambda: transpose_plain(x),
                library=lambda: x.transpose(1, 2).contiguous(),
                counter=(KERNEL, "transpose"), nbytes=2 * _nbytes(x),
                info={"shape": list(x.shape), "kernel": plan.kernel,
                      "blocks": plan.blocks})


def cases(device, size="main"):
    """The gather probes. ``size``: "check" (small shapes, every kernel
    path), "main" (each probe at its own main size, chip_smoke.py) or
    "sweep" (the module CLI: row widths x table sizes x index order, lane
    gathers by table height, ring depths)."""
    small = size == "check"
    g = _gen(device, 0)
    # A1 row widths: one table above L2 (198 MB), random indices; the sweep
    # adds every table size and sorted indices
    tables = TABLE_BYTES if size == "sweep" else TABLE_BYTES[-1:]
    for label, dtype, width in ROW_WIDTHS:
        row_bytes = width * torch.tensor([], dtype=dtype).element_size()
        for t_label, t_bytes in tables:
            rows = 257 if small else int(t_bytes // row_bytes)
            n = 1000 if small else int(64e6 // row_bytes)
            tab = _table(rows, width, dtype, device, g)
            for sort in ((False, True) if size == "sweep" else (False,)):
                idx = _index(n, rows, device, g, sort)
                name = (f"A1 row gather, {label}, {t_label}, "
                        f"{'sorted' if sort else 'random'}")
                info = {"order": "sorted" if sort else "random"}
                yield row_case(name, "tools/bench_unitable.py:59", tab, idx,
                               info=info)
            del tab
    if small:
        for width in RAGGED_WIDTHS:
            tab = _table(257, width, torch.float32, device, g)
            yield row_case(f"A1 row gather, ragged {4 * width} B",
                           "tools/bench_unitable.py:59", tab,
                           _index(1000, 257, device, g))
    # the probes' own row gathers
    for name, replaces, rows, width, dtype, n in (
            ("A1 kern_take (8192,128) f32, 1024 rows",
             "tools/bench_unitable.py:59", 8192, 128, torch.float32, 1024),
            ("A1 take2 b) (4096,128) bf16 by 4096 rows",
             "tools/bench_pallas_take2.py:30", 4096, 128, torch.bfloat16, 4096),
            ("A1 gather_sub (512,256) f32, 1024 rows",
             "tools/probe_mosaic_caps.py:67", 512, 256, torch.float32, 1024)):
        tab = _table(rows, width, dtype, device, g)
        idx = _index(n, rows, device, g)
        yield row_case(name, replaces, tab, idx)
    tab = _table(8192, 128, torch.float32, device, g)
    idx = _index(100 if small else 1024, 8192, device, g)
    for k in ((7, 1024) if small else
              ((1, 8, 64, 1024) if size == "sweep" else (1024,))):
        yield row_case(f"A2 kern_dslice (8192,128) f32, {idx.shape[0]} rows, "
                       f"{k} a warp", "tools/bench_unitable.py:73", tab, idx,
                       serial_rows=k, info={"rows_per_warp": k})
    # A3: bench_gather's per-lane gather by table height (a block stages
    # whole 128-lane rows up to TH 454 f32 / 908 bf16, column blocks up to
    # 1,816 / 3,632; the small size crosses both limits); the sweep also
    # times the design not picked where the columns fit
    L = 128
    n = 1000 if small else 262144
    ths = ((96, torch.float32), (768, torch.bfloat16), (3000, torch.float32)) \
        if small else \
        [(th, dt) for dt in (torch.float32, torch.bfloat16)
         for th in (384, 512, 768, 2048, 8192, 32768, 196608)] \
        if size == "sweep" else \
        ((512, torch.float32), (196608, torch.float32), (768, torch.bfloat16))
    for th, dt in ths:
        tab = _table(th, L, dt, device, g)
        idx = torch.randint(0, th, (n, L), generator=g, device=device,
                            dtype=torch.int32)
        name = f"A3 dg_kernel TH={th} {str(dt).replace('torch.', '')}"
        yield lane_case(name, "tools/bench_gather.py:155", tab, idx)
        tx = lane_stage_tx(tab)
        if size == "sweep" and tx:
            other = 0 if lane_stage(tab, idx) else tx
            yield lane_case(name + (", through L1" if other == 0 else
                                    ", in shared memory"),
                            "tools/bench_gather.py:155", tab, idx,
                            stage=other)
    tab = _table(512, 128, torch.float32, device, g)
    idx = torch.randint(0, 512, (512, 128), generator=g, device=device,
                        dtype=torch.int32)
    yield lane_case("A3 dg_kernel (512,128) f32", "tools/bench_dyngather2.py:176",
                    tab, idx)
    R_ = 4096 if not small else 256
    tab = _table(R_, 128, torch.bfloat16, device, g)
    rows_idx = _index(R_, R_, device, g)
    yield lane_case("A3 take2 a) (4096,128) bf16, idx (R,L)",
                    "tools/bench_pallas_take2.py:30", tab,
                    rows_idx[:, None].expand(R_, 128).contiguous())
    tab = _table(512 * 8 if not small else 64, 128, torch.bfloat16, device, g)
    yield lane_case("A3 take2 c) sublane in (512,8,128) bf16 tiles",
                    "tools/bench_pallas_take2.py:30", tab,
                    torch.randint(0, 8, tuple(tab.shape), generator=g,
                                  device=device, dtype=torch.int32),
                    mode="tile", group=8)
    tab = _table(R_, 128, torch.bfloat16, device, g)
    yield lane_case("A3 take2 d) lane (4096,128) bf16",
                    "tools/bench_pallas_take2.py:30", tab,
                    torch.randint(0, 128, (R_, 128), generator=g, device=device,
                                  dtype=torch.int32), mode="lane")
    tab = _table(128, 256, torch.float32, device, g)
    yield lane_case("A3 gather_lane (128,256) f32, (8,256) idx",
                    "tools/probe_mosaic_caps.py:86", tab,
                    torch.randint(0, 128, (8, 256), generator=g, device=device,
                                  dtype=torch.int32))
    # A4: dma_kernel's shape: 147,456 rows of 4 KB from 48,387 (198 MB),
    # 256 a block, 8 in flight; against direct loads and A1 on the same rows
    nrows, ng, R = (300, 2048, 64) if small else (48387, 147456, 256)
    tab = _table(nrows, (16, 128), torch.bfloat16, device, g)
    idx = _index(ng, nrows, device, g)
    for Q in ((2, 8, 16) if small else
              (RING_DEPTHS if size == "sweep" else (8,))):
        yield ring_case(f"A4 dma_kernel ring R={R} Q={Q}, 4 KB rows",
                        "tools/probe_kernel_dma.py:114", tab, idx, R, Q, True)
    yield ring_case(f"A4 direct loads R={R}, 4 KB rows",
                    "tools/probe_kernel_dma.py:114", tab, idx, R, 0, False)
    yield row_case("A1 on A4's rows, 4 KB rows", "tools/probe_kernel_dma.py:114",
                   tab, idx)
    if size == "sweep":
        for R2 in (64, 1024):
            yield ring_case(f"A4 dma_kernel ring R={R2} Q=8, 4 KB rows",
                            "tools/probe_kernel_dma.py:114", tab, idx, R2, 8,
                            True)
            yield ring_case(f"A4 direct loads R={R2}, 4 KB rows",
                            "tools/probe_kernel_dma.py:114", tab, idx, R2, 0,
                            False)
        small_tab = _table(int(8e6 // 4096), (16, 128), torch.bfloat16, device, g)
        small_idx = _index(ng, small_tab.shape[0], device, g)
        yield ring_case(f"A4 dma_kernel ring R={R} Q=8, 8 MB table",
                        "tools/probe_kernel_dma.py:114", small_tab, small_idx,
                        R, 8, True)
        yield ring_case(f"A4 direct loads R={R}, 8 MB table",
                        "tools/probe_kernel_dma.py:114", small_tab, small_idx,
                        R, 0, False)
    del tab, idx
    # A5: relay_kernel's 192 blocks x 12 relayouts of (64, 16), and swapT;
    # "check" adds shapes of the shared-memory tile kernel
    nb = 37 if small else 192 * 12
    shapes = [("A5 relay (64,16) -> (16,64)", "tools/probe_kernel_dma.py:144",
               (nb, 64, 16)),
              ("A5 swapT (16,128) -> (128,16)",
               "tools/probe_mosaic_coord_ops.py:69", (nb, 16, 128))]
    if small:
        shapes += [(f"A5 other shape {r}x{c} -> {c}x{r}",
                    "tools/probe_kernel_dma.py:144", (nb, r, c))
                   for r, c in ((3, 5), (48, 63))]
    for name, replaces, shape in shapes:
        yield transpose_case(name, replaces,
                             torch.randn(shape, generator=g, device=device))


def main(argv=None):
    return run_cli(cases, argv, __doc__)


if __name__ == "__main__":
    main()
