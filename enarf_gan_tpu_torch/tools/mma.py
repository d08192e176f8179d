"""Family B of the probes: tensor-core gathers and products
(``csrc/probe_mma.cu``).

* ``onehot_gather`` (B1): per sample two local rows ``loc`` and weights
  ``w``; out[s] = bf16(weighted one-hot row) @ slab, the slab being the whole
  (WIN, 128) bf16 table ("static") or WIN rows from a 512-aligned base taken
  from each group's first row ("dynamic"); on the tensor cores.
  ``direct_gather`` is the same function read straight from the two rows.
* ``tile_gather`` (B2): blocks of 512 samples, one row each from the
  512-row tile the block's ``tile`` entry names.
* ``gemm`` (B3): (batch, M, K) @ (K, 128) or (batch, K, 128), bf16 in,
  float32 out; library ``torch.matmul`` (bf16 out).

The plain twins compute the same numbers in float32 from the bf16 values
(the one-hot weights rounded to bf16 as the TPU kernel rounds them).

    python -m enarf_gan_tpu_torch.tools.mma [--device cpu]
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.tools.timing import BF16_FLOPS, Case, run_cli

SOURCE = "enarf_gan_tpu_torch/csrc/probe_mma.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = KernelLibrary(
    "probe_mma", "probe_onehot_gather", [_P] * 5 + [_I] * 5 + [_P],
    keys=("onehot_static", "onehot_dynamic", "tile", "direct", "gemm"),
    symbols={"probe_direct_gather": [_P] * 4 + [_I] * 5 + [_P],
             "probe_gemm": [_P] * 3 + [_I] * 4 + [_P]})
N = 128                      # columns of every table and output
WINDOW_MODES = ("static", "dynamic")
BASE_ALIGN = 512
TILE = 512


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
    if G <= 0 or S % G or WIN > tab.shape[0] or \
            (mode == "static" and WIN != tab.shape[0]):
        raise ValueError(f"G={G} must divide S={S}; WIN={WIN} must fit the "
                         f"table (and be its height for a static window)")


def onehot_gather(loc, w, tab, G, WIN, mode="static"):
    """(S, 128) float32: the weighted one-hot rows of each sample times its
    group's (WIN, 128) slab, on the tensor cores."""
    _check_b1(loc, w, tab, G, WIN, mode)
    if not tab.is_cuda:
        return onehot_gather_plain(loc, w, tab, G, WIN, mode)
    _check_cuda(loc, w, tab)
    S = loc.shape[0]
    if G % 64 or WIN % 64 or S >= 2 ** 31:
        raise ValueError(f"the kernel takes G and WIN multiples of 64, got "
                         f"G={G} WIN={WIN}")
    out = torch.empty((S, N), dtype=torch.float32, device=tab.device)
    _raise(KERNEL.load()(loc.data_ptr(), w.data_ptr(), loc.data_ptr(),
                         tab.data_ptr(), out.data_ptr(), S, G, WIN,
                         tab.shape[0], WINDOW_MODES.index(mode),
                         _stream(tab)), "probe_onehot_gather")
    KERNEL.count(f"onehot_{mode}")
    return out


def direct_gather(loc, w, tab, G, WIN, mode="static"):
    """``onehot_gather``'s function from the two rows of each sample."""
    _check_b1(loc, w, tab, G, WIN, mode)
    if not tab.is_cuda:
        return onehot_gather_plain(loc, w, tab, G, WIN, mode)
    _check_cuda(loc, w, tab)
    S = loc.shape[0]
    out = torch.empty((S, N), dtype=torch.float32, device=tab.device)
    _raise(KERNEL.load("probe_direct_gather")(
        loc.data_ptr(), w.data_ptr(), tab.data_ptr(), out.data_ptr(), S, G,
        WIN, tab.shape[0], int(mode == "dynamic"), _stream(tab)),
        "probe_direct_gather")
    KERNEL.count("direct")
    return out


# ------------------------------------------------------------------- B2

def tile_gather_plain(tile, loc, tab):
    rows = tile.long().repeat_interleave(loc.shape[0] // tile.shape[0]) * TILE
    return tab[rows + loc.long()].float()


def tile_gather(tile, loc, tab):
    """(S, 128) float32: sample s of block b (512 a block) is row loc[s] of
    the 512-row tile tile[b] of tab, as a one-hot product."""
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
    out = torch.empty((S, N), dtype=torch.float32, device=tab.device)
    _raise(KERNEL.load()(loc.data_ptr(), loc.data_ptr(), tile.data_ptr(),
                         tab.data_ptr(), out.data_ptr(), S, TILE, TILE,
                         tab.shape[0], 2, _stream(tab)), "probe_onehot_gather")
    KERNEL.count("tile")
    return out


# ------------------------------------------------------------------- B3

def gemm_plain(a, b):
    return torch.matmul(a.float(), b.float())


def gemm(a, b):
    """(batch, M, K) bf16 @ (K, 128) or (batch, K, 128) bf16 -> (batch, M,
    128) float32."""
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
    if M % 16 or K % 16 or batch > 65535:
        raise ValueError(f"the kernel takes M and K multiples of 16 and at "
                         f"most 65535 batch elements, got {tuple(a.shape)}")
    out = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    _raise(KERNEL.load("probe_gemm")(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), batch, M, K,
                                     int(b.dim() == 3), _stream(a)),
           "probe_gemm")
    KERNEL.count("gemm")
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


def b1_case(S, G, WIN, mode, device, g, direct=False):
    loc, w, tab = b1_inputs(S, G, WIN, mode, device, g)
    kern = direct_gather if direct else onehot_gather
    tab_f = tab.float()
    base = window_bases(loc, G, WIN, tab.shape[0], mode)
    j, wb = onehot_weights(loc, w, base, WIN)
    gl = base[:, None] + j
    rows_needed = int(torch.unique(gl).numel())   # the rows the function reads
    return Case(
        f"B1 {'direct two-row gather' if direct else 'one-hot gather'} "
        f"{mode} G={G} WIN={WIN}", "tools/bench_pallas_prims.py:73", SOURCE,
        kernel=lambda: kern(loc, w, tab, G, WIN, mode),
        plain=lambda: onehot_gather_plain(loc, w, tab, G, WIN, mode),
        # one PyTorch call of the same sums: embedding_bag over float32 rows
        library=lambda: F.embedding_bag(gl, tab_f, mode="sum",
                                        per_sample_weights=wb),
        counter=(KERNEL, "direct" if direct else f"onehot_{mode}"),
        nbytes=_nbytes(loc, w) + rows_needed * N * 2.0 + S * N * 4.0,
        flops=0.0 if direct else float(S) * WIN * N * 2, rate=BF16_FLOPS,
        # the same bf16 products, summed in float32 in another order
        rtol=1e-6, atol=1e-6,
        info={"S": S, "G": G, "WIN": WIN, "window": mode})


def b2_case(n_blocks, device, g):
    n_rows = 196608
    tile = torch.randint(0, n_rows // TILE, (n_blocks,), generator=g,
                         device=device, dtype=torch.int32)
    loc = torch.randint(0, TILE, (n_blocks * TILE,), generator=g,
                        device=device, dtype=torch.int32)
    tab = torch.randn((n_rows, N), generator=g, device=device).to(torch.bfloat16)
    rows = tile.long().repeat_interleave(TILE) * TILE + loc.long()
    S = n_blocks * TILE
    return Case(
        f"B2 sorted-tile one-hot gather, {n_blocks} blocks of {TILE}",
        "tools/bench_dyngather2.py:144", SOURCE,
        kernel=lambda: tile_gather(tile, loc, tab),
        plain=lambda: tile_gather_plain(tile, loc, tab),
        library=lambda: torch.index_select(tab, 0, rows),
        counter=(KERNEL, "tile"),
        nbytes=_nbytes(tile, loc) + min(n_blocks * TILE * N * 2.0,
                                        _nbytes(tab)) + S * N * 4.0,
        flops=float(S) * TILE * N * 2, rate=BF16_FLOPS, rtol=0, atol=0,
        info={"S": S, "blocks": n_blocks, "tile": TILE,
              "also_replaces": "tools/bench_dyngather2.py:115"})


def b3_case(name, replaces, batch, M, K, b_batched, device, g):
    a = torch.randn((batch, M, K), generator=g, device=device).to(torch.bfloat16)
    b = torch.randn(((batch,) if b_batched else ()) + (K, N), generator=g,
                    device=device).to(torch.bfloat16)
    return Case(
        name, replaces, SOURCE, kernel=lambda: gemm(a, b),
        plain=lambda: gemm_plain(a, b), library=lambda: torch.matmul(a, b),
        counter=(KERNEL, "gemm"),
        nbytes=_nbytes(a, b) + batch * M * N * 4.0,
        flops=2.0 * batch * M * K * N, rate=BF16_FLOPS,
        # K-long float32 sums of exact bf16 products in another order
        rtol=1e-4, atol=1e-4 * K ** 0.5,
        info={"batch": batch, "M": M, "K": K, "N": N,
              "b": "per batch element" if b_batched else "shared"})


B1_STATIC = ((512, 768), (256, 768), (512, 1536), (1024, 768), (512, 512))
B1_DYNAMIC = ((512, 768), (1024, 1024))
B3_CHAINS = ((1024, 512, 768), (1024, 512, 256), (256, 1024, 1024))
B3_BATCHED = (("B3 dot_batched (16,128,64) @ (16,64,128)",
               "tools/probe_mosaic_caps.py:98", 16, 128, 64),
              ("B3 dot_kshape (128,32,16) @ (128,16,128)",
               "tools/bisect_kernel_ops.py:95", 128, 32, 16),
              ("B3 bdiag_dot per unit (256,32,16) @ (256,16,128)",
               "tools/bisect_hat_kernel.py:99", 256, 32, 16))


def cases(device, size="main"):
    """B1 at bench_pallas_prims.py's (G, WIN) list (S = 1,179,648) with the
    direct gather beside it, B2 at 8192 blocks, B3 at the chain and batched
    shapes. "check" shrinks S, blocks and batches; "sweep" adds the direct
    gather at every B1 shape."""
    small = size == "check"
    g = torch.Generator(device=device).manual_seed(1)
    S = 1_179_648 if not small else None
    for mode, shapes in (("static", B1_STATIC), ("dynamic", B1_DYNAMIC)):
        for G, WIN in shapes:
            s = 2 * G if small else S // G * G
            yield b1_case(s, G, WIN, mode, device, g)
            if size == "sweep" or (G, WIN) == (512, 768):
                yield b1_case(s, G, WIN, mode, device, g, direct=True)
    yield b2_case(3 if small else 8192, device, g)
    for n, M, K in B3_CHAINS:
        n = 2 if small else n
        yield b3_case(f"B3 chain ({M}x{K}) @ ({K}x{N}) x{n}",
                      "tools/bench_pallas_prims.py:105", n, M, K, False,
                      device, g)
    for name, replaces, batch, M, K in B3_BATCHED:
        yield b3_case(name, replaces, 3 if small else batch, M, K, True,
                      device, g)


def main(argv=None):
    return run_cli(cases, argv, __doc__)


if __name__ == "__main__":
    main()
