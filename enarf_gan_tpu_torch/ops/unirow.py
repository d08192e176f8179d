"""Unirow tri-plane sampling: one fused read per (point, candidate, plane)
(port of ``enarf_gan_tpu/ops/unirow.py``), and the float32 candidate sampler
(the port of ``enarf_gan_tpu/ops/quadtable.py``'s).

Three layouts of the same planes:

* ``pack_unirow``, the JAX package's layout: one 256-lane bf16 row per
  sample cell,

      [ A_f | B_f | C_f | D_f | A_m(32) | B_m(32) | C_m(32) | D_m(32) ]

  A..D are the 2×2 bilinear texel quad of the cell; each mask corner block
  holds that texel's mask logit for every bone (bone k at lane k, K <= 32).
  Every texel is stored four times (it is a corner of four cells): 101 MB
  an image at 256² planes. ``gather_combine_plain`` combines it, the plain
  twin of the JAX package's ``jnp.take`` + ``_combine_xla``.
* ``pack_texels``, the layout kernels 1 and 1b read (and kernels 2, 2b and
  3, ``ops/tilewin.py``): the one-texel zero-padded planes channels-last,
  (B, 3, H+2, W+2, 64) bf16, one 128-byte line a texel holding [32 feature
  lanes | 32 mask lanes, bone k at lane 32+k]. 25.6 MB an image at 256²
  planes, so an image's table stays in the H100's 50 MB L2. Corner q of
  cell (t, s) is texel (t + q//2, s + q%2), so the rows of
  ``candidate_rows`` address both layouts. (In float32 the same layout is
  51.1 MB an image; the tests and the tools keep it as the earlier float32
  design's yardstick, and no kernel reads it.)
* ``pack_texels_f32``, the layout kernels 1f and 1bf read: a
  ``Float32Texels`` of a feature table (B, 3, H+2, W+2, 32) float32, one
  128-byte line a texel (25.6 MB an image at 256²), and bone-major mask
  planes (B, 3, K, H+2, W+2) float32 (18.4 MB at K = 23), both with the
  zero ring: 44 MB together, in the L2. A cell's corners (t, s) and
  (t, s+1) are neighbouring floats of a mask plane, as in the JAX package's
  float32 mask table (row (bone*3 + plane)*(H+1)*(W+1) + cell).

``unirow_combine`` gathers a candidate's four texels on each plane of the
bf16 table and combines them: bilinear feature sum over planes, the
candidate bone's mask logit, the product of sigmoids over planes, and the
candidate-weighted feature sum. On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/unirow_combine.cu`` (kernel 1, which
replaces the Pallas kernel ``_combine_kernel``) and, for the gradient,
``csrc/unirow_combine_bwd.cu`` (kernel 1b, which replaces its XLA VJP)
through a ``torch.autograd.Function``; on a CPU tensor it runs
``gather_combine_texels_plain``, which autograd differentiates. Gradients
reach the texel table (and through ``pack_texels`` the planes) and ``wq4``
(and through ``candidate_rows`` the candidate positions).

``sample_f32`` computes the same function for float32 planes from the
candidates' positions: each plane's cell and corner weights
(``_quad_cells_weights``'s expressions, rounded as PyTorch rounds them),
the gathers and the combine. On a CUDA tensor it launches kernel 1f
(``csrc/unirow_combine_f32.cu``) and, for the gradient, kernel 1bf
(``csrc/unirow_combine_bwd_f32.cu``), which return the gradients of both
tables and of the positions; they replace XLA's gathers, combine and
autodiff in the JAX package's float32 sampler
``ops/quadtable.py::sample_candidates_quadtable``. On a CPU tensor it runs
``sample_f32_plain``, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.ops.activation import straight_through_clamp
from enarf_gan_tpu_torch.ops.quadtable import (_quad_cells_weights,
                                               quad_pack_corners)

MASK_BLOCK = 32          # lanes per mask corner block (bones 0..K-1, K<=32)
FEAT_BLOCK = 32          # feature lanes of a texel (F <= 32, zeros beyond F)
TEXEL_WIDTH = FEAT_BLOCK + MASK_BLOCK
KERNEL_FEAT_DIM = 32     # the kernels take F = 32 (a texel's full feature half)


def row_width(feat_dim: int) -> int:
    return 4 * feat_dim + 4 * MASK_BLOCK


def _split_planes(tri_plane_feature: torch.Tensor, feat_dim: int,
                  num_bone: int):
    """(B, (F+K)*3, H, W) → feature (B, 3, H, W, F) and mask (B, 3, H, W, K)
    planes, channels last. Input channels: F*3 feature planes, then K*3
    per-bone mask planes."""
    B, C3, H, W = tri_plane_feature.shape
    F_, K = feat_dim, num_bone
    if C3 != (F_ + K) * 3 or K > MASK_BLOCK:
        raise ValueError(f"planes of {C3} channels do not hold F={F_}, "
                         f"K={K} (K <= {MASK_BLOCK})")
    feat = tri_plane_feature[:, :F_ * 3].reshape(B, 3, F_, H, W) \
        .permute(0, 1, 3, 4, 2)
    mask = tri_plane_feature[:, F_ * 3:].reshape(B, K, 3, H, W) \
        .permute(0, 2, 3, 4, 1)
    return feat, mask


def pack_unirow(tri_plane_feature: torch.Tensor, feat_dim: int,
                num_bone: int, dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """(B, (F+K)*3, H, W) planes → (B, 3*(H+1)*(W+1), 4F+128) table of
    ``dtype`` (bf16, as the JAX package packs it).

    Row r = p*(H+1)*(W+1) + t*(W+1) + s for plane p, cell (t, s).
    """
    B = tri_plane_feature.shape[0]
    K = num_bone
    feat, mask = _split_planes(tri_plane_feature, feat_dim, num_bone)
    fq = quad_pack_corners(feat)                               # (…, 4F)
    mq = quad_pack_corners(mask).reshape(B, 3, -1, 4, K)
    mq = F.pad(mq, (0, MASK_BLOCK - K)).reshape(B, 3, fq.shape[2],
                                                 4 * MASK_BLOCK)
    table = torch.cat([fq, mq], dim=-1).to(dtype)
    return table.reshape(B, 3 * fq.shape[2], row_width(feat_dim))


def pack_texels(tri_plane_feature: torch.Tensor, feat_dim: int,
                num_bone: int, dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """(B, (F+K)*3, H, W) planes → (B, 3, H+2, W+2, 64) texel table of
    ``dtype``: the planes with a one-texel ring of zeros (grid_sample's
    zeros padding), channels last, lanes [feature (F, zeros to 32) | mask
    (bone k at lane 32+k, zeros to 32)]. Holds the values of the texels of
    ``pack_unirow`` (each rounded once to ``dtype``), each once; autograd's
    backward is a slice and permute of the texel gradient. Kernels 1 and 1b
    take it in bf16; float32 planes are packed by ``pack_texels_f32``."""
    if feat_dim > FEAT_BLOCK:
        raise ValueError(f"a texel holds F <= {FEAT_BLOCK} feature channels, "
                         f"got F={feat_dim}")
    feat, mask = _split_planes(tri_plane_feature, feat_dim, num_bone)
    tex = torch.cat([F.pad(feat.to(dtype), (0, FEAT_BLOCK - feat_dim)),
                     F.pad(mask.to(dtype), (0, MASK_BLOCK - num_bone))],
                    dim=-1)
    return F.pad(tex, (0, 0, 1, 1, 1, 1))


class Float32Texels(NamedTuple):
    """The float32 sampler's tables (``pack_texels_f32``), both with the
    one-texel ring of zeros."""
    feature: torch.Tensor   # (B, 3, H+2, W+2, 32): F channels, zeros to 32
    mask: torch.Tensor      # (B, 3, K, H+2, W+2): bone-major mask planes

    @property
    def dtype(self) -> torch.dtype:
        return self.feature.dtype


def pack_texels_f32(tri_plane_feature: torch.Tensor, feat_dim: int,
                    num_bone: int) -> Float32Texels:
    """(B, (F+K)*3, H, W) float32 planes → the float32 sampler's tables:
    the feature planes channels-last (B, 3, H+2, W+2, 32), zeros beyond F,
    and the mask planes bone-major (B, 3, K, H+2, W+2), each with a
    one-texel ring of zeros (grid_sample's zeros padding). They hold the
    values of ``pack_texels(..., float32)``'s feature half and mask lanes,
    without the 32 - K lanes of padding a texel. A pad and a permute:
    autograd's backward carries the tables' gradients to the planes."""
    if feat_dim > FEAT_BLOCK:
        raise ValueError(f"a texel holds F <= {FEAT_BLOCK} feature channels, "
                         f"got F={feat_dim}")
    B, C3, H, W = tri_plane_feature.shape
    if C3 != (feat_dim + num_bone) * 3 or num_bone > MASK_BLOCK:
        raise ValueError(f"planes of {C3} channels do not hold F={feat_dim}, "
                         f"K={num_bone} (K <= {MASK_BLOCK})")
    planes = tri_plane_feature.float()
    feat = planes[:, :feat_dim * 3].reshape(B, 3, feat_dim, H, W) \
        .permute(0, 1, 3, 4, 2)                            # (B, 3, H, W, F)
    mask = planes[:, feat_dim * 3:].reshape(B, num_bone, 3, H, W) \
        .transpose(1, 2)                                   # (B, 3, K, H, W)
    return Float32Texels(
        F.pad(feat, (0, FEAT_BLOCK - feat_dim, 1, 1, 1, 1)).contiguous(),
        F.pad(mask, (1, 1, 1, 1)).contiguous())


def gather_combine_plain(table, rows, wq4, cand_idx, valid, feat_dim: int,
                         clamp_mask: bool):
    """Plain PyTorch gather + combine on the quad-row table of
    ``pack_unirow`` (the JAX layout; the kernels read ``pack_texels``).

    Same results as ``gather_combine_texels_plain``. Materialises the
    gathered feature lanes (B, 3, M, n, 4F) and computes in float32, as the
    TPU kernel does (the JAX ``_combine_xla`` forms the feature products in
    bf16). Under autograd it gathers from a float32 copy of the table, so
    the table gradient accumulates in float32.
    """
    F_ = feat_dim
    if torch.is_grad_enabled() and table.requires_grad:
        table = table.float()
    B, R, RW = table.shape
    flat = rows.long() + (torch.arange(B, device=rows.device) * R).view(B, 1, 1, 1)
    tab = table.reshape(B * R, RW)
    wq = wq4.movedim(1, -1)                                    # (B, 3, M, n, 4)
    # the feature lanes and the candidates' mask logits are gathered apart,
    # and nothing gathered is sliced: autograd would zero-fill a gradient of
    # the gathered rows' size for every slice
    fq = tab[:, :4 * F_][flat].unflatten(-1, (4, F_))          # (…, 4, F)
    lane = flat * RW + 4 * F_ + cand_idx.long()[:, None]       # (B, 3, M, n)
    quad = MASK_BLOCK * torch.arange(4, device=rows.device)
    mq = tab.reshape(-1)[lane[..., None] + quad]               # (…, 4)
    return _combine(fq, mq, wq, valid, clamp_mask)


def _combine(fq, mq, wq, valid, clamp_mask):
    """The combine on gathered corners: feature lanes fq (B, 3, M, n, 4, F),
    the candidate's mask logits mq (B, 3, M, n, 4), weights wq (…, 4)."""
    feat = (fq.float() * wq[..., None]).sum(dim=-2).sum(dim=1)  # (B, M, n, F)
    logit = (mq.float() * wq).sum(dim=-1)                      # (B, 3, M, n)
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_wn = torch.sigmoid(logit).prod(dim=1)                 # (B, M, n)
    feature = torch.einsum("bmnf,bmn->bfn", feat, cand_wn * valid)
    return feature, cand_wn


def texel_corners(rows: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The texel (within its batch item's table, planes flattened) of
    corner A of each row's cell, int64; corner q is texel
    + (q//2)*(W+2) + q%2."""
    cells = (H + 1) * (W + 1)
    r = rows.long()
    p, c = r // cells, r % cells
    t, s = c // (W + 1), c % (W + 1)
    return (p * (H + 2) + t) * (W + 2) + s


def gather_combine_texels_plain(texels, rows, wq4, cand_idx, valid,
                                feat_dim: int, clamp_mask: bool):
    """Plain PyTorch gather + combine on the texel table (the twin of the
    kernels): same arguments and results as ``unirow_combine``. Gathers the
    four corner texels of each (plane, candidate, point) and computes in
    float32, in the order of ``gather_combine_plain``. Under autograd it
    gathers from a float32 copy of the table, so the texel gradient
    accumulates in float32, as kernel 1b's does."""
    F_ = feat_dim
    if torch.is_grad_enabled() and texels.requires_grad:
        texels = texels.float()
    B, _, Hp, Wp, TW = texels.shape
    per_b = 3 * Hp * Wp
    a = texel_corners(rows, Hp - 2, Wp - 2) \
        + (torch.arange(B, device=rows.device) * per_b).view(B, 1, 1, 1)
    corners = a[..., None] + torch.tensor([0, 1, Wp, Wp + 1],
                                          device=rows.device)  # (…, 4)
    tab = texels.reshape(B * per_b, TW)
    fq = tab[:, :F_][corners]                                  # (…, 4, F)
    lane = corners * TW + FEAT_BLOCK + cand_idx.long()[:, None, :, :, None]
    mq = tab.reshape(-1)[lane]                                 # (…, 4)
    return _combine(fq, mq, wq4.movedim(1, -1), valid, clamp_mask)


_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
F32_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
F32_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
# one library a source and a launch count each: kernels 1 and 1b on bf16
# texels, 1f and 1bf on the float32 tables
KERNEL = KernelLibrary("unirow_combine", "unirow_combine_bf16", _FWD_ARGS)
KERNEL_BWD = KernelLibrary("unirow_combine_bwd", "unirow_combine_bwd_bf16",
                           _BWD_ARGS)
KERNEL_F32 = KernelLibrary("unirow_combine_f32", "unirow_combine_f32",
                           F32_FWD_ARGS)
KERNEL_BWD_F32 = KernelLibrary("unirow_combine_bwd_f32",
                               "unirow_combine_bwd_f32", F32_BWD_ARGS)
TEXEL_DTYPES = (torch.bfloat16, torch.float32)     # the plain twin's


def _check_inputs(texels, rows, wq4, cand_idx, valid):
    if texels.dim() != 5 or texels.dtype not in TEXEL_DTYPES \
            or texels.shape[1] != 3 or texels.shape[4] != TEXEL_WIDTH:
        raise ValueError(f"the texel table must be (B, 3, H+2, W+2, "
                         f"{TEXEL_WIDTH}) bfloat16 or float32 (pack_texels), "
                         f"got {tuple(texels.shape)} {texels.dtype}")
    B = texels.shape[0]
    if rows.dim() != 4 or rows.shape[:2] != (B, 3):
        raise ValueError(f"rows must be (B, 3, M, n), got {tuple(rows.shape)}")
    M, n = rows.shape[2:]
    want = {"rows": (rows, (B, 3, M, n), torch.int32),
            "wq4": (wq4, (B, 4, 3, M, n), torch.float32),
            "cand_idx": (cand_idx, (B, M, n), torch.int32),
            "valid": (valid, (B, M, n), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != texels.device:
            raise ValueError(f"{name} is on {t.device}, texels on "
                             f"{texels.device}")
    if torch.is_grad_enabled() and valid.requires_grad:
        raise ValueError("valid takes no gradient (it comes from a bool); "
                         "detach it")


def _kernel_shape(texels, rows, feat_dim):
    """(B, H, W, M, n) for the kernels, or raise on what they do not take."""
    if feat_dim != KERNEL_FEAT_DIM:
        raise ValueError(f"the CUDA kernel takes feat_dim "
                         f"{KERNEL_FEAT_DIM}, got {feat_dim}")
    if texels.dtype != torch.bfloat16:
        raise ValueError("kernels 1 and 1b take a bf16 texel table; float32 "
                         "planes are sampled from pack_texels_f32's tables "
                         "by sample_f32 (kernels 1f and 1bf)")
    B, _, Hp, Wp, _ = texels.shape
    M, n = rows.shape[2:]
    if 3 * (Hp - 1) * (Wp - 1) >= 2 ** 31 or M * n >= 2 ** 31 or B > 65535:
        raise ValueError(f"shape too large for the kernel: B={B} "
                         f"H={Hp - 2} W={Wp - 2} M={M} n={n}")
    return B, Hp - 2, Wp - 2, M, n


def _launch_kernel(texels, rows, wq4, cand_idx, valid, feat_dim, clamp_mask):
    """Kernel 1: feature (B, F, n), cand_w (B, M, n)."""
    B, H, W, M, n = _kernel_shape(texels, rows, feat_dim)
    feature = torch.empty((B, feat_dim, n), dtype=torch.float32,
                          device=texels.device)
    cand_w = torch.empty((B, M, n), dtype=torch.float32, device=texels.device)
    if n == 0:
        return feature, cand_w
    kernel = KERNEL
    fn = kernel.load()
    stream = torch.cuda.current_stream(texels.device).cuda_stream
    err = fn(texels.data_ptr(), rows.data_ptr(), wq4.data_ptr(),
             cand_idx.data_ptr(), valid.data_ptr(), feature.data_ptr(),
             cand_w.data_ptr(), B, H, W, M, n, int(clamp_mask), stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: CUDA error "
                           f"{err}")
    kernel.count()
    return feature, cand_w


def launch_backward(texels, rows, wq4, cand_idx, valid, dfeature, dcand_w,
                    feat_dim, clamp_mask):
    """Kernel 1b: the gradients of ``unirow_combine``'s two outputs with
    respect to the texel table, (B, 3, H+2, W+2, 64) float32 (mask lanes of
    bones >= K stay zero), and to ``wq4``."""
    B, H, W, M, n = _kernel_shape(texels, rows, feat_dim)
    dtexels = torch.zeros(texels.shape, dtype=torch.float32,
                          device=texels.device)
    dwq4 = torch.empty_like(wq4)
    if n == 0:
        return dtexels, dwq4
    dfeature = dfeature.float().contiguous()
    dcand_w = dcand_w.float().contiguous()
    kernel = KERNEL_BWD
    fn = kernel.load()
    stream = torch.cuda.current_stream(texels.device).cuda_stream
    err = fn(texels.data_ptr(), rows.data_ptr(), wq4.data_ptr(),
             cand_idx.data_ptr(), valid.data_ptr(), dfeature.data_ptr(),
             dcand_w.data_ptr(), dtexels.data_ptr(), dwq4.data_ptr(),
             B, H, W, M, n, int(clamp_mask), stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: CUDA error "
                           f"{err}")
    kernel.count()
    return dtexels, dwq4


class _UnirowCombine(torch.autograd.Function):
    """Kernel 1 forward, kernel 1b backward."""

    @staticmethod
    def forward(ctx, texels, rows, wq4, cand_idx, valid, feat_dim,
                clamp_mask):
        ctx.save_for_backward(texels, rows, wq4, cand_idx, valid)
        ctx.feat_dim, ctx.clamp_mask = feat_dim, clamp_mask
        return _launch_kernel(texels, rows, wq4, cand_idx, valid, feat_dim,
                              clamp_mask)

    @staticmethod
    def backward(ctx, dfeature, dcand_w):
        texels, rows, wq4, cand_idx, valid = ctx.saved_tensors
        dtexels, dwq4 = launch_backward(texels, rows, wq4, cand_idx, valid,
                                        dfeature, dcand_w, ctx.feat_dim,
                                        ctx.clamp_mask)
        # dtexels is float32, the four cells that share a texel summed in
        # it; autograd rounds it once to the bf16 table's type here, and
        # pack_texels' backward carries it on to the planes
        return dtexels, None, dwq4, None, None, None, None


def unirow_combine(texels, rows, wq4, cand_idx, valid, feat_dim: int,
                   clamp_mask: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + combine the candidates' texels.

    Args:
        texels: (B, 3, H+2, W+2, 64) bf16 from ``pack_texels`` (float32 on
            the CPU only, the plain twin's).
        rows: (B, 3, M, n) int32 cell of each (plane, candidate, point)
            within its batch item, p*(H+1)*(W+1) + t*(W+1) + s.
        wq4: (B, 4, 3, M, n) f32 bilinear corner weights.
        cand_idx: (B, M, n) int32 bone ids; valid: (B, M, n) f32.
    Returns:
        feature (B, F, n) f32 and cand_w (B, M, n) f32.

    Differentiable in ``texels`` and ``wq4``; ``valid`` takes no gradient
    (asking for one raises). CUDA tensors go to kernel 1, and their
    gradients to kernel 1b (a float32 table raises: float32 planes go
    through ``sample_f32``); CPU tensors to ``gather_combine_texels_plain``.
    """
    _check_inputs(texels, rows, wq4, cand_idx, valid)
    if texels.is_cuda:
        if not all(t.is_contiguous()
                   for t in (texels, rows, wq4, cand_idx, valid)):
            raise ValueError("the CUDA kernel takes contiguous tensors")
        return _UnirowCombine.apply(texels, rows, wq4, cand_idx, valid,
                                    feat_dim, clamp_mask)
    return gather_combine_texels_plain(texels, rows, wq4, cand_idx, valid,
                                       feat_dim, clamp_mask)


def candidate_rows(cand_pos: torch.Tensor, cand_idx: torch.Tensor,
                   cand_valid: torch.Tensor, H: int, W: int):
    """The combine's inputs for candidates (B, n, M): rows (B, 3, M, n)
    int32, wq4 (B, 4, 3, M, n) f32, cand_idx (B, M, n) int32 and valid
    (B, M, n) f32, all contiguous with the point axis minor."""
    cp = cand_pos.permute(0, 3, 2, 1)                      # (B, 3, M, n)
    cells, wq = _quad_cells_weights(cp, H, W)              # (B, 3, M, n)
    plane = torch.arange(3, dtype=torch.int32,
                         device=cells.device).view(1, 3, 1, 1)
    rows = (plane * ((H + 1) * (W + 1)) + cells).contiguous()
    wq4 = torch.stack(wq, dim=1).contiguous()
    ci = cand_idx.permute(0, 2, 1).contiguous()
    cv = cand_valid.permute(0, 2, 1).float().contiguous()
    return rows, wq4, ci, cv


def sample_candidates_unirow(
        texels, cand_pos: torch.Tensor, cand_idx: torch.Tensor,
        cand_valid: torch.Tensor, feat_dim: int, num_bone: int, H: int, W: int,
        clamp_mask: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused part probability + weighted feature over candidate bones.

    Args:
        texels: (B, 3, H+2, W+2, 64) bf16 from ``pack_texels`` (the rows of
            ``candidate_rows``, then kernel 1), or the ``Float32Texels`` of
            ``pack_texels_f32`` (``sample_f32``: kernel 1f, from the
            positions).
        cand_pos: (B, n, M, 3); cand_idx: (B, n, M) int32;
        cand_valid: (B, n, M) bool.
    Returns:
        (feature (B, F, n) f32, cand_w (B, n, M) f32).
    """
    if isinstance(texels, Float32Texels):
        return sample_f32(texels, cand_pos, cand_idx, cand_valid, feat_dim,
                          clamp_mask)
    feature, cand_wn = unirow_combine(
        texels, *candidate_rows(cand_pos, cand_idx, cand_valid, H, W),
        feat_dim, clamp_mask)
    return feature, cand_wn.permute(0, 2, 1)


# ------------------------------------------- float32: kernels 1f and 1bf

def sample_f32_plain(tables: Float32Texels, cand_pos, cand_idx, cand_valid,
                     feat_dim: int, clamp_mask: bool):
    """Plain PyTorch version of ``sample_f32`` (the twin of kernels 1f and
    1bf; autograd differentiates it in the tables and the positions): the
    cells and corner weights of ``_quad_cells_weights``, the four corners'
    feature lines and bone mask values gathered from each plane, and the
    combine of ``gather_combine_texels_plain`` in float32.

    Returns (feature (B, F, n), cand_w (B, n, M))."""
    ft, mt = tables
    B, _, Hp, Wp, _ = ft.shape
    K = mt.shape[2]
    H, W = Hp - 2, Wp - 2
    dev = cand_pos.device
    cells, wq = _quad_cells_weights(cand_pos.permute(0, 3, 2, 1), H, W)
    t, s = cells // (W + 1), cells % (W + 1)                  # (B, 3, M, n)
    corners = (t * Wp + s).long()[..., None] \
        + torch.tensor([0, 1, Wp, Wp + 1], device=dev)        # (…, 4)
    plane = (torch.arange(B, device=dev).view(B, 1, 1, 1, 1) * 3
             + torch.arange(3, device=dev).view(1, 3, 1, 1, 1))
    fq = ft.reshape(-1, FEAT_BLOCK)[:, :feat_dim][
        plane * (Hp * Wp) + corners]                          # (…, 4, F)
    bone = cand_idx.permute(0, 2, 1).long()[:, None, :, :, None]
    mq = mt.reshape(-1)[(plane * K + bone) * (Hp * Wp) + corners]
    valid = cand_valid.permute(0, 2, 1).float()
    feature, cand_wn = _combine(fq, mq, torch.stack(wq, dim=-1), valid,
                                clamp_mask)
    return feature, cand_wn.permute(0, 2, 1)


def _check_f32_inputs(tables, cand_pos, cand_idx, cand_valid):
    ft, mt = tables
    if ft.dim() != 5 or ft.shape[1] != 3 or ft.shape[4] != FEAT_BLOCK \
            or mt.dim() != 5 or mt.shape[:2] != ft.shape[:2] \
            or mt.shape[3:] != ft.shape[2:4] \
            or not 0 < mt.shape[2] <= MASK_BLOCK \
            or ft.dtype != torch.float32 or mt.dtype != torch.float32:
        raise ValueError(f"the float32 tables must be (B, 3, H+2, W+2, "
                         f"{FEAT_BLOCK}) and (B, 3, K, H+2, W+2) float32, "
                         f"K <= {MASK_BLOCK} (pack_texels_f32), got "
                         f"{tuple(ft.shape)} {ft.dtype}, {tuple(mt.shape)} "
                         f"{mt.dtype}")
    B = ft.shape[0]
    if cand_pos.dim() != 4 or cand_pos.shape[0] != B \
            or cand_pos.shape[3] != 3 or cand_pos.dtype != torch.float32:
        raise ValueError(f"cand_pos must be (B, n, M, 3) float32, got "
                         f"{tuple(cand_pos.shape)} {cand_pos.dtype}")
    shape = tuple(cand_pos.shape[:3])
    for name, t, dtype in (("cand_idx", cand_idx, torch.int32),
                           ("cand_valid", cand_valid, torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (mt, cand_pos, cand_idx, cand_valid):
        if t.device != ft.device:
            raise ValueError(f"the float32 sampler's inputs lie on "
                             f"{t.device} and {ft.device}")


def _f32_kernel_shape(tables, inputs, feat_dim):
    """(B, H, W, K, M, n) for kernels 1f and 1bf, or raise on what they do
    not take; ``inputs`` (cand_pos, cand_idx, cand_valid)."""
    if feat_dim != KERNEL_FEAT_DIM:
        raise ValueError(f"the CUDA kernel takes feat_dim "
                         f"{KERNEL_FEAT_DIM}, got {feat_dim}")
    ft, mt = tables
    if not all(t.is_contiguous() for t in (ft, mt) + inputs):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    B, _, Hp, Wp, _ = ft.shape
    K = mt.shape[2]
    n, M = inputs[0].shape[1:3]
    if 3 * Hp * Wp * max(FEAT_BLOCK, K) >= 2 ** 31 or n >= 2 ** 31 \
            or B > 65535:
        raise ValueError(f"shape too large for the kernel: B={B} "
                         f"H={Hp - 2} W={Wp - 2} K={K} n={n}")
    return B, Hp - 2, Wp - 2, K, M, n


def launch_f32(tables, cand_pos, cand_idx, cand_valid, feat_dim, clamp_mask):
    """Kernel 1f: feature (B, F, n) and cand_w (B, n, M) from the
    positions."""
    B, H, W, K, M, n = _f32_kernel_shape(
        tables, (cand_pos, cand_idx, cand_valid), feat_dim)
    dev = cand_pos.device
    feature = torch.empty((B, feat_dim, n), dtype=torch.float32, device=dev)
    cand_w = torch.empty((B, n, M), dtype=torch.float32, device=dev)
    if n == 0:
        return feature, cand_w
    fn = KERNEL_F32.load()
    err = fn(tables.feature.data_ptr(), tables.mask.data_ptr(),
             cand_pos.data_ptr(), cand_idx.data_ptr(), cand_valid.data_ptr(),
             feature.data_ptr(), cand_w.data_ptr(), B, H, W, K, M, n,
             int(clamp_mask), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_F32.name} kernel launch failed: CUDA "
                           f"error {err}")
    KERNEL_F32.count()
    return feature, cand_w


def launch_backward_f32(tables, cand_pos, cand_idx, cand_valid, dfeature,
                        dcand_w, feat_dim, clamp_mask):
    """Kernel 1bf: the gradients of ``sample_f32``'s two outputs with
    respect to the feature table, the mask table (float32, the tables'
    shapes) and the positions (B, n, M, 3)."""
    B, H, W, K, M, n = _f32_kernel_shape(
        tables, (cand_pos, cand_idx, cand_valid), feat_dim)
    dev = cand_pos.device
    dfeat = torch.zeros_like(tables.feature)
    dmask = torch.zeros_like(tables.mask)
    dpos = torch.empty_like(cand_pos)
    if n == 0:
        return dfeat, dmask, dpos
    dfeature = dfeature.float().contiguous()
    dcand_w = dcand_w.float().contiguous()
    fn = KERNEL_BWD_F32.load()
    err = fn(tables.feature.data_ptr(), tables.mask.data_ptr(),
             cand_pos.data_ptr(), cand_idx.data_ptr(), cand_valid.data_ptr(),
             dfeature.data_ptr(), dcand_w.data_ptr(), dfeat.data_ptr(),
             dmask.data_ptr(), dpos.data_ptr(), B, H, W, K, M, n,
             int(clamp_mask), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_BWD_F32.name} kernel launch failed: "
                           f"CUDA error {err}")
    KERNEL_BWD_F32.count()
    return dfeat, dmask, dpos


class _SampleF32(torch.autograd.Function):
    """Kernel 1f forward, kernel 1bf backward."""

    @staticmethod
    def forward(ctx, feat, mask, cand_pos, cand_idx, cand_valid, feat_dim,
                clamp_mask):
        ctx.save_for_backward(feat, mask, cand_pos, cand_idx, cand_valid)
        ctx.feat_dim, ctx.clamp_mask = feat_dim, clamp_mask
        return launch_f32(Float32Texels(feat, mask), cand_pos, cand_idx,
                          cand_valid, feat_dim, clamp_mask)

    @staticmethod
    def backward(ctx, dfeature, dcand_w):
        feat, mask, cand_pos, cand_idx, cand_valid = ctx.saved_tensors
        dfeat, dmask, dpos = launch_backward_f32(
            Float32Texels(feat, mask), cand_pos, cand_idx, cand_valid,
            dfeature, dcand_w, ctx.feat_dim, ctx.clamp_mask)
        # pack_texels_f32's backward carries the tables' gradients on to
        # the planes; dpos goes to whatever made the positions
        return dfeat, dmask, dpos, None, None, None, None


def sample_f32(tables: Float32Texels, cand_pos: torch.Tensor,
               cand_idx: torch.Tensor, cand_valid: torch.Tensor,
               feat_dim: int, clamp_mask: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 planes' fused part probability + weighted feature over
    candidate bones, from the candidates' positions.

    Args:
        tables: ``Float32Texels`` from ``pack_texels_f32``.
        cand_pos: (B, n, M, 3) float32, invalid candidates anywhere (at 2
            from ``select_candidate_bones``); cand_idx: (B, n, M) int32
            bones in [0, K); cand_valid: (B, n, M) bool.
    Returns:
        (feature (B, F, n) f32, cand_w (B, n, M) f32).

    Differentiable in both tables and in ``cand_pos``. CUDA tensors go to
    kernel 1f, and their gradients to kernel 1bf (or raise); CPU tensors to
    ``sample_f32_plain``.
    """
    _check_f32_inputs(tables, cand_pos, cand_idx, cand_valid)
    if tables.feature.is_cuda:
        return _SampleF32.apply(tables.feature, tables.mask, cand_pos,
                                cand_idx, cand_valid, feat_dim, clamp_mask)
    return sample_f32_plain(tables, cand_pos, cand_idx, cand_valid, feat_dim,
                            clamp_mask)
