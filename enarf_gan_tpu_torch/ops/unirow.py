"""Unirow tri-plane sampling: one fused row per (point, candidate, plane)
(port of ``enarf_gan_tpu/ops/unirow.py``).

``pack_unirow`` packs the feature planes and all per-bone mask planes into
one 256-lane bf16 row per sample cell:

    [ A_f | B_f | C_f | D_f | A_m(32) | B_m(32) | C_m(32) | D_m(32) ]

A..D are the 2×2 bilinear texel quad of the cell; each mask corner block
holds that texel's mask logit for every bone (bone k at lane k, K <= 32).

``unirow_combine`` gathers those rows and combines them: bilinear feature
sum over planes, the candidate bone's mask logit, the product of sigmoids
over planes, and the candidate-weighted feature sum. On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/unirow_combine.cu`` (which
replaces the Pallas kernel ``_combine_kernel``); on a CPU tensor it runs
``gather_combine_plain``, the plain PyTorch twin of the JAX package's
``jnp.take`` + ``_combine_xla``. Forward only: the backward kernel waits
for DSO training.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.ops.activation import straight_through_clamp
from enarf_gan_tpu_torch.ops.quadtable import (_quad_cells_weights,
                                               quad_pack_corners)

MASK_BLOCK = 32          # lanes per mask corner block (bones 0..K-1, K<=32)
KERNEL_FEAT_DIM = 32     # the kernel maps feature lane f to warp lane f


def row_width(feat_dim: int) -> int:
    return 4 * feat_dim + 4 * MASK_BLOCK


def pack_unirow(tri_plane_feature: torch.Tensor, feat_dim: int,
                num_bone: int) -> torch.Tensor:
    """(B, (F+K)*3, H, W) planes → (B, 3*(H+1)*(W+1), 4F+128) bf16 table.

    Row r = p*(H+1)*(W+1) + t*(W+1) + s for plane p, cell (t, s). Input
    channels: F*3 feature planes, then K*3 per-bone mask planes.
    """
    B, C3, H, W = tri_plane_feature.shape
    F_, K = feat_dim, num_bone
    if C3 != (F_ + K) * 3 or K > MASK_BLOCK:
        raise ValueError(f"planes of {C3} channels do not hold F={F_}, "
                         f"K={K} (K <= {MASK_BLOCK})")
    feat = tri_plane_feature[:, :F_ * 3].reshape(B, 3, F_, H, W) \
        .permute(0, 1, 3, 4, 2)                                # (B,3,H,W,F)
    mask = tri_plane_feature[:, F_ * 3:].reshape(B, K, 3, H, W) \
        .permute(0, 2, 3, 4, 1)                                # (B,3,H,W,K)
    fq = quad_pack_corners(feat)                               # (…, 4F)
    mq = quad_pack_corners(mask).reshape(B, 3, -1, 4, K)
    mq = F.pad(mq, (0, MASK_BLOCK - K)).reshape(B, 3, fq.shape[2],
                                                 4 * MASK_BLOCK)
    table = torch.cat([fq, mq], dim=-1).to(torch.bfloat16)
    return table.reshape(B, 3 * fq.shape[2], row_width(F_))


def gather_combine_plain(table, rows, wq4, cand_idx, valid, feat_dim: int,
                         clamp_mask: bool):
    """Plain PyTorch gather + combine (the twin of the kernel).

    Same arguments and results as ``unirow_combine``. Materialises the
    gathered rows (B, 3, M, n, 4F+128) and computes in float32, as the TPU
    kernel does (the JAX ``_combine_xla`` forms the feature products in
    bf16).
    """
    F_ = feat_dim
    B, R, RW = table.shape
    _, _, M, n = rows.shape
    flat = rows.long() + (torch.arange(B, device=rows.device) * R).view(B, 1, 1, 1)
    g = table.reshape(B * R, RW)[flat.reshape(-1)].reshape(B, 3, M, n, RW)
    feat = sum(g[..., q * F_:(q + 1) * F_].float() * wq4[:, q, ..., None]
               for q in range(4))
    feat = feat.sum(dim=1)                                     # (B, M, n, F)
    sel = cand_idx.long()[:, None, :, :, None].expand(B, 3, M, n, 1)
    base = 4 * F_
    logit = sum(
        g[..., base + q * MASK_BLOCK: base + (q + 1) * MASK_BLOCK]
        .gather(-1, sel)[..., 0].float() * wq4[:, q]
        for q in range(4))                                     # (B, 3, M, n)
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_wn = torch.sigmoid(logit).prod(dim=1)                 # (B, M, n)
    feature = torch.einsum("bmnf,bmn->bfn", feat, cand_wn * valid)
    return feature, cand_wn


KERNEL = KernelLibrary("unirow_combine", "unirow_combine_bf16",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])


def _check_inputs(table, rows, wq4, cand_idx, valid, feat_dim):
    if table.dim() != 3 or table.dtype != torch.bfloat16 \
            or table.shape[2] != row_width(feat_dim):
        raise ValueError(f"table must be (B, R, {row_width(feat_dim)}) "
                         f"bfloat16, got {tuple(table.shape)} {table.dtype}")
    B = table.shape[0]
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
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")


def _launch_kernel(table, rows, wq4, cand_idx, valid, feat_dim, clamp_mask):
    inputs = (table, rows, wq4, cand_idx, valid)
    if feat_dim != KERNEL_FEAT_DIM:
        raise ValueError(f"the CUDA kernel takes feat_dim "
                         f"{KERNEL_FEAT_DIM}, got {feat_dim}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            "unirow_combine has no backward kernel yet (ROADMAP Queue 2, "
            "kernel 1b); render under torch.no_grad()")
    B, R, _ = table.shape
    M, n = rows.shape[2:]
    if R >= 2 ** 31 or n >= 2 ** 31 or B > 65535:
        raise ValueError(f"shape too large for the kernel: B={B} R={R} "
                         f"M={M} n={n}")
    feature = torch.empty((B, feat_dim, n), dtype=torch.float32,
                          device=table.device)
    cand_w = torch.empty((B, M, n), dtype=torch.float32, device=table.device)
    if n == 0:
        return feature, cand_w
    fn = KERNEL.load()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), rows.data_ptr(), wq4.data_ptr(),
             cand_idx.data_ptr(), valid.data_ptr(), feature.data_ptr(),
             cand_w.data_ptr(), B, R, M, n, int(clamp_mask), stream)
    if err != 0:
        raise RuntimeError(f"unirow_combine kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL.count()
    return feature, cand_w


def unirow_combine(table, rows, wq4, cand_idx, valid, feat_dim: int,
                   clamp_mask: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + combine unirow rows.

    Args:
        table: (B, R, 4F+128) bf16 from ``pack_unirow``.
        rows: (B, 3, M, n) int32 row of each (plane, candidate, point)
            within its batch's table.
        wq4: (B, 4, 3, M, n) f32 bilinear corner weights.
        cand_idx: (B, M, n) int32 bone ids; valid: (B, M, n) f32.
    Returns:
        feature (B, F, n) f32 and cand_w (B, M, n) f32.

    CUDA tensors go to the kernel (or raise); CPU tensors to
    ``gather_combine_plain``.
    """
    _check_inputs(table, rows, wq4, cand_idx, valid, feat_dim)
    if table.is_cuda:
        return _launch_kernel(table, rows, wq4, cand_idx, valid, feat_dim,
                              clamp_mask)
    return gather_combine_plain(table, rows, wq4, cand_idx, valid, feat_dim,
                                clamp_mask)


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
        table: torch.Tensor, cand_pos: torch.Tensor, cand_idx: torch.Tensor,
        cand_valid: torch.Tensor, feat_dim: int, num_bone: int, H: int, W: int,
        clamp_mask: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused part probability + weighted feature over candidate bones.

    Args:
        table: (B, 3*(H+1)*(W+1), 4F+128) bf16 from ``pack_unirow``.
        cand_pos: (B, n, M, 3); cand_idx: (B, n, M) int32;
        cand_valid: (B, n, M) bool.
    Returns:
        (feature (B, F, n) f32, cand_w (B, n, M) f32).
    """
    feature, cand_wn = unirow_combine(
        table, *candidate_rows(cand_pos, cand_idx, cand_valid, H, W),
        feat_dim, clamp_mask)
    return feature, cand_wn.permute(0, 2, 1)
