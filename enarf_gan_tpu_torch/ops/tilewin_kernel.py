"""Patch-window (tilewin) combine: the hand-written Hopper kernel and its
plain twin (port of the default "hat" kernel of
``enarf_gan_tpu/ops/tilewin_kernel.py``).

``tilewin_combine`` takes the packed window tables of ``ops/tilewin.py``,
the window rows each (unit, slot, plane) reads and the members' in-window
coordinates, and returns the candidate-weighted feature of every point and
the candidate weights. On a CUDA tensor it launches
``csrc/tilewin_combine.cu`` (which replaces the Pallas kernel
``_combine_kernel_hat`` and does the row gathers itself); on a CPU tensor it
runs ``tilewin_combine_plain``. Forward only: the backward kernel (2b) waits
for DSO training.

A unit is one (patch, sample): U = n_patch * S units, each with m member
rays (m = 16 for 4x4 patches, m = 4 on the coarse-corner pass).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.ops.activation import straight_through_clamp

WIN = 8
NTEX = WIN * WIN
KERNEL_FEAT_DIM = 32            # the kernel maps channel f to warp lane f
KERNEL_MEMBERS = (4, 16)        # member counts the kernel is built for


class _TilewinKernel(KernelLibrary):
    """``KernelLibrary`` that also counts launches by member count:
    ``launches_by_m[m]`` goes up with ``launches``."""

    def __init__(self):
        super().__init__("tilewin_combine", "tilewin_combine_bf16",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
        self.launches_by_m = {m: 0 for m in KERNEL_MEMBERS}

    def count(self, m: int):
        super().count()
        self.launches_by_m[m] += 1

    def reset_counts(self):
        super().reset_counts()
        self.launches_by_m = {m: 0 for m in KERNEL_MEMBERS}

    def smem_bytes(self, Mp: int, m: int) -> int:
        """Dynamic shared memory of one block, in bytes."""
        self.load()
        return self.lib.tilewin_combine_smem_bytes(Mp, m)


KERNEL = _TilewinKernel()


def texel_cells(x: torch.Tensor):
    """In-window position x in [0, WIN-1) → (top-left texel i <= WIN-2,
    fraction). An f32 offset + fraction that rounds up to WIN-1 keeps i at
    WIN-2 with fraction 1, the value the TPU kernel's hats give."""
    i = x.floor().clamp(max=WIN - 2)
    return i.long(), x - i


def tilewin_combine_plain(feat_table, mask_table, frows, mrows, xt, xs, valid,
                          feat_dim: int, S: int, clamp_mask: bool):
    """Plain PyTorch gather + combine (the twin of the kernel).

    Same arguments and results as ``tilewin_combine``. Gathers each member's
    2x2 texels corner by corner and computes in float32 from the bf16 rows,
    as the kernel does.
    """
    F_ = feat_dim
    B, _, Mp, U = frows.shape
    m = xt.shape[3]
    n_patch = U // S
    tex = feat_table.reshape(feat_table.shape[0], -1)[:, :NTEX * F_] \
        .reshape(-1, F_)                                   # (R*64, F)
    msk = mask_table.reshape(-1)                           # (Rm*64,)
    i, ft = texel_cells(xt)                                # (B,3,Mp,m,U)
    k, fs = texel_cells(xs)
    cell = i * WIN + k
    frow = frows.long()[:, :, :, None, :] * NTEX + cell
    mrow = mrows.long()[:, :, :, None, :] * NTEX + cell
    feat = 0.0
    logit = 0.0
    for dt, ds, w in ((0, 0, (1 - ft) * (1 - fs)), (0, 1, (1 - ft) * fs),
                      (1, 0, ft * (1 - fs)), (1, 1, ft * fs)):
        off = dt * WIN + ds
        v = tex[(frow + off).reshape(-1)].reshape(*frow.shape, F_)
        feat = feat + v.float() * w[..., None]
        logit = logit + msk[mrow + off].float() * w
    feat = feat.sum(dim=1)                                 # (B,Mp,m,U,F)
    logit = logit * valid[:, None]
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_w = torch.sigmoid(logit).prod(dim=1)              # (B,Mp,m,U)
    feature = (feat * (cand_w * valid)[..., None]).sum(dim=1)   # (B,m,U,F)
    feature = feature.reshape(B, m, n_patch, S, F_).permute(0, 4, 2, 1, 3) \
        .reshape(B, F_, n_patch * m * S)
    cand_w = cand_w.reshape(B, Mp, m, n_patch, S).permute(0, 1, 3, 2, 4)
    return feature, cand_w.contiguous()


def _check_inputs(feat_table, mask_table, frows, mrows, xt, xs, valid,
                  feat_dim, S):
    if feat_table.dim() != 3 or feat_table.dtype != torch.bfloat16 \
            or feat_table.shape[1] * feat_table.shape[2] < NTEX * feat_dim:
        raise ValueError(f"feat_table must be (R, SUB, LANE) bfloat16 holding "
                         f"{NTEX}x{feat_dim} lanes a row, got "
                         f"{tuple(feat_table.shape)} {feat_table.dtype}")
    if mask_table.dim() != 2 or mask_table.shape[1] != NTEX \
            or mask_table.dtype != torch.bfloat16:
        raise ValueError(f"mask_table must be (Rm, {NTEX}) bfloat16, got "
                         f"{tuple(mask_table.shape)} {mask_table.dtype}")
    if frows.dim() != 4 or frows.shape[1] != 3:
        raise ValueError(f"frows must be (B, 3, Mp, U), got "
                         f"{tuple(frows.shape)}")
    B, _, Mp, U = frows.shape
    if xt.dim() != 5 or tuple(xt.shape[:3]) != (B, 3, Mp) or xt.shape[4] != U:
        raise ValueError(f"xt must be (B, 3, Mp, m, U) = ({B}, 3, {Mp}, m, "
                         f"{U}), got {tuple(xt.shape)}")
    m = xt.shape[3]
    if S <= 0 or U % S:
        raise ValueError(f"S={S} does not divide U={U}")
    want = {"frows": (frows, (B, 3, Mp, U), torch.int32),
            "mrows": (mrows, (B, 3, Mp, U), torch.int32),
            "xt": (xt, (B, 3, Mp, m, U), torch.float32),
            "xs": (xs, (B, 3, Mp, m, U), torch.float32),
            "valid": (valid, (B, Mp, m, U), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in [("mask_table", mask_table)] + \
            [(k, v[0]) for k, v in want.items()]:
        if t.device != feat_table.device:
            raise ValueError(f"{name} is on {t.device}, feat_table on "
                             f"{feat_table.device}")


def _launch_kernel(feat_table, mask_table, frows, mrows, xt, xs, valid,
                   feat_dim, S, clamp_mask):
    inputs = (feat_table, mask_table, frows, mrows, xt, xs, valid)
    B, _, Mp, U = frows.shape
    m = xt.shape[3]
    if feat_dim != KERNEL_FEAT_DIM or \
            feat_table.shape[1] * feat_table.shape[2] != NTEX * feat_dim:
        raise ValueError(f"the CUDA kernel takes feat_dim {KERNEL_FEAT_DIM} "
                         f"(rows of {NTEX * KERNEL_FEAT_DIM} lanes), got "
                         f"feat_dim {feat_dim}")
    if m not in KERNEL_MEMBERS:
        raise ValueError(f"the CUDA kernel takes m in {KERNEL_MEMBERS} "
                         f"members a unit, got m={m}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            "tilewin_combine has no backward kernel yet (ROADMAP Queue 2, "
            "kernel 2b); render under torch.no_grad()")
    if B > 65535 or U * m >= 2 ** 31 or Mp * U * m >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: B={B} Mp={Mp} "
                         f"m={m} U={U}")
    n = U * m
    feature = torch.empty((B, feat_dim, n), dtype=torch.float32,
                          device=feat_table.device)
    cand_w = torch.empty((B, Mp, U // S, m, S), dtype=torch.float32,
                         device=feat_table.device)
    if U == 0:
        return feature, cand_w
    fn = KERNEL.load()
    stream = torch.cuda.current_stream(feat_table.device).cuda_stream
    err = fn(*(t.data_ptr() for t in inputs), feature.data_ptr(),
             cand_w.data_ptr(), B, Mp, m, U, S, int(clamp_mask), stream)
    if err != 0:
        raise RuntimeError(f"tilewin_combine kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL.count(m)
    return feature, cand_w


def tilewin_combine(feat_table, mask_table, frows, mrows, xt, xs, valid,
                    feat_dim: int, S: int, clamp_mask: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + combine patch-window rows.

    Args:
        feat_table: (R, 16, 128) bf16 window rows from ``pack_tilewin``.
        mask_table: (Rm, 64) bf16 mask window rows.
        frows, mrows: (B, 3, Mp, U) int32 table rows of each (plane, slot,
            unit), over all batches.
        xt, xs: (B, 3, Mp, m, U) f32 in-window member positions in
            [0, WIN-1); valid: (B, Mp, m, U) f32 slot-member validity.
        S: samples per patch (unit u is patch u // S, sample u % S).
    Returns:
        feature (B, F, n_patch*m*S) f32 in tiled point order
        ((patch*m + member)*S + sample) and cand_w (B, Mp, n_patch, m, S)
        f32.

    CUDA tensors go to the kernel (or raise); CPU tensors to
    ``tilewin_combine_plain``.
    """
    _check_inputs(feat_table, mask_table, frows, mrows, xt, xs, valid,
                  feat_dim, S)
    if feat_table.is_cuda:
        return _launch_kernel(feat_table, mask_table, frows, mrows, xt, xs,
                              valid, feat_dim, S, clamp_mask)
    return tilewin_combine_plain(feat_table, mask_table, frows, mrows, xt, xs,
                                 valid, feat_dim, S, clamp_mask)
