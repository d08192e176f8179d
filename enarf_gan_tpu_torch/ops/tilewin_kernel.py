"""Patch-window (tilewin) combine: the hand-written Hopper kernels and their
plain twin (port of ``enarf_gan_tpu/ops/tilewin_kernel.py``).

``tilewin_combine`` takes the packed window tables of ``ops/tilewin.py``,
the window rows each (unit, slot, plane) reads and the members' in-window
coordinates, and returns the candidate-weighted feature of every point and
the candidate weights. ``mode`` (or ``ENARF_TILEWIN_KERNEL``, default
"hat") picks the formulation, as in the JAX package:

* "hat": ``csrc/tilewin_combine.cu`` (kernel 2, replaces the Pallas kernel
  ``_combine_kernel_hat``), m = 4 or 16;
* "dot", "bdiag", "vpu": ``csrc/tilewin_combine_modes.cu`` (kernel 3,
  replaces ``_combine_kernel`` and ``_combine_kernel_bdiag``), m = 16: the
  t-contraction as a matrix product, on the tensor cores with the t-weights
  rounded to bf16 ("dot", "bdiag") or in float32 FMAs ("vpu").

Each kernel does the row gathers itself. On the card the combine is a
``torch.autograd.Function`` whose backward is ``csrc/tilewin_combine_bwd.cu``
(kernel 2b) whatever the mode: the function is the same, and the JAX
package's backward ignores the mode too. Gradients reach both tables and
the coordinates xt, xs. The coarse-corner pass (m = 4) runs without
gradients, as the JAX one runs under ``stop_gradient``: asking for one at
m = 4 raises. On a CPU tensor every mode runs ``tilewin_combine_plain``,
which autograd differentiates.

A unit is one (patch, sample): U = n_patch * S units, each with m member
rays (m = 16 for 4x4 patches, m = 4 on the coarse-corner pass).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.ops.activation import straight_through_clamp

WIN = 8
NTEX = WIN * WIN
KERNEL_FEAT_DIM = 32            # the kernel maps channel f to warp lane f
KERNEL_MEMBERS = (4, 16)        # member counts kernel 2 is built for
GRAD_MEMBERS = 16               # the member count with a backward (kernel 2b)
MODES = ("hat", "dot", "vpu", "bdiag")
MATRIX_MODES = ("dot", "vpu", "bdiag")    # kernel 3: m = 16 only
# kernel 2's stage ablations (tools/ablate.py), in the order of the C enum
HAT_STAGES = ("full", "stream", "noweights", "nomask", "nofeat")


# launches counted by member count (kernel 2) and by mode (kernel 3)
KERNEL = KernelLibrary("tilewin_combine", "tilewin_combine_bf16",
                       [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p], keys=KERNEL_MEMBERS)
KERNEL_MODES = KernelLibrary("tilewin_combine_modes",
                             "tilewin_combine_modes_bf16",
                             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p], keys=MATRIX_MODES)
KERNEL_BWD = KernelLibrary("tilewin_combine_bwd", "tilewin_combine_bwd_bf16",
                           [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])


def resolve_mode(mode: Optional[str]) -> str:
    """``mode``, or ``ENARF_TILEWIN_KERNEL`` (default "hat") when None."""
    if mode is None:
        mode = os.environ.get("ENARF_TILEWIN_KERNEL", "hat")
    if mode not in MODES:
        raise ValueError(f"tilewin combine mode must be one of {MODES}, got "
                         f"{mode!r}")
    return mode


def texel_cells(x: torch.Tensor):
    """In-window position x in [0, WIN-1) → (top-left texel i <= WIN-2,
    fraction). An f32 offset + fraction that rounds up to WIN-1 keeps i at
    WIN-2 with fraction 1, the value the TPU kernel's hats give."""
    i = x.floor().clamp(max=WIN - 2)
    return i.long(), x - i


def tilewin_combine_plain(feat_table, mask_table, frows, mrows, xt, xs, valid,
                          feat_dim: int, S: int, clamp_mask: bool,
                          round_t: bool = False, stage: str = "full"):
    """Plain PyTorch gather + combine (the twin of the kernels).

    Same arguments and results as ``tilewin_combine``. Gathers each member's
    2x2 texels corner by corner and computes in float32 from the bf16 rows,
    as the kernels do. ``round_t`` rounds the t-direction weights (hat x
    valid) to bf16, as the "dot" and "bdiag" formulations do (the JAX
    ``A.astype(jnp.bfloat16)``). Under autograd it gathers from float32
    copies of the tables, so the table gradients accumulate in float32, as
    the backward kernel's do.

    ``stage`` other than "full" is the twin of one of kernel 2's stage
    ablations (``csrc/tilewin_combine.cu``, ``tools/ablate.py``): "stream"
    reads a feature texel as (frow & 255) / 256 and a mask texel as
    (mrow & 255) / 256, "noweights" sets both bilinear fractions to 0.5,
    "nomask" sets every logit to 0 and "nofeat" every feature texel to 1.
    """
    F_ = feat_dim
    if torch.is_grad_enabled() and feat_table.requires_grad:
        feat_table = feat_table.float()
    if torch.is_grad_enabled() and mask_table.requires_grad:
        mask_table = mask_table.float()
    B, _, Mp, U = frows.shape
    m = xt.shape[3]
    n_patch = U // S
    tex = feat_table.reshape(feat_table.shape[0], -1)[:, :NTEX * F_] \
        .reshape(-1, F_)                                   # (R*64, F)
    msk = mask_table.reshape(-1)                           # (Rm*64,)
    if stage not in HAT_STAGES:
        raise ValueError(f"stage must be one of {HAT_STAGES}, got {stage!r}")
    i, ft = texel_cells(xt)                                # (B,3,Mp,m,U)
    k, fs = texel_cells(xs)
    if stage == "noweights":
        ft = fs = torch.full_like(ft, 0.5)
    cell = i * WIN + k
    frow = frows.long()[:, :, :, None, :] * NTEX + cell
    mrow = mrows.long()[:, :, :, None, :] * NTEX + cell
    wt = (1 - ft, ft)
    if round_t:
        vm = valid[:, None, :, :, :]
        wt = tuple((w * vm).to(torch.bfloat16).float() for w in wt)
    feat = 0.0
    logit = torch.zeros_like(ft)
    for dt, ds, w, wf in ((0, 0, (1 - ft) * (1 - fs), wt[0] * (1 - fs)),
                          (0, 1, (1 - ft) * fs, wt[0] * fs),
                          (1, 0, ft * (1 - fs), wt[1] * (1 - fs)),
                          (1, 1, ft * fs, wt[1] * fs)):
        off = dt * WIN + ds
        if stage == "stream":
            v = ((frows[:, :, :, None, :] & 255).float() / 256)[..., None] \
                * torch.ones(F_, device=ft.device)
        elif stage == "nofeat":
            v = torch.ones(F_, device=ft.device)
        else:
            v = tex[(frow + off).reshape(-1)].reshape(*frow.shape, F_)
        feat = feat + v.float() * wf[..., None]
        if stage == "stream":
            logit = logit + (mrows[:, :, :, None, :] & 255).float() / 256 * w
        elif stage != "nomask":
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
                  feat_dim, S, mode):
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
    if mode in MATRIX_MODES and (m != 16 or feat_dim != KERNEL_FEAT_DIM):
        raise ValueError(f"mode {mode!r} takes m = 16 members and feat_dim "
                         f"{KERNEL_FEAT_DIM}, got m={m} feat_dim={feat_dim}")
    if torch.is_grad_enabled():
        if valid.requires_grad:
            raise ValueError("valid takes no gradient (it comes from a bool); "
                             "detach it")
        if m != GRAD_MEMBERS and any(
                t.requires_grad for t in (feat_table, mask_table, xt, xs)):
            raise ValueError(f"the tilewin combine has a backward for m = "
                             f"{GRAD_MEMBERS} only (the coarse-corner pass, "
                             f"m = {m}, runs under torch.no_grad()), got a "
                             f"gradient request")


def _check_kernel_shapes(feat_table, frows, xt, feat_dim):
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
    if B > 65535 or U * m >= 2 ** 31 or Mp * U * m >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: B={B} Mp={Mp} "
                         f"m={m} U={U}")


def _launch_kernel(feat_table, mask_table, frows, mrows, xt, xs, valid,
                   feat_dim, S, clamp_mask, mode="hat"):
    """Kernel 2 ("hat") or kernel 3 (the matrix modes): feature
    (B, F, n) and cand_w (B, Mp, n_patch, m, S)."""
    inputs = (feat_table, mask_table, frows, mrows, xt, xs, valid)
    _check_kernel_shapes(feat_table, frows, xt, feat_dim)
    B, _, Mp, U = frows.shape
    m = xt.shape[3]
    n = U * m
    feature = torch.empty((B, feat_dim, n), dtype=torch.float32,
                          device=feat_table.device)
    cand_w = torch.empty((B, Mp, U // S, m, S), dtype=torch.float32,
                         device=feat_table.device)
    if U == 0:
        return feature, cand_w
    stream = torch.cuda.current_stream(feat_table.device).cuda_stream
    ptrs = [t.data_ptr() for t in inputs] + [feature.data_ptr(),
                                             cand_w.data_ptr()]
    if mode == "hat":
        err = KERNEL.load()(*ptrs, B, Mp, m, U, S, int(clamp_mask), stream)
    else:
        err = KERNEL_MODES.load()(*ptrs, B, Mp, U, S, int(clamp_mask),
                                  int(mode != "vpu"), stream)
    if err != 0:
        raise RuntimeError(f"tilewin_combine kernel ({mode}) launch failed: "
                           f"CUDA error {err}")
    if mode == "hat":
        KERNEL.count(m)
    else:
        KERNEL_MODES.count(mode)
    return feature, cand_w


def launch_backward(feat_table, mask_table, frows, mrows, xt, xs, valid,
                    dfeature, dcand_w, feat_dim, S, clamp_mask):
    """Kernel 2b: the gradients of ``tilewin_combine``'s two outputs with
    respect to the feature table (R, 16, 128) and the mask table (Rm, 64),
    both float32, and to xt and xs."""
    _check_kernel_shapes(feat_table, frows, xt, feat_dim)
    B, _, Mp, U = frows.shape
    m = xt.shape[3]
    if m != GRAD_MEMBERS:
        raise ValueError(f"the backward kernel takes m = {GRAD_MEMBERS}, got "
                         f"m={m}")
    dev = feat_table.device
    dfeat = torch.zeros(feat_table.shape, dtype=torch.float32, device=dev)
    dmask = torch.zeros(mask_table.shape, dtype=torch.float32, device=dev)
    dxt = torch.empty_like(xt)
    dxs = torch.empty_like(xs)
    if U == 0:
        return dfeat, dmask, dxt, dxs
    dfeature = dfeature.float().contiguous()
    dcand_w = dcand_w.float().contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = KERNEL_BWD.load()(
        *(t.data_ptr() for t in (feat_table, mask_table, frows, mrows, xt, xs,
                                 valid, dfeature, dcand_w, dfeat, dmask, dxt,
                                 dxs)),
        B, Mp, U, S, int(clamp_mask), stream)
    if err != 0:
        raise RuntimeError(f"tilewin_combine backward kernel launch failed: "
                           f"CUDA error {err}")
    KERNEL_BWD.count()
    return dfeat, dmask, dxt, dxs


class _TilewinCombine(torch.autograd.Function):
    """Kernel 2 or 3 forward, kernel 2b backward."""

    @staticmethod
    def forward(ctx, feat_table, mask_table, frows, mrows, xt, xs, valid,
                feat_dim, S, clamp_mask, mode):
        ctx.save_for_backward(feat_table, mask_table, frows, mrows, xt, xs,
                              valid)
        ctx.feat_dim, ctx.S, ctx.clamp_mask = feat_dim, S, clamp_mask
        return _launch_kernel(feat_table, mask_table, frows, mrows, xt, xs,
                              valid, feat_dim, S, clamp_mask, mode)

    @staticmethod
    def backward(ctx, dfeature, dcand_w):
        dfeat, dmask, dxt, dxs = launch_backward(
            *ctx.saved_tensors, dfeature, dcand_w, ctx.feat_dim, ctx.S,
            ctx.clamp_mask)
        # the table gradients are float32; autograd rounds them to the bf16
        # tables' type here, and pack_tilewin's unfold carries them on to the
        # planes
        return (dfeat, dmask, None, None, dxt, dxs, None, None, None, None,
                None)


def tilewin_combine(feat_table, mask_table, frows, mrows, xt, xs, valid,
                    feat_dim: int, S: int, clamp_mask: bool,
                    mode: Optional[str] = None
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
        mode: "hat", "dot", "vpu" or "bdiag"; None reads
            ``ENARF_TILEWIN_KERNEL`` (default "hat"). The matrix modes take
            m = 16 only.
    Returns:
        feature (B, F, n_patch*m*S) f32 in tiled point order
        ((patch*m + member)*S + sample) and cand_w (B, Mp, n_patch, m, S)
        f32.

    Differentiable in both tables, xt and xs at m = 16; ``valid`` takes no
    gradient. CUDA tensors go to the mode's kernel and their gradient to
    kernel 2b (or raise); CPU tensors to ``tilewin_combine_plain``.
    """
    mode = resolve_mode(mode)
    _check_inputs(feat_table, mask_table, frows, mrows, xt, xs, valid,
                  feat_dim, S, mode)
    if feat_table.is_cuda:
        if not all(t.is_contiguous() for t in (feat_table, mask_table, frows,
                                                mrows, xt, xs, valid)):
            raise ValueError("the CUDA kernel takes contiguous tensors")
        return _TilewinCombine.apply(feat_table, mask_table, frows, mrows, xt,
                                     xs, valid, feat_dim, S, clamp_mask, mode)
    return tilewin_combine_plain(feat_table, mask_table, frows, mrows, xt, xs,
                                 valid, feat_dim, S, clamp_mask,
                                 round_t=mode in ("dot", "bdiag"))
