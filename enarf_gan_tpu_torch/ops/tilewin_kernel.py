"""Patch-window (tilewin) combine: the hand-written Hopper kernels and their
plain twins (port of ``enarf_gan_tpu/ops/tilewin_kernel.py``).

``tilewin_combine`` reads the texel table of ``ops/unirow.py::pack_texels``
((B, 3, H+2, W+2, 64) bf16, one 128-byte line a texel: 32 feature lanes,
then bone k's mask logit at lane 32 + k), the table the exact sampler reads
too. For every (unit, slot, plane) the plan names the base texel of the
group's 8x8 window and the slot's bone; the members' in-window coordinates
pick their 2x2 texels. It returns the candidate-weighted feature of every
point and the candidate weights. ``mode`` (or ``ENARF_TILEWIN_KERNEL``,
default "hat") picks the formulation, as in the JAX package:

* "hat": ``csrc/tilewin_combine.cu`` (kernel 2, replaces the Pallas kernel
  ``_combine_kernel_hat``), m = 4 or 16;
* "dot", "bdiag", "vpu": ``csrc/tilewin_combine_modes.cu`` (kernel 3,
  replaces ``_combine_kernel`` and ``_combine_kernel_bdiag``), m = 16: the
  t-contraction as a matrix product over whole window rows, on the tensor
  cores with the t-weights rounded to bf16 ("dot", "bdiag") or in float32
  FMAs ("vpu"). It reads the TPU's window rows, which the wrapper builds
  from the texel table without gradient (``windows_from_texels``, the rows
  of ``ops/tilewin.py::pack_tilewin`` bit for bit).

Each kernel does the table reads itself. On the card the combine is a
``torch.autograd.Function`` whose backward is ``csrc/tilewin_combine_bwd.cu``
(kernel 2b) whatever the mode: the function is the same, and the JAX
package's backward ignores the mode too. Gradients reach the texel table
(as one float32 texel gradient, rounded once to bf16 at the autograd
boundary; ``pack_texels``' slice and permute carry it to the planes) and
the coordinates xt, xs. The coarse-corner pass (m = 4) runs without
gradients, as the JAX one runs under ``stop_gradient``: asking for one at
m = 4 raises. On a CPU tensor every mode runs
``tilewin_combine_texels_plain``, which autograd differentiates.

The JAX package's window tables (``pack_tilewin``: every stride-2 8x8
window of the padded planes, 198 MB of features and 142 MB of masks an
image at 256² planes) stay as the reference layout: ``tilewin_combine_plain``
combines them, and the texel twin computes the same numbers.

A unit is one (patch, sample): U = n_patch * S units, each with m member
rays (m = 16 for 4x4 patches, m = 4 on the coarse-corner pass).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.ops.activation import straight_through_clamp
from enarf_gan_tpu_torch.ops.unirow import (FEAT_BLOCK, MASK_BLOCK,
                                            TEXEL_WIDTH)

WIN = 8
NTEX = WIN * WIN
STRIDE = 2                      # window base stride, texels
SUB, LANE = 16, 128             # a feature window row: 16 x 128 bf16
KERNEL_FEAT_DIM = 32            # the kernel maps channel f to warp lane f
KERNEL_MEMBERS = (4, 16)        # member counts kernel 2 is built for
GRAD_MEMBERS = 16               # the member count with a backward (kernel 2b)
MODES = ("hat", "dot", "vpu", "bdiag")
MATRIX_MODES = ("dot", "vpu", "bdiag")    # kernel 3: m = 16 only
# kernel 2's stage ablations (tools/ablate.py), in the order of the C enum
HAT_STAGES = ("full", "stream", "noweights", "nomask", "nofeat")


# launches counted by member count (kernel 2) and by mode (kernel 3)
KERNEL = KernelLibrary("tilewin_combine", "tilewin_combine_bf16",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p], keys=KERNEL_MEMBERS)
KERNEL_MODES = KernelLibrary("tilewin_combine_modes",
                             "tilewin_combine_modes_bf16",
                             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p], keys=MATRIX_MODES)
KERNEL_BWD = KernelLibrary("tilewin_combine_bwd", "tilewin_combine_bwd_bf16",
                           [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])


def resolve_mode(mode: Optional[str]) -> str:
    """``mode``, or ``ENARF_TILEWIN_KERNEL`` (default "hat") when None."""
    if mode is None:
        mode = os.environ.get("ENARF_TILEWIN_KERNEL", "hat")
    if mode not in MODES:
        raise ValueError(f"tilewin combine mode must be one of {MODES}, got "
                         f"{mode!r}")
    return mode


def num_bases(size: int) -> int:
    """Window bases per plane dimension: quad top-left texels span
    [0, size] in the zero-padded plane and the quad extends to +1, so the
    last window must reach texel size+1."""
    return (size - WIN + 3 + STRIDE - 1) // STRIDE + 1


def texel_cells(x: torch.Tensor):
    """In-window position x in [0, WIN-1) → (top-left texel i <= WIN-2,
    fraction). An f32 offset + fraction that rounds up to WIN-1 keeps i at
    WIN-2 with fraction 1, the value the TPU kernel's hats give."""
    i = x.floor().clamp(max=WIN - 2)
    return i.long(), x - i


def texel_corners(bases: torch.Tensor, i: torch.Tensor, k: torch.Tensor,
                  Wp: int) -> torch.Tensor:
    """The texel-table texel of corner (0, 0) of each member's 2x2 quad,
    int64; corner (dt, ds) is that + dt*Wp + ds, with Wp = W+2 texels a
    table row. ``bases`` (B, 3, Mp, U) are window base texels, i and k
    (B, 3, Mp, m, U) the members' in-window cells. On planes of at least
    WIN texels a side the plan keeps every corner within rows and columns
    H+1, W+1 (``ops/tilewin.py::texel_plan``)."""
    return bases.long()[:, :, :, None, :] + i * Wp + k


def _hat_combine(feat_at, mask_at, ft, fs, valid, S, feat_dim, clamp_mask,
                 round_t, stage):
    """The combine from the members' corner values, in float32:
    ``feat_at(dt, ds)`` gives the feature (…, F) and ``mask_at(dt, ds)`` the
    mask logit (…) of corner (dt, ds) of each (batch, plane, slot, member,
    unit); ft, fs are the bilinear fractions (B, 3, Mp, m, U)."""
    B, _, Mp, m, U = ft.shape
    n_patch = U // S
    if stage == "noweights":
        ft = fs = torch.full_like(ft, 0.5)
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
        feat = feat + feat_at(dt, ds).float() * wf[..., None]
        if stage != "nomask":
            logit = logit + mask_at(dt, ds).float() * w
    feat = feat.sum(dim=1)                                 # (B,Mp,m,U,F)
    logit = logit * valid[:, None]
    if clamp_mask:
        logit = straight_through_clamp(logit)
    cand_w = torch.sigmoid(logit).prod(dim=1)              # (B,Mp,m,U)
    feature = (feat * (cand_w * valid)[..., None]).sum(dim=1)   # (B,m,U,F)
    feature = feature.reshape(B, m, n_patch, S, feat_dim) \
        .permute(0, 4, 2, 1, 3).reshape(B, feat_dim, n_patch * m * S)
    cand_w = cand_w.reshape(B, Mp, m, n_patch, S).permute(0, 1, 3, 2, 4)
    return feature, cand_w.contiguous()


def _check_stage(stage):
    if stage not in HAT_STAGES:
        raise ValueError(f"stage must be one of {HAT_STAGES}, got {stage!r}")


def tilewin_combine_plain(feat_table, mask_table, frows, mrows, xt, xs, valid,
                          feat_dim: int, S: int, clamp_mask: bool,
                          round_t: bool = False, stage: str = "full"):
    """Plain PyTorch gather + combine on the window tables of
    ``pack_tilewin`` (the JAX layout; the kernels read the texel table):
    the reference of ``tilewin_combine_texels_plain``.

    feat_table (R, 16, 128) and mask_table (Rm, 64) bf16 window rows;
    frows, mrows (B, 3, Mp, U) int32 the rows of each (plane, slot, unit);
    the other arguments and the results are ``tilewin_combine``'s. Gathers
    each member's 2x2 texels corner by corner and computes in float32 from
    the bf16 rows, as the kernels do. ``round_t`` rounds the t-direction
    weights (hat x valid) to bf16, as the "dot" and "bdiag" formulations do
    (the JAX ``A.astype(jnp.bfloat16)``). Under autograd it gathers from
    float32 copies of the tables, so the table gradients accumulate in
    float32.

    ``stage`` other than "full" is the window-layout counterpart of one of
    kernel 2's stage ablations (see ``tilewin_combine_texels_plain``), with
    the row indices in place of the base texels and bones: "stream" reads a
    feature texel as (frow & 255) / 256 and a mask texel as
    (mrow & 255) / 256.
    """
    _check_stage(stage)
    F_ = feat_dim
    if torch.is_grad_enabled() and feat_table.requires_grad:
        feat_table = feat_table.float()
    if torch.is_grad_enabled() and mask_table.requires_grad:
        mask_table = mask_table.float()
    tex = feat_table.reshape(feat_table.shape[0], -1)[:, :NTEX * F_] \
        .reshape(-1, F_)                                   # (R*64, F)
    msk = mask_table.reshape(-1)                           # (Rm*64,)
    i, ft = texel_cells(xt)                                # (B,3,Mp,m,U)
    k, fs = texel_cells(xs)
    cell = i * WIN + k
    frow = frows.long()[:, :, :, None, :] * NTEX + cell
    mrow = mrows.long()[:, :, :, None, :] * NTEX + cell
    ones = torch.ones(F_, device=ft.device)

    def feat_at(dt, ds):
        if stage == "stream":
            return ((frows[:, :, :, None, :] & 255).float() / 256)[..., None] \
                * ones
        if stage == "nofeat":
            return ones
        off = dt * WIN + ds
        return tex[(frow + off).reshape(-1)].reshape(*frow.shape, F_)

    def mask_at(dt, ds):
        if stage == "stream":
            return (mrows[:, :, :, None, :] & 255).float() / 256
        return msk[mrow + dt * WIN + ds]

    return _hat_combine(feat_at, mask_at, ft, fs, valid, S, F_, clamp_mask,
                        round_t, stage)


def tilewin_combine_texels_plain(texels, bases, bones, xt, xs, valid,
                                 feat_dim: int, S: int, clamp_mask: bool,
                                 round_t: bool = False, stage: str = "full"):
    """Plain PyTorch gather + combine on the texel table (the twin of the
    kernels): same arguments and results as ``tilewin_combine``. Gathers
    each member's 2x2 texels (``texel_corners``) corner by corner and
    computes in float32, in the order of ``tilewin_combine_plain``, which
    gives the same numbers from the window tables. ``round_t`` as there.
    Under autograd it gathers from a float32 copy of the table, so the
    texel gradient accumulates in float32, as kernel 2b's does.

    ``stage`` other than "full" is the twin of one of kernel 2's stage
    ablations (``csrc/tilewin_combine.cu``, ``tools/ablate.py``): "stream"
    reads a feature texel as (base & 255) / 256 and a mask texel as
    bone / 256, "noweights" sets both bilinear fractions to 0.5, "nomask"
    sets every logit to 0 and "nofeat" every feature texel to 1.
    """
    _check_stage(stage)
    F_ = feat_dim
    if torch.is_grad_enabled() and texels.requires_grad:
        texels = texels.float()
    Wp, TW = texels.shape[3:]
    tab = texels.reshape(-1, TW)
    flat = texels.reshape(-1)
    i, ft = texel_cells(xt)                                # (B,3,Mp,m,U)
    k, fs = texel_cells(xs)
    t00 = texel_corners(bases, i, k, Wp)
    lane = FEAT_BLOCK + bones.long()[:, None, :, None, :]  # (B,1,Mp,1,U)
    ones = torch.ones(F_, device=ft.device)

    def feat_at(dt, ds):
        if stage == "stream":
            return ((bases[:, :, :, None, :] & 255).float() / 256)[..., None] \
                * ones
        if stage == "nofeat":
            return ones
        t = t00 + (dt * Wp + ds)
        return tab[:, :F_][t.reshape(-1)].reshape(*t.shape, F_)

    def mask_at(dt, ds):
        if stage == "stream":
            return (bones[:, None, :, None, :] & 255).float() / 256
        return flat[(t00 + (dt * Wp + ds)) * TW + lane]

    return _hat_combine(feat_at, mask_at, ft, fs, valid, S, F_, clamp_mask,
                        round_t, stage)


def windows_from_texels(texels: torch.Tensor, nb: int,
                        n_bones: int = MASK_BLOCK):
    """The window tables of ``pack_tilewin`` built from the texel table:
    feature rows (B*3*nb*nb, 16, 128) and mask rows (B*n_bones*3*nb*nb, 64)
    bf16, the 8x8 windows at base (2bi, 2bj) of the padded planes (bone k's
    mask rows from lane 32 + k). Bone k < K's rows and, at F = 32, every
    feature row equal ``pack_tilewin``'s: the same bf16 values, the same
    zeros past the table. Kernel 3's input; built without gradient (its gradient goes
    through kernel 2b into the texel table)."""
    B, _, Hp, Wp, _ = texels.shape
    span = (nb - 1) * STRIDE + WIN
    with torch.no_grad():
        pt = F.pad(texels, (0, 0, 0, span - Wp, 0, span - Hp))
        fw = pt[..., :FEAT_BLOCK].unfold(2, WIN, STRIDE) \
            .unfold(3, WIN, STRIDE)                        # (B,3,nb,nb,F,t,s)
        fw = fw.permute(0, 1, 2, 3, 5, 6, 4).reshape(-1, SUB, LANE)
        mw = pt[..., FEAT_BLOCK:FEAT_BLOCK + n_bones].permute(0, 4, 1, 2, 3) \
            .unfold(3, WIN, STRIDE).unfold(4, WIN, STRIDE)  # (B,K,3,nb,nb,t,s)
        mw = mw.reshape(-1, NTEX)
    return fw, mw


def window_rows(bases: torch.Tensor, bones: torch.Tensor, Hp: int, Wp: int,
                nb: int, n_bones: int = MASK_BLOCK):
    """The window rows of ``windows_from_texels``' tables that a plan's base
    texels and bones name: frows, mrows (B, 3, Mp, U) int32."""
    b = bases.long()
    plane = torch.div(b, Hp * Wp, rounding_mode="floor")   # batch*3 + p
    bi = torch.div(b, Wp, rounding_mode="floor") % Hp // STRIDE
    bj = b % Wp // STRIDE
    frows = (plane * nb + bi) * nb + bj
    batch = torch.div(plane, 3, rounding_mode="floor")
    p = plane % 3
    mrows = (((batch * n_bones + bones.long()[:, None]) * 3 + p) * nb + bi) \
        * nb + bj
    return frows.to(torch.int32).contiguous(), mrows.to(torch.int32) \
        .contiguous()


def _check_coords(xt, xs, valid, B, Mp, U, S):
    if xt.dim() != 5 or tuple(xt.shape[:3]) != (B, 3, Mp) or xt.shape[4] != U:
        raise ValueError(f"xt must be (B, 3, Mp, m, U) = ({B}, 3, {Mp}, m, "
                         f"{U}), got {tuple(xt.shape)}")
    m = xt.shape[3]
    if S <= 0 or U % S:
        raise ValueError(f"S={S} does not divide U={U}")
    return m, {"xt": (xt, (B, 3, Mp, m, U), torch.float32),
               "xs": (xs, (B, 3, Mp, m, U), torch.float32),
               "valid": (valid, (B, Mp, m, U), torch.float32)}


def _check_want(want, device, ref_name):
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on "
                             f"{device}")


def _check_grad(m, valid, *diff):
    if torch.is_grad_enabled():
        if valid.requires_grad:
            raise ValueError("valid takes no gradient (it comes from a bool); "
                             "detach it")
        if m != GRAD_MEMBERS and any(t.requires_grad for t in diff):
            raise ValueError(f"the tilewin combine has a backward for m = "
                             f"{GRAD_MEMBERS} only (the coarse-corner pass, "
                             f"m = {m}, runs under torch.no_grad()), got a "
                             f"gradient request")


def _check_mode(mode, m, feat_dim):
    if mode in MATRIX_MODES and (m != 16 or feat_dim != KERNEL_FEAT_DIM):
        raise ValueError(f"mode {mode!r} takes m = 16 members and feat_dim "
                         f"{KERNEL_FEAT_DIM}, got m={m} feat_dim={feat_dim}")


def _check_inputs(texels, bases, bones, xt, xs, valid, feat_dim, S, mode):
    if texels.dim() != 5 or texels.dtype != torch.bfloat16 \
            or texels.shape[1] != 3 or texels.shape[4] != TEXEL_WIDTH:
        raise ValueError(f"the tilewin combine reads the texel table, "
                         f"(B, 3, H+2, W+2, {TEXEL_WIDTH}) bfloat16 "
                         f"(pack_texels), got {tuple(texels.shape)} "
                         f"{texels.dtype}")
    if feat_dim > FEAT_BLOCK:
        raise ValueError(f"a texel holds F <= {FEAT_BLOCK} channels, got "
                         f"feat_dim {feat_dim}")
    if min(texels.shape[2:4]) < WIN + 2:
        raise ValueError(f"the tilewin combine takes planes of at least {WIN} "
                         f"texels a side, got a table of "
                         f"{tuple(texels.shape)}")
    B = texels.shape[0]
    if bases.dim() != 4 or tuple(bases.shape[:2]) != (B, 3):
        raise ValueError(f"bases must be (B, 3, Mp, U), got "
                         f"{tuple(bases.shape)}")
    Mp, U = bases.shape[2:]
    m, want = _check_coords(xt, xs, valid, B, Mp, U, S)
    want = {"bases": (bases, (B, 3, Mp, U), torch.int32),
            "bones": (bones, (B, Mp, U), torch.int32), **want}
    _check_want(want, texels.device, "texels")
    _check_mode(mode, m, feat_dim)
    _check_grad(m, valid, texels, xt, xs)


def _check_window_inputs(feat_table, mask_table, frows, mrows, xt, xs, valid,
                         feat_dim, S, mode):
    """The window-table inputs of kernel 3 and of the window twin."""
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
    m, want = _check_coords(xt, xs, valid, B, Mp, U, S)
    want = {"frows": (frows, (B, 3, Mp, U), torch.int32),
            "mrows": (mrows, (B, 3, Mp, U), torch.int32),
            "mask_table": (mask_table, tuple(mask_table.shape), torch.bfloat16),
            **want}
    _check_want(want, feat_table.device, "feat_table")
    _check_mode(mode, m, feat_dim)
    _check_grad(m, valid, feat_table, mask_table, xt, xs)


def _check_kernel_shapes(texels, bases, xt, feat_dim):
    """(B, H, W, Mp, m, U) for kernels 2 and 2b, or raise on what they do
    not take."""
    B, _, Hp, Wp, _ = texels.shape
    Mp, U = bases.shape[2:]
    m = xt.shape[3]
    if feat_dim != KERNEL_FEAT_DIM:
        raise ValueError(f"the CUDA kernel takes feat_dim {KERNEL_FEAT_DIM} "
                         f"(a texel's 32 feature lanes), got feat_dim "
                         f"{feat_dim}")
    if m not in KERNEL_MEMBERS:
        raise ValueError(f"the CUDA kernel takes m in {KERNEL_MEMBERS} "
                         f"members a unit, got m={m}")
    if B > 65535 or U * m >= 2 ** 31 or Mp * U * m >= 2 ** 31 \
            or B * 3 * Hp * Wp >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: B={B} H={Hp - 2} "
                         f"W={Wp - 2} Mp={Mp} m={m} U={U}")
    return B, Hp - 2, Wp - 2, Mp, m, U


def launch_modes(feat_table, mask_table, frows, mrows, xt, xs, valid,
                 feat_dim, S, clamp_mask, mode):
    """Kernel 3 in ``mode`` on window rows (``windows_from_texels``):
    feature (B, F, n) and cand_w (B, Mp, n_patch, 16, S), no gradient."""
    _check_window_inputs(feat_table, mask_table, frows, mrows, xt, xs, valid,
                         feat_dim, S, mode)
    if mode not in MATRIX_MODES:
        raise ValueError(f"kernel 3 runs the modes {MATRIX_MODES}, got "
                         f"{mode!r}")
    inputs = (feat_table, mask_table, frows, mrows, xt, xs, valid)
    if not feat_table.is_cuda or not all(t.is_contiguous() for t in inputs):
        raise ValueError("kernel 3 takes contiguous CUDA tensors")
    if feat_dim != KERNEL_FEAT_DIM or \
            feat_table.shape[1] * feat_table.shape[2] != NTEX * feat_dim:
        raise ValueError(f"the CUDA kernel takes feat_dim {KERNEL_FEAT_DIM} "
                         f"(rows of {NTEX * KERNEL_FEAT_DIM} lanes), got "
                         f"feat_dim {feat_dim}")
    B, _, Mp, U = frows.shape
    if B > 65535 or Mp * U * 16 >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: B={B} Mp={Mp} "
                         f"U={U}")
    n = U * 16
    feature = torch.empty((B, feat_dim, n), dtype=torch.float32,
                          device=feat_table.device)
    cand_w = torch.empty((B, Mp, U // S, 16, S), dtype=torch.float32,
                         device=feat_table.device)
    if U == 0:
        return feature, cand_w
    stream = torch.cuda.current_stream(feat_table.device).cuda_stream
    ptrs = [t.data_ptr() for t in inputs] + [feature.data_ptr(),
                                             cand_w.data_ptr()]
    err = KERNEL_MODES.load()(*ptrs, B, Mp, U, S, int(clamp_mask),
                              int(mode != "vpu"), stream)
    if err != 0:
        raise RuntimeError(f"tilewin_combine_modes kernel ({mode}) launch "
                           f"failed: CUDA error {err}")
    KERNEL_MODES.count(mode)
    return feature, cand_w


def _launch_kernel(texels, bases, bones, xt, xs, valid, feat_dim, S,
                   clamp_mask, mode="hat"):
    """Kernel 2 ("hat") on the texel table, or kernel 3 (the matrix modes)
    on window rows built from it: feature (B, F, n) and cand_w
    (B, Mp, n_patch, m, S)."""
    B, H, W, Mp, m, U = _check_kernel_shapes(texels, bases, xt, feat_dim)
    if mode != "hat":
        if H != W:
            raise ValueError(f"kernel 3 takes square planes, got {H}x{W}")
        nb = num_bases(H)
        feat_w, mask_w = windows_from_texels(texels, nb)
        frows, mrows = window_rows(bases, bones, H + 2, W + 2, nb)
        return launch_modes(feat_w, mask_w, frows, mrows, xt, xs, valid,
                            feat_dim, S, clamp_mask, mode)
    feature = torch.empty((B, feat_dim, U * m), dtype=torch.float32,
                          device=texels.device)
    cand_w = torch.empty((B, Mp, U // S, m, S), dtype=torch.float32,
                         device=texels.device)
    if U == 0:
        return feature, cand_w
    stream = torch.cuda.current_stream(texels.device).cuda_stream
    ptrs = [t.data_ptr() for t in (texels, bases, bones, xt, xs, valid,
                                   feature, cand_w)]
    err = KERNEL.load()(*ptrs, B, H, W, Mp, m, U, S, int(clamp_mask), stream)
    if err != 0:
        raise RuntimeError(f"tilewin_combine kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL.count(m)
    return feature, cand_w


def launch_backward(texels, bases, bones, xt, xs, valid, dfeature, dcand_w,
                    feat_dim, S, clamp_mask):
    """Kernel 2b: the gradients of ``tilewin_combine``'s two outputs with
    respect to the texel table, (B, 3, H+2, W+2, 64) float32 (mask lanes of
    bones no slot names stay zero), and to xt and xs."""
    B, H, W, Mp, m, U = _check_kernel_shapes(texels, bases, xt, feat_dim)
    if m != GRAD_MEMBERS:
        raise ValueError(f"the backward kernel takes m = {GRAD_MEMBERS}, got "
                         f"m={m}")
    dev = texels.device
    dtexels = torch.zeros(texels.shape, dtype=torch.float32, device=dev)
    dxt = torch.empty_like(xt)
    dxs = torch.empty_like(xs)
    if U == 0:
        return dtexels, dxt, dxs
    dfeature = dfeature.float().contiguous()
    dcand_w = dcand_w.float().contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = KERNEL_BWD.load()(
        *(t.data_ptr() for t in (texels, bases, bones, xt, xs, valid,
                                 dfeature, dcand_w, dtexels, dxt, dxs)),
        B, H, W, Mp, U, S, int(clamp_mask), stream)
    if err != 0:
        raise RuntimeError(f"tilewin_combine backward kernel launch failed: "
                           f"CUDA error {err}")
    KERNEL_BWD.count()
    return dtexels, dxt, dxs


class _TilewinCombine(torch.autograd.Function):
    """Kernel 2 or 3 forward, kernel 2b backward."""

    @staticmethod
    def forward(ctx, texels, bases, bones, xt, xs, valid, feat_dim, S,
                clamp_mask, mode):
        ctx.save_for_backward(texels, bases, bones, xt, xs, valid)
        ctx.feat_dim, ctx.S, ctx.clamp_mask = feat_dim, S, clamp_mask
        return _launch_kernel(texels, bases, bones, xt, xs, valid, feat_dim,
                              S, clamp_mask, mode)

    @staticmethod
    def backward(ctx, dfeature, dcand_w):
        dtexels, dxt, dxs = launch_backward(
            *ctx.saved_tensors, dfeature, dcand_w, ctx.feat_dim, ctx.S,
            ctx.clamp_mask)
        # dtexels is float32, every unit, slot and sample that shares a
        # texel summed in it; autograd rounds it once to the bf16 table's
        # type here, and pack_texels' backward carries it on to the planes
        return dtexels, None, None, dxt, dxs, None, None, None, None, None


def tilewin_combine(texels, bases, bones, xt, xs, valid, feat_dim: int,
                    S: int, clamp_mask: bool, mode: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + combine the members' texels of each (plane, slot, unit).

    Args:
        texels: (B, 3, H+2, W+2, 64) bf16 from ``pack_texels``.
        bases: (B, 3, Mp, U) int32 base texel of each (plane, slot, unit)
            window, over the whole table:
            ((b*3 + p)*(H+2) + bt)*(W+2) + bs.
        bones: (B, Mp, U) int32 bone of each (slot, unit), < 32.
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

    Differentiable in ``texels``, xt and xs at m = 16; ``valid`` takes no
    gradient. CUDA tensors go to the mode's kernel and their gradient to
    kernel 2b (or raise); CPU tensors to ``tilewin_combine_texels_plain``.
    """
    mode = resolve_mode(mode)
    _check_inputs(texels, bases, bones, xt, xs, valid, feat_dim, S, mode)
    if texels.is_cuda:
        if not all(t.is_contiguous() for t in (texels, bases, bones, xt, xs,
                                                valid)):
            raise ValueError("the CUDA kernel takes contiguous tensors")
        return _TilewinCombine.apply(texels, bases, bones, xt, xs, valid,
                                     feat_dim, S, clamp_mask, mode)
    return tilewin_combine_texels_plain(texels, bases, bones, xt, xs, valid,
                                        feat_dim, S, clamp_mask,
                                        round_t=mode in ("dot", "bdiag"))
