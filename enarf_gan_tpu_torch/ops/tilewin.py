"""Patch-window tri-plane sampling (port of ``enarf_gan_tpu/ops/tilewin.py``).

With depth bins pooled per 4x4-pixel patch (``nerf/tiled.py``), the member
rays of a (patch, sample, bone, plane) group land within a few texels of
each other, so one 8x8-texel window serves the whole group:

* ``pack_tilewin_texels`` packs the planes once per frame into the texel
  table of ``ops/unirow.py::pack_texels`` (the exact sampler's table: every
  texel of the zero-padded planes once, 25.6 MB an image at 256² planes);
  each stride-2 window is a base texel and the 8x8 texels below and right
  of it;
* ``select_patch_slots`` picks the Mp candidate bones of each (patch,
  sample);
* ``texel_plan`` picks each group's window base texel and the members'
  in-window coordinates;
* ``tilewin_combine`` (``ops/tilewin_kernel.py``) reads the members' texels
  and combines them: a CUDA kernel on the card (with a backward kernel), its
  plain twin on the CPU.

``sample_tilewin_fused`` is that chain and the one sampler the renderer
calls; ``sample_tilewin`` is the same chain with the plain combine, for CPU
tensors only. ``sample_tilewin`` also takes the JAX package's window tables
(``pack_tilewin``: every window packed into a 4 KB feature row and a mask
row per bone, 340 MB an image at 256² planes) with their plan
(``_fused_plan``): the JAX layout, kept as the reference (the JAX XLA path,
in float32 where the JAX einsum rounds the bilinear weights to bf16).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch.ops.tilewin_kernel import (LANE, NTEX, STRIDE, SUB,
                                                    WIN, num_bases,
                                                    tilewin_combine,
                                                    tilewin_combine_plain,
                                                    tilewin_combine_texels_plain)
from enarf_gan_tpu_torch.ops.triplane import PLANE_COORDS
from enarf_gan_tpu_torch.ops.unirow import pack_texels

RESCUE_W = 0.5     # uncovered-member rescue weight in select_patch_slots


class TilewinTables(NamedTuple):
    feat: torch.Tensor   # (B*3*nb*nb, SUB, LANE) bf16 window rows
    mask: torch.Tensor   # (B*K*3*nb*nb, 64) bf16
    nb: int              # window bases per plane dim
    feat_dim: int
    num_bone: int
    size: int            # plane resolution (H == W)


class TilewinTexels(NamedTuple):
    """What the tiled sampler reads: the texel table and what its plan
    needs to know of the planes."""
    texels: torch.Tensor  # (B, 3, H+2, W+2, 64) bf16 from pack_texels
    feat_dim: int
    num_bone: int
    size: int             # plane resolution (H == W)


class TilewinPlan(NamedTuple):
    """What ``tilewin_combine`` reads, unit axis U = n_patch * S minor."""
    frows: torch.Tensor              # (B, 3, Mp, U) int32 feature rows
    mrows: torch.Tensor              # (B, 3, Mp, U) int32 mask rows
    xt: torch.Tensor                 # (B, 3, Mp, m, U) f32 in [0, WIN-1)
    xs: torch.Tensor
    valid: torch.Tensor              # (B, Mp, m, U) f32
    clamped: Optional[torch.Tensor]  # share of valid fetches edge-clamped


class TexelPlan(NamedTuple):
    """What ``tilewin_combine`` reads beside the texel table, unit axis
    U = n_patch * S minor."""
    bases: torch.Tensor              # (B, 3, Mp, U) int32 window base texels
    bones: torch.Tensor              # (B, Mp, U) int32 slot bones
    xt: torch.Tensor                 # (B, 3, Mp, m, U) f32 in [0, WIN-1)
    xs: torch.Tensor
    valid: torch.Tensor              # (B, Mp, m, U) f32
    clamped: Optional[torch.Tensor]  # share of valid fetches edge-clamped


def pack_tilewin_texels(tri_plane_feature: torch.Tensor, feat_dim: int,
                        num_bone: int) -> TilewinTexels:
    """(B, (F+K)*3, H, W) planes → the texel table (``pack_texels``) with
    F, K and the plane size. Differentiable: the texel gradient
    goes back to the planes through ``pack_texels``' slice and permute."""
    B, C3, H, W = tri_plane_feature.shape
    if C3 != (feat_dim + num_bone) * 3 or H != W or H < WIN:
        raise ValueError(f"planes {tuple(tri_plane_feature.shape)} do not "
                         f"hold F={feat_dim}, K={num_bone} on a square plane "
                         f"of at least {WIN} texels")
    return TilewinTexels(pack_texels(tri_plane_feature, feat_dim, num_bone),
                         feat_dim, num_bone, H)


def pack_tilewin(tri_plane_feature: torch.Tensor, feat_dim: int,
                 num_bone: int) -> TilewinTables:
    """(B, (F+K)*3, H, W) planes → packed window tables.

    Feature rows hold the 8x8xF window at base (2bi, 2bj) of the 1-texel
    zero-padded plane, texel-major (lane (t*8+s)*F + f); mask rows hold the
    same window of one bone's mask plane, one texel per lane (t*8+s). The
    windows are strided views of the padded bf16 planes (``unfold``), so the
    only copy made is the table itself.
    """
    B, C3, H, W = tri_plane_feature.shape
    F_, K = feat_dim, num_bone
    if C3 != (F_ + K) * 3 or H != W:
        raise ValueError(f"planes {tuple(tri_plane_feature.shape)} do not "
                         f"hold F={F_}, K={K} on a square plane")
    nb = num_bases(H)
    span = (nb - 1) * STRIDE + WIN     # padded extent the windows address
    feat = tri_plane_feature[:, :F_ * 3].reshape(B, 3, F_, H, W) \
        .permute(0, 1, 3, 4, 2)                                # (B,3,H,W,F)
    mask = tri_plane_feature[:, F_ * 3:].reshape(B, K, 3, H, W)
    pf = F.pad(feat.to(torch.bfloat16),
               (0, 0, 1, span - W - 1, 1, span - H - 1))
    pm = F.pad(mask.to(torch.bfloat16), (1, span - W - 1, 1, span - H - 1))

    fw = pf.unfold(2, WIN, STRIDE).unfold(3, WIN, STRIDE)  # (B,3,nb,nb,F,t,s)
    fw = fw.permute(0, 1, 2, 3, 5, 6, 4).reshape(B * 3 * nb * nb, NTEX * F_)
    width = -(-NTEX * F_ // (SUB * LANE)) * SUB * LANE
    if width != NTEX * F_:
        fw = F.pad(fw, (0, width - NTEX * F_))
    fw = fw.reshape(-1, width // LANE, LANE)

    mw = pm.unfold(3, WIN, STRIDE).unfold(4, WIN, STRIDE)  # (B,K,3,nb,nb,t,s)
    mw = mw.reshape(B * K * 3 * nb * nb, NTEX)
    return TilewinTables(fw, mw, nb, F_, K, H)


def member_texels(cp: torch.Tensor, size: int):
    """Padded-plane texel coordinates and bilinear fractions per (plane,
    member).

    cp: (B, 3, Mp, n) canonical positions in [-1, 1]. Returns py, px
    (B, 3, Mp, n) int32 in [0, size] (top-left texel of the 2x2 quad in the
    1-texel zero-padded plane) and fy, fx fractions (align_corners=False,
    zero padding: the pad ring is the zero border).
    """
    H = W = size
    pys, pxs, fys, fxs = [], [], [], []
    for i, j in PLANE_COORDS:
        x = (cp[:, i] + 1) * (W / 2) - 0.5
        y = (cp[:, j] + 1) * (H / 2) - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fxs.append(x - x0)
        fys.append(y - y0)
        pxs.append(x0.clamp(-1, W - 1).to(torch.int32) + 1)
        pys.append(y0.clamp(-1, H - 1).to(torch.int32) + 1)
    stack = lambda l: torch.stack(l, dim=1)  # noqa: E731
    return stack(pys), stack(pxs), stack(fys), stack(fxs)


def group_bases(py, px, valid, nb: int, member_dim: int = 4):
    """Window base (stride-aligned, clipped) of each group from the member
    texel minima over ``member_dim`` (invalid members excluded)."""
    big = 10 ** 6
    inv = torch.where(valid, 0, big).to(py.dtype)
    min_t = (py + inv).amin(dim=member_dim)
    min_s = (px + inv).amin(dim=member_dim)
    hi = (nb - 1) * STRIDE
    bt = ((min_t // STRIDE) * STRIDE).clamp(0, hi)
    bs = ((min_s // STRIDE) * STRIDE).clamp(0, hi)
    return bt, bs


def _sep_weights(d, f, lim: int):
    """lim-wide separable bilinear weight vector
    w[i] = [i==d](1-f) + [i==d+1]f; d is clipped into [0, lim-1]."""
    d = d.clamp(0, lim - 1)
    iota = torch.arange(lim, device=d.device)
    dd = d[..., None]
    ff = f[..., None]
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    return torch.where(iota == dd, 1.0 - ff,
                       torch.where(iota == dd + 1, ff, zero))


def select_patch_slots(canonical: torch.Tensor, validity: torch.Tensor,
                       n_patch: int, m: int, S: int, Mp: int):
    """Patch-level candidate bones: the Mp best bones per (patch, sample).

    Greedy: each slot takes the bone maximizing (max member score: valid ?
    1 + cube-centrality : -1) + RESCUE_W * (count of still-uncovered members
    it would cover); ties go to the lowest bone index, as ``jnp.argmax``
    breaks them.

    Args:
        canonical: (B, K, 3, n) canonical positions, point order
            ((patch*m + member)*S + sample); validity: (B, K, n) bool.
    Returns:
        slot_idx (B, Mp, np, S) int32; cand_pos (B, 3, Mp, np, m, S);
        cand_valid (B, Mp, np, m, S) bool.
    """
    B, K, _, n = canonical.shape
    if n != n_patch * m * S:
        raise ValueError(f"{n} points are not {n_patch}x{m}x{S}")
    centrality = 1.0 - canonical.abs().amax(dim=2)          # (B, K, n)
    score_m = torch.where(validity, 1.0 + centrality,
                          torch.full_like(centrality, -1.0)) \
        .reshape(B, K, n_patch, m, S)
    pooled = score_m.amax(dim=3)                            # (B,K,np,S)
    valid_r = validity.reshape(B, K, n_patch, m, S)
    covers = valid_r.to(canonical.dtype)

    bone_ids = torch.arange(K, device=canonical.device).view(1, K, 1, 1)
    uncov = torch.ones((B, 1, n_patch, m, S), dtype=canonical.dtype,
                       device=canonical.device)
    taken = torch.zeros_like(pooled, dtype=torch.bool)
    idx_l = []
    for _ in range(Mp):
        rescue = (covers * uncov).sum(dim=3)                # (B,K,np,S)
        sc = torch.where(taken, torch.full_like(pooled, float("-inf")),
                         pooled + RESCUE_W * rescue)
        i = sc.argmax(dim=1)                                # (B, np, S)
        sel = bone_ids == i[:, None]                        # (B,K,np,S)
        idx_l.append(i)
        taken = taken | sel
        new_cov = (sel[:, :, :, None].to(covers.dtype) * covers) \
            .amax(dim=1, keepdim=True)                      # (B,1,np,m,S)
        uncov = uncov * (1.0 - new_cov)
    slot_idx = torch.stack(idx_l, dim=1)                    # (B,Mp,np,S)

    gi = slot_idx[:, :, None, :, None, :].expand(B, Mp, 3, n_patch, m, S)
    cand_pos = canonical.reshape(B, K, 3, n_patch, m, S).gather(1, gi) \
        .permute(0, 2, 1, 3, 4, 5)                          # (B,3,Mp,np,m,S)
    cand_valid = valid_r.gather(1, gi[:, :, 0])             # (B,Mp,np,m,S)
    return slot_idx.to(torch.int32), cand_pos, cand_valid


def _member_geometry(nb: int, size: int, cand_pos, cand_valid,
                     with_stats: bool):
    """Each group's window base (bt, bs) (B, 3, Mp, U), the members'
    in-window coordinates xt, xs (B, 3, Mp, m, U), validity (B, Mp, m, U)
    and, with ``with_stats``, the share of valid fetches outside their
    group's window (edge-clamped)."""
    B, _, Mp, n_patch, m, S = cand_pos.shape
    U = n_patch * S
    cpT = cand_pos.permute(0, 1, 2, 4, 3, 5)                # (B,3,Mp,m,np,S)
    py, px, fy, fx = member_texels(cpT.reshape(B, 3, Mp, m * U), size)
    pym = py.reshape(B, 3, Mp, m, U)
    pxm = px.reshape(B, 3, Mp, m, U)
    validT = cand_valid.permute(0, 1, 3, 2, 4).reshape(B, Mp, m, U)
    vm = validT[:, None].expand(B, 3, Mp, m, U)
    bt, bs = group_bases(pym, pxm, vm, nb, member_dim=3)    # (B,3,Mp,U)
    dt = pym - bt[:, :, :, None]
    ds = pxm - bs[:, :, :, None]
    clamped = None
    if with_stats:
        out = (dt < 0) | (dt > WIN - 2) | (ds < 0) | (ds > WIN - 2)
        clamped = (out & vm).sum() / vm.sum().clamp(min=1)
    # a member outside its group's window reads the window's edge texels
    # (its clamped cell), as the TPU's window rows make it
    xt = dt.clamp(0, WIN - 2).float() + fy.reshape(B, 3, Mp, m, U)
    xs = ds.clamp(0, WIN - 2).float() + fx.reshape(B, 3, Mp, m, U)
    return bt, bs, xt.contiguous(), xs.contiguous(), \
        validT.float().contiguous(), clamped


def _fused_plan(tables: TilewinTables, cand_pos, slot_idx, cand_valid,
                with_stats: bool = False) -> TilewinPlan:
    """Window rows and member in-window coordinates on the window tables of
    ``pack_tilewin``, unit axis minor."""
    B, _, Mp, n_patch, m, S = cand_pos.shape
    K, nb = tables.num_bone, tables.nb
    U = n_patch * S
    dev = cand_pos.device
    bt, bs, xt, xs, valid, clamped = _member_geometry(
        nb, tables.size, cand_pos, cand_valid, with_stats)
    plane = torch.arange(3, dtype=torch.int32, device=dev).view(1, 3, 1, 1)
    batch = torch.arange(B, dtype=torch.int32, device=dev).view(B, 1, 1, 1)
    bi, bj = bt // STRIDE, bs // STRIDE
    frows = ((batch * 3 + plane) * nb + bi) * nb + bj
    slot_u = slot_idx.reshape(B, Mp, U)[:, None]            # (B,1,Mp,U)
    mrows = (((batch * K + slot_u) * 3 + plane) * nb + bi) * nb + bj
    return TilewinPlan(frows.to(torch.int32).contiguous(),
                       mrows.to(torch.int32).contiguous(), xt, xs, valid,
                       clamped)


def texel_plan(tables: TilewinTexels, cand_pos, slot_idx, cand_valid,
               with_stats: bool = False) -> TexelPlan:
    """Window base texels, slot bones and member in-window coordinates on
    the texel table, unit axis minor.

    The plan stops at indices: ``tilewin_combine`` reads the texels itself,
    so no window is ever gathered or packed. The base texel of (b, p, g, u)
    is ((b*3 + p)*(H+2) + bt)*(W+2) + bs, with (bt, bs) the window base of
    ``group_bases`` (stride-aligned, at most 2(nb-1) <= H-4). A member
    reads rows bt + i and bt + i + 1, i its in-window cell: i <= py - bt
    for a member inside the window (py <= H its quad's top texel), i = 6
    < py - bt past it, i = 0 before it; so no row passes H+1, nor a column
    W+1. The f32 sum xt = (py - bt) + fy could round up to the next integer
    only where fy has bits below the sum's precision, i.e. where py - bt
    exceeds the top texel's binade: never at py = H on a plane of 8 texels
    or more (tests/test_torch_tilewin.py pins both).
    """
    B, _, Mp, n_patch, m, S = cand_pos.shape
    size = tables.size
    U = n_patch * S
    dev = cand_pos.device
    bt, bs, xt, xs, valid, clamped = _member_geometry(
        num_bases(size), size, cand_pos, cand_valid, with_stats)
    plane = torch.arange(3, dtype=torch.int32, device=dev).view(1, 3, 1, 1)
    batch = torch.arange(B, dtype=torch.int32, device=dev).view(B, 1, 1, 1)
    bases = ((batch * 3 + plane) * (size + 2) + bt) * (size + 2) + bs
    bones = slot_idx.reshape(B, Mp, U)
    return TexelPlan(bases.to(torch.int32).contiguous(),
                     bones.to(torch.int32).contiguous(), xt, xs, valid,
                     clamped)


def _with_stats(feature, cand_w, plan, with_stats):
    if not with_stats:
        return feature, cand_w
    return feature, cand_w, {"clamped": plan.clamped}


def sample_tilewin(tables: Union[TilewinTexels, TilewinTables], cand_pos,
                   slot_idx, cand_valid, clamp_mask: bool = False,
                   with_stats: bool = False):
    """Window-shared part probability + weighted feature, plain PyTorch: the
    reference for ``sample_tilewin_fused``, on CPU tensors only (on the card
    the combine is the kernel's, through ``sample_tilewin_fused``).

    Args:
        tables: from ``pack_tilewin_texels`` (the texel table and
            ``tilewin_combine_texels_plain``) or ``pack_tilewin`` (the JAX
            window tables and ``tilewin_combine_plain``); cand_pos
            (B, 3, Mp, np, m, S), slot_idx (B, Mp, np, S) int32 and
            cand_valid (B, Mp, np, m, S) bool from ``select_patch_slots``.
    Returns:
        (feature (B, F, np*m*S) f32, cand_w (B, Mp, np, m, S) f32
        [, stats]); stats = {"clamped": share of valid member-plane fetches
        outside their group window (edge-clamped)}.
    """
    windows = isinstance(tables, TilewinTables)
    if (tables.feat if windows else tables.texels).is_cuda:
        raise ValueError("sample_tilewin is the CPU reference; CUDA tensors "
                         "go through sample_tilewin_fused")
    S = cand_pos.shape[-1]
    if windows:
        plan = _fused_plan(tables, cand_pos, slot_idx, cand_valid, with_stats)
        feature, cand_w = tilewin_combine_plain(
            tables.feat, tables.mask, plan.frows, plan.mrows, plan.xt,
            plan.xs, plan.valid, tables.feat_dim, S, clamp_mask)
    else:
        plan = texel_plan(tables, cand_pos, slot_idx, cand_valid, with_stats)
        feature, cand_w = tilewin_combine_texels_plain(
            tables.texels, plan.bases, plan.bones, plan.xt, plan.xs,
            plan.valid, tables.feat_dim, S, clamp_mask)
    return _with_stats(feature, cand_w, plan, with_stats)


def sample_tilewin_fused(tables: TilewinTexels, cand_pos, slot_idx,
                         cand_valid, clamp_mask: bool = False,
                         with_stats: bool = False,
                         mode: Optional[str] = None):
    """``sample_tilewin`` on the texel table of ``pack_tilewin_texels``
    through ``tilewin_combine`` in ``mode`` (None reads
    ``ENARF_TILEWIN_KERNEL``, default "hat"): the CUDA kernels for CUDA
    tensors (m of 4 or 16, F = 32, else it raises), the plain combine for
    CPU tensors; differentiable in the texel table and ``cand_pos`` at
    m = 16. With ``with_stats`` the clamped share comes from the plan in
    plain PyTorch and the combine still runs the kernel."""
    if not isinstance(tables, TilewinTexels):
        raise ValueError("sample_tilewin_fused reads the texel table of "
                         "pack_tilewin_texels (the window tables of "
                         "pack_tilewin are sample_tilewin's, the CPU "
                         "reference)")
    plan = texel_plan(tables, cand_pos, slot_idx, cand_valid, with_stats)
    feature, cand_w = tilewin_combine(
        tables.texels, plan.bases, plan.bones, plan.xt, plan.xs, plan.valid,
        tables.feat_dim, cand_pos.shape[-1], clamp_mask, mode=mode)
    return _with_stats(feature, cand_w, plan, with_stats)
