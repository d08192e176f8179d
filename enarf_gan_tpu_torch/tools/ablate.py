"""Family C of the probes: stage ablations of the port's kernels 2 and 3,
and of kernel 1b's atomic adds; kernel 2b's plain version.

Where the tilewin combine's time goes on this card, asked of the kernels it
runs (``csrc/tilewin_combine.cu``, ``csrc/tilewin_combine_modes.cu``), as
``tools/probe_hat_ablate.py`` and ``tools/probe_tilewin_bdiag.py`` asked it
of the TPU kernels. Each source takes a compile-time stage; its main entry
point instantiates only the full kernel, and the same source built with
``-DTILEWIN_STAGE_ENTRY`` is a second library that exports the doctored
variants. Each variant's plain twin does the doctored work in PyTorch, and
the card holds kernel and twin together, which shows that the variant does
that work and no less (nvcc drops a load whose value goes unused).

Kernel 2 (``hat_stage``, on the texel table; twin
``tilewin_combine_texels_plain(..., stage=)``): "full", "stream" (no table
reads), "noweights" (bilinear fractions 0.5), "nomask" (no mask read,
cand_w = 0.5^3), "nofeat" (feature texels 1).
Kernel 3 (``modes_stage``, "dot" or "vpu" path; twin ``modes_stage_plain``;
the kernel's code on the TPU's window rows, which its TMA loads as it
loads the texel table's windows): "full", "stream", "featA" (t-weights 1),
"featD" (product replaced by a sum of the staged tiles), "featB" (s-weights
1), "feat" (no mask), "mask" (no feature product). The build of each
library prints each instantiation's ptxas line (``chip_smoke.py``), the counterpart of
``tools/probe_kernel_stages.py`` and ``tools/probe_kernel_variants.py``.
Kernel 1b (``unirow_bwd_stage``, built from ``csrc/unirow_combine_bwd.cu``
with ``-DUNIROW_STAGE_ENTRY``; twin ``unirow_bwd_stage_plain``; timed by
``chip_smoke.py`` beside kernel 1b, no TPU probe asked it): "full",
"scalar" (the feature adds as scalar atomics in place of 16-byte vector
reductions), "nofeat" (no feature adds), "nomask" (no mask adds). Kernel
1bf likewise (``unirow_bwd_f32_stage``, ``csrc/unirow_combine_bwd_f32.cu``;
twin ``unirow_bwd_f32_stage_plain``): "full", "nofeat", "nomask", and
"blocks4" (the full kernel at 4 blocks an SM in place of 3).
Kernel 2b's plain version (``tilewin_bwd_plain``) is what ``chip_smoke.py``
holds the kernel to.

    python -m enarf_gan_tpu_torch.tools.ablate [--device cpu]
"""
from __future__ import annotations

import ctypes

import torch

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.ops import tilewin, unirow
from enarf_gan_tpu_torch.ops.tilewin_kernel import (
    HAT_STAGES, NTEX, WIN, _check_inputs, _check_kernel_shapes,
    _check_window_inputs, texel_cells, texel_corners,
    tilewin_combine_texels_plain)
from enarf_gan_tpu_torch.ops.triplane import PLANE_COORDS
from enarf_gan_tpu_torch.tools.timing import (BF16_FLOPS, F32_FLOPS, Case,
                                              run_cli)

MODES_STAGES = ("full", "stream", "featA", "featD", "featB", "feat", "mask")
PATHS = ("dot", "vpu")
STAGE_FLAGS = ("-DTILEWIN_STAGE_ENTRY",)
KERNEL_STAGES = KernelLibrary(
    "tilewin_combine_stages", "tilewin_combine_stage_bf16",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    keys=HAT_STAGES, source="tilewin_combine.cu", flags=STAGE_FLAGS)
KERNEL_MODES_STAGES = KernelLibrary(
    "tilewin_combine_modes_stages", "tilewin_combine_modes_stage_bf16",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    keys=tuple(f"{p}/{s}" for p in PATHS for s in MODES_STAGES),
    source="tilewin_combine_modes.cu", flags=STAGE_FLAGS)
# kernel 1b's stages, in the order of the C enum
UNIROW_BWD_STAGES = ("full", "scalar", "nofeat", "nomask")
KERNEL_UNIROW_BWD_STAGES = KernelLibrary(
    "unirow_combine_bwd_stages", "unirow_combine_bwd_stage_bf16",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    keys=UNIROW_BWD_STAGES, source="unirow_combine_bwd.cu",
    flags=("-DUNIROW_STAGE_ENTRY",))
# kernel 1bf's stages, in the order of the C enum
UNIROW_BWD_F32_STAGES = ("full", "nofeat", "nomask", "blocks4")
KERNEL_UNIROW_BWD_F32_STAGES = KernelLibrary(
    "unirow_combine_bwd_f32_stages", "unirow_combine_bwd_stage_f32",
    unirow.F32_BWD_ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p],
    keys=UNIROW_BWD_F32_STAGES, source="unirow_combine_bwd_f32.cu",
    flags=("-DUNIROW_STAGE_ENTRY",))
F_ = 32
TRI_PLANE_SIZE, RAY_CHUNK, TILE_PATCH = 256, 4096, 4


def _outputs(device, B, Mp, m, U, S):
    """feature (B, F, U*m) and cand_w (B, Mp, U/S, m, S), as
    ``tilewin_combine`` allocates them."""
    return (torch.empty((B, F_, U * m), dtype=torch.float32, device=device),
            torch.empty((B, Mp, U // S, m, S), dtype=torch.float32,
                        device=device))


def _launch(lib, key, args, outputs, extra):
    """One launch of a stage library; ``extra`` the entry's int
    arguments."""
    if not all(t.is_contiguous() for t in args):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if outputs[1].shape[2] == 0:
        return outputs
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    ptrs = [t.data_ptr() for t in args + outputs]
    err = lib.load()(*ptrs, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{lib.name} ({key}) launch failed: CUDA error {err}")
    lib.count(key)
    return outputs


def hat_stage(texels, bases, bones, xt, xs, valid, S, clamp_mask, stage):
    """Kernel 2 with one stage doctored (``HAT_STAGES``) on the texel
    table: feature (B, 32, n) and cand_w (B, Mp, n_patch, m, S), as
    ``tilewin_combine``."""
    if stage not in HAT_STAGES:
        raise ValueError(f"stage must be one of {HAT_STAGES}, got {stage!r}")
    args = (texels, bases, bones, xt, xs, valid)
    _check_inputs(*args, F_, S, "hat")
    if not texels.is_cuda:
        return tilewin_combine_texels_plain(*args, F_, S, clamp_mask,
                                            stage=stage)
    B, H, W, Mp, m, U = _check_kernel_shapes(texels, bases, xt, F_)
    return _launch(KERNEL_STAGES, stage, args,
                   _outputs(texels.device, B, Mp, m, U, S),
                   (B, H, W, Mp, m, U, S, int(clamp_mask),
                    HAT_STAGES.index(stage)))


def modes_stage(feat_table, mask_table, frows, mrows, xt, xs, valid, S,
                clamp_mask, path, stage):
    """Kernel 3 in its "dot" (tensor-core) or "vpu" path with one stage
    doctored (``MODES_STAGES``), on window rows: the kernel's code with its
    tiles loaded from the rows that ``frows`` names and its mask logits
    from the rows ``mrows`` names (rows of 64 texels x 32 channels, on 16
    bytes). Stage "full" on the rows of a texel plan
    (``windows_from_texels``, ``window_rows``) is ``tilewin_combine``'s
    result in that mode, number for number."""
    if path not in PATHS or stage not in MODES_STAGES:
        raise ValueError(f"path in {PATHS} and stage in {MODES_STAGES}, got "
                         f"{path!r}, {stage!r}")
    args = (feat_table, mask_table, frows, mrows, xt, xs, valid)
    _check_window_inputs(*args, F_, S, path)
    if not feat_table.is_cuda:
        return modes_stage_plain(*args, S, clamp_mask, path, stage)
    B, _, Mp, U = frows.shape
    R = feat_table.shape[0]
    if tuple(feat_table.shape[1:]) != (16, 128) or R >= 2 ** 31 \
            or B > 65535 or Mp * U * 16 >= 2 ** 31:
        raise ValueError(f"kernel 3's stage build takes (R, 16, 128) rows "
                         f"and a plan within int32, got rows "
                         f"{tuple(feat_table.shape)}, B={B} Mp={Mp} U={U}")
    if feat_table.data_ptr() % 16:
        raise ValueError("kernel 3 loads the rows by TMA: it takes rows on "
                         "16 bytes")
    return _launch(KERNEL_MODES_STAGES, f"{path}/{stage}", args,
                   _outputs(feat_table.device, B, Mp, 16, U, S),
                   (R, B, Mp, U, S, int(clamp_mask), int(path == "dot"),
                    MODES_STAGES.index(stage)))


def unirow_bwd_stage(texels, rows, wq4, cand_idx, valid, dfeature, dcand_w,
                     stage):
    """Kernel 1b with its adds doctored (``UNIROW_BWD_STAGES``): (dtexels,
    dwq4), as ``ops/unirow.py::launch_backward``; on the CPU the twin."""
    if stage not in UNIROW_BWD_STAGES:
        raise ValueError(f"stage must be one of {UNIROW_BWD_STAGES}, got "
                         f"{stage!r}")
    args = (texels, rows, wq4, cand_idx, valid)
    unirow._check_inputs(*args)
    if not texels.is_cuda:
        return unirow_bwd_stage_plain(*args, dfeature, dcand_w, stage)
    B, H, W, M, n = unirow._kernel_shape(texels, rows, F_)
    dtexels = torch.zeros(texels.shape, dtype=torch.float32,
                          device=texels.device)
    dwq4 = torch.empty_like(wq4)
    dfeature = dfeature.float().contiguous()
    dcand_w = dcand_w.float().contiguous()
    stream = torch.cuda.current_stream(texels.device).cuda_stream
    ptrs = [t.data_ptr() for t in args + (dfeature, dcand_w, dtexels, dwq4)]
    lib = KERNEL_UNIROW_BWD_STAGES
    err = lib.load()(*ptrs, B, H, W, M, n, 0, UNIROW_BWD_STAGES.index(stage),
                     stream)
    if err != 0:
        raise RuntimeError(f"{lib.name} ({stage}) launch failed: CUDA error "
                           f"{err}")
    lib.count(stage)
    return dtexels, dwq4


def unirow_bwd_plain(texels, rows, wq4, cand_idx, valid, dfeature, dcand_w):
    """Kernel 1b's function by autograd through
    ``gather_combine_texels_plain`` on float32 copies, image by image (the
    gathered float32 texels of 4 images of a fine pass are 13 GB; images
    share no texels): (dtexels, dwq4)."""
    dts, dws = [], []
    with torch.enable_grad():
        for b in range(texels.shape[0]):
            sl = slice(b, b + 1)
            tf = texels[sl].float().requires_grad_(True)
            wf = wq4[sl].clone().requires_grad_(True)
            f, w = unirow.gather_combine_texels_plain(
                tf, rows[sl], wf, cand_idx[sl], valid[sl], F_, False)
            dt, dw = torch.autograd.grad(
                (f * dfeature[sl]).sum() + (w * dcand_w[sl]).sum(), [tf, wf])
            dts.append(dt)
            dws.append(dw)
    return torch.cat(dts), torch.cat(dws)


def unirow_bwd_stage_plain(texels, rows, wq4, cand_idx, valid, dfeature,
                           dcand_w, stage):
    """The twin of ``unirow_bwd_stage``: ``unirow_bwd_plain`` with the
    feature lanes ("nofeat") or the mask lanes ("nomask") of the texel
    gradient left at zero."""
    dtexels, dwq4 = unirow_bwd_plain(texels, rows, wq4, cand_idx, valid,
                                     dfeature, dcand_w)
    lanes = {"nofeat": slice(0, unirow.FEAT_BLOCK),
             "nomask": slice(unirow.FEAT_BLOCK, None)}.get(stage)
    if lanes is not None:
        dtexels[..., lanes] = 0
    return dtexels, dwq4


def unirow_bwd_f32_stage(tables, cand_pos, cand_idx, cand_valid, dfeature,
                         dcand_w, stage):
    """Kernel 1bf with its adds doctored (``UNIROW_BWD_F32_STAGES``):
    (dfeat, dmask, dcand_pos), as ``ops/unirow.py::launch_backward_f32``;
    on the CPU the twin."""
    if stage not in UNIROW_BWD_F32_STAGES:
        raise ValueError(f"stage must be one of {UNIROW_BWD_F32_STAGES}, "
                         f"got {stage!r}")
    inputs = (cand_pos, cand_idx, cand_valid)
    unirow._check_f32_inputs(tables, *inputs)
    if not tables.feature.is_cuda:
        return unirow_bwd_f32_stage_plain(tables, *inputs, dfeature, dcand_w,
                                          stage)
    B, H, W, K, M, n = unirow._f32_kernel_shape(tables, inputs, F_)
    dfeat = torch.zeros_like(tables.feature)
    dmask = torch.zeros_like(tables.mask)
    dpos = torch.empty_like(cand_pos)
    dfeature = dfeature.float().contiguous()
    dcand_w = dcand_w.float().contiguous()
    stream = torch.cuda.current_stream(cand_pos.device).cuda_stream
    ptrs = [t.data_ptr() for t in tuple(tables) + inputs
            + (dfeature, dcand_w, dfeat, dmask, dpos)]
    lib = KERNEL_UNIROW_BWD_F32_STAGES
    err = lib.load()(*ptrs, B, H, W, K, M, n, 0,
                     UNIROW_BWD_F32_STAGES.index(stage), stream)
    if err != 0:
        raise RuntimeError(f"{lib.name} ({stage}) launch failed: CUDA error "
                           f"{err}")
    lib.count(stage)
    return dfeat, dmask, dpos


def unirow_bwd_f32_plain(tables, cand_pos, cand_idx, cand_valid, dfeature,
                         dcand_w):
    """Kernel 1bf's function by autograd through ``sample_f32_plain``,
    image by image (images share no texels): (dfeat, dmask, dcand_pos)."""
    out = ([], [], [])
    with torch.enable_grad():
        for b in range(cand_pos.shape[0]):
            sl = slice(b, b + 1)
            leaves = [t[sl].detach().clone().requires_grad_(True)
                      for t in (*tables, cand_pos)]
            f, w = unirow.sample_f32_plain(
                unirow.Float32Texels(*leaves[:2]), leaves[2], cand_idx[sl],
                cand_valid[sl], F_, False)
            grads = torch.autograd.grad(
                (f * dfeature[sl]).sum() + (w * dcand_w[sl]).sum(), leaves)
            for acc, g in zip(out, grads):
                acc.append(g)
    return tuple(torch.cat(g) for g in out)


def unirow_bwd_f32_stage_plain(tables, cand_pos, cand_idx, cand_valid,
                               dfeature, dcand_w, stage):
    """The twin of ``unirow_bwd_f32_stage``: ``unirow_bwd_f32_plain`` with
    the feature table's gradient ("nofeat") or the mask table's ("nomask")
    left at zero ("full" and "blocks4": the whole gradients)."""
    dfeat, dmask, dpos = unirow_bwd_f32_plain(tables, cand_pos, cand_idx,
                                              cand_valid, dfeature, dcand_w)
    if stage == "nofeat":
        dfeat.zero_()
    elif stage == "nomask":
        dmask.zero_()
    return dfeat, dmask, dpos


def tilewin_bwd_plain(texels, bases, bones, xt, xs, valid, dfeature, dcand_w,
                      S):
    """Kernel 2b's function by autograd through
    ``tilewin_combine_texels_plain`` on float32 copies, image by image
    (images share no texels): (dtexels, dxt, dxs)."""
    Hp, Wp = texels.shape[2:4]
    dts, dxt, dxs = [], [], []
    with torch.enable_grad():
        for b in range(texels.shape[0]):
            sl = slice(b, b + 1)
            tf = texels[sl].float().requires_grad_(True)
            xtb = xt[sl].clone().requires_grad_(True)
            xsb = xs[sl].clone().requires_grad_(True)
            f, w = tilewin_combine_texels_plain(
                tf, bases[sl] - b * 3 * Hp * Wp, bones[sl], xtb, xsb,
                valid[sl], F_, S, False)
            grads = torch.autograd.grad(
                (f * dfeature[sl]).sum() + (w * dcand_w[sl]).sum(),
                [tf, xtb, xsb])
            for acc, g in zip((dts, dxt, dxs), grads):
                acc.append(g)
    return torch.cat(dts), torch.cat(dxt), torch.cat(dxs)


def _axis_weights(i, frac):
    """(..., 8) weights of the 8 texels along one axis: 1 - f at i, f at
    i + 1."""
    t = torch.arange(WIN, device=i.device)
    return (t == i[..., None]) * (1 - frac)[..., None] \
        + (t == i[..., None] + 1) * frac[..., None]


def modes_stage_plain(feat_table, mask_table, frows, mrows, xt, xs, valid, S,
                      clamp_mask, path="dot", stage="full"):
    """Kernel 3's formulation in PyTorch, with ``stage`` doctored as the
    kernel's: per (slot g, plane p) the t-contraction D = A @ W over the
    whole window row W (16 x 128, sublane 2t + h, lane 32q + f), then
    S[j, f] += sum_{h,q} D[j, h, 32q + f] ws_j(4h + q). "full" is
    ``tilewin_combine_plain(..., round_t=path == "dot")``."""
    B, _, Mp, U = frows.shape
    m = xt.shape[3]
    i, ft = texel_cells(xt)                               # (B,3,Mp,m,U)
    k, fs = texel_cells(xs)
    vm = valid[:, None, :, :, :, None]
    if stage == "featA":
        A = torch.ones(i.shape + (WIN,), device=xt.device)
    else:
        A = _axis_weights(i, ft) * vm
        if path == "dot" and stage != "featD":
            A = A.to(torch.bfloat16).float()
    ws = _axis_weights(k, fs)
    if stage == "featB":
        ws = torch.ones_like(ws)
    rows = feat_table.reshape(-1, 16, 128)
    sg = torch.zeros((B, Mp, m, U, F_), device=xt.device)
    for g in range(Mp):
        for p in range(3):
            W = rows[frows[:, p, g].long()].float()       # (B, U, 16, 128)
            Wr = W.view(B, U, WIN, 2, 4, F_)              # [t, h, q, f]
            if stage == "stream":
                s = W[:, None, :, 0, :F_] \
                    + (xt[:, p, g] + xs[:, p, g])[..., None]
            elif stage == "mask":
                s = Wr.sum((2, 3, 4))[:, None].expand(B, m, U, F_)
            else:
                if stage == "featD":
                    D = Wr.sum(2)[:, None] \
                        + A[:, p, g].sum(-1)[..., None, None, None]
                else:
                    D = torch.einsum("bjut,buthqf->bjuhqf", A[:, p, g], Wr)
                wsv = ws[:, p, g].reshape(B, m, U, 2, 4)  # s = 4h + q
                s = (D * wsv[..., None]).sum((3, 4))
            sg[:, g] += s
    if stage == "feat":
        cand_w = torch.ones((B, Mp, m, U), device=xt.device)
    else:
        msk = mask_table.reshape(-1)
        if stage == "stream":
            logit = msk[mrows.long() * NTEX].float()[:, :, :, None, :] \
                .expand(B, 3, Mp, m, U)
        else:
            mrow = mrows.long()[:, :, :, None, :] * NTEX + i * WIN + k
            logit = sum(msk[mrow + dt * WIN + ds].float() * w
                        for dt, ds, w in ((0, 0, (1 - ft) * (1 - fs)),
                                          (0, 1, (1 - ft) * fs),
                                          (1, 0, ft * (1 - fs)),
                                          (1, 1, ft * fs)))
        logit = logit * valid[:, None]
        if clamp_mask:
            logit = logit.clamp(-2.0, 5.0)
        cand_w = torch.sigmoid(logit).prod(dim=1)         # (B,Mp,m,U)
    feature = (sg * (cand_w * valid)[..., None]).sum(dim=1)   # (B,m,U,F)
    n_patch = U // S
    feature = feature.reshape(B, m, n_patch, S, F_).permute(0, 4, 2, 1, 3) \
        .reshape(B, F_, n_patch * m * S)
    cand_w = cand_w.reshape(B, Mp, m, n_patch, S).permute(0, 1, 3, 2, 4)
    return feature, cand_w.contiguous()


# ------------------------------------------------------------ inputs, bytes

def chunk_inputs(device, m, S, B=1, seed=0, H=TRI_PLANE_SIZE,
                 n_patch=RAY_CHUNK // (TILE_PATCH * TILE_PATCH),
                 layout="texels"):
    """The tables and plan of one full chunk of the tiled path (by default
    256² planes, 4096 rays in 256 patches), S samples, 4 slots; members
    clustered within ~1.5 texels per (patch, sample, slot), ~20% invalid.
    ``layout`` "texels" (what the kernels read): (texels, bases, bones, xt,
    xs, valid, F, S, clamp); "windows" (the JAX layout, kernel 3's and the
    window twin's), the same draws: (feat, mask, frows, mrows, xt, xs,
    valid, F, S, clamp)."""
    K, Mp = 23, 4
    g = torch.Generator().manual_seed(seed)
    planes = torch.randn((B, (F_ + K) * 3, H, H), generator=g).to(device)
    centers = torch.rand((B, 3, Mp, n_patch, 1, S), generator=g) * 1.7 - 0.85
    jitter = (torch.rand((B, 3, Mp, n_patch, m, S), generator=g) * 2 - 1) \
        * (1.5 / H)
    pos = (centers + jitter).clamp(-0.99, 0.99).to(device)
    slot_idx = torch.randint(0, K, (B, Mp, n_patch, S), generator=g,
                             dtype=torch.int32).to(device)
    valid = (torch.rand((B, Mp, n_patch, m, S), generator=g) < 0.8).to(device)
    if layout == "windows":
        tables = tilewin.pack_tilewin(planes, F_, K)
        plan = tilewin._fused_plan(tables, pos, slot_idx, valid)
        return (tables.feat, tables.mask, plan.frows, plan.mrows, plan.xt,
                plan.xs, plan.valid, F_, S, False)
    tables = tilewin.pack_tilewin_texels(planes, F_, K)
    plan = tilewin.texel_plan(tables, pos, slot_idx, valid)
    return (tables.texels, plan.bases, plan.bones, plan.xt, plan.xs,
            plan.valid, F_, S, False)


def unirow_inputs(device, B, n, H=TRI_PLANE_SIZE, M=4, K=23, seed=0,
                  dtype=torch.bfloat16):
    """The unirow kernels' inputs at random positions (``chip_smoke.py``'s
    checks): B images of n points, M candidates (about 30% invalid), 256²
    planes by default. bf16 (kernels 1 and 1b): (texels, rows, wq4,
    cand_idx, valid, dfeature, dcand_w (B, M, n)), the texel table and
    ``candidate_rows``' inputs; float32 (kernels 1f and 1bf): (tables,
    cand_pos, cand_idx, cand_valid, dfeature, dcand_w (B, n, M)), the
    ``pack_texels_f32`` tables and the candidates themselves. The last two
    are the backward's cotangents; both draw the same numbers."""
    g = torch.Generator().manual_seed(seed)
    planes = torch.randn((B, (F_ + K) * 3, H, H), generator=g).to(device)
    pos = (torch.rand((B, n, M, 3), generator=g) * 2.4 - 1.2).to(device)
    idx = torch.randint(0, K, (B, n, M), generator=g,
                        dtype=torch.int32).to(device)
    valid = (torch.rand((B, n, M), generator=g) > 0.3).to(device)
    dfeature = torch.randn((B, F_, n), generator=g).to(device)
    dcand_w = torch.randn((B, M, n), generator=g).to(device)
    if dtype == torch.float32:
        return (unirow.pack_texels_f32(planes, F_, K), pos, idx, valid,
                dfeature, dcand_w.transpose(1, 2).contiguous())
    texels = unirow.pack_texels(planes, F_, K, dtype=dtype)
    rows, wq4, ci, cv = unirow.candidate_rows(pos, idx, valid, H, H)
    return texels, rows, wq4, ci, cv, dfeature, dcand_w


def texel_table_bytes(texels, rows, cand_idx, valid, feat_dim):
    """Bytes of the texel table (``pack_texels``) one unirow launch must
    read: the F feature lanes of each distinct texel a valid candidate
    reads (4 corners a row; the feature is weighted by valid) and each
    distinct 32-byte sector holding a candidate's mask logit (every
    candidate's cand_w needs it). Returns (bytes, distinct feature texels,
    distinct mask sectors)."""
    B, _, Hp, Wp, TW = texels.shape
    a = unirow.texel_corners(rows, Hp - 2, Wp - 2) \
        + (torch.arange(B, device=rows.device) * 3 * Hp * Wp).view(B, 1, 1, 1)
    corners = a[..., None] + torch.tensor([0, 1, Wp, Wp + 1],
                                          device=rows.device)  # (…, 4)
    keep = (valid != 0)[:, None, :, :, None].expand_as(corners)
    d_tex = int(torch.unique(corners[keep]).numel())
    lanes_per_sector = 32 // texels.element_size()
    sectors = corners * (TW // lanes_per_sector) + (
        unirow.FEAT_BLOCK + cand_idx.long()[:, None, :, :, None]) \
        // lanes_per_sector
    d_sec = int(torch.unique(sectors).numel())
    return d_tex * feat_dim * texels.element_size() + d_sec * 32, d_tex, \
        d_sec


def _corners_with_gradient(cand_pos, H, W):
    """(B, 3, M, n, 4): whether the weight of corner q of each (plane,
    candidate, point)'s cell or the weight's derivative is nonzero: the
    corner lies inside the plane (``_quad_cells_weights``' range masks) and
    not both of its weight's factors are 0."""
    cp = cand_pos.permute(0, 3, 2, 1)                         # (B, 3, M, n)
    planes = []
    for i, j in PLANE_COORDS:
        x = (cp[:, i] + 1) * (W / 2) - 0.5
        y = (cp[:, j] + 1) * (H / 2) - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        in_x = ((x0 >= 0) & (x0 <= W - 1), (x0 >= -1) & (x0 <= W - 2))
        in_y = ((y0 >= 0) & (y0 <= H - 1), (y0 >= -1) & (y0 <= H - 2))
        cx = (1 - fx != 0, fx != 0)              # the weight's factors
        wy = (1 - fy != 0, fy != 0)
        planes.append(torch.stack(
            [in_x[q % 2] & in_y[q // 2] & (cx[q % 2] | wy[q // 2])
             for q in range(4)], dim=-1))
    return torch.stack(planes, dim=1)


def f32_table_bytes(tables, cand_pos, cand_idx, cand_valid, grad=False):
    """Bytes of the float32 tables (``pack_texels_f32``) one launch of
    kernel 1f must read: the 128-byte feature line of each distinct texel
    at a corner of nonzero weight of a valid candidate (an invalid one's
    feature is weighted by 0), and each distinct 32-byte sector of the
    bone-major mask planes holding a corner of nonzero weight of any
    candidate (every candidate's cand_w needs it). With ``grad`` (kernel
    1bf) a corner of weight 0 counts too where the weight's derivative is
    not 0 (on a cell's edge): it enters the positions' gradient. Returns
    (bytes, distinct feature texels, distinct mask sectors)."""
    ft, mt = tables
    B, _, Hp, Wp, _ = ft.shape
    K = mt.shape[2]
    dev = cand_pos.device
    cells, wq = unirow._quad_cells_weights(cand_pos.permute(0, 3, 2, 1),
                                           Hp - 2, Wp - 2)
    t, s = cells // (Wp - 1), cells % (Wp - 1)                # (B, 3, M, n)
    corners = (t * Wp + s).long()[..., None] \
        + torch.tensor([0, 1, Wp, Wp + 1], device=dev)        # (…, 4)
    plane = (torch.arange(B, device=dev).view(B, 1, 1, 1, 1) * 3
             + torch.arange(3, device=dev).view(1, 3, 1, 1, 1))
    nonzero = torch.stack(wq, dim=-1) != 0
    if grad:
        nonzero |= _corners_with_gradient(cand_pos, Hp - 2, Wp - 2)
    keep = nonzero & cand_valid.permute(0, 2, 1)[:, None, :, :, None]
    d_tex = int(torch.unique((plane * Hp * Wp + corners)[keep]).numel())
    bone = cand_idx.permute(0, 2, 1).long()[:, None, :, :, None]
    mask_at = (plane * K + bone) * (Hp * Wp) + corners
    d_sec = int(torch.unique(mask_at[nonzero] // 8).numel())  # 8 floats
    return d_tex * 32 * 4 + d_sec * 32, d_tex, d_sec


def parent_f32_table_bytes(tables, cand_pos, cand_idx, cand_valid):
    """The earlier float32 design's bytes for the same candidates (the
    earlier kernel 1f, the bf16 kernel's template on a 64-lane float32 texel
    table, fed ``candidate_rows``): ``texel_table_bytes`` on that table's
    shape, and the streamed rows, wq4, cand_idx and valid. Returns (table
    bytes, streamed input bytes)."""
    B, _, Hp, Wp, _ = tables.feature.shape
    rows, wq4, ci, cv = unirow.candidate_rows(cand_pos, cand_idx, cand_valid,
                                              Hp - 2, Wp - 2)
    shape = torch.empty((B, 3, Hp, Wp, unirow.TEXEL_WIDTH),
                        dtype=torch.float32, device="meta")
    nbytes = texel_table_bytes(shape, rows, ci, cv, F_)[0]
    return nbytes, sum(t.numel() * t.element_size()
                       for t in (rows, wq4, ci, cv))


def probe_inputs(device, U=12288, S=48, Mp=4, m=16, seed=0):
    """The TPU probes' inputs (probe_hat_ablate.py, probe_tilewin_bdiag.py)
    in the window layout (kernel 3's): every (plane, slot, unit) its own
    random window row, coordinates uniform in [0, 7), 90% valid."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_rows = 3 * Mp * U
    feat = torch.randn((n_rows, 16, 128), generator=g, device=device) \
        .to(torch.bfloat16)
    mask = torch.randn((n_rows, NTEX), generator=g, device=device) \
        .to(torch.bfloat16)
    rows = torch.arange(n_rows, device=device, dtype=torch.int32) \
        .view(1, 3, Mp, U)
    xt = torch.rand((1, 3, Mp, m, U), generator=g, device=device) * (WIN - 1)
    xs = torch.rand((1, 3, Mp, m, U), generator=g, device=device) * (WIN - 1)
    valid = (torch.rand((1, Mp, m, U), generator=g, device=device) < 0.9) \
        .float()
    return feat, mask, rows, rows.clone(), xt, xs, valid, F_, S, False


def probe_texel_inputs(device, U=12288, S=48, Mp=4, m=16, seed=0,
                       per_row=256):
    """The TPU probes' inputs in the texel layout (kernel 2's): every
    (plane, slot, unit) its own 8x8-texel window of a random texel table,
    the windows side by side, ``per_row`` to a row of windows (at the
    probe's U = 12288, 1.2 GB of texels, as the TPU probe's 147,456 random
    4 KB rows lie far above the L2); a random bone a (slot, unit),
    coordinates uniform in [0, 7), 90% valid. Returns (texels, bases,
    bones, xt, xs, valid, F, S, clamp)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_win = Mp * U
    per_row = min(per_row, n_win)
    Hp = WIN * -(-n_win // per_row)
    Wp = WIN * per_row
    texels = torch.randn((1, 3, Hp, Wp, 64), generator=g, device=device) \
        .to(torch.bfloat16)
    w = torch.arange(n_win, device=device).view(1, 1, Mp, U)
    plane = torch.arange(3, device=device).view(1, 3, 1, 1)
    bases = (plane * Hp + WIN * (w // per_row)) * Wp + WIN * (w % per_row)
    bones = torch.randint(0, 32, (1, Mp, U), generator=g, device=device,
                          dtype=torch.int32)
    xt = torch.rand((1, 3, Mp, m, U), generator=g, device=device) * (WIN - 1)
    xs = torch.rand((1, 3, Mp, m, U), generator=g, device=device) * (WIN - 1)
    valid = (torch.rand((1, Mp, m, U), generator=g, device=device) < 0.9) \
        .float()
    return texels, bases.to(torch.int32), bones, xt, xs, valid, F_, S, False


def table_bytes(feat_dim, frows, mrows, xt, xs, valid):
    """Bytes of the window tables one tilewin launch would read (the TPU
    layout; kernel 3 reads it, and it is kernel 2's yardstick): each
    distinct 64-byte feature texel of a window row (F bf16 channels) and
    each distinct 32-byte mask sector in the 2x2 quad of a valid member (an
    invalid member's feature is weighted by 0 and its logit is 0). A plane
    texel lies in up to 16 windows, and each copy counts. Returns (bytes,
    distinct texels, distinct mask sectors)."""
    i, _ = texel_cells(xt)                                    # (B,3,Mp,m,U)
    k, _ = texel_cells(xs)
    keep = (valid != 0)[:, None].expand_as(i)
    cell = (i * WIN + k)[keep]
    quad = torch.tensor([0, 1, WIN, WIN + 1], device=cell.device)

    def texels(rows):
        base = rows.long()[:, :, :, None, :].expand_as(i)[keep] * NTEX + cell
        return (base[:, None] + quad).reshape(-1)

    d_tex = int(torch.unique(texels(frows)).numel())
    d_sec = int(torch.unique(texels(mrows) // 16).numel())   # 16 bf16 a sector
    return d_tex * feat_dim * 2 + d_sec * 32, d_tex, d_sec


def tilewin_texel_bytes(texels, bases, bones, xt, xs, valid, feat_dim):
    """Bytes of the texel table one tilewin launch must read: each distinct
    64-byte feature half of a texel (F bf16 channels) in the 2x2 quad of a
    valid member, and each distinct 32-byte sector holding its slot bone's
    mask logit (an invalid member's feature is weighted by 0 and its logit
    is 0). Returns (bytes, distinct texels, distinct mask sectors)."""
    Wp, TW = texels.shape[3:]
    i, _ = texel_cells(xt)                                    # (B,3,Mp,m,U)
    k, _ = texel_cells(xs)
    t00 = texel_corners(bases, i, k, Wp)
    keep = (valid != 0)[:, None].expand_as(i)
    corners = torch.stack([t00, t00 + 1, t00 + Wp, t00 + Wp + 1])[:, keep]
    d_tex = int(torch.unique(corners).numel())
    lanes_per_sector = 32 // texels.element_size()
    lane = (unirow.FEAT_BLOCK + bones.long()[:, None, :, None, :]) \
        .expand_as(i)[keep]
    sectors = corners * (TW // lanes_per_sector) + lane // lanes_per_sector
    d_sec = int(torch.unique(sectors).numel())
    return d_tex * feat_dim * texels.element_size() + d_sec * 32, d_tex, \
        d_sec


def io_bytes(args, m):
    """The plan's arrays (row indices or base texels and bones,
    coordinates, validity) read, outputs written: args are either
    layout's (tables first, then the plan)."""
    plan = args[2:7] if args[0].dim() == 3 else args[1:6]
    B, _, Mp, U = plan[0].shape
    return sum(t.numel() * t.element_size() for t in plan) \
        + B * (F_ + Mp) * U * m * 4


def _hat_bytes(args, stage):
    m = args[3].shape[3]
    io = io_bytes(args, m)
    if stage == "stream":
        return float(io)
    _, d_tex, d_sec = tilewin_texel_bytes(*args[:6], F_)
    feat = 0 if stage == "nofeat" else d_tex * F_ * 2
    mask = 0 if stage == "nomask" else d_sec * 32
    return float(io + feat + mask)


def _modes_work(args, path, stage):
    """Bytes and operations of kernel 3's formulation of one variant: each
    distinct 4 KB window row once (every variant stages whole rows), the
    mask sectors its logits read, coordinates and outputs; the products'
    operations (tensor or float32) where the variant multiplies."""
    frows, mrows = args[2], args[3]
    m = args[4].shape[3]
    rows = int(torch.unique(frows).numel())
    if stage == "feat":
        mask = 0
    elif stage == "stream":
        mask = int(torch.unique(mrows).numel()) * 32
    else:
        mask = table_bytes(F_, *args[2:7])[2] * 32
    nbytes = float(io_bytes(args, m) + rows * 4096 + mask)
    units = frows.numel()                    # (batch, plane, slot, unit)
    if stage in ("stream", "mask", "featD"):
        return nbytes, 0.0, F32_FLOPS
    if path == "dot":
        return nbytes, float(units) * 32 * 16 * 128 * 2, BF16_FLOPS
    return nbytes, float(units) * 2 * 16 * 8 * 128 * 2, F32_FLOPS


def cases(device, size="main"):
    """Every variant of kernels 2 and 3 at the TPU probes' U = 12288 (random
    windows or rows) and at chip_smoke.py's fine chunk (a tiled render's
    plan, U = 16384); "check" at small sizes. Kernel 2 reads the texel
    layout of each, kernel 3 the window layout."""
    if size == "check":
        shapes = (("small probe inputs",
                   probe_texel_inputs(device, U=96, S=12, per_row=16),
                   probe_inputs(device, U=96, S=12)),
                  ("small chunk", chunk_inputs(device, 16, 5, H=16, n_patch=3),
                   chunk_inputs(device, 16, 5, H=16, n_patch=3,
                                layout="windows")))
    else:
        shapes = (("U=12288 probe inputs", probe_texel_inputs(device),
                   probe_inputs(device)),
                  ("fine chunk", chunk_inputs(device, 16, 64),
                   chunk_inputs(device, 16, 64, layout="windows")))
    for label, targs, wargs in shapes:
        a6, a7, S = targs[:6], wargs[:7], targs[7]
        U = targs[1].shape[3]
        for stage in HAT_STAGES:
            # the full hat kernel is also probe_tilewin_bdiag.py's "v4"
            yield Case(
                f"C kernel 2 {stage}, {label}",
                "tools/probe_tilewin_bdiag.py:211" if stage == "full"
                else "tools/probe_hat_ablate.py:145",
                "enarf_gan_tpu_torch/csrc/tilewin_combine.cu",
                kernel=lambda st=stage: hat_stage(*a6, S, False, st),
                plain=lambda st=stage: tilewin_combine_texels_plain(
                    *a6, F_, S, False, stage=st),
                counter=(KERNEL_STAGES, stage),
                nbytes=_hat_bytes(targs, stage), rtol=1e-4, atol=1e-5,
                info={"kernel": 2, "stage": stage, "U": U, "inputs": label})
        for path in PATHS:
            for stage in MODES_STAGES:
                nbytes, flops, rate = _modes_work(wargs, path, stage)
                yield Case(
                    f"C kernel 3 {path} {stage}, {label}",
                    "tools/probe_tilewin_bdiag.py:246",
                    "enarf_gan_tpu_torch/csrc/tilewin_combine_modes.cu",
                    kernel=lambda p=path, st=stage: modes_stage(
                        *a7, S, False, p, st),
                    plain=lambda p=path, st=stage: modes_stage_plain(
                        *a7, S, False, p, st),
                    counter=(KERNEL_MODES_STAGES, f"{path}/{stage}"),
                    nbytes=nbytes, flops=flops, rate=rate,
                    # float32 sums in another order (the "mask" and
                    # "stream" variants add up whole rows)
                    rtol=1e-4, atol=1e-5,
                    info={"kernel": 3, "path": path, "stage": stage, "U": U,
                          "inputs": label})


def main(argv=None):
    return run_cli(cases, argv, __doc__)


if __name__ == "__main__":
    main()
