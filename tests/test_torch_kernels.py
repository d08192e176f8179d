"""The port's kernel wrappers: dispatch, input checks, and each CUDA kernel
against its plain PyTorch version on the card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax; there, skip the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance, kernel vs plain: both compute in float32 from the same bf16
rows (kernels 1f and 1bf: float32 tables, and the cells and corner
weights computed from the positions, rounded alike); the sums run in
another order and the exp is another implementation, so 1e-4 relative /
1e-5 absolute (the forward kernels).
The backward kernels add into the table gradients with atomics, in an
order that changes from run to run, and the plain gradients come from
autograd's scatter-adds: relative L2 error 1e-4 per gradient.
"""
import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel, unirow
from enarf_gan_tpu_torch.tools import ablate


def _combine_args(B, n, M, H=16, F=32, K=23, seed=2, device="cpu",
                  dtype=torch.bfloat16):
    """The texel table (of ``dtype``) and candidate inputs of
    ``unirow_combine``; points outside every bone and on the plane edges
    (in the zero padding)."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, H, H)).astype(np.float32)
    pos = rng.uniform(-1.4, 1.4, (B, n, M, 3)).astype(np.float32)
    pos[:, :2] = 2.0                     # points outside every bone
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    table = unirow.pack_texels(torch.from_numpy(planes), F, K, dtype=dtype)
    args = (table,) + unirow.candidate_rows(
        torch.from_numpy(pos), torch.from_numpy(idx), torch.from_numpy(valid),
        H, H)
    return tuple(a.to(device) for a in args)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = _combine_args(1, 50, 4)
    before = unirow.KERNEL.launches
    got = unirow.unirow_combine(*args, 32, False)
    ref = unirow.gather_combine_texels_plain(*args, 32, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert unirow.KERNEL.launches == before


def _f32_args(B, n, M, H=16, F=32, K=23, seed=2, device="cpu"):
    """The float32 tables (``pack_texels_f32``) and the candidates of
    ``sample_f32``: positions in range, on the plane edges and outside
    every bone (at 2), about 30% invalid."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, H, H)).astype(np.float32)
    pos = rng.uniform(-1.4, 1.4, (B, n, M, 3)).astype(np.float32)
    pos[:, :2] = 2.0                     # points outside every bone
    if n > 3:
        pos[:, 2, 0] = (-1.0, 1.0, -1.0)
        pos[:, 3, 0] = (1.0, -1.0, 0.999)
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    tables = unirow.pack_texels_f32(torch.from_numpy(planes), F, K)
    args = (torch.from_numpy(pos), torch.from_numpy(idx),
            torch.from_numpy(valid))
    return (unirow.Float32Texels(*(t.to(device) for t in tables)),) \
        + tuple(a.to(device) for a in args)


def test_float32_table_runs_plain_on_cpu_and_counts_no_launch():
    """Float32 planes go through ``sample_f32``: on CPU tensors it is its
    plain twin, launching nothing; kernels 1f and 1bf are libraries of
    their own sources, each with its own count."""
    args = _f32_args(1, 50, 4)
    kernels = (unirow.KERNEL, unirow.KERNEL_F32, unirow.KERNEL_BWD_F32)
    counts = [k.launches for k in kernels]
    got = unirow.sample_f32(*args, 32, False)
    ref = unirow.sample_f32_plain(*args, 32, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [k.launches for k in kernels] == counts
    assert (unirow.KERNEL_F32.source, unirow.KERNEL_BWD_F32.source) == \
        ("unirow_combine_f32.cu", "unirow_combine_bwd_f32.cu")
    assert unirow.KERNEL_F32.owner is None and \
        unirow.KERNEL_BWD_F32.owner is None


def test_float32_wrapper_rejects_what_the_kernel_does_not_take():
    tables, pos, idx, valid = _f32_args(1, 20, 3)
    with pytest.raises(ValueError, match="float32 tables"):      # bf16
        unirow.sample_f32(unirow.Float32Texels(tables.feature.bfloat16(),
                                               tables.mask), pos, idx,
                          valid, 32, False)
    with pytest.raises(ValueError, match="float32 tables"):      # 64 lanes
        unirow.sample_f32(unirow.Float32Texels(
            torch.zeros(1, 3, 18, 18, 64), tables.mask), pos, idx, valid,
            32, False)
    with pytest.raises(ValueError, match="cand_pos"):
        unirow.sample_f32(tables, pos[..., :2], idx, valid, 32, False)
    with pytest.raises(ValueError, match="cand_idx"):
        unirow.sample_f32(tables, pos, idx.long(), valid, 32, False)
    with pytest.raises(ValueError, match="cand_valid"):
        unirow.sample_f32(tables, pos, idx, valid.float(), 32, False)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, rows, wq4, idx, valid = _combine_args(1, 50, 4)
    with pytest.raises(ValueError, match="table"):     # bf16 or float32 only
        unirow.unirow_combine(table.half(), rows, wq4, idx, valid, 32, False)
    with pytest.raises(ValueError, match="texel table"):      # quad rows
        unirow.unirow_combine(table.reshape(1, -1, 256), rows, wq4, idx,
                              valid, 32, False)
    with pytest.raises(ValueError, match="rows"):
        unirow.unirow_combine(table, rows.long(), wq4, idx, valid, 32, False)
    with pytest.raises(ValueError, match="valid"):
        unirow.unirow_combine(table, rows, wq4, idx, valid[:, :2], 32, False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


UNIROW_CASES = [(1, 1000, 4, False), (2, 333, 3, True), (1, 5, 1, False),
                (3, 77, 2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,M,clamp", UNIROW_CASES)
def test_unirow_kernel_matches_plain_on_card(cuda_device, B, n, M, clamp):
    args = _combine_args(B, n, M, device=cuda_device)
    before = unirow.KERNEL.launches
    with torch.no_grad():
        f, w = unirow.unirow_combine(*args, 32, clamp)
        torch.cuda.synchronize()
        f_ref, w_ref = unirow.gather_combine_texels_plain(*args, 32, clamp)
    assert unirow.KERNEL.launches == before + 1
    torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f, f_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_unirow_kernel_refuses_a_gradient(cuda_device):
    """valid comes from a bool and takes no gradient; the table and wq4
    do (kernel 1b)."""
    table, rows, wq4, idx, valid = _combine_args(1, 40, 4, device=cuda_device)
    with pytest.raises(ValueError, match="valid takes no gradient"):
        unirow.unirow_combine(table, rows, wq4, idx, valid.requires_grad_(True),
                              32, False)


@pytest.mark.cuda
def test_unirow_kernels_refuse_what_they_do_not_take(cuda_device):
    """On the card: no quad-row table, feat_dim 32 only, contiguous tensors;
    nothing falls back to the plain twin."""
    table, rows, wq4, idx, valid = _combine_args(1, 40, 4, device=cuda_device)
    before = (unirow.KERNEL.launches, unirow.KERNEL_BWD.launches)
    quad = torch.zeros((1, 3 * 17 * 17, 256), dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="texel table"):
        unirow.unirow_combine(quad, rows, wq4, idx, valid, 32, False)
    with pytest.raises(ValueError, match="feat_dim"):
        unirow.unirow_combine(table, rows, wq4, idx, valid, 16, False)
    with pytest.raises(ValueError, match="contiguous"):
        unirow.unirow_combine(table, rows.transpose(2, 3).contiguous()
                              .transpose(2, 3), wq4, idx, valid, 32, False)
    dcot = torch.zeros((1, 32, 40), device=cuda_device)
    with pytest.raises(ValueError, match="feat_dim"):
        unirow.launch_backward(table, rows, wq4, idx, valid, dcot,
                               torch.zeros_like(valid), 16, False)
    assert (unirow.KERNEL.launches, unirow.KERNEL_BWD.launches) == before


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _cotangents(outs, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g).to(o.device) for o in outs]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,M,clamp", UNIROW_CASES)
def test_unirow_backward_kernel_matches_plain_on_card(cuda_device, B, n, M,
                                                      clamp):
    table, rows, wq4, idx, valid = _combine_args(B, n, M, device=cuda_device)
    table.requires_grad_(True)
    wq4.requires_grad_(True)
    outs = unirow.unirow_combine(table, rows, wq4, idx, valid, 32, clamp)
    cots = _cotangents(outs, 5)
    before = unirow.KERNEL_BWD.launches
    dtable, dwq4 = unirow.launch_backward(table.detach(), rows, wq4.detach(),
                                          idx, valid, *cots, 32, clamp)
    torch.cuda.synchronize()
    assert unirow.KERNEL_BWD.launches == before + 1
    assert dtable.dtype == torch.float32 and dtable.shape == table.shape
    # the plain twin under autograd, on a float32 copy of the texel table
    tf = table.detach().float().requires_grad_(True)
    wf = wq4.detach().clone().requires_grad_(True)
    ref = unirow.gather_combine_texels_plain(tf, rows, wf, idx, valid, 32,
                                             clamp)
    r_table, r_wq4 = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(ref, cots)), [tf, wf])
    assert _rel_l2(dtable, r_table) <= 1e-4
    assert _rel_l2(dwq4, r_wq4) <= 1e-4
    assert not dtable[..., unirow.FEAT_BLOCK + 23:].any()   # bones >= K
    # and through the autograd Function: the table gradient in its bf16 type
    g_table, g_wq4 = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cots)), [table, wq4])
    assert g_table.dtype == torch.bfloat16
    assert unirow.KERNEL_BWD.launches == before + 2
    torch.testing.assert_close(g_wq4, dwq4, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,M,clamp", UNIROW_CASES)
def test_unirow_f32_kernel_matches_plain_on_card(cuda_device, B, n, M,
                                                 clamp):
    """Kernel 1f on the float32 tables, from the positions: launched (its
    own count, not kernel 1's) and equal to the plain twin."""
    args = _f32_args(B, n, M, device=cuda_device)
    before = (unirow.KERNEL.launches, unirow.KERNEL_F32.launches)
    with torch.no_grad():
        f, w = unirow.sample_f32(*args, 32, clamp)
        torch.cuda.synchronize()
        f_ref, w_ref = unirow.sample_f32_plain(*args, 32, clamp)
    assert (unirow.KERNEL.launches, unirow.KERNEL_F32.launches) == \
        (before[0], before[1] + 1)
    torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f, f_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,M,clamp", UNIROW_CASES)
def test_unirow_f32_backward_kernel_matches_plain_on_card(cuda_device, B, n,
                                                          M, clamp):
    """Kernel 1bf against autograd through the plain twin: both tables'
    gradients and the positions'; through the autograd Function too."""
    tables, pos, idx, valid = _f32_args(B, n, M, device=cuda_device)
    leaves = [tables.feature.requires_grad_(True),
              tables.mask.requires_grad_(True), pos.requires_grad_(True)]
    outs = unirow.sample_f32(tables, pos, idx, valid, 32, clamp)
    cots = _cotangents(outs, 5)
    before = unirow.KERNEL_BWD_F32.launches
    got = unirow.launch_backward_f32(
        unirow.Float32Texels(*(t.detach() for t in tables)), pos.detach(),
        idx, valid, *cots, 32, clamp)
    torch.cuda.synchronize()
    assert unirow.KERNEL_BWD_F32.launches == before + 1
    copies = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref = unirow.sample_f32_plain(unirow.Float32Texels(*copies[:2]),
                                  copies[2], idx, valid, 32, clamp)
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref, cots)),
                               copies)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_l2(a, b) <= 1e-4
    through = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cots)), leaves)
    assert unirow.KERNEL_BWD_F32.launches == before + 2
    for a, b in zip(through, want):
        assert _rel_l2(a, b) <= 1e-4


@pytest.mark.cuda
def test_unirow_kernel_refuses_a_float32_table(cuda_device):
    """Kernels 1 and 1b take the bf16 texel table only: float32 planes go
    through sample_f32, and nothing falls back."""
    args = _combine_args(1, 40, 4, device=cuda_device, dtype=torch.float32)
    before = (unirow.KERNEL.launches, unirow.KERNEL_BWD.launches)
    with pytest.raises(ValueError, match="bf16"):
        unirow.unirow_combine(*args, 32, False)
    dcot = torch.zeros((1, 32, 40), device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        unirow.launch_backward(*args, dcot, torch.zeros_like(args[4]), 32,
                               False)
    assert (unirow.KERNEL.launches, unirow.KERNEL_BWD.launches) == before


def test_unirow_bwd_stages_run_their_twins_on_cpu():
    """Kernel 1b's stage ablations (tools/ablate.py): on the CPU each runs
    its twin, the full gradient with the feature ("nofeat") or mask
    ("nomask") lanes of the texel gradient left at zero; an unknown stage
    raises."""
    args = ablate.unirow_inputs("cpu", 2, 40, H=12, seed=3)
    full_t, full_w = ablate.unirow_bwd_plain(*args)
    F = unirow.FEAT_BLOCK
    assert full_t[..., :F].abs().max() > 0 and full_t[..., F:].abs().max() > 0
    for stage in ablate.UNIROW_BWD_STAGES:
        dt, dw = ablate.unirow_bwd_stage(*args, stage)
        want = full_t.clone()
        if stage == "nofeat":
            want[..., :F] = 0
        elif stage == "nomask":
            want[..., F:] = 0
        # autograd's scatter-adds on the CPU sum in a varying order
        torch.testing.assert_close(dt, want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dw, full_w, rtol=1e-5, atol=1e-6)
        if stage in ("nofeat", "nomask"):
            zeroed = slice(0, F) if stage == "nofeat" else slice(F, None)
            assert not dt[..., zeroed].any()
    with pytest.raises(ValueError, match="stage"):
        ablate.unirow_bwd_stage(*args, "noatomics")


@pytest.mark.cuda
def test_unirow_bwd_stage_kernels_match_their_twins_on_card(cuda_device):
    args = ablate.unirow_inputs(cuda_device, 2, 333, H=16, M=3, seed=4)
    for stage in ablate.UNIROW_BWD_STAGES:
        before = ablate.KERNEL_UNIROW_BWD_STAGES.launches_by[stage]
        got = ablate.unirow_bwd_stage(*args, stage)
        torch.cuda.synchronize()
        assert ablate.KERNEL_UNIROW_BWD_STAGES.launches_by[stage] == before + 1
        ref = ablate.unirow_bwd_stage_plain(*args, stage)
        for a, b in zip(got, ref):
            assert _rel_l2(a, b) <= 1e-4, stage


def test_unirow_bwd_f32_stages_run_their_twins_on_cpu():
    """Kernel 1bf's stage ablations (tools/ablate.py): on the CPU each runs
    its twin, the full gradients with the feature table's ("nofeat") or the
    mask table's ("nomask") left at zero ("blocks4": all whole); the
    positions' always whole."""
    args = ablate.unirow_inputs("cpu", 2, 40, H=12, seed=3,
                                dtype=torch.float32)
    full = ablate.unirow_bwd_f32_plain(*args)
    assert all(float(g.abs().max()) > 0 for g in full)
    for stage in ablate.UNIROW_BWD_F32_STAGES:
        got = ablate.unirow_bwd_f32_stage(*args, stage)
        zeroed = {"nofeat": 0, "nomask": 1}.get(stage)
        for i, (a, b) in enumerate(zip(got, full)):
            if i == zeroed:
                assert not a.any()
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="stage"):
        ablate.unirow_bwd_f32_stage(*args, "scalar")


@pytest.mark.cuda
def test_unirow_bwd_f32_stage_kernels_match_their_twins_on_card(cuda_device):
    args = ablate.unirow_inputs(cuda_device, 2, 333, H=16, M=3, seed=4,
                                dtype=torch.float32)
    lib = ablate.KERNEL_UNIROW_BWD_F32_STAGES
    for stage in ablate.UNIROW_BWD_F32_STAGES:
        before = lib.launches_by[stage]
        got = ablate.unirow_bwd_f32_stage(*args, stage)
        torch.cuda.synchronize()
        assert lib.launches_by[stage] == before + 1
        ref = ablate.unirow_bwd_f32_stage_plain(*args, stage)
        for a, b in zip(got, ref):
            if b.any():
                assert _rel_l2(a, b) <= 1e-4, stage
            else:
                assert not a.any(), stage


def test_tilewin_bwd_plain_is_autograd_through_the_combine():
    """Kernel 2b's plain version (tools/ablate.py), which runs image by
    image on bases shifted to each image's table, gives the batch's
    gradients of autograd through the texel twin."""
    args = _tilewin_args(16, 3, 5)
    g = torch.Generator().manual_seed(5)
    dfeature = torch.randn((2, 32, 3 * 16 * 5), generator=g)
    dcand_w = torch.randn((2, 3, 3, 16, 5), generator=g)
    got = ablate.tilewin_bwd_plain(*args, dfeature, dcand_w, 5)
    texels, bases, bones, xt, xs, valid = args
    tf = texels.float().requires_grad_(True)
    xtg = xt.clone().requires_grad_(True)
    xsg = xs.clone().requires_grad_(True)
    f, w = tilewin_kernel.tilewin_combine_texels_plain(
        tf, bases, bones, xtg, xsg, valid, 32, 5, False)
    want = torch.autograd.grad((f * dfeature).sum() + (w * dcand_w).sum(),
                               [tf, xtg, xsg])
    assert got[0].abs().max() > 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _tilewin_args(m, n_patch, S, Mp=3, B=2, ts=16, F=32, K=6, seed=3,
                  device="cpu", spread=1.5):
    """The texel table and plan for members clustered within ~``spread``
    texels per (patch, sample, slot), about 20% invalid: (texels, bases,
    bones, xt, xs, valid)."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, ts, ts)).astype(np.float32)
    tables = tilewin.pack_tilewin_texels(torch.from_numpy(planes), F, K)
    centers = rng.uniform(-0.85, 0.85, (B, 3, Mp, n_patch, 1, S))
    jitter = rng.uniform(-spread / ts, spread / ts, (B, 3, Mp, n_patch, m, S))
    pos = np.clip(centers + jitter, -0.99, 0.99).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, Mp, n_patch, S)).astype(np.int32)
    valid = rng.random((B, Mp, n_patch, m, S)) < 0.8
    plan = tilewin.texel_plan(tables, torch.from_numpy(pos),
                              torch.from_numpy(slot_idx),
                              torch.from_numpy(valid))
    args = (tables.texels, plan.bases, plan.bones, plan.xt, plan.xs,
            plan.valid)
    return tuple(a.to(device) for a in args)


def test_tilewin_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = _tilewin_args(16, 3, 5)
    before = tilewin_kernel.KERNEL.launches
    got = tilewin_kernel.tilewin_combine(*args, 32, 5, False)
    ref = tilewin_kernel.tilewin_combine_texels_plain(*args, 32, 5, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tilewin_kernel.KERNEL.launches == before


def test_tilewin_wrapper_refuses_window_tables():
    """The combine reads the texel table: the JAX layout's window rows are
    the plain reference's input, and the wrapper refuses them on any
    device."""
    rng = np.random.default_rng(4)
    planes = torch.from_numpy(rng.normal(size=(1, 38 * 3, 16, 16))
                              .astype(np.float32))
    tables = tilewin.pack_tilewin(planes, 32, 6)
    _, bases, bones, xt, xs, valid = _tilewin_args(16, 3, 5, B=1)
    with pytest.raises(ValueError, match="texel table"):
        tilewin_kernel.tilewin_combine(tables.feat, bases, bones, xt, xs,
                                       valid, 32, 5, False)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_patch,S,clamp", [
    (16, 3, 5, False),     # U = 15: one ragged block
    (16, 37, 7, True),     # U = 259: many blocks, ragged edge
    (4, 20, 12, False),    # the coarse-corner pass
    (4, 9, 5, True)])
def test_tilewin_kernel_matches_plain_on_card(cuda_device, m, n_patch, S,
                                              clamp):
    args = _tilewin_args(m, n_patch, S, device=cuda_device)
    k = tilewin_kernel.KERNEL
    before, before_m = k.launches, k.launches_by[m]
    with torch.no_grad():
        f, w = tilewin_kernel.tilewin_combine(*args, 32, S, clamp)
        torch.cuda.synchronize()
        f_ref, w_ref = tilewin_kernel.tilewin_combine_texels_plain(
            *args, 32, S, clamp)
    assert k.launches == before + 1 and k.launches_by[m] == before_m + 1
    torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f, f_ref, rtol=1e-4, atol=1e-5)


def test_tilewin_launch_counts_go_up_and_reset_together():
    k = KernelLibrary("tilewin_combine", "tilewin_combine_bf16", [],
                      keys=tilewin_kernel.KERNEL_MEMBERS)
    assert k.fn is None                  # counting builds nothing
    k.count(16)
    k.count(4)
    k.count(16)
    assert k.launches == 3 and k.launches_by == {4: 1, 16: 2}
    k.reset_counts()
    assert k.launches == 0 and k.launches_by == {4: 0, 16: 0}
    with pytest.raises(KeyError):
        k.count()                        # a keyed library counts by key


@pytest.mark.cuda
def test_plain_sampler_refuses_cuda_tensors(cuda_device):
    rng = np.random.default_rng(4)
    F, K, ts = 32, 6, 16
    planes = rng.normal(size=(1, (F + K) * 3, ts, ts)).astype(np.float32)
    tables = tilewin.pack_tilewin(torch.from_numpy(planes).to(cuda_device),
                                  F, K)
    pos = torch.zeros((1, 3, 2, 3, 16, 5), device=cuda_device)
    slot_idx = torch.zeros((1, 2, 3, 5), dtype=torch.int32,
                           device=cuda_device)
    valid = torch.ones((1, 2, 3, 16, 5), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="sample_tilewin_fused"):
        tilewin.sample_tilewin(tables, pos, slot_idx, valid)


@pytest.mark.cuda
def test_window_tables_raise_on_card(cuda_device):
    """The card reads the texel table: window tables on a CUDA tensor go to
    no kernel, whichever entry point they reach."""
    rng = np.random.default_rng(4)
    planes = torch.from_numpy(rng.normal(size=(1, 38 * 3, 16, 16))
                              .astype(np.float32)).to(cuda_device)
    tables = tilewin.pack_tilewin(planes, 32, 6)
    pos = torch.zeros((1, 3, 2, 3, 16, 5), device=cuda_device)
    slot_idx = torch.zeros((1, 2, 3, 5), dtype=torch.int32,
                           device=cuda_device)
    valid = torch.ones((1, 2, 3, 16, 5), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="texel table"):
        tilewin.sample_tilewin_fused(tables, pos, slot_idx, valid)
    _, bases, bones, xt, xs, v = _tilewin_args(16, 3, 5, B=1,
                                               device=cuda_device)
    with pytest.raises(ValueError, match="texel table"):
        tilewin_kernel.tilewin_combine(tables.feat, bases, bones, xt, xs, v,
                                       32, 5, False)


@pytest.mark.cuda
def test_tilewin_kernels_stay_inside_the_table_on_card(cuda_device):
    """Members at the far corner of every plane of the last image (the
    table's last texels) and beyond it (invalid ones, at clamped texels):
    kernels 2 and 2b read and add only texels of the table, and agree with
    the twin and with autograd through it."""
    rng = np.random.default_rng(8)
    B, Mp, n_patch, S, F, K, ts = 2, 2, 3, 4, 32, 6, 16
    planes = rng.normal(size=(B, (F + K) * 3, ts, ts)).astype(np.float32)
    tables = tilewin.pack_tilewin_texels(torch.from_numpy(planes), F, K)
    pos = rng.uniform(0.8, 1.3, (B, 3, Mp, n_patch, 16, S)).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, Mp, n_patch, S)).astype(np.int32)
    valid = (np.abs(pos) < 1).all(axis=1) & (rng.random(pos[:, 0].shape) < 0.9)
    plan = tilewin.texel_plan(tables, torch.from_numpy(pos),
                              torch.from_numpy(slot_idx),
                              torch.from_numpy(valid))
    args = [t.to(cuda_device) for t in (tables.texels, plan.bases,
                                        plan.bones, plan.xt, plan.xs,
                                        plan.valid)]
    with torch.no_grad():
        got = tilewin_kernel.tilewin_combine(*args, 32, S, False)
        torch.cuda.synchronize()
        ref = tilewin_kernel.tilewin_combine_texels_plain(*args, 32, S, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    cots = _cotangents(got, 7)
    grads = tilewin_kernel.launch_backward(*args, *cots, 32, S, False)
    torch.cuda.synchronize()
    leaves = [args[0].float().requires_grad_(True),
              args[3].clone().requires_grad_(True),
              args[4].clone().requires_grad_(True)]
    out = tilewin_kernel.tilewin_combine_texels_plain(
        leaves[0], *args[1:3], leaves[1], leaves[2], args[5], 32, S, False)
    refs = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)),
                               leaves)
    for name, a, b in zip(("texels", "xt", "xs"), grads, refs):
        assert _rel_l2(a, b) <= 1e-4, name
    # the last image's far corner texel took gradient
    assert float(grads[0][-1, :, -2, -2, :32].abs().sum()) > 0


@pytest.mark.cuda
def test_tilewin_kernel_refuses_a_gradient(cuda_device):
    """The coarse-corner pass (m = 4) has no backward: it runs under
    torch.no_grad(), as the JAX one runs under stop_gradient."""
    args = list(_tilewin_args(4, 3, 5, device=cuda_device))
    args[3] = args[3].requires_grad_(True)
    with pytest.raises(ValueError, match="backward for m = 16 only"):
        tilewin_kernel.tilewin_combine(*args, 32, 5, False)


def _device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def test_tilewin_input_checks_refuse_what_no_kernel_takes(monkeypatch):
    """Checked before the dispatch, so the same on the CPU and the card:
    an unknown mode, a matrix mode at m = 4, a gradient at m = 4, and a
    gradient for valid."""
    dev = _device()
    args16 = list(_tilewin_args(16, 3, 5, device=dev))
    args4 = list(_tilewin_args(4, 3, 5, device=dev))
    with pytest.raises(ValueError, match="mode must be one of"):
        tilewin_kernel.tilewin_combine(*args16, 32, 5, False, mode="mxu")
    monkeypatch.setenv("ENARF_TILEWIN_KERNEL", "mxu")
    with pytest.raises(ValueError, match="mode must be one of"):
        tilewin_kernel.tilewin_combine(*args16, 32, 5, False)
    monkeypatch.delenv("ENARF_TILEWIN_KERNEL")
    for mode in tilewin_kernel.MATRIX_MODES:
        with pytest.raises(ValueError, match="takes m = 16"):
            tilewin_kernel.tilewin_combine(*args4, 32, 5, False, mode=mode)
    xs = args4[4].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="backward for m = 16 only"):
        tilewin_kernel.tilewin_combine(*args4[:4], xs, args4[5], 32, 5, False)
    valid = args16[5].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="valid takes no gradient"):
        tilewin_kernel.tilewin_combine(*args16[:5], valid, 32, 5, False)
    with torch.no_grad():                # the coarse pass as the renderer runs it
        tilewin_kernel.tilewin_combine(*args4[:4], xs, args4[5], 32, 5, False)


def test_unirow_input_checks_refuse_a_gradient_for_valid():
    table, rows, wq4, idx, valid = _combine_args(1, 40, 4, device=_device())
    with pytest.raises(ValueError, match="valid takes no gradient"):
        unirow.unirow_combine(table, rows, wq4, idx, valid.requires_grad_(True),
                              32, False)


def test_plain_modes_on_cpu():
    """On the CPU every mode runs the texel twin: "vpu" is "hat", "dot" and
    "bdiag" round the t-weights to bf16 (within 1e-1 of "hat")."""
    args = _tilewin_args(16, 3, 5)
    out = {m: tilewin_kernel.tilewin_combine(*args, 32, 5, False, mode=m)
           for m in tilewin_kernel.MODES}
    for a, b in zip(out["vpu"], out["hat"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(out["bdiag"], out["dot"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(out["dot"][1], out["hat"][1], rtol=0, atol=0)
    assert 0 < float((out["dot"][0] - out["hat"][0]).abs().max()) < 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dot", "vpu", "bdiag"])
@pytest.mark.parametrize("n_patch,S,clamp", [(3, 5, False), (37, 7, True)])
def test_tilewin_modes_kernel_matches_plain_on_card(cuda_device, mode,
                                                    n_patch, S, clamp):
    args = _tilewin_args(16, n_patch, S, device=cuda_device)
    k = tilewin_kernel.KERNEL_MODES
    before = k.launches_by[mode]
    with torch.no_grad():
        f, w = tilewin_kernel.tilewin_combine(*args, 32, S, clamp, mode=mode)
        torch.cuda.synchronize()
        f_ref, w_ref = tilewin_kernel.tilewin_combine_texels_plain(
            *args, 32, S, clamp, round_t=mode != "vpu")
    assert k.launches_by[mode] == before + 1
    torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f, f_ref, rtol=1e-4, atol=1e-5)


def _no_window_tables(monkeypatch):
    """Make the window-table builders raise: kernel 3's launch reads the
    texel table and must call neither."""
    def refuse(*args, **kwargs):
        raise AssertionError("kernel 3's launch built window tables")
    monkeypatch.setattr(tilewin_kernel, "windows_from_texels", refuse)
    monkeypatch.setattr(tilewin_kernel, "window_rows", refuse)


@pytest.mark.parametrize("mode", ["dot", "vpu", "bdiag"])
def test_modes_launch_passes_the_texel_table(monkeypatch, mode):
    """Kernel 3's launch, with the CUDA entry point replaced by a recorder:
    it gets kernel 2's inputs (the texel table, bases, bones, xt, xs,
    valid), the outputs, (B, H, W, Mp, U, S, clamp, tensor) and the raw
    stream handle, counts one launch under its mode, and builds no window
    table."""
    _no_window_tables(monkeypatch)
    args = _tilewin_args(16, 3, 5)
    calls = []

    def entry(*a):
        calls.append(a)
        return 0

    monkeypatch.setattr(tilewin_kernel.KERNEL_MODES, "load", lambda: entry)
    monkeypatch.setattr(tilewin_kernel, "raw_stream", lambda t: 1234)
    before = dict(tilewin_kernel.KERNEL_MODES.launches_by)
    f, w = tilewin_kernel._launch_kernel(*args, 32, 5, True, mode=mode)
    (a,) = calls
    assert a[:6] == tuple(t.data_ptr() for t in args)
    assert a[6:8] == (f.data_ptr(), w.data_ptr())
    B, Mp, U = args[1].shape[0], args[1].shape[2], args[1].shape[3]
    assert a[8:] == (B, 16, 16, Mp, U, 5, 1, int(mode != "vpu"), 1234)
    assert tilewin_kernel.KERNEL_MODES.launches_by[mode] == before[mode] + 1
    assert tuple(f.shape) == (B, 32, U * 16)
    assert tuple(w.shape) == (B, Mp, U // 5, 16, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dot", "vpu", "bdiag"])
@pytest.mark.parametrize("edge", [False, True])
def test_tilewin_modes_kernel_matches_window_rows_on_card(
        cuda_device, monkeypatch, mode, edge):
    """Kernel 3 through ``tilewin_combine`` (which builds no window table)
    against the texel twin (1e-4 / 1e-5) and against its window-row
    formulation on the rows ``windows_from_texels`` builds (1e-6: the same
    tiles), on clustered members and on a plan at the far corner of every
    plane, whose windows reach past the plane (the TMA's zero fill) and
    whose last image's are the table's last texels."""
    if edge:
        rng = np.random.default_rng(8)
        Bn, Mp, n_patch, S, F, K, ts = 2, 2, 3, 4, 32, 6, 16
        planes = rng.normal(size=(Bn, (F + K) * 3, ts, ts)).astype(np.float32)
        tables = tilewin.pack_tilewin_texels(torch.from_numpy(planes), F, K)
        pos = rng.uniform(0.8, 1.3, (Bn, 3, Mp, n_patch, 16, S)) \
            .astype(np.float32)
        slot_idx = rng.integers(0, K, (Bn, Mp, n_patch, S)).astype(np.int32)
        valid = (np.abs(pos) < 1).all(axis=1) \
            & (rng.random(pos[:, 0].shape) < 0.9)
        plan = tilewin.texel_plan(tables, torch.from_numpy(pos),
                                  torch.from_numpy(slot_idx),
                                  torch.from_numpy(valid))
        args = [t.to(cuda_device) for t in (tables.texels, plan.bases,
                                            plan.bones, plan.xt, plan.xs,
                                            plan.valid)]
        nb = tilewin_kernel.num_bases(ts)
        last = (args[1] % (ts + 2) ** 2) // (ts + 2) // 2 == nb - 1
        assert bool(last.any())
    else:
        S = 5
        args = list(_tilewin_args(16, 3, S, device=cuda_device))
    texels, bases, bones = args[:3]
    Hp, Wp = texels.shape[2:4]
    nb = tilewin_kernel.num_bases(Hp - 2)
    feat, mask = tilewin_kernel.windows_from_texels(texels, nb)
    frows, mrows = tilewin_kernel.window_rows(bases, bones, Hp, Wp, nb)
    _no_window_tables(monkeypatch)
    with torch.no_grad():
        got = tilewin_kernel.tilewin_combine(*args, 32, S, False, mode=mode)
        rows = ablate.modes_stage(feat, mask, frows, mrows, *args[3:6], S,
                                  False, "vpu" if mode == "vpu" else "dot",
                                  "full")
        torch.cuda.synchronize()
        ref = tilewin_kernel.tilewin_combine_texels_plain(
            *args, 32, S, False, round_t=mode != "vpu")
    for a, b, r in zip(got, rows, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
        assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n_patch,S,clamp", [(3, 5, False), (37, 7, True)])
def test_tilewin_backward_kernel_matches_plain_on_card(cuda_device, n_patch,
                                                       S, clamp):
    texels, bases, bones, xt, xs, valid = _tilewin_args(
        16, n_patch, S, device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (texels, xt, xs)]
    outs = tilewin_kernel.tilewin_combine(leaves[0], bases, bones, leaves[1],
                                          leaves[2], valid, 32, S, clamp)
    cots = _cotangents(outs, 6)
    before = tilewin_kernel.KERNEL_BWD.launches
    grads = tilewin_kernel.launch_backward(texels, bases, bones, xt, xs,
                                           valid, *cots, 32, S, clamp)
    torch.cuda.synchronize()
    assert tilewin_kernel.KERNEL_BWD.launches == before + 1
    assert grads[0].dtype == torch.float32
    ref_leaves = [texels.float().requires_grad_(True),
                  xt.clone().requires_grad_(True),
                  xs.clone().requires_grad_(True)]
    ref = tilewin_kernel.tilewin_combine_texels_plain(
        ref_leaves[0], bases, bones, ref_leaves[1], ref_leaves[2], valid, 32,
        S, clamp)
    refs = torch.autograd.grad(sum((o * c).sum() for o, c in zip(ref, cots)),
                               ref_leaves)
    for name, got, want in zip(("texels", "xt", "xs"), grads, refs):
        assert _rel_l2(got, want) <= 1e-4, name
    # through the autograd Function: the texel table in its bf16 type
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)),
                            leaves)
    assert g[0].dtype == torch.bfloat16
    assert tilewin_kernel.KERNEL_BWD.launches == before + 2
    torch.testing.assert_close(g[1], grads[1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_tilewin_kernel_rejects_other_widths_and_member_counts(cuda_device):
    with pytest.raises(ValueError, match="m in"):
        tilewin_kernel.tilewin_combine(
            *_tilewin_args(9, 3, 5, device=cuda_device), 32, 5, False)
    args = _tilewin_args(16, 3, 5, device=cuda_device)
    with pytest.raises(ValueError, match="feat_dim"):
        tilewin_kernel.tilewin_combine(*args, 16, 5, False)


# ------------------------------------------- the probes (enarf_gan_tpu_torch.tools)

def _probe_modules():
    from enarf_gan_tpu_torch.tools import ablate, constructs, gather, mma
    return {"gather": gather, "mma": mma, "ablate": ablate,
            "constructs": constructs}


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["gather", "mma", "ablate", "constructs"])
def test_probe_kernels_match_plain_on_card(cuda_device, module):
    """Every probe kernel and variant at its small ("check") size against its
    plain twin, each launch counted once (tolerances: each case's, see
    enarf_gan_tpu_torch/tools)."""
    from enarf_gan_tpu_torch.tools import timing
    for case in _probe_modules()[module].cases(cuda_device, "check"):
        lib, key = case.counter
        before = lib.launches_by[key]
        timing.check(case)
        assert lib.launches_by[key] == before + 1, case.name


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", [(3, torch.float32), (66, torch.float32),
                                         (2, torch.bfloat16), (1024, torch.bfloat16)])
def test_row_gather_ragged_on_card(cuda_device, width, dtype):
    from enarf_gan_tpu_torch.tools import gather
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tab = torch.randn((301, width), generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(0, 301, (997,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    for serial in (0, 5):
        got = gather.row_gather(tab, idx, serial_rows=serial)
        torch.testing.assert_close(got, tab[idx.long()], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes", [4, 8, 12, 20, 64, 128, 256, 264, 288,
                                       2048, 4096, 4100])
def test_row_gather_plans_on_card(cuda_device, row_bytes):
    """A1 bit-equal to its twin at every width of the sweep and the ragged
    ones, at n of one row, a ragged 4,099 and one past a wave of the card's
    threads, so that rows of 128 bytes and more run under both cache hints
    of row_plan (the plain ones at one row, the streaming ones past a
    wave), a table off 16 bytes (8- or 4-byte units) and an index off 16
    bytes; each launch counted once. A plan whose grid is one block short
    is refused."""
    from enarf_gan_tpu_torch.tools import gather
    g = torch.Generator(device=cuda_device).manual_seed(3)
    words = row_bytes // 4
    flat = torch.randn((301 * words + 4,), generator=g, device=cuda_device)
    sms = gather._card(torch.cuda.current_device())[0]
    wave = sms * gather.SM_THREADS * 16 // row_bytes + 1
    hints = set()
    for tab in (flat[:301 * words].view(301, words),
                flat[1:1 + 301 * words].view(301, words)):
        off = tab.data_ptr() % 16
        for n in (1, 4099, wave):
            plan = gather.row_plan(n, row_bytes, off & -off if off else 16,
                                   sms)
            hints.add(plan.variant)
            idx_flat = torch.randint(0, 301, (n + 1,), generator=g,
                                     device=cuda_device, dtype=torch.int32)
            for idx in (idx_flat[:n], idx_flat[1:]):
                ref = gather.row_gather_plain(tab, idx)
                before = gather.KERNEL.launches_by["row"]
                got = gather.row_gather(tab, idx)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (row_bytes, n, plan)
                assert gather.KERNEL.launches_by["row"] == before + 1
    assert hints == ({"plain", "stream"} if row_bytes >= gather.STREAM_BYTES
                     else {"plain"}), hints
    plan = gather.row_plan(4099, row_bytes, 16, sms)
    idx = torch.randint(0, 301, (4099,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    out = torch.empty((4099, words), device=cuda_device)
    assert gather.KERNEL.load("probe_row_gather")(
        flat.data_ptr(), idx.data_ptr(), out.data_ptr(), 4099, row_bytes,
        plan.unit, 0, plan.blocks - 1,
        torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 1024, 1500])
def test_row_gather_warp_loop_on_card(cuda_device, k):
    """A2, one warp walking k rows: bit-equal to the twin at row widths from
    4 B to 4 KB (rows of fewer and more units than the warp's 32 lanes), a
    row count that no group of units divides, and more rows a warp than it
    stages indices at once (1,500); the groups leave by TMA bulk stores
    where every warp's rows start and end on 16 bytes, else by the lanes'
    stores (rows of 4, 8 and 12 bytes: 1,997 of them end off 16 bytes)."""
    from enarf_gan_tpu_torch.tools import gather
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for row_bytes in (4, 8, 12, 16, 48, 512, 528, 2064, 4096):
        tab = torch.randn((301, row_bytes // 4), generator=g,
                          device=cuda_device)
        idx = torch.randint(0, 301, (1997,), generator=g, device=cuda_device,
                            dtype=torch.int32)
        before = gather.KERNEL.launches_by["serial"]
        got = gather.row_gather(tab, idx, serial_rows=k)
        torch.cuda.synchronize()
        assert torch.equal(got, gather.row_gather_plain(tab, idx)), row_bytes
        assert gather.KERNEL.launches_by["serial"] == before + 1


def _lane_limits(L, dtype):
    """Table heights just under and just over each width of staging: the
    whole row's columns, then halves down to 8 lane vectors (32 lanes)."""
    es = torch.tensor([], dtype=dtype).element_size()
    from enarf_gan_tpu_torch.tools import gather
    block_smem = gather._card(torch.cuda.current_device())[2]
    tx, out = gather._lane_tx(L), []
    while True:
        top = block_smem // (4 * tx * es)
        out += [top, top + 1]
        if tx <= 8:
            return out
        tx //= 2


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 3, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_gather_designs_on_card(cuda_device, L, dtype):
    """A3 in every mode, through L1 and staged in shared memory where the
    table's columns fit, bit-equal to the twin: ragged L (not a multiple of
    the 4-lane vector, two column blocks), n = 1001 (no multiple of the
    rows a thread has in flight), tables just under and over each staging
    limit."""
    from enarf_gan_tpu_torch.tools import gather
    g = torch.Generator(device=cuda_device).manual_seed(2)
    n = 1001

    def check(tab, idx, mode, group=8):
        ref = gather.lane_gather_plain(tab, idx, mode, group)
        tx = gather.lane_stage_tx(tab, mode)
        for stage in {0, tx}:
            got = gather._lane_launch(tab, idx, mode, group, stage)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (mode, tuple(tab.shape), stage)
        assert torch.equal(gather.lane_gather(tab, idx, mode, group), ref)

    for th in [97] + _lane_limits(L, dtype):
        tab = torch.randn((th, L), generator=g, device=cuda_device).to(dtype)
        check(tab, torch.randint(0, th, (n, L), generator=g,
                                 device=cuda_device, dtype=torch.int32),
              "table")
    tab = torch.randn((1000, L), generator=g, device=cuda_device).to(dtype)
    check(tab, torch.randint(0, 8, (1000, L), generator=g, device=cuda_device,
                             dtype=torch.int32), "tile")
    check(tab, torch.randint(0, L, (1000, L), generator=g, device=cuda_device,
                             dtype=torch.int32), "lane")
    # an index that starts off a 16-byte boundary takes the scalar path
    idx = torch.randint(0, 97, (n * L + 1,), generator=g, device=cuda_device,
                        dtype=torch.int32)[1:].view(n, L)
    check(torch.randn((97, L), generator=g, device=cuda_device).to(dtype),
          idx, "table")


@pytest.mark.cuda
def test_probe_timing_fields_on_card(cuda_device):
    """measure's host and device µs a call, of the kernel and the library
    call, are positive and finite at a small case, and its launches leave
    out the launch-cost calls."""
    import math
    from enarf_gan_tpu_torch.tools import gather, timing
    case = next(c for c in gather.cases(cuda_device, "check")
                if c.name.startswith("A3"))
    lib, key = case.counter
    before = lib.launches_by[key]
    t = timing.measure(case, budget_ms=2.0)
    for key_ in ("device_us", "host_us", "library_device_us",
                 "library_host_us"):
        assert 0 < t[key_] < 1e5 and math.isfinite(t[key_]), (key_, t[key_])
    # the launches of the timing in ms (a warm-up, one, then 2 x reps), not
    # those of the launch-cost calls
    assert 6 <= t["launches"] < lib.launches_by[key] - before


@pytest.mark.cuda
def test_probe_wrappers_refuse_on_card(cuda_device):
    from enarf_gan_tpu_torch.tools import constructs, gather, mma
    dev = cuda_device
    with pytest.raises(ValueError, match="multiple of 4"):
        gather.row_gather(torch.zeros((5, 3), dtype=torch.bfloat16, device=dev),
                          torch.zeros(2, dtype=torch.int32, device=dev))
    tab = torch.zeros((10, 16, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="Q in"):
        gather.ring_gather(tab, torch.zeros(8, dtype=torch.int32, device=dev),
                           4, Q=3)
    with pytest.raises(ValueError, match="contiguous"):
        gather.transpose(torch.zeros((2, 16, 8), device=dev).transpose(1, 2))
    g = torch.Generator(device=dev).manual_seed(0)
    loc, w, slab = mma.b1_inputs(96, 48, 128, "static", dev, g)
    words = torch.zeros(2 * 96 + 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="8-byte"):        # 4 bytes off
        mma.onehot_gather(words[1:-1].view(96, 2), w, slab, 48, 128)
    rows = torch.zeros(129 * 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):       # 8 bytes off
        mma.onehot_gather(loc, w, rows[4:4 + 128 * 128].view(128, 128), 48,
                          128)
    many = torch.zeros((mma.PAIR_MAX_S, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="2\\*\\*26"):
        mma.onehot_gather(many, many.float(), slab, 64, 128)
    del many
    a = torch.zeros((2, 16, 24), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        mma.gemm(a, torch.zeros((24, 128), dtype=torch.bfloat16, device=dev))
    flat = torch.zeros(2 * 512 * 64 + 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):     # 2 bytes off
        mma.gemm(flat[1:1 + 2 * 512 * 64].view(2, 512, 64),
                 torch.zeros((64, 128), dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="not the construct's"):
        constructs.construct("cat_sub", torch.zeros((4, 16, 3), device=dev))


@pytest.mark.cuda
def test_probe_gemm_and_onehot_ragged_on_card(cuda_device):
    """B3 across the edges of both kernels' tiles (the TMA kernel's 256
    rows and 64-deep k-tiles, resident and streamed B, more tiles than
    SMs, and walks of at most 128 rows whose K is too deep for the
    launch-bound kernel; the launch-bound kernel's blocks of 16 and 32
    rows), each launch counted under the kernel the plan names; B1 at
    ragged groups and windows and B2 at 1 and 3 blocks, each launch
    counted."""
    from enarf_gan_tpu_torch.tools import mma
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tile = mma.GEMM_TILE_ROWS
    shapes = ((3, 48, 32, False), (5, 16, 16, True), (2, 96, 80, True),
              (2, tile - 16, 64 + 16, True), (1, tile + 16, 16, False),
              (2, tile + 16, 2 * 64 + 16, True), (30, 16, 64 + 16, False),
              (1, 16, 16, False), (3, tile, 4 * 64 + 16, False),
              (4, 144, 3 * 64 + 16, False), (1, 16, 1024, True),
              (3, 128, 320, True)) + mma.B3_RAGGED
    for batch, M, K, batched in shapes:
        a = torch.randn((batch, M, K), generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        b = torch.randn(((batch,) if batched else ()) + (K, 128), generator=g,
                        device=cuda_device).to(torch.bfloat16)
        kernel = mma.gemm_plan(batch, M, K, batched).kernel
        before = mma.KERNEL.launches_by[kernel]
        torch.testing.assert_close(mma.gemm(a, b), mma.gemm_plain(a, b),
                                   rtol=1e-4, atol=1e-4 * K ** 0.5)
        assert mma.KERNEL.launches_by[kernel] == before + 1, (batch, M, K)
    assert {mma.gemm_plan(b, M, K, bb).kernel
            for b, M, K, bb in shapes} == {"gemm", "gemm_small"}
    assert mma.gemm_plan(1, 16, 1024, True).kernel == "gemm"
    # the launch-bound kernel at its edges: batch 1 and 3 (16-row blocks),
    # M 16-128, K 16-64 and 240 (the deepest K a 32-row block does not
    # fit), and 32-row blocks that do not divide M (80, 48)
    edges = [(batch, M, K) for batch in (1, 3)
             for M, K in ((16, 16), (48, 64), (112, 48), (128, 16), (80, 32),
                          (128, 240))] + [(40, 80, 32), (64, 48, 64)]
    assert {mma.gemm_plan(b, M, K, True).block_rows
            for b, M, K in edges} == {16, 32}
    for batch, M, K in edges:
        a = torch.randn((batch, M, K), generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        b = torch.randn((batch, K, 128), generator=g,
                        device=cuda_device).to(torch.bfloat16)
        assert mma.gemm_plan(batch, M, K, True).kernel == "gemm_small"
        before = mma.KERNEL.launches_by["gemm_small"]
        got = mma.gemm(a, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, mma.gemm_plain(a, b), rtol=1e-4,
                                   atol=1e-4 * K ** 0.5)
        assert mma.KERNEL.launches_by["gemm_small"] == before + 1, \
            (batch, M, K)
    # B1 at groups and windows no multiple of 64, a last block left
    # partial (G = 5), rows outside the window and coinciding; B2 at 1 and
    # 3 blocks, bit-equal
    for mode in mma.WINDOW_MODES:
        for G in (48, 192, 5):
            for WIN in (80, 320):
                S = 3 * G
                loc, w, tab = mma.b1_inputs(S, G, WIN, mode, cuda_device, g)
                loc[1, 1] = loc[1, 0]
                loc[2, 0] += WIN
                if G == 5:
                    assert S % mma.PAIR_SAMPLES and S % 2
                key = f"onehot_{mode}"
                before = mma.KERNEL.launches_by[key]
                got = mma.onehot_gather(loc, w, tab, G, WIN, mode)
                torch.cuda.synchronize()
                assert mma.KERNEL.launches_by[key] == before + 1
                torch.testing.assert_close(
                    got, mma.onehot_gather_plain(loc, w, tab, G, WIN, mode),
                    rtol=1e-6, atol=1e-6)
    tab = torch.randn((4 * mma.TILE, 128), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    for n_blocks in (1, 3):
        tile = torch.randint(0, 4, (n_blocks,), generator=g,
                             device=cuda_device, dtype=torch.int32)
        loc = torch.randint(0, mma.TILE, (n_blocks * mma.TILE,), generator=g,
                            device=cuda_device, dtype=torch.int32)
        before = mma.KERNEL.launches_by["tile"]
        got = mma.tile_gather(tile, loc, tab)
        torch.cuda.synchronize()
        assert mma.KERNEL.launches_by["tile"] == before + 1
        assert torch.equal(got, mma.tile_gather_plain(tile, loc, tab))


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(64, 16), (16, 128), (3, 5), (48, 63)])
def test_transpose_ragged_on_card(cuda_device, R, C):
    """A5 bit-equal to its twin: the register kernel at the probes' shapes
    and the shared-memory tile kernel at the others, for 1 and 37 matrices
    and a count no block's share divides (8 matrices of (64, 16), 4 of (16,
    128)), and from an input off 16 bytes (the tile kernel), each launch
    counted."""
    from enarf_gan_tpu_torch.tools import gather
    g = torch.Generator(device=cuda_device).manual_seed(4)
    for NB in (1, 37, 1003):
        flat = torch.randn(NB * R * C + 1, generator=g, device=cuda_device)
        for x in (flat[:-1].view(NB, R, C), flat[1:].view(NB, R, C)):
            before = gather.KERNEL.launches_by["transpose"]
            got = gather.transpose(x)
            torch.cuda.synchronize()
            assert torch.equal(got, gather.transpose_plain(x)), (NB, R, C)
            assert gather.KERNEL.launches_by["transpose"] == before + 1


@pytest.mark.cuda
def test_construct_own_kernels_ragged_on_card(cuda_device):
    """reshape_fm_kernel (1e-5: float32 sums in another order),
    ewr_mma_kernel (1e-5: float32 sums of exact products in another order),
    vec4_kernel<false> (reshape_lead) and <true> (load_c, warm and cat_sub;
    bit-equal), expand_kernel and concat_mid_kernel (vectors and words;
    bit-equal) against construct_plain at
    ragged shapes (TB 2113, 3 M words and 1.2 M words take more than one
    wave), short last blocks, word counts that are and are not multiples
    of 4, M and TB that are no powers of two; each launch counted under
    its construct. A base off 16 bytes raises in the wrapper, and a grid
    too small for the rows in the entry point."""
    from enarf_gan_tpu_torch.tools import constructs
    g = torch.Generator(device=cuda_device).manual_seed(5)
    shapes = [("reshape_fm", s) for s in ((1, 2048), (3, 2048), (37, 2048),
                                          (1000, 2048), (2113, 2048))] \
        + [("reshape_lead", s) for s in ((1, 1), (1, 3), (3, 5, 7),
                                         (37, 16, 128), (2, 7, 105),
                                         (1000, 1000, 1), (600, 1000, 5))] \
        + [("ewr", (TB, 16, 64)) for TB in (1, 3, 37, 1000, 2113)] \
        + [(n, s) for n in ("cat_sub", "load_c")
           for s in ((1, 1, 1), (1, 3, 1), (3, 5, 1), (2, 2, 1), (37, 16, 1),
                     (600, 1999, 1), (601, 1999, 1))] \
        + [("warm", s) for s in ((1, 1), (3, 5), (37, 128), (1024, 1200),
                                 (1001, 1203))] \
        + [("expand", s) for s in ((1, 1), (5, 3), (16, 37), (16, 128),
                                   (7, 3001), (33, 2113))] \
        + [("concat_mid", s) for s in ((1, 1), (3, 4), (37, 16), (128, 16),
                                       (5, 36), (3, 1), (37, 3), (2, 5),
                                       (2113, 16), (2113, 33), (1000, 1204))]
    for name, shape in shapes:
        ins = constructs.check_inputs(name, shape, cuda_device, g)
        before = constructs.KERNEL.launches_by[name]
        got = constructs.construct(name, *ins)
        torch.cuda.synchronize()
        tol = 1e-5 if name in ("reshape_fm", "ewr") else 0.0
        torch.testing.assert_close(got, constructs.construct_plain(name, *ins),
                                   rtol=tol, atol=tol)
        assert constructs.KERNEL.launches_by[name] == before + 1, shape
    stream = torch.cuda.current_stream().cuda_stream
    flat = torch.zeros(37 * 2048 + 8, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16 bytes"):
        constructs.construct("reshape_fm", flat[1:1 + 37 * 2048].view(37, 2048))
    out = torch.empty((37, 32), device=cuda_device)
    assert constructs.KERNEL.load("probe_reshape_fm")(
        flat.data_ptr(), out.data_ptr(), 37, 36, stream) != 0
    x, y = constructs.check_inputs("ewr", (37, 16, 64), cuda_device, g)
    for t in (x, y):
        off = torch.zeros(t.numel() + 8, dtype=torch.bfloat16,
                          device=cuda_device)[1:1 + t.numel()].view(t.shape)
        with pytest.raises(ValueError, match="16 bytes"):
            constructs.construct("ewr", *((off, y) if t is x else (x, off)))
    out = torch.empty((37, 16, 32), device=cuda_device)
    ewr = constructs.KERNEL.load("probe_ewr")
    assert ewr(x.data_ptr(), y.data_ptr(), out.data_ptr(), 37, 18,
               stream) != 0                    # 36 warps for 37 elements
    w = torch.zeros(1001 * 1203 + 4, device=cuda_device)
    with pytest.raises(ValueError, match="16 bytes"):
        constructs.construct("warm", w[1:1 + 1001 * 1203].view(1001, 1203))
    out = torch.empty(1001 * 1203, device=cuda_device)
    for twice in (0, 1):
        assert constructs.KERNEL.load("probe_vec4")(
            w.data_ptr(), out.data_ptr(), 1001 * 1203, twice,
            constructs.copy_plan(1001 * 1203).blocks - 1, stream) != 0
    x = torch.randn((33, 2113), generator=g, device=cuda_device)
    out = torch.empty((2113, 33, 128), device=cuda_device)
    assert constructs.KERNEL.load("probe_expand")(
        x.data_ptr(), out.data_ptr(), 2113, 33,
        constructs.copy_plan(out.numel()).blocks - 1, stream) != 0
    for TB, M in ((2113, 16), (2113, 33)):
        x = torch.randn((TB, M), generator=g, device=cuda_device)
        out = torch.empty((TB, 2 * M), device=cuda_device)
        assert constructs.KERNEL.load("probe_concat_mid")(
            x.data_ptr(), out.data_ptr(), TB, M,
            constructs.own_plan("concat_mid", x).blocks - 1, stream) != 0


@pytest.mark.cuda
def test_ewr_library_call_matches_plain_on_card(cuda_device):
    """ewr's card-only library call, the float32-out ``torch.bmm``, against
    construct_plain at the probe's inputs (1e-5: float32 sums of exact
    products in another order)."""
    from enarf_gan_tpu_torch.tools import constructs
    case = next(c for c in constructs.cases(cuda_device) if c.name == "D ewr")
    got = case.library()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, case.plain(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_launch_cost_on_card(cuda_device):
    from enarf_gan_tpu_torch.tools import constructs, timing
    g = torch.Generator(device=cuda_device).manual_seed(3)
    ins, outs = constructs.roster_args("7in_2out", cuda_device, g)
    host_us, device_us = timing.launch_us(
        lambda: constructs.roster("7in_2out", ins, outs), spin_ms=5.0)
    assert 0 < device_us < 1e3 and 0 < host_us < 1e4


@pytest.mark.cuda
def test_warp_rows_study_on_card(cuda_device):
    """tools/warp_rows.py: its copying kernels (the ring of lane stores in
    1-8 warps, TMA bulk loads) equal tab[idx], and each part of A2's loop
    gives a positive time."""
    from enarf_gan_tpu_torch.tools import warp_rows
    out = warp_rows.main()
    assert set(out["device_us"]) >= set(warp_rows.PARTS)
    assert all(0 < t < 1e4 for t in out["device_us"].values())
    assert 0 < out["chase_ns_a_row"] < 1e4
