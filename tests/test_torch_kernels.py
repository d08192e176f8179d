"""The port's kernel wrappers: dispatch, input checks, and each CUDA kernel
against its plain PyTorch version on the card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax; there, skip the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance, kernel vs plain: both compute in float32 from the same bf16
rows; the sums run in another order and the exp is another
implementation, so 1e-4 relative / 1e-5 absolute (the forward kernels).
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


def _combine_args(B, n, M, H=16, F=32, K=23, seed=2, device="cpu"):
    """The texel table and candidate inputs of ``unirow_combine``; points
    outside every bone and on the plane edges (in the zero padding)."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, H, H)).astype(np.float32)
    pos = rng.uniform(-1.4, 1.4, (B, n, M, 3)).astype(np.float32)
    pos[:, :2] = 2.0                     # points outside every bone
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    table = unirow.pack_texels(torch.from_numpy(planes), F, K)
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


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, rows, wq4, idx, valid = _combine_args(1, 50, 4)
    with pytest.raises(ValueError, match="table"):
        unirow.unirow_combine(table.float(), rows, wq4, idx, valid, 32, False)
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
    with pytest.raises(ValueError, match="multiples of 64"):
        mma.onehot_gather(loc, w, slab, 48, 128)
    a = torch.zeros((2, 16, 24), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        mma.gemm(a, torch.zeros((24, 128), dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="not the construct's"):
        constructs.construct("cat_sub", torch.zeros((4, 16, 3), device=dev))


@pytest.mark.cuda
def test_probe_gemm_and_onehot_ragged_on_card(cuda_device):
    from enarf_gan_tpu_torch.tools import mma
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for batch, M, K, batched in ((3, 48, 32, False), (5, 16, 16, True),
                                 (2, 96, 80, True)):
        a = torch.randn((batch, M, K), generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        b = torch.randn(((batch,) if batched else ()) + (K, 128), generator=g,
                        device=cuda_device).to(torch.bfloat16)
        torch.testing.assert_close(mma.gemm(a, b), mma.gemm_plain(a, b),
                                   rtol=1e-4, atol=1e-4 * K ** 0.5)
    for mode in mma.WINDOW_MODES:
        loc, w, tab = mma.b1_inputs(3 * 192, 192, 320, mode, cuda_device, g)
        ref = mma.onehot_gather_plain(loc, w, tab, 192, 320, mode)
        for fn in (mma.onehot_gather, mma.direct_gather):
            torch.testing.assert_close(fn(loc, w, tab, 192, 320, mode), ref,
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_launch_cost_on_card(cuda_device):
    from enarf_gan_tpu_torch.tools import constructs
    host_us, device_us = constructs.launch_cost("7in_2out", cuda_device, n=50,
                                                spin_ms=5.0)
    assert 0 < device_us < 1e3 and 0 < host_us < 1e4
