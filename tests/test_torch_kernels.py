"""The port's kernel wrappers: dispatch, input checks, and each CUDA kernel
against its plain PyTorch version on the card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax; there, skip the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance, kernel vs plain: both compute in float32 from the same bf16
rows; the sums run in another order and the exp is another
implementation, so 1e-4 relative / 1e-5 absolute (both kernels).
"""
import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel, unirow


def _combine_args(B, n, M, H=16, F=32, K=23, seed=2, device="cpu"):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, H, H)).astype(np.float32)
    pos = rng.uniform(-1.4, 1.4, (B, n, M, 3)).astype(np.float32)
    pos[:, :2] = 2.0                     # points outside every bone
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    table = unirow.pack_unirow(torch.from_numpy(planes), F, K)
    args = (table,) + unirow.candidate_rows(
        torch.from_numpy(pos), torch.from_numpy(idx), torch.from_numpy(valid),
        H, H)
    return tuple(a.to(device) for a in args)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = _combine_args(1, 50, 4)
    before = unirow.KERNEL.launches
    got = unirow.unirow_combine(*args, 32, False)
    ref = unirow.gather_combine_plain(*args, 32, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert unirow.KERNEL.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, rows, wq4, idx, valid = _combine_args(1, 50, 4)
    with pytest.raises(ValueError, match="table"):
        unirow.unirow_combine(table.float(), rows, wq4, idx, valid, 32, False)
    with pytest.raises(ValueError, match="rows"):
        unirow.unirow_combine(table, rows.long(), wq4, idx, valid, 32, False)
    with pytest.raises(ValueError, match="valid"):
        unirow.unirow_combine(table, rows, wq4, idx, valid[:, :2], 32, False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,M,clamp", [(1, 1000, 4, False), (2, 333, 3, True),
                                         (1, 5, 1, False)])
def test_unirow_kernel_matches_plain_on_card(cuda_device, B, n, M, clamp):
    args = _combine_args(B, n, M, device=cuda_device)
    before = unirow.KERNEL.launches
    with torch.no_grad():
        f, w = unirow.unirow_combine(*args, 32, clamp)
        torch.cuda.synchronize()
        f_ref, w_ref = unirow.gather_combine_plain(*args, 32, clamp)
    assert unirow.KERNEL.launches == before + 1
    torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f, f_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_unirow_kernel_refuses_a_gradient(cuda_device):
    table, rows, wq4, idx, valid = _combine_args(1, 40, 4, device=cuda_device)
    with pytest.raises(NotImplementedError, match="backward"):
        unirow.unirow_combine(table, rows, wq4.requires_grad_(True), idx,
                              valid, 32, False)


def _tilewin_args(m, n_patch, S, Mp=3, B=2, ts=16, F=32, K=6, seed=3,
                  device="cpu"):
    """Window tables and plan for members clustered within ~1.5 texels per
    (patch, sample, slot), about 20% invalid."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, ts, ts)).astype(np.float32)
    tables = tilewin.pack_tilewin(torch.from_numpy(planes), F, K)
    centers = rng.uniform(-0.85, 0.85, (B, 3, Mp, n_patch, 1, S))
    jitter = rng.uniform(-1.5 / ts, 1.5 / ts, (B, 3, Mp, n_patch, m, S))
    pos = np.clip(centers + jitter, -0.99, 0.99).astype(np.float32)
    slot_idx = rng.integers(0, K, (B, Mp, n_patch, S)).astype(np.int32)
    valid = rng.random((B, Mp, n_patch, m, S)) < 0.8
    plan = tilewin._fused_plan(tables, torch.from_numpy(pos),
                               torch.from_numpy(slot_idx),
                               torch.from_numpy(valid))
    args = (tables.feat, tables.mask, plan.frows, plan.mrows, plan.xt,
            plan.xs, plan.valid)
    return tuple(a.to(device) for a in args)


def test_tilewin_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = _tilewin_args(16, 3, 5)
    before = tilewin_kernel.KERNEL.launches
    got = tilewin_kernel.tilewin_combine(*args, 32, 5, False)
    ref = tilewin_kernel.tilewin_combine_plain(*args, 32, 5, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tilewin_kernel.KERNEL.launches == before


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
    before, before_m = k.launches, k.launches_by_m[m]
    with torch.no_grad():
        f, w = tilewin_kernel.tilewin_combine(*args, 32, S, clamp)
        torch.cuda.synchronize()
        f_ref, w_ref = tilewin_kernel.tilewin_combine_plain(*args, 32, S,
                                                            clamp)
    assert k.launches == before + 1 and k.launches_by_m[m] == before_m + 1
    torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f, f_ref, rtol=1e-4, atol=1e-5)


def test_tilewin_launch_counts_go_up_and_reset_together():
    k = tilewin_kernel._TilewinKernel()
    assert k.fn is None                  # counting builds nothing
    k.count(16)
    k.count(4)
    k.count(16)
    assert k.launches == 3 and k.launches_by_m == {4: 1, 16: 2}
    k.reset_counts()
    assert k.launches == 0 and k.launches_by_m == {4: 0, 16: 0}


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
def test_tilewin_kernel_refuses_a_gradient(cuda_device):
    args = list(_tilewin_args(16, 3, 5, device=cuda_device))
    args[4] = args[4].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        tilewin_kernel.tilewin_combine(*args, 32, 5, False)


@pytest.mark.cuda
def test_tilewin_kernel_rejects_other_widths_and_member_counts(cuda_device):
    with pytest.raises(ValueError, match="m in"):
        tilewin_kernel.tilewin_combine(
            *_tilewin_args(9, 3, 5, device=cuda_device), 32, 5, False)
    args = _tilewin_args(16, 3, 5, device=cuda_device)
    with pytest.raises(ValueError, match="feat_dim"):
        tilewin_kernel.tilewin_combine(*args, 16, 5, False)
