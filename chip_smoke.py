"""Smoke run of the PyTorch/CUDA port (``enarf_gan_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. Prints the card (``nvidia-smi``) and the versions, and builds the
   hand-written kernels from ``enarf_gan_tpu_torch/csrc`` (one nvcc per
   source, all started together), with each kernel's ptxas report.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (unirow: one full fine chunk; tilewin: one full
   fine chunk, m = 16, and one full coarse-corner chunk, m = 4), times both
   with CUDA events in turns, and computes each kernel's bound from this
   run's inputs: the distinct table bytes the function needs (64-byte
   texels or row segments and 32-byte mask sectors that valid members
   touch), each coordinate and output once.
3. Builds the DSO model at the full width the JAX ``bench.py`` times
   (24 joints, 256² tri-planes, w_dim 512, deformation field, bf16
   sampling) with seeded, perturbed random weights, and renders 128² frames
   (Nc 48 + Nf 64, 4096-ray chunks) through the port's entry point
   ``make_dso_full_renderer``: first the exact path (the unirow kernel),
   then the same weights with ``tile_patch=4`` and coarse corners (the
   patch-tiled path and the tilewin kernel; ``bench.py``'s tilewin4). Each
   path must launch its own kernel and not the other's; outputs must be
   finite with a non-empty mask.
4. Renders each path's frame again with the plain combine in the kernel's
   place and bounds the difference; prints the tiled frame's PSNR and mask
   difference against the exact frame.
5. Shows where a frame's time goes: the per-frame plane stages on the host
   clock, one frame's device time by kernel class (torch.profiler), and the
   tiled frame's distinct texels and bytes bound per launch.

The second-to-last line is a JSON record of the kernels, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line; so does a machine without a CUDA device.
"""
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

SEED = 0
TRI_PLANE_SIZE = 256
W_DIM = 512
RENDER_SIZE = 128
RAY_CHUNK = 4096
NC, NF = 48, 64
TILE_PATCH = 4
FINE_CHUNK_POINTS = RAY_CHUNK * NF       # one full fine chunk
N_FRAMES = 3
HBM_BYTES_PER_S = 3.35e12                # H100 SXM HBM3
F32_FLOPS = 67e12                        # H100 SXM float32, no tensor cores
RTOL, ATOL = 1e-4, 1e-5   # kernel vs plain: both f32 from the same bf16 rows;
                          # only the order of the sums and the exp differ


def _cuda_time_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes, flops):
    """The least time the card could take: the larger of bytes over the HBM
    rate and float32 operations over the float32 peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def _unirow_table_bytes(table, rows, cand_idx, valid):
    """Bytes of the unirow table one launch must read: the 4F feature lanes
    of each distinct row a valid candidate reads (the feature is weighted
    by valid), and each distinct 32-byte sector holding a candidate's mask
    logit (every candidate's cand_w needs it). Returns (bytes, distinct
    feature rows, distinct mask sectors)."""
    import torch
    from enarf_gan_tpu_torch.ops.unirow import MASK_BLOCK
    B, R, RW = table.shape
    F_ = (RW - 4 * MASK_BLOCK) // 4
    grow = rows.long() + (torch.arange(B, device=rows.device)
                          * R).view(B, 1, 1, 1)               # (B, 3, M, n)
    keep = (valid != 0)[:, None].expand_as(grow)
    d_rows = int(torch.unique(grow[keep]).numel())
    lanes_per_sector = 32 // table.element_size()
    sectors = torch.stack([
        grow * (RW // lanes_per_sector)
        + ((4 * F_ + q * MASK_BLOCK + cand_idx.long()[:, None])
           // lanes_per_sector) for q in range(4)])
    d_sec = int(torch.unique(sectors).numel())
    return d_rows * 4 * F_ * table.element_size() + d_sec * 32, d_rows, d_sec


def _tilewin_table_bytes(feat_dim, frows, mrows, xt, xs, valid):
    """Bytes of the window tables one tilewin launch must read: each
    distinct 64-byte feature texel (F bf16 channels) and each distinct
    32-byte mask sector in the 2x2 quad of a valid member (an invalid
    member's feature is weighted by 0 and its logit is 0). Returns (bytes,
    distinct texels, distinct mask sectors)."""
    import torch
    from enarf_gan_tpu_torch.ops.tilewin_kernel import NTEX, WIN, texel_cells
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


def _compare_and_time(kern, plain, label):
    """Kernel vs plain on the same inputs (CUDA events, in turns: plain,
    kernel, kernel, plain). Returns (max abs error, kernel ms, plain ms)."""
    import torch
    with torch.no_grad():
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        errs = []
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
            errs.append(float((a - b).abs().max()))
        times = [_cuda_time_ms(plain, 5), _cuda_time_ms(kern, 20),
                 _cuda_time_ms(kern, 20), _cuda_time_ms(plain, 5)]
    plain_ms = (times[0] + times[3]) / 2
    kern_ms = (times[1] + times[2]) / 2
    print(f"{label} vs plain (rtol {RTOL}, atol {ATOL}): max|d| "
          + " / ".join(f"{e:.3e}" for e in errs))
    print("  times (plain, kernel, kernel, plain) ms: "
          + ", ".join(f"{x:.4f}" for x in times))
    return max(errs), kern_ms, plain_ms


def phase_setup():
    import torch
    from enarf_gan_tpu_torch.ops import tilewin_kernel, unirow
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    # full float32 in matmuls and convolutions (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False")
    kernels = {"unirow_combine": unirow.KERNEL,
               "tilewin_combine": tilewin_kernel.KERNEL}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for f in [pool.submit(k.load) for k in kernels.values()]:
            f.result()
    print(f"built {', '.join(kernels)} in {time.perf_counter() - t0:.2f} s "
          f"(in parallel)")
    for name, k in kernels.items():
        for line in k.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"  ptxas {name}:", line.strip())
    print("  tilewin_combine dynamic shared memory (Mp=4): m=16 "
          f"{tilewin_kernel.KERNEL.smem_bytes(4, 16)} B, m=4 "
          f"{tilewin_kernel.KERNEL.smem_bytes(4, 4)} B")


def phase_unirow_check(device):
    """Kernel 1 vs plain at one full fine chunk of the exact path."""
    import torch
    from enarf_gan_tpu_torch.ops import unirow
    F_, K, M, H = 32, 23, 4, 256
    n = FINE_CHUNK_POINTS
    g = torch.Generator().manual_seed(SEED)
    planes = torch.randn((1, (F_ + K) * 3, H, H), generator=g).to(device)
    pos = (torch.rand((1, n, M, 3), generator=g) * 2.4 - 1.2).to(device)
    idx = torch.randint(0, K, (1, n, M), generator=g, dtype=torch.int32).to(device)
    valid = (torch.rand((1, n, M), generator=g) > 0.3).to(device)
    table = unirow.pack_unirow(planes, F_, K)
    args = (table,) + unirow.candidate_rows(pos, idx, valid, H, H)
    err, kern_ms, plain_ms = _compare_and_time(
        lambda: unirow.unirow_combine(*args, F_, False),
        lambda: unirow.gather_combine_plain(*args, F_, False),
        f"unirow_combine at n={n} M={M} table {tuple(table.shape)} bf16")
    table_bytes, d_rows, d_sec = _unirow_table_bytes(table, args[1], args[3],
                                                     args[4])
    nbytes = table_bytes + sum(
        a.numel() * a.element_size() for a in args[1:]) + (F_ + M) * n * 4
    flops = n * M * 3 * (4 * F_ * 2 + 4 * 2) + n * M * F_ * 2
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"  kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{args[1].numel()} row reads on {d_rows} distinct feature rows "
          f"(valid candidates) and {d_sec} distinct mask sectors: table "
          f"{table_bytes / 1e6:.1f} MB; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_tilewin_check(device, m, S, label):
    """Kernel 2 vs plain at one full chunk of the tiled path: 256² planes,
    4096 rays in 256 patches, S samples, 4 slots; members clustered within
    ~1.5 texels per (patch, sample, slot), ~20% invalid."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel
    F_, K, Mp, H = 32, 23, 4, TRI_PLANE_SIZE
    n_patch = RAY_CHUNK // (TILE_PATCH * TILE_PATCH)
    g = torch.Generator().manual_seed(SEED + m)
    planes = torch.randn((1, (F_ + K) * 3, H, H), generator=g).to(device)
    tables = tilewin.pack_tilewin(planes, F_, K)
    centers = torch.rand((1, 3, Mp, n_patch, 1, S), generator=g) * 1.7 - 0.85
    jitter = (torch.rand((1, 3, Mp, n_patch, m, S), generator=g) * 2 - 1) \
        * (1.5 / H)
    pos = (centers + jitter).clamp(-0.99, 0.99).to(device)
    slot_idx = torch.randint(0, K, (1, Mp, n_patch, S), generator=g,
                             dtype=torch.int32).to(device)
    valid = (torch.rand((1, Mp, n_patch, m, S), generator=g) < 0.8).to(device)
    plan = tilewin._fused_plan(tables, pos, slot_idx, valid)
    args = (tables.feat, tables.mask, plan.frows, plan.mrows, plan.xt,
            plan.xs, plan.valid, F_, S, False)
    err, kern_ms, plain_ms = _compare_and_time(
        lambda: tilewin_kernel.tilewin_combine(*args),
        lambda: tilewin_kernel.tilewin_combine_plain(*args),
        f"tilewin_combine {label} at U={n_patch * S} m={m} Mp={Mp}")
    U = n_patch * S
    table_bytes, d_tex, d_sec = _tilewin_table_bytes(F_, *args[2:7])
    coords = sum(t.numel() * t.element_size() for t in args[2:7])
    outputs = (F_ * U * m + Mp * U * m) * 4
    nbytes = table_bytes + coords + outputs
    n_valid = int((plan.valid != 0).sum())
    flops = 3 * n_valid * (4 * F_ * 2 + 4 * 2) + n_valid * F_ * 2
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"  kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{plan.frows.numel()} window-row reads on "
          f"{int(torch.unique(plan.frows).numel())} distinct feature rows; "
          f"valid members {n_valid} of {plan.valid.numel()} touch {d_tex} "
          f"distinct texels and {d_sec} distinct mask sectors: table "
          f"{table_bytes / 1e6:.1f} MB, coordinates {coords / 1e6:.1f} MB, "
          f"outputs {outputs / 1e6:.1f} MB; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def build_models(device):
    """The exact-path model, and the same weights with tile_patch=4 and
    coarse corners (bench.py's tilewin4)."""
    import dataclasses
    import torch
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu_torch.models.generator import (DSONARFGenerator,
                                                      register_canonical_pose)
    from enarf_gan_tpu_torch.models.narf import NARFParams
    params = NARFParams(Nc=NC, Nf=NF, hidden_size=256,
                        tri_plane_size=TRI_PLANE_SIZE,
                        render_bs=RAY_CHUNK, coordinate_scale=3.0,
                        view_dependent=False, origin_location="center_fixed",
                        deformation_field=True, time_conditional=True,
                        pose_conditional=False, plane_sample_dtype="bfloat16",
                        max_bones_per_point=4, feat_dim=32, w_dim=W_DIM,
                        tile_patch=0)
    g = torch.Generator().manual_seed(SEED)
    gen = DSONARFGenerator(params, num_bone=24, parent_id=SMPL_PARENTS,
                           device=device, generator=g)
    # fresh DSO models render an all-zero mask: perturb every parameter
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(device))
    pose_cam, _, bl, inv_K, canonical, _ = tiny_scene(1, RENDER_SIZE,
                                                      focal_scale=1.2)
    register_canonical_pose(gen, canonical, "center_fixed", SMPL_PARENTS)
    tiled = DSONARFGenerator(
        dataclasses.replace(params, tile_patch=TILE_PATCH,
                            tile_coarse_corners=True),
        num_bone=24, parent_id=SMPL_PARENTS, device=device)
    tiled.load_state_dict(gen.state_dict())
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"model: {n_params} parameters, flow StyleGAN2 {TRI_PLANE_SIZE}² "
          f"w_dim {W_DIM}, tri-plane {tuple(gen.nerf.tri_plane.shape)}; "
          f"tiled copy: tile_patch {TILE_PATCH}, coarse corners")
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)  # noqa
    return gen, tiled, (to(pose_cam), to(inv_K), to(bl))


def _reset_counts():
    from enarf_gan_tpu_torch.ops import tilewin_kernel, unirow
    unirow.KERNEL.reset_counts()
    tilewin_kernel.KERNEL.reset_counts()


def phase_render(gen, scene, device, label, own, other):
    """N frames through make_dso_full_renderer; ``own`` must launch, the
    ``other`` kernel must not."""
    import torch
    from enarf_gan_tpu_torch.models.generator import make_dso_full_renderer
    pose_cam, inv_K, bl = scene
    render = make_dso_full_renderer(gen, RENDER_SIZE, ray_batchsize=RAY_CHUNK)

    def frame(ft, seed):
        rng = torch.Generator(device=device).manual_seed(seed)
        ft_t = torch.tensor([float(ft)], dtype=torch.float32, device=device)
        return render(pose_cam, inv_K, ft_t, bl, generator=rng)

    frame(0.5, 1)                        # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    outs = [frame(ft, 1) for ft in np.linspace(0.25, 0.75, N_FRAMES)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / N_FRAMES * 1e3
    launches, others = own.launches, other.launches
    peak = torch.cuda.max_memory_allocated()
    for color, mask, disp in outs:
        assert color.shape == (3, RENDER_SIZE, RENDER_SIZE), color.shape
        assert mask.shape == disp.shape == (RENDER_SIZE, RENDER_SIZE)
        for x in (color, mask, disp):
            assert bool(torch.isfinite(x).all()), "non-finite render"
        assert float(mask.sum()) > 0, "empty foreground mask"
    assert launches > 0, f"the {label} frames did not launch their kernel"
    assert others == 0, f"the {label} frames launched the other kernel"
    fg = float((outs[1][1] > 0.05).float().mean())
    print(f"{label}: rendered {N_FRAMES} frames {RENDER_SIZE}²: {ms:.2f} "
          f"ms/frame, peak {peak / 2**30:.3f} GiB allocated, kernel launches "
          f"{launches} ({launches / N_FRAMES:g} a frame), other kernel "
          f"{others}, foreground share {fg:.3f}")
    return frame, ms, peak


def phase_plain_render(frame, module, name, plain, kernel, label):
    """The frame at t=0.5 again, with the plain combine in the kernel's
    place; the fine sampler gets the same draws."""
    import torch
    ref = frame(0.5, 1)
    before = kernel.launches
    with mock.patch.object(module, name, plain):
        got = frame(0.5, 1)
    torch.cuda.synchronize()
    assert kernel.launches == before, "plain render launched the kernel"
    # bounds: the combines agree to ~1e-6, but the fine sampler's bin pick is
    # discontinuous, so a rare pixel may move; bound a high quantile and the
    # mean, and report the max
    for what, a, b in zip(("color", "mask", "disparity"), ref, got):
        d = (a - b).abs().flatten()
        q = float(torch.quantile(d, 0.999))
        mean = float(d.mean())
        print(f"{label} kernel vs plain render, {what}: max|d| "
              f"{float(d.max()):.3e}, q99.9 {q:.3e}, mean {mean:.3e}")
        assert q <= 1e-2 and mean <= 1e-3, (what, q, mean)
    return ref


def phase_tiled_vs_exact(tiled_frame, exact_frame):
    """Informational: the two paths change the sampling pattern, not the
    radiance field (the CPU test asserts PSNR > 24 dB, mask diff < 0.15)."""
    c_t, m_t, _ = tiled_frame
    c_e, m_e, _ = exact_frame
    mse = float(((c_t - c_e) ** 2).mean())
    psnr = 20 * np.log10(2.0) - 10 * np.log10(max(mse, 1e-12))
    print(f"tiled vs exact frame (t=0.5): PSNR {psnr:.2f} dB, mask mean "
          f"|d| {float((m_t - m_e).abs().mean()):.4f}")


def phase_tiled_rows(frame):
    """The window rows each tilewin launch of one tiled frame reads, and
    the bound they set: the data-dependent floor the kernel works against."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin
    real = tilewin.tilewin_combine
    census = []

    def counting(feat, mask, frows, mrows, xt, xs, valid, F_, S, clamp):
        B, _, Mp, U = frows.shape
        m = xt.shape[3]
        table_bytes, d_tex, d_sec = _tilewin_table_bytes(F_, frows, mrows,
                                                         xt, xs, valid)
        coords = sum(t.numel() * t.element_size()
                     for t in (frows, mrows, xt, xs, valid))
        outputs = B * (F_ + Mp) * U * m * 4
        census.append((m, U, frows.numel(),
                       int(torch.unique(frows).numel()),
                       float((valid != 0).float().mean()), d_tex, d_sec,
                       table_bytes, coords + outputs))
        return real(feat, mask, frows, mrows, xt, xs, valid, F_, S, clamp)

    with mock.patch.object(tilewin, "tilewin_combine", counting):
        frame(0.5, 1)
    torch.cuda.synchronize()
    for m, U, reads, d_f, share, d_tex, d_sec, table, rest in census:
        print(f"  tiled frame launch m={m} U={U}: {reads} window-row reads "
              f"on {d_f} distinct rows; valid share {share:.3f}; {d_tex} "
              f"distinct texels, {d_sec} distinct mask sectors: table "
              f"{table / 1e6:.2f} MB + coordinates and outputs "
              f"{rest / 1e6:.2f} MB; bytes bound "
              f"{(table + rest) / HBM_BYTES_PER_S * 1e3:.4f} ms")


def phase_profile(gen, scene, frame, ms_frame, device, label, pack):
    """Where a frame's time goes: the per-frame plane stages timed alone,
    and the device time of one whole frame by kernel (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    pose_cam, _, bl = scene
    ft = torch.tensor([0.5], device=device)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    with torch.no_grad():
        z = gen.get_latents(ft, pose_cam)
        _, bl_t = gen.transform_pose(pose_cam, bl)
        ms_planes, planes = timed(lambda: gen.compute_tri_plane_feature(z, bl_t))
        ms_pack, _ = timed(lambda: getattr(gen, pack)(planes))
    print(f"{label} profile: of a {ms_frame:.2f} ms frame, flow StyleGAN2 + "
          f"warp {ms_planes:.2f} ms and {pack} {ms_pack:.2f} ms (host clock)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame(0.5, 1)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        if e.self_device_time_total > 0:
            name = e.key.lower()
            key = ("unirow kernel" if "unirow" in name else
                   "tilewin kernel" if "tilewin" in name else
                   "convolution" if "conv" in name or "cudnn" in name
                   or "xmma" in name or "sm90" in name else
                   "gemm" if "gemm" in name or "cutlass" in name else
                   "sort" if "sort" in name or "radix" in name else
                   "index/gather" if "index" in name or "gather" in name
                   or "scatter" in name else
                   "reduce" if "reduce" in name else "elementwise/other")
            groups[key] = groups.get(key, 0.0) + e.self_device_time_total
    print(f"{label} profile: device time {device_us / 1e3:.2f} ms in a "
          f"{ms_frame:.2f} ms frame (busy share {device_us / 1e3 / ms_frame:.3f})")
    for key, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {key}: {us / 1e3:.2f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs the port on "
                 "an NVIDIA GPU")
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel, unirow
    device = torch.device("cuda", 0)
    phase_setup()
    k1 = phase_unirow_check(device)
    k2 = {m: phase_tilewin_check(device, m, S, label)
          for m, S, label in ((16, NF, "fine"), (4, NC, "coarse-corner"))}
    gen, tiled, scene = build_models(device)

    exact_frame, ms_exact, _ = phase_render(gen, scene, device, "exact",
                                            unirow.KERNEL,
                                            tilewin_kernel.KERNEL)
    k1["launches"] = unirow.KERNEL.launches
    tiled_frame, ms_tiled, _ = phase_render(tiled, scene, device, "tiled",
                                            tilewin_kernel.KERNEL,
                                            unirow.KERNEL)
    launches_by_m = dict(tilewin_kernel.KERNEL.launches_by_m)
    print(f"tiled: tilewin launches by member count {launches_by_m}")

    ref_e = phase_plain_render(exact_frame, unirow, "unirow_combine",
                               unirow.gather_combine_plain, unirow.KERNEL,
                               "exact")
    ref_t = phase_plain_render(tiled_frame, tilewin, "tilewin_combine",
                               tilewin_kernel.tilewin_combine_plain,
                               tilewin_kernel.KERNEL, "tiled")
    phase_tiled_vs_exact(ref_t, ref_e)
    phase_profile(gen, scene, exact_frame, ms_exact, device, "exact",
                  "pack_planes")
    phase_profile(tiled, scene, tiled_frame, ms_tiled, device, "tiled",
                  "pack_planes_tiled")
    phase_tiled_rows(tiled_frame)

    entries = [{"name": "unirow_combine", "route": "cuda",
                "source": "enarf_gan_tpu_torch/csrc/unirow_combine.cu",
                "replaces": "enarf_gan_tpu/ops/unirow.py:115", **k1,
                "library_ms": None}]
    for m, shape in ((16, "fine chunk, m=16"), (4, "coarse-corner chunk, m=4")):
        entries.append({
            "name": f"tilewin_combine ({shape})", "route": "cuda",
            "source": "enarf_gan_tpu_torch/csrc/tilewin_combine.cu",
            "replaces": "enarf_gan_tpu/ops/tilewin_kernel.py:166",
            "launches": launches_by_m[m], **k2[m], "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
