"""Smoke run of the PyTorch/CUDA port (``enarf_gan_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. Prints the card (``nvidia-smi``) and the versions, and builds the
   hand-written kernels from ``enarf_gan_tpu_torch/csrc`` (one nvcc per
   source, all started together), with each kernel's ptxas report.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (unirow: one full fine chunk; tilewin: one full
   fine chunk, m = 16, and one full coarse-corner chunk, m = 4; kernel 3 in
   each mode at the fine chunk, on window rows built from the texel table
   and held to ``pack_tilewin``'s; the backward kernels 1b and 2b at one
   training fine pass of 4 images, against autograd through the plain
   versions), times both with CUDA events in turns, and computes each
   kernel's bound from this run's inputs: the distinct table bytes the
   function needs (64-byte feature halves of texels and 32-byte mask
   sectors that valid members touch; all of them read the texel table, and
   the TPU layouts' bounds, quad rows for unirow and window rows for
   tilewin, are printed beside; kernel 3 computes kernel 2's function and is
   held to its bound, with the whole 4 KB rows it reads printed beside),
   each coordinate and output once (the backward kernels' dense float32
   texel gradients counted as written). Kernel 1b's stage build (scalar
   feature adds, no feature adds, no mask adds) is held to its twins and
   timed beside it.
   Then the probes of ``enarf_gan_tpu_torch/tools`` (the TPU probe kernels
   of ``tools/`` as Hopper microbenchmarks: row and lane gathers, tensor-core
   gathers and products, stage ablations of kernels 2 and 3, one-construct
   kernels and launch cost): each kernel and variant against its plain twin
   at a small size, then at its probe's main size once more and timed with
   its plain twin, the one PyTorch call of the same function where there is
   one, and its bound; one line a probe, and the launch cost of each
   argument roster (host and device microseconds a launch).
3. Builds the DSO model at the full width the JAX ``bench.py`` times
   (24 joints, 256² tri-planes, w_dim 512, deformation field, bf16
   sampling) with seeded, perturbed random weights, and renders 128² frames
   (Nc 48 + Nf 64, 4096-ray chunks) through the port's entry point
   ``make_dso_full_renderer``: first the exact path (the unirow kernel),
   then the same weights with ``tile_patch=4`` and coarse corners (the
   patch-tiled path and the tilewin kernel, on the same texel table;
   ``bench.py``'s tilewin4). Each
   path must launch its own kernel and not the other's; outputs must be
   finite with a non-empty mask.
4. Renders each path's frame again with the plain combine in the kernel's
   place and bounds the difference; prints the tiled frame's PSNR and mask
   difference against the exact frame.
5. Shows where a frame's time goes: the per-frame plane stages on the host
   clock, one frame's device time by kernel class and its launches
   (torch.profiler), the host cost of those launches at the probes' cost a
   launch beside the frame's idle time, and the tiled frame's distinct
   texels and bytes bound per launch (the window tables' beside).
6. Trains the model of ``configs/DSO_train/ZJU/313_denarf_tpu.yml`` (512²
   images, batch 16, 4096 rays an image, 256² planes, w_dim 512, pose and
   time conditioning, Nc 48 + Nf 64, "mae" loss, lr 1e-3) through the
   port's ``training.dso`` on synthetic 512² frames: the exact path
   (kernels 1 and 1b) and the tiled path (2 and 2b), each 1 warm-up and 3
   timed steps at the smallest micro-batch split that fits, with s/iter,
   peak memory and a profile of one step (each port kernel's device ms and
   launches a step; kernel 1b's time a valid candidate and 2b's a valid
   member in the step against their times at phase 2's positions, which
   shows whether their atomics contend); then one tiled step in each of
   kernel 3's modes on the hat step's batch and draws, whose loss must
   match.
7. Overfits one 64² frame for 200 iterations on both paths at full width:
   the PSNR must beat the blank frame's by more than 2 dB.

The second-to-last line is a JSON record of the kernels, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line; so does a machine without a CUDA device.

    python3 chip_smoke.py --learn-spread | --learn-collapse | --learn-gradcheck

run only phase 1 and one study of phase 7's spread from run to run (3-8
minutes each on an H100): each path learning twice from each of three seeds
(PSNR through its own and the exact renderer, the loss trajectories'
divergence); repeated runs from one seed with the kernels and with the plain
combine; and the parameter gradients along learning, kernels against the
plain combine.

    python3 chip_smoke.py --probes

runs phase 1 and every probe module's full sweep (row widths x table sizes
x index order, lane gathers by table height, ring depths, every one-hot
shape with its direct gather), one JSON line a measurement.
"""
import json
import re
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
N_FRAMES = 2
HBM_BYTES_PER_S = 3.35e12                # H100 SXM HBM3
F32_FLOPS = 67e12                        # H100 SXM float32, no tensor cores
BF16_FLOPS = 989e12                      # H100 SXM bf16 tensor cores, dense
RTOL, ATOL = 1e-4, 1e-5   # kernel vs plain: both f32 from the same bf16 rows;
                          # only the order of the sums and the exp differ
GRAD_REL_L2 = 1e-4        # backward kernel vs autograd through the plain
                          # version: the atomics add in a varying order
TRAIN_IMAGES = 4          # images of a training fine pass in the 1b/2b checks
MODES = ("dot", "vpu", "bdiag")
# configs/DSO_train/ZJU/313_denarf_tpu.yml over configs/DSO_train/default.yml
# (written out, so that the script needs no YAML reader); the model widths not
# in the files are NARFParams' defaults (256² planes, feat 32, w_dim 512)
TRAIN_CONFIG = {
    "out": "DSO/ZJU/313_denarf_tpu",
    "dataset": {"bs": 16, "image_size": 512, "bg_color": -1,
                "train": {"n_frames": 1176}},
    "generator_params": {
        "use_triplane": True, "ray_batchsize": 4096,
        "nerf_params": {
            "plane_sample_dtype": "bfloat16", "tile_patch": 4,
            "tile_coarse_corners": True, "hidden_size": 256, "Nc": 48,
            "Nf": 64, "no_ray_direction": True,
            "origin_location": "center_fixed", "coordinate_scale": 3,
            "deformation_field": True, "time_conditional": True,
            "pose_conditional": True, "render_bs": 16384,
            "model_type": "narf",
            "multiply_density_with_triplane_wieght": False,
            "clamp_mask": False, "constant_triplane": False,
            "constant_trimask": False, "selector_mlp": False,
            "no_selector": False, "constant_trimask_lr_mul": 1}},
    "loss": {"color_coef": 1, "mask_coef": 1, "nerf_loss_type": "mae"},
    "num_iter": 150000, "lr": 0.001, "scheduler_gamma": 0.99995,
    "val_interval": 500, "print_interval": 10, "tensorboard_interval": 100,
    "save_interval": 500, "resume": None, "resume_latest": False}
TRAIN_SOURCE_IMAGES = 4   # distinct synthetic 512² frames, repeated to 16
TIMED_STEPS = 3
LEARN_SIZE, LEARN_ITERS = 64, 200


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


def _bound(nbytes, flops, rate=F32_FLOPS):
    """The least time the card could take: the larger of bytes over the HBM
    rate and the operations over the peak ``rate`` of their type (float32
    unless given)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def _unirow_table_bytes(rows, cand_idx, valid, feat_dim, H, W):
    """The quad-row yardstick (the TPU layout, ``pack_unirow``): bytes of
    the quad-row table one launch would read, the 4F feature lanes of each
    distinct row a valid candidate reads (the feature is weighted by valid)
    and each distinct 32-byte sector holding a candidate's mask logit
    (every candidate's cand_w needs it). Returns (bytes, distinct feature
    rows, distinct mask sectors)."""
    import torch
    from enarf_gan_tpu_torch.ops.unirow import MASK_BLOCK, row_width
    B = rows.shape[0]
    R, RW, F_ = 3 * (H + 1) * (W + 1), row_width(feat_dim), feat_dim
    grow = rows.long() + (torch.arange(B, device=rows.device)
                          * R).view(B, 1, 1, 1)               # (B, 3, M, n)
    keep = (valid != 0)[:, None].expand_as(grow)
    d_rows = int(torch.unique(grow[keep]).numel())
    lanes_per_sector = 32 // 2                                # bf16
    sectors = torch.stack([
        grow * (RW // lanes_per_sector)
        + ((4 * F_ + q * MASK_BLOCK + cand_idx.long()[:, None])
           // lanes_per_sector) for q in range(4)])
    d_sec = int(torch.unique(sectors).numel())
    return d_rows * 4 * F_ * 2 + d_sec * 32, d_rows, d_sec


def _tilewin_table_bytes(args):
    """The distinct texels and mask sectors of the texel table that one
    tilewin launch on ``args`` (texels, bases, bones, xt, xs, valid, F, ...)
    must read (``tools/ablate.py::tilewin_texel_bytes``): (bytes, texels,
    sectors)."""
    from enarf_gan_tpu_torch.tools.ablate import tilewin_texel_bytes
    return tilewin_texel_bytes(*args[:6], args[6])


def _window_table_bytes(args, n_bones=32):
    """The window-table yardstick (the TPU layout, ``pack_tilewin``): the
    distinct window-row texels and mask sectors the same launch would read
    there (``tools/ablate.py::table_bytes``), the rows named from the
    plan's base texels and bones (the count of bones only numbers the mask
    rows). Returns (bytes, texels, sectors, distinct feature rows)."""
    import torch
    from enarf_gan_tpu_torch.ops.tilewin_kernel import num_bases, window_rows
    from enarf_gan_tpu_torch.tools.ablate import table_bytes
    texels, bases, bones, xt, xs, valid, F_ = args[:7]
    Hp, Wp = texels.shape[2:4]
    frows, mrows = window_rows(bases, bones, Hp, Wp, num_bases(Hp - 2),
                               n_bones)
    nbytes, d_tex, d_sec = table_bytes(F_, frows, mrows, xt, xs, valid)
    return nbytes, d_tex, d_sec, int(torch.unique(frows).numel())


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
    from enarf_gan_tpu_torch.tools import ablate
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
               "unirow_combine_bwd": unirow.KERNEL_BWD,
               "tilewin_combine": tilewin_kernel.KERNEL,
               "tilewin_combine_bwd": tilewin_kernel.KERNEL_BWD,
               "tilewin_combine_modes": tilewin_kernel.KERNEL_MODES,
               **{k.name: k for k in _probe_kernels()}}
    assert ablate.KERNEL_STAGES in kernels.values()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for f in [pool.submit(k.load) for k in kernels.values()]:
            f.result()
    print(f"built {', '.join(kernels)} in {time.perf_counter() - t0:.2f} s "
          f"(in parallel); nvcc seconds: "
          + ", ".join(f"{n} {k.build_seconds:.2f}" for n, k in kernels.items()))
    for name, k in kernels.items():
        for line in k.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"  ptxas {name}:", line.strip())
    tw = tilewin_kernel
    smem = {"tilewin_combine m=16": tw.KERNEL.lib.tilewin_combine_smem_bytes(
                4, 16),
            "m=4": tw.KERNEL.lib.tilewin_combine_smem_bytes(4, 4),
            "tilewin_combine_bwd":
                tw.KERNEL_BWD.lib.tilewin_combine_bwd_smem_bytes(4),
            "tilewin_combine_modes":
                tw.KERNEL_MODES.lib.tilewin_combine_modes_smem_bytes(4)}
    print("  dynamic shared memory a block (Mp=4): "
          + "; ".join(f"{k} {v} B" for k, v in smem.items()))


def phase_unirow_check(device):
    """Kernel 1 vs its plain twin at one full fine chunk of the exact
    path. The bound counts the texel table's bytes the function needs;
    the quad-row table's (the TPU layout) is printed beside it."""
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.tools.ablate import (texel_table_bytes,
                                                  unirow_inputs)
    F_, M, H = 32, 4, 256
    n = FINE_CHUNK_POINTS
    args = unirow_inputs(device, 1, n, H, M, seed=SEED)[:5]
    texels = args[0]
    err, kern_ms, plain_ms = _compare_and_time(
        lambda: unirow.unirow_combine(*args, F_, False),
        lambda: unirow.gather_combine_texels_plain(*args, F_, False),
        f"unirow_combine at n={n} M={M} texels {tuple(texels.shape)} bf16")
    inputs = sum(a.numel() * a.element_size() for a in args[1:])
    outputs = (F_ + M) * n * 4
    flops = n * M * 3 * (4 * F_ * 2 + 4 * 2) + n * M * F_ * 2
    table_bytes, d_tex, d_sec = texel_table_bytes(texels, args[1], args[3],
                                                  args[4], F_)
    bound_ms, bound_by = _bound(table_bytes + inputs + outputs, flops)
    quad_bytes, d_rows, d_qsec = _unirow_table_bytes(args[1], args[3],
                                                     args[4], F_, H, H)
    quad_ms, _ = _bound(quad_bytes + inputs + outputs, flops)
    print(f"  kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{args[1].numel()} (plane, candidate, point) reads on {d_tex} "
          f"distinct feature texels (valid candidates) and {d_sec} distinct "
          f"mask sectors: texel table {table_bytes / 1e6:.1f} MB, inputs "
          f"{inputs / 1e6:.1f} MB, outputs {outputs / 1e6:.1f} MB; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP); "
          f"quad-row yardstick: {d_rows} distinct rows and {d_qsec} mask "
          f"sectors, {quad_bytes / 1e6:.1f} MB, bound {quad_ms:.4f} ms")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "quad_row_bound_ms": quad_ms,
            "valid": int((args[4] != 0).sum()), "points": n}


def _tilewin_inputs(device, m, S, B=1, seed_offset=0, layout="texels"):
    """The texel table and plan of one full chunk of the tiled path
    (``tools/ablate.py::chunk_inputs``): 256² planes, 4096 rays in 256
    patches, S samples, 4 slots; members clustered within ~1.5 texels per
    (patch, sample, slot), ~20% invalid. ``layout="windows"``: the window
    tables and plan of the same draws (kernel 3's inputs)."""
    from enarf_gan_tpu_torch.tools.ablate import chunk_inputs
    return chunk_inputs(device, m, S, B=B, seed=SEED + m + seed_offset,
                        layout=layout)


def _tilewin_io_bytes(args, m):
    """The plan's arrays read, outputs written."""
    from enarf_gan_tpu_torch.tools.ablate import io_bytes
    return io_bytes(args, m)


CHUNK_BONES = 23          # bones of tools/ablate.py::chunk_inputs' planes


def _tilewin_bound(args, m):
    """The tilewin combine's bound on one launch's texel inputs: the
    distinct texels and mask sectors its valid members need, the plan's
    arrays and the outputs; the float32 operations of its valid members.
    Kernels 2 and 3 compute this one function, so both are held to it. The
    window tables' bound on the same launch is the yardstick. Returns
    (bound ms, bound by, bytes, operations, the table-bytes triple, window
    yardstick ms, the window-bytes quadruple)."""
    F_ = args[6]
    table = _tilewin_table_bytes(args)
    io = _tilewin_io_bytes(args, m)
    n_valid = int((args[5] != 0).sum())
    flops = 3 * n_valid * (4 * F_ * 2 + 4 * 2) + n_valid * F_ * 2
    window = _window_table_bytes(args)
    window_ms, _ = _bound(window[0] + io, flops)
    return _bound(table[0] + io, flops) + (table[0] + io, flops, table,
                                           window_ms, window)


def phase_tilewin_check(device, m, S, label):
    """Kernel 2 vs its texel twin at one full chunk of the tiled path."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin_kernel
    args = _tilewin_inputs(device, m, S)
    Mp = args[1].shape[2]
    err, kern_ms, plain_ms = _compare_and_time(
        lambda: tilewin_kernel.tilewin_combine(*args),
        lambda: tilewin_kernel.tilewin_combine_texels_plain(*args),
        f"tilewin_combine {label} at U={args[1].shape[3]} m={m} Mp={Mp} "
        f"texels {tuple(args[0].shape)} bf16")
    bound_ms, bound_by, nbytes, flops, (table_bytes, d_tex, d_sec), \
        window_ms, (window_bytes, w_tex, w_sec, w_rows) = \
        _tilewin_bound(args, m)
    print(f"  kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{args[1].numel()} (plane, slot, unit) windows on "
          f"{int(torch.unique(args[1]).numel())} distinct base texels; "
          f"valid members {int((args[5] != 0).sum())} of {args[5].numel()} "
          f"touch {d_tex} distinct texels and {d_sec} distinct mask sectors: "
          f"texel table {table_bytes / 1e6:.2f} MB, plan and outputs "
          f"{(nbytes - table_bytes) / 1e6:.2f} MB; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP); "
          f"window-table yardstick: {w_rows} distinct rows, {w_tex} texels "
          f"and {w_sec} mask sectors, {window_bytes / 1e6:.2f} MB, bound "
          f"{window_ms:.4f} ms")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "window_bound_ms": window_ms}


def phase_modes_check(device):
    """Kernel 3 in each mode vs its plain version at kernel 2's full fine
    chunk. It reads window rows, which the texel path builds from the texel
    table (``windows_from_texels``): first those rows are held to
    ``pack_tilewin``'s, bit for bit, and the texel path's kernel-3 result
    to the kernel on ``pack_tilewin``'s tables. Its bound is kernel 2's:
    the same function on the same inputs (the bf16 rounding of the
    t-weights changes no byte or operation the function needs). What its
    formulation does is printed beside it: whole 4 KB window rows read once
    each, and the (32 x 16) @ (16 x 128) t-contraction per (unit, slot,
    plane), on the bf16 tensor cores ("dot", "bdiag") or in float32 ("vpu",
    the parity's 16 nonzero rows). ``ms`` is the kernel's time on rows
    built beforehand; ``path_ms`` is the time of ``tilewin_combine`` in the
    mode on the texel table, which rebuilds the whole batch's window rows
    at each launch."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin_kernel as tk
    targs = _tilewin_inputs(device, 16, NF)
    wargs = _tilewin_inputs(device, 16, NF, layout="windows")
    Mp, U = wargs[2].shape[2], wargs[2].shape[3]
    texels, bases, bones = targs[:3]
    nb = tk.num_bases(texels.shape[2] - 2)
    feat_t, mask_t = tk.windows_from_texels(texels, nb)
    frows_t, mrows_t = tk.window_rows(bases, bones, texels.shape[2],
                                      texels.shape[3], nb)
    same = bool(torch.equal(feat_t[frows_t.long()], wargs[0][wargs[2].long()])
                and torch.equal(mask_t[mrows_t.long()],
                                wargs[1][wargs[3].long()]))
    print(f"kernel 3's window rows from the texel table vs pack_tilewin's "
          f"rows of the same plan: {'equal' if same else 'DIFFERENT'}")
    assert same
    del feat_t, mask_t
    bound_ms, bound_by, nbytes, flops, (table_bytes, _, _), _, \
        (_, _, d_sec, d_rows) = _tilewin_bound(targs, 16)
    form_bytes = _tilewin_io_bytes(wargs, 16) + d_rows * 4096 + d_sec * 32
    out = {}
    for mode in MODES:
        with torch.no_grad():
            via = tk.tilewin_combine(*targs, mode=mode)
            direct = tk.launch_modes(*wargs, mode=mode)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(via, direct)), mode
        err, kern_ms, plain_ms = _compare_and_time(
            lambda: tk.launch_modes(*wargs, mode=mode),
            lambda: tk.tilewin_combine_plain(*wargs, round_t=mode != "vpu"),
            f"tilewin_combine_modes {mode} at U={U} m=16 Mp={Mp}")
        with torch.no_grad():
            path_ms = _cuda_time_ms(
                lambda: tk.tilewin_combine(*targs, mode=mode), 5)
        if mode == "vpu":
            form_flops, rate = U * Mp * 3 * 2 * 16 * 8 * 128 * 2, F32_FLOPS
        else:
            form_flops, rate = U * Mp * 3 * 32 * 16 * 128 * 2, BF16_FLOPS
        form_ms, form_by = _bound(form_bytes, form_flops, rate)
        print(f"  kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP), kernel 2's on the texel table; its "
              f"formulation: {d_rows} distinct 4 KB rows and {d_sec} mask "
              f"sectors, {form_bytes / 1e6:.1f} MB, "
              f"{form_flops / 1e9:.2f} GFLOP "
              f"({'float32' if mode == 'vpu' else 'bf16 tensor cores'}), "
              f"least {form_ms:.4f} ms by {form_by}; the texel path gives "
              f"the same numbers in {path_ms:.4f} ms with its window rows "
              f"rebuilt")
        out[mode] = {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
                     "path_ms": path_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "formulation_bytes": form_bytes,
                     "formulation_ms": form_ms}
    return out


def _grad_check(label, kern, plain, names):
    """A backward kernel vs autograd through the plain version: relative L2
    per gradient, then times (plain, kernel, kernel, plain)."""
    import torch
    got = kern()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(names, got, ref):
        errs[name] = float((a.float() - b.float()).norm()
                           / b.float().norm().clamp_min(1e-30))
    del got, ref
    print(f"{label} vs autograd through the plain version: relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {GRAD_REL_L2})")
    assert max(errs.values()) <= GRAD_REL_L2, errs
    times = [_cuda_time_ms(plain, 1), _cuda_time_ms(kern, 5),
             _cuda_time_ms(kern, 5), _cuda_time_ms(plain, 1)]
    print("  times (plain, kernel, kernel, plain) ms: "
          + ", ".join(f"{x:.4f}" for x in times))
    return max(errs.values()), (times[1] + times[2]) / 2, \
        (times[0] + times[3]) / 2


def phase_unirow_bwd_check(device):
    """Kernel 1b at one training fine pass: 4 images x 4096 rays x Nf 64,
    4 candidates, against autograd through the plain twin (image by image:
    images share no texels). The kernel's time includes zeroing the dense
    float32 texel gradient, which the bound counts as written. Then its
    stage ablations (``tools/ablate.py``: scalar feature adds, no feature
    adds, no mask adds), each held to its doctored twin and timed in turns
    with the full kernel."""
    import torch
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.tools import ablate
    F_, H, B, n = 32, 256, TRAIN_IMAGES, FINE_CHUNK_POINTS
    args = ablate.unirow_inputs(device, B, n, H, seed=SEED + 5)
    texels, rows, wq4, ci, cv, dfeature, dcand_w = args
    M = rows.shape[2]

    def kern():
        return unirow.launch_backward(*args, F_, False)

    err, kern_ms, plain_ms = _grad_check(
        f"unirow_combine_bwd at B={B} n={n} M={M}", kern,
        lambda: ablate.unirow_bwd_plain(*args), ("texels", "wq4"))
    table_bytes, d_tex, d_sec = ablate.texel_table_bytes(texels, rows, ci, cv,
                                                         F_)
    inputs = sum(t.numel() * t.element_size() for t in args[1:])
    outputs = texels.numel() * 4 + wq4.numel() * 4
    flops = 3 * (n * M * 3 * (4 * F_ * 2 + 4 * 2) + n * M * F_ * 2) * B
    bound_ms, bound_by = _bound(table_bytes + inputs + outputs, flops)
    quad_bytes, _, _ = _unirow_table_bytes(rows, ci, cv, F_, H, H)
    quad_out = B * 3 * (H + 1) * (H + 1) * unirow.row_width(F_) * 4 \
        + wq4.numel() * 4
    quad_ms, _ = _bound(quad_bytes + inputs + quad_out, flops)
    print(f"  kernel {kern_ms:.4f} ms (with the zeroed float32 texel "
          f"gradient), plain {plain_ms:.4f} ms; texel reads "
          f"{table_bytes / 1e6:.1f} MB ({d_tex} texels, {d_sec} mask "
          f"sectors), other inputs {inputs / 1e6:.1f} MB, outputs "
          f"{outputs / 1e6:.1f} MB; bound {bound_ms:.4f} ms by {bound_by}; "
          f"quad-row yardstick: table reads {quad_bytes / 1e6:.1f} MB, "
          f"outputs {quad_out / 1e6:.1f} MB, bound {quad_ms:.4f} ms")
    stage_ms = {}
    for stage in ablate.UNIROW_BWD_STAGES[1:]:
        got = ablate.unirow_bwd_stage(*args, stage)
        torch.cuda.synchronize()
        ref = ablate.unirow_bwd_stage_plain(*args, stage)
        errs = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(got, ref)]
        del got, ref
        assert max(errs) <= GRAD_REL_L2, (stage, errs)
        times = [_cuda_time_ms(kern, 5),
                 _cuda_time_ms(lambda: ablate.unirow_bwd_stage(*args, stage),
                               5),
                 _cuda_time_ms(lambda: ablate.unirow_bwd_stage(*args, stage),
                               5),
                 _cuda_time_ms(kern, 5)]
        stage_ms[stage] = (times[1] + times[2]) / 2
        print(f"  stage {stage}: relative L2 to its twin "
              + ", ".join(f"{e:.2e}" for e in errs) + "; times (full, "
              f"{stage}, {stage}, full) ms: "
              + ", ".join(f"{x:.4f}" for x in times))
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "quad_row_bound_ms": quad_ms, "stage_ms": stage_ms,
            "valid": int((cv != 0).sum()), "points": B * n}


def phase_tilewin_bwd_check(device):
    """Kernel 2b at one training fine pass: 4 images x 256 patches x 64
    samples, m = 16, 4 slots, against autograd through the texel twin
    (image by image, into float32 copies of the texel table). The kernel's
    time includes zeroing the dense float32 texel gradient, which the bound
    counts as written; the window tables' bound (their dense float32
    gradients written, as the window-table kernel wrote them) is the
    yardstick."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin_kernel
    from enarf_gan_tpu_torch.tools import ablate
    B = TRAIN_IMAGES
    args = _tilewin_inputs(device, 16, NF, B=B, seed_offset=7)
    texels, bases, bones, xt, xs, valid, F_, S, clamp = args
    g = torch.Generator().manual_seed(SEED + 9)
    n = xt.shape[3] * xt.shape[4]
    Mp = bases.shape[2]
    dfeature = torch.randn((B, F_, n), generator=g).to(device)
    dcand_w = torch.randn((B, Mp, n // (16 * S), 16, S), generator=g) \
        .to(device)

    def kern():
        return tilewin_kernel.launch_backward(texels, bases, bones, xt, xs,
                                              valid, dfeature, dcand_w, F_, S,
                                              clamp)

    def plain():
        return ablate.tilewin_bwd_plain(*args[:6], dfeature, dcand_w, S)

    err, kern_ms, plain_ms = _grad_check(
        f"tilewin_combine_bwd at B={B} U={bases.shape[3]} m=16 Mp={Mp}",
        kern, plain, ("texels", "xt", "xs"))
    table_bytes, d_tex, d_sec = _tilewin_table_bytes(args)
    io = _tilewin_io_bytes(args, 16) - B * (F_ + Mp) * n * 4
    inputs = io + (dfeature.numel() + dcand_w.numel()) * 4
    outputs = (texels.numel() + xt.numel() + xs.numel()) * 4
    n_valid = int((valid != 0).sum())
    flops = 3 * (3 * n_valid * (4 * F_ * 2 + 4 * 2) + n_valid * F_ * 2)
    bound_ms, bound_by = _bound(table_bytes + inputs + outputs, flops)
    nb = tilewin_kernel.num_bases(texels.shape[2] - 2)
    window_table, _, _, _ = _window_table_bytes(args)
    window_out = B * 3 * nb * nb * (64 * F_ + CHUNK_BONES * 64) * 4 \
        + (xt.numel() + xs.numel()) * 4
    window_ms, _ = _bound(window_table + inputs + window_out, flops)
    print(f"  kernel {kern_ms:.4f} ms (with the zeroed float32 texel "
          f"gradient), plain {plain_ms:.4f} ms; texel reads "
          f"{table_bytes / 1e6:.1f} MB ({d_tex} texels, {d_sec} mask "
          f"sectors), other inputs {inputs / 1e6:.1f} MB, outputs "
          f"{outputs / 1e6:.1f} MB; bound {bound_ms:.4f} ms by {bound_by}; "
          f"window-table yardstick: table reads {window_table / 1e6:.1f} MB, "
          f"outputs {window_out / 1e6:.1f} MB, bound {window_ms:.4f} ms")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "window_bound_ms": window_ms,
            "valid": n_valid, "points": B * 16 * bases.shape[3]}


PROBE_MODULES = ("gather", "mma", "ablate", "constructs")
PROBE_BUDGET_MS = 20.0     # CUDA-event time a probe's kernel, plain, library


def _probe_modules():
    import importlib
    return [importlib.import_module(f"enarf_gan_tpu_torch.tools.{m}")
            for m in PROBE_MODULES]


def _probe_kernels():
    """The probes' libraries: the three probe sources and the stage builds
    of kernels 2, 3 and 1b."""
    from enarf_gan_tpu_torch.tools import ablate, constructs, gather, mma
    return (gather.KERNEL, mma.KERNEL, constructs.KERNEL, ablate.KERNEL_STAGES,
            ablate.KERNEL_MODES_STAGES, ablate.KERNEL_UNIROW_BWD_STAGES)


def phase_probes(device):
    """The probe kernels of ``enarf_gan_tpu_torch/tools`` (families A-D):
    every kernel and variant held to its plain twin at a small size
    (ragged shapes), then at its probe's own main size held once more and
    timed (kernel, plain, library call) against its bound; the launch cost
    of each argument roster. Each entry's ``launches`` are the kernel's
    launches while it was timed (its comparisons excluded). Kernel 2's and
    3's stage variants are timed at the probes' U = 12288 and at the fine
    chunk; the entry holds the former and ``fine_chunk_ms`` the latter."""
    import torch
    from enarf_gan_tpu_torch.tools import constructs, timing
    t0 = time.perf_counter()
    n = 0
    for mod in _probe_modules():
        for case in mod.cases(device, "check"):
            timing.check(case)
            n += 1
    torch.cuda.synchronize()
    print(f"probes: {n} kernels and variants held to their plain twins at "
          f"small sizes in {time.perf_counter() - t0:.1f} s")
    for k in _probe_kernels():
        k.reset_counts()
    entries = {}
    for mod in _probe_modules():
        for case in mod.cases(device, "main"):
            err = timing.check(case)
            lib, key = case.counter
            before = lib.launches_by[key]
            t = timing.measure(case, PROBE_BUDGET_MS)
            launches = lib.launches_by[key] - before
            assert launches > 0, f"{case.name} did not launch its kernel"
            name = case.name.replace(", fine chunk", "") \
                .replace(", U=12288 probe inputs", "")
            line = (f"  {case.name}: max|d| {err:.2e}, kernel {t['ms']:.4f} ms,"
                    f" plain {t['plain_ms']:.4f} ms, library "
                    + (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
                       else "none")
                    + f", bound {t['bound_ms']:.4f} ms by {t['bound_by']}")
            if case.nbytes and t["ms"] > 0:
                line += f"; {case.nbytes / t['ms'] / 1e9:.3f} TB/s"
            if case.flops and t["ms"] > 0:
                line += f", {case.flops / t['ms'] / 1e9:.1f} TFLOP/s"
            print(line)
            if case.info.get("inputs") == "fine chunk":
                entries[name].update(fine_chunk_ms=t["ms"],
                                     fine_chunk_bound_ms=t["bound_ms"])
                continue
            assert name not in entries, name
            entries[name] = {
                "name": name, "route": "cuda", "source": case.source,
                "replaces": case.replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}
    for name in constructs.ROSTERS:
        host_us, device_us = constructs.launch_cost(name, device)
        entries[f"D launch roster {name}"].update(host_us=host_us,
                                                  device_us=device_us)
        print(f"  launch cost, roster {name} {constructs.ROSTERS[name]}: host "
              f"{host_us:.2f} us a call through the ctypes wrapper, device "
              f"{device_us:.2f} us a launch")
    print(f"probe phase done in {time.perf_counter() - t0:.1f} s")
    return list(entries.values())


def probe_sweeps(device):
    """``--probes``: each probe module's full sweep (its CLI), one JSON line
    a measurement."""
    for mod in _probe_modules():
        mod.main(["--device", str(device)])


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
    _reset_all_counts()
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
    """The texels each tilewin launch of one tiled frame reads, and the
    bound they set: the data-dependent floor the kernel works against; the
    window rows the TPU layout would read beside it."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin
    real = tilewin.tilewin_combine
    census = []

    def counting(*args, mode=None):
        texels, bases = args[:2]
        B, _, Mp, U = bases.shape
        m = args[3].shape[3]
        table_bytes, d_tex, d_sec = _tilewin_table_bytes(args)
        window_bytes, _, _, w_rows = _window_table_bytes(args)
        rest = _tilewin_io_bytes(args, m)
        census.append((m, U, bases.numel(), w_rows,
                       float((args[5] != 0).float().mean()), d_tex, d_sec,
                       table_bytes, rest, window_bytes))
        return real(*args, mode=mode)

    with mock.patch.object(tilewin, "tilewin_combine", counting):
        frame(0.5, 1)
    torch.cuda.synchronize()
    for m, U, reads, w_rows, share, d_tex, d_sec, table, rest, window in \
            census:
        print(f"  tiled frame launch m={m} U={U}: {reads} (plane, slot, unit) "
              f"windows; valid share {share:.3f}; {d_tex} distinct texels, "
              f"{d_sec} distinct mask sectors: texel table "
              f"{table / 1e6:.2f} MB + plan and outputs {rest / 1e6:.2f} MB; "
              f"bytes bound {(table + rest) / HBM_BYTES_PER_S * 1e3:.4f} ms; "
              f"window tables: {w_rows} distinct rows, {window / 1e6:.2f} MB, "
              f"bound {(window + rest) / HBM_BYTES_PER_S * 1e3:.4f} ms")


def phase_profile(gen, scene, frame, ms_frame, device, label, pack):
    """Where a frame's time goes: the per-frame plane stages timed alone,
    and the device time of one whole frame by kernel (torch.profiler)."""
    import torch
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
    return _profile(lambda: frame(0.5, 1), f"{label} profile", ms_frame,
                    "frame")


def _profile(fn, label, ms_host, what):
    """Device time of one call of ``fn`` by kernel class (torch.profiler),
    and its share of ``ms_host``, the call's time on the host clock.
    Returns (device ms, kernel launches, {port kernel: (device ms,
    launches)}) for the port's kernels (unirow, tilewin)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    port = {}
    for e in kernels:
        if e.self_device_time_total > 0:
            name = e.key.lower()
            key = ("unirow kernels" if "unirow" in name else
                   "tilewin kernels" if "tilewin" in name else
                   "convolution" if "conv" in name or "cudnn" in name
                   or "xmma" in name or "sm90" in name else
                   "gemm" if "gemm" in name or "cutlass" in name else
                   "sort" if "sort" in name or "radix" in name else
                   "index/gather" if "index" in name or "gather" in name
                   or "scatter" in name else
                   "reduce" if "reduce" in name else "elementwise/other")
            groups[key] = groups.get(key, 0.0) + e.self_device_time_total
            if key in ("unirow kernels", "tilewin kernels"):
                short = re.search(r"\w*(?:unirow|tilewin)\w*",
                                  e.key).group(0)
                ms, count = port.get(short, (0.0, 0))
                port[short] = (ms + e.self_device_time_total / 1e3,
                               count + e.count)
    n_launches = sum(e.count for e in kernels)
    print(f"{label}: device time {device_us / 1e3:.2f} ms in a "
          f"{ms_host:.2f} ms {what} (busy share {device_us / 1e3 / ms_host:.3f}),"
          f" {n_launches} kernel launches")
    for key, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {key}: {us / 1e3:.2f} ms")
    for short, (ms, count) in sorted(port.items()):
        print(f"  port kernel {short}: {ms:.3f} ms, {count} launches a {what}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")
    return device_us / 1e3, n_launches, port


def phase_launch_cost(probes, frames, ms_host):
    """The host cost of a launch through the port's ctypes wrappers (the
    probe phase's 7-in / 2-out roster, the tilewin kernel's) times the
    kernel launches of a 128² frame, beside the frame's idle time (host
    time less device time)."""
    roster = next(e for e in probes if e["name"] == "D launch roster 7in_2out")
    for label, (device_ms, n_launches, _) in frames.items():
        idle = ms_host[label] - device_ms
        cost = roster["host_us"] * n_launches / 1e3
        print(f"{label} frame: {n_launches} launches x {roster['host_us']:.2f} "
              f"us a launch (host) = {cost:.2f} ms, beside an idle "
              f"{idle:.2f} ms of a {ms_host[label]:.2f} ms frame "
              f"({cost / max(idle, 1e-9):.2f} of it)")


def _all_kernels():
    from enarf_gan_tpu_torch.ops import tilewin_kernel, unirow
    return (unirow.KERNEL, unirow.KERNEL_BWD, tilewin_kernel.KERNEL,
            tilewin_kernel.KERNEL_BWD, tilewin_kernel.KERNEL_MODES)


def _reset_all_counts():
    for k in _all_kernels():
        k.reset_counts()


def _train_config(**overrides):
    """TRAIN_CONFIG with nested overrides (keys as "a.b.c")."""
    import copy
    from enarf_gan_tpu_torch.config import AttrDict
    raw = copy.deepcopy(TRAIN_CONFIG)
    for key, value in overrides.items():
        node = raw
        *path, leaf = key.split(".")
        for k in path:
            node = node[k]
        node[leaf] = value
    return AttrDict(raw)


def build_training(device, root):
    """The 313_denarf_tpu model (tiled) and the same weights on the exact
    path, seeded and perturbed (a fresh model renders an all-zero mask and
    has zero feature gradients), and a batch of 16 of 4 distinct synthetic
    512² frames."""
    import torch
    from enarf_gan_tpu_torch.data.datasets import SSODataset
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.data.loader import collate
    from enarf_gan_tpu_torch.training import dso
    size = TRAIN_CONFIG["dataset"]["image_size"]
    t0 = time.perf_counter()
    make_synthetic_human_cache(root, size=size, n_frames=2, n_camera=2)
    print(f"synthetic {size}² cache of {TRAIN_SOURCE_IMAGES} frames (numpy "
          f"rasteriser): {time.perf_counter() - t0:.2f} s")
    config = _train_config(**{"dataset.train.data_root": root,
                              "dataset.train.n_frames": 2})
    ds = SSODataset(config.dataset.train, size=size, return_bone_params=True,
                    num_repeat_in_epoch=1)
    bs = config.dataset.bs
    batch = collate([ds[i % TRAIN_SOURCE_IMAGES] for i in range(bs)])
    batch = dso.prepare_batch(batch, device)
    g = torch.Generator().manual_seed(SEED + 11)
    tiled = dso.build_generator(config, ds.num_bone, ds.parents, device,
                                generator=g)
    with torch.no_grad():
        for p in tiled.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(device))
    exact_cfg = _train_config(**{"generator_params.nerf_params.tile_patch": 0})
    exact = dso.build_generator(exact_cfg, ds.num_bone, ds.parents, device)
    exact.load_state_dict(tiled.state_dict())
    n_params = sum(p.numel() for p in tiled.parameters())
    print(f"training model (configs/DSO_train/ZJU/313_denarf_tpu.yml): "
          f"{n_params} parameters, tri-plane "
          f"{tuple(tiled.nerf.tri_plane.shape)}, z_dim {tiled.z_dim}; batch "
          f"{bs} x {size}², {config.generator_params.ray_batchsize} rays an "
          f"image")
    return config, ds, batch, tiled, exact


def _is_oom(err):
    import torch
    return isinstance(err, torch.cuda.OutOfMemoryError) or \
        "out of memory" in str(err)


def phase_train(gen, config, ds, batch, device, label, own, census_of=None):
    """1 warm-up and TIMED_STEPS steps of ``label``'s path at the smallest
    micro-batch split in (1, 2, 4, 8, 16) that fits; ``own`` are the
    kernels the path must launch. Then a profile of one step (each port
    kernel's device ms and launches a step) and, with ``census_of``
    (module, wrapper name, index of its ``valid`` argument), one more step
    that records the points and valid candidates or members of each of
    that wrapper's launches."""
    import gc
    import torch
    from enarf_gan_tpu_torch.training import dso
    rng = torch.Generator(device=device).manual_seed(SEED + 13)
    step = None
    for n_accum in (1, 2, 4, 8, 16):
        opt = dso.init_state(config, gen, ds.canonical_pose)
        step = dso.make_train_step(gen, opt, config.loss,
                                   config.dataset.bg_color, n_accum)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = step(batch, rng)
            torch.cuda.synchronize()
            print(f"{label} training: n_accum_step {n_accum} fits (warm-up "
                  f"{time.perf_counter() - t0:.2f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
            break
        except RuntimeError as err:
            if not _is_oom(err):
                raise
            print(f"{label} training: n_accum_step {n_accum} runs out of "
                  f"memory")
        step = opt = None
        gen.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
    assert step is not None, f"{label} training fits no micro-batch split"
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    metrics = [step(batch, rng) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / TIMED_STEPS
    launches = {k.name: k.launches for k in _all_kernels()}
    launches_by_m = dict(_all_kernels()[2].launches_by)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    assert all(np.isfinite(losses)) and all(m["applied"] for m in metrics), \
        metrics
    for k in own:
        assert k.launches > 0, f"{label} training did not launch {k.name}"
    print(f"{label} training: {s_iter:.3f} s/iter over {TIMED_STEPS} steps "
          f"(batch {batch['img'].shape[0]}, n_accum_step {n_accum}), peak "
          f"{peak / 2**30:.2f} GiB allocated, losses "
          + ", ".join(f"{x:.5f}" for x in losses) + f"; kernel launches "
          f"{launches}")
    t0 = time.perf_counter()
    step(batch, rng)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3
    device_ms, _, port = _profile(lambda: step(batch, rng),
                                  f"{label} training profile", ms_step,
                                  "step")
    census = None
    if census_of is not None:
        census = _census_step(step, batch, rng, *census_of)
        print(f"{label} training: {census_of[0].__name__}.{census_of[1]} "
              f"launches of a step: "
              + "; ".join(f"{p} points, {v} valid" for p, v in census))
    return {"s_iter": s_iter, "peak": peak, "n_accum": n_accum,
            "launches": launches, "launches_by_m": launches_by_m,
            "device_ms": device_ms, "ms_step": ms_step, "kernels": port,
            "census": census}


def _census_step(step, batch, rng, module, name, valid_at):
    """One more step with the wrapper ``module.name`` (its argument
    ``valid_at`` is ``valid``: (B, M, n) candidates or (B, Mp, m, U)
    members) recording each launch's points and valid candidates or
    members: [(points, valid), ...]."""
    import torch
    real = getattr(module, name)
    seen = []

    def recording(*args, **kw):
        valid = args[valid_at]
        seen.append((valid.numel() // valid.shape[1],
                     int((valid != 0).sum())))
        return real(*args, **kw)

    with mock.patch.object(module, name, recording):
        step(batch, rng)
    torch.cuda.synchronize()
    return seen


def phase_bwd_contention(label, run, kernel, check, what):
    """A backward kernel's device time per point and per valid ``what``
    (candidate or member) inside a training step (its profile; consecutive
    points are samples of one ray or patch and often add into the same
    texels) against the same at the check's positions (phase 2): a clearly
    higher cost in the step says the atomics contend."""
    step_ms, _ = run["kernels"].get(kernel, (0.0, 0))
    points = sum(p for p, _ in run["census"])
    valid = sum(v for _, v in run["census"])
    per = {"step": (step_ms, points, valid),
           "check": (check["ms"], check["points"], check["valid"])}
    for where, (ms, p, v) in per.items():
        print(f"{label} in the {where}: {ms:.3f} ms for {p} points and {v} "
              f"valid {what}s: {ms * 1e6 / max(p, 1):.3f} ns a point, "
              f"{ms * 1e6 / max(v, 1):.3f} ns a valid {what}")
    ratio = (step_ms / max(valid, 1)) / (check["ms"] / check["valid"])
    print(f"  step / check time a valid {what}: {ratio:.3f}")
    return ratio


def phase_train_modes(gen, config, ds, batch, device, n_accum):
    """One tiled step in each of kernel 3's modes on the batch and draws of
    a hat step, from the same weights: each must launch kernel 3 in its
    mode, and its loss must match the hat step's within 1e-3 relative.
    Then TIMED_STEPS more steps in the mode give its s/iter, and the peak
    memory of all of them is the mode's (a matrix mode's steps rebuild the
    window rows from the texel table at each launch)."""
    import os
    import torch
    from enarf_gan_tpu_torch.ops import tilewin_kernel
    from enarf_gan_tpu_torch.training import dso
    P = config.generator_params.nerf_params.tile_patch
    size = config.dataset.image_size
    mb = batch["img"].shape[0] // n_accum
    n_patch = config.generator_params.ray_batchsize // (P * P)
    Nf = config.generator_params.nerf_params.Nf
    g = torch.Generator(device=device).manual_seed(SEED + 17)
    randoms = [{"ray_noise": torch.rand((mb, (size // P) ** 2), generator=g,
                                        device=device),
                "draws": tuple(torch.rand((mb * n_patch, Nf), generator=g,
                                          device=device) for _ in range(2))}
               for _ in range(n_accum)]
    state = {k: v.clone() for k, v in gen.state_dict().items()}
    out = {}
    for mode in ("hat",) + MODES:
        gen.load_state_dict(state)
        opt = dso.init_state(config, gen, ds.canonical_pose)
        step = dso.make_train_step(gen, opt, config.loss,
                                   config.dataset.bg_color, n_accum)
        _reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.dict(os.environ, {"ENARF_TILEWIN_KERNEL": mode}):
            m = step(batch, randoms=randoms)
            torch.cuda.synchronize()
            counts = (dict(tilewin_kernel.KERNEL_MODES.launches_by),
                      tilewin_kernel.KERNEL_BWD.launches)
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                step(batch, randoms=randoms)
            torch.cuda.synchronize()
        s_iter = (time.perf_counter() - t0) / TIMED_STEPS
        out[mode] = (m["loss"], *counts, s_iter,
                     torch.cuda.max_memory_allocated())
        del opt, step
        torch.cuda.empty_cache()
    gen.load_state_dict(state)
    ref = out["hat"][0]
    print(f"tiled training step in mode hat: {out['hat'][3]:.4f} s/iter "
          f"over {TIMED_STEPS} steps, peak {out['hat'][4] / 2**30:.2f} GiB")
    for mode in MODES:
        loss, by_mode, bwd, s_iter, peak = out[mode]
        rel = abs(loss - ref) / abs(ref)
        print(f"tiled training step in mode {mode}: loss {loss:.6f} vs hat "
              f"{ref:.6f} (relative {rel:.2e}, bound 1e-3); kernel 3 "
              f"launches {by_mode}, backward (2b) launches {bwd}; "
              f"{s_iter:.4f} s/iter over {TIMED_STEPS} steps, peak "
              f"{peak / 2**30:.2f} GiB")
        assert by_mode[mode] > 0, f"mode {mode} did not launch kernel 3"
        assert rel <= 1e-3, (mode, loss, ref)
    return {mode: {"launches": out[mode][1].get(mode, 0),
                   "step_s_iter": out[mode][3],
                   "step_peak_gib": out[mode][4] / 2**30}
            for mode in ("hat",) + MODES}


def _learn_setup(device, root, label, tile, seed):
    """The learning config, dataset, loader and fresh model from ``seed``
    on the one LEARN_SIZE² frame of the cache at ``root``."""
    import torch
    from enarf_gan_tpu_torch.data.datasets import SSODataset
    from enarf_gan_tpu_torch.data.loader import DataLoader
    from enarf_gan_tpu_torch.training import dso
    config = _train_config(**{
        "out_root": root, "out": f"learn_{label}",
        "dataset.image_size": LEARN_SIZE, "dataset.bs": 1,
        "dataset.train.data_root": root, "dataset.train.n_frames": 1,
        "generator_params.nerf_params.tile_patch": tile,
        "num_iter": LEARN_ITERS, "print_interval": 10 ** 9,
        "val_interval": 10 ** 9, "save_interval": 10 ** 9})
    ds = SSODataset(config.dataset.train, size=LEARN_SIZE,
                    return_bone_params=True, num_repeat_in_epoch=LEARN_ITERS)
    loader = DataLoader(ds, 1, seed=0)
    gen = dso.build_generator(config, ds.num_bone, ds.parents, device,
                              generator=torch.Generator().manual_seed(seed))
    return config, ds, loader, gen


def _learn(device, root, label, tile, seed, exact_psnr=False):
    """Overfit the one LEARN_SIZE² frame of the cache at ``root`` for
    LEARN_ITERS iterations on ``label``'s path from a fresh model made from
    ``seed``. Returns (PSNR through the path's own renderer, blank frame's
    PSNR, loss history, seconds, and with ``exact_psnr`` the PSNR of the
    same weights through the exact renderer)."""
    import torch
    from enarf_gan_tpu_torch.eval_lib.metrics import psnr
    from enarf_gan_tpu_torch.training import dso
    config, ds, loader, gen = _learn_setup(device, root, label, tile, seed)
    t0 = time.perf_counter()
    gen, _, history = dso.train_loop(
        config, gen, (ds, {}), (loader, {}), ds.canonical_pose, verbose=False,
        generator=torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0

    def val_psnr(model):
        return dso.validate(model, config, {"train": loader},
                            torch.Generator(device=device).manual_seed(5),
                            num_data=1)["train"]["color_PSNR"]

    got = val_psnr(gen)
    if exact_psnr:
        config.generator_params.nerf_params.tile_patch = 0
        exact = dso.build_generator(config, ds.num_bone, ds.parents, device)
        exact.load_state_dict(gen.state_dict())
        got = (got, val_psnr(exact))
    item = ds[0]
    blank = psnr(item["img"][None], np.full_like(item["img"][None], -1.0))
    assert np.isfinite(history).all(), (label, seed)
    return got, blank, history, secs


def phase_learn(device, root):
    """Overfit one 64² frame for LEARN_ITERS iterations at lr 1e-3 on both
    paths, at the training model's full width, from a fresh model: the
    PSNR must beat the blank frame's by more than 2 dB."""
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    make_synthetic_human_cache(root, size=LEARN_SIZE, n_frames=1, n_camera=1)
    out = {}
    for label, tile in (("exact", 0), ("tiled", TILE_PATCH)):
        got, blank, history, secs = _learn(device, root, label, tile, SEED)
        print(f"{label} learning: {LEARN_ITERS} iterations on one "
              f"{LEARN_SIZE}² frame in {secs:.1f} s, loss {history[0]:.4f} -> "
              f"{history[-1]:.4f}; PSNR {got:.3f} dB, blank frame "
              f"{blank:.3f} dB")
        assert got > blank + 2.0, (label, got, blank)
        out[label] = (got, blank)
    return out


def learn_spread(device, root, seeds=(0, 1, 2)):
    """Where the learning PSNR's spread from run to run comes from: each
    path learns twice from each seed (same weights, same draws). The two
    runs of a seed differ only in the order the backward kernels' atomics
    add in; a tiled model is also rendered through the exact renderer, to
    tell its learning from its render. Prints per run the PSNRs and the
    loss trajectories' divergence, and one JSON line of all of it."""
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    make_synthetic_human_cache(root, size=LEARN_SIZE, n_frames=1, n_camera=1)
    rows = []
    for label, tile in (("exact", 0), ("tiled", TILE_PATCH)):
        for seed in seeds:
            runs = [_learn(device, root, label, tile, seed, exact_psnr=True)
                    for _ in range(2)]
            h = np.asarray([r[2] for r in runs], np.float64)
            rel = np.abs(h[0] - h[1]) / np.abs(h[0])
            first = int(np.argmax(rel > 0)) + 1 if (rel > 0).any() else None
            row = {"path": label, "seed": seed,
                   "psnr": [r[0][0] for r in runs],
                   "psnr_exact_render": [r[0][1] for r in runs],
                   "blank": runs[0][1],
                   "final_loss": [float(x[-1]) for x in h],
                   "mean_loss_last_20": [float(x[-20:].mean()) for x in h],
                   "first_differing_iteration": first,
                   "loss_rel_diff_at": {str(i): float(rel[i - 1])
                                        for i in (1, 2, 5, 20, 50, 100, 200)
                                        if i <= len(rel)}}
            print(f"learn spread: {label} seed {seed}: PSNR "
                  + " / ".join(f"{p:.3f}" for p in row["psnr"])
                  + " dB (exact render "
                  + " / ".join(f"{p:.3f}" for p in row["psnr_exact_render"])
                  + f" dB), blank {row['blank']:.3f} dB; losses first differ "
                  f"at iteration {first}; relative difference by iteration "
                  f"{row['loss_rel_diff_at']}")
            rows.append(row)
    print(json.dumps({"learn_spread": rows}))


def learn_collapse(device, root, seed=2, runs=4):
    """Whether a learning run that falls back to the empty frame (the fresh
    model's render) points at kernel 2b: from one seed, ``runs`` tiled runs
    with kernels 2 and 2b, as many with the plain combine under autograd in
    their place, and as many exact runs. Prints each run's PSNR and the
    iteration from which its loss stays within 1% of the empty frame's."""
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel
    make_synthetic_human_cache(root, size=LEARN_SIZE, n_frames=1, n_camera=1)

    def plain(*args, mode=None):
        return tilewin_kernel.tilewin_combine_texels_plain(*args)

    rows = []
    for variant, tile in (("tiled, kernels", TILE_PATCH),
                          ("tiled, plain combine", TILE_PATCH),
                          ("exact, kernels", 0)):
        for _ in range(runs):
            before = tilewin_kernel.KERNEL_BWD.launches
            if variant == "tiled, plain combine":
                with mock.patch.object(tilewin, "tilewin_combine", plain):
                    got, blank, history, _ = _learn(device, root, variant,
                                                    tile, seed)
                assert tilewin_kernel.KERNEL_BWD.launches == before
            else:
                got, blank, history, _ = _learn(device, root, variant, tile,
                                                seed)
            h = np.asarray(history)
            empty = np.abs(h / h[0] - 1) <= 0.01
            tail = np.flatnonzero(~empty)
            since = None if not empty[-1] else \
                (int(tail[-1]) + 2 if tail.size else 1)
            print(f"learn collapse: {variant}, seed {seed}: PSNR {got:.3f} dB "
                  f"(blank {blank:.3f}); loss {h[-1]:.4f}, at the empty "
                  f"frame's from iteration {since}")
            rows.append({"variant": variant, "seed": seed, "psnr": got,
                         "final_loss": float(h[-1]), "empty_since": since})
    print(json.dumps({"learn_collapse": rows}))


def learn_gradcheck(device, root, seeds=(0, 1, 2), every=10):
    """The backward kernels on the inputs that learning gives them: along a
    learning run of each path (with the kernels) from each seed, every
    ``every`` iterations, the gradient of the step's loss with respect to
    every parameter is taken three times on the same weights, batch and
    draws: twice with the kernels, once with the plain combine under
    autograd in their place. Prints the largest relative L2 difference
    over the parameters, kernel vs kernel (the atomics' order) and kernel
    vs plain, per checked iteration."""
    import torch
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel, unirow
    from enarf_gan_tpu_torch.training import dso
    from enarf_gan_tpu_torch.training.losses import photometric_loss
    make_synthetic_human_cache(root, size=LEARN_SIZE, n_frames=1, n_camera=1)

    def plain_tilewin(*args, mode=None):
        return tilewin_kernel.tilewin_combine_texels_plain(*args)

    def max_rel(a, b):
        rel = {n: float((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30))
               for n in b}
        worst = max(rel, key=rel.get)
        return rel[worst], worst

    rows = []
    for label, tile, module, name, plain in (
            ("tiled", TILE_PATCH, tilewin, "tilewin_combine", plain_tilewin),
            ("exact", 0, unirow, "unirow_combine",
             unirow.gather_combine_texels_plain)):
        for seed in seeds:
            config, ds, loader, gen = _learn_setup(device, root, label, tile,
                                                   seed)
            opt = dso.init_state(config, gen, ds.canonical_pose)
            step = dso.make_train_step(gen, opt, config.loss,
                                       config.dataset.bg_color)
            rng = torch.Generator(device=device).manual_seed(seed)

            def grads(b, draw_seed):
                opt.zero_grad()
                color, nerf_mask, ray_idx = gen(
                    b["pose_3d"], b["camera_rotation"], b["mask"],
                    b["frame_time"], b["bone_length"], b["inv_intrinsics"],
                    background=config.dataset.bg_color,
                    generator=torch.Generator(device=device).manual_seed(
                        draw_seed))
                lc, lm = photometric_loss(
                    ray_idx, color, nerf_mask, b["img"], b["mask"],
                    config.loss.nerf_loss_type,
                    float(config.loss.color_coef),
                    float(config.loss.mask_coef))
                (lc + lm).backward()
                return float((lc + lm).detach()), {
                    n: p.grad.detach().clone()
                    for n, p in gen.named_parameters() if p.grad is not None}

            checks = []
            for it, batch in enumerate(loader):
                if it >= LEARN_ITERS:
                    break
                b = dso.prepare_batch(batch, device)
                if it % every == 0:
                    loss, g1 = grads(b, 1000 + it)
                    _, g2 = grads(b, 1000 + it)
                    with mock.patch.object(module, name, plain):
                        loss_p, g3 = grads(b, 1000 + it)
                    noise, noise_at = max_rel(g2, g1)
                    vs_plain, vs_plain_at = max_rel(g1, g3)
                    checks.append({"iteration": it + 1, "loss": loss,
                                   "loss_plain": loss_p,
                                   "kernel_vs_kernel": noise,
                                   "kernel_vs_kernel_at": noise_at,
                                   "kernel_vs_plain": vs_plain,
                                   "kernel_vs_plain_at": vs_plain_at})
                step(b, rng)
            worst = max(checks, key=lambda c: c["kernel_vs_plain"])
            print(f"learn gradcheck: {label} seed {seed}: {len(checks)} "
                  f"checks; kernel vs kernel up to "
                  f"{max(c['kernel_vs_kernel'] for c in checks):.3e}; kernel "
                  f"vs plain up to {worst['kernel_vs_plain']:.3e} "
                  f"({worst['kernel_vs_plain_at']}, iteration "
                  f"{worst['iteration']}); last loss {checks[-1]['loss']:.4f}")
            rows.append({"path": label, "seed": seed, "checks": checks})
            del gen, opt, step
            torch.cuda.empty_cache()
    print(json.dumps({"learn_gradcheck": rows}))


def main():
    import os
    import tempfile
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs the port on "
                 "an NVIDIA GPU")
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel, unirow
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_setup()
    studies = {"--learn-spread": learn_spread,
               "--learn-collapse": learn_collapse,
               "--learn-gradcheck": learn_gradcheck,
               "--probes": lambda device, root: probe_sweeps(device)}
    if sys.argv[1:2] and sys.argv[1] in studies:
        with tempfile.TemporaryDirectory() as root:
            studies[sys.argv[1]](device, root)
        print(f"{sys.argv[1]} done in {time.perf_counter() - t_start:.1f} s")
        return
    k1 = phase_unirow_check(device)
    k2 = {m: phase_tilewin_check(device, m, S, label)
          for m, S, label in ((16, NF, "fine"), (4, NC, "coarse-corner"))}
    k3 = phase_modes_check(device)
    k1b = phase_unirow_bwd_check(device)
    k2b = phase_tilewin_bwd_check(device)
    torch.cuda.empty_cache()
    probes = phase_probes(device)
    torch.cuda.empty_cache()
    gen, tiled, scene = build_models(device)

    exact_frame, ms_exact, _ = phase_render(gen, scene, device, "exact",
                                            unirow.KERNEL,
                                            tilewin_kernel.KERNEL)
    tiled_frame, ms_tiled, _ = phase_render(tiled, scene, device, "tiled",
                                            tilewin_kernel.KERNEL,
                                            unirow.KERNEL)
    print(f"tiled: tilewin launches by member count "
          f"{dict(tilewin_kernel.KERNEL.launches_by)}")

    ref_e = phase_plain_render(exact_frame, unirow, "unirow_combine",
                               unirow.gather_combine_texels_plain,
                               unirow.KERNEL, "exact")
    ref_t = phase_plain_render(
        tiled_frame, tilewin, "tilewin_combine",
        lambda *a, mode=None: tilewin_kernel.tilewin_combine_texels_plain(*a),
        tilewin_kernel.KERNEL, "tiled")
    phase_tiled_vs_exact(ref_t, ref_e)
    frames = {
        "exact": phase_profile(gen, scene, exact_frame, ms_exact, device,
                               "exact", "pack_planes"),
        "tiled": phase_profile(tiled, scene, tiled_frame, ms_tiled, device,
                               "tiled", "pack_planes_tiled")}
    phase_launch_cost(probes, frames, {"exact": ms_exact, "tiled": ms_tiled})
    phase_tiled_rows(tiled_frame)
    del gen, tiled, exact_frame, tiled_frame, ref_e, ref_t
    torch.cuda.empty_cache()
    print(f"rendering phases done at {time.perf_counter() - t_start:.1f} s")

    with tempfile.TemporaryDirectory() as root:
        config, ds, batch, tiled_t, exact_t = build_training(
            device, os.path.join(root, "train"))
        te = phase_train(exact_t, config, ds, batch, device, "exact",
                         (unirow.KERNEL, unirow.KERNEL_BWD),
                         census_of=(unirow, "launch_backward", 4))
        phase_bwd_contention("unirow_combine_bwd", te,
                             "unirow_combine_bwd_kernel", k1b, "candidate")
        assert te["launches"]["tilewin_combine"] == 0 and \
            te["launches"]["tilewin_combine_bwd"] == 0, te["launches"]
        del exact_t
        torch.cuda.empty_cache()
        tt = phase_train(tiled_t, config, ds, batch, device, "tiled",
                         (tilewin_kernel.KERNEL, tilewin_kernel.KERNEL_BWD),
                         census_of=(tilewin_kernel, "launch_backward", 5))
        k2b["step_over_check"] = phase_bwd_contention(
            "tilewin_combine_bwd", tt, "tilewin_combine_bwd_kernel", k2b,
            "member")
        torch.cuda.empty_cache()
        by_m = dict(tt["launches_by_m"])
        assert tt["launches"]["unirow_combine"] == 0 and by_m[4] > 0 \
            and by_m[16] > 0, tt
        k3_steps = phase_train_modes(tiled_t, config, ds, batch, device,
                                        tt["n_accum"])
        del tiled_t, batch
        torch.cuda.empty_cache()
        print(f"training phases done at {time.perf_counter() - t_start:.1f} s")
        phase_learn(device, os.path.join(root, "learn"))
    print(f"all phases done in {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, numbers):
        return {"name": name, "route": "cuda",
                "source": f"enarf_gan_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                **{k: v for k, v in numbers.items()
                   if k not in ("valid", "points")},
                "library_ms": None}

    for k, run, kernel in ((k1, te, "unirow_combine_kernel"),
                           (k1b, te, "unirow_combine_bwd_kernel"),
                           (k2b, tt, "tilewin_combine_bwd_kernel")):
        k["step_ms"], k["step_launches"] = run["kernels"].get(kernel,
                                                              (0.0, 0))

    entries = [
        entry("unirow_combine", "unirow_combine.cu",
              "enarf_gan_tpu/ops/unirow.py:115",
              te["launches"]["unirow_combine"], k1),
        entry("unirow_combine_bwd (4 images' fine pass)",
              "unirow_combine_bwd.cu", "enarf_gan_tpu/ops/unirow.py:234",
              te["launches"]["unirow_combine_bwd"], k1b)]
    for m, shape in ((16, "fine chunk, m=16"), (4, "coarse-corner chunk, m=4")):
        entries.append(entry(f"tilewin_combine ({shape})",
                             "tilewin_combine.cu",
                             "enarf_gan_tpu/ops/tilewin_kernel.py:166",
                             by_m[m], k2[m]))
    entries.append(entry("tilewin_combine_bwd (4 images' fine pass, m=16)",
                         "tilewin_combine_bwd.cu",
                         "enarf_gan_tpu/ops/tilewin.py:447",
                         tt["launches"]["tilewin_combine_bwd"], k2b))
    for mode in MODES:
        entries.append(entry(
            f"tilewin_combine_modes ({mode}, fine chunk)",
            "tilewin_combine_modes.cu",
            "enarf_gan_tpu/ops/tilewin_kernel.py:"
            + ("317" if mode == "bdiag" else "65"),
            k3_steps[mode]["launches"],
            {**k3[mode], "step_s_iter": k3_steps[mode]["step_s_iter"],
             "step_peak_gib": k3_steps[mode]["step_peak_gib"],
             "hat_step_s_iter": k3_steps["hat"]["step_s_iter"],
             "hat_step_peak_gib": k3_steps["hat"]["step_peak_gib"]}))
    print(json.dumps({"kernels": entries + probes}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
