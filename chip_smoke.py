"""Smoke run of the PyTorch/CUDA port (``enarf_gan_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. Prints the card (``nvidia-smi``) and the versions, and builds the
   hand-written kernels from ``enarf_gan_tpu_torch/csrc`` (one nvcc per
   source, all started together), with each kernel's ptxas report.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (unirow: one full fine chunk; tilewin: one full
   fine chunk, m = 16, and one full coarse-corner chunk, m = 4; kernel 3 in
   each mode at the fine chunk on the texel table, and held to its
   window-row formulation on window rows built from the texel table and
   held to ``pack_tilewin``'s; the backward kernels 1b and 2b at one
   training fine pass of 4 images, against autograd through the plain
   versions; kernels 1f and 1bf, kernels 1 and 1b on a float32 texel
   table, at the same shapes), times both with CUDA events in turns, and
   computes each
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
   of ``tools/`` as Hopper microbenchmarks: row and lane gathers, the
   one-hot gathers read as direct row gathers, products on the tensor
   cores, stage ablations of kernels 2 and 3, one-construct
   kernels and launch cost): each kernel and variant against its plain twin
   at a small size, then at its probe's main size once more and timed with
   its plain twin, the one PyTorch call of the same function where there is
   one, and its bound; one line a probe, with the host and device
   microseconds a call of the kernel and of the library call (calls queued
   behind a spin kernel; for the argument rosters, the launch cost).
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
7. The GAN of ``configs/enarfgan_train/AIST/config_tpu.yml`` (over
   ``configs/enarfgan_train/default.yml``, written out as a dict): 128²
   images, batch 12 in 2 micro-batches, z_dim 256, 256² StyleGAN2
   tri-planes at w_dim 512, Nc 48 + Nf 64, bf16 sampling with
   ``tile_patch: 4`` and coarse corners, 2048-ray training chunks, the
   cropped learned background, the discriminator without minibatch-std, ce
   loss with bone coefficient 10, R1 10, tri-plane L2 0.001; seeded
   weights perturbed by 0.3, synthetic 128² frames. Sampling: 4 poses
   through ``make_gan_full_renderer`` on the tiled path (kernel 2) and on
   its exact twin with the same weights (kernel 1), each launching only
   its own kernel, finite with a non-empty mask, again with the plain
   combine (bounded as in phase 4), tiled against exact, ms a frame, peak
   memory and a profile of a frame. Training (``training.gan``): 1 warm-up
   and 3 timed iterations of the G and D steps at the config's split, one
   R1 step timed apart, a profile of a G step (each kernel's launches and
   device ms); one G step of the exact twin (kernels 1 and 1b); and for
   each path one micro-batch's generator gradients through the kernels
   against the plain combine's under autograd (relative L2 within 1e-2,
   over all of them and over the tri-plane generator's, which alone come
   through the combine's backward); on the tiled path the tri-plane bound
   must also reject 2b's gradients with their mask lanes zeroed.
8. The published float32 DSO config through the port's CLI functions
   (``enarf_gan_tpu_torch.train_DSO``, ``DSO_demo``): ``configs/DSO_train/
   ZJU/313_denarf.yml`` over its ``default.yml``, read by the port's YAML
   reader with only the data roots, ``out_root`` and the iteration count
   replaced (float32 planes: kernels 1f and 1bf), trained on a synthetic
   512² cache of 16 images at full width (1 warm-up, 3 timed and 1
   profiled iteration: s/iter, peak memory, launches a step); then
   ``--validation`` on 2 frames (PSNR and SSIM, cropped) and the demo
   (``configs/DSO_demo/ZJU/313_denarf.yml``) on 2 samples at 512², its PNGs
   read back. Then the float32 GAN of ``configs/enarfgan_train/AIST/
   config.yml`` over its ``default.yml`` (128², bs 12 in 2 micro-batches,
   the exact sampler): 1 warm-up and 2 timed G + D iterations through
   ``training.gan``, a profile of a G step, and one 128² sample.
9. Overfits one 64² frame for 200 iterations on both paths at full width:
   the PSNR must beat the blank frame's by more than 2 dB.

The second-to-last line is a JSON record of the kernels, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line; so does a machine without a CUDA device.

    python3 chip_smoke.py --learn-spread | --learn-collapse | --learn-gradcheck

run only phase 1 and one study of phase 8's spread from run to run (3-8
minutes each on an H100): each path learning twice from each of three seeds
(PSNR through its own and the exact renderer, the loss trajectories'
divergence); repeated runs from one seed with the kernels and with the plain
combine; and the parameter gradients along learning, kernels against the
plain combine.

    python3 chip_smoke.py --gan

runs only phase 1 and phase 7 (about a minute on an H100).

    python3 chip_smoke.py --float32

runs phase 1, kernels 1f and 1bf's checks (phase 2) and the float32
configs' runs (phase 8's first half).

    python3 chip_smoke.py --modes

runs phase 1, kernel 2's and kernel 3's checks at the fine chunk (phase
2), and the tiled training steps of phase 6 in the hat mode and in each of
kernel 3's modes (s/iter and peak memory a mode; a few minutes on an H100).

    python3 chip_smoke.py --probes

runs phase 1 and every probe module's full sweep (row widths x table sizes
x index order, A2 at 1, 8, 64 and 1,024 rows a warp, A3 by table height
from 384 to 196,608 rows in float32 and bf16 on the kept design, ring
depths, B3 at its ragged shapes), one JSON line a measurement.
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
# configs/enarfgan_train/AIST/config_tpu.yml over configs/enarfgan_train/
# default.yml, written out; the widths not in the files are NARFParams'
# defaults (256² planes, feat 32, w_dim 512) and the discriminator's
# channel_max 512
GAN_CONFIG = {
    "out_root": "data", "out": "GAN/AIST/example_tpu",
    "dataset": {"name": "human_v2", "bs": 12, "image_size": 128,
                "train": {"data_root": None, "pose_prior_root": None}},
    "generator_params": {
        "z_dim": 256, "patch_size": 24, "background_ratio": 0.7,
        "use_triplane": True, "crop_background": True,
        "pretrained_background": False, "train_ray_chunk": 2048,
        "nerf_params": {
            "final_activation": "tanh", "hidden_size": 256, "out_dim": 256,
            "Nc": 48, "Nf": 64, "no_ray_direction": False,
            "mask_input": False, "origin_location": "center_fixed",
            "coordinate_scale": 3,
            "multiply_density_with_triplane_wieght": False,
            "clamp_mask": False, "constant_triplane": False,
            "constant_trimask": False, "constant_trimask_lr_mul": 1,
            "deformation_field": False, "selector_mlp": False,
            "no_selector": False, "plane_sample_dtype": "bfloat16",
            "tile_patch": 4, "tile_coarse_corners": True}},
    "discriminator_params": {"minibatch_std": False},
    "loss": {"adv_loss_type": "ce", "bone_guided_coef": 10,
             "r1_loss_coef": 10, "tri_plane_reg_coef": 0.001},
    "replace": True, "num_iter": 800000, "n_accum_step": 2,
    "resume": None, "resume_latest": False}
# the published float32 configs (no plane_sample_dtype: float32 planes,
# kernels 1f and 1bf), read from the files by the port's YAML reader
DSO_F32_CONFIG = ("configs/DSO_train/ZJU/313_denarf.yml",
                  "configs/DSO_train/default.yml")
DEMO_F32_CONFIG = ("configs/DSO_demo/ZJU/313_denarf.yml",
                   "configs/DSO_demo/default.yml")
GAN_F32_CONFIG = ("configs/enarfgan_train/AIST/config.yml",
                  "configs/enarfgan_train/default.yml")
CLI_FRAMES, CLI_CAMERAS = 4, 4   # the synthetic 512² training cache: 16
CLI_ITERS = 1 + TIMED_STEPS + 1   # warm-up, timed, profiled
GAN_F32_TIMED = 2
GAN_POSES = 4             # full-image GAN frames a path
GAN_GRAD_REL_L2 = 1e-2    # G-step gradients, kernels vs plain combine: the
                          # atomics' order, and near-ties (bone slots, fine
                          # bins) that the sums' order decides otherwise;
                          # over all of G's and over the tri-plane's alone
TRI_PLANE = "nerf.tri_plane_gen."   # the parameters 2b's (1b's) gradient
                                    # reaches


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
    from enarf_gan_tpu_torch import use_full_float32
    from enarf_gan_tpu_torch.ops import tilewin_kernel, unirow
    from enarf_gan_tpu_torch.tools import ablate
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    use_full_float32()     # as the CLIs do: no TF32 (cuDNN's default)
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
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


def _quadtable_bytes(rows, cand_idx, valid, feat_dim, H, W, K):
    """The float32 quad-table yardstick (the JAX package's float32 layout,
    ``ops/quadtable.py``: a 4F-lane feature quad row a cell, a 4-lane mask
    quad row a bone and cell): the feature rows of valid candidates and the
    32-byte sectors holding every candidate's mask quad row. Returns
    (bytes, distinct feature rows, distinct mask sectors)."""
    import torch
    B = rows.shape[0]
    cells = 3 * (H + 1) * (W + 1)
    base = torch.arange(B, device=rows.device).view(B, 1, 1, 1)
    grow = rows.long() + base * cells
    keep = (valid != 0)[:, None].expand_as(grow)
    d_rows = int(torch.unique(grow[keep]).numel())
    # mask row (k*3 + p)*(H+1)*(W+1) + cell = k*cells + row, 16 bytes each
    mrow = cand_idx.long()[:, None] * cells + rows.long() + base * K * cells
    d_sec = int(torch.unique(mrow // 2).numel())
    return d_rows * 4 * feat_dim * 4 + d_sec * 32, d_rows, d_sec


def phase_unirow_check(device, dtype=None):
    """Kernel 1 (bf16 texels) or 1f (``dtype`` float32) vs its plain twin at
    one full fine chunk of the exact path. The bound counts the texel
    table's bytes the function needs; the TPU layout's (bf16 quad rows; for
    float32 the JAX package's quad tables) is printed beside it."""
    import torch
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.tools.ablate import (texel_table_bytes,
                                                  unirow_inputs)
    dtype = dtype or torch.bfloat16
    F_, M, H = 32, 4, 256
    n = FINE_CHUNK_POINTS
    args = unirow_inputs(device, 1, n, H, M, seed=SEED, dtype=dtype)[:5]
    texels = args[0]
    name = "unirow_combine" + ("_f32" if dtype == torch.float32 else "")
    err, kern_ms, plain_ms = _compare_and_time(
        lambda: unirow.unirow_combine(*args, F_, False),
        lambda: unirow.gather_combine_texels_plain(*args, F_, False),
        f"{name} at n={n} M={M} texels {tuple(texels.shape)} {dtype}")
    inputs = sum(a.numel() * a.element_size() for a in args[1:])
    outputs = (F_ + M) * n * 4
    flops = n * M * 3 * (4 * F_ * 2 + 4 * 2) + n * M * F_ * 2
    table_bytes, d_tex, d_sec = texel_table_bytes(texels, args[1], args[3],
                                                  args[4], F_)
    bound_ms, bound_by = _bound(table_bytes + inputs + outputs, flops)
    if dtype == torch.float32:
        quad_bytes, d_rows, d_qsec = _quadtable_bytes(args[1], args[3],
                                                      args[4], F_, H, H, 23)
        layout = "float32 quad tables"
    else:
        quad_bytes, d_rows, d_qsec = _unirow_table_bytes(args[1], args[3],
                                                         args[4], F_, H, H)
        layout = "quad rows"
    quad_ms, _ = _bound(quad_bytes + inputs + outputs, flops)
    print(f"  kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{args[1].numel()} (plane, candidate, point) reads on {d_tex} "
          f"distinct feature texels (valid candidates) and {d_sec} distinct "
          f"mask sectors: texel table {table_bytes / 1e6:.1f} MB, inputs "
          f"{inputs / 1e6:.1f} MB, outputs {outputs / 1e6:.1f} MB; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP); "
          f"{layout} yardstick: {d_rows} distinct rows and {d_qsec} mask "
          f"sectors, {quad_bytes / 1e6:.1f} MB, bound {quad_ms:.4f} ms")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            ("quad_table_bound_ms" if dtype == torch.float32
             else "quad_row_bound_ms"): quad_ms,
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


def _window_texels(texels, bases):
    """The distinct texels of the table that the 8x8 windows at ``bases``
    cover (a window past the plane covers fewer)."""
    import torch
    Hp, Wp = texels.shape[2:4]
    b = torch.unique(bases).long()
    t = torch.arange(8, device=b.device)
    bt = b % (Hp * Wp) // Wp
    bs = b % Wp
    inside = ((bt[:, None, None] + t[:, None]) < Hp) \
        & ((bs[:, None, None] + t) < Wp)
    cover = b[:, None, None] + t[:, None] * Wp + t
    return int(torch.unique(cover[inside]).numel())


def phase_modes_check(device):
    """Kernel 3 in each mode vs its plain version at kernel 2's full fine
    chunk, through ``tilewin_combine`` on the texel table, as the main path
    launches it (``ms``: its time, the tensor map's encoding included).
    Then the same plan through kernel 3's window-row formulation (its stage
    build's "full" variant, ``tools/ablate.py::modes_stage``) on the window
    rows that ``windows_from_texels`` builds from the texel table and
    ``window_rows`` names, which are first held to ``pack_tilewin``'s rows
    of the same draws, bit for bit: its tiles are the same numbers, so
    the two results agree within 1e-6, else the texel fetch is at fault
    (``rows_ms``: its time on rows built beforehand). Its bound is kernel
    2's: the same function on the same inputs (the bf16 rounding of the
    t-weights changes no byte or operation the function needs). What its
    formulation does is printed beside it: each (unit, slot, plane) loads
    its window's whole 4 KB tile through L2 (the distinct texels of the
    windows once from the table at least), and the (32 x 16) @ (16 x 128)
    t-contraction, on the bf16 tensor cores ("dot", "bdiag") or in
    float32 ("vpu", the halves' 16 nonzero rows)."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin_kernel as tk
    from enarf_gan_tpu_torch.tools.ablate import modes_stage
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
    print(f"window rows from the texel table vs pack_tilewin's rows of the "
          f"same plan: {'equal' if same else 'DIFFERENT'}")
    assert same
    del wargs
    rows = (feat_t, mask_t, frows_t, mrows_t, *targs[3:6], *targs[7:9])
    bound_ms, bound_by, nbytes, flops, (_, _, d_sec), _, _ = \
        _tilewin_bound(targs, 16)
    d_win = _window_texels(texels, bases)
    tiles = bases.numel()
    form_bytes = _tilewin_io_bytes(targs, 16) + d_win * 64 + d_sec * 32
    out = {}
    for mode in MODES:
        path = "vpu" if mode == "vpu" else "dot"
        err, kern_ms, plain_ms = _compare_and_time(
            lambda: tk.tilewin_combine(*targs, mode=mode),
            lambda: tk.tilewin_combine_texels_plain(*targs,
                                                    round_t=mode != "vpu"),
            f"tilewin_combine_modes {mode} at U={U} m=16 Mp={Mp} texels "
            f"{tuple(texels.shape)} bf16")
        with torch.no_grad():
            got = tk.tilewin_combine(*targs, mode=mode)
            via_rows = modes_stage(*rows, path, "full")
            torch.cuda.synchronize()
            diff = max(float((a - b).abs().max())
                       for a, b in zip(got, via_rows))
            rows_ms = _cuda_time_ms(lambda: modes_stage(*rows, path, "full"),
                                    20)
        print(f"  the window-row formulation of the same plan: max|d| "
              f"{diff:.3e} (bound 1e-6), {rows_ms:.4f} ms")
        assert diff <= 1e-6, (mode, diff)
        if mode == "vpu":
            form_flops, rate = tiles * 2 * 16 * 8 * 128 * 2, F32_FLOPS
        else:
            form_flops, rate = tiles * 32 * 16 * 128 * 2, BF16_FLOPS
        form_ms, form_by = _bound(form_bytes, form_flops, rate)
        print(f"  kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP), kernel 2's on the texel table; its "
              f"formulation: {tiles} tiles of 4 KB through L2 "
              f"({tiles * 4096 / 1e6:.1f} MB), {d_win} distinct window "
              f"texels and {d_sec} mask sectors from the table, "
              f"{form_bytes / 1e6:.1f} MB, {form_flops / 1e9:.2f} GFLOP "
              f"({'float32' if mode == 'vpu' else 'bf16 tensor cores'}), "
              f"least {form_ms:.4f} ms by {form_by}")
        out[mode] = {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "rows_ms": rows_ms, "rows_max_abs_diff": diff,
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


def phase_unirow_bwd_check(device, dtype=None):
    """Kernel 1b (bf16 texels) or 1bf (``dtype`` float32) at one training
    fine pass: 4 images x 4096 rays x Nf 64, 4 candidates, against autograd
    through the plain twin (image by image: images share no texels). The
    kernel's time includes zeroing the dense float32 texel gradient, which
    the bound counts as written. Then, for kernel 1b, its stage ablations
    (``tools/ablate.py``: scalar feature adds, no feature adds, no mask
    adds), each held to its doctored twin and timed in turns with the full
    kernel."""
    import torch
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.tools import ablate
    dtype = dtype or torch.bfloat16
    F_, H, B, n = 32, 256, TRAIN_IMAGES, FINE_CHUNK_POINTS
    args = ablate.unirow_inputs(device, B, n, H, seed=SEED + 5, dtype=dtype)
    texels, rows, wq4, ci, cv, dfeature, dcand_w = args
    M = rows.shape[2]

    def kern():
        return unirow.launch_backward(*args, F_, False)

    name = "unirow_combine_bwd" + ("_f32" if dtype == torch.float32 else "")
    err, kern_ms, plain_ms = _grad_check(
        f"{name} at B={B} n={n} M={M} {dtype} texels", kern,
        lambda: ablate.unirow_bwd_plain(*args), ("texels", "wq4"))
    table_bytes, d_tex, d_sec = ablate.texel_table_bytes(texels, rows, ci, cv,
                                                         F_)
    inputs = sum(t.numel() * t.element_size() for t in args[1:])
    outputs = texels.numel() * 4 + wq4.numel() * 4
    flops = 3 * (n * M * 3 * (4 * F_ * 2 + 4 * 2) + n * M * F_ * 2) * B
    bound_ms, bound_by = _bound(table_bytes + inputs + outputs, flops)
    if dtype == torch.float32:     # the gradients of both quad tables
        quad_bytes, _, _ = _quadtable_bytes(rows, ci, cv, F_, H, H, 23)
        quad_out = B * 3 * (H + 1) * (H + 1) * (4 * F_ + 4 * 23) * 4 \
            + wq4.numel() * 4
    else:
        quad_bytes, _, _ = _unirow_table_bytes(rows, ci, cv, F_, H, H)
        quad_out = B * 3 * (H + 1) * (H + 1) * unirow.row_width(F_) * 4 \
            + wq4.numel() * 4
    quad_ms, _ = _bound(quad_bytes + inputs + quad_out, flops)
    print(f"  kernel {kern_ms:.4f} ms (with the zeroed float32 texel "
          f"gradient), plain {plain_ms:.4f} ms; texel reads "
          f"{table_bytes / 1e6:.1f} MB ({d_tex} texels, {d_sec} mask "
          f"sectors), other inputs {inputs / 1e6:.1f} MB, outputs "
          f"{outputs / 1e6:.1f} MB; bound {bound_ms:.4f} ms by {bound_by}; "
          f"{'quad-table' if dtype == torch.float32 else 'quad-row'} "
          f"yardstick: table reads {quad_bytes / 1e6:.1f} MB, "
          f"outputs {quad_out / 1e6:.1f} MB, bound {quad_ms:.4f} ms")
    stage_ms = {}
    stages = ablate.UNIROW_BWD_STAGES[1:] if dtype == torch.bfloat16 else ()
    for stage in stages:
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
            ("quad_table_bound_ms" if dtype == torch.float32
             else "quad_row_bound_ms"): quad_ms, "stage_ms": stage_ms,
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
    timed (kernel, plain, library call) against its bound, with the host
    and device µs a call of the kernel and the library call (``device_us``,
    ``host_us``, ``library_device_us``, ``library_host_us``: calls queued
    behind a spin kernel, ``timing.launch_us``). Each entry's ``launches``
    are the kernel's launches while it was timed in ms (its comparisons and
    the calls of ``launch_us`` excluded). Kernel 2's and
    3's stage variants are timed at the probes' U = 12288 and at the fine
    chunk; the entry holds the former and ``fine_chunk_ms`` the latter."""
    import torch
    from enarf_gan_tpu_torch.tools import timing
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
            t = timing.measure(case, PROBE_BUDGET_MS)
            launches = t["launches"]
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
            line += (f"; a call: device {t['device_us']:.2f} us, host "
                     f"{t['host_us']:.2f} us")
            if t["library_ms"] is not None:
                line += (f" (library device {t['library_device_us']:.2f} us,"
                         f" host {t['library_host_us']:.2f} us)")
            extra = {k: v for k, v in t.items()
                     if k.startswith("library_") and k.endswith("_ms")
                     and k != "library_ms"}
            line += "".join(f"; {k} {v:.4f}" for k, v in extra.items())
            if case.info.get("kernel") == "gemm":
                line += (f"; {case.info['tiles']} tiles, "
                         f"{case.info['stages']} stages, B "
                         + ("resident" if case.info["b_resident"]
                            else "streamed")
                         + f", B from L2 {case.info['b_l2_bytes'] / 1e9:.4f}"
                         f" GB")
            elif case.info.get("kernel") == "gemm_small":
                line += (f"; {case.info['blocks']} blocks of "
                         f"{case.info['block_rows']} rows x 64 columns in "
                         f"{case.info['warps']} warps, "
                         f"{case.info['smem_bytes']} B shared")
            elif case.info.get("kernel") in ("tile4", "tile"):
                line += (f"; {case.info['kernel']} kernel, "
                         f"{case.info['blocks']} blocks")
            elif case.info.get("kernel") in ("reshape_fm_kernel",
                                             "vec4_kernel<false>",
                                             "vec4_kernel<true>",
                                             "concat_mid_kernel"):
                line += (f"; {case.info['kernel']}, {case.info['blocks']} "
                         f"blocks of {case.info['threads']} threads, one "
                         f"16-byte vector a thread")
            elif "variant" in case.info:             # A1's row_plan
                line += (f"; row_units_kernel, {case.info['variant']} hints, "
                         f"{case.info['per_thread']} {case.info['unit']}-byte"
                         f" units a thread, {case.info['blocks']} blocks; "
                         f"sector floor {case.info['sector_floor_ms']:.4f} ms")
            elif case.info.get("kernel") == "pair_rows_kernel":   # B1, B2
                line += (f"; pair_rows_kernel, {case.info['blocks']} blocks "
                         f"of {case.info['threads']} threads, "
                         f"{case.info['samples_per_warp']} samples a warp, "
                         f"{case.info['cols_per_thread']} float32 columns a "
                         f"thread from 16 bytes of each row, "
                         f"{case.info['hints']}; bound by {t['bound_by']}; "
                         f"the one-hot formulation "
                         f"{case.info['formulation_ms']:.4f} ms on the "
                         f"tensor cores")
                if "group_floor_ms" in case.info:
                    line += (f"; rows from HBM once a group "
                             f"{case.info['group_floor_ms']:.4f} ms")
            elif case.info.get("kernel") == "ewr_mma_kernel":
                line += (f"; ewr_mma_kernel, {case.info['blocks']} blocks of "
                         f"{case.info['threads'] // 32} warps, a warp a batch "
                         f"element, 16 mma.sync m16n8k16")
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
                "library_ms": t["library_ms"],
                **{k: t[k] for k in ("device_us", "library_device_us",
                                     "host_us", "library_host_us")},
                **extra}
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
    launches)}) for the port's kernels (unirow, tilewin), each under its
    name and, for a template, also its name with its first argument
    (``tilewin_combine_kernel<16>``)."""
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
                found = re.search(r"(\w*(?:unirow|tilewin)\w*)(<\d+)?",
                                  e.key)
                # by name, and by name and first template argument (the
                # member count of tilewin_combine_kernel<m, stage>)
                for short in {found.group(0) + ">" * bool(found.group(2)),
                              found.group(1)}:
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
            tilewin_kernel.KERNEL_BWD, tilewin_kernel.KERNEL_MODES,
            unirow.KERNEL_F32, unirow.KERNEL_BWD_F32)


def _reset_all_counts():
    for k in _all_kernels():
        k.reset_counts()


def _train_config(base=None, **overrides):
    """``base`` (TRAIN_CONFIG by default) with nested overrides (keys as
    "a.b.c")."""
    import copy
    from enarf_gan_tpu_torch.config import AttrDict
    raw = copy.deepcopy(TRAIN_CONFIG if base is None else base)
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
    memory of all of them is the mode's."""
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


def modes_study(device, root):
    """Kernel 3 beside kernel 2: both at the fine chunk (phase 2), then the
    tiled training step in the hat mode and in each of kernel 3's modes
    (phase 6's model, batch and split)."""
    import os
    from enarf_gan_tpu_torch.ops import tilewin_kernel
    phase_tilewin_check(device, 16, NF, "fine")
    phase_modes_check(device)
    config, ds, batch, tiled, exact = build_training(
        device, os.path.join(root, "train"))
    del exact
    tt = phase_train(tiled, config, ds, batch, device, "tiled",
                     (tilewin_kernel.KERNEL, tilewin_kernel.KERNEL_BWD))
    phase_train_modes(tiled, config, ds, batch, device, tt["n_accum"])


def build_gan(device, root):
    """The config_tpu.yml GAN (tiled, kernels 2 and 2b) with seeded weights
    perturbed by 0.3, its exact twin (tile_patch 0, kernels 1 and 1b) with
    the same weights, and a batch of 12 from a synthetic 128² cache of 12
    frames (3 poses x 4 cameras): real images and the pose prior's poses
    and bone masks."""
    import torch
    from enarf_gan_tpu_torch.data.datasets import (HumanDataset,
                                                   HumanPoseDataset)
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.data.loader import collate
    from enarf_gan_tpu_torch.models.generator import register_canonical_pose
    from enarf_gan_tpu_torch.training import checkpoint as ckpt
    from enarf_gan_tpu_torch.training import gan
    size = GAN_CONFIG["dataset"]["image_size"]
    bs = GAN_CONFIG["dataset"]["bs"]
    t0 = time.perf_counter()
    make_synthetic_human_cache(root, size=size, n_frames=3, n_camera=4)
    config = _train_config(GAN_CONFIG, **{"dataset.train.data_root": root})
    img_ds = HumanDataset(config.dataset.train, size=size,
                          return_bone_params=False, num_repeat_in_epoch=1)
    pose_ds = HumanPoseDataset(size=size, data_root=root,
                               num_repeat_in_epoch=1)
    batch = gan.prepare_gan_batch(collate([img_ds[i] for i in range(bs)]),
                                  collate([pose_ds[i] for i in range(bs)]),
                                  device)
    g = torch.Generator().manual_seed(SEED + 21)
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents,
                                device, generator=g)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(device))
    exact_cfg = _train_config(config, **{
        "generator_params.nerf_params.tile_patch": 0})
    exact, _ = gan.build_models(exact_cfg, pose_ds.num_bone, pose_ds.parents,
                                device)
    ckpt.load_gen_state_dict(exact, ckpt.gen_state_dict(gen))
    for model in (gen, exact):
        register_canonical_pose(model, pose_ds.canonical_pose,
                                "center_fixed", pose_ds.parents)
    n_gen = sum(p.numel() for p in gen.parameters())
    n_dis = sum(p.numel() for p in dis.parameters())
    print(f"GAN (configs/enarfgan_train/AIST/config_tpu.yml): generator "
          f"{n_gen} parameters (tri-plane StyleGAN2 "
          f"{gen.nerf_params.tri_plane_size}² w_dim {gen.nerf_params.w_dim}, "
          f"background {size}² z_dim {gen.z_dim}), discriminator {n_dis} "
          f"(minibatch_std {config.discriminator_params.minibatch_std}); "
          f"batch {bs} x {size}² from a synthetic cache, "
          f"{time.perf_counter() - t0:.2f} s to build")
    return config, gen, exact, dis, batch, pose_ds.canonical_pose


def phase_gan_sample(gen, batch, device, label, own, other):
    """GAN_POSES full-image foregrounds of the batch's first poses through
    ``make_gan_full_renderer``, each from its own z; ``own`` must launch,
    ``other`` must not. Returns (frame(i, seed), ms a frame, launches a
    frame of every kernel by name and of ``own`` by member count)."""
    import torch
    from enarf_gan_tpu_torch.models.generator import make_gan_full_renderer
    render = make_gan_full_renderer(gen)
    size = gen.size
    g = torch.Generator().manual_seed(SEED + 23)
    zs = torch.randn((GAN_POSES, 4 * gen.z_dim), generator=g).to(device)

    def frame(i, seed):
        rng = torch.Generator(device=device).manual_seed(seed)
        return render(batch["pose_to_camera"][i:i + 1],
                      batch["bone_length"][i:i + 1], zs[i:i + 1],
                      batch["inv_intrinsics"][i:i + 1], generator=rng)

    frame(0, 1)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    outs = [frame(i, 1) for i in range(GAN_POSES)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / GAN_POSES * 1e3
    launches, others = own.launches, other.launches
    counts = {"by_m": {m: n / GAN_POSES for m, n in own.launches_by.items()},
              **{k.name: k.launches / GAN_POSES for k in _all_kernels()}}
    by = dict(own.launches_by)
    peak = torch.cuda.max_memory_allocated()
    for color, mask, disp in outs:
        assert color.shape == (3, size, size), color.shape
        assert mask.shape == disp.shape == (size, size)
        for x in (color, mask, disp):
            assert bool(torch.isfinite(x).all()), "non-finite GAN frame"
        assert float(mask.sum()) > 0, "empty GAN foreground mask"
    assert launches > 0, f"the GAN {label} frames did not launch their kernel"
    assert others == 0, f"the GAN {label} frames launched the other kernel"
    fg = [round(float((m > 0.05).float().mean()), 3) for _, m, _ in outs]
    print(f"GAN {label} sampling: {GAN_POSES} frames {size}² through "
          f"make_gan_full_renderer: {ms:.2f} ms/frame, peak "
          f"{peak / 2**30:.3f} GiB allocated, kernel launches {launches} "
          f"({launches / GAN_POSES:g} a frame; by key {by}), other kernel "
          f"{others}, foreground shares {fg}")
    return (lambda _t, seed: frame(0, seed)), ms, counts


def _gan_micro_loss(gen, dis, config, micro, **randoms):
    """The G step's loss of one micro-batch (training/gan.py::g_step)."""
    from enarf_gan_tpu_torch.training.losses import (adv_loss_gen,
                                                     nerf_patch_loss,
                                                     triplane_l2_reg)
    img, mask, aux = gen(micro["pose_to_camera"], micro["pose_to_world"],
                         micro["bone_length"], randoms.pop("z"),
                         micro["inv_intrinsics"], train=True, **randoms)
    loss = adv_loss_gen(dis(img), config.loss.adv_loss_type) + \
        nerf_patch_loss(mask, micro["bone_mask"], gen.background_ratio,
                        coef=float(config.loss.bone_guided_coef))
    return loss + triplane_l2_reg(aux["tri_plane_feature"]) * \
        float(config.loss.tri_plane_reg_coef)


def phase_gan_train(gen, dis, config, batch, canonical, device):
    """The config's training on the tiled path: 1 warm-up and TIMED_STEPS
    timed iterations of the G step (n_accum_step micro-batches) and the D
    step; one R1 step timed apart after a warm-up one; profiles of one G
    step (each port kernel's device ms and launches, device time by kernel
    class) and of one R1 step. Losses must be finite."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin_kernel
    from enarf_gan_tpu_torch.training import gan
    real = batch["real_img"]
    poses = {k: v for k, v in batch.items() if k != "real_img"}
    bs = real.shape[0]
    rng = torch.Generator(device=device).manual_seed(SEED + 25)
    state = {k: v.clone() for k, v in gen.state_dict().items()}
    n_accum = int(config.n_accum_step)
    gen_opt, dis_opt = gan.init_gan_state(config, gen, dis, canonical)
    g_step, d_step, r1_step = gan.make_gan_steps(config, gen, dis, gen_opt,
                                                 dis_opt)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fake, _ = g_step(poses, rng)
    d_step(fake, real)
    torch.cuda.synchronize()
    print(f"GAN training: warm-up iteration {time.perf_counter() - t0:.2f} "
          f"s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TIMED_STEPS):
        fake, gm = g_step(poses, rng)
        metrics.append({**gm, **d_step(fake, real)})
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / TIMED_STEPS
    launches = {k.name: k.launches for k in _all_kernels()}
    by_m = dict(tilewin_kernel.KERNEL.launches_by)
    peak = torch.cuda.max_memory_allocated()
    r1_step(real)                        # warm-up: the first double backward
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rm = r1_step(real)
    torch.cuda.synchronize()
    r1_ms = (time.perf_counter() - t0) * 1e3
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    r1 = float(rm["r1_reg"])
    assert all(np.isfinite(v) for m in metrics for v in m.values()) and \
        np.isfinite(r1), (metrics, r1)
    assert launches["tilewin_combine"] > 0 and \
        launches["tilewin_combine_bwd"] > 0, launches
    assert launches["unirow_combine"] == 0 and \
        launches["unirow_combine_bwd"] == 0, launches
    print(f"GAN training (tiled): {s_iter:.3f} s/iter (G + D step) over "
          f"{TIMED_STEPS} iterations, batch {bs}, n_accum_step {n_accum}, "
          f"peak {peak / 2**30:.2f} GiB allocated; R1 step {r1_ms:.1f} ms "
          f"(r1 {r1:.4g}); losses "
          + "; ".join(", ".join(f"{k} {v:.4f}" for k, v in m.items())
                      for m in metrics)
          + f"; kernel launches a G step "
          + str({k: v / TIMED_STEPS for k, v in launches.items()})
          + f", tilewin by member count {by_m}")
    t0 = time.perf_counter()
    g_step(poses, rng)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3
    device_ms, n_launch, port = _profile(lambda: g_step(poses, rng),
                                         "GAN G step profile", ms_step,
                                         "G step")
    _profile(lambda: r1_step(real), "GAN R1 step profile", r1_ms, "R1 step")
    gen.load_state_dict(state)
    return {"s_iter": s_iter, "peak": peak, "n_accum": n_accum,
            "r1_ms": r1_ms, "launches": launches, "by_m": by_m,
            "ms_step": ms_step, "device_ms": device_ms, "kernels": port}


def phase_gan_exact_step(exact, dis, config, batch, canonical, device,
                         n_accum):
    """One G step of the exact twin (kernels 1 and 1b), after a warm-up,
    profiled: its kernels' launches and device ms a G step."""
    import torch
    from enarf_gan_tpu_torch.training import gan
    poses = {k: v for k, v in batch.items() if k != "real_img"}
    rng = torch.Generator(device=device).manual_seed(SEED + 27)
    state = {k: v.clone() for k, v in exact.state_dict().items()}
    config = _train_config(config, n_accum_step=n_accum)
    g_step = gan.make_gan_steps(
        config, exact, dis, *gan.init_gan_state(config, exact, dis,
                                                canonical))[0]
    g_step(poses, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    _, gm = g_step(poses, rng)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in _all_kernels()}
    peak = torch.cuda.max_memory_allocated()
    assert launches["unirow_combine"] > 0 and \
        launches["unirow_combine_bwd"] > 0, launches
    assert launches["tilewin_combine"] == 0 and \
        launches["tilewin_combine_bwd"] == 0, launches
    assert all(np.isfinite(float(v)) for v in gm.values()), gm
    print(f"GAN exact G step: {ms_step:.1f} ms, peak {peak / 2**30:.2f} GiB, "
          f"loss_gen {float(gm['loss_gen']):.4f}; kernel launches "
          f"{launches}")
    _, _, port = _profile(lambda: g_step(poses, rng), "GAN exact G step "
                          "profile", ms_step, "G step")
    exact.load_state_dict(state)
    return {"launches": launches, "kernels": port, "ms_step": ms_step}


def phase_gan_grad_check(gen, dis, config, batch, device, label, module,
                         name, plain, kernels, n_accum, fault=None):
    """The generator's parameter gradients of one micro-batch's G loss with
    the path's kernels (``kernels``: forward and backward) against the same
    loss with the plain combine in ``module.name``'s place under autograd,
    from the same draws and w_avg: relative L2 within GAN_GRAD_REL_L2 over
    all gradients together and over the tri-plane generator's (TRI_PLANE,
    the only ones the combine's backward produces); the worst parameters
    printed. ``fault`` = (module, name, faulty function) plants a fault in
    the kernels' path, which the tri-plane bound must reject. Returns the
    two relative L2s."""
    import torch
    from enarf_gan_tpu_torch.nerf.rendering import draw_fine_uniforms
    mb = batch["pose_to_camera"].shape[0] // n_accum
    micro = {k: v[:mb] for k, v in batch.items()}
    g = torch.Generator(device=device).manual_seed(SEED + 29)
    bg = gen.background_generator
    randoms = {
        "z": torch.randn((mb, 4 * gen.z_dim), generator=g, device=device),
        "draws": draw_fine_uniforms(gen.fine_draw_rows(mb),
                                    gen.nerf_params.Nf, g, device),
        "noise": [torch.randn(s, generator=g, device=device)
                  for s in bg.noise_shapes(mb)],
        "crop": (0, gen.size // 3)}
    w_avg = gen.nerf.tri_plane_gen.mapping.w_avg
    w_avg0 = w_avg.clone()

    def grads():
        gen.zero_grad(set_to_none=True)
        w_avg.copy_(w_avg0)
        dis.requires_grad_(False)
        try:
            loss = _gan_micro_loss(gen, dis, config, micro, **dict(randoms))
            loss.backward()
        finally:
            dis.requires_grad_(True)
        torch.cuda.synchronize()
        return float(loss), {k: p.grad.clone()
                             for k, p in gen.named_parameters()
                             if p.grad is not None}

    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    loss_k, gk = grads()
    ms_k = (time.perf_counter() - t0) * 1e3
    assert all(k.launches > b for k, b in zip(kernels, before)), label
    counts = [k.launches for k in kernels]
    t0 = time.perf_counter()
    with mock.patch.object(module, name, plain):
        loss_p, gp = grads()
    ms_p = (time.perf_counter() - t0) * 1e3
    assert [k.launches for k in kernels] == counts, \
        f"the plain {label} G loss launched a kernel"
    assert set(gk) == set(gp)

    def rel_l2(got, keys):
        num = sum(float((got[k] - gp[k]).double().pow(2).sum()) for k in keys)
        den = sum(float(gp[k].double().pow(2).sum()) for k in keys)
        return (num / den) ** 0.5

    tri = [k for k in gp if k.startswith(TRI_PLANE)]
    rel, rel_tri = rel_l2(gk, gp), rel_l2(gk, tri)
    worst = sorted(((float((gk[k] - gp[k]).norm() / gp[k].norm()), k)
                    for k in gp if float(gp[k].norm()) > 0), reverse=True)
    print(f"GAN {label} G-step gradients ({mb}-image micro-batch), kernels "
          f"vs plain combine: relative L2 {rel:.3e} over {len(gp)} "
          f"parameters, {rel_tri:.3e} over the {len(tri)} of {TRI_PLANE}* "
          f"(bound {GAN_GRAD_REL_L2:g} each); loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; worst "
          + ", ".join(f"{k} {e:.2e}" for e, k in worst[:3])
          + f"; {ms_k:.0f} ms with kernels, {ms_p:.0f} ms plain")
    assert rel <= GAN_GRAD_REL_L2 and rel_tri <= GAN_GRAD_REL_L2, \
        (label, rel, rel_tri)
    if fault is not None:
        with mock.patch.object(*fault):
            _, gf = grads()
        rel_fault = rel_l2(gf, tri)
        print(f"GAN {label} control: with {fault[1]} planted faulty, "
              f"{TRI_PLANE}* relative L2 {rel_fault:.3e} against the bound "
              f"{GAN_GRAD_REL_L2:g} (all parameters {rel_l2(gf, gp):.3e})")
        assert rel_fault > GAN_GRAD_REL_L2, \
            f"the {label} tri-plane bound passes a planted fault"
    gen.zero_grad(set_to_none=True)
    w_avg.copy_(w_avg0)
    return rel, rel_tri


def phase_gan(device, root):
    """The GAN slice: sampling on both paths (against the plain combine,
    tiled against exact, profiles), then training (tiled), the exact twin's
    G step, and the G-step gradient checks. Returns the numbers the kernels
    line reports."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel, unirow
    t0 = time.perf_counter()
    config, gen, exact, dis, batch, canonical = build_gan(device, root)
    frame_t, ms_t, counts_t = phase_gan_sample(gen, batch, device, "tiled",
                                               tilewin_kernel.KERNEL,
                                               unirow.KERNEL)
    frame_e, ms_e, counts_e = phase_gan_sample(exact, batch, device, "exact",
                                               unirow.KERNEL,
                                               tilewin_kernel.KERNEL)
    ref_e = phase_plain_render(frame_e, unirow, "unirow_combine",
                               unirow.gather_combine_texels_plain,
                               unirow.KERNEL, "GAN exact")
    ref_t = phase_plain_render(
        frame_t, tilewin, "tilewin_combine",
        lambda *a, mode=None: tilewin_kernel.tilewin_combine_texels_plain(*a),
        tilewin_kernel.KERNEL, "GAN tiled")
    phase_tiled_vs_exact(ref_t, ref_e)
    frames = {label: _profile(lambda f=f: f(0, 1), f"GAN {label} frame "
                              "profile", ms, "frame")
              for label, f, ms in (("tiled", frame_t, ms_t),
                                   ("exact", frame_e, ms_e))}
    del ref_e, ref_t
    torch.cuda.empty_cache()
    train = phase_gan_train(gen, dis, config, batch, canonical, device)
    torch.cuda.empty_cache()
    exact_step = phase_gan_exact_step(exact, dis, config, batch, canonical,
                                      device, train["n_accum"])
    torch.cuda.empty_cache()
    launch_backward = tilewin_kernel.launch_backward

    def mask_grads_zeroed(*args):
        """Kernel 2b with the gradient of the texels' mask lanes (the
        mask logits', from lane FEAT_BLOCK) set to 0: a planted fault."""
        dtexels, dxt, dxs = launch_backward(*args)
        dtexels[..., unirow.FEAT_BLOCK:] = 0
        return dtexels, dxt, dxs

    rel_t = phase_gan_grad_check(
        gen, dis, config, batch, device, "tiled", tilewin, "tilewin_combine",
        lambda *a, mode=None: tilewin_kernel.tilewin_combine_texels_plain(*a),
        (tilewin_kernel.KERNEL, tilewin_kernel.KERNEL_BWD), train["n_accum"],
        fault=(tilewin_kernel, "launch_backward", mask_grads_zeroed))
    torch.cuda.empty_cache()
    rel_e = phase_gan_grad_check(
        exact, dis, config, batch, device, "exact", unirow, "unirow_combine",
        unirow.gather_combine_texels_plain,
        (unirow.KERNEL, unirow.KERNEL_BWD), train["n_accum"])
    del gen, exact, dis, batch
    torch.cuda.empty_cache()
    print(f"GAN phases done in {time.perf_counter() - t0:.1f} s")
    return {"frames": frames, "frame_counts": {"tiled": counts_t,
                                               "exact": counts_e},
            "train": train, "exact_step": exact_step,
            "grad_rel": {"tiled": rel_t, "exact": rel_e}}


def _repo_path(rel):
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def _read_config(pair, replace):
    """The config pair read by the port's YAML reader
    (``config.yaml_config``), with the keys of ``replace`` ("a.b.c": value)
    set; prints each replacement."""
    from enarf_gan_tpu_torch.config import yaml_config
    config = yaml_config(*map(_repo_path, pair))
    print(f"{pair[0]} over {pair[1]} (the port's YAML reader), replaced:")
    for key, value in replace.items():
        node = config
        *path, leaf = key.split(".")
        for k in path:
            node = node[k]
        print(f"  {key}: {node.get(leaf)!r} -> {value!r}")
        node[leaf] = value
    return config


def _sample_data(path, items):
    """A demo's ``sample_data.npz``: the poses, bone lengths and cameras of
    dataset ``items``."""
    import os
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "sample_data.npz"),
             **{k: np.stack([item[k] for item in items])
                for k in ("pose_3d", "bone_length", "intrinsics")})


def phase_dso_cli(device, root):
    """The published float32 DSO config through the port's CLI functions:
    ``configs/DSO_train/ZJU/313_denarf.yml`` trained on a synthetic 512²
    cache of 16 images (``train_DSO.train``: CLI_ITERS iterations, the
    first a warm-up, the next TIMED_STEPS timed, the last profiled;
    kernels 1f and 1bf, no other unirow or tilewin kernel; the model's
    seeded weights perturbed by 0.3 as in phase 6), then
    ``train_DSO.validation`` on 2 frames (PSNR, SSIM, cropped) and the demo
    (``DSO_demo.demo``, ``configs/DSO_demo/ZJU/313_denarf.yml``) on 2
    samples at 512², its PNGs read back."""
    import os
    import torch
    from enarf_gan_tpu_torch import DSO_demo, train_DSO
    from enarf_gan_tpu_torch.data.datasets import SSODataset
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.training import dso
    from enarf_gan_tpu_torch.utils.logging import read_png
    train_root, val_root = (os.path.join(root, d) for d in ("train", "val"))
    config = _read_config(DSO_F32_CONFIG, {
        "out_root": root, "dataset.train.data_root": train_root,
        "dataset.val.train.data_root": train_root,
        "dataset.val.novel_view.data_root": val_root,
        "dataset.val.novel_pose.data_root": val_root + "_pose"})
    nerf = config.generator_params.nerf_params
    assert "plane_sample_dtype" not in nerf
    size = config.dataset.image_size
    t0 = time.perf_counter()
    make_synthetic_human_cache(train_root, size=size, n_frames=CLI_FRAMES,
                               n_camera=CLI_CAMERAS)
    for seed, key in ((1, "novel_view"), (2, "novel_pose")):
        make_synthetic_human_cache(config.dataset.val[key].data_root,
                                   size=size, n_frames=1, n_camera=1,
                                   seed=seed)
    print(f"synthetic {size}² caches: {CLI_FRAMES * CLI_CAMERAS} training "
          f"images, 2 validation frames ({time.perf_counter() - t0:.1f} s)")
    print(f"  iterations: num_iter {config.num_iter} -> {CLI_ITERS} "
          f"(--iterations); bs {config.dataset.bs}, "
          f"{config.dataset.image_size}², {config.generator_params.ray_batchsize}"
          f" rays an image, Nc {nerf.Nc} + Nf {nerf.Nf}, float32 planes")

    real, build = dso.make_train_step, dso.build_generator
    ends, counts, peak, prof = [], [], [], {}

    def perturbed_build(*a, **k):
        """The CLI's model with its seeded weights perturbed by 0.3: a fresh
        DSO model renders an all-zero mask, and a few steps do not change
        that, so the demo's PNGs would be constant."""
        gen = build(*a, **k)
        g = torch.Generator().manual_seed(SEED + 29)
        with torch.no_grad():
            for p in gen.parameters():
                p.add_(0.3 * torch.randn(p.shape, generator=g).to(p.device))
        return gen

    def timed_step_factory(*a, **k):
        step = real(*a, **k)

        def timed(*sa, **sk):
            if len(ends) == CLI_ITERS - 1:           # the profiled step
                ms = (ends[TIMED_STEPS] - ends[0]) / TIMED_STEPS * 1e3
                out = {}
                prof["profile"] = _profile(
                    lambda: out.update(m=step(*sa, **sk)),
                    "CLI float32 training profile", ms, "step")
                m = out["m"]
            else:
                m = step(*sa, **sk)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if len(ends) == 1:                       # after the warm-up
                torch.cuda.reset_peak_memory_stats()
            if len(ends) == 1 + TIMED_STEPS:
                peak.append(torch.cuda.max_memory_allocated())
            counts.append((unirow.KERNEL_F32.launches,
                           unirow.KERNEL_BWD_F32.launches))
            return m

        return timed

    _reset_all_counts()
    with mock.patch.object(dso, "make_train_step", timed_step_factory), \
            mock.patch.object(dso, "build_generator", perturbed_build):
        gen, _, history = train_DSO.train(config, device, CLI_ITERS)
    launches = {k.name: k.launches for k in _all_kernels()}
    s_iter = (ends[TIMED_STEPS] - ends[0]) / TIMED_STEPS
    f_step = (counts[TIMED_STEPS][0] - counts[0][0]) / TIMED_STEPS
    b_step = (counts[TIMED_STEPS][1] - counts[0][1]) / TIMED_STEPS
    assert len(history) == CLI_ITERS and np.isfinite(history).all(), history
    assert launches["unirow_combine_f32"] > 0 and \
        launches["unirow_combine_bwd_f32"] > 0, launches
    assert all(v == 0 for k, v in launches.items() if not k.endswith("_f32")), \
        launches
    assert gen.nerf.texel_dtype == torch.float32
    out_dir = train_DSO.out_dir_of(config)
    snap = os.path.join(out_dir, "snapshot_latest.pth")
    assert os.path.exists(snap), snap
    print(f"CLI float32 training (313_denarf.yml): {s_iter:.3f} s/iter over "
          f"{TIMED_STEPS} iterations (the loader's batches included), peak "
          f"{peak[0] / 2**30:.2f} GiB allocated, losses "
          + ", ".join(f"{x:.5f}" for x in history)
          + f"; kernel launches {launches}; a step: 1f {f_step:g}, 1bf "
          f"{b_step:g}; snapshot {snap}")
    del gen
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    val = train_DSO.validation(config, device)
    val_s = time.perf_counter() - t0
    assert set(val) == {"novel_view", "novel_pose"}, val
    for key, metrics in val.items():
        assert np.isfinite(metrics["color_PSNR"]) and \
            np.isfinite(metrics["color_SSIM"]), val
    print(f"CLI --validation on 2 frames (crop on, PSNR and SSIM): "
          f"{val_s:.2f} s; " + "; ".join(
              f"{k} PSNR {m['color_PSNR']:.3f} dB, SSIM {m['color_SSIM']:.4f}"
              for k, m in val.items()))

    demo_cfg = _read_config(DEMO_F32_CONFIG, {
        "out_root": root, "sample_path": os.path.join(root, "samples"),
        "canonical_pose_path": os.path.join(train_root, "canonical.npy")})
    _sample_data(demo_cfg.sample_path,
                 [SSODataset(config.dataset.val[k], size=size)[0]
                  for k in ("novel_view", "novel_pose")])
    _reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = DSO_demo.demo(demo_cfg, device)
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) / len(paths) * 1e3
    frame_launches = unirow.KERNEL_F32.launches / len(paths)
    assert unirow.KERNEL_BWD_F32.launches == 0 and frame_launches > 0
    for p in paths:
        img = read_png(p)
        assert img.shape == (size, size, 3) and img.min() < img.max(), \
            (p, img.shape, img.min(), img.max())
    print(f"CLI demo: {len(paths)} samples at {size}² read back from their PNGs "
          f"({[os.path.basename(p) for p in paths]}), {ms_frame:.1f} ms a "
          f"sample with its snapshot load spread over them, kernel 1f "
          f"launches a frame {frame_launches:g}")
    device_ms, _, port = prof["profile"]
    return {"s_iter": s_iter, "peak_gib": peak[0] / 2**30,
            "launches": launches, "step_launches": (f_step, b_step),
            "step_ms": (port.get("unirow_combine_kernel", (0.0, 0))[0],
                        port.get("unirow_combine_bwd_kernel", (0.0, 0))[0]),
            "frame_launches": frame_launches, "ms_frame": ms_frame,
            "val": val}


def phase_gan_f32(device, root):
    """The float32 GAN of ``configs/enarfgan_train/AIST/config.yml`` read by
    the port's YAML reader (data roots and ``out_root`` replaced): seeded
    weights perturbed by 0.3, 1 warm-up and GAN_F32_TIMED timed G + D
    iterations through ``training.gan`` (kernels 1f and 1bf, no other
    unirow or tilewin kernel), a profile of a G step, and one 128² sample
    through ``make_gan_full_renderer``."""
    import torch
    from enarf_gan_tpu_torch.data.datasets import (HumanDataset,
                                                   HumanPoseDataset)
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.data.loader import collate
    from enarf_gan_tpu_torch.models.generator import (make_gan_full_renderer,
                                                      register_canonical_pose)
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.training import gan
    t0 = time.perf_counter()
    config = _read_config(GAN_F32_CONFIG, {
        "out_root": root, "dataset.train.data_root": root,
        "dataset.train.pose_prior_root": root})
    nerf = config.generator_params.nerf_params
    assert "plane_sample_dtype" not in nerf and "tile_patch" not in nerf
    size, bs = config.dataset.image_size, config.dataset.bs
    make_synthetic_human_cache(root, size=size, n_frames=3, n_camera=4)
    img_ds = HumanDataset(config.dataset.train, size=size,
                          return_bone_params=False, num_repeat_in_epoch=1)
    pose_ds = HumanPoseDataset(size=size,
                               data_root=config.dataset.train.pose_prior_root,
                               num_repeat_in_epoch=1)
    batch = gan.prepare_gan_batch(collate([img_ds[i] for i in range(bs)]),
                                  collate([pose_ds[i] for i in range(bs)]),
                                  device)
    g = torch.Generator().manual_seed(SEED + 31)
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents,
                                device, generator=g)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(device))
    register_canonical_pose(gen, pose_ds.canonical_pose, "center_fixed",
                            pose_ds.parents)
    assert gen.nerf.texel_dtype == torch.float32 and \
        not gen.nerf.supports_tiled_sampling()
    real = batch["real_img"]
    poses = {k: v for k, v in batch.items() if k != "real_img"}
    rng = torch.Generator(device=device).manual_seed(SEED + 33)
    g_step, d_step, _ = gan.make_gan_steps(
        config, gen, dis, *gan.init_gan_state(config, gen, dis,
                                              pose_ds.canonical_pose))
    print(f"GAN float32 (config.yml): bs {bs} x {size}², n_accum_step "
          f"{config.n_accum_step}, z_dim {gen.z_dim}, "
          f"{sum(p.numel() for p in gen.parameters())} generator parameters; "
          f"built in {time.perf_counter() - t0:.1f} s")
    fake, _ = g_step(poses, rng)
    d_step(fake, real)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(GAN_F32_TIMED):
        fake, gm = g_step(poses, rng)
        metrics.append({**gm, **d_step(fake, real)})
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / GAN_F32_TIMED
    launches = {k.name: k.launches for k in _all_kernels()}
    peak = torch.cuda.max_memory_allocated()
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    assert all(np.isfinite(v) for m in metrics for v in m.values()), metrics
    assert launches["unirow_combine_f32"] > 0 and \
        launches["unirow_combine_bwd_f32"] > 0, launches
    assert all(v == 0 for k, v in launches.items() if not k.endswith("_f32")), \
        launches
    print(f"GAN float32 training: {s_iter:.3f} s/iter (G + D) over "
          f"{GAN_F32_TIMED} iterations, peak {peak / 2**30:.2f} GiB "
          f"allocated; losses " + "; ".join(
              ", ".join(f"{k} {v:.4f}" for k, v in m.items())
              for m in metrics)
          + f"; kernel launches a G step "
          + str({k: v / GAN_F32_TIMED for k, v in launches.items()}))
    t0 = time.perf_counter()
    g_step(poses, rng)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3
    device_ms, _, port = _profile(lambda: g_step(poses, rng),
                                  "GAN float32 G step profile", ms_step,
                                  "G step")
    render = make_gan_full_renderer(gen)
    z = torch.randn((1, 4 * gen.z_dim), generator=g).to(device)
    _reset_all_counts()
    color, mask, disp = render(poses["pose_to_camera"][:1],
                               poses["bone_length"][:1], z,
                               poses["inv_intrinsics"][:1],
                               generator=torch.Generator(
                                   device=device).manual_seed(1))
    torch.cuda.synchronize()
    assert color.shape == (3, size, size) and mask.shape == (size, size)
    assert all(bool(torch.isfinite(x).all()) for x in (color, mask, disp))
    assert float(mask.sum()) > 0, "empty GAN foreground mask"
    assert unirow.KERNEL_F32.launches > 0
    print(f"GAN float32 sample {size}²: foreground share "
          f"{float((mask > 0.05).float().mean()):.3f}, kernel 1f launches "
          f"{unirow.KERNEL_F32.launches}")
    return {"s_iter": s_iter, "peak_gib": peak / 2**30,
            "step_launches": (launches["unirow_combine_f32"] / GAN_F32_TIMED,
                              launches["unirow_combine_bwd_f32"]
                              / GAN_F32_TIMED),
            "step_ms": (port.get("unirow_combine_kernel", (0.0, 0))[0],
                        port.get("unirow_combine_bwd_kernel", (0.0, 0))[0]),
            "g_step_device_ms": device_ms,
            "frame_launches": unirow.KERNEL_F32.launches}


def float32_study(device, root):
    """``--float32``: kernels 1f and 1bf against their plain twins (phase
    2's shapes), then the published float32 configs through the port's CLI
    functions and ``training.gan`` (phase 8's first half)."""
    import os
    import torch
    phase_unirow_check(device, torch.float32)
    phase_unirow_bwd_check(device, torch.float32)
    torch.cuda.empty_cache()
    phase_dso_cli(device, os.path.join(root, "cli"))
    torch.cuda.empty_cache()
    phase_gan_f32(device, os.path.join(root, "gan32"))


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
               "--probes": lambda device, root: probe_sweeps(device),
               "--modes": modes_study,
               "--gan": phase_gan,
               "--float32": float32_study}
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
    k1f = phase_unirow_check(device, torch.float32)
    k1bf = phase_unirow_bwd_check(device, torch.float32)
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
        gan = phase_gan(device, os.path.join(root, "gan"))
        torch.cuda.empty_cache()
        cli = phase_dso_cli(device, os.path.join(root, "cli"))
        torch.cuda.empty_cache()
        gan32 = phase_gan_f32(device, os.path.join(root, "gan32"))
        torch.cuda.empty_cache()
        print(f"float32 phases done at {time.perf_counter() - t_start:.1f} s")
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
    # the GAN path's (phase_gan): launches and device ms of each kernel in
    # one G step (tiled: kernels 2, 2b, 3; the exact twin: 1, 1b) and in
    # one full-image frame (tiled: 2, 2b, 3; exact: 1, 1b): launches from
    # the counts of the timed steps and frames, ms from their profiles
    gs, ge = gan["train"], gan["exact_step"]
    ft, fe = gan["frames"]["tiled"][2], gan["frames"]["exact"][2]
    ct, ce = gan["frame_counts"]["tiled"], gan["frame_counts"]["exact"]

    def ms_of(profile, kernel):
        return profile.get(kernel, (0.0, 0))[0]

    k1.update(gan_step_launches=ge["launches"]["unirow_combine"],
              gan_step_ms=ms_of(ge["kernels"], "unirow_combine_kernel"),
              gan_frame_launches=ce["unirow_combine"],
              gan_frame_ms=ms_of(fe, "unirow_combine_kernel"))
    k1b.update(gan_step_launches=ge["launches"]["unirow_combine_bwd"],
               gan_step_ms=ms_of(ge["kernels"], "unirow_combine_bwd_kernel"),
               gan_frame_launches=ce["unirow_combine_bwd"],
               gan_frame_ms=ms_of(fe, "unirow_combine_bwd_kernel"),
               gan_grad_rel_l2=gan["grad_rel"]["exact"][0],
               gan_tri_plane_grad_rel_l2=gan["grad_rel"]["exact"][1])
    for m in (16, 4):
        k2[m] = dict(k2[m],
                     gan_step_launches=gs["by_m"].get(m, 0) / TIMED_STEPS,
                     gan_step_ms=ms_of(gs["kernels"],
                                       f"tilewin_combine_kernel<{m}>"),
                     gan_frame_launches=ct["by_m"].get(m, 0),
                     gan_frame_ms=ms_of(ft, f"tilewin_combine_kernel<{m}>"))
    k2b.update(gan_step_launches=gs["launches"]["tilewin_combine_bwd"]
               / TIMED_STEPS,
               gan_step_ms=ms_of(gs["kernels"], "tilewin_combine_bwd_kernel"),
               gan_frame_launches=ct["tilewin_combine_bwd"],
               gan_frame_ms=ms_of(ft, "tilewin_combine_bwd_kernel"),
               gan_grad_rel_l2=gan["grad_rel"]["tiled"][0],
               gan_tri_plane_grad_rel_l2=gan["grad_rel"]["tiled"][1],
               gan_s_iter=gs["s_iter"], gan_peak_gib=gs["peak"] / 2**30)
    k3_gan = {"gan_step_launches":
              gs["launches"]["tilewin_combine_modes"] / TIMED_STEPS,
              "gan_step_ms": ms_of(gs["kernels"],
                                   "tilewin_combine_modes_kernel"),
              "gan_frame_launches": ct["tilewin_combine_modes"],
              "gan_frame_ms": ms_of(ft, "tilewin_combine_modes_kernel")}

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
             "hat_step_peak_gib": k3_steps["hat"]["step_peak_gib"],
             **k3_gan}))
    # kernels 1f and 1bf: launches in the published float32 DSO config's
    # CLI training (the counts reset before it), a step's launches and
    # device ms (its profiled step), a 512² demo frame's, and the float32
    # GAN's G step
    for i, (name, k) in enumerate((("unirow_combine_f32 (kernel 1f)", k1f),
                                   ("unirow_combine_bwd_f32 (kernel 1bf, "
                                    "4 images' fine pass)", k1bf))):
        k.update(step_launches=cli["step_launches"][i],
                 step_ms=cli["step_ms"][i],
                 dso_cli_s_iter=cli["s_iter"],
                 dso_cli_peak_gib=cli["peak_gib"],
                 frame_launches=cli["frame_launches"] if i == 0 else 0,
                 gan_step_launches=gan32["step_launches"][i],
                 gan_step_ms=gan32["step_ms"][i],
                 gan_s_iter=gan32["s_iter"], gan_peak_gib=gan32["peak_gib"],
                 gan_g_step_device_ms=gan32["g_step_device_ms"])
        entries.insert(2 + i, entry(
            name, "unirow_combine_bwd.cu" if i else "unirow_combine.cu",
            "enarf_gan_tpu/ops/unirow.py:" + ("234" if i else "115"),
            cli["launches"]["unirow_combine_bwd_f32" if i
                            else "unirow_combine_f32"],
            {"replaces_float32": "enarf_gan_tpu/ops/quadtable.py:111 "
             + ("(its XLA VJP)" if i else "(XLA)"), **k}))
    print(json.dumps({"kernels": entries + probes}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
