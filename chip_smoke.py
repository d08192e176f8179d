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
   the exact sampler) through the port's GAN CLI,
   ``train_ENARF_GAN.main``: 1 warm-up, 2 timed and 1 profiled G + D
   iterations (the loader's batches included), its image grids and
   snapshot, and one 128² sample. Then the demo CLI,
   ``ENARF_GAN_demo.main``, on ``configs/enarfgan_demo/AIST/enarfgan.yml``
   (only ``out_root``, ``out`` and ``sample_path`` replaced; the synthetic
   canonical pose at its default path) loads that snapshot and writes 2
   samples with ``--black_bg --mesh`` at the default voxel of 0.003: a 667³
   density grid through kernel 1f, marching tetrahedra and the rasteriser
   on the card, the PNGs read back; seconds of the grid, the iso-surface
   and the rasteriser, ms a frame, the peak, 1f's launches a mesh, the
   volume's range, active cubes, vertices and faces; one chunk of the grid
   and one demo frame against the plain combine; profiles of a grid and a
   frame; and, where the model's volume crosses mesh_th nowhere, the
   iso-surface and rasteriser on an analytic ball on the same grid.
Phase "preprocess" (between 8 and 9): the port's data preparation. It
   says first that the pipelines' image stages (cv2) do not run on a
   machine without cv2, and that the CPU tests hold them to the JAX
   scripts. (a) A full-size synthetic SMPL model for each gender (6,890
   vertices, 10 betas, a non-negative, row-normalised J_regressor) and
   the port's ``prepare_canonical_pose`` CLI on the card, held to the
   float64 numpy forward kinematics within 1e-5. (b) AIST++'s pose stage
   as ``read_frames`` calls it (``AIST.preprocess.view_pose_stage``: the
   forward kinematics of a sequence's whole 60 fps motion, the model sent
   anew, and the crop geometry, once a camera view) over one dancer's
   share of the release, 47 sequences of 798 motion frames in 9 views;
   and ZJU 313's pose stage (1,176 train frames and the two test caches'
   40 and 10, each frame with its own betas and root transform); each
   held to the plain version within 1e-5, with ms, poses a second and the
   peak. (c)
   The port's ``prepare_sample_data`` CLI on phase 8's 512² cache, then
   the demo (``DSO_demo.demo``) on that ``sample_data.npz`` with phase 8's
   snapshot: finite frames, a non-empty mask, kernel 1f's launches.
9. The evaluation CLIs of ``enarf_gan_tpu_torch.evaluation`` score that
   float32 GAN snapshot at full width (kernel 1f on every generated
   batch): ``compute_fid`` on ``config.yml`` (INCEPTION_WEIGHTS_NPZ=
   random:0, a synthetic AIST-layout cache of 64 frames at 128², 256
   samples in batches of 16, ``--black_bg``), ``compute_PCK`` with the
   ``projected`` and ``stub`` estimators (64 samples), and
   ``compute_depth`` on ``configs/enarfgan_train/SURREAL/config.yml`` (the
   same generator) over a synthetic depth cache of 16 items; each CLI's
   seconds, images a second, 1f launches, peak and metric; Inception's ms
   a batch of 16, a profile of an FID batch, and one evaluation frame
   through 1f against the plain combine (phase 4's bounds).
Phase "variants" (between 9 and 10): the model variants through the
   port's CLI functions, the published configs read as in phase 8 with the
   one variant key replaced. (a) ``configs/DSO_train/default.yml`` over
   itself, the MLP NARF (narf, hidden 32, 128², bs 6, 4096 rays an image,
   Nc 48 + Nf 48) trained on a synthetic cache of 8 images (1 warm-up, 3
   timed and 1 profiled iteration: s/iter, peak, the step's device ms by
   class), tnarf and dnarf (1 + 2 iterations each), a 128² frame of each,
   ``--validation`` on 2 frames and ``DSO_demo.demo`` on
   ``configs/DSO_demo/default.yml`` (2 samples of that config's own
   view-independent model, PNGs read back): no port kernel may launch.
   (b) The float32 ``config.yml`` GAN with ``constant_trimask``,
   ``selector_mlp`` and ``no_selector`` each, through
   ``train_ENARF_GAN.main`` (1 warm-up, 2 timed and 1 profiled iteration)
   and one 128² sample: ``constant_trimask`` launches kernels 1f and 1bf,
   its frame is held to the plain combine's (phase 4's bounds) and its
   G-step gradients to the plain combine's; the selector variants launch
   no kernel and print the dense sampler's (``F.grid_sample``) share of a
   G step. (c) ``constant_trimask`` on the bf16 tiled ``config_tpu.yml``:
   one G step (kernels 2 and 2b) and its gradients against the plain
   combine's. (d) On (b)'s ``constant_trimask`` weights, a 128² frame
   sampled densely (max_bones_per_point 23, plain) against the candidate
   path's (kernel 1f): reported, not gated.
10. Overfits one 64² frame for 200 iterations on both paths at full width:
   the PSNR must beat the blank frame's by more than 2 dB.
Phase "tools" (last): the port's measurement tools
   (``enarf_gan_tpu_torch.tools``) at full width through their ``main``:
   ``frame_ablate`` (phase 3's 128² frame on both paths in full, under
   ENARF_ABLATE=sampler, where it must launch no kernel 1 or 2, and under
   ENARF_ABLATE=heads, where it must launch the full frame's kernels; host
   and device ms and the split), ``frame_parts`` (the frame's pieces and
   the sampler's stages alone), ``production`` (the bench model's DSO step
   at 512², batch 16, and a 1024² demo frame in 8,192-ray chunks, each
   path launching its own kernel), ``gan_step`` (the G, D and R1 steps at
   the JAX tool's bs 4 in 4 micro-batches, tiled, which must launch
   kernels 2 and 2b) and ``diag_learning`` (phase 10's tiled run from seed
   2 with its three stages; the forced-density render must cover the
   fixture's mask); the 128² frame's tools at 3 frames a variant or
   piece, the others at cut counts of steps and frames.

The second-to-last line is a JSON record of the kernels, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line; so does a machine without a CUDA device.

    python3 chip_smoke.py --learn-spread | --learn-collapse | --learn-gradcheck

run only phase 1 and one study of phase 10's spread from run to run (3-8
minutes each on an H100): each path learning twice from each of three seeds
(PSNR through its own and the exact renderer, the loss trajectories'
divergence); repeated runs from one seed with the kernels and with the plain
combine; and the parameter gradients along learning, kernels against the
plain combine.

    python3 chip_smoke.py --gan

runs only phase 1 and phase 7 (about a minute on an H100).

    python3 chip_smoke.py --float32

runs phase 1, kernels 1f and 1bf's checks (phase 2) and the float32
configs' runs through the port's CLIs (phase 8: DSO training, validation
and demo; GAN training and the GAN demo with its meshes; phase 9: the
evaluation CLIs on that GAN).

    python3 chip_smoke.py --variants

runs phase 1 and phase "variants" (about two minutes on an H100).

    python3 chip_smoke.py --preprocess

runs phase 1, phase 8's DSO CLI run and phase "preprocess" (about 75 s
on an H100).

    python3 chip_smoke.py --modes

runs phase 1, kernel 2's and kernel 3's checks at the fine chunk (phase
2), and the tiled training steps of phase 6 in the hat mode and in each of
kernel 3's modes (s/iter and peak memory a mode; a few minutes on an H100).

    python3 chip_smoke.py --tools

runs phase 1 and phase "tools" at the JAX tools' repetitions (REPS 3,
BENCH_ITERS 30, BENCH_REPS 3, GAN_ITERS 3; a few minutes on an H100).

    python3 chip_smoke.py --probes

runs phase 1 and every probe module's full sweep (row widths x table sizes
x index order, A2 at 1, 8, 64 and 1,024 rows a warp, A3 by table height
from 384 to 196,608 rows in float32 and bf16 on the kept design, ring
depths, B3 at its ragged shapes), one JSON line a measurement.
"""
import contextlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

from enarf_gan_tpu_torch.tools.benchkit import (port_kernels as _all_kernels,
                                               reset_launches as
                                               _reset_all_counts)
from enarf_gan_tpu_torch.utils.introspect import (card as _card,
                                                  profile_by_class)

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
# the published demo config of the float32 GAN, and its samples
GAN_DEMO_CONFIG = ("configs/enarfgan_demo/AIST/enarfgan.yml",
                   "configs/enarfgan_demo/default.yml")
DEMO_SAMPLES = 2
DEMO_VOXEL = 0.003        # the demo's default --mesh_voxel_size: a 667³ grid
PROFILED_CHUNKS = 64      # chunks of a mesh grid in its profile
# phase 9: the evaluation CLIs on phase 8's float32 GAN snapshot; the
# SURREAL config's generator is AIST config.yml's (the files differ only in
# out and data_root)
SURREAL_F32_CONFIG = ("configs/enarfgan_train/SURREAL/config.yml",
                      "configs/enarfgan_train/default.yml")
EVAL_FRAMES, EVAL_CAMERAS = 16, 4   # the synthetic AIST-layout cache: 64
FID_SAMPLES, FID_BATCH = 256, 16
PCK_SAMPLES = 64
DEPTH_ITEMS = 16                    # the synthetic SURREAL depth cache
INCEPTION_WEIGHTS = "random:0"      # no Inception weights in the repository
# phase "variants": configs/DSO_train/default.yml's MLP NARF over itself
# (use_triplane False, narf, hidden 32, Nc 48 + Nf 48, 128², bs 6, 4096 rays
# an image) and its model types, the demo's default.yml; the tri-plane
# variants on the float32 config.yml GAN and constant_trimask on the bf16
# tiled config_tpu.yml GAN
MLP_CONFIG = ("configs/DSO_train/default.yml", "configs/DSO_train/default.yml")
MLP_DEMO_CONFIG = ("configs/DSO_demo/default.yml",
                   "configs/DSO_demo/default.yml")
MLP_FRAMES, MLP_CAMERAS = 2, 4    # the synthetic 128² training cache: 8
MLP_TYPES_TIMED = 2               # tnarf, dnarf: 1 warm-up + 2 timed
GAN_VARIANTS = ("constant_trimask", "selector_mlp", "no_selector")
DENSE_BONES = 23                  # max_bones_per_point >= K: dense sampling
# phase "preprocess": synthetic SMPL models at full size; AIST++'s pose
# stage as read_frames calls it, once a video: a dancer's share of the
# release (1,408 sequences of 30 dancers, 5.2 hours at 60 fps, 9 views:
# Li et al., "AI Choreographer", ICCV 2021), each sequence at the mean
# length, 5.2 h x 3600 s x 60 / 1,408 = 798 motion frames, its videos at
# 1920x1080 decoded at 3 fps; ZJU subject 313's frames (1,176 train, 294
# test); the demo's samples from phase 8's cache
SMPL_VERTICES, SMPL_BETAS = 6890, 10
AIST_SEQUENCES, AIST_VIEWS, AIST_SEQ_FRAMES = 47, 9, 798
AIST_HW, AIST_FOCAL, AIST_DISTANCE = (1080, 1920), 1500.0, 500.0  # px, cm
ZJU_313_FRAMES = (1176, 294)
PREP_SAMPLES = 2
PREP_FK_TOL = 1e-5        # float32 transforms against the float64 plain
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
    print(f"card: {_card()}")
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
    return profile_by_class(lambda: frame(0.5, 1), f"{label} profile",
                            ms_frame, "frame")


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
    device_ms, _, port = profile_by_class(lambda: step(batch, rng),
                                          f"{label} training profile",
                                          ms_step, "step")
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


def build_gan(device, root, **nerf):
    """The config_tpu.yml GAN (tiled, kernels 2 and 2b; ``nerf`` overrides
    its nerf_params) with seeded weights perturbed by 0.3, its exact twin
    (tile_patch 0, kernels 1 and 1b) with the same weights, and a batch of
    12 from a synthetic 128² cache of 12 frames (3 poses x 4 cameras):
    real images and the pose prior's poses and bone masks."""
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
    config = _train_config(GAN_CONFIG, **{
        "dataset.train.data_root": root,
        **{f"generator_params.nerf_params.{k}": v for k, v in nerf.items()}})
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
    device_ms, n_launch, port = profile_by_class(
        lambda: g_step(poses, rng), "GAN G step profile", ms_step, "G step")
    profile_by_class(lambda: r1_step(real), "GAN R1 step profile", r1_ms,
                     "R1 step")
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
    _, _, port = profile_by_class(lambda: g_step(poses, rng),
                                  "GAN exact G step profile", ms_step,
                                  "G step")
    exact.load_state_dict(state)
    return {"launches": launches, "kernels": port, "ms_step": ms_step}


def phase_gan_grad_check(gen, dis, config, batch, device, label, module,
                         name, plain, kernels, n_accum, fault=None,
                         tri_plane=(TRI_PLANE,)):
    """The generator's parameter gradients of one micro-batch's G loss with
    the path's kernels (``kernels``: forward and backward) against the same
    loss with the plain combine in ``module.name``'s place under autograd,
    from the same draws and w_avg: relative L2 within GAN_GRAD_REL_L2 over
    all gradients together and over those the combine's backward reaches
    (the parameters named with a prefix of ``tri_plane``: the tri-plane
    generator's, TRI_PLANE, and a constant mask plane's); the worst
    parameters printed. ``fault`` = (module, name, faulty function) plants a fault in
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
    w_avg = gen.nerf.plane_generator.mapping.w_avg
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

    tri = [k for k in gp if k.startswith(tri_plane)]
    rel, rel_tri = rel_l2(gk, gp), rel_l2(gk, tri)
    worst = sorted(((float((gk[k] - gp[k]).norm() / gp[k].norm()), k)
                    for k in gp if float(gp[k].norm()) > 0), reverse=True)
    print(f"GAN {label} G-step gradients ({mb}-image micro-batch), kernels "
          f"vs plain combine: relative L2 {rel:.3e} over {len(gp)} "
          f"parameters, {rel_tri:.3e} over the {len(tri)} of "
          f"{', '.join(p + '*' for p in tri_plane)} "
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
    frames = {label: profile_by_class(lambda f=f: f(0, 1),
                                      f"GAN {label} frame profile", ms,
                                      "frame")
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


def _cli_train(config, device, timed, label, profile=True, seed=SEED + 29):
    """``config`` trained through ``train_DSO.train`` (the CLI's loop, its
    loader included): 1 warm-up, ``timed`` timed and, with ``profile``, 1
    profiled iteration, the model's seeded weights perturbed by 0.3 (a
    fresh DSO model renders an all-zero mask, and a few steps do not
    change that). Returns the model, the loss history, s/iter and the peak
    memory of the timed iterations, every kernel's launches in all and a
    step, and the profile (``profile_by_class``'s)."""
    import torch
    from enarf_gan_tpu_torch import train_DSO
    from enarf_gan_tpu_torch.training import dso
    real, build = dso.make_train_step, dso.build_generator
    iters = 1 + timed + bool(profile)
    ends, counts, peak, prof = [], [], [], {}

    def perturbed_build(*a, **k):
        gen = build(*a, **k)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in gen.parameters():
                p.add_(0.3 * torch.randn(p.shape, generator=g).to(p.device))
        return gen

    def timed_step_factory(*a, **k):
        step = real(*a, **k)

        def timed_step(*sa, **sk):
            if profile and len(ends) == iters - 1:   # the profiled step
                ms = (ends[timed] - ends[0]) / timed * 1e3
                out = {}
                prof["profile"] = profile_by_class(
                    lambda: out.update(m=step(*sa, **sk)), label, ms, "step")
                m = out["m"]
            else:
                m = step(*sa, **sk)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if len(ends) == 1:                       # after the warm-up
                torch.cuda.reset_peak_memory_stats()
            if len(ends) == 1 + timed:
                peak.append(torch.cuda.max_memory_allocated())
            counts.append({k.name: k.launches for k in _all_kernels()})
            return m

        return timed_step

    _reset_all_counts()
    with mock.patch.object(dso, "make_train_step", timed_step_factory), \
            mock.patch.object(dso, "build_generator", perturbed_build):
        gen, _, history = train_DSO.train(config, device, iters)
    assert len(history) == iters and np.isfinite(history).all(), history
    return {"gen": gen, "history": history,
            "s_iter": (ends[timed] - ends[0]) / timed, "peak": peak[0],
            "launches": {k.name: k.launches for k in _all_kernels()},
            "step_launches": {k: (counts[timed][k] - counts[0][k]) / timed
                              for k in counts[0]},
            "profile": prof.get("profile")}


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

    run = _cli_train(config, device, TIMED_STEPS,
                     "CLI float32 training profile")
    gen, history, launches = run["gen"], run["history"], run["launches"]
    s_iter, peak = run["s_iter"], run["peak"]
    f_step = run["step_launches"]["unirow_combine_f32"]
    b_step = run["step_launches"]["unirow_combine_bwd_f32"]
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
          f"{peak / 2**30:.2f} GiB allocated, losses "
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
    device_ms, _, port = run["profile"]
    return {"s_iter": s_iter, "peak_gib": peak / 2**30,
            "launches": launches, "step_launches": (f_step, b_step),
            "step_ms": (port.get("unirow_combine_kernel", (0.0, 0))[0],
                        port.get("unirow_combine_bwd_kernel", (0.0, 0))[0]),
            "frame_launches": frame_launches, "ms_frame": ms_frame,
            "val": val}


def _gan_cli_train(device, root, replace, label, seed=SEED + 31):
    """A float32 GAN config (GAN_F32_CONFIG with ``replace`` over the data
    roots and ``out_root``) through the port's CLI,
    ``train_ENARF_GAN.main``: seeded weights perturbed by 0.3, 1 warm-up,
    GAN_F32_TIMED timed and 1 profiled iteration (the loader's batches
    included); the synthetic 128² cache written at ``root``. Returns the
    config, the models, the history, s/iter, the peak, each kernel's
    launches over the timed G steps, 1f's and 1bf's a G step, the G step's
    ms (host) and its profile (``profile_by_class``'s)."""
    import torch
    from enarf_gan_tpu_torch import train_ENARF_GAN
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.training import gan
    config = _read_config(GAN_F32_CONFIG, {
        "out_root": root, "dataset.train.data_root": root,
        "dataset.train.pose_prior_root": root, **replace})
    size = config.dataset.image_size
    make_synthetic_human_cache(root, size=size, n_frames=3, n_camera=4)
    g = torch.Generator().manual_seed(seed)
    built, starts, g_ms, launches_g, peak, prof = [], [], [], [], [], {}
    real_build, real_steps = gan.build_models, gan.make_gan_steps

    def perturbed_build(*a, **k):
        """The CLI's models from a seeded generator, G's weights perturbed
        by 0.3: a fresh generator renders an empty foreground."""
        gen, dis = real_build(*a, generator=g, **k)
        with torch.no_grad():
            for p in gen.parameters():
                p.add_(0.3 * torch.randn(p.shape, generator=g).to(p.device))
        built.append((gen, dis))
        return gen, dis

    def timed_steps(*a, **k):
        g_step, d_step, r1_step = real_steps(*a, **k)

        def timed_g(*sa, **sk):
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
            if len(starts) == 2:                     # after the warm-up
                torch.cuda.reset_peak_memory_stats()
                _reset_all_counts()
            if len(starts) == 2 + GAN_F32_TIMED:     # the profiled step
                peak.append(torch.cuda.max_memory_allocated())
                prof["launches"] = {k.name: k.launches
                                    for k in _all_kernels()}
                out = {}
                prof["profile"] = profile_by_class(
                    lambda: out.update(r=g_step(*sa, **sk)),
                    f"{label} G step profile (CLI)",
                    float(np.mean(g_ms[1:])), "G step")
                return out["r"]
            before = unirow.KERNEL_F32.launches, unirow.KERNEL_BWD_F32.launches
            r = g_step(*sa, **sk)
            torch.cuda.synchronize()
            g_ms.append((time.perf_counter() - starts[-1]) * 1e3)
            launches_g.append((unirow.KERNEL_F32.launches - before[0],
                               unirow.KERNEL_BWD_F32.launches - before[1]))
            return r

        return timed_g, d_step, r1_step

    iters = 1 + GAN_F32_TIMED + 1
    with mock.patch.object(train_ENARF_GAN, "yaml_config",
                           lambda *a, **k: config), \
            mock.patch.object(gan, "build_models", perturbed_build), \
            mock.patch.object(gan, "make_gan_steps", timed_steps):
        _, _, history = train_ENARF_GAN.main(
            ["--config", _repo_path(GAN_F32_CONFIG[0]), "--default_config",
             _repo_path(GAN_F32_CONFIG[1]), "--iterations", str(iters)])
    torch.cuda.synchronize()
    assert len(history) == iters, history
    assert all(np.isfinite(v) for m in history for v in m.values()), history
    gen, dis = built[0]
    return {"config": config, "gen": gen, "dis": dis, "history": history,
            "s_iter": (starts[1 + GAN_F32_TIMED] - starts[1]) / GAN_F32_TIMED,
            "peak": peak[0], "launches": prof["launches"],
            "step_launches": tuple(float(np.mean([x[i] for x in
                                                  launches_g[1:]]))
                                   for i in (0, 1)),
            "g_ms": float(np.mean(g_ms[1:])), "profile": prof["profile"]}


def phase_gan_f32(device, root):
    """The float32 GAN of ``configs/enarfgan_train/AIST/config.yml`` through
    the port's CLI, ``train_ENARF_GAN.main``, its config read from the files
    by the port's YAML reader (data roots and ``out_root`` replaced): seeded
    weights perturbed by 0.3, 1 warm-up, GAN_F32_TIMED timed and 1 profiled
    iteration (kernels 1f and 1bf, no other unirow or tilewin kernel; the
    loader's batches included), the image grids and the snapshot the demo
    loads, then one 128² sample through ``make_gan_full_renderer``."""
    import os
    import torch
    from enarf_gan_tpu_torch.utils.logging import read_png
    t0 = time.perf_counter()
    run = _gan_cli_train(device, root, {}, "GAN float32")
    config, gen, dis = run["config"], run["gen"], run["dis"]
    nerf = config.generator_params.nerf_params
    assert "plane_sample_dtype" not in nerf and "tile_patch" not in nerf
    size, bs = config.dataset.image_size, config.dataset.bs
    s_iter, history, launches = run["s_iter"], run["history"], run["launches"]
    f_step, b_step = run["step_launches"]
    assert launches["unirow_combine_f32"] > 0 and \
        launches["unirow_combine_bwd_f32"] > 0, launches
    assert all(v == 0 for k, v in launches.items() if not k.endswith("_f32")), \
        launches
    assert gen.nerf.texel_dtype == torch.float32 and \
        not gen.nerf.supports_tiled_sampling()
    out_dir = os.path.join(root, "result", config.out)
    for name in ("rgb_0.png", "real.png", "bone_0.png"):
        grid = read_png(os.path.join(out_dir, name))
        assert grid.shape == (3 * size, 3 * size, 3), (name, grid.shape)
    assert os.path.exists(os.path.join(out_dir, "snapshot_latest.pth"))
    print(f"GAN float32 (config.yml) through the CLI: bs {bs} x {size}², "
          f"n_accum_step {config.n_accum_step}, z_dim {gen.z_dim}, "
          f"{sum(p.numel() for p in gen.parameters())} generator parameters; "
          f"{len(history)} iterations in {time.perf_counter() - t0:.1f} s "
          f"with the cache and the builds")
    print(f"GAN float32 training: {s_iter:.3f} s/iter (G + D, the loader's "
          f"batches included) over {GAN_F32_TIMED} iterations, G step "
          f"{run['g_ms']:.1f} ms (host), peak "
          f"{run['peak'] / 2**30:.2f} GiB allocated; losses " + "; ".join(
              ", ".join(f"{k} {v:.4f}" for k, v in m.items())
              for m in history)
          + f"; kernel launches a G step: 1f {f_step:g}, 1bf {b_step:g}; "
          f"grids rgb_0.png, real.png, bone_0.png and the snapshot in "
          f"{out_dir}")
    device_ms, _, port = run["profile"]
    frame = _gan_frame(gen, config, root, device)
    _reset_all_counts()
    color, mask, disp = frame(0, 1)
    torch.cuda.synchronize()
    assert color.shape == (3, size, size) and mask.shape == (size, size)
    assert all(bool(torch.isfinite(x).all()) for x in (color, mask, disp))
    assert float(mask.sum()) > 0, "empty GAN foreground mask"
    sample_launches = {k.name: k.launches for k in _all_kernels()}
    assert sample_launches["unirow_combine_f32"] > 0
    print(f"GAN float32 sample {size}²: foreground share "
          f"{float((mask > 0.05).float().mean()):.3f}, kernel 1f launches "
          f"{sample_launches['unirow_combine_f32']}")
    result = {"s_iter": s_iter, "peak_gib": run["peak"] / 2**30,
              "step_launches": (f_step, b_step),
              "step_ms": (port.get("unirow_combine_kernel", (0.0, 0))[0],
                          port.get("unirow_combine_bwd_kernel", (0.0, 0))[0]),
              "g_step_device_ms": device_ms,
              "frame_launches": sample_launches["unirow_combine_f32"],
              "out": config.out}
    del gen, dis, run
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def _working_dir(path):
    import os
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _sphere_volume(D, cube_half, voxel, device, radius=0.25, peak=30.0):
    """A ball's density on the demo's grid: ``peak`` at the centre falling
    linearly to 0 at twice ``radius``, so that it crosses mesh_th 15 at
    ``radius``."""
    import torch
    ar = (torch.arange(D, device=device, dtype=torch.float32) - cube_half) \
        * voxel
    r = torch.sqrt(ar[:, None, None] ** 2 + ar[None, :, None] ** 2
                   + ar[None, None, :] ** 2)
    return peak * (1 - r / (2 * radius))


def phase_gan_demo(device, root, out):
    """The port's demo CLI, ``ENARF_GAN_demo.main``, on
    ``configs/enarfgan_demo/AIST/enarfgan.yml`` read by the port's YAML
    reader with only ``out_root``, ``out`` (the float32 GAN's run) and
    ``sample_path`` replaced: 2 samples of the synthetic pose prior with
    ``--black_bg`` and ``--mesh`` at the default voxel, DEMO_VOXEL (a 667³
    density grid through kernel 1f, marching tetrahedra and the rasteriser
    on the card), run in a directory holding the synthetic canonical pose
    at the config's default ``smpl_data/neutral_canonical.npy``; the PNGs
    read back. Then one chunk of the mesh grid through kernel 1f against
    the plain combine (phase 2's bound, both timed), a demo frame against
    the plain combine's, profiles of a frame and of 64 chunks of a density
    grid, and, if the model's volume crossed mesh_th nowhere, the same
    iso-surface and rasteriser on an analytic ball on the same grid."""
    import os
    import torch
    from enarf_gan_tpu_torch import ENARF_GAN_demo
    from enarf_gan_tpu_torch.data.datasets import HumanPoseDataset
    from enarf_gan_tpu_torch.mesh import extract
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.tools.ablate import texel_table_bytes
    from enarf_gan_tpu_torch.training import gan
    from enarf_gan_tpu_torch.utils.logging import read_png
    work = os.path.join(root, "demo_cwd")
    samples_dir = os.path.join(root, "demo_samples")
    config = _read_config(GAN_DEMO_CONFIG, {
        "out_root": root, "out": out, "sample_path": samples_dir})
    size = config.dataset.image_size
    pose_ds = HumanPoseDataset(size=size, data_root=root,
                               num_repeat_in_epoch=1)
    os.makedirs(samples_dir, exist_ok=True)
    np.savez(os.path.join(samples_dir, "sample_data.npz"), **{
        k: np.stack([pose_ds[i * 5][k] for i in range(DEMO_SAMPLES)])
        for k in ("pose_to_camera", "pose_to_world", "bone_length",
                  "intrinsics")})
    os.makedirs(os.path.join(work, "smpl_data"), exist_ok=True)
    np.save(os.path.join(work, "smpl_data", "neutral_canonical.npy"),
            pose_ds.canonical_pose)
    assert "canonical_pose_path" not in config

    gens, forwards, frames, grids, isos, rasters = [], [], [], [], [], []
    real_build = gan.build_generator
    real_grid, real_iso = extract.density_grid, extract.marching_tetrahedra
    real_raster = ENARF_GAN_demo.render_mesh_image

    def build(*a, **k):
        gen = real_build(*a, **k)
        forward = gen.forward

        def timed_forward(*fa, **fk):
            torch.cuda.synchronize()
            t = time.perf_counter()
            before = unirow.KERNEL_F32.launches
            r = forward(*fa, **fk)
            torch.cuda.synchronize()
            frames.append({"ms": (time.perf_counter() - t) * 1e3,
                           "launches": unirow.KERNEL_F32.launches - before,
                           "args": fa, "kwargs": fk})
            return r

        gen.forward = timed_forward
        gens.append(gen)
        forwards.append(forward)
        return gen

    def timed_grid(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = unirow.KERNEL_F32.launches
        vol, bins = real_grid(*a, **k)
        torch.cuda.synchronize()
        grids.append({"s": time.perf_counter() - t,
                      "launches": unirow.KERNEL_F32.launches - before,
                      "min": float(vol.min()), "max": float(vol.max()),
                      "D": vol.shape[0], "args": a, "kwargs": k})
        if len(grids) == 1:
            grids[0]["volume"] = vol
        return vol, bins

    def timed_iso(vol, th, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        verts, faces = real_iso(vol, th, *a, **k)
        torch.cuda.synchronize()
        isos.append({"s": time.perf_counter() - t, "verts": verts.shape[0],
                     "faces": faces.shape[0],
                     "active": int(extract.active_cubes(vol, th).shape[0])})
        return verts, faces

    def timed_raster(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = real_raster(*a, **k)
        rasters.append({"s": time.perf_counter() - t,
                        "covered": int(img.any(axis=2).sum())})
        return img

    _reset_all_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(ENARF_GAN_demo, "yaml_config",
                           lambda *a, **k: config), \
            mock.patch.object(gan, "build_generator", build), \
            mock.patch.object(extract, "density_grid", timed_grid), \
            mock.patch.object(extract, "marching_tetrahedra", timed_iso), \
            mock.patch.object(ENARF_GAN_demo, "render_mesh_image",
                              timed_raster), _working_dir(work):
        paths = ENARF_GAN_demo.main(
            ["--config", _repo_path(GAN_DEMO_CONFIG[0]), "--default_config",
             _repo_path(GAN_DEMO_CONFIG[1]), "--num_samples",
             str(DEMO_SAMPLES), "--black_bg", "--mesh", "--mesh_voxel_size",
             str(DEMO_VOXEL)])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k.name: k.launches for k in _all_kernels()}
    assert launches["unirow_combine_f32"] > 0 and all(
        v == 0 for k, v in launches.items() if k != "unirow_combine_f32"), \
        launches
    assert len(frames) == len(grids) == len(isos) == len(rasters) \
        == DEMO_SAMPLES
    want = {"img": (size, size, 3), "mask": (size, size, 3),
            "mesh": (ENARF_GAN_demo.MESH_RENDER_SIZE,) * 2 + (3,)}
    for p in paths:
        img = read_png(p)
        assert img.shape == want[os.path.basename(p).split("_")[0]], \
            (p, img.shape)
    assert len(paths) == 3 * DEMO_SAMPLES, paths
    D = grids[0]["D"]
    assert D == 2 * int(1 / DEMO_VOXEL) + 1, D
    print(f"GAN demo CLI (enarfgan.yml, --black_bg --mesh, voxel "
          f"{DEMO_VOXEL}): "
          f"{DEMO_SAMPLES} samples in {demo_s:.1f} s with the snapshot load, "
          f"peak {peak / 2**30:.2f} GiB allocated; PNGs read back: "
          + ", ".join(os.path.basename(p) for p in paths))
    for i, (fr, gr, iso, ra) in enumerate(zip(frames, grids, isos, rasters)):
        print(f"  sample {i}: frame {fr['ms']:.1f} ms ({fr['launches']} 1f "
              f"launches); density grid {D}³ ({D ** 3} points) "
              f"{gr['s']:.2f} s, {gr['launches']} 1f launches, volume "
              f"[{gr['min']:.4g}, {gr['max']:.4g}]; iso-surface "
              f"{iso['s']:.2f} s: {iso['active']} active cubes, "
              f"{iso['verts']} vertices, {iso['faces']} faces; rasteriser "
              f"{ra['s']:.2f} s, {ra['covered']} pixels covered")
    gen = gens[0]
    frame = frames[0]

    # one chunk of the mesh grid, kernel 1f against the plain combine: the
    # chunk with the most points of nonzero density in sample 0's volume,
    # or, if it has none, the middle chunk (the slab through the centre)
    vol = grids[0].pop("volume")
    chunk = 262144
    nonzero = (vol.reshape(-1) > 0).float()
    n_chunks = -(-nonzero.shape[0] // chunk)
    per = torch.nn.functional.pad(nonzero, (0, n_chunks * chunk
                                            - nonzero.shape[0]))
    per = per.reshape(n_chunks, chunk).sum(1)
    c = int(per.argmax()) if float(per.max()) > 0 else D ** 3 // 2 // chunk
    del vol, nonzero, per
    fa = frame["args"]
    pose, bl, z = fa[0], fa[2], fa[3]
    with torch.no_grad():
        z_nerf, z_rend, _ = gen.split_z(z)
        pose_t, bl_t = gen.transform_pose(pose, bl)
        packed = gen.pack_planes(gen.compute_tri_plane_feature(
            z_nerf, bl_t, 0.4))
        pose_scaled = pose_t.clone()
        pose_scaled[:, :, :3, 3] *= gen.nerf_params.coordinate_scale
        pts = extract.grid_points(
            pose[0, 0, :3, 3], DEMO_VOXEL, gen.nerf_params.coordinate_scale,
            int(1 / DEMO_VOXEL), c * chunk, min((c + 1) * chunk, D ** 3))

    def density():
        return gen.nerf_density_color(pts, pose_scaled, bl_t, packed,
                                      z_rend, None)[0]

    # kernel 1f on the chunk's own inputs (its candidates' cells, weights
    # and bones) against its plain twin, within phase 2's bound and timed
    calls = []
    real_combine = unirow.unirow_combine

    def recording(*a, **k):
        calls.append((a, k))
        return real_combine(*a, **k)

    with torch.no_grad(), mock.patch.object(unirow, "unirow_combine",
                                            recording):
        got = density()
    (a, k), = calls
    n_valid = int(a[4].sum())
    chunk_err, chunk_ms, chunk_plain_ms = _compare_and_time(
        lambda: unirow.unirow_combine(*a, **k),
        lambda: unirow.gather_combine_texels_plain(*a, **k),
        f"kernel 1f, mesh grid chunk {c} ({pts.shape[-1]} points, "
        f"{n_valid} valid candidates)")
    # its bound, as phase 2 counts it, from this chunk's inputs
    F_, M, n = a[5], a[3].shape[1], a[3].shape[2]
    table_bytes, d_tex, _ = texel_table_bytes(a[0], a[1], a[3], a[4], F_)
    chunk_bound_ms, chunk_bound_by = _bound(
        table_bytes + sum(x.numel() * x.element_size() for x in a[1:5])
        + (F_ + M) * n * 4,
        n * M * 3 * (4 * F_ * 2 + 4 * 2) + n * M * F_ * 2)
    print(f"  bound {chunk_bound_ms:.4f} ms by {chunk_bound_by} "
          f"({d_tex} distinct feature texels)")
    # ... and the density through the point network: within 1e-4 of its
    # scale (the MLP and the x10 carry the combine's rounding on)
    with torch.no_grad(), mock.patch.object(
            unirow, "unirow_combine", unirow.gather_combine_texels_plain):
        ref = density()
    dens_err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"  the chunk's density, kernel 1f vs plain combine: max|d| "
          f"{dens_err:.3e} of a scale {scale:.4g} (bound 1e-4 of it)")
    assert dens_err <= 1e-4 * scale, (dens_err, scale)
    del calls, a, k, got, ref

    # a demo frame against the plain combine's (the same z and draws)
    @torch.no_grad()
    def demo_frame(_=None, seed=7):
        return tuple(x[0] for x in forwards[0](*fa, **{
            **frame["kwargs"], "generator": torch.Generator(
                device=device).manual_seed(seed)})[:2])

    phase_plain_render(demo_frame, unirow, "unirow_combine",
                       unirow.gather_combine_texels_plain, unirow.KERNEL_F32,
                       "demo frame (image, mask)")

    # where a mesh grid's time goes: a profile of its middle
    # PROFILED_CHUNKS chunks (a whole grid's 270k launches take minutes to
    # trace), beside their host time
    lo = max(0, min(n_chunks - PROFILED_CHUNKS,
                    D ** 3 // 2 // chunk - PROFILED_CHUNKS // 2))
    hi = min(n_chunks, lo + PROFILED_CHUNKS)

    @torch.no_grad()
    def grid_slice():
        for i in range(lo, hi):
            density_fn(extract.grid_points(
                pose[0, 0, :3, 3], DEMO_VOXEL,
                gen.nerf_params.coordinate_scale, int(1 / DEMO_VOXEL),
                i * chunk, min((i + 1) * chunk, D ** 3)))

    density_fn = grids[0]["args"][0]
    grid_slice()
    torch.cuda.synchronize()
    t = time.perf_counter()
    grid_slice()
    torch.cuda.synchronize()
    slice_ms = (time.perf_counter() - t) * 1e3
    grid_prof = profile_by_class(
        grid_slice, f"GAN demo density grid ({D}³, sample 0), chunks {lo} "
        f"to {hi - 1}, profile", slice_ms, f"{hi - lo} chunks")
    frame_prof = profile_by_class(demo_frame, "GAN demo frame profile",
                                  frame["ms"], "frame")

    surface = "model"
    if any(iso["faces"] == 0 for iso in isos):
        # the model crossed mesh_th nowhere: the same surface path on a ball
        surface = "analytic ball"
        cube_half = int(1 / DEMO_VOXEL)
        ball = _sphere_volume(D, cube_half, DEMO_VOXEL, device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        verts, faces = extract.marching_tetrahedra(ball, 15.0)
        torch.cuda.synchronize()
        iso_s = time.perf_counter() - t
        del ball
        verts = (verts - cube_half) * DEMO_VOXEL + pose[0, 0, :3, 3]
        t = time.perf_counter()
        img = real_raster(verts, faces, np.linalg.inv(
            fa[4][0].cpu().numpy()), img_size=size,
            render_size=ENARF_GAN_demo.MESH_RENDER_SIZE)
        raster_s = time.perf_counter() - t
        assert faces.shape[0] > 0 and img.any()
        isos.append({"s": iso_s, "verts": verts.shape[0],
                     "faces": faces.shape[0], "active": None})
        rasters.append({"s": raster_s, "covered": int(img.any(axis=2).sum())})
        print(f"  analytic ball (radius 0.25, the model's volume crossed "
              f"mesh_th nowhere): iso-surface {iso_s:.2f} s, "
              f"{verts.shape[0]} vertices, {faces.shape[0]} faces; "
              f"rasteriser {raster_s:.2f} s, {rasters[-1]['covered']} pixels")
    else:
        assert all(r["covered"] > 0 for r in rasters), rasters
    print(f"GAN demo mesh surface: {surface}")
    return {"frames": [{k: v for k, v in f.items()
                        if k not in ("args", "kwargs")} for f in frames],
            "grids": [{k: v for k, v in g.items()
                       if k in ("s", "launches", "min", "max")}
                      for g in grids],
            "isos": isos, "rasters": rasters, "surface": surface,
            "peak_gib": peak / 2**30, "demo_s": demo_s,
            "chunk": {"max_abs_err": chunk_err, "ms": chunk_ms,
                      "plain_ms": chunk_plain_ms, "valid": n_valid,
                      "bound_ms": chunk_bound_ms, "bound_by": chunk_bound_by,
                      "points": int(pts.shape[-1]),
                      "density_max_abs_err": dens_err},
            "slice_ms_1f": grid_prof[2].get("unirow_combine_kernel",
                                            (0.0, 0))[0],
            "slice_device_ms": grid_prof[0], "slice_ms": slice_ms,
            "frame_ms_1f": frame_prof[2].get("unirow_combine_kernel",
                                             (0.0, 0))[0],
            "frame_device_ms": frame_prof[0]}


def phase_eval(device, root, out):
    """The evaluation CLIs of the port on phase 8's float32 GAN snapshot
    (``root``/result/``out``), each through its ``main(argv)``, the
    published configs read by the port's YAML reader with only the data
    roots, ``out_root`` and ``out`` replaced: ``compute_fid`` on
    ``configs/enarfgan_train/AIST/config.yml`` with
    INCEPTION_WEIGHTS_NPZ=random:0 (the repository holds no Inception
    weights) over a synthetic AIST-layout cache of 64 frames at 128²,
    ``--num_sample 256 --batch_size 16 --black_bg``; ``compute_PCK``
    (``--estimator projected`` and ``stub``, ``--num_sample 64``) on the
    same; ``compute_depth`` on ``configs/enarfgan_train/SURREAL/config.yml``
    over a synthetic depth cache of 16 items at 128², ``--num_sample 16``.
    For each: wall seconds, generated images a second (of the CLI and of
    its renders alone), kernel 1f's launches (> 0, and no other kernel's),
    the peak and the metric (finite). Then Inception's ms a batch of 16 on
    the card, a profile of one FID batch (render, resize, Inception), and
    one evaluation frame (image, mask, disparity) through 1f against the
    plain combine, with phase 4's bounds."""
    import os
    import torch
    from enarf_gan_tpu_torch.data.fixtures import (make_synthetic_depth_cache,
                                                   make_synthetic_human_cache)
    from enarf_gan_tpu_torch.eval_lib import fid as fid_lib
    from enarf_gan_tpu_torch.evaluation import (compute_depth, compute_fid,
                                                compute_PCK)
    from enarf_gan_tpu_torch.ops import unirow
    data = os.path.join(root, "eval_aist")
    surreal = os.path.join(root, "eval_surreal")
    t0 = time.perf_counter()
    make_synthetic_human_cache(data, size=RENDER_SIZE, n_frames=EVAL_FRAMES,
                               n_camera=EVAL_CAMERAS)
    make_synthetic_depth_cache(os.path.join(surreal, "NARF_GAN_depth_cache"),
                               size=RENDER_SIZE, n_items=DEPTH_ITEMS)
    print(f"evaluation caches: {EVAL_FRAMES * EVAL_CAMERAS} AIST-layout "
          f"frames and {DEPTH_ITEMS} depth items at {RENDER_SIZE}² in "
          f"{time.perf_counter() - t0:.1f} s")
    aist = _read_config(GAN_F32_CONFIG, {
        "out_root": root, "out": out, "dataset.train.data_root": data})
    surreal_config = _read_config(SURREAL_F32_CONFIG, {
        "out_root": root, "out": out})
    assert aist.generator_params == surreal_config.generator_params
    renders, frechet = [], []
    real_render = compute_fid.render_batch
    real_frechet = compute_fid.frechet_distance

    def timed_render(gen, batch, rng, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real_render(gen, batch, rng, *a, **k)
        torch.cuda.synchronize()
        renders.append({"s": time.perf_counter() - t,
                        "images": len(batch["bone_length"]), "gen": gen,
                        "batch": batch, "args": a, "kwargs": k})
        return r

    def timed_frechet(*a):
        t = time.perf_counter()
        r = real_frechet(*a)
        frechet.append(time.perf_counter() - t)
        return r

    def run(name, module, config, argv, images):
        renders.clear()
        _reset_all_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with mock.patch.object(module, "yaml_config",
                               lambda *a, **k: config), \
                mock.patch.object(module, "render_batch", timed_render), \
                mock.patch.object(compute_fid, "frechet_distance",
                                  timed_frechet), \
                mock.patch.dict(os.environ, {"INCEPTION_WEIGHTS_NPZ":
                                             INCEPTION_WEIGHTS}):
            metric = module.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k.name: k.launches for k in _all_kernels()}
        generated = sum(r["images"] for r in renders)
        render_s = sum(r["s"] for r in renders)
        assert np.isfinite(metric), (name, metric)
        assert launches["unirow_combine_f32"] > 0 and all(
            v == 0 for k, v in launches.items() if k != "unirow_combine_f32"), \
            (name, launches)
        assert generated >= images, (name, generated)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{name}: {metric!r} in {wall:.2f} s; {generated} images "
              f"generated ({generated / wall:.2f} a second of the CLI, "
              f"{generated / render_s:.2f} of its {len(renders)} renders, "
              f"{render_s:.2f} s); kernel 1f launches "
              f"{launches['unirow_combine_f32']}, no other kernel's; peak "
              f"{peak:.2f} GiB allocated")
        first = {k: renders[0][k] for k in ("gen", "batch", "args", "kwargs")}
        renders.clear()
        return {"metric": metric, "s": wall, "images": generated,
                "render_s": render_s, "peak_gib": peak,
                "launches": launches["unirow_combine_f32"], "first": first}

    aist_argv = ["--config", _repo_path(GAN_F32_CONFIG[0]),
                 "--default_config", _repo_path(GAN_F32_CONFIG[1])]
    results = {}
    results["fid"] = run(
        "compute_fid (FID, random:0 Inception)", compute_fid, aist,
        aist_argv + ["--num_sample", str(FID_SAMPLES), "--batch_size",
                     str(FID_BATCH), "--black_bg"], FID_SAMPLES)
    size = aist.dataset.image_size
    cache = os.path.join(data, f"fid_stats_{size}_{INCEPTION_WEIGHTS}.npz")
    assert os.path.exists(cache), cache
    print(f"  FID's real statistics cached at {os.path.basename(cache)}; "
          f"the Fréchet distance (scipy sqrtm of 2048²) took "
          f"{frechet[0]:.2f} s on the host")
    results["fid"]["frechet_s"] = frechet[0]
    for est in ("projected", "stub"):
        results[f"pck_{est}"] = run(
            f"compute_PCK ({est})", compute_PCK, aist,
            aist_argv + ["--num_sample", str(PCK_SAMPLES), "--estimator",
                         est], PCK_SAMPLES)
    results["depth"] = run(
        "compute_depth (disparity MSE)", compute_depth, surreal_config,
        ["--config", _repo_path(SURREAL_F32_CONFIG[0]), "--default_config",
         _repo_path(SURREAL_F32_CONFIG[1]), "--surreal_path", surreal,
         "--num_sample", str(DEPTH_ITEMS)], DEPTH_ITEMS)
    for key, name in (("fid", "fid.txt"), ("pck_projected",
                                           "pck_projected.txt"),
                      ("pck_stub", "pck_stub.txt"),
                      ("depth", "disparity_mse.txt")):
        with open(os.path.join(root, "result", out, name)) as f:
            assert float(f.read()) == results[key]["metric"], key

    # Inception on the card: ms a batch of 16 (resize 128² → 299², then
    # the features), CUDA events
    extractor = fid_lib.make_inception_extractor(
        INCEPTION_WEIGHTS, batch_size=FID_BATCH, device=device)
    x = torch.rand((FID_BATCH, 3, size, size), device=device,
                   generator=torch.Generator(device=device).manual_seed(3))
    x = x * 255
    resize_ms = _cuda_time_ms(lambda: fid_lib.resize_bilinear_299(x), 20)
    big = fid_lib.resize_bilinear_299(x)
    inception_ms = _cuda_time_ms(lambda: extractor(big), 10)
    print(f"Inception (random:0) on the card: {inception_ms:.3f} ms a batch "
          f"of {FID_BATCH} at 299² (features to the host included), the "
          f"resize {resize_ms:.4f} ms")
    results["inception_ms"], results["resize_ms"] = inception_ms, resize_ms

    # where an FID batch's time goes: render, resize, Inception
    first = results["fid"]["first"]
    gen = first["gen"]

    def fid_batch():
        rng = torch.Generator(device=device).manual_seed(5)
        img, _, _ = real_render(gen, first["batch"], rng, *first["args"],
                                **first["kwargs"])
        extractor(fid_lib.resize_bilinear_299(img.clamp(-1, 1) * 127.5
                                              + 127.5))

    fid_batch()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fid_batch()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t) * 1e3
    prof = profile_by_class(fid_batch, f"FID batch of {FID_BATCH} (render, "
                            "resize, Inception) profile", batch_ms, "batch")
    results["fid_batch"] = {"ms": batch_ms, "device_ms": prof[0],
                            "launches": prof[1],
                            "ms_1f": prof[2].get("unirow_combine_kernel",
                                                 (0.0, 0))[0]}

    # one evaluation frame through kernel 1f against the plain combine:
    # the depth CLI's first batch, image, mask and disparity of its first
    # pose
    first = results["depth"]["first"]

    @torch.no_grad()
    def eval_frame(_=None, seed=7):
        img, mask, aux = real_render(
            first["gen"], first["batch"],
            torch.Generator(device=device).manual_seed(seed), *first["args"],
            **first["kwargs"])
        return img[0], mask[0], aux["disparity"][0]

    phase_plain_render(eval_frame, unirow, "unirow_combine",
                       unirow.gather_combine_texels_plain, unirow.KERNEL_F32,
                       "evaluation frame (image, mask, disparity)")
    for r in results.values():
        if isinstance(r, dict):
            r.pop("first", None)
    del gen, first, extractor
    torch.cuda.empty_cache()
    return results


def _timed_fk(label, fn, n_poses, card):
    """``fn()`` on the card after a warm-up call: ms, poses a second and
    the peak memory allocated, printed with the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()                                   # returns host arrays
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {n_poses:,} poses in {ms:.2f} ms ({n_poses / ms * 1e3:,.0f}"
          f" poses/s, host arrays in and out), peak {peak:.3f} GiB allocated "
          f"[{card}]")
    return out, {"ms": ms, "poses_per_s": n_poses / ms * 1e3,
                 "peak_gib": peak}


def phase_preprocess(device, root, cli_root):
    """Phase "preprocess": the port's data preparation on the card.
    (a) A full-size synthetic SMPL model for each gender, then the port's
    ``prepare_canonical_pose`` CLI on the card, its canonical poses held to
    the float64 plain forward kinematics. (b) AIST++'s pose stage
    (``AIST.preprocess.view_pose_stage``, the male model) as
    ``read_frames`` calls it, once a camera view of each of a dancer's
    AIST_SEQUENCES sequences, the first sequence's views held to the plain
    forward kinematics and to the crop geometry on the host; and ZJU
    313's pose stage (``ZJU.preprocess.pose_stage``: the train cache's
    frames and the two test caches', each frame with its own betas and
    Rh/Th), timed and held to the plain version. (c) The port's
    ``prepare_sample_data`` CLI on phase 8's ``313_denarf.yml`` cache
    (``cli_root``), then the demo CLI function (``DSO_demo.demo``) on
    that ``sample_data.npz`` with the cache's pixel intrinsics and phase
    8's snapshot: kernel 1f's launches, finite frames, a non-empty mask."""
    import os
    import torch
    from enarf_gan_tpu_torch import DSO_demo
    from enarf_gan_tpu_torch.data.cache import load_cache
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_smpl_npz
    from enarf_gan_tpu_torch.data_preprocess import (prepare_canonical_pose,
                                                     prepare_sample_data)
    from enarf_gan_tpu_torch.data_preprocess.AIST import preprocess as aist
    from enarf_gan_tpu_torch.data_preprocess.ZJU import preprocess as zju
    from enarf_gan_tpu_torch.geometry.smpl import (rvec_to_matrix_plain,
                                                   smpl_pose_transforms_plain)
    card = _card()
    print("phase preprocess: the pipelines' image stages (cv2's imread, "
          "undistort, resize and video decoding) do not run here: this "
          "machine has no cv2; tests/test_torch_preprocess.py holds them to "
          "the JAX scripts on the CPU. What runs here is what needs no cv2: "
          "the forward kinematics, the root rotation, the sample data and "
          "the demo on it.")
    t_phase = time.perf_counter()
    out = {}

    # (a) canonical poses of three full-size models
    smpl_dir = os.path.join(root, "smpl_data")
    models = {}
    for i, g in enumerate(("MALE", "FEMALE", "NEUTRAL")):
        path = os.path.join(smpl_dir, f"SMPL_{g}.npz")
        make_synthetic_smpl_npz(path, SEED + 37 + i, n_betas=SMPL_BETAS,
                                n_vertices=SMPL_VERTICES)
        models[g] = dict(np.load(path))
    t0 = time.perf_counter()
    written = prepare_canonical_pose.main(
        ["--smpl_dir", smpl_dir, "--out_dir", smpl_dir, "--device",
         str(device)])
    canon_s = time.perf_counter() - t0
    assert len(written) == 3, written
    errs = {}
    for gender, m in models.items():
        want = smpl_pose_transforms_plain(
            np.zeros((1, SMPL_BETAS)), np.zeros((1, 72)), m["v_template"],
            m["shapedirs"], m["J_regressor"], m["parents"])[0]
        want[:, :3, 3] -= want[[1, 2], :3, 3].mean(axis=0, keepdims=True)
        got = np.load(os.path.join(smpl_dir, f"{gender.lower()}_canonical.npy"))
        assert got.shape == (24, 4, 4) and got.dtype == np.float32
        errs[gender] = float(np.abs(got - want).max())
        assert errs[gender] <= PREP_FK_TOL, (gender, errs[gender])
    print(f"(a) prepare_canonical_pose on {SMPL_VERTICES}-vertex, "
          f"{SMPL_BETAS}-beta models: 3 genders in {canon_s:.3f} s (the CLI, "
          f"its first device calls included); max|Δ| against the float64 "
          f"plain version " + ", ".join(f"{g} {e:.3g}" for g, e in
                                        errs.items())
          + f" (bound {PREP_FK_TOL:g}) [{card}]")
    out["canonical_max_abs_err"] = max(errs.values())

    # (b) AIST++'s pose stage as read_frames calls it, and ZJU 313's
    male = models["MALE"]
    rs = np.random.RandomState(SEED + 41)
    video_len = AIST_SEQ_FRAMES // 20             # frames decoded at 3 fps
    H, W = AIST_HW
    K = np.array([[AIST_FOCAL, 0, W / 2], [0, AIST_FOCAL, H / 2], [0, 0, 1]])
    views = [(rvec_to_matrix_plain(np.array([[0, 2 * np.pi * v / AIST_VIEWS,
                                              0.0]]))[0],
              np.array([[0.0], [0.0], [AIST_DISTANCE]]))
             for v in range(AIST_VIEWS)]     # a ring around the dance floor
    motions = [(rs.normal(0, 0.3, (AIST_SEQ_FRAMES, 72)),
                np.array([rs.uniform(85, 100)]),                  # scaling
                rs.normal(0, 0.5, (AIST_SEQ_FRAMES, 3)).cumsum(0))  # cm
               for _ in range(AIST_SEQUENCES)]

    def stage(motion, view, on=device):
        return aist.view_pose_stage(male, *motion, *view, K, video_len, H, W,
                                    on)

    stage(motions[0], views[0])                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = [stage(m, v) for m in motions for v in views][:AIST_VIEWS]
    s_all = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = AIST_SEQUENCES * AIST_VIEWS
    n_poses = calls * AIST_SEQ_FRAMES
    out["aist"] = {"s": s_all, "ms_call": s_all / calls * 1e3,
                   "poses_per_s": n_poses / s_all, "peak_gib": peak}
    print(f"(b) AIST++ pose stage as read_frames calls it (view_pose_stage: "
          f"the male model sent anew, zero betas): one dancer, "
          f"{AIST_SEQUENCES} sequences x {AIST_VIEWS} views = {calls} calls "
          f"of {AIST_SEQ_FRAMES} 60 fps poses, {video_len} frames kept: "
          f"{s_all:.3f} s, {out['aist']['ms_call']:.3f} ms a call, "
          f"{out['aist']['poses_per_s']:,.0f} poses/s (host arrays in and "
          f"out), peak {peak:.3f} GiB allocated [{card}]")
    poses, scaling, trans = motions[0]
    want = smpl_pose_transforms_plain(
        np.zeros((AIST_SEQ_FRAMES, SMPL_BETAS)), poses, male["v_template"],
        male["shapedirs"], male["J_regressor"], male["parents"])
    want[:, :, :3, 3] = want[:, :, :3, 3] * scaling + trans[:, None]
    want = want[19:20 * video_len:20]
    err, n_valid = 0.0, 0
    for view, (A, valid, top_left, intr) in zip(views, first):
        assert A.shape == (video_len, 24, 4, 4) and A.dtype == np.float32
        # in the cache's units (metres: the pipeline divides by 100)
        err = max(err, float(np.abs(A - want).max()) / 100)
        host = aist.crop_geometry(A, *view, K, H, W, "cpu")
        assert np.array_equal(valid, host[0]), (valid, host[0])
        assert np.array_equal(top_left, host[1])
        assert np.abs(intr - host[2]).max() <= 1e-9 * np.abs(host[2]).max()
        n_valid += int(valid.sum())
    assert err <= PREP_FK_TOL and n_valid > 0, (err, n_valid)
    out["aist"]["max_abs_err"] = err
    print(f"    first sequence's {AIST_VIEWS} views: max|Δ| against the "
          f"float64 plain version {err:.3g} m (bound {PREP_FK_TOL:g}); "
          f"validity, crop corners and intrinsics as on the host "
          f"({n_valid} of {AIST_VIEWS * video_len} frames in view); its "
          f"(B, {SMPL_VERTICES}, 3) vertices would be "
          f"{AIST_SEQ_FRAMES * SMPL_VERTICES * 3 * 8 / 2**20:.0f} MiB a call "
          f"in float64 [{card}]")
    del first, want

    neutral = models["NEUTRAL"]
    n_train, n_test = ZJU_313_FRAMES
    params = [{"poses": rs.normal(0, 0.3, (1, 72)).astype(np.float32),
               "shapes": rs.normal(0, 1.0, (1, SMPL_BETAS)).astype(np.float32),
               "Rh": rs.normal(0, 0.8, 3), "Th": rs.normal(0, 1.0, 3)}
              for _ in range(n_train + n_test + 1)]
    caches = {"train": range(0, n_train),
              "test_novel_view": range(0, n_train, 30),
              "test_novel_pose": range(n_train, n_train + n_test, 30)}
    out["zju"] = {}
    for name, frames in caches.items():
        frame_params = [params[f + 1] for f in frames]   # 313: frame + 1
        got, out["zju"][name] = _timed_fk(
            f"(b) ZJU 313 pose stage, {name} cache (its own betas, Rh, Th a "
            f"frame)", lambda: zju.pose_stage(neutral, frame_params, device),
            len(frames), card)
        stack = lambda k: np.stack([np.asarray(p[k]).reshape(-1)  # noqa: E731
                                    for p in frame_params])
        smpl = smpl_pose_transforms_plain(
            stack("shapes"), stack("poses"), neutral["v_template"],
            neutral["shapedirs"], neutral["J_regressor"], neutral["parents"])
        root_tf = np.tile(np.eye(4), (len(frames), 1, 1))
        root_tf[:, :3, :3] = rvec_to_matrix_plain(stack("Rh"))
        root_tf[:, :3, 3] = stack("Th")
        err = float(np.abs(got - root_tf[:, None] @ smpl).max())
        assert got.shape == (len(frames), 24, 4, 4) and err <= PREP_FK_TOL, \
            (name, err)
        out["zju"][name]["max_abs_err"] = err
        print(f"    max|Δ| against the float64 plain version {err:.3g} "
              f"[{card}]")

    # (c) the demo's sample data from phase 8's cache, and the demo on it
    train_root = os.path.join(cli_root, "train")
    samples = os.path.join(root, "samples")
    path = prepare_sample_data.main(["--data_root", train_root, "--out",
                                     samples, "--num", str(PREP_SAMPLES),
                                     "--stride", "5"])
    data, cache = np.load(path), load_cache(train_root)
    idx = np.arange(0, len(cache["smpl_pose"]), 5)[:PREP_SAMPLES]
    assert np.array_equal(data["intrinsics"], cache["camera_intrinsic"][idx])
    demo_cfg = _read_config(DEMO_F32_CONFIG, {
        "out_root": cli_root, "sample_path": samples,
        "canonical_pose_path": os.path.join(train_root, "canonical.npy")})
    renders, real = [], DSO_demo.make_dso_full_renderer

    def recording(*a, **k):
        render = real(*a, **k)

        def run(*ra, **rk):
            renders.append(render(*ra, **rk))
            return renders[-1]
        return run

    _reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(DSO_demo, "make_dso_full_renderer", recording):
        paths = DSO_demo.demo(demo_cfg, device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(paths) * 1e3
    launches = {k.name: k.launches for k in _all_kernels()}
    size = demo_cfg.dataset.image_size
    assert len(paths) == len(renders) == PREP_SAMPLES
    assert launches["unirow_combine_f32"] > 0 and all(
        v == 0 for k, v in launches.items() if k != "unirow_combine_f32"), \
        launches
    for color, mask, _ in renders:
        assert color.shape == (3, size, size) and mask.shape == (size, size)
        assert torch.isfinite(color).all() and torch.isfinite(mask).all()
        assert mask.sum() > 0, float(mask.sum())
    out["frame_launches"] = launches["unirow_combine_f32"] / len(paths)
    out["ms_frame"] = ms
    print(f"(c) prepare_sample_data on phase 8's {size}² cache ({PREP_SAMPLES}"
          f" samples, the cache's pixel intrinsics), then the demo on them: "
          f"{ms:.1f} ms a sample (the snapshot's load spread over them), "
          f"kernel 1f launches a frame {out['frame_launches']:g}, mask sums "
          + ", ".join(f"{float(m.sum()):.1f}" for _, m, _ in renders)
          + f" [{card}]")
    out["s"] = time.perf_counter() - t_phase
    print(f"phase preprocess done in {out['s']:.1f} s [{card}]")
    return out


def _mlp_frame(gen, item, device, seed=1):
    """One full frame of a DSO model through ``make_dso_full_renderer`` at
    the dataset item's pose, camera and frame time (the camera's rotation
    for view-dependent heads). Returns (color, mask, disparity), ms."""
    import torch
    from enarf_gan_tpu_torch.models.generator import make_dso_full_renderer
    size = item["img"].shape[-1]
    render = make_dso_full_renderer(gen, size, ray_batchsize=RAY_CHUNK)
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.asarray(x, np.float32)[None]).to(device)
    args = (to(item["pose_3d"]), to(np.linalg.inv(item["intrinsics"])),
            to(item["frame_time"]), to(item["bone_length"]))
    camera = to(item["camera_rotation"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render(*args, camera_pose=camera,
                 generator=torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    assert out[0].shape == (3, size, size)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    return out, ms


def _no_launches(launches, what):
    assert all(v == 0 for v in launches.values()), (what, launches)


def phase_variants_mlp(device, root):
    """(a) ``configs/DSO_train/default.yml`` over itself (the MLP NARF,
    narf, hidden 32, Nc 48 + Nf 48, 128², bs 6, 4096 rays an image) through
    the port's CLI functions on a synthetic 128² cache of 8 images: 1
    warm-up, 3 timed and 1 profiled iteration (``_cli_train``), one 128²
    frame, ``train_DSO.validation`` on 2 frames; then tnarf and dnarf with
    only ``model_type`` replaced, 1 + 2 iterations and one frame each; then
    ``DSO_demo.demo`` on ``configs/DSO_demo/default.yml`` (2 samples, PNGs
    read back). No port kernel may launch."""
    import os
    import torch
    from enarf_gan_tpu_torch import DSO_demo, train_DSO
    from enarf_gan_tpu_torch.data.datasets import SSODataset
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu_torch.models.narf import MLPNARF
    from enarf_gan_tpu_torch.training import checkpoint as ckpt
    from enarf_gan_tpu_torch.training import dso
    from enarf_gan_tpu_torch.utils.logging import read_png
    train_root, val_root = (os.path.join(root, d) for d in ("train", "val"))
    replace = {"out_root": root, "out": "DSO/default_narf",
               "dataset.train.data_root": train_root,
               "dataset.train.n_frames": MLP_FRAMES,
               "dataset.val.novel_view.data_root": val_root,
               "dataset.val.novel_view.n_frames": 1,
               "dataset.val.novel_pose.data_root": val_root + "_pose",
               "dataset.val.novel_pose.n_frames": 1}
    config = _read_config(MLP_CONFIG, replace)
    gp, nerf = config.generator_params, config.generator_params.nerf_params
    assert not gp.use_triplane and nerf.model_type == "narf"
    size, bs = config.dataset.image_size, config.dataset.bs
    make_synthetic_human_cache(train_root, size=size, n_frames=MLP_FRAMES,
                               n_camera=MLP_CAMERAS)
    for seed, key in ((1, "novel_view"), (2, "novel_pose")):
        make_synthetic_human_cache(config.dataset.val[key].data_root,
                                   size=size, n_frames=1, n_camera=1,
                                   seed=seed)
    K = 23                         # "center" origins: 24 joints, 23 bones
    pe = bs * K * 3 * 2 * 10 * gp.ray_batchsize * nerf.Nf * 4
    print(f"MLP NARF ({MLP_CONFIG[0]}): bs {bs} x {size}², "
          f"{gp.ray_batchsize} rays an image, Nc {nerf.Nc} + Nf {nerf.Nf}, "
          f"hidden {nerf.hidden_size}; the fine pass's multi-part PE "
          f"(B, K*3*2L, n) = ({bs}, {K * 60}, {gp.ray_batchsize * nerf.Nf}) "
          f"float32 is {pe / 1e9:.2f} GB a copy")
    item = SSODataset(config.dataset.val["novel_view"], size=size)[0]
    out = {}
    for mt in ("narf", "tnarf", "dnarf"):
        cfg = config if mt == "narf" else _read_config(MLP_CONFIG, {
            **replace, "out": f"DSO/default_{mt}",
            "generator_params.nerf_params.model_type": mt})
        timed = TIMED_STEPS if mt == "narf" else MLP_TYPES_TIMED
        run = _cli_train(cfg, device, timed,
                         f"MLP {mt} training profile (default.yml)",
                         profile=mt == "narf")
        gen = run["gen"]
        assert isinstance(gen.nerf, MLPNARF) and \
            gen.nerf_params.model_type == mt
        _no_launches(run["launches"], f"MLP {mt} training")
        _reset_all_counts()
        (_, mask, _), ms = _mlp_frame(gen, item, device)
        _no_launches({k.name: k.launches for k in _all_kernels()},
                     f"MLP {mt} frame")
        print(f"MLP {mt} (default.yml through train_DSO.train): "
              f"{run['s_iter']:.3f} s/iter over {timed} iterations (the "
              f"loader's batches included), peak {run['peak'] / 2**30:.2f} "
              f"GiB allocated, losses "
              + ", ".join(f"{x:.5f}" for x in run["history"])
              + f"; a {size}² frame {ms:.1f} ms, mask in "
              f"[{float(mask.min()):.3f}"
              f", {float(mask.max()):.3f}]; port kernel launches 0")
        out[mt] = {"s_iter": run["s_iter"], "peak_gib": run["peak"] / 2**30,
                   "frame_ms": ms}
        if mt == "narf":
            out[mt]["step_device_ms"] = run["profile"][0]
            out[mt]["step_by_class"] = run["profile"].groups
        del gen, run
        torch.cuda.empty_cache()

    _reset_all_counts()
    t0 = time.perf_counter()
    val = train_DSO.validation(config, device)
    val_s = time.perf_counter() - t0
    _no_launches({k.name: k.launches for k in _all_kernels()},
                 "MLP validation")
    assert set(val) == {"novel_view", "novel_pose"}, val
    assert all(np.isfinite(m["color_PSNR"]) and np.isfinite(m["color_SSIM"])
               for m in val.values()), val
    print(f"MLP narf --validation on 2 frames (crop on): {val_s:.2f} s; "
          + "; ".join(f"{k} PSNR {m['color_PSNR']:.3f} dB, SSIM "
                      f"{m['color_SSIM']:.4f}" for k, m in val.items()))

    # the demo's default.yml describes another model than the training
    # default (view-independent heads, "center_fixed" origins): the demo
    # renders that model, its seeded weights perturbed by 0.3 and saved as
    # the snapshot it loads (the demo renders without a camera pose, which
    # a view-dependent model needs, in JAX as here); its density bias is
    # raised by 2, since the MLP NARF's raw density logit comes out
    # negative everywhere from these weights and the PNGs would be black
    demo_cfg = _read_config(MLP_DEMO_CONFIG, {
        "out_root": root, "out": "DSO/default_demo",
        "sample_path": os.path.join(root, "samples"),
        "canonical_pose_path": os.path.join(train_root, "canonical.npy")})
    demo_gen = dso.build_generator(
        demo_cfg, 24, SMPL_PARENTS, device,
        generator=torch.Generator().manual_seed(SEED + 35))
    g = torch.Generator().manual_seed(SEED + 36)
    with torch.no_grad():
        for p in demo_gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(device))
        assert not demo_gen.nerf_params.view_dependent
        demo_gen.nerf.mlp.layers[-1].bias[0, 3] += 2.0   # density: 4th
    ckpt.save_checkpoint(train_DSO.out_dir_of(demo_cfg),
                         {"iteration": 0, "gen": ckpt.gen_state_dict(demo_gen)},
                         0)
    del demo_gen
    _sample_data(demo_cfg.sample_path,
                 [SSODataset(config.dataset.val[k], size=size)[0]
                  for k in ("novel_view", "novel_pose")])
    _reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = DSO_demo.demo(demo_cfg, device)
    torch.cuda.synchronize()
    demo_ms = (time.perf_counter() - t0) / len(paths) * 1e3
    _no_launches({k.name: k.launches for k in _all_kernels()}, "MLP demo")
    for p in paths:
        img = read_png(p)
        assert img.shape == (size, size, 3) and img.min() < img.max(), \
            (p, img.shape, img.min(), img.max())
    print(f"MLP demo ({MLP_DEMO_CONFIG[0]}): {len(paths)} samples at {size}² "
          f"read back from their PNGs, {demo_ms:.1f} ms a sample with the "
          f"snapshot load spread over them; port kernel launches 0")
    out["validation_s"], out["demo_ms"] = val_s, demo_ms
    return out


def _gan_frame(gen, config, root, device, seed=SEED + 33):
    """``frame(_t, draw_seed)``: one 128² foreground through
    ``make_gan_full_renderer`` of the first image and pose of the cache at
    ``root``, from one z drawn from ``seed`` (phase 4's frame signature)."""
    import torch
    from enarf_gan_tpu_torch.data.datasets import (HumanDataset,
                                                   HumanPoseDataset)
    from enarf_gan_tpu_torch.data.loader import collate
    from enarf_gan_tpu_torch.models.generator import make_gan_full_renderer
    from enarf_gan_tpu_torch.training import gan
    size = config.dataset.image_size
    render = make_gan_full_renderer(gen)
    batch = gan.prepare_gan_batch(
        collate([HumanDataset(config.dataset.train, size=size,
                              return_bone_params=False)[0]]),
        collate([HumanPoseDataset(size=size, data_root=root)[0]]), device)
    z = torch.randn((1, 4 * gen.z_dim),
                    generator=torch.Generator().manual_seed(seed)).to(device)

    def frame(_t, draw_seed):
        return render(batch["pose_to_camera"], batch["bone_length"], z,
                      batch["inv_intrinsics"], generator=torch.Generator(
                          device=device).manual_seed(draw_seed))

    return frame


def _gan_batch(config, root, device):
    """The config's batch (bs images and poses) of the cache at ``root``."""
    from enarf_gan_tpu_torch.data.datasets import (HumanDataset,
                                                   HumanPoseDataset)
    from enarf_gan_tpu_torch.data.loader import collate
    from enarf_gan_tpu_torch.training import gan
    size, bs = config.dataset.image_size, config.dataset.bs
    img_ds = HumanDataset(config.dataset.train, size=size,
                          return_bone_params=False, num_repeat_in_epoch=1)
    pose_ds = HumanPoseDataset(size=size, data_root=root,
                               num_repeat_in_epoch=1)
    return gan.prepare_gan_batch(collate([img_ds[i] for i in range(bs)]),
                                 collate([pose_ds[i] for i in range(bs)]),
                                 device)


def _frame_diff(a, b):
    """max, q99.9 and mean |a - b| and the share of pixels above 1e-2."""
    import torch
    d = (a - b).abs()
    if d.ndim == 3:
        d = d.amax(dim=0)
    d = d.flatten()
    return (float(d.max()), float(torch.quantile(d, 0.999)), float(d.mean()),
            float((d > 1e-2).float().mean()))


def phase_variants_gan(device, root):
    """(b) The tri-plane variants on the float32 GAN of
    ``configs/enarfgan_train/AIST/config.yml`` (read by the port's reader;
    data roots, ``out_root``, ``out`` and the one variant key replaced),
    each alone through ``train_ENARF_GAN.main`` (``_gan_cli_train``: 1
    warm-up, 2 timed and 1 profiled G + D iterations) and one 128² sample:
    ``constant_trimask`` on the candidate path (kernels 1f and 1bf; its
    frame against the plain combine's within phase 4's bounds, its G-step
    gradients against the plain combine's), ``selector_mlp`` and
    ``no_selector`` on the dense sampler (no port kernel; the share of the
    G step's device time in ``F.grid_sample``). (d) On constant_trimask's
    weights: a 128² frame through the dense path (max_bones_per_point 23)
    against the candidate path's (4, kernel 1f), reported, not gated."""
    import os
    import torch
    from enarf_gan_tpu_torch.ops import unirow
    from enarf_gan_tpu_torch.training import checkpoint as ckpt
    from enarf_gan_tpu_torch.training import gan
    out = {}
    for variant in GAN_VARIANTS:
        vroot = os.path.join(root, variant)
        t0 = time.perf_counter()
        run = _gan_cli_train(device, vroot, {
            "out": f"GAN/AIST/{variant}",
            f"generator_params.nerf_params.{variant}": True},
            f"GAN {variant}")
        config, gen, dis = run["config"], run["gen"], run["dis"]
        candidates = variant == "constant_trimask"
        assert gen.nerf.uses_candidate_sampling() == candidates
        launches, (f_step, b_step) = run["launches"], run["step_launches"]
        device_ms, _, _ = run["profile"]
        groups = run["profile"].groups
        dense_ms = groups.get("grid sample", 0.0)
        frame = _gan_frame(gen, config, vroot, device)
        _reset_all_counts()
        color, mask, _ = frame(0, 1)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(x).all()) for x in (color, mask))
        assert float(mask.sum()) > 0, f"empty {variant} GAN foreground"
        frame_launches = {k.name: k.launches for k in _all_kernels()}
        if candidates:
            assert f_step > 0 and b_step > 0, launches
            assert all(v == 0 for k, v in launches.items()
                       if not k.endswith("_f32")), launches
            assert frame_launches["unirow_combine_f32"] > 0, frame_launches
        else:
            _no_launches(launches, f"GAN {variant} G steps")
            _no_launches(frame_launches, f"GAN {variant} frame")
        print(f"GAN {variant} (config.yml, float32): {run['s_iter']:.3f} "
              f"s/iter (G + D, the loader's batches included) over "
              f"{GAN_F32_TIMED} iterations, G step {run['g_ms']:.1f} ms "
              f"(host), {device_ms:.2f} ms device, peak "
              f"{run['peak'] / 2**30:.2f} GiB allocated; launches a G step: "
              f"1f {f_step:g}, 1bf {b_step:g}; dense sampler (grid sample) "
              f"{dense_ms:.2f} ms, {dense_ms / device_ms:.3f} of the G "
              f"step's device time; a {config.dataset.image_size}² sample's "
              f"foreground share "
              f"{float((mask > 0.05).float().mean()):.3f}, its launches "
              f"{frame_launches}; {time.perf_counter() - t0:.1f} s in all")
        out[variant] = {"s_iter": run["s_iter"],
                        "peak_gib": run["peak"] / 2**30,
                        "g_step_device_ms": device_ms,
                        "dense_ms": dense_ms, "by_class": groups,
                        "step_launches": (f_step, b_step),
                        "frame_launches": frame_launches}
        if candidates:
            phase_plain_render(frame, unirow, "unirow_combine",
                               unirow.gather_combine_texels_plain,
                               unirow.KERNEL_F32, "GAN constant_trimask")
            torch.cuda.empty_cache()
            out[variant]["grad_rel"] = phase_gan_grad_check(
                gen, dis, config, _gan_batch(config, vroot, device), device,
                "constant_trimask", unirow, "unirow_combine",
                unirow.gather_combine_texels_plain,
                (unirow.KERNEL_F32, unirow.KERNEL_BWD_F32),
                int(config.n_accum_step),
                tri_plane=("nerf.generator.", "nerf.tri_plane"))
            torch.cuda.empty_cache()
            # (d) the same weights sampled densely: every bone of every point
            dense_cfg = _train_config(config, **{
                "generator_params.nerf_params.max_bones_per_point":
                DENSE_BONES})
            dense = gan.build_generator(dense_cfg, 24, gen.parent_id, device)
            ckpt.load_gen_state_dict(dense, ckpt.gen_state_dict(gen))
            assert not dense.nerf.uses_candidate_sampling()
            dense_frame = _gan_frame(dense, config, vroot, device)
            ref = frame(0, 1)
            _reset_all_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = dense_frame(0, 1)
            torch.cuda.synchronize()
            dense_frame_ms = (time.perf_counter() - t1) * 1e3
            _no_launches({k.name: k.launches for k in _all_kernels()},
                         "dense frame")
            diffs = {what: _frame_diff(a, b) for what, a, b in
                     zip(("color", "mask"), got, ref)}
            print(f"GAN constant_trimask, dense (max_bones_per_point "
                  f"{DENSE_BONES}, plain) against candidates (4, kernel 1f), "
                  f"one {config.dataset.image_size}² frame "
                  f"({dense_frame_ms:.1f} ms dense): "
                  + "; ".join(f"{w} max|d| {d[0]:.3e}, q99.9 {d[1]:.3e}, "
                              f"mean {d[2]:.3e}, share > 1e-2 {d[3]:.4f}"
                              for w, d in diffs.items()))
            out["dense_vs_candidates"] = diffs
            del dense, dense_frame
        del gen, dis, run, frame
        torch.cuda.empty_cache()
    return out


def phase_variants_tiled(device, root):
    """(c) constant_trimask on the bf16 tiled GAN of config_tpu.yml
    (``build_gan``, tile_patch 4): one G step (kernels 2 and 2b launch, 1
    and 1b do not) and its gradients against the plain combine's."""
    import torch
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel
    from enarf_gan_tpu_torch.training import gan
    config, gen, _, dis, batch, canonical = build_gan(
        device, root, constant_trimask=True)
    assert gen.nerf.supports_tiled_sampling()
    poses = {k: v for k, v in batch.items() if k != "real_img"}
    g_step = gan.make_gan_steps(config, gen, dis, *gan.init_gan_state(
        config, gen, dis, canonical))[0]
    state = {k: v.clone() for k, v in gen.state_dict().items()}
    _reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, gm = g_step(poses, torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in _all_kernels()}
    by_m = dict(tilewin_kernel.KERNEL.launches_by)
    gen.load_state_dict(state)
    assert launches["tilewin_combine"] > 0 and \
        launches["tilewin_combine_bwd"] > 0, launches
    assert launches["unirow_combine"] == 0 and \
        launches["unirow_combine_bwd"] == 0, launches
    assert all(np.isfinite(float(v)) for v in gm.values()), gm
    print(f"GAN constant_trimask on config_tpu.yml (bf16, tile_patch 4): one "
          f"G step {ms:.1f} ms (host, the first: cuDNN's choices included), "
          f"loss_gen {float(gm['loss_gen']):.4f}; kernel launches {launches}, "
          f"tilewin by member count {by_m}")
    rel = phase_gan_grad_check(
        gen, dis, config, batch, device, "constant_trimask tiled", tilewin,
        "tilewin_combine",
        lambda *a, mode=None: tilewin_kernel.tilewin_combine_texels_plain(*a),
        (tilewin_kernel.KERNEL, tilewin_kernel.KERNEL_BWD),
        int(config.n_accum_step),
        tri_plane=("nerf.generator.", "nerf.tri_plane"))
    del gen, dis, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "by_m": by_m, "grad_rel": rel,
            "step_ms": ms}


def phase_variants(device, root):
    """Phase "variants": (a) the MLP NARF baselines through the DSO CLIs,
    (b) and (d) the tri-plane variants on the float32 GAN, (c)
    constant_trimask on the bf16 tiled GAN."""
    import os
    import torch
    t0 = time.perf_counter()
    out = {"mlp": phase_variants_mlp(device, os.path.join(root, "mlp"))}
    torch.cuda.empty_cache()
    print(f"variants (a) done in {time.perf_counter() - t0:.1f} s")
    out["gan"] = phase_variants_gan(device, os.path.join(root, "gan"))
    torch.cuda.empty_cache()
    print(f"variants (b), (d) done in {time.perf_counter() - t0:.1f} s")
    out["tiled"] = phase_variants_tiled(device, os.path.join(root, "tiled"))
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"phase variants done in {out['s']:.1f} s")
    return out


def float32_study(device, root):
    """``--float32``: kernels 1f and 1bf against their plain twins (phase
    2's shapes), then the published float32 configs through the port's
    CLIs: DSO training, validation and demo, GAN training and the GAN demo
    with its meshes (phase 8)."""
    import os
    import torch
    phase_unirow_check(device, torch.float32)
    phase_unirow_bwd_check(device, torch.float32)
    torch.cuda.empty_cache()
    phase_dso_cli(device, os.path.join(root, "cli"))
    torch.cuda.empty_cache()
    gan32 = phase_gan_f32(device, os.path.join(root, "gan32"))
    phase_gan_demo(device, os.path.join(root, "gan32"), gan32["out"])
    phase_eval(device, os.path.join(root, "gan32"), gan32["out"])


def preprocess_study(device, root):
    """``--preprocess``: phase 8's DSO CLI run (the cache and snapshot the
    phase reuses), then phase "preprocess"."""
    import os
    import torch
    phase_dso_cli(device, os.path.join(root, "cli"))
    torch.cuda.empty_cache()
    phase_preprocess(device, os.path.join(root, "prep"),
                     os.path.join(root, "cli"))


def _tool(main, env, argv=()):
    """``main(argv)`` of a tool of ``enarf_gan_tpu_torch.tools`` with the
    variables ``env`` set while it runs; prints its seconds."""
    import os
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {k: str(v) for k, v in env.items()}):
        out = main(["--device", "cuda", *argv])
    print(f"tools: {main.__module__.rsplit('.', 1)[-1]} in "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_tools(device, study=False):
    """Phase "tools": the port's measurement tools at full width, at cut
    counts (REPS 3, BENCH_ITERS 2, BENCH_REPS 1, GAN_ITERS 1; ``study``:
    the JAX tools' defaults, REPS 3, BENCH_ITERS 30, BENCH_REPS 3,
    GAN_ITERS 3). Their host clocks run
    here after the earlier phases' (and tools') profiles, which leave the
    host's launches dearer; a tool run alone, ``python -m
    enarf_gan_tpu_torch.tools.<name>``, times before its first profile. ``frame_ablate`` on both paths: the nosampler frames
    must launch no kernel 1 or 2, the noheads frames as many as the full
    ones, which launch their own; ``frame_parts``; ``production`` (dso512,
    demo1024; exact and tiled), whose frames must launch their own kernel;
    ``gan_step`` (G, D, R1) on the tiled path, which must launch kernels 2
    and 2b; ``diag_learning`` on phase 10's tiled run from seed 2, whose
    forced-density render must cover the fixture's mask. Returns each
    tool's records."""
    import torch
    from enarf_gan_tpu_torch.tools import (diag_learning, frame_ablate,
                                           frame_parts, gan_step, production)
    t_phase = time.perf_counter()
    reps = {} if study else {"REPS": 3, "BENCH_ITERS": 2, "BENCH_REPS": 1,
                             "GAN_ITERS": 1}
    out = {"frame_ablate": _tool(frame_ablate.main, reps)}
    for path, rec in out["frame_ablate"].items():
        by = {r["variant"]: r for r in rec["variants"]}
        own = "kernel2_launches" if path.startswith("tilewin") \
            else "kernel1_launches"
        assert by["full"][own] > 0, (path, by["full"])
        assert by["nosampler"]["kernel1_launches"] == 0 and \
            by["nosampler"]["kernel2_launches"] == 0, (path, by["nosampler"])
        assert by["noheads"]["launches_a_frame"] == \
            by["full"]["launches_a_frame"], (path, by["noheads"])
        split = rec["split"]
        print(f"tools: {path} 128² frame split (host ms / device ms): "
              + "; ".join(f"{k} {split['split_ms_host'][k]:.2f} / "
                          f"{split['split_device_ms'][k]:.2f}"
                          for k in ("full", "sampler", "heads", "rest"))
              + f" [{_card()}]")
    torch.cuda.empty_cache()
    out["frame_parts"] = _tool(frame_parts.main, reps)
    torch.cuda.empty_cache()
    out["production"] = _tool(production.main, reps)
    for r in out["production"]:
        counts = r.get("launches_a_frame", r.get("launches_a_step"))
        own = "tilewin_combine" if r["tile_patch"] else "unirow_combine"
        assert counts[own] > 0, r
        print(f"tools: {r['metric']} (tile_patch {r['tile_patch']}): "
              f"{r['value']:.4f} {r['unit']}, device {r['device_ms']:.2f} ms "
              f"(busy {r['busy']:.3f}), peak {r['peak_gib']:.2f} GiB, "
              f"{own} {counts[own]:g} a "
              f"{'frame' if 'launches_a_frame' in r else 'step'}")
    torch.cuda.empty_cache()
    out["gan_step"] = _tool(gan_step.main, reps)
    g = out["gan_step"]["G"]["launches_a_step"]
    assert g["tilewin_combine"] > 0 and g["tilewin_combine_bwd"] > 0, g
    torch.cuda.empty_cache()
    diag = _tool(diag_learning.main, {}, [
        "--size", str(LEARN_SIZE), "--iters", str(LEARN_ITERS),
        "--tile", str(TILE_PATCH), "--seed", "2", "--log-every", "50"])
    assert diag["A"]["coverage"] >= 0.9 and np.isfinite(diag["C"]["psnr"]), \
        diag
    out["diag_learning"] = diag
    torch.cuda.empty_cache()
    print(f"phase tools done in {time.perf_counter() - t_phase:.1f} s "
          f"[{_card()}]")
    return out


def tools_study(device, root):
    """``--tools``: phase "tools" at the JAX tools' repetitions."""
    phase_tools(device, study=True)


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
               "--float32": float32_study,
               "--variants": phase_variants,
               "--preprocess": preprocess_study,
               "--tools": tools_study}
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
        demo = phase_gan_demo(device, os.path.join(root, "gan32"),
                              gan32["out"])
        torch.cuda.empty_cache()
        prep = phase_preprocess(device, os.path.join(root, "prep"),
                                os.path.join(root, "cli"))
        torch.cuda.empty_cache()
        evals = phase_eval(device, os.path.join(root, "gan32"), gan32["out"])
        torch.cuda.empty_cache()
        print(f"float32 phases done at {time.perf_counter() - t_start:.1f} s")
        variants = phase_variants(device, os.path.join(root, "variants"))
        print(f"variants phase done at {time.perf_counter() - t_start:.1f} s")
        phase_learn(device, os.path.join(root, "learn"))
    torch.cuda.empty_cache()
    tools = phase_tools(device)
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
    # phase variants: constant_trimask's G step on the bf16 tiled
    # config_tpu.yml (kernels 2 and 2b) and on the float32 config.yml (1f,
    # 1bf; and 1f in its 128² sample)
    vt, vc = variants["tiled"], variants["gan"]["constant_trimask"]
    k2b.update(variants_trimask_step_launches=vt["launches"][
        "tilewin_combine_bwd"],
        variants_trimask_grad_rel_l2=vt["grad_rel"][0])
    for m in (16, 4):
        k2[m] = dict(k2[m], variants_trimask_step_launches=vt["by_m"].get(m, 0))
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

    # phase tools: each kernel's launches a frame or step on the tools'
    # paths (frame_ablate's variants, production's dso512 step and
    # demo1024 frame, gan_step's tiled G step), and the frame's split
    def tool_launches(key, path):
        prod = {r["metric"].split("_")[0]:
                r.get("launches_a_frame", r.get("launches_a_step"))[key]
                for r in tools["production"]
                if (r["tile_patch"] > 0) == (path != "exact")}
        return {**{f"tools_{r['variant']}_frame_launches":
                   r["launches_a_frame"][key]
                   for r in tools["frame_ablate"][path]["variants"]},
                "tools_dso512_step_launches": prod["dso512"],
                "tools_demo1024_frame_launches": prod["demo1024"],
                "tools_gan_step_launches":
                    tools["gan_step"]["G"]["launches_a_step"][key]}

    k1.update(tool_launches("unirow_combine", "exact"),
              tools_frame_split_device_ms=tools["frame_ablate"]["exact"][
                  "split"]["split_device_ms"])
    k1b.update(tool_launches("unirow_combine_bwd", "exact"))
    for m in (16, 4):
        k2[m] = dict(k2[m], **tool_launches(f"tilewin_combine<{m}>",
                                            "tilewin4"))
    k2[16]["tools_frame_split_device_ms"] = tools["frame_ablate"][
        "tilewin4"]["split"]["split_device_ms"]
    k2b.update(tool_launches("tilewin_combine_bwd", "tilewin4"))

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
    # device ms (its profiled step), a 512² demo frame's, the float32
    # GAN's G step (through its CLI), and 1f's in the GAN demo: a 128²
    # frame's and a 667³ mesh grid's launches and device ms (profiles), and
    # one chunk of the mesh grid against the plain combine
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
        k.update(variants_trimask_step_launches=vc["step_launches"][i],
                 variants_trimask_grad_rel_l2=vc["grad_rel"][0],
                 variants_trimask_s_iter=vc["s_iter"],
                 variants_trimask_peak_gib=vc["peak_gib"])
        if i == 0:
            k.update(variants_trimask_frame_launches=vc["frame_launches"][
                "unirow_combine_f32"],
                preprocess_demo_frame_launches=prep["frame_launches"])
            k.update(gan_demo_frame_launches=demo["frames"][0]["launches"],
                     gan_demo_frame_ms=demo["frame_ms_1f"],
                     gan_demo_frame_device_ms=demo["frame_device_ms"],
                     gan_mesh_launches=demo["grids"][0]["launches"],
                     gan_mesh_s=demo["grids"][0]["s"],
                     gan_mesh_profiled_chunks=PROFILED_CHUNKS,
                     gan_mesh_profiled_chunks_ms=demo["slice_ms_1f"],
                     gan_mesh_profiled_chunks_device_ms=demo[
                         "slice_device_ms"],
                     gan_mesh_chunk_max_abs_err=demo["chunk"]["max_abs_err"],
                     gan_mesh_chunk_ms=demo["chunk"]["ms"],
                     gan_mesh_chunk_plain_ms=demo["chunk"]["plain_ms"],
                     gan_mesh_chunk_bound_ms=demo["chunk"]["bound_ms"],
                     gan_demo_peak_gib=demo["peak_gib"],
                     eval_fid_launches=evals["fid"]["launches"],
                     eval_pck_projected_launches=evals["pck_projected"][
                         "launches"],
                     eval_pck_stub_launches=evals["pck_stub"]["launches"],
                     eval_depth_launches=evals["depth"]["launches"],
                     eval_fid_batch_ms_1f=evals["fid_batch"]["ms_1f"],
                     eval_fid_batch_device_ms=evals["fid_batch"][
                         "device_ms"])
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
