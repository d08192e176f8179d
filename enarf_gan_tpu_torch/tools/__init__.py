"""The counterparts of ``tools/``: the TPU probe kernels as Hopper
microbenchmarks, and the main path's measurement and diagnosis tools.

Each probe module holds hand-written CUDA kernels (``csrc/probe_*.cu`` and the
stage builds of kernels 2 and 3), their wrappers (device, type, shape and
contiguity checks, a launch count; a CPU tensor runs the plain twin, a CUDA
tensor the kernel or an error), the plain PyTorch twins and the cases
(``cases(device, size)``), and a ``main`` that runs its sweep on the card
and prints one JSON line a measurement:

    python -m enarf_gan_tpu_torch.tools.gather      # family A
    python -m enarf_gan_tpu_torch.tools.mma         # family B
    python -m enarf_gan_tpu_torch.tools.ablate      # family C
    python -m enarf_gan_tpu_torch.tools.constructs  # family D
    (each with --device cpu: only the plain versions, at small sizes)
    (and --size, --only REGEX, --against DIR: each case beside another
    tree's version of it, timing.other_tree)
    python -m enarf_gan_tpu_torch.tools.warp_rows   # what bounds A2

The main path's tools (``benchkit`` holds what they share) run the port's
entry points at full width on the card and print one JSON line a record
with the host and device clocks (``utils.introspect.profile_by_class``),
the kernels' launches and the card's name and power limit; with
``--device cpu`` they run at the small sizes their variables allow, with
no device numbers:

    python -m enarf_gan_tpu_torch.tools.frame_ablate   # sampler / heads / rest
    python -m enarf_gan_tpu_torch.tools.frame_parts    # the frame's pieces
    python -m enarf_gan_tpu_torch.tools.production     # dso512, demo1024
    python -m enarf_gan_tpu_torch.tools.gan_step       # G, D, R1
    python -m enarf_gan_tpu_torch.tools.diag_learning  # a blank-frame run

``tools/`` file (TPU, Pallas)          counterpart here
------------------------------------   -----------------------------------
tpu_timeit.py (timing harness)         timing.py
bench_gather.py:155 dg_kernel          gather.lane_gather (A3)
bench_dyngather2.py:115, :144          mma.tile_gather (B2)
bench_dyngather2.py:176 dg_kernel      gather.lane_gather (A3)
bench_pallas_prims.py:73 one-hot       mma.onehot_gather (B1)
bench_pallas_prims.py:105 chain        mma.gemm (B3)
bench_unitable.py:59 kern_take         gather.row_gather (A1)
bench_unitable.py:73 kern_dslice       gather.row_gather(serial_rows=) (A2)
bench_pallas_take2.py:30 a-d           gather.lane_gather (A3), row_gather (A1)
bisect_hat_kernel.py:32                constructs.construct (D); bdiag_dot:
                                       mma.gemm (B3)
bisect_kernel_ops.py:53-135            constructs.construct (D); dot_kshape:
                                       mma.gemm (B3)
probe_call_structure.py:55             constructs.roster, timing.launch_us (D)
probe_hat_ablate.py:145                ablate.hat_stage (C, kernel 2)
probe_kernel_dma.py:114 dma_kernel     gather.ring_gather (A4)
probe_kernel_dma.py:144 relay_kernel   gather.transpose (A5)
probe_kernel_stages.py:145             ablate (C): the stage builds' ptxas
                                       lines and build time
probe_kernel_variants.py:46            constructs.construct("warm") (D)
probe_kernel_variants.py:68            ablate (C): kernel 3's build and
                                       first launch
probe_mosaic_caps.py:67-119            constructs (D); gather_sub: A1;
                                       gather_lane: A3; dot_batched: B3
probe_mosaic_coord_ops.py:69           gather.transpose (swapT, A5),
                                       constructs (expand, bcast, D)
probe_tilewin_bdiag.py:211, :246       ablate.modes_stage (C, kernel 3),
                                       ablate.hat_stage (the v4 hat kernel)
bench_frame_ablate.py                  frame_ablate (ENARF_ABLATE of
                                       models/narf.py)
bench_parts.py, bench_tilewin_stages   frame_parts
bench_production.py                    production
bench_gan_step.py                      gan_step
diag_learning.py                       diag_learning
check_kernel_parity.py                 nothing: chip_smoke.py holds every
                                       kernel to its plain twin on the card
                                       at the main path's shapes
aot_compile_kernel.py,                 nothing: they found Mosaic's compile
debug_tilewin_kernel.py                errors, which a remote TPU compiler
                                       hid; nvcc reports its errors and
                                       ptxas its registers and spills
                                       directly (cuda_build, chip_smoke.py's
                                       build phase)
analyze_gather_locality.py,            still to port (TPU design probes of
analyze_patch_locality.py, bench_dc2,  the XLA layouts; ROADMAP Queue 1,
bench_elemwise, bench_rowwidth,        item 6)
bench_sort_gather, bench_stages2,
bench_tileshape, bench_windowgather,
bench_unirow_vs_quad

``enarf_gan_tpu/utils`` module         counterpart here
------------------------------------   -----------------------------------
introspect.py                          utils/introspect.py
platform.py (sync_platform_from_env)   nothing: it forced JAX's platform
                                       and its compile cache past a TPU
                                       plugin; the port names its device
                                       (``--device``, no fallback) and
                                       builds its kernels at first use
compile_retry.py                       nothing: it retried a remote TPU
                                       compile service's transient
                                       failures; nvcc runs locally, and a
                                       failed build raises with its log
"""
