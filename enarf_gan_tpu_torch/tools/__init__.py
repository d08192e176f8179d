"""The TPU probe kernels of ``tools/`` as Hopper microbenchmarks.

Each module holds hand-written CUDA kernels (``csrc/probe_*.cu`` and the
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
"""
