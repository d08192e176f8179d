"""What the main-path measurement tools share (``frame_ablate``,
``frame_parts``, ``production``, ``gan_step``, ``diag_learning``): the
device argument, host clocks that end in a synchronise, the device time of
a call by ``utils.introspect.profile_by_class``, the port kernels' launch
counts, the peak memory, one JSON line a record, and ``bench.py``'s DSO
model at the JAX bench's widths.

The tools read the JAX tools' ``BENCH_*``, ``GAN_*``, ``REPS`` and
``ABLATE_VARIANTS`` variables. ``BENCH_PLANES`` and ``BENCH_W_DIM`` (the
tri-plane size and StyleGAN2 width, 256 and 512) exist only to shrink the
model for smoke runs on the CPU, as the JAX GAN tool's ``GAN_PLANES``
does. On the CPU every record's device fields are None: only a run on the
card measures them.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from enarf_gan_tpu_torch.utils.introspect import (card, device_memory_stats,
                                                  profile_by_class)


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions, for a "
                         "smoke run at a small size; no device numbers)")
    return ap


def resolve(name: str) -> torch.device:
    """The tool's device; on a machine without a card, "cuda" stops the
    tool (no fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the port on an NVIDIA "
                 "GPU; pass --device cpu for a smoke run")
    if device.type == "cuda":
        from enarf_gan_tpu_torch import use_full_float32
        use_full_float32()       # as the CLIs and chip_smoke.py run
    return device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn: Callable, reps: int, device: torch.device):
    """(ms a call on the host clock over ``reps`` calls, ending in a
    synchronise; the last call's result). The caller warms up."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3, out


def device_profile(fn: Callable, device: torch.device, label: str,
                   ms_host: float, what: str, verbose: bool = False) -> Dict:
    """One call of ``fn`` under ``profile_by_class``, after one call
    unprofiled (the caching allocator and cuDNN back in the state of the
    timed calls, whatever ran in between): device ms, busy share (device
    ms over ``ms_host``), kernel launches and the ms by kernel class; all
    None on the CPU. A tool times its work on the host clock before its
    first profile: after a ``torch.profiler`` session the host's launches
    cost more (``frame_ablate``'s ``full_ms_host_after_profiles``)."""
    if device.type != "cuda":
        return {"device_ms": None, "busy": None, "kernel_launches": None,
                "device_ms_by_class": None}
    fn()
    prof = profile_by_class(fn, label, ms_host, what, verbose=verbose)
    return {"device_ms": prof[0], "busy": prof[0] / ms_host,
            "kernel_launches": prof[1], "device_ms_by_class": prof.groups}


def port_kernels():
    """The main path's kernel libraries: 1 and 1b (bf16), 2, 2b, 3, 1f,
    1bf."""
    from enarf_gan_tpu_torch.ops import tilewin_kernel, unirow
    return (unirow.KERNEL, unirow.KERNEL_BWD, tilewin_kernel.KERNEL,
            tilewin_kernel.KERNEL_BWD, tilewin_kernel.KERNEL_MODES,
            unirow.KERNEL_F32, unirow.KERNEL_BWD_F32)


def reset_launches() -> None:
    for k in port_kernels():
        k.reset_counts()


def launches() -> Dict[str, int]:
    """Each port kernel's launches since ``reset_launches`` (a CPU tensor
    runs the plain twin and counts none), and by key where a library counts
    by key (``tilewin_combine<16>``: kernel 2 by member count; kernel 3 by
    mode)."""
    out = {}
    for k in port_kernels():
        out[k.name] = k.launches
        out.update({f"{k.name}<{key}>": n for key, n in k.launches_by.items()})
    return out


def peak_gib(device: torch.device) -> Optional[float]:
    stats = device_memory_stats(device)
    return stats["peak_bytes_in_use"] / 2**30 if stats else None


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


@functools.lru_cache(maxsize=None)
def _card(device: torch.device) -> str:
    return card(device)


def emit(tool: str, device: torch.device, **record) -> Dict:
    """Print one JSON line: the tool, the card (name and power limit, or
    "cpu") and ``record``; returns the line's dict."""
    line = {"tool": tool, "card": _card(device), **record}
    print(json.dumps(line), flush=True)
    return line


def bench_params(tile_patch: int, render_bs: int, **overrides):
    """``bench.py``'s NARFParams: 256² planes (``BENCH_PLANES``), w_dim 512
    (``BENCH_W_DIM``), hidden 256, Nc 48 + Nf 64 (``BENCH_NC``,
    ``BENCH_NF``), view-independent, deformation field, time conditioning,
    ``BENCH_PLANE_DTYPE`` (bfloat16) sampling, coarse corners on the tiled
    path (``BENCH_COARSE_CORNERS``, 1)."""
    from enarf_gan_tpu_torch.models.narf import NARFParams
    kw = dict(Nc=env_int("BENCH_NC", 48), Nf=env_int("BENCH_NF", 64),
              hidden_size=256, tri_plane_size=env_int("BENCH_PLANES", 256),
              w_dim=env_int("BENCH_W_DIM", 512), render_bs=render_bs,
              coordinate_scale=3.0, view_dependent=False,
              origin_location="center_fixed", deformation_field=True,
              time_conditional=True, pose_conditional=False,
              plane_sample_dtype=os.environ.get("BENCH_PLANE_DTYPE",
                                                "bfloat16"),
              tile_patch=tile_patch,
              tile_coarse_corners=tile_patch > 0 and os.environ.get(
                  "BENCH_COARSE_CORNERS", "1") == "1")
    kw.update(overrides)
    return NARFParams(**kw)


def build_dso(params, device: torch.device, seed: int = 0):
    """A DSO generator with ``params`` on ``device``, its weights drawn from
    ``seed`` and perturbed by 0.3 (a fresh DSO model renders an empty
    frame; ``chip_smoke.py`` perturbs its frame's model so), with the
    canonical pose of ``data.fixtures.tiny_scene``."""
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu_torch.models.generator import (DSONARFGenerator,
                                                      register_canonical_pose)
    g = torch.Generator().manual_seed(seed)
    gen = DSONARFGenerator(params, num_bone=24, parent_id=SMPL_PARENTS,
                           device=device, generator=g)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(device))
    canonical = tiny_scene(1, 8)[4]
    register_canonical_pose(gen, canonical, "center_fixed", SMPL_PARENTS)
    return gen


def scene(B: int, size: int, device: torch.device,
          focal_scale: float = 1.2):
    """``tiny_scene``'s (pose_to_camera, camera rotation, bone_length,
    inv_intrinsics) as float32 tensors on ``device``."""
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    pose_cam, world, bl, inv_K, _, _ = tiny_scene(B, size, focal_scale)
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).to(device)
    return to(pose_cam), to(world[:, 0, :3, :3]), to(bl), to(inv_K)
