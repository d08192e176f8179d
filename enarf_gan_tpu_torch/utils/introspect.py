"""Cost, memory and profile introspection (port of
``enarf_gan_tpu/utils/introspect.py``).

* ``param_count`` / ``param_bytes`` over an ``nn.Module`` (its
  parameters), a state dict or any dict of tensors;
* ``flops_estimate``: the FLOPs of one call that
  ``torch.utils.flop_counter.FlopCounterMode`` counts (JAX's takes XLA's
  cost analysis of the jitted function);
* ``device_memory_stats``: the CUDA caching allocator's statistics and
  peaks; ``{}`` on the CPU, as JAX's on a backend without statistics;
* ``trace``: ``torch.profiler`` around a block, written as a Chrome trace
  (JAX's writes a ``jax.profiler`` trace for TensorBoard);
* ``Timer``: named wall-clock sections that synchronise the device;
* ``profile_by_class``: one call's device time by kernel class, its
  launches and the port's kernels' share (``torch.profiler``);
* ``card``: the card's name and power limit, as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import contextlib
import os
import re
import subprocess
import time
from typing import Any, Dict, Optional

import torch
import torch.nn as nn


def _tensors(obj):
    if isinstance(obj, nn.Module):
        return list(obj.parameters())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def param_count(obj) -> int:
    """Elements of a module's parameters, or of every tensor of a (nested)
    dict, list or tuple such as a state dict."""
    return sum(t.numel() for t in _tensors(obj))


def param_bytes(obj) -> int:
    """Bytes of what ``param_count`` counts, each tensor in its own type."""
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def flops_estimate(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of ``fn(*args, **kwargs)`` as ``FlopCounterMode`` counts them
    (matrix products and convolutions of aten, forward and any backward run
    inside the call), or None where counting fails, as JAX's returns. The
    port's hand-written kernels launch outside aten, through ctypes, and are
    not counted; neither are elementwise operations."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        return float(counter.get_total_flops())
    except Exception:       # noqa: BLE001 (JAX's returns None on any failure)
        return None


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The CUDA caching allocator's ``torch.cuda.memory_stats`` of
    ``device`` (the current one by default), plus ``bytes_in_use``,
    ``peak_bytes_in_use`` (allocated) and ``peak_bytes_reserved`` since the
    last ``reset_peak_memory_stats``. A CPU device has none: ``{}``."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats.update(bytes_in_use=torch.cuda.memory_allocated(device),
                 peak_bytes_in_use=torch.cuda.max_memory_allocated(device),
                 peak_bytes_reserved=torch.cuda.max_memory_reserved(device))
    return stats


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """``torch.profiler`` around a block (the CPU, and the card where there
    is one), written to ``log_dir/name`` as a Chrome trace; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _sync(sync_on) -> None:
    for t in _tensors(sync_on):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class Timer:
    """Named wall-clock accumulator. ``section(name, sync_on=x)``
    synchronises the device that holds the tensor (or the first CUDA
    tensor of the dict, list or module) ``x`` before the section starts and
    before it ends, so that the section's time holds its device work; a CPU
    tensor needs no synchronisation."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        _sync(sync_on)
        start = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync_on)
            self.totals[name] = self.totals.get(name, 0.0) + \
                (time.perf_counter() - start)


class Profile(tuple):
    """(device ms, kernel launches, port kernels) of ``profile_by_class``,
    with the device ms by kernel class as ``groups``."""
    groups = {}


def _kernel_class(name: str) -> str:
    # cuDNN's convolutions (their implicit GEMMs: fprop, dgrad, wgrad)
    # before cuBLAS's GEMMs, whose xmma kernels share the prefix
    # (sm80_xmma_gemm_*)
    return ("unirow kernels" if "unirow" in name else
            "tilewin kernels" if "tilewin" in name else
            "grid sample" if "grid_sampler" in name else
            "convolution" if any(w in name for w in (
                "conv", "cudnn", "fprop", "dgrad", "wgrad")) else
            "gemm" if any(w in name for w in (
                "gemm", "gemv", "cutlass", "xmma", "sm90")) else
            "sort" if "sort" in name or "radix" in name else
            "index/gather" if "index" in name or "gather" in name
            or "scatter" in name else
            "reduce" if "reduce" in name else "elementwise/other")


def profile_by_class(fn, label: str, ms_host: float, what: str,
                     verbose: bool = True) -> Profile:
    """Device time of one call of ``fn`` by kernel class (torch.profiler),
    and its share of ``ms_host``, the call's time on the host clock.
    Returns (device ms, kernel launches, {port kernel: (device ms,
    launches)}) for the port's kernels (unirow, tilewin), each under its
    name and, for a template, also its name with its first argument
    (``tilewin_combine_kernel<16>``); the ms by class as ``.groups``.
    Prints the totals, the classes, the port's kernels and the ten longest
    kernels; with ``verbose=False`` nothing."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
            key = _kernel_class(e.key.lower())
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
    if verbose:
        print(f"{label}: device time {device_us / 1e3:.2f} ms in a "
              f"{ms_host:.2f} ms {what} (busy share "
              f"{device_us / 1e3 / ms_host:.3f}), {n_launches} kernel "
              f"launches")
        for key, us in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {key}: {us / 1e3:.2f} ms")
        for short, (ms, count) in sorted(port.items()):
            print(f"  port kernel {short}: {ms:.3f} ms, {count} launches a "
                  f"{what}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d} "
                  f"x  {e.key[:90]}")
    out = Profile((device_us / 1e3, n_launches, port))
    out.groups = {k: us / 1e3 for k, us in groups.items()}
    return out


def card(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the first card's, or
    ``device``'s index); "cpu" for a CPU device."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]
