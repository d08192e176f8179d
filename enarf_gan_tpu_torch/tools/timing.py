"""Timing harness of the probes: CUDA events around a loop of launches.

The port's counterpart of ``tools/tpu_timeit.py``. That harness ran each op
``iters`` times inside one jitted ``scan`` and perturbed an argument by a
checksum of the last result, so that XLA could not merge the iterations
into one, and it fetched a scalar to the host because ``block_until_ready``
did not fence on the remote TPU runtime. None of that is needed here:
PyTorch runs eagerly and launches every call it is given, launches on one
stream run in order, and two CUDA events recorded on that stream bracket
exactly the device work between them. So ``cuda_time_ms`` warms up, records
an event, launches the call ``reps`` times, records a second event,
synchronises, and divides. The launches queue up faster than the card
drains them whenever a call takes more than a few microseconds, so the host
does not enter the time; for calls shorter than that it does. So
``launch_us`` takes the two apart: it queues a spin kernel that holds the
card (``constructs.hold``), enqueues n calls while it spins (the host clock
over them is the host's cost of a call) and brackets them with CUDA events,
which then time the n calls run back to back on the card (the device's cost
of a call).

A probe is a ``Case``: the kernel's wrapper, its plain PyTorch twin, the
one PyTorch call that computes the same function where there is one, the
tolerance, and the bytes and operations its bound counts. ``check`` holds
kernel against twin, ``measure`` times kernel, twin and library call (in
turns: plain, kernel, kernel, plain) and the host and device µs a call of
the kernel and the library call. Every module's ``main`` runs its
sweep through ``run_cli``: one JSON line a case, on the card, or with
``--device cpu`` only the plain versions at small sizes; ``--against DIR``
times each case beside another tree's version of it (``other_tree``).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import sys
import time
from typing import Callable, Iterable, Optional

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM float32, no tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50e6                # H100 L2 cache


@dataclasses.dataclass
class Case:
    """One probe at one size. ``kernel``, ``plain`` and ``library`` take no
    arguments and return a tensor or a tuple of tensors; ``counter`` is
    (KernelLibrary, key) of the kernel's launch count. ``extra_library``
    names more PyTorch calls timed beside the library call (yardsticks of
    a nearby function, such as a lower-precision output)."""
    name: str
    replaces: str
    source: str
    kernel: Callable
    plain: Callable
    counter: tuple
    nbytes: float
    flops: float = 0.0
    rate: float = F32_FLOPS
    library: Optional[Callable] = None
    rtol: float = 0.0
    atol: float = 0.0
    info: dict = dataclasses.field(default_factory=dict)
    extra_library: dict = dataclasses.field(default_factory=dict)


def cuda_time_ms(fn: Callable, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_us(fn: Callable, ms_once: Optional[float] = None,
              spin_ms: float = 20.0, max_calls: int = 400) -> tuple:
    """(host µs a call, device µs a call) of ``fn``: n calls enqueued while
    a spin kernel of ``spin_ms`` holds the card, the host clock around the
    enqueueing, CUDA events around the n calls (which the card then runs
    back to back). n fills half the spin on the host and at most
    ``spin_ms`` on the card (``ms_once``: the device ms of one call, timed
    here if not given). Where the enqueueing outlasted the spin (a host
    slower than its first three calls said: the card then ran the calls
    with gaps), the n calls are timed again behind a spin twice as long,
    three times at most; raises if they still outlast it."""
    from enarf_gan_tpu_torch.tools.constructs import hold
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    if ms_once is None:
        ms_once = cuda_time_ms(fn, 1, 0)
    n = int(max(3, min(max_calls, 0.5e-3 * spin_ms / max(host_s, 1e-7),
                       spin_ms / max(ms_once, 1e-4))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        hold(spin_ms)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        if t1 - t0 <= spin_ms * 1e-3:
            return (t1 - t0) / n * 1e6, start.elapsed_time(end) / n * 1e3
        spin_ms *= 2
    raise RuntimeError(f"{n} calls took {(t1 - t0) * 1e3:.1f} ms to "
                       f"enqueue, longer than the {spin_ms / 2} ms spin")


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    """The least time the card could take: the larger of bytes over the HBM
    rate and the operations over the peak ``rate`` of their type. Returns
    (ms, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def check(case: Case) -> float:
    """Kernel vs plain on the same inputs within (rtol, atol); returns the
    max abs error. Raises AssertionError on a disagreement."""
    with torch.no_grad():
        got = _as_tuple(case.kernel())
        if got[0].is_cuda:
            torch.cuda.synchronize()
        ref = _as_tuple(case.plain())
    err = 0.0
    for a, b in zip(got, ref):
        assert a.shape == b.shape, (case.name, a.shape, b.shape)
        torch.testing.assert_close(a.float(), b.float(), rtol=case.rtol,
                                   atol=case.atol, msg=lambda m: f"{case.name}: {m}")
        err = max(err, float((a.float() - b.float()).abs().max()))
    return err


def reps_for(ms_once: float, budget_ms: float = 40.0, lo: int = 2,
             hi: int = 200) -> int:
    return int(min(hi, max(lo, budget_ms // max(ms_once, 1e-3))))


def _launches(case: Case) -> int:
    lib, key = case.counter
    return lib.launches_by[key]


def measure(case: Case, budget_ms: float = 40.0) -> dict:
    """Times of kernel, plain and library call (ms), each after a warm-up,
    the kernel and plain in turns (plain, kernel, kernel, plain), and the
    case's bound; the host and device µs a call (``launch_us``) of the
    kernel and the library call; each ``extra_library`` call's ms as
    ``library_<name>_ms``. Launches of the kernel go to its count;
    ``launches`` are those of the timing in ms (the launch-cost calls
    excluded)."""
    with torch.no_grad():
        before = _launches(case)
        k_once = cuda_time_ms(case.kernel, 1)
        k_reps = reps_for(k_once, budget_ms)
        p_reps = reps_for(cuda_time_ms(case.plain, 1), budget_ms, hi=20)
        times = [cuda_time_ms(case.plain, p_reps, 0),
                 cuda_time_ms(case.kernel, k_reps, 0),
                 cuda_time_ms(case.kernel, k_reps, 0),
                 cuda_time_ms(case.plain, p_reps, 0)]
        launches = _launches(case) - before
        host_us, device_us = launch_us(case.kernel, k_once)
        lib_ms = lib_host_us = lib_device_us = None
        if case.library is not None:
            lib_once = cuda_time_ms(case.library, 1)
            lib_ms = cuda_time_ms(case.library, reps_for(lib_once, budget_ms))
            lib_host_us, lib_device_us = launch_us(case.library, lib_once)
        extra = {f"library_{k}_ms": cuda_time_ms(
                     fn, reps_for(cuda_time_ms(fn, 1), budget_ms))
                 for k, fn in case.extra_library.items()}
    bound_ms, bound_by = bound(case.nbytes, case.flops, case.rate)
    return {"ms": (times[1] + times[2]) / 2, "plain_ms": (times[0] + times[3]) / 2,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "device_us": device_us, "host_us": host_us,
            "library_device_us": lib_device_us,
            "library_host_us": lib_host_us, "launches": launches, **extra}


def record(case: Case, err: Optional[float], times: Optional[dict],
           device: str) -> dict:
    """One JSON-ready line of a case."""
    out = {"probe": case.name, "replaces": case.replaces,
           "source": case.source, "device": device, **case.info,
           "bytes": case.nbytes, "flops": case.flops}
    if err is not None:
        out["max_abs_err"] = err
    if times is not None:
        out.update(times)
        if times["ms"] > 0:
            out["GB_per_s"] = case.nbytes / times["ms"] / 1e6
            if case.flops:
                out["TFLOP_per_s"] = case.flops / times["ms"] / 1e9
            for key, rate in (("rows", "Mrows_per_s"), ("S", "Msamples_per_s")):
                if key in case.info:
                    out[rate] = case.info[key] / times["ms"] / 1e3
    return out


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def other_tree(module, root: str):
    """Probe ``module`` of this package as the tree at ``root`` has it (for
    example an earlier commit unpacked by ``git archive`` into a directory
    that .gitignore lists): its file loaded under another name, and each
    ``KernelLibrary`` it holds at module level built from that tree's source
    under the library name ``<name>_other``."""
    from enarf_gan_tpu_torch.cuda_build import KernelLibrary
    qual = module.__spec__.name            # also when run as __main__
    spec = importlib.util.spec_from_file_location(
        qual + "_other", os.path.join(root, qual.replace(".", os.sep) + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    csrc = os.path.join(os.path.abspath(root), "enarf_gan_tpu_torch", "csrc")
    for name, lib in list(vars(mod).items()):
        if isinstance(lib, KernelLibrary):
            setattr(mod, name, KernelLibrary(
                lib.name + "_other", lib.symbol, lib.argtypes, keys=lib.keys,
                symbols=lib.symbols, source=os.path.join(csrc, lib.source),
                flags=lib.flags))
    return mod


def _same_inputs(case: Case, other: Case) -> bool:
    """The two cases replace one TPU kernel, and every ``info`` key they
    share (the shapes, the window mode) has the same value."""
    return case.replaces == other.replaces and all(
        case.info[k] == v for k, v in other.info.items() if k in case.info)


def pair_cases(mine: list, theirs: list) -> list:
    """(case, the other tree's case or None): by name, then the rest by
    the TPU kernel they replace, in order; then each other case still left
    (a kernel the other tree has beside its own for the same function)
    after the first case of these with the same inputs, as one more
    pair."""
    left = {c.name: c for c in theirs}
    out = [(c, left.pop(c.name, None)) for c in mine]
    for i, (c, o) in enumerate(out):
        if o is None:
            o = next((t for t in left.values() if t.replaces == c.replaces),
                     None)
            if o is not None:
                out[i] = (c, left.pop(o.name))
    for o in left.values():
        i = next((i for i, (c, _) in enumerate(out) if _same_inputs(c, o)),
                 None)
        if i is not None:
            out.insert(i + 1, (out[i][0], o))
    return out


def against(case: Case, other: Case, budget_ms: float = 40.0) -> dict:
    """``measure`` of a case and of the other tree's counterpart in turns
    (case, other, other, case), averaged; the other's as ``other_*``."""
    runs = [measure(c, budget_ms) for c in (case, other, other, case)]
    keys = ("ms", "device_us", "host_us")
    out = dict(runs[0])
    for k in keys:
        out[k] = (runs[0][k] + runs[3][k]) / 2
    out["launches"] = runs[0]["launches"] + runs[3]["launches"]
    out.update({"other_probe": other.name,
                **{f"other_{k}": (runs[1][k] + runs[2][k]) / 2 for k in keys}})
    return out


def run_cli(cases: Callable[[torch.device, str], Iterable[Case]],
            argv=None, doc: str = "") -> list:
    """A probe module's ``main``: the sweep on the card (each case checked
    against its plain twin, then timed), or with ``--device cpu`` the plain
    versions at the small size. Prints one JSON line a case. ``--only``
    keeps the cases whose name matches; ``--against DIR`` also checks and
    times each case's counterpart in another tree (``other_tree``,
    ``pair_cases``) in turns with it."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0] if doc else None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the sweep on the card) or cpu (the "
                         "plain versions at small sizes)")
    ap.add_argument("--size", choices=("check", "main", "sweep"),
                    help="the cases' size (default: sweep on the card, "
                         "check on the CPU)")
    ap.add_argument("--only", default="", help="a regular expression of the "
                    "case names to run")
    ap.add_argument("--against", metavar="DIR",
                    help="another tree's root, whose version of each case is "
                         "timed beside it (on the card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: the probes run on an NVIDIA GPU; pass "
                 "--device cpu for the plain versions")
    if args.against and device.type != "cuda":
        sys.exit("--against times kernels: it runs on the card")
    size = args.size or ("sweep" if device.type == "cuda" else "check")
    name = device_name(device)
    only = re.compile(args.only)
    selected = (c for c in cases(device, size) if only.search(c.name))
    pairs = ((c, None) for c in selected)    # one case's tensors at a time
    if args.against:
        selected = list(selected)
        module = other_tree(sys.modules[cases.__module__], args.against)
        replaced = {c.replaces for c in selected}
        pairs = pair_cases(selected, [
            c for c in module.cases(device, size) if c.replaces in replaced])
    lines = []
    for case, other in pairs:
        if device.type == "cuda":
            err = check(case)
            if other is None:
                line = record(case, err, measure(case), name)
            else:
                line = record(case, err, against(case, other), name)
                line["other_max_abs_err"] = check(other)
        else:
            with torch.no_grad():
                out = _as_tuple(case.plain())
            line = record(case, None, None, name)
            line["shapes"] = [list(t.shape) for t in out]
            line["finite"] = bool(all(torch.isfinite(t.float()).all()
                                      for t in out))
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines
