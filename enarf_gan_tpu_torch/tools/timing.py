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
does not enter the time; for calls shorter than that it does, which is what
``constructs.launch_cost`` measures on purpose.

A probe is a ``Case``: the kernel's wrapper, its plain PyTorch twin, the
one PyTorch call that computes the same function where there is one, the
tolerance, and the bytes and operations its bound counts. ``check`` holds
kernel against twin, ``measure`` times kernel, twin and library call (in
turns: plain, kernel, kernel, plain). Every module's ``main`` runs its
sweep through ``run_cli``: one JSON line a case, on the card, or with
``--device cpu`` only the plain versions at small sizes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
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
    (KernelLibrary, key) of the kernel's launch count."""
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


def measure(case: Case, budget_ms: float = 40.0) -> dict:
    """Times of kernel, plain and library call (ms), each after a warm-up,
    the kernel and plain in turns (plain, kernel, kernel, plain), and the
    case's bound. Launches of the kernel go to its count."""
    with torch.no_grad():
        k_reps = reps_for(cuda_time_ms(case.kernel, 1), budget_ms)
        p_reps = reps_for(cuda_time_ms(case.plain, 1), budget_ms, hi=20)
        times = [cuda_time_ms(case.plain, p_reps, 0),
                 cuda_time_ms(case.kernel, k_reps, 0),
                 cuda_time_ms(case.kernel, k_reps, 0),
                 cuda_time_ms(case.plain, p_reps, 0)]
        lib_ms = None
        if case.library is not None:
            lib_ms = cuda_time_ms(case.library,
                                  reps_for(cuda_time_ms(case.library, 1),
                                           budget_ms))
    bound_ms, bound_by = bound(case.nbytes, case.flops, case.rate)
    return {"ms": (times[1] + times[2]) / 2, "plain_ms": (times[0] + times[3]) / 2,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}


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


def run_cli(cases: Callable[[torch.device, str], Iterable[Case]],
            argv=None, doc: str = "") -> list:
    """A probe module's ``main``: the sweep on the card (each case checked
    against its plain twin, then timed), or with ``--device cpu`` the plain
    versions at the small size. Prints one JSON line a case."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0] if doc else None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the sweep on the card) or cpu (the "
                         "plain versions at small sizes)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: the probes run on an NVIDIA GPU; pass "
                 "--device cpu for the plain versions")
    name = device_name(device)
    lines = []
    for case in cases(device, "sweep" if device.type == "cuda" else "check"):
        if device.type == "cuda":
            line = record(case, check(case), measure(case), name)
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
