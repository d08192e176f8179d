"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``csrc/`` into ``_build/`` beside this file, keyed by a hash
of the sources, the headers of ``csrc/`` and the flags, so a changed source
rebuilds and an unchanged one loads the library already built. The sources have a plain C interface and
include none of PyTorch's headers, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return path


def build_library(name: str, sources: Sequence[str], flags: Sequence[str] = ()
                  ) -> Tuple[ctypes.CDLL, str]:
    """Compile ``sources`` (paths relative to csrc/) into one shared library
    with ``flags`` added to ``NVCC_FLAGS``, and load it. Returns (library,
    compiler log); the log is empty when the library was already built."""
    paths = [os.path.join(_HERE, "csrc", s) for s in sources]
    headers = sorted(os.path.join(_HERE, "csrc", h)
                     for h in os.listdir(os.path.join(_HERE, "csrc"))
                     if h.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for p in paths + headers:
        with open(p, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp,
                                   *paths],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent build never loads half
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(out), log


def raw_stream(t) -> int:
    """The handle of the current CUDA stream of ``t``'s device, for a
    kernel's launch, without building a ``torch.cuda.Stream`` (which costs a
    call microseconds of host time)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


class KernelLibrary:
    """One kernel's library, built at first use, and its launch count.

    ``load()`` builds ``csrc/<name>.cu`` (or ``source``, with the extra nvcc
    ``flags``) and returns its C entry point ``symbol`` with ``argtypes``
    and an int result (a CUDA error code); a library with more entry points
    names them in ``symbols`` ({name: argtypes}), and ``load(name)`` returns
    that one. ``build_seconds`` is the time of its nvcc run (0 when it was
    already built).
    ``launches`` goes up by one for every launch of the CUDA kernel and for
    nothing else: the wrapper calls ``count`` after a launch succeeds, and
    callers ``reset_counts()`` to count the launches of one run. A library
    built for several variants (member counts, modes) names them in
    ``keys``; ``count(key)`` then also adds one to ``launches_by[key]``.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 keys: Sequence = (), symbols: Optional[dict] = None,
                 source: Optional[str] = None, flags: Sequence[str] = ()):
        self.name, self.symbol, self.argtypes = name, symbol, list(argtypes)
        self.symbols = {symbol: self.argtypes, **(symbols or {})}
        self.source = source or f"{name}.cu"
        self.flags = tuple(flags)
        self.keys = tuple(keys)
        self.lib = None
        self.fn = None
        self.fns = {}
        self.build_log = ""
        self.build_seconds = 0.0
        self.reset_counts()

    def load(self, symbol: Optional[str] = None):
        if self.lib is None:
            t0 = time.perf_counter()
            self.lib, self.build_log = build_library(self.name, [self.source],
                                                     self.flags)
            if self.build_log:
                self.build_seconds = time.perf_counter() - t0
            for sym, argtypes in self.symbols.items():
                fn = getattr(self.lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                self.fns[sym] = fn
            self.fn = self.fns[self.symbol]
        return self.fns[symbol or self.symbol]

    def count(self, key=None):
        self.launches += 1
        if self.keys:
            self.launches_by[key] += 1

    def reset_counts(self):
        self.launches = 0
        self.launches_by = {k: 0 for k in self.keys}
