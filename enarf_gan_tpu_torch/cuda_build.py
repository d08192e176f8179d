"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``csrc/`` into ``_build/`` beside this file, keyed by a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
loads the library already built. The sources have a plain C interface and
include none of PyTorch's headers, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence, Tuple

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


def build_library(name: str, sources: Sequence[str]
                  ) -> Tuple[ctypes.CDLL, str]:
    """Compile ``sources`` (paths relative to csrc/) into one shared library
    and load it. Returns (library, compiler log); the log is empty when the
    library was already built."""
    paths = [os.path.join(_HERE, "csrc", s) for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent build never loads half
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(out), log


class KernelLibrary:
    """One kernel's library, built at first use, and its launch count.

    ``load()`` builds ``csrc/<name>.cu`` and returns its C entry point
    ``symbol`` with ``argtypes`` and an int result (a CUDA error code).
    ``launches`` goes up by one for every launch of the CUDA kernel and for
    nothing else: the wrapper calls ``count`` after a launch succeeds, and
    callers ``reset_counts()`` to count the launches of one run.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name, self.symbol, self.argtypes = name, symbol, list(argtypes)
        self.lib = None
        self.fn = None
        self.build_log = ""
        self.launches = 0

    def load(self):
        if self.fn is None:
            self.lib, self.build_log = build_library(self.name,
                                                     [f"{self.name}.cu"])
            fn = getattr(self.lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self.fn = fn
        return self.fn

    def count(self):
        self.launches += 1

    def reset_counts(self):
        self.launches = 0
