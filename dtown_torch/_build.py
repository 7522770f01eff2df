"""Build and load the CUDA kernels of dtown_torch.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface, ``build/dtown_torch/<name>-<hash>.so`` at the
repo root, at first use; the libraries are loaded with ctypes. The hash
covers the sources and the flags, so an edited source rebuilds. All
sources can be compiled at once (one nvcc process each) with
``build_all()``. ``kernel(...)`` binds one entry point of a library and
is how every kernel of the package is launched.

A failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from dtown_torch.utils import profiling

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dtown_torch")

# No fast math and no FMA contraction: every float op rounds once, as in
# the plain torch versions, so kernel and plain version agree to the bit
# (the state step's discrete rows such as done/collision must agree
# exactly). Contraction is a speed lever left for later.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("state_kernel", "blob_render", "row_render", "fma_probe",
           "conv8s4", "conv3s1")

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            p = os.path.join(root, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of dtown_torch "
                           "build only where the CUDA toolkit is installed")
    return p


def _lib_path(name) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc()] + NVCC_FLAGS + [
        "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, started):
    """Wait for one nvcc; returns its output (ptxas register report)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Compile every source at once (one nvcc each). Returns name -> nvcc
    output for the sources that were built now."""
    started, logs = {}, {}
    try:
        for n in SOURCES:
            started[n] = _start(n)
        for n in SOURCES:
            logs[n] = _finish(n, started[n])
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return logs


def load(name) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
    return lib


# ctypes of kernel(...)'s argument codes (struct's letters)
_CTYPES = {"P": ctypes.c_void_p, "q": ctypes.c_longlong, "i": ctypes.c_int}


def kernel(source, symbol, codes, name):
    """A launcher of the entry ``symbol`` of csrc/<source>.cu, whose
    arguments are given by ``codes`` ("P" a pointer, "q" a long long, "i"
    an int) and then a CUDA stream, and which returns a CUDA error code.
    The launcher takes the entry's arguments and then the device, and
    passes that device's current stream. It loads the library at its
    first call, raises RuntimeError on a nonzero return and counts each
    launch as ``launches.<name>``."""
    fn = None

    def launch(*args):
        nonlocal fn
        if fn is None:
            fn = getattr(load(source), symbol)
            fn.argtypes = [_CTYPES[c] for c in codes] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        *args, device = args
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        profiling.count(f"launches.{name}")
    return launch
