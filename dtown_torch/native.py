"""ctypes binding to the repo's C++ map compiler, ``native/mapc.cpp``.

Counterpart of dtown/native/__init__.py. The library is built from the
source at first use with the flags of native/build.sh into
``build/dtown_torch/libdtown_mapc-<hash>.so`` at the repo root (the hash
covers the source and the flags, so an edited source rebuilds); nothing
is ever written into ``native/``. A failed build, or a library whose
struct sizes or ABI version differ from this module's, raises: there is
no silent fallback. The python compiler (map_loader.py) stays the
reference, and tests/test_torch_native.py holds the two together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from dtown_torch._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "mapc.cpp")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]

MAXG = 32
MAXC = 12
MAXO = 64
BANK = 2048
MAXW = (MAXG * MAXG + 3) // 4


class CMap(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int32),
        ("W", ctypes.c_int32),
        ("n_objects", ctypes.c_int32),
        ("max_objects", ctypes.c_int32),
        ("tile_size", ctypes.c_double),
        ("tile_kind", ctypes.c_int32 * (MAXG * MAXG)),
        ("tile_angle", ctypes.c_int32 * (MAXG * MAXG)),
        ("drivable", ctypes.c_uint8 * (MAXG * MAXG)),
        ("curves", ctypes.c_double * (MAXG * MAXG * MAXC * 4 * 3)),
        ("curve_mask", ctypes.c_uint8 * (MAXG * MAXG * MAXC)),
        ("obj_pos", ctypes.c_double * (MAXO * 3)),
        ("obj_y_rot", ctypes.c_double * MAXO),
        ("obj_scale", ctypes.c_double * MAXO),
        ("obj_height", ctypes.c_double * MAXO),
        ("obj_halfdims", ctypes.c_double * (MAXO * 2)),
        ("obj_corners", ctypes.c_double * (MAXO * 4 * 2)),
        ("obj_norms", ctypes.c_double * (MAXO * 2 * 2)),
        ("obj_safety_rad", ctypes.c_double * MAXO),
        ("obj_kind", ctypes.c_int32 * MAXO),
        ("obj_mask", ctypes.c_uint8 * MAXO),
        ("obj_optional", ctypes.c_uint8 * MAXO),
        ("obj_dynamic", ctypes.c_uint8 * MAXO),
        ("obj_walk_dist", ctypes.c_double * MAXO),
        ("spawn_pos", ctypes.c_double * (BANK * 3)),
        ("spawn_angle", ctypes.c_double * BANK),
        ("spawn_lane_deg", ctypes.c_double * BANK),
        ("spawn_mask", ctypes.c_uint8 * BANK),
        ("n_words", ctypes.c_int32),
        ("tile_words", ctypes.c_int32 * MAXW),
        ("obj_sincos", ctypes.c_double * (MAXO * 2)),
        ("obj_lmodel", ctypes.c_double * (MAXO * 3)),
        ("obj_bound_rad", ctypes.c_double * MAXO),
    ]


N_OBJ_KINDS = 21
P_MAX = 4


class CPrims(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int32 * (N_OBJ_KINDS * P_MAX)),
        ("center", ctypes.c_double * (N_OBJ_KINDS * P_MAX * 3)),
        ("param", ctypes.c_double * (N_OBJ_KINDS * P_MAX * 3)),
        ("color", ctypes.c_double * (N_OBJ_KINDS * P_MAX * 3)),
        ("mask", ctypes.c_uint8 * (N_OBJ_KINDS * P_MAX)),
        ("phase", ctypes.c_uint8 * (N_OBJ_KINDS * P_MAX)),
    ]


ABI_VERSION = 3


def cxx() -> str | None:
    """Path of g++, or None."""
    return shutil.which("g++")


def build_library(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile ``source`` with g++ into ``build_dir`` unless that build
    exists; returns the library's path. Raises RuntimeError when g++ is
    missing or fails."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    out = os.path.join(build_dir, f"libdtown_mapc-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    compiler = cxx()
    if compiler is None:
        raise RuntimeError("g++ not found: the native map compiler builds "
                           "only where a C++ compiler is installed")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler] + CXX_FLAGS + ["-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def check_abi(lib):
    """Raise RuntimeError naming each of the struct sizes and the ABI
    version that differ between the library and this module."""
    checks = {
        "CMap sizeof": (lib.dtown_mapc_sizeof(), ctypes.sizeof(CMap)),
        "CPrims sizeof": (lib.dtown_prims_sizeof(), ctypes.sizeof(CPrims)),
        "abi version": (lib.dtown_mapc_abi_version(), ABI_VERSION),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise RuntimeError("native map compiler ABI mismatch (library, "
                           "binding): " + ", ".join(
                               f"{k} {a} != {b}" for k, (a, b) in bad.items()))


def load_library(path: str) -> ctypes.CDLL:
    """Load the library at ``path``, declare its functions and check its
    ABI (check_abi)."""
    lib = ctypes.CDLL(path)
    lib.dtown_compile_map.argtypes = [ctypes.c_char_p, ctypes.POINTER(CMap)]
    lib.dtown_compile_map.restype = ctypes.c_int
    lib.dtown_prim_tables.argtypes = [ctypes.POINTER(CPrims)]
    lib.dtown_prim_tables.restype = ctypes.c_int
    for fn in ("dtown_mapc_sizeof", "dtown_prims_sizeof",
               "dtown_mapc_abi_version"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    check_abi(lib)
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return load_library(build_library())


def available() -> bool:
    """Whether g++ is present and builds the library."""
    if cxx() is None:
        return False
    try:
        build_library()
    except RuntimeError:
        return False
    return True


def compile_map_native(path: str) -> dict:
    """Compile a map yaml with the C++ compiler -> dict of numpy arrays
    (unpadded to the map's actual H, W, max_objects)."""
    out = CMap()
    rc = _lib().dtown_compile_map(path.encode(), ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"native map compile failed (rc={rc}) for {path}")
    H, W, M = out.H, out.W, out.max_objects

    def arr(field, shape, dtype, crop):
        a = np.ctypeslib.as_array(getattr(out, field)).astype(dtype)
        return a.reshape(shape)[crop].copy()

    g = (slice(0, H), slice(0, W))
    o = slice(0, M)
    return dict(
        H=H, W=W, max_objects=M, n_objects=out.n_objects,
        tile_size=float(out.tile_size),
        tile_kind=arr("tile_kind", (MAXG, MAXG), np.int32, g),
        tile_angle=arr("tile_angle", (MAXG, MAXG), np.int32, g),
        drivable=arr("drivable", (MAXG, MAXG), bool, g),
        curves=arr("curves", (MAXG, MAXG, MAXC, 4, 3), np.float64, g),
        curve_mask=arr("curve_mask", (MAXG, MAXG, MAXC), bool, g),
        obj_pos=arr("obj_pos", (MAXO, 3), np.float64, o),
        obj_y_rot=arr("obj_y_rot", (MAXO,), np.float64, o),
        obj_scale=arr("obj_scale", (MAXO,), np.float64, o),
        obj_height=arr("obj_height", (MAXO,), np.float64, o),
        obj_halfdims=arr("obj_halfdims", (MAXO, 2), np.float64, o),
        obj_corners=arr("obj_corners", (MAXO, 4, 2), np.float64, o),
        obj_norms=arr("obj_norms", (MAXO, 2, 2), np.float64, o),
        obj_safety_rad=arr("obj_safety_rad", (MAXO,), np.float64, o),
        obj_kind=arr("obj_kind", (MAXO,), np.int32, o),
        obj_mask=arr("obj_mask", (MAXO,), bool, o),
        obj_optional=arr("obj_optional", (MAXO,), bool, o),
        obj_dynamic=arr("obj_dynamic", (MAXO,), bool, o),
        obj_walk_dist=arr("obj_walk_dist", (MAXO,), np.float64, o),
        spawn_pos=arr("spawn_pos", (BANK, 3), np.float64, slice(None)),
        spawn_angle=arr("spawn_angle", (BANK,), np.float64, slice(None)),
        spawn_lane_deg=arr("spawn_lane_deg", (BANK,), np.float64,
                           slice(None)),
        spawn_mask=arr("spawn_mask", (BANK,), bool, slice(None)),
        n_words=int(out.n_words),
        tile_words=arr("tile_words", (MAXW,), np.int32,
                       slice(0, out.n_words)),
        obj_sincos=arr("obj_sincos", (MAXO, 2), np.float64, o),
        obj_lmodel=arr("obj_lmodel", (MAXO, 3), np.float64, o),
        obj_bound_rad=arr("obj_bound_rad", (MAXO,), np.float64, o),
    )


def prim_tables_native() -> dict:
    """Primitive render-model tables baked by the native compiler (the
    counterpart of render/meshes.py::prim_tables over the built-in
    kinds)."""
    out = CPrims()
    rc = _lib().dtown_prim_tables(ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"native prim table bake failed (rc={rc})")

    def arr(field, shape, dtype):
        return np.ctypeslib.as_array(getattr(out, field)).astype(
            dtype).reshape(shape).copy()

    K, P = N_OBJ_KINDS, P_MAX
    return dict(
        type=arr("type", (K, P), np.int32),
        center=arr("center", (K, P, 3), np.float64),
        param=arr("param", (K, P, 3), np.float64),
        color=arr("color", (K, P, 3), np.float64),
        mask=arr("mask", (K, P), bool),
        phase=arr("phase", (K, P), bool),
    )
