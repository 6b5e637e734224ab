"""ctypes wrapper for the native C++ binned-SAH builder (native/).

Counterpart of raytracingrenderer_tpu/geometry/bvh_native.py: `build`
has the contract of geometry/bvh.py's `build` (flat depth-first arrays
and the triangle order) and calls `bvh_build_q` of the same C++ source,
which has no JAX in it.

Which library is loaded.  The committed `native/libbvh.so` was compiled
with `-march=native` on a host with AVX-512 and contains AVX-512 and FMA
instructions; on a CPU without them it dies with SIGILL, which no `try`
can catch.  So it is loaded only where /proc/cpuinfo lists every ISA
extension in `_COMMITTED_ISA` (there the trees equal the JAX package's,
which loads the same file).  Anywhere else `native/bvh_builder.cpp` is
compiled with g++ and the Makefile's flags into `build/native/` at the
repository root at first use, and that library is loaded.  There is no
silent fall-back to the Python builder, which would take minutes on a
scene of 300k triangles: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..scene.types import BVH

ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = ROOT / "native"
COMMITTED_LIB = NATIVE_DIR / "libbvh.so"
SOURCE = NATIVE_DIR / "bvh_builder.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
# ISA extensions the committed library's instructions need (zmm AVX-512
# F/BW/DQ/VL forms, FMA, AVX2).
_COMMITTED_ISA = frozenset({"avx512f", "avx512bw", "avx512dq", "avx512vl",
                            "avx2", "fma"})

_lib = None
source: Optional[str] = None   # path of the loaded library, once loaded


def cpu_flags(cpuinfo: str = "/proc/cpuinfo") -> frozenset:
    """ISA flags of the host CPU (empty if cpuinfo is unreadable)."""
    try:
        with open(cpuinfo) as f:
            for line in f:
                if line.startswith("flags"):
                    return frozenset(line.split(":", 1)[1].split())
    except OSError:
        pass
    return frozenset()


def committed_ok(flags: frozenset) -> bool:
    """True where the committed -march=native library can run."""
    return _COMMITTED_ISA <= flags


def _compile() -> Path:
    """g++ native/bvh_builder.cpp into build/native/ unless an
    up-to-date library exists; the name carries a hash of the source and
    the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libbvh-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    """The library this host loads (compiling it if needed)."""
    if committed_ok(cpu_flags()) and COMMITTED_LIB.is_file():
        return COMMITTED_LIB
    return _compile()


def _load() -> ctypes.CDLL:
    global _lib, source
    if _lib is None:
        path = library_path()
        lib = ctypes.CDLL(str(path))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.bvh_build_q.restype = ctypes.c_int
        lib.bvh_build_q.argtypes = [fp, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    fp, fp, ip, ip, ip, ip]
        if hasattr(lib, "alias_build"):   # lights/envmap.py's alias table
            lib.alias_build.restype = None
            lib.alias_build.argtypes = [ctypes.POINTER(ctypes.c_double),
                                        ctypes.c_int, fp, ip]
        _lib, source = lib, str(path)
    return _lib


def build(tp: np.ndarray, max_leaf: int = 4, bins: int = 16,
          all_axes: bool = False) -> Tuple[BVH, np.ndarray]:
    """tp: (T, 3, 3) vertex positions -> (flat BVH, triangle order)."""
    from .bvh import make_bvh
    t = len(tp)
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    lib = _load()
    verts = np.ascontiguousarray(tp.reshape(t, 9), np.float32)
    cap = 2 * t
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    order = np.empty(t, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = lib.bvh_build_q(
        verts.ctypes.data_as(fp), t, max_leaf, bins, int(all_axes),
        lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
        right.ctypes.data_as(ip), start.ctypes.data_as(ip),
        count.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if n <= 0:
        raise RuntimeError(f"native BVH build failed ({n}) for {t} "
                           f"triangles")
    return (make_bvh(lo[:n], hi[:n], right[:n], start[:n], count[:n]),
            order.astype(np.int64))
