"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain `extern "C"` launcher and compiles
on its own into `build/kernels/lib<name>-<hash>.so` at the repository
root, where the hash covers the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing is built when
the package is imported: the first launch builds.

Flags: Hopper only (`sm_90a`), `-O3`, and `--fmad=false` so that nvcc
does not contract a*b+c into FMAs; with IEEE division (nvcc's default)
each kernel then rounds exactly as its plain torch version does, op for
op, which keeps hit decisions on edge-grazing rays identical.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

# name -> (seconds spent compiling, nvcc's output); only for fresh builds
build_log: Dict[str, tuple] = {}


def nvcc() -> str:
    """Path of nvcc under torch's CUDA_HOME ($CUDA_HOME, $CUDA_PATH, the
    nvcc on PATH, or the toolkit's default location)."""
    from torch.utils.cpp_extension import CUDA_HOME
    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.isfile(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH")
    return path


def library_path(name: str, src: Optional[Path] = None,
                 flags: Sequence[str] = NVCC_FLAGS) -> Path:
    src = src or CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, src: Optional[Path] = None,
          flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile csrc/<name>.cu (or `src`, another revision of it, under the
    same library name and its own hash) unless an up-to-date library
    exists.  `flags` other than NVCC_FLAGS are for measurements beside the
    shipped build (a probe that times a source with FMA allowed)."""
    src = src or CSRC / f"{name}.cu"
    out = library_path(name, src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *flags, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    key = name if (src == CSRC / f"{name}.cu"
                   and tuple(flags) == NVCC_FLAGS) else f"{src} {flags}"
    build_log[key] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def load_library(name: str, src: Optional[Path] = None,
                 flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, src, flags)))
