"""The one launch path of every kernel wrapper: bind a library's
`extern "C"` launchers once, then call them on PyTorch's current stream.

Each launcher of csrc/*.cu takes its arguments, then the stream, and
returns the CUDA error of its launch (0 = launched).  `bind` loads the
library (building it on first use) and fixes each function's ctypes
signature once; the wrappers keep the bound functions, so a launch does
no lookup on the library.  `launch` enters the tensors' device only
where it is not the current one, takes the raw handle of that device's
current stream (never a kept one: the current stream can change between
calls) and raises on a refused launch.  A wrapper's Python path then
costs about as much as one PyTorch operator's.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Sequence

import torch

PTR = ctypes.c_void_p
I32 = ctypes.c_int


def bind(library: str, signatures: Dict[str, Sequence], src=None,
         flags=None) -> Dict[str, Callable]:
    """Load csrc/<library>.cu's shared library (or the one built from
    `src`, another revision of that source, or with other nvcc `flags`
    than build.NVCC_FLAGS) and return its launchers by name, each with
    `argtypes` (the given ones, then the stream) and an int `restype`
    set."""
    from .build import NVCC_FLAGS, load_library
    lib = load_library(library, src, NVCC_FLAGS if flags is None else flags)
    bound = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes) + [PTR]
        fn.restype = I32
        bound[name] = fn
    return bound


def _raw_stream(index: int) -> int:
    """The handle (cudaStream_t as an int) of the current stream of CUDA
    device `index`."""
    return torch.cuda.current_stream(index).cuda_stream


# torch's own binding returns the handle without building a Stream object;
# the public path serves where a build lacks it
stream_of = getattr(torch._C, "_cuda_getCurrentRawStream", _raw_stream)


def launch(fn: Callable, dev: torch.device, *args) -> None:
    """Call the bound launcher `fn(*args, stream)` on the current stream
    of the CUDA device `dev`; raise, naming it, if the launch was
    refused."""
    cur = torch.cuda.current_device()
    index = cur if dev.index is None else dev.index
    if index == cur:
        err = fn(*args, stream_of(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream_of(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with CUDA error "
                           f"{err}")
