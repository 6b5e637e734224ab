"""The threefry-2x32 draws of sampling/rng.py as one hand-written kernel.

sampling/rng.py computes threefry-2x32 as int64 torch operations, about
170 launches a draw.  On the card each draw is instead one launch of
csrc/rng_kernel.cu, with the same bits: `uniform_ids` (counter
(pixel id, bounce * 16 + decision) -> float32 in [0, 1)) and
`random_bits` (counter (0, offset + i) -> the word y0 ^ y1 as int64, or
jax.random.uniform's float32 of it).  The keys stay Python ints derived
on the host and reach the launch as scalars: no copy to the card, no
wait.  The plain version is sampling/rng.py's torch path, which the CPU
takes and which tests/test_torch_rng.py holds to jax.random; rng.py
dispatches (`rng.takes_kernel`), this module only launches, and raises
for a tensor that is not on the card.

`launches` counts kernel launches, `lanes` the lanes they hashed.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .launch import I32, PTR, bind, launch

U32 = ctypes.c_uint32
I64 = ctypes.c_longlong

launches = 0             # kernel launches since import (or the last reset)
lanes = 0                # the lanes those launches hashed
_lib = None


def _library():
    """csrc/rng_kernel.cu's launchers, bound once."""
    global _lib
    if _lib is None:
        _lib = bind("rng_kernel",
                    {"rng_uniform_ids": [PTR, I32, I64, U32, U32, U32, PTR],
                     "rng_random_bits": [I64, I64, U32, U32, I32, PTR]})
    return _lib


def _on_card(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no rng kernel for device {dev}")


def uniform_ids(key: Tuple[int, int], counter: int, ids: torch.Tensor
                ) -> torch.Tensor:
    """U[0,1) float32 of `ids`' shape: threefry of (id, counter) under
    `key`, its first word's top 24 bits times 2^-24.  `ids` are int32 or
    int64 on the card (the launcher refuses other widths); only their low
    32 bits enter."""
    global launches, lanes
    _on_card(ids.device)
    ids = ids.contiguous()
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    n = ids.numel()
    if n:
        launch(_library()["rng_uniform_ids"], ids.device, ids.data_ptr(),
               ids.element_size(), n, key[0], key[1], counter,
               out.data_ptr())
        launches += 1
        lanes += n
    return out


def random_bits(key: Tuple[int, int], n: int, offset: int,
                device: torch.device, unit_float: bool) -> torch.Tensor:
    """The n words y0 ^ y1 of threefry (0, offset + i) under `key`, as a
    1-D int64 tensor, or with `unit_float` their jax.random.uniform floats
    (float32 in [0, 1)).  The counters must lie in [0, 2^32): rng.py
    checks them, and the launcher refuses others."""
    global launches, lanes
    _on_card(device)
    out = torch.empty(n, dtype=torch.float32 if unit_float else torch.int64,
                      device=device)
    if n:
        launch(_library()["rng_random_bits"], device, offset, n, key[0],
               key[1], int(unit_float), out.data_ptr())
        launches += 1
        lanes += n
    return out
