"""Deterministic counter-based RNG, bit-exact with the JAX package.

Counterpart of raytracingrenderer_tpu/sampling/rng.py.  Every random
decision is keyed by (base seed, spp index, bounce, decision id) through
threefry-2x32 (20 rounds, Salmon et al. 2011) exactly as `jax.random`
computes it with `jax_threefry_partitionable` on, so the same key gives
the same bits in both packages and renders compare pixel by pixel.

A key is a pair of Python ints `(k0, k1)`, each a 32-bit word: keys are
tiny and are derived on the host (`fold_in` per sample and per
decision).  There is no `torch.Generator` and no global state.

Two paths compute the same bits.  On a CUDA device every draw is one
launch of csrc/rng_kernel.cu (ops/rng_kernel.py; `takes_kernel` is the
rule).  Elsewhere the draws run `threefry2x32` as int64 torch operations,
each masked with `& 0xFFFFFFFF` so that no intermediate overflows: the
CPU's path, and the kernel's oracle.  `plain_lanes_cuda` counts the lanes
that the torch operations drew on a CUDA device, which the rule leaves at
0.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import rng_kernel
from ..utils.profiling import spanned

# Decision ids: stable enumeration of every RNG consumption point so that
# adding a new decision never perturbs existing streams.
PIXEL_JITTER_X = 0
PIXEL_JITTER_Y = 1
LIGHT_PICK = 2
LIGHT_POS_U = 3
LIGHT_POS_V = 4
RR = 5
BSDF_U = 6
BSDF_V = 7
BSDF_LOBE = 8
LENS_U = 9
LENS_V = 10
LIGHT_AUX = 11
BND_PICK = 12
BND_EDGE = 13
BND_T = 14
BND_CELL = 15
_NUM_DECISIONS = 16

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

plain_lanes_cuda = 0     # lanes the torch operations drew on a CUDA device


def takes_kernel(device: torch.device) -> bool:
    """The dispatch rule: draws on a CUDA device launch the kernel."""
    return device.type == "cuda"


def _count_plain(device: torch.device, n: int) -> None:
    global plain_lanes_cuda
    if device.type == "cuda":
        plain_lanes_cuda += n


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 of the counter pair (x0, x1) under `key`.

    x0 and x1 are Python ints or int64 tensors holding 32-bit words
    (they broadcast); returns the hashed pair in the same form."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: the key [0, seed]."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return (0, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in`: hash the counter pair (0, data)."""
    return threefry2x32(key, 0, int(data) & MASK)


def spp_key(base_key: Key, spp_index: int) -> Key:
    return fold_in(base_key, spp_index)


def decision_key(key: Key, bounce: int, decision: int) -> Key:
    return fold_in(key, bounce * _NUM_DECISIONS + decision)


def split(key: Key) -> Tuple[Key, Key]:
    """`jax.random.split(key)` (partitionable threefry): key i of the
    split is `fold_in(key, i)`."""
    return fold_in(key, 0), fold_in(key, 1)


@spanned("rtr.rng")
def random_bits(key: Key, shape, device=None, offset: int = 0
                ) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (32-bit, partitionable layout):
    counters (0, flat index), hi and lo words XORed, as int64.

    `offset` is the flat index of the first lane: the lanes of a band
    that starts at lane `offset` of a larger draw get exactly the bits
    that the larger draw gives them, so a rank's share of a batch
    (parallel/) draws what the whole batch draws there."""
    return _bits(key, shape, device, offset, False)


def _bits(key: Key, shape, device, offset: int, unit_float: bool
          ) -> torch.Tensor:
    """random_bits, or with `unit_float` its `_bits_to_unit_float`."""
    n = 1
    for s in shape:
        n *= int(s)
    if not (0 <= offset and offset + n <= 2**32):
        raise ValueError(f"lanes [{offset}, {offset + n}) exceed the "
                         f"32-bit counter")
    dev = (torch.device(device) if device is not None
           else torch.get_default_device())
    if takes_kernel(dev):
        out = rng_kernel.random_bits(key, n, offset, dev, unit_float)
    else:
        _count_plain(dev, n)
        lo = torch.arange(offset, offset + n, dtype=torch.int64, device=dev)
        y0, y1 = threefry2x32(key, 0, lo)
        out = y0 ^ y1
        if unit_float:
            out = _bits_to_unit_float(out)
    return out.reshape(shape)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform's mantissa trick: 23 random bits under the
    exponent of 1.0, minus 1.0 -> [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


@spanned("rtr.rng")
def uniform(key: Key, bounce: int, decision: int, shape,
            device=None, offset: int = 0) -> torch.Tensor:
    """U[0,1) tensor of `shape` for one decision point of one bounce
    (= `jax.random.uniform(decision_key(...), shape)`); `offset` as in
    `random_bits`."""
    return _bits(decision_key(key, bounce, decision), shape, device, offset,
                 True)


@spanned("rtr.rng")
def raw_uniform(key: Key, shape, device=None, offset: int = 0
                ) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: U[0,1) straight from `key`, with
    no decision key folded in (the adaptive sampler's draws)."""
    return _bits(key, shape, device, offset, True)


@spanned("rtr.rng")
def randint(key: Key, shape, lo: int, hi: int, device=None) -> torch.Tensor:
    """`jax.random.randint(key, shape, lo, hi)` as int32 in [lo, hi)
    (`hi <= lo` gives `lo`): two 32-bit words a value, from the two keys
    of `split(key)`, reduced mod the span in wrapping uint32 arithmetic
    (jax/_src/random.py::_randint)."""
    lo, hi = int(lo), int(hi)
    if not -2**31 <= lo < 2**31 or not -2**31 <= hi < 2**31:
        raise ValueError(f"randint bounds ({lo}, {hi}) do not fit int32")
    k1, k2 = split(key)
    hi_bits = random_bits(k1, shape, device)
    lo_bits = random_bits(k2, shape, device)
    span = (hi - lo) & MASK if hi > lo else 1
    multiplier = ((2**16 % span) ** 2 & MASK) % span
    offset = (((hi_bits % span) * multiplier & MASK)
              + lo_bits % span) & MASK
    return (lo + offset % span).to(torch.int32)


@spanned("rtr.rng")
def uniform_ids(key: Key, bounce: int, decision: int,
                ids: torch.Tensor) -> torch.Tensor:
    """U[0,1) per lane, keyed by the lane's PIXEL id: one threefry block
    per (key, bounce, decision, pixel) with counter pair
    (pixel id, bounce*16 + decision), so every stream is invariant under
    lane permutation.  Top 24 bits of the first output word, scaled by
    2^-24."""
    counter = (bounce * _NUM_DECISIONS + decision) & MASK
    if takes_kernel(ids.device):
        if ids.dtype not in (torch.int32, torch.int64):
            ids = ids.to(torch.int64)
        return rng_kernel.uniform_ids(key, counter, ids)
    _count_plain(ids.device, ids.numel())
    y0, _ = threefry2x32(key, ids.to(torch.int64), counter)
    return (y0 >> 8).to(torch.float32) * (2.0 ** -24)
