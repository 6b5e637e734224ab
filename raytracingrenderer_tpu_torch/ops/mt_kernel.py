"""Brute-force Moller-Trumbore intersection: CUDA kernel wrapper and its
plain torch version.

Counterpart of raytracingrenderer_tpu/ops/mt_kernel.py, whose Pallas
kernel (`_kernel`, launched by `intersect_pallas`) carries small scenes
on the TPU.  Here the kernel is csrc/mt_kernel.cu, written for Hopper
(sm_90a): one thread per ray, padded triangle rows streamed through a
ring of shared-memory tiles by bulk copies, the second half of the test
skipped where no ray of a warp can pass it.  It computes what the TPU
kernel computes, with the same arithmetic: `t_init` seeds each ray's
search radius, so closest-hit passes BIG_T and any-hit passes the
segment length (an occlusion exists iff a triangle id was recorded); a
miss keeps t = t_init, tri = -1, u = v = 0; ties go to the lowest
triangle index.

`intersect` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it calls `intersect_plain`, the plain torch version of
the same function (a chunked form of closest_hit_brute with t_init
seeding), which is also the kernel's reference on the card.  `launches`
counts kernel launches, `rays` the rays handed to them.
"""
from __future__ import annotations

import torch

from ..core.vec import V3
from ..geometry.intersect import BIG_T, Hit, _mt_test, on_live_lanes
from ..scene.types import Triangles, same_data
from .launch import I32, PTR, bind, launch

MAX_SMEM_TRIS = 4096   # the TPU kernel's dispatch cap, kept as the contract
# Plain version: (ray, triangle) pairs per chunk, which bounds the
# (N, chunk) temporaries to 64 MB each.
_PAIR_BUDGET = 1 << 24

ROW = 12               # floats of a packed row: 9 and the padding
_PACKED_SETS = 8       # triangle sets whose packed rows are kept

launches = 0           # kernel launches since import (or the last reset)
rays = 0               # the rays of those launches, dead lanes included
_lib = None
_packed = []           # [(the 9 tensors and their versions, rows)]


def pack_tris(tris: Triangles) -> torch.Tensor:
    """(T, ROW) contiguous f32 rows [p0 e1 e2 0 0 0]: what the kernel
    reads, three 16-byte loads a row.  Packed once a triangle set: the
    rows are kept with the nine component tensors they were made from
    (checked by `same_data`, so a new or an updated `Triangles` packs
    anew), the last few sets only."""
    parts = (*tris.p0, *tris.e1, *tris.e2)
    for kept, rows in _packed:
        if all(same_data(a, b, v) for a, (b, v) in zip(parts, kept)):
            return rows
    zero = torch.zeros_like(parts[0])
    rows = torch.stack([*parts] + [zero] * (ROW - 9), dim=-1).contiguous()
    _packed.insert(0, (tuple((a, a._version) for a in parts), rows))
    del _packed[_PACKED_SETS:]
    return rows


def intersect_plain(tris: Triangles, o: V3, d: V3, t_init: torch.Tensor,
                    chunk=None) -> Hit:
    """Plain torch version of the kernel: every ray against every
    triangle, `chunk` triangles at a time, keeping per ray the nearest
    hit with t < its running bound (seeded by t_init)."""
    n_tri = tris.count
    n_ray = o.x.shape[0]
    if chunk is None:
        chunk = _PAIR_BUDGET // max(n_ray, 1)
    chunk = max(1, min(chunk, n_tri))
    dev = o.x.device
    best_t = t_init.to(torch.float32)
    best_tri = torch.full((n_ray,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n_ray, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n_ray, dtype=torch.float32, device=dev)
    ob = V3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = V3(d.x[:, None], d.y[:, None], d.z[:, None])
    for start in range(0, n_tri, chunk):
        idx = torch.arange(start, min(start + chunk, n_tri), device=dev)
        t, u, v, hit = _mt_test(tris, idx[None, :], ob, db)
        hit = hit & (t < best_t[:, None])
        t = torch.where(hit, t, float("inf"))
        j = torch.argmin(t, dim=1, keepdim=True)   # first index on ties
        tj = torch.take_along_dim(t, j, 1)[:, 0]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_tri = torch.where(better, (j[:, 0] + start).to(torch.int32),
                               best_tri)
        best_u = torch.where(better, torch.take_along_dim(u, j, 1)[:, 0],
                             best_u)
        best_v = torch.where(better, torch.take_along_dim(v, j, 1)[:, 0],
                             best_v)
    return Hit(best_t, best_tri, best_u, best_v)


def _library():
    """csrc/mt_kernel.cu's launchers, bound once."""
    global _lib
    if _lib is None:
        _lib = bind("mt_kernel",
                    {"mt_intersect": [PTR, I32] + [PTR] * 11 + [I32]})
    return _lib


def _check(rows: torch.Tensor, arrays, n: int) -> None:
    if rows.dim() != 2 or rows.shape[1] != ROW:
        raise ValueError(f"triangle rows must be (T, {ROW}), got "
                         f"{tuple(rows.shape)}")
    if rows.shape[0] > MAX_SMEM_TRIS:
        raise ValueError(f"{rows.shape[0]} triangles exceed the brute-force "
                         f"cap {MAX_SMEM_TRIS}; use the BVH")
    for name, a in arrays:
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(a)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != rows.device:
            raise ValueError(f"{name} is on {a.device}, triangles on "
                             f"{rows.device}")


def intersect(tris: Triangles, o: V3, d: V3, t_init: torch.Tensor) -> Hit:
    """All-pairs MT; t_init bounds each ray's search.  CUDA tensors launch
    the kernel; CPU tensors take `intersect_plain`."""
    global launches, rays
    rows = pack_tris(tris)
    n = o.x.shape[0]
    _check(rows, (("o.x", o.x), ("o.y", o.y), ("o.z", o.z), ("d.x", d.x),
                  ("d.y", d.y), ("d.z", d.z), ("t_init", t_init)), n)
    dev = rows.device
    if dev.type == "cpu":
        return on_live_lanes(lambda *r: intersect_plain(tris, *r), o, d,
                             t_init)
    if dev.type != "cuda":
        raise ValueError(f"no MT kernel for device {dev}")
    if rows.data_ptr() % 16:
        raise ValueError("the packed rows must be 16-byte aligned (copied "
                         "in bulk, read as float4)")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return Hit(t, tri, u, v)
    launch(_library()["mt_intersect"], dev,
           rows.data_ptr(), rows.shape[0],
           o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
           d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
           t_init.data_ptr(), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
           v.data_ptr(), n)
    launches += 1
    rays += n
    return Hit(t, tri, u, v)


def closest_hit(tris: Triangles, o: V3, d: V3) -> Hit:
    """Nearest hit with an unbounded search radius (misses: t = BIG_T)."""
    t_init = torch.full((o.x.shape[0],), BIG_T, dtype=torch.float32,
                        device=o.x.device)
    return intersect(tris, o, d, t_init)


def any_hit(tris: Triangles, o: V3, d: V3, max_t: torch.Tensor
            ) -> torch.Tensor:
    """True where segment [0, max_t] is occluded."""
    return intersect(tris, o, d, max_t).tri >= 0
