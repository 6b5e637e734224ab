"""Batched ray-scene intersection: the brute-force branch.

Counterpart of the brute-force half of
raytracingrenderer_tpu/geometry/intersect.py.  Scenes of 64 triangles or
fewer (cornell-box's 36) are intersected by testing every ray against
every triangle; `closest_hit` and `occluded` route that through the MT
kernel wrapper (ops/mt_kernel.py), which launches the CUDA kernel for
CUDA tensors and runs its plain torch version for CPU tensors.  The BVH
branch waits for its slice.

Triangle test is Moller-Trumbore on (p0, e1, e2); barycentrics map as
alpha = 1-u-v (v0), beta = u (v1), gamma = v (v2).

Contracts (as in the JAX package): a miss is t = BIG_T, tri = -1; a lane
whose search radius t_init is negative is dead and never hits; any-hit
is tri >= 0 with t_init = max_t.  Hits are returned detached.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import V3
from ..scene.types import Triangles

DET_EPS = 1e-12
BIG_T = 3.4e38


class Hit(NamedTuple):
    t: torch.Tensor      # (N,) hit distance (BIG_T if miss)
    tri: torch.Tensor    # (N,) int32 triangle id (-1 if miss)
    u: torch.Tensor      # (N,) barycentric beta (weight of v1)
    v: torch.Tensor      # (N,) barycentric gamma (weight of v2)

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def _mt_test(tris: Triangles, idx, o: V3, d: V3):
    """Moller-Trumbore for rays (N,) against gathered triangles idx (N,)
    or broadcast (N, C).  Returns (t, u, v, hit)."""
    p0 = tris.p0.gather(idx)
    e1 = tris.e1.gather(idx)
    e2 = tris.e2.gather(idx)
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    # double-where: 1/det is never evaluated at det~0
    bad = torch.abs(det) < DET_EPS
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    tvec = o - p0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    hit = ((torch.abs(det) >= DET_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > 0.0))
    return t, u, v, hit


def miss_all(n_ray: int, device=None) -> Hit:
    return Hit(torch.full((n_ray,), BIG_T, dtype=torch.float32,
                          device=device),
               torch.full((n_ray,), -1, dtype=torch.int32, device=device),
               torch.zeros(n_ray, dtype=torch.float32, device=device),
               torch.zeros(n_ray, dtype=torch.float32, device=device))


def closest_hit_brute(tris: Triangles, o: V3, d: V3,
                      chunk: int = 4096) -> Hit:
    """Every ray against every triangle, `chunk` triangles at a time (the
    plain version of the MT kernel with an unbounded search radius)."""
    from ..ops import mt_kernel
    n_ray = o.x.shape[0]
    if tris.count == 0:
        return miss_all(n_ray, o.x.device)
    t_init = torch.full((n_ray,), BIG_T, dtype=torch.float32,
                        device=o.x.device)
    return mt_kernel.intersect_plain(tris, o, d, t_init, chunk)


def any_hit_brute(tris: Triangles, o: V3, d: V3, max_t: torch.Tensor,
                  chunk: int = 4096) -> torch.Tensor:
    """True where segment [0, max_t] is occluded."""
    hit = closest_hit_brute(tris, o, d, chunk)
    return hit.valid & (hit.t < max_t)


def _check_dispatch(scene) -> None:
    if scene.bvh is not None:
        raise NotImplementedError(
            "BVH traversal (ops/bvh_kernel.py) is not ported yet")


def _rays(o: V3, d: V3):
    return (V3(*(c.detach().contiguous() for c in o)),
            V3(*(c.detach().contiguous() for c in d)))


def closest_hit(scene, o: V3, d: V3, active=None) -> Hit:
    """Scene-level closest hit (RTBase Scene::traverse, Scene.h:107-130).

    `active` marks live lanes; inactive lanes return misses without
    paying for the test (their search radius is negative)."""
    from ..ops import mt_kernel
    _check_dispatch(scene)
    o, d = _rays(o, d)
    n = o.x.shape[0]
    t_init = torch.full((n,), BIG_T, dtype=torch.float32, device=o.x.device)
    if active is not None:
        t_init = torch.where(active.detach(), t_init, -1.0)
    with torch.no_grad():
        h = mt_kernel.intersect(scene.triangles, o, d, t_init)
        return h._replace(t=torch.where(h.tri >= 0, h.t, BIG_T))


def occluded(scene, o: V3, d: V3, max_t: torch.Tensor) -> torch.Tensor:
    """Scene-level any-hit (RTBase Scene::visible, Scene.h:161-169).
    Lanes with max_t < 0 are inactive and never occluded."""
    from ..ops import mt_kernel
    _check_dispatch(scene)
    o, d = _rays(o, d)
    with torch.no_grad():
        return mt_kernel.any_hit(scene.triangles, o, d,
                                 max_t.detach().contiguous())
