"""The reference's ray-scene intersection: every ray against every
triangle, in plain torch (no tree: the configurations it judges are
small).

The contracts are the renderer's: a miss is t = BIG_T, tri = -1; a lane
whose search radius t_init is negative is dead and never hits; any-hit
is tri >= 0 with t_init = max_t; hits are returned detached.  Two
triangles at exactly the same t resolve to the lower triangle id (file
order).  Moller-Trumbore on (p0, e1, e2); barycentrics map as
alpha = 1-u-v (v0), beta = u (v1), gamma = v (v2).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import V3
from ..scene.types import Triangles

DET_EPS = 1e-12
BIG_T = 3.4e38
_PAIR_BUDGET = 1 << 24      # ray-triangle pairs a brute-force chunk


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
    return mt(tris.p0.gather(idx), tris.e1.gather(idx),
              tris.e2.gather(idx), o, d)


def mt(p0: V3, e1: V3, e2: V3, o: V3, d: V3):
    """Moller-Trumbore of rays against triangles (p0, e1, e2), shapes
    broadcasting.  Returns (t, u, v, hit)."""
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


def brute_force(tris: Triangles, o: V3, d: V3, t_init: torch.Tensor) -> Hit:
    """Every ray against every triangle, a chunk of triangles at a time,
    keeping per ray the nearest hit with t < its running bound."""
    n_tri = tris.count
    n_ray = o.x.shape[0]
    dev = o.x.device
    best_t = t_init.to(torch.float32)
    best_tri = torch.full((n_ray,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n_ray, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n_ray, dtype=torch.float32, device=dev)
    chunk = max(1, min(_PAIR_BUDGET // max(n_ray, 1), n_tri))
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


def _walk(scene, o: V3, d: V3, t_init: torch.Tensor, any_hit: bool) -> Hit:
    return brute_force(scene.triangles, o, d, t_init)


def _rays(o: V3, d: V3):
    return (V3(*(c.detach().contiguous() for c in o)),
            V3(*(c.detach().contiguous() for c in d)))


def closest_hit(scene, o: V3, d: V3, active=None,
                presorted: bool = False) -> Hit:
    """Scene-level closest hit; `active` marks live lanes (the others
    miss).  `presorted` is accepted for the integrators' signature and
    changes nothing here."""
    o, d = _rays(o, d)
    n = o.x.shape[0]
    t_init = torch.full((n,), BIG_T, dtype=torch.float32, device=o.x.device)
    if active is not None:
        t_init = torch.where(active.detach(), t_init, -1.0)
    with torch.no_grad():
        h = _walk(scene, o, d, t_init, False)
        return h._replace(t=torch.where(h.tri >= 0, h.t, BIG_T))


def occluded(scene, o: V3, d: V3, max_t: torch.Tensor,
             presorted: bool = False) -> torch.Tensor:
    """Scene-level any-hit: True where a triangle lies on (0, max_t).
    Lanes with max_t < 0 are inactive and never occluded."""
    o, d = _rays(o, d)
    max_t = max_t.detach().contiguous().to(torch.float32)
    with torch.no_grad():
        return _walk(scene, o, d, max_t, True).tri >= 0
