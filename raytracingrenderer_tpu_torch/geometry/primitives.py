"""Analytic primitives: plane, sphere and box intersection (batched).

Counterpart of raytracingrenderer_tpu/geometry/primitives.py: RTBase's
Plane::rayIntersect (Geometry.h:33-57), Sphere::rayIntersect
(Geometry.h:194-229) and AABB::rayAABB (Geometry.h:151-183) on the
port's V3 batches.  The scenes are triangle-only; these are part of the
geometry API and its unit tests (RTtest.cpp:22-103).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.vec import V3


def ray_plane(o: V3, d: V3, n: V3, dist) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Plane n.x = dist -> (t, hit); no hit for parallel rays or
    intersections behind the origin (t < 0)."""
    denom = n.dot(d)
    safe = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    t = (dist - n.dot(o)) / safe
    hit = (torch.abs(denom) >= 1e-12) & (t >= 0.0)
    return t, hit


def ray_sphere(o: V3, d: V3, centre: V3, radius
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere |x - c| = r -> (t, hit): the nearest positive root of the
    quadratic (unit directions, a = 1); t is 0 where there is no hit."""
    l = o - centre
    b = 2.0 * d.dot(l)
    c = l.dot(l) - radius * radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) * 0.5
    t1 = (-b + sq) * 0.5
    t = torch.where(t0 > 0.0, t0, t1)
    hit = (disc >= 0.0) & (t > 0.0)
    return torch.where(hit, t, 0.0), hit


def ray_aabb(o: V3, inv_d: V3, lo: V3, hi: V3
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab test -> (tmin, tmax, hit)."""
    t0x = (lo.x - o.x) * inv_d.x
    t1x = (hi.x - o.x) * inv_d.x
    t0y = (lo.y - o.y) * inv_d.y
    t1y = (hi.y - o.y) * inv_d.y
    t0z = (lo.z - o.z) * inv_d.z
    t1z = (hi.z - o.z) * inv_d.z
    mn, mx = torch.minimum, torch.maximum
    tmin = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    tmax = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    return tmin, tmax, tmax >= torch.clamp(tmin, min=0.0)
