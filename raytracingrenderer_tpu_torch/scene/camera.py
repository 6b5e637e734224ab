"""Batched pinhole camera ray generation and projection.

Counterpart of raytracingrenderer_tpu/scene/camera.py (RTBase Camera,
Scene.h:10-70), batched over flat pixel tensors on the camera's device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import matrix
from ..core.vec import V3
from .types import Camera


def generate_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor
                  ) -> Tuple[V3, V3]:
    """Pixel coords (float, e.g. x+0.5) -> (origin, unit direction) batches.

    NDC x'=2(x/w)-1, y'=2(1-y/h)-1, dir =
    normalize(cam_to_world.mulVec(P^-1.mulPoint([x', y', 1]))).
    Origins are materialised (not broadcast views), so every returned
    tensor is contiguous.
    """
    xp = (px / cam.width) * 2.0 - 1.0
    yp = (1.0 - py / cam.height) * 2.0 - 1.0
    d = V3(xp, yp, torch.ones_like(xp))
    d = matrix.apply_point(cam.p_inv, d)
    d = matrix.apply_vec(cam.cam_to_world, d).normalize()
    o = V3(cam.origin.x.expand(d.x.shape).clone(),
           cam.origin.y.expand(d.y.shape).clone(),
           cam.origin.z.expand(d.z.shape).clone())
    return o, d


def project_onto_camera(cam: Camera, p: V3
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World point batch -> (x_pixel, y_pixel, valid), with a
    front-of-camera check (w > 0)."""
    pv = matrix.apply_point(cam.world_to_cam, p)
    M = cam.p
    q = matrix.apply_point(M, pv)
    w = M[3, 0] * pv.x + M[3, 1] * pv.y + M[3, 2] * pv.z + M[3, 3]
    inv_w = 1.0 / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    sx = (q.x * inv_w + 1.0) * 0.5
    sy = (q.y * inv_w + 1.0) * 0.5
    valid = (w > 0.0) & (sx >= 0.0) & (sx <= 1.0) & (sy >= 0.0) & (sy <= 1.0)
    x = sx * cam.width
    y = (1.0 - sy) * cam.height
    return x, y, valid


def view_direction(cam: Camera) -> V3:
    """Unit forward axis of the camera (RTBase Camera::viewDirection)."""
    d = matrix.apply_point(cam.p_inv, V3.of(0.0, 0.0, 1.0,
                                            device=cam.p_inv.device))
    return matrix.apply_vec(cam.cam_to_world, d).normalize()


def cos_theta_to_pixel(cam: Camera, dir_to_pixel: V3) -> torch.Tensor:
    """cos of the angle between the camera's forward axis and a unit
    direction: the cos^4 of the light tracer's importance
    W = 1 / (A_film cos^4)."""
    return dir_to_pixel.dot(view_direction(cam))
