"""Batched pinhole camera ray generation.

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
