"""Orthonormal shading frames for vector batches.

Counterpart of raytracingrenderer_tpu/core/frame.py: the branchless
Duff et al. 2017 tangent frame, local <-> world transforms.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import V3


class Frame(NamedTuple):
    t: V3  # tangent  (local +x)
    b: V3  # bitangent (local +y)
    n: V3  # normal   (local +z)

    @staticmethod
    def from_normal(n: V3) -> "Frame":
        # Branchless ONB (Duff et al., JCGT 2017).
        s = torch.where(n.z >= 0.0, 1.0, -1.0)
        a = -1.0 / (s + n.z)
        b = n.x * n.y * a
        t = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
        bt = V3(b, s + n.y * n.y * a, -n.y)
        return Frame(t, bt, n)

    def to_world(self, w: V3) -> V3:
        return self.t * w.x + self.b * w.y + self.n * w.z

    def to_local(self, w: V3) -> V3:
        return V3(w.dot(self.t), w.dot(self.b), w.dot(self.n))
