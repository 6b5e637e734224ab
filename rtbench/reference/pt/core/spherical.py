"""Spherical <-> Cartesian conversions, z-up.

Counterpart of raytracingrenderer_tpu/core/spherical.py.
"""
from __future__ import annotations

import torch

from .vec import V3


def spherical_to_world(theta, phi) -> V3:
    st = torch.sin(theta)
    return V3(st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))

