"""Spherical <-> Cartesian conversions, z-up.

Counterpart of raytracingrenderer_tpu/core/spherical.py.
"""
from __future__ import annotations

import math

import torch

from .vec import V3


def spherical_to_world(theta, phi) -> V3:
    st = torch.sin(theta)
    return V3(st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))


def world_to_theta(v: V3):
    return torch.acos(torch.clamp(v.z, -1.0, 1.0))


def world_to_phi(v: V3):
    p = torch.atan2(v.y, v.x)
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)
