"""Analytic sampling warps and their PDFs.

Counterpart of raytracingrenderer_tpu/sampling/warps.py: uniform/cosine
hemisphere, uniform sphere and triangle warps, vectorized over flat
batches (the GGX warps serve lobes the reference does not hold).
"""
from __future__ import annotations

import math

import torch

from ..core.spherical import spherical_to_world
from ..core.vec import V3

INV_PI = 1.0 / math.pi
INV_4PI = 0.25 / math.pi



def cosine_hemisphere(r1, r2) -> V3:
    theta = torch.acos(torch.sqrt(torch.clamp(r1, 0.0, 1.0)))
    phi = 2.0 * math.pi * r2
    return spherical_to_world(theta, phi)



def uniform_sphere(r1, r2) -> V3:
    theta = torch.acos(torch.clamp(1.0 - 2.0 * r1, -1.0, 1.0))
    phi = 2.0 * math.pi * r2
    return spherical_to_world(theta, phi)


def uniform_sphere_pdf(wi: V3):
    return torch.full_like(wi.x, INV_4PI)


def uniform_triangle(r1, r2):
    """Barycentric (alpha, beta, gamma) for area-uniform triangle sampling:
    alpha = 1-sqrt(r1), beta = r2*sqrt(r1)."""
    sq = torch.sqrt(torch.clamp(r1, 0.0, 1.0))
    alpha = 1.0 - sq
    beta = r2 * sq
    return alpha, beta, 1.0 - alpha - beta
