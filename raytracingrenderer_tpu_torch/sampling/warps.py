"""Analytic sampling warps and their PDFs.

Counterpart of raytracingrenderer_tpu/sampling/warps.py: uniform/cosine
hemisphere, uniform sphere and triangle warps, and the GGX half-vector
warp with its D, Smith G and pdf, vectorized over flat batches.
"""
from __future__ import annotations

import math

import torch

from ..core.spherical import spherical_to_world
from ..core.vec import V3

INV_PI = 1.0 / math.pi
INV_2PI = 0.5 / math.pi
INV_4PI = 0.25 / math.pi


def uniform_hemisphere(r1, r2) -> V3:
    theta = torch.acos(torch.clamp(r1, 0.0, 1.0))
    phi = 2.0 * math.pi * r2
    return spherical_to_world(theta, phi)


def uniform_hemisphere_pdf(wi: V3):
    return torch.where(wi.z >= 0.0, INV_2PI, 0.0)


def cosine_hemisphere(r1, r2) -> V3:
    theta = torch.acos(torch.sqrt(torch.clamp(r1, 0.0, 1.0)))
    phi = 2.0 * math.pi * r2
    return spherical_to_world(theta, phi)


def cosine_hemisphere_pdf(wi: V3):
    return torch.where(wi.z >= 0.0, wi.z * INV_PI, 0.0)


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


def ggx_sample_half(r1, r2, alpha) -> V3:
    """Sample the GGX normal distribution (half-vector about +z)."""
    r1 = torch.clamp(r1, 0.0, 1.0 - 1e-7)
    tan2 = (alpha * alpha) * r1 / (1.0 - r1)
    cos_t = torch.rsqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, 1e-20, 1.0))
    phi = 2.0 * math.pi * r2
    return V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def ggx_d(h: V3, alpha):
    """GGX microfacet distribution D(h), h in local (z-up) space."""
    a2 = alpha * alpha
    c2 = h.z * h.z
    denom = c2 * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * denom * denom, min=1e-12)
    return torch.where(h.z > 0.0, d, 0.0)


def ggx_lambda(w: V3, alpha):
    """Smith Lambda for GGX; w local."""
    c2 = torch.clamp(w.z * w.z, 1e-12, 1.0)
    tan2 = (1.0 - c2) / c2
    return 0.5 * (torch.sqrt(1.0 + alpha * alpha * tan2) - 1.0)


def ggx_g(wi: V3, wo: V3, alpha):
    """Smith height-correlated masking-shadowing G(wi, wo)."""
    return 1.0 / (1.0 + ggx_lambda(wi, alpha) + ggx_lambda(wo, alpha))


def ggx_half_pdf(h: V3, alpha):
    return ggx_d(h, alpha) * torch.clamp(h.z, min=0.0)
