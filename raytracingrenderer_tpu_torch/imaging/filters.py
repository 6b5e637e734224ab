"""Reconstruction filter kernels for the film's splats.

Counterpart of raytracingrenderer_tpu/imaging/filters.py (RTBase
ImageFilter / BoxFilter / GaussianFilter / MitchellFilter,
Imaging.h:132-199), with the Mitchell filter implemented as there (the
reference's returns 0).  film.splat evaluates them over the
(2s+1)^2 footprint.
"""
from __future__ import annotations

import math

import torch


def box(dx, dy, size: int):
    """size 0 => a single pixel (the reference's active configuration)."""
    if size == 0:
        return torch.ones_like(dx)
    inside = (torch.abs(dx) <= size + 0.5) & (torch.abs(dy) <= size + 0.5)
    return inside.to(torch.float32)


def gaussian(dx, dy, size: int, alpha: float = 2.0):
    d2 = dx * dx + dy * dy
    return torch.clamp(torch.exp(-alpha * d2)
                       - math.exp(-alpha * size * size), min=0.0)


def _mitchell_1d(x, b: float, c: float):
    x = torch.abs(2.0 * x)  # domain scaled to [-2, 2]
    x2 = x * x
    x3 = x2 * x
    inner = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
             + (6 - 2 * b)) / 6.0
    outer = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
             + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def mitchell(dx, dy, size: int, b: float = 1.0 / 3.0, c: float = 1.0 / 3.0):
    """Separable Mitchell-Netravali; size is the half-width in pixels."""
    s = max(size, 1)
    return _mitchell_1d(dx / s, b, c) * _mitchell_1d(dy / s, b, c)
