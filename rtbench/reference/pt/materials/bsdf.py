"""Branchless batched BSDFs over an enum-tagged material table.

Counterpart of raytracingrenderer_tpu/materials/bsdf.py, cut to the
lobe the benchmark's configurations reach: the diffuse (Lambertian)
lobe, expression for expression as the renderer computes it in a scene
of diffuse materials alone (the loader refuses every other BSDF and the
coat).  A configuration that needs another lobe brings it back.

Conventions: directions in the local shading frame, +z = shading normal,
`wo` points away from the surface.  `sample` returns (wi, colour, pdf,
valid); `evaluate`/`pdf_fn` return the f term / solid-angle pdf used by
NEE+MIS.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..core.vec import V3, vwhere
from ..sampling import warps
from ..scene.types import (MAT_DIELECTRIC, MAT_DIFFUSE, MAT_GLASS,
                           MAT_MIRROR, MAT_OREN_NAYAR)

INV_PI = 1.0 / math.pi
MIN_ALPHA = 1e-3


class MatParams(NamedTuple):
    """Per-lane gathered material parameters."""
    mtype: torch.Tensor
    albedo: V3
    eta: V3
    k: V3
    int_ior: torch.Tensor
    ext_ior: torch.Tensor
    alpha: torch.Tensor
    sigma: torch.Tensor
    emission: V3
    is_emissive: torch.Tensor
    coat_thickness: torch.Tensor = None
    coat_sigma_a: V3 = None
    coat_int_ior: torch.Tensor = None
    coat_ext_ior: torch.Tensor = None


def is_specular(mtype: torch.Tensor) -> torch.Tensor:
    """Mirror + glass are delta lobes."""
    return (mtype == MAT_MIRROR) | (mtype == MAT_GLASS)


def is_two_sided(mtype: torch.Tensor) -> torch.Tensor:
    """All but glass/dielectric flip their shading frame toward wo."""
    return ~((mtype == MAT_GLASS) | (mtype == MAT_DIELECTRIC))


def _has(types, *ms) -> bool:
    """Static presence test: `types` is the set of MAT_* values present in
    the scene, or None for "assume all"."""
    return types is None or any(m in types for m in ms)


def evaluate(mp: MatParams, wo: V3, wi: V3, types=None) -> V3:
    """f(wo, wi) without the cosine term."""
    zero = V3.zeros_like(wo.z)
    up = (wo.z > 0.0) & (wi.z > 0.0)
    out = zero
    if _has(types, MAT_DIFFUSE):
        f_diff = vwhere(up, mp.albedo * INV_PI, zero)
        out = vwhere(mp.mtype == MAT_DIFFUSE, f_diff, out)
    return out


def pdf_fn(mp: MatParams, wo: V3, wi: V3, types=None) -> torch.Tensor:
    """Solid-angle pdf of `sample`."""
    cos_pdf = torch.where((wo.z > 0.0) & (wi.z > 0.0), wi.z * INV_PI, 0.0)
    return torch.where((mp.mtype == MAT_DIFFUSE)
                       | (mp.mtype == MAT_OREN_NAYAR), cos_pdf, 0.0)


def sample(mp: MatParams, wo: V3, r1: torch.Tensor, r2: torch.Tensor,
           rl: torch.Tensor, types=None
           ) -> Tuple[V3, V3, torch.Tensor, torch.Tensor]:
    """Sample an incident direction per lane (the cosine lobe).

    Returns (wi, colour, pdf, valid); valid=False lanes should terminate
    the path.  `rl`, the renderer's lobe-select draw, is unused here.
    """
    wi = warps.cosine_hemisphere(r1, r2)
    colour = evaluate(mp, wo, wi, types)
    pdf = pdf_fn(mp, wo, wi, types)
    valid = pdf > 1e-9
    valid = valid | is_specular(mp.mtype)
    valid = valid & (torch.abs(wi.z) > 1e-7)
    return wi, colour, pdf, valid
