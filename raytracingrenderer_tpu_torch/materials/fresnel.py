"""Fresnel terms (dielectric + conductor).

Counterpart of raytracingrenderer_tpu/materials/fresnel.py: the exact
unpolarized dielectric Fresnel equation and the RTBase conductor
approximation (Materials.h:78-91).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.vec import V3, vclamp


def fresnel_dielectric(cos_i: torch.Tensor, eta_i, eta_t
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpolarized Fresnel reflectance for |cos_i| at an eta_i->eta_t
    interface.  Returns (R, cos_t); R = 1 on total internal reflection."""
    cos_i = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    eta = eta_i / eta_t
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_s = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(
        eta_i * cos_i + eta_t * cos_t, min=1e-12)
    r_p = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(
        eta_t * cos_i + eta_i * cos_t, min=1e-12)
    r = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(tir, 1.0, torch.clamp(r, 0.0, 1.0)), cos_t


def fresnel_conductor(cos_i: torch.Tensor, eta: V3, k: V3) -> V3:
    """Approximate unpolarized conductor Fresnel (complex IOR eta + i*k)."""
    c = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    c2 = c * c
    s2 = 1.0 - c2
    n2k2 = eta * eta + k * k
    two_eta_c = eta * (2.0 * c)
    r_p2 = (n2k2 * c2 - two_eta_c + s2) / (n2k2 * c2 + two_eta_c + s2)
    r_s2 = (n2k2 - two_eta_c + c2) / (n2k2 + two_eta_c + c2)
    return vclamp((r_p2 + r_s2) * 0.5, 0.0, 1.0)


def refract_dir(wo: V3, cos_t: torch.Tensor, eta: torch.Tensor) -> V3:
    """Refracted direction in the local frame for wo with wo.z of either
    sign; eta = eta_i/eta_t.  The transmitted ray leaves through the
    opposite hemisphere."""
    sign = torch.sign(wo.z)
    return V3(-eta * wo.x, -eta * wo.y, -sign * cos_t)
