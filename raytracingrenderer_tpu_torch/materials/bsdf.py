"""Branchless batched BSDFs over an enum-tagged material table.

Counterpart of raytracingrenderer_tpu/materials/bsdf.py: every lobe
family present in the scene is evaluated for every lane and the per-lane
material type selects the result.  The seven MAT_* types (diffuse,
mirror, GGX conductor, smooth glass, rough dielectric, Oren-Nayar,
plastic) and the layered coat are implemented as in the JAX package,
expression for expression, and `_has` skips the lobes of types the scene
does not use.

Conventions: directions in the local shading frame, +z = shading normal,
`wo` points away from the surface.  `sample` returns (wi, colour, pdf,
valid); `evaluate`/`pdf_fn` return the f term / solid-angle pdf used by
NEE+MIS and are 0 for delta lobes (mirror, glass).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..core.vec import V3, reflect_z, vwhere
from ..sampling import warps
from ..scene.types import (MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_DIFFUSE,
                           MAT_GLASS, MAT_MIRROR, MAT_OREN_NAYAR,
                           MAT_PLASTIC)
from . import fresnel

INV_PI = 1.0 / math.pi
MIN_ALPHA = 1e-3

# Static sentinel appended to cfg.mat_types by render.specialize_config
# when any material carries a coat (coat_thickness > 0).
COAT = 99

# Near-smooth GGX roughness of the layered coat's reflection lobe.
COAT_ALPHA = 0.01


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


# ---------------------------------------------------------------------------
# helpers

def _grey(s: torch.Tensor) -> V3:
    """The JAX package's V3.of(1, 1, 1) * s (1*s is exact)."""
    return V3(s, s, s)


def _reflect_about(w: V3, h: V3) -> V3:
    return h * (2.0 * w.dot(h)) - w


def _mirror_z(w: V3, s: torch.Tensor) -> V3:
    """Conditionally mirror z so that transformed wo.z > 0."""
    return V3(w.x, w.y, w.z * s)


def _oren_nayar_f(albedo: V3, sigma, wo: V3, wi: V3) -> V3:
    """Full Oren-Nayar."""
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin2_i = torch.clamp(1.0 - wi.z * wi.z, min=0.0)
    sin2_o = torch.clamp(1.0 - wo.z * wo.z, min=0.0)
    sin_i = torch.sqrt(sin2_i)
    sin_o = torch.sqrt(sin2_o)
    denom = torch.clamp(sin_i * sin_o, min=1e-7)
    cos_dphi = torch.clamp((wi.x * wo.x + wi.y * wo.y) / denom, -1.0, 1.0)
    cos_dphi = torch.clamp(cos_dphi, min=0.0)
    sin_alpha = torch.maximum(sin_i, sin_o)
    cos_max = torch.maximum(torch.abs(wi.z), torch.abs(wo.z))
    tan_beta = torch.minimum(sin_i, sin_o) / torch.clamp(cos_max, min=1e-7)
    return albedo * (INV_PI * (a + b * cos_dphi * sin_alpha * tan_beta))


def _ggx_reflect_eval(alpha, f0: V3, wo: V3, wi: V3
                      ) -> Tuple[V3, torch.Tensor]:
    """(f, pdf) of a GGX reflection lobe with Fresnel colour f0 already
    evaluated at the half vector by the caller."""
    h = (wo + wi).normalize()
    h = vwhere(h.z >= 0.0, h, -h)
    d = warps.ggx_d(h, alpha)
    g = warps.ggx_g(wo, wi, alpha)
    denom = torch.clamp(4.0 * torch.abs(wo.z) * torch.abs(wi.z), min=1e-7)
    f = f0 * (d * g / denom)
    pdf = warps.ggx_half_pdf(h, alpha) / torch.clamp(
        4.0 * torch.abs(wo.dot(h)), min=1e-7)
    ok = (wo.z > 0.0) & (wi.z > 0.0)
    return vwhere(ok, f, 0.0), torch.where(ok, pdf, 0.0)


def _plastic_fresnel(mp: MatParams, cos_x) -> torch.Tensor:
    r, _ = fresnel.fresnel_dielectric(cos_x, mp.ext_ior, mp.int_ior)
    return r


# ---------------------------------------------------------------------------
# layered coating: f = f_coat + T(wo) T(wi) A(wo, wi) f_base, with T the
# coat interface transmittance and A Beer-Lambert absorption along both
# coat crossings (see the JAX package for the derivation).

def _coat_applies(mp: MatParams) -> torch.Tensor:
    return (mp.coat_thickness > 0.0) & ~is_specular(mp.mtype)


def _coat_fresnel(mp: MatParams, cos_x) -> torch.Tensor:
    r, _ = fresnel.fresnel_dielectric(torch.abs(cos_x), mp.coat_ext_ior,
                                      mp.coat_int_ior)
    return r


def _coat_absorb(mp: MatParams, wo: V3, wi: V3) -> V3:
    path = mp.coat_thickness * (
        1.0 / torch.clamp(torch.abs(wo.z), min=1e-4)
        + 1.0 / torch.clamp(torch.abs(wi.z), min=1e-4))
    return V3(torch.exp(-mp.coat_sigma_a.x * path),
              torch.exp(-mp.coat_sigma_a.y * path),
              torch.exp(-mp.coat_sigma_a.z * path))


def _coat_layer_eval(mp: MatParams, wo: V3, wi: V3, f_base: V3) -> V3:
    h = (wo + wi).normalize()
    fc_h = _coat_fresnel(mp, wo.dot(h))
    f_coat, _ = _ggx_reflect_eval(COAT_ALPHA, _grey(fc_h), wo, wi)
    t_o = 1.0 - _coat_fresnel(mp, wo.z)
    t_i = 1.0 - _coat_fresnel(mp, wi.z)
    return f_coat + f_base * _coat_absorb(mp, wo, wi) * (t_o * t_i)


# ---------------------------------------------------------------------------
# evaluate / pdf (non-delta lobes; used by NEE + MIS)

def _has(types, *ms) -> bool:
    """Static presence test: `types` is the set of MAT_* values present in
    the scene, or None for "assume all".  Lobes for absent types are
    never evaluated."""
    return types is None or any(m in types for m in ms)


def evaluate(mp: MatParams, wo: V3, wi: V3, types=None) -> V3:
    """f(wo, wi) without the cosine term."""
    zero = V3.zeros_like(wo.z)
    up = (wo.z > 0.0) & (wi.z > 0.0)
    out = zero

    if _has(types, MAT_DIFFUSE):
        f_diff = vwhere(up, mp.albedo * INV_PI, zero)
        out = vwhere(mp.mtype == MAT_DIFFUSE, f_diff, out)
    if _has(types, MAT_OREN_NAYAR):
        f_on = vwhere(up, _oren_nayar_f(mp.albedo, mp.sigma, wo, wi), zero)
        out = vwhere(mp.mtype == MAT_OREN_NAYAR, f_on, out)
    if _has(types, MAT_CONDUCTOR, MAT_PLASTIC):
        h = (wo + wi).normalize()
    if _has(types, MAT_CONDUCTOR):
        fr_cond = (fresnel.fresnel_conductor(wo.dot(h), mp.eta, mp.k)
                   * mp.albedo)
        f_cond, _ = _ggx_reflect_eval(mp.alpha, fr_cond, wo, wi)
        out = vwhere(mp.mtype == MAT_CONDUCTOR, f_cond, out)
    if _has(types, MAT_PLASTIC):
        fr_h = _plastic_fresnel(mp, wo.dot(h))
        spec, _ = _ggx_reflect_eval(mp.alpha, _grey(fr_h), wo, wi)
        fr_o = _plastic_fresnel(mp, wo.z)
        f_plastic = spec + vwhere(up, mp.albedo * (INV_PI * (1.0 - fr_o)),
                                  zero)
        out = vwhere(mp.mtype == MAT_PLASTIC, f_plastic, out)
    if _has(types, MAT_DIELECTRIC):
        f_diel = _dielectric_eval_pdf(mp, wo, wi)[0]
        out = vwhere(mp.mtype == MAT_DIELECTRIC, f_diel, out)
    if _has(types, COAT) and mp.coat_thickness is not None:
        out = vwhere(_coat_applies(mp), _coat_layer_eval(mp, wo, wi, out),
                     out)
    return out  # mirror/glass stay zero (delta)


def pdf_fn(mp: MatParams, wo: V3, wi: V3, types=None) -> torch.Tensor:
    """Solid-angle pdf of `sample` for non-delta lobes (0 for deltas)."""
    cos_pdf = torch.where((wo.z > 0.0) & (wi.z > 0.0), wi.z * INV_PI, 0.0)
    out = torch.where((mp.mtype == MAT_DIFFUSE)
                      | (mp.mtype == MAT_OREN_NAYAR), cos_pdf, 0.0)
    if _has(types, MAT_CONDUCTOR, MAT_PLASTIC):
        _, pdf_ggx = _ggx_reflect_eval(mp.alpha, _grey(torch.ones_like(wo.z)),
                                       wo, wi)
    if _has(types, MAT_CONDUCTOR):
        out = torch.where(mp.mtype == MAT_CONDUCTOR, pdf_ggx, out)
    if _has(types, MAT_PLASTIC):
        fr_o = _plastic_fresnel(mp, wo.z)
        pdf_plastic = fr_o * pdf_ggx + (1.0 - fr_o) * cos_pdf
        out = torch.where(mp.mtype == MAT_PLASTIC, pdf_plastic, out)
    if _has(types, MAT_DIELECTRIC):
        pdf_diel = _dielectric_eval_pdf(mp, wo, wi)[1]
        out = torch.where(mp.mtype == MAT_DIELECTRIC, pdf_diel, out)
    if _has(types, COAT) and mp.coat_thickness is not None:
        # mixture pdf matching sample(): coat lobe with prob Fc(wo)
        fc_o = _coat_fresnel(mp, wo.z)
        _, pdf_coat = _ggx_reflect_eval(
            COAT_ALPHA, _grey(torch.ones_like(wo.z)), wo, wi)
        out = torch.where(_coat_applies(mp),
                          fc_o * pdf_coat + (1.0 - fc_o) * out, out)
    return out


def _dielectric_eval_pdf(mp: MatParams, wo: V3, wi: V3
                         ) -> Tuple[V3, torch.Tensor]:
    """Rough dielectric f and pdf (Walter et al. 2007 microfacet
    refraction), canonicalized so the macro-normal side of wo is +z."""
    s = torch.where(wo.z >= 0.0, 1.0, -1.0)
    wo_c = _mirror_z(wo, s)
    wi_c = _mirror_z(wi, s)
    eta_i = torch.where(s > 0.0, mp.ext_ior, mp.int_ior)
    eta_t = torch.where(s > 0.0, mp.int_ior, mp.ext_ior)
    reflecting = wi_c.z > 0.0

    # reflection branch
    h_r = (wo_c + wi_c).normalize()
    h_r = vwhere(h_r.z >= 0.0, h_r, -h_r)
    r_r, _ = fresnel.fresnel_dielectric(wo_c.dot(h_r), eta_i, eta_t)
    d_r = warps.ggx_d(h_r, mp.alpha)
    g_r = warps.ggx_g(wo_c, vwhere(reflecting, wi_c, reflect_z(wi_c)),
                      mp.alpha)
    f_refl = r_r * d_r * g_r / torch.clamp(
        4.0 * torch.abs(wo_c.z) * torch.abs(wi_c.z), min=1e-7)
    pdf_refl = (r_r * warps.ggx_half_pdf(h_r, mp.alpha)
                / torch.clamp(4.0 * torch.abs(wo_c.dot(h_r)), min=1e-7))

    # transmission branch: half vector of refraction
    ht = -(wo_c * eta_i + wi_c * eta_t)
    ht = ht.normalize()
    ht = vwhere(ht.z >= 0.0, ht, -ht)
    oh = wo_c.dot(ht)
    ih = wi_c.dot(ht)
    r_t, _ = fresnel.fresnel_dielectric(oh, eta_i, eta_t)
    d_t = warps.ggx_d(ht, mp.alpha)
    g_t = warps.ggx_g(wo_c, reflect_z(wi_c), mp.alpha)
    denom_t = torch.square(eta_i * oh + eta_t * ih)
    jac = eta_t * eta_t * torch.abs(ih) / torch.clamp(denom_t, min=1e-10)
    f_trans = ((1.0 - r_t) * d_t * g_t
               * torch.abs(oh) * torch.abs(ih) * eta_t * eta_t
               / torch.clamp(torch.abs(wo_c.z) * torch.abs(wi_c.z) * denom_t,
                             min=1e-10))
    pdf_trans = (1.0 - r_t) * warps.ggx_half_pdf(ht, mp.alpha) * jac

    f = vwhere(reflecting, mp.albedo * f_refl, mp.albedo * f_trans)
    pdf = torch.where(reflecting, pdf_refl, pdf_trans)
    ok = torch.abs(wo.z) > 1e-6
    return vwhere(ok, f, 0.0), torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# sampling

def sample(mp: MatParams, wo: V3, r1: torch.Tensor, r2: torch.Tensor,
           rl: torch.Tensor, types=None
           ) -> Tuple[V3, V3, torch.Tensor, torch.Tensor]:
    """Sample an incident direction per lane.

    Returns (wi, colour, pdf, valid); valid=False lanes (below-horizon
    microfacet rejects) should terminate the path.  `types` statically
    gates which lobe families are evaluated (see _has).
    """
    mt = mp.mtype

    # -- layered coat lobe select (before base lobes consume rl) -------
    coat_on = _has(types, COAT) and mp.coat_thickness is not None
    if coat_on:
        coated = _coat_applies(mp)
        fc_o = _coat_fresnel(mp, wo.z)
        pick_coat = coated & (rl < fc_o)
        # renormalize rl for the base's own lobe selects
        rl = torch.where(coated,
                         torch.clamp((rl - fc_o)
                                     / torch.clamp(1.0 - fc_o, min=1e-6),
                                     0.0, 1.0 - 1e-7), rl)

    # -- cosine lobe (diffuse / oren-nayar / plastic-diffuse) ----------
    wi_cos = warps.cosine_hemisphere(r1, r2)
    wi = wi_cos

    # -- mirror --------------------------------------------------------
    if _has(types, MAT_MIRROR):
        wi = vwhere(mt == MAT_MIRROR, reflect_z(wo), wi)

    # -- ggx half-vector (conductor / plastic-spec / rough dielectric) -
    if _has(types, MAT_CONDUCTOR, MAT_PLASTIC, MAT_DIELECTRIC):
        h = warps.ggx_sample_half(r1, r2, mp.alpha)
        wi_ggx = _reflect_about(wo, h)
    if _has(types, MAT_CONDUCTOR):
        wi = vwhere(mt == MAT_CONDUCTOR, wi_ggx, wi)

    # -- glass (smooth dielectric, stochastic Fresnel select) ----------
    if _has(types, MAT_GLASS):
        enter = wo.z > 0.0
        g_eta_i = torch.where(enter, mp.ext_ior, mp.int_ior)
        g_eta_t = torch.where(enter, mp.int_ior, mp.ext_ior)
        r_glass, cos_t = fresnel.fresnel_dielectric(wo.z, g_eta_i, g_eta_t)
        glass_reflect = rl < r_glass
        wi_glass = vwhere(glass_reflect, reflect_z(wo),
                          fresnel.refract_dir(wo, cos_t, g_eta_i / g_eta_t))
        col_glass = vwhere(glass_reflect, mp.albedo * r_glass,
                           mp.albedo * (1.0 - r_glass))
        pdf_glass = torch.where(glass_reflect, r_glass, 1.0 - r_glass)
        wi = vwhere(mt == MAT_GLASS, wi_glass, wi)

    # -- rough dielectric ---------------------------------------------
    if _has(types, MAT_DIELECTRIC):
        s = torch.where(wo.z >= 0.0, 1.0, -1.0)
        wo_c = _mirror_z(wo, s)
        d_eta_i = torch.where(s > 0.0, mp.ext_ior, mp.int_ior)
        d_eta_t = torch.where(s > 0.0, mp.int_ior, mp.ext_ior)
        r_d, cos_td = fresnel.fresnel_dielectric(wo_c.dot(h), d_eta_i,
                                                 d_eta_t)
        d_reflect = rl < r_d
        wi_d_refl = _reflect_about(wo_c, h)
        eta_ratio = d_eta_i / d_eta_t
        c = wo_c.dot(h)
        wi_d_trans = (h * (eta_ratio * c - cos_td) - wo_c * eta_ratio)
        wi_dc = vwhere(d_reflect, wi_d_refl, wi_d_trans)
        wi_diel = _mirror_z(wi_dc, s)
        valid_diel = torch.where(d_reflect, wi_dc.z > 0.0, wi_dc.z < 0.0)
        wi = vwhere(mt == MAT_DIELECTRIC, wi_diel, wi)

    # -- plastic lobe select ------------------------------------------
    if _has(types, MAT_PLASTIC):
        fr_o = _plastic_fresnel(mp, wo.z)
        plastic_spec = rl < fr_o
        wi_plastic = vwhere(plastic_spec, wi_ggx, wi_cos)
        wi = vwhere(mt == MAT_PLASTIC, wi_plastic, wi)

    # -- layered coat reflection override ------------------------------
    if coat_on:
        h_coat = warps.ggx_sample_half(r1, r2,
                                       torch.full_like(wo.z, COAT_ALPHA))
        wi = vwhere(pick_coat, _reflect_about(wo, h_coat), wi)

    # ---- per-type (colour, pdf, valid) -------------------------------
    f_eval = evaluate(mp, wo, wi, types)  # correct for all non-delta
    pdf = pdf_fn(mp, wo, wi, types)
    colour = f_eval
    if _has(types, MAT_MIRROR):
        colour = vwhere(mt == MAT_MIRROR, mp.albedo, colour)
        pdf = torch.where(mt == MAT_MIRROR, 1.0, pdf)
    if _has(types, MAT_GLASS):
        colour = vwhere(mt == MAT_GLASS, col_glass, colour)
        pdf = torch.where(mt == MAT_GLASS, pdf_glass, pdf)

    valid = pdf > 1e-9
    if _has(types, MAT_DIELECTRIC):
        valid = torch.where(mt == MAT_DIELECTRIC, valid & valid_diel, valid)
    valid = valid | is_specular(mt)
    valid = valid & (torch.abs(wi.z) > 1e-7)
    return wi, colour, pdf, valid
