"""Unified light sampling over the light table + background.

Counterpart of raytracingrenderer_tpu/lights/lights.py (RTBase
Scene::sampleLight + Light::sample, Scene.h:131-140, Lights.h:17-133):
uniform (or power-weighted) light selection over the area lights plus
the background when it carries power; area lights sampled uniformly by
area, a constant background uniformly over the sphere (the reference
loads no environment map).  Everything returns solid-angle quantities so the
integrator's NEE/MIS code is light-kind agnostic.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.vec import V3, vwhere
from ..sampling import warps
from ..scene.types import BG_CONST, Scene

INF_DIST = 1e30


class LightSample(NamedTuple):
    """One NEE candidate per lane."""
    wi: V3                   # unit direction toward the light
    dist: torch.Tensor       # distance to the light point (INF_DIST if infinite)
    emitted: V3              # radiance toward the shading point
    pdf_solid: torch.Tensor  # selection-inclusive pdf in solid angle (MIS)
    g_over_pdf: torch.Tensor # geometry/pdf weight: contribution = f*Le*this
    valid: torch.Tensor


def background_enabled(scene: Scene) -> bool:
    """Does the background participate as a light?  (RTBase registers it
    iff its totalIntegratedPower > 0, Scene.h:142-160.)"""
    bg = scene.background
    if bg.kind == BG_CONST:
        return bool(bg.colour.lum() > 0.0)
    return False


def num_lights(scene: Scene) -> int:
    return scene.num_lights + (1 if background_enabled(scene) else 0)


def eval_background(scene: Scene, d: V3) -> V3:
    """Radiance for escaped rays."""
    bg = scene.background
    if bg.kind == BG_CONST:
        return V3(bg.colour.x.expand(d.z.shape), bg.colour.y.expand(d.z.shape),
                  bg.colour.z.expand(d.z.shape))
    return V3.zeros_like(d.z)


def background_pdf(scene: Scene, d: V3) -> torch.Tensor:
    """Solid-angle pdf that `sample_one` picks direction d via the
    background (selection pmf not included)."""
    return torch.full_like(d.z, warps.INV_4PI)


def selection_pmf(scene: Scene, power: bool):
    """Light-selection pmfs: (pmf_area (L,) or None, pmf_bg).

    power=False: uniform 1/N.  power=True: proportional to each light's
    power (AreaLight Lum(Le)*area, BackgroundColour Lum*4pi)."""
    n_area = scene.num_lights
    has_bg = background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    dev = scene.device
    if n_total == 0:
        return None, torch.zeros((), dtype=torch.float32, device=dev)
    if not power:
        u = torch.tensor(1.0 / n_total, dtype=torch.float32, device=dev)
        return (u.expand(n_area) if n_area else None), u
    w_area = (scene.lights.power if n_area
              else torch.zeros(0, dtype=torch.float32, device=dev))
    if has_bg:
        w_bg = scene.background.colour.lum() * 4.0 * math.pi
    else:
        w_bg = torch.zeros((), dtype=torch.float32, device=dev)
    total = torch.clamp(torch.sum(w_area) + w_bg, min=1e-30)
    return ((w_area / total) if n_area else None), w_bg / total


def pick_light(scene: Scene, r_pick: torch.Tensor, power: bool,
               has_bg: bool):
    """The light each lane draws, uniformly or power-weighted over the
    area lights then the background (index num_lights; `has_bg`, as
    background_enabled says) -> (pick, its selection pmf, the
    background's pmf).  At least one light."""
    n_total = scene.num_lights + (1 if has_bg else 0)
    if power:
        pmf_tab, pmf_bg = selection_pmf(scene, True)
        concat = [pmf_tab] if scene.num_lights else []
        if has_bg:
            concat.append(pmf_bg[None])
        pmf_all = torch.cat(concat)
        cdf = torch.cumsum(pmf_all, 0)
        pick = torch.clamp(torch.searchsorted(cdf, r_pick, right=True),
                           0, n_total - 1)
        # clamp: f32 cumsum roundoff can land r_pick >= cdf[-1]
        return (pick, torch.clamp(pmf_all[pick], min=1e-12),
                torch.clamp(pmf_bg, min=1e-30))
    # uniform (RTBase Scene::sampleLight)
    pick = torch.clamp((r_pick * n_total).to(torch.int32),
                       max=n_total - 1).long()
    return pick, torch.full_like(r_pick, 1.0 / n_total), 1.0 / n_total


def sample_one(scene: Scene, x: V3, sn: V3, r_pick, r1, r2,
               r3=None, geom_grads: bool = False,
               power: bool = False) -> LightSample:
    """Pick one light per lane (uniformly, or power-weighted with `power`)
    and sample a direction to it.  Area lights are sampled uniformly by
    area (pdf 1/area, one-sided emission through the cos_light clamp);
    a constant background uniformly over the sphere (`r3`, the
    renderer's draw for an environment map's alias test, is unused).

    With `geom_grads`, emitter geometry is gathered from the triangle
    arrays through LightTable.tri instead of the table's detached copy,
    so vertex-position gradients flow through the NEE geometry term (the
    sampled point and cos/d2).  The values are the copy's bit for bit
    (the loader and geometry.refit copy them from the triangles)."""
    n_area = scene.num_lights
    has_bg = background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    if n_total == 0:
        z = torch.zeros_like(x.x)
        return LightSample(V3.zeros_like(x.x), z, V3.zeros_like(x.x), z, z,
                           torch.zeros_like(x.x, dtype=torch.bool))
    pick, pmf_pick, pmf_b = pick_light(scene, r_pick, power, has_bg)
    is_area = (pick < n_area if n_area
               else torch.zeros_like(x.x, dtype=torch.bool))

    if n_area:
        li = torch.clamp(pick, max=n_area - 1)
        lt = scene.lights
        a, b, g = warps.uniform_triangle(r1, r2)
        # point = p0 + e1*beta + e2*gamma
        if geom_grads:
            ti = lt.tri[li].long()
            tr = scene.triangles
            p0g, e1g, e2g = tr.p0.gather(ti), tr.e1.gather(ti), \
                tr.e2.gather(ti)
            ln = tr.gn.gather(ti)
        else:
            p0g, e1g, e2g = (lt.p0.gather(li), lt.e1.gather(li),
                             lt.e2.gather(li))
            ln = lt.gn.gather(li)
        p = p0g + e1g * b + e2g * g
        le = lt.le.gather(li)
        area = lt.area[li]
        to_l = p - x
        # upper clip: missed lanes carry x ~ 1e12, whose length_sq
        # overflows
        d2 = torch.clamp(to_l.length_sq(), 1e-12, 1e18)
        dist = torch.sqrt(d2)
        wi_a = to_l * (1.0 / dist)
        cos_s = torch.clamp(wi_a.dot(sn), min=0.0)
        cos_l = torch.clamp(-wi_a.dot(ln), min=0.0)
        # contribution = f * Le * G / (pmf * pdf_area); G = cos_s*cos_l/d2
        g_term = cos_s * cos_l / d2
        g_over_pdf_a = g_term * area / pmf_pick
        # solid-angle pdf incl. selection
        pos_l = cos_l > 0.0
        pdf_solid_a = torch.where(
            pos_l, pmf_pick / torch.clamp(area, min=1e-12) * d2
            / torch.where(pos_l, torch.clamp(cos_l, min=1e-9), 1.0), 0.0)
        valid_a = g_term > 0.0
    else:
        wi_a = V3.zeros_like(x.x)
        dist = torch.zeros_like(x.x)
        le = V3.zeros_like(x.x)
        g_over_pdf_a = torch.zeros_like(x.x)
        pdf_solid_a = torch.zeros_like(x.x)
        valid_a = torch.zeros_like(x.x, dtype=torch.bool)

    if has_bg:
        wi_b = warps.uniform_sphere(r1, r2)
        pdf_b = warps.uniform_sphere_pdf(wi_b)
        le_b = eval_background(scene, wi_b)
        cos_sb = torch.clamp(wi_b.dot(sn), min=0.0)
        g_over_pdf_b = cos_sb / torch.clamp(pdf_b, min=1e-12) / pmf_b
        pdf_solid_b = pmf_b * pdf_b
        valid_b = (cos_sb > 0.0) & (pdf_b > 0.0)
    else:
        wi_b = V3.zeros_like(x.x)
        le_b = V3.zeros_like(x.x)
        g_over_pdf_b = torch.zeros_like(x.x)
        pdf_solid_b = torch.zeros_like(x.x)
        valid_b = torch.zeros_like(x.x, dtype=torch.bool)

    return LightSample(
        wi=vwhere(is_area, wi_a, wi_b),
        dist=torch.where(is_area, dist, INF_DIST),
        emitted=vwhere(is_area, le, le_b),
        pdf_solid=torch.where(is_area, pdf_solid_a, pdf_solid_b),
        g_over_pdf=torch.where(is_area, g_over_pdf_a, g_over_pdf_b),
        valid=torch.where(is_area, valid_a, valid_b))


def hit_light_pdf_solid(scene: Scene, light_id, x: V3, hit_p: V3,
                        light_gn: V3, power: bool = False) -> torch.Tensor:
    """pdf (solid angle, selection-inclusive) that NEE would have sampled
    the point hit by BSDF sampling: the MIS counterweight.  `power` must
    match sample_one's selection mode."""
    n_total = num_lights(scene)
    if n_total == 0 or scene.num_lights == 0:
        return torch.zeros_like(x.x)
    li = torch.clamp(light_id, min=0).long()
    if power:
        pmf_tab, _ = selection_pmf(scene, True)
        pmf = pmf_tab[li]
    else:
        pmf = 1.0 / n_total
    area = scene.lights.area[li]
    to_l = hit_p - x
    d2 = torch.clamp(to_l.length_sq(), min=1e-12)
    wi = to_l * torch.rsqrt(d2)
    cos_l = torch.clamp(-wi.dot(light_gn), min=0.0)
    # double-where: torch's division backward forms (a / b) / b, which
    # overflows to inf on a masked lane whose x lies at the 1e12 miss
    # clamp (d2 ~ 1e24) and whose cos_l is tiny; times the mask's zero
    # that is NaN (the JAX package's -g * a * b^-2 stays finite there)
    ok = (light_id >= 0) & (cos_l > 1e-9)
    den = torch.where(ok, torch.clamp(area * cos_l, min=1e-12), 1.0)
    return torch.where(ok, pmf * d2 / den, 0.0)
