"""Instant radiosity: VPL generation and the camera rays' gather.

Counterpart of raytracingrenderer_tpu/integrators/vpl.py (RTBase
traceVPLs / VPLTracePath / computeVPLsContribution,
Renderer.h:81-218).  Pass 1 traces MAX_VPL light paths whose diffuse
vertices deposit VPLs into a table of MAX_VPL x (max_depth + 2) slots
(invalid slots masked); pass 2 shoots one camera ray a pixel and, slot
by slot, adds Le_vpl * f_vpl * f_recv * G * V: one full-width shadow-ray
batch a slot, as the JAX package's lax.scan over slots does, every slot
launched whether or not it holds a VPL.

Each surface VPL keeps its incident direction and material, so its BSDF
is evaluated with the true gather direction; emitter VPLs pass their
radiance through; background VPLs (on the scene's bounding sphere)
evaluate the background along each receiver's direction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EPSILON, MAX_VPL, RenderConfig
from ..core.frame import Frame
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..imaging import film as film_mod
from ..lights import lights as lights_mod
from ..materials import bsdf as bsdf_mod
from ..render import pixel_grid
from ..sampling import rng, warps
from ..scene.camera import generate_rays
from ..scene.types import Scene
from .common import shading_data
from .lighttracer import _light_points

# VPL kinds
VPL_SURFACE = 0   # a path vertex: its stored material and wo give the BSDF
VPL_EMITTER = 1   # on an area light: le is the emitted radiance
VPL_BG = 2        # on the bounding sphere: the background, evaluated per
                  # receiver direction at gather time


class VPLs(NamedTuple):
    x: V3        # position
    n: V3        # normal (the shading normal of a surface VPL, the inward
                 # sphere normal of a background VPL)
    wo: V3       # world direction toward the previous path vertex
    le: V3       # carried radiance / scale (divided by the pdfs and the
                 # path count; no VPL-side BSDF: that is evaluated at
                 # gather time)
    mp: bsdf_mod.MatParams  # the material at the vertex (surface VPLs)
    kind: torch.Tensor
    valid: torch.Tensor


def _dummy_mp(n: int, device=None) -> bsdf_mod.MatParams:
    z = torch.zeros(n, device=device)
    v = V3.zeros((n,), device=device)
    return bsdf_mod.MatParams(
        mtype=torch.zeros(n, dtype=torch.int32, device=device), albedo=v,
        eta=v, k=v, int_ior=z, ext_ior=z, alpha=z, sigma=z, emission=v,
        is_emissive=torch.zeros(n, dtype=torch.bool, device=device),
        coat_thickness=z, coat_sigma_a=v, coat_int_ior=z, coat_ext_ior=z)


def _cat(parts):
    """Concatenate tensors, V3s or MatParams field by field."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    return type(first)(*(_cat([getattr(p, f) for p in parts])
                         for f in first._fields))


def _row(a, i: int):
    """Row i of a tensor, V3 or MatParams as a batch of one."""
    if isinstance(a, torch.Tensor):
        return a[i:i + 1]
    return type(a)(*(_row(getattr(a, f), i) for f in a._fields))


def trace_vpls(scene: Scene, key: rng.Key, cfg: RenderConfig,
               n_paths: int = MAX_VPL) -> VPLs:
    """The VPL table: slot s * n_paths + i is path i's vertex s (s = 0 on
    the light, s = 1.. its bounces)."""
    n_area = scene.num_lights
    has_bg = lights_mod.background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    n = n_paths
    dev = scene.device
    slots = cfg.max_depth + 2  # the light vertex and the bounces
    if n_total == 0:
        z = V3.zeros((slots * n,), device=dev)
        return VPLs(z, z, z, z, _dummy_mp(slots * n, dev),
                    torch.zeros(slots * n, dtype=torch.int32, device=dev),
                    torch.zeros(slots * n, dtype=torch.bool, device=dev))

    pmf = 1.0 / n_total
    is_bg, p, ln, pdf_pos, le_a = _light_points(scene, key, n, n_area,
                                                has_bg)
    inv_np = 1.0 / n_paths
    scale0 = inv_np / torch.clamp(pmf * pdf_pos, min=1e-12)

    # VPL 0 lies on the light (a background VPL keeps the scale only:
    # its radiance depends on the direction)
    vpl_x, vpl_n, vpl_wo = [p], [ln], [ln]
    vpl_le = [vwhere(is_bg, V3(scale0, scale0, scale0), le_a * scale0)]
    vpl_mp = [_dummy_mp(n, dev)]
    vpl_kind = [torch.where(is_bg, VPL_BG, VPL_EMITTER).to(torch.int32)]
    vpl_ok = [torch.ones(n, dtype=torch.bool, device=dev)]

    r3 = rng.uniform(key, 0, rng.BSDF_U, (n,), dev)
    r4 = rng.uniform(key, 0, rng.BSDF_V, (n,), dev)
    wl = warps.cosine_hemisphere(r3, r4)
    wi = Frame.from_normal(ln).to_world(wl)
    pdf_dir = warps.cosine_hemisphere_pdf(wl)
    le = (vwhere(is_bg, lights_mod.eval_background(scene, -wi), le_a)
          if has_bg else le_a)
    # the carried term: Le cos / (pmf pdf_pos pdf_dir N)
    carried = le * (wl.z * inv_np
                    / torch.clamp(pmf * pdf_pos * pdf_dir, min=1e-12))

    o, d = p + wi * EPSILON, wi
    beta = V3.full((n,), 1.0, 1.0, 1.0, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(cfg.max_depth + 1):
        # every lane walks: a dead path's slot keeps the fields the JAX
        # package's has (masked by `valid`)
        hit = intersect.closest_hit(scene, o, d)
        found = hit.valid & alive
        sh = shading_data(scene, hit, o, d)
        specular = bsdf_mod.is_specular(sh.mp.mtype)
        deposit = found & ~sh.mp.is_emissive & ~specular
        # the deposited VPL carries the incident flux estimate, its wo
        # and its material; its BSDF toward a receiver is evaluated at
        # gather time (vpl_pass)
        vpl_x.append(sh.x)
        vpl_n.append(sh.sn)
        vpl_wo.append(-d)
        vpl_le.append(beta * carried)
        vpl_mp.append(sh.mp)
        vpl_kind.append(torch.full((n,), VPL_SURFACE, dtype=torch.int32,
                                   device=dev))
        vpl_ok.append(deposit)

        rr_p = torch.clamp(beta.lum(), max=cfg.rr_cap)
        r_rr = rng.uniform(key, depth + 1, rng.RR, (n,), dev)
        survive = deposit & (r_rr < rr_p)
        beta = vwhere(survive, beta / torch.clamp(rr_p, min=1e-9), beta)
        b1 = rng.uniform(key, depth + 1, rng.BSDF_U, (n,), dev)
        b2 = rng.uniform(key, depth + 1, rng.BSDF_V, (n,), dev)
        bl = rng.uniform(key, depth + 1, rng.BSDF_LOBE, (n,), dev)
        wi2, colour, pdf, ok = bsdf_mod.sample(sh.mp, sh.wo_local, b1, b2,
                                               bl, cfg.mat_types)
        weight = colour * (torch.abs(wi2.z) / torch.clamp(pdf, min=1e-9))
        alive = survive & ok & (weight.max_comp() > 0.0)
        beta = vwhere(alive, beta * weight, beta)
        w_world = sh.frame.to_world(wi2)
        o = vwhere(alive, sh.x + w_world * EPSILON, o)
        d = vwhere(alive, w_world, d)

    return VPLs(x=_cat(vpl_x), n=_cat(vpl_n), wo=_cat(vpl_wo),
                le=_cat(vpl_le), mp=_cat(vpl_mp), kind=_cat(vpl_kind),
                valid=_cat(vpl_ok))


def vpl_pass(scene: Scene, film: film_mod.Film, key: rng.Key,
             cfg: RenderConfig) -> film_mod.Film:
    """One instant-radiosity frame (both passes) added to the film."""
    vpls = trace_vpls(scene, rng.decision_key(key, 0, 15), cfg)
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width, scene.device)
    o, d = generate_rays(cam, xs + 0.5, ys + 0.5)
    hit = intersect.closest_hit(scene, o, d)
    sh = shading_data(scene, hit, o, d)
    shade = (hit.valid & ~sh.mp.is_emissive
             & ~bsdf_mod.is_specular(sh.mp.mtype))
    has_bg = lights_mod.background_enabled(scene)

    acc = V3.zeros_like(o.x)
    for slot in range(vpls.valid.shape[0]):
        # the slot's VPL as a batch of one row, broadcast over the pixels
        # (no full-width gather of the table)
        v = _row(vpls, slot)
        to_v = v.x - sh.x
        d2 = to_v.length_sq()
        near = d2 < 1e-4  # the reference skips near VPLs (Renderer.h:135)
        dir_ = to_v * torch.rsqrt(torch.clamp(d2, min=1e-12))
        cos_v = v.n.dot(-dir_)
        cos_x = sh.sn.dot(dir_)
        cand = shade & v.valid & ~near & (cos_v > 0.0) & (cos_x > 0.0)
        g_term = torch.where(cand, cos_v * cos_x
                             / torch.clamp(d2, min=1e-12), 0.0)
        dist = torch.sqrt(torch.clamp(d2, min=1e-12))
        occ = intersect.occluded(
            scene, sh.x + dir_ * EPSILON, dir_,
            torch.where(cand, dist - 2.0 * EPSILON, -1.0))
        f = bsdf_mod.evaluate(sh.mp, sh.wo_local, sh.frame.to_local(dir_),
                              cfg.mat_types)
        # the VPL side: a surface VPL's stored material between its wo
        # and the receiver; an emitter's radiance as it is; the
        # background along the receiver's line of sight
        vframe = Frame.from_normal(v.n)
        f_vpl = bsdf_mod.evaluate(v.mp, vframe.to_local(v.wo),
                                  vframe.to_local(-dir_), cfg.mat_types)
        le_eff = vwhere(v.kind == VPL_SURFACE, v.le * f_vpl, v.le)
        if has_bg:
            le_eff = vwhere(v.kind == VPL_BG,
                            v.le * lights_mod.eval_background(scene, dir_),
                            le_eff)
        acc = acc + le_eff * f * torch.where(occ, 0.0, g_term)
    # camera rays that hit a light see its emission
    acc = acc + vwhere(hit.valid & sh.mp.is_emissive
                       & (d.dot(sh.gn_raw) < 0.0), sh.mp.emission, 0.0)
    # camera rays that escape see the background
    if has_bg:
        acc = acc + vwhere(~hit.valid, lights_mod.eval_background(scene, d),
                           0.0)
    img = acc.stacked().reshape(cam.height, cam.width, 3)
    return film_mod.add_sample_image(film, img)
