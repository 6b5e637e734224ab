"""Light tracer (adjoint transport): light paths splatted onto the film.

Counterpart of raytracingrenderer_tpu/integrators/lighttracer.py (RTBase
lightTracer / connectToCamera / lightTracePath, Renderer.h:220-326): a
batch of light paths advances bounce by bounce (the JAX package's
lax.scan over bounces as a Python loop at full width, no compaction);
every vertex connects to the camera with importance
W_e = 1 / (A_film cos^4 theta) and geometry G, and the contributions
scatter-add into the film (film.splat).  With `mesh=` (parallel/mesh.py)
the paths split over its ranks: each traces its band of them, drawing
what the whole batch draws there (rng lane offsets), splats into a zero
film, and the films' all_reduce sum joins the incoming film on every
rank.
"""
from __future__ import annotations

import math

import torch

from ..config import EPSILON, RenderConfig
from ..core.frame import Frame
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..imaging import film as film_mod
from ..lights import lights as lights_mod
from ..materials import bsdf as bsdf_mod
from ..sampling import rng, warps
from ..scene import camera as camera_mod
from ..scene.types import Scene
from .common import shading_data


def _connect(scene: Scene, film_buf: torch.Tensor, p: V3, n: V3, col: V3,
             active: torch.Tensor) -> torch.Tensor:
    """Project p onto the camera and splat col * W_e * G where the camera
    sees it (RTBase connectToCamera, Renderer.h:234-259) -> the buffer.
    Lanes that cannot connect get a negative search radius."""
    cam = scene.camera
    x, y, proj_ok = camera_mod.project_onto_camera(cam, p)
    to_cam = V3(cam.origin.x - p.x, cam.origin.y - p.y, cam.origin.z - p.z)
    dist2 = torch.clamp(to_cam.length_sq(), min=1e-12)
    dir_ = to_cam * torch.rsqrt(dist2)
    cos_s = n.dot(dir_)
    cos_cam = camera_mod.view_direction(cam).dot(-dir_)
    ok = active & proj_ok & (cos_s > 0.0) & (cos_cam > 0.0)
    g = cos_s * cos_cam / dist2
    w_e = 1.0 / (cam.a_film * torch.clamp(cos_cam ** 4, min=1e-9))
    contrib = col * (g * w_e)
    dist = torch.sqrt(dist2)
    occ = intersect.occluded(scene, p + dir_ * EPSILON, dir_,
                             torch.where(ok, dist - 2.0 * EPSILON, -1.0))
    ok = ok & ~occ
    rgb = torch.where(ok[:, None], contrib.stacked(), 0.0)
    zero = torch.zeros((), dtype=torch.float32, device=film_buf.device)
    return film_mod.splat(film_mod.Film(film_buf, zero), x, y, rgb).buffer


def _light_points(scene: Scene, key: rng.Key, n: int, n_area: int,
                  has_bg: bool, first: int = 0):
    """Each path's light and its point: a uniform pick over the area
    lights and the background (Scene::sampleLight's pmf), a point uniform
    by area, or on the scene's bounding sphere with the inward normal for
    the background (samplePositionFromLight, Lights.h:119-126,185-193)
    -> (is_bg, p, ln, pdf_pos, the area lights' le)."""
    dev = scene.device
    n_total = n_area + (1 if has_bg else 0)
    r_pick = rng.uniform(key, 0, rng.LIGHT_PICK, (n,), dev, first)
    pick = torch.clamp((r_pick * n_total).to(torch.int32), max=n_total - 1)
    is_bg = (pick >= n_area if has_bg
             else torch.zeros(n, dtype=torch.bool, device=dev))
    r1 = rng.uniform(key, 0, rng.LIGHT_POS_U, (n,), dev, first)
    r2 = rng.uniform(key, 0, rng.LIGHT_POS_V, (n,), dev, first)
    if n_area:
        li = torch.clamp(pick, max=n_area - 1).long()
        lt = scene.lights
        _, b, g = warps.uniform_triangle(r1, r2)
        p_a = lt.p0.gather(li) + lt.e1.gather(li) * b + lt.e2.gather(li) * g
        ln_a = lt.gn.gather(li)
        pdf_pos_a = 1.0 / torch.clamp(lt.area[li], min=1e-12)
        le_a = lt.le.gather(li)
    else:
        p_a = V3.zeros((n,), device=dev)
        ln_a = V3.full((n,), 0.0, 0.0, 1.0, device=dev)
        pdf_pos_a = torch.ones(n, device=dev)
        le_a = V3.zeros((n,), device=dev)
    if not has_bg:
        return is_bg, p_a, ln_a, pdf_pos_a, le_a
    sph = warps.uniform_sphere(r1, r2)
    c = scene.bounds.centre
    r = torch.clamp(scene.bounds.radius, min=1e-6)
    p = vwhere(is_bg, V3(c.x + sph.x * r, c.y + sph.y * r, c.z + sph.z * r),
               p_a)
    ln = vwhere(is_bg, -sph, ln_a)
    pdf_pos = torch.where(is_bg, 1.0 / (4.0 * math.pi * r * r), pdf_pos_a)
    return is_bg, p, ln, pdf_pos, le_a


def light_trace_pass(scene: Scene, film: film_mod.Film, key: rng.Key,
                     cfg: RenderConfig, n_paths: int,
                     mesh=None) -> film_mod.Film:
    """One pass of n_paths light paths; the film's spp grows by 1 (the
    reference shoots width * height paths a frame, Renderer.h:222-229).
    With `mesh`, this rank traces its band of the paths and every rank
    returns the same film."""
    n_area = scene.num_lights
    has_bg = lights_mod.background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    buf = film.buffer
    if n_total == 0:
        return film_mod.Film(buf, film.spp + 1.0)
    first, n = 0, n_paths
    if mesh is not None:
        if scene.sharded:
            raise ValueError("a scene-sharded scene walks every ray on "
                             "every rank: call light_trace_pass without a "
                             "mesh")
        first, hi = mesh.band(n_paths)
        n = hi - first
        buf = torch.zeros_like(buf)
    dev = scene.device
    pmf = 1.0 / n_total
    is_bg, p, ln, pdf_pos, le_a = _light_points(scene, key, n, n_area,
                                                has_bg, first)

    # cosine-sampled emission about the (inward, for the background)
    # normal
    r3 = rng.uniform(key, 0, rng.BSDF_U, (n,), dev, first)
    r4 = rng.uniform(key, 0, rng.BSDF_V, (n,), dev, first)
    wl = warps.cosine_hemisphere(r3, r4)
    wi = Frame.from_normal(ln).to_world(wl)
    pdf_dir = warps.cosine_hemisphere_pdf(wl)
    # an area light's radiance is constant; a ray entering along wi from
    # the background carries what a camera ray escaping along -wi sees
    le = (vwhere(is_bg, lights_mod.eval_background(scene, -wi), le_a)
          if has_bg else le_a)
    # radiance over pdf carried along the path (lightTrace_init,
    # Renderer.h:260-286)
    le_over = le * (wl.z / torch.clamp(pmf * pdf_dir * pdf_pos, min=1e-12))
    # the light vertex itself: emitted radiance toward the camera (for
    # the background, the directly visible environment)
    cam = scene.camera
    dir_c = V3(cam.origin.x - p.x, cam.origin.y - p.y,
               cam.origin.z - p.z).normalize()
    le_cam = (vwhere(is_bg, lights_mod.eval_background(scene, -dir_c), le_a)
              if has_bg else le_a)
    buf = _connect(scene, buf, p, ln,
                   le_cam * (1.0 / torch.clamp(pmf * pdf_pos, min=1e-12)),
                   torch.ones(n, dtype=torch.bool, device=dev))

    o, d = p + wi * EPSILON, wi
    beta = V3.full((n,), 1.0, 1.0, 1.0, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(cfg.max_depth + 1):
        # dead lanes skip the walk; every use of their hit is masked
        hit = intersect.closest_hit(scene, o, d, alive)
        found = hit.valid & alive
        sh = shading_data(scene, hit, o, d)
        specular = bsdf_mod.is_specular(sh.mp.mtype)
        connectable = found & ~sh.mp.is_emissive & ~specular

        to_cam = V3(cam.origin.x - sh.x.x, cam.origin.y - sh.x.y,
                    cam.origin.z - sh.x.z).normalize()
        f = bsdf_mod.evaluate(sh.mp, sh.wo_local, sh.frame.to_local(to_cam),
                              cfg.mat_types)
        buf = _connect(scene, buf, sh.x, sh.sn, beta * f * le_over,
                       connectable)

        # RR and BSDF continuation (lightTracePath, Renderer.h:303-324)
        rr_p = torch.clamp(beta.lum(), max=cfg.rr_cap)
        r_rr = rng.uniform(key, depth + 1, rng.RR, (n,), dev,
                         first)
        survive = connectable & (r_rr < rr_p)
        beta = vwhere(survive, beta / torch.clamp(rr_p, min=1e-9), beta)
        b1 = rng.uniform(key, depth + 1, rng.BSDF_U, (n,), dev,
                         first)
        b2 = rng.uniform(key, depth + 1, rng.BSDF_V, (n,), dev,
                         first)
        bl = rng.uniform(key, depth + 1, rng.BSDF_LOBE, (n,), dev,
                         first)
        wi2, colour, pdf, ok = bsdf_mod.sample(sh.mp, sh.wo_local, b1, b2,
                                               bl, cfg.mat_types)
        weight = colour * (torch.abs(wi2.z) / torch.clamp(pdf, min=1e-9))
        alive = survive & ok & (weight.max_comp() > 0.0)
        beta = vwhere(alive, beta * weight, beta)
        w_world = sh.frame.to_world(wi2)
        o = vwhere(alive, sh.x + w_world * EPSILON, o)
        d = vwhere(alive, w_world, d)
    if mesh is not None:
        mesh.all_reduce(buf)
        buf = film.buffer + buf
    return film_mod.Film(buf, film.spp + 1.0)
