"""Path tracer: NEE (+MIS) with Russian roulette over flat ray batches.

Counterpart of raytracingrenderer_tpu/integrators/path.py (RTBase
RayTracer::pathTrace, Renderer.h:328-392).  The JAX package's
`lax.scan` over depths becomes a Python loop with alive masks; RR, the
depth cutoff and emissive termination are masks, as there:

  depth 0..max_depth   : emissive-hit add -> NEE -> RR -> BSDF continue
  depth max_depth+1    : emissive-hit add -> NEE -> stop

Deliberate departures from RTBase are the JAX package's: MIS on by
default, escaped rays weighted by throughput, one-sided emission.
Every random decision is keyed by the ray's pixel id (rng.uniform_ids),
so the same key gives the same path in both packages.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import EPSILON, RenderConfig
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..lights import lights as lights_mod
from ..materials import bsdf as bsdf_mod
from ..sampling import rng
from ..scene.types import Scene
from .common import balance_heuristic, compute_direct, shading_data


def init_state(o: V3, d: V3, first_id: int = 0) -> dict:
    """Fresh per-ray bounce state for a batch of primary rays; ray i
    draws its numbers as pixel first_id + i (a band of rows of a larger
    image passes its first pixel, parallel/mesh.render_sharded)."""
    n = o.x.shape[0]
    dev = o.x.device
    return dict(
        o=o, d=d,
        ids=torch.arange(first_id, first_id + n, dtype=torch.int64,
                         device=dev),
        throughput=V3.full((n,), 1.0, 1.0, 1.0, device=dev),
        radiance=V3.zeros((n,), device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        # canHitLight: on the primary ray and after specular bounces
        can_hit_light=torch.ones(n, dtype=torch.bool, device=dev),
        prev_pdf=torch.zeros(n, dtype=torch.float32, device=dev),
    )


def bounce_step(scene: Scene, state: dict, depth: int, key: rng.Key,
                cfg: RenderConfig, presorted: bool = False, saved=None,
                return_saved: bool = False):
    """One bounce over the whole (possibly compacted) ray batch.  With
    `presorted` the batch is already coherence-sorted (wavefront mode),
    and the closest-hit dispatch skips its own sort and unsort.

    `saved` = {"hit": Hit, "occ": bool tensor, "bnd_occ": bool tensor or
    None} replays traversal results recorded earlier (the closest hits,
    the shadow rays' and the boundary probes' occlusion bits) instead of
    walking the scene: the backward's recompute (`step`) passes them, so
    it launches no kernel.
    `return_saved` makes the bounce return (state, saved) to record."""
    o, d = state["o"], state["d"]
    ids = state["ids"]
    alive = state["alive"]
    beta = state["throughput"]
    radiance = state["radiance"]

    if saved is not None:
        hit = saved["hit"]
    else:
        hit = intersect.closest_hit(scene, o, d, alive, presorted=presorted)
    found = hit.valid & alive
    missed = alive & ~hit.valid

    # ---- escaped rays: background -------------------------------------
    bg = lights_mod.eval_background(scene, d)
    if lights_mod.background_enabled(scene):
        if cfg.mis:
            _, pmf_bg = lights_mod.selection_pmf(scene, cfg.power_lights)
            pdf_l = lights_mod.background_pdf(scene, d) * pmf_bg
            w_bg = torch.where(state["can_hit_light"], 1.0,
                               balance_heuristic(state["prev_pdf"], pdf_l))
        else:
            w_bg = state["can_hit_light"].to(torch.float32)
    else:
        w_bg = torch.ones_like(d.z)  # pure miss colour, not a light
    radiance = radiance + vwhere(missed, beta * bg * w_bg, 0.0)

    sh = shading_data(scene, hit, o, d, geom_grads=cfg.geom_grads)

    # ---- emissive hit: add Le, terminate ------------------------------
    hit_le = sh.mp.emission
    one_sided = d.dot(sh.gn_raw) < 0.0
    is_light = found & sh.mp.is_emissive
    if cfg.mis:
        pdf_l = lights_mod.hit_light_pdf_solid(
            scene, sh.light_id, o, sh.x, sh.gn_raw, power=cfg.power_lights)
        w_le = torch.where(state["can_hit_light"], 1.0,
                           balance_heuristic(state["prev_pdf"], pdf_l))
    else:
        w_le = state["can_hit_light"].to(torch.float32)
    add_le = is_light & one_sided
    if not cfg.debug_no_emission:
        radiance = radiance + vwhere(add_le, beta * hit_le * w_le, 0.0)

    shade = found & ~is_light  # terminate on lights

    # ---- NEE -----------------------------------------------------------
    r_pick = rng.uniform_ids(key, depth, rng.LIGHT_PICK, ids)
    r_lu = rng.uniform_ids(key, depth, rng.LIGHT_POS_U, ids)
    r_lv = rng.uniform_ids(key, depth, rng.LIGHT_POS_V, ids)
    r_aux = rng.uniform_ids(key, depth, rng.LIGHT_AUX, ids)
    # shadow rays are not presorted, even in wavefront mode: their key
    # holds the direction toward the light, not the bounce direction
    direct, occ = compute_direct(
        scene, sh, shade, r_pick, r_lu, r_lv, cfg.mis, cfg.mat_types,
        r3=r_aux, geom_grads=cfg.geom_grads,
        saved_occ=None if saved is None else saved["occ"],
        power=cfg.power_lights)
    if not cfg.debug_no_nee:
        radiance = radiance + beta * direct
    bnd_occ = None
    if cfg.boundary_grads:
        raise NotImplementedError("the reference has no boundary term")

    # ---- depth cutoff / RR / BSDF continuation -------------------------
    cont = shade & (depth <= cfg.max_depth)
    if cfg.rr:
        # the survival probability belongs to the sampling distribution:
        # detached, else its 1/p weight leaks a spurious gradient term
        rr_p = torch.clamp(beta.lum(), max=cfg.rr_cap).detach()
        r_rr = rng.uniform_ids(key, depth, rng.RR, ids)
        survive = cont & (r_rr < rr_p)
        beta = vwhere(survive, beta / torch.clamp(rr_p, min=1e-9), beta)
    else:
        survive = cont

    r1 = rng.uniform_ids(key, depth, rng.BSDF_U, ids)
    r2 = rng.uniform_ids(key, depth, rng.BSDF_V, ids)
    rl = rng.uniform_ids(key, depth, rng.BSDF_LOBE, ids)
    wi_local, colour, pdf, ok = bsdf_mod.sample(
        sh.mp, sh.wo_local, r1, r2, rl, cfg.mat_types)
    specular = bsdf_mod.is_specular(sh.mp.mtype)
    # throughput update: specular lanes skip the cosine (their colour/pdf
    # already account for it)
    cos_term = torch.where(specular, 1.0, torch.abs(wi_local.z))
    weight = colour * (cos_term / torch.clamp(pdf, min=1e-9))
    alive_next = survive & ok & (weight.max_comp() > 0.0)
    beta = vwhere(alive_next, beta * weight, beta)

    wi = sh.frame.to_world(wi_local)
    new_o = sh.x + wi * EPSILON
    out = dict(
        o=vwhere(alive_next, new_o, o),
        d=vwhere(alive_next, wi, d),
        ids=ids,
        throughput=beta,
        radiance=radiance,
        alive=alive_next,
        can_hit_light=torch.where(alive_next, specular,
                                  state["can_hit_light"]),
        prev_pdf=torch.where(alive_next, pdf, state["prev_pdf"]),
    )
    if return_saved:
        return out, {"hit": hit, "occ": occ, "bnd_occ": bnd_occ}
    return out


def step(scene: Scene, state: dict, depth: int, key: rng.Key,
         cfg: RenderConfig, presorted: bool = False) -> dict:
    """bounce_step, checkpointed when gradients are being recorded and
    cfg.remat is set: the bounce keeps only its inputs and its traversal
    results (hits, and the occlusion bits of the shadow rays and of the
    boundary probes) for the backward, which runs the
    bounce again with those results replayed, so it never traverses.
    The counterpart of the JAX package's jax.checkpoint with
    save_only_these_names("ray_hit", "ray_occ"); the random numbers are
    keyed by pixel id, so the recompute draws the same ones."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return bounce_step(scene, state, depth, key, cfg, presorted)
    rec = {}

    def body(st):
        if "saved" in rec:
            return bounce_step(scene, st, depth, key, cfg, presorted,
                               saved=rec["saved"])
        out, rec["saved"] = bounce_step(scene, st, depth, key, cfg,
                                        presorted, return_saved=True)
        return out

    return checkpoint(body, state, use_reentrant=False,
                      preserve_rng_state=False)


def trace_radiance(scene: Scene, o: V3, d: V3, key: rng.Key,
                   cfg: RenderConfig, first_id: int = 0, post=None) -> V3:
    """Estimate radiance along a batch of primary rays (one sample/ray);
    `first_id` as in init_state.  `post(state)`, where given, maps the
    bounce state before the first bounce and after each (the control's
    rounding to a lower precision, rtbench/reference/precision.py)."""
    state = init_state(o, d, first_id)
    if post is not None:
        state = post(state)
    for depth in range(cfg.max_depth + 2):  # depths 0..max_depth+1
        state = step(scene, state, depth, key, cfg)
        if post is not None:
            state = post(state)
    return state["radiance"]
