"""Shared integrator pieces: shading-data construction and NEE.

Counterpart of raytracingrenderer_tpu/integrators/common.py (RTBase
Scene::calculateShadingData, Scene.h:174-203, and RayTracer::
computeDirect / computeDirectMIS, Renderer.h:423-557).  Hit attributes
are read by plain indexing of the triangle and material tables; the JAX
package packs them into one row per triangle (`pack_attrs` +
`ops/gather.gather_rows`) only because gathers are slow on a TPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EPSILON
from ..core.frame import Frame
from ..core.vec import V3, vwhere
from ..geometry.intersect import Hit, _mt_test, occluded
from ..imaging import texture as tex_mod
from ..lights import lights as lights_mod
from ..materials import bsdf as bsdf_mod
from ..scene.types import Scene
from ..utils.profiling import spanned


class Shading(NamedTuple):
    x: V3              # hit position
    sn: V3             # shading normal (flipped toward wo where two-sided)
    gn: V3             # geometric normal (same flip rule)
    gn_raw: V3         # canonical geometric normal (no flip): emission
                       # sidedness keys off this
    frame: Frame
    wo_local: V3
    uv_u: torch.Tensor
    uv_v: torch.Tensor
    mp: bsdf_mod.MatParams
    light_id: torch.Tensor  # light-table row if the hit triangle is emissive


@spanned("rtr.shade")
def shading_data(scene: Scene, hit: Hit, o: V3, d: V3,
                 geom_grads: bool = False) -> Shading:
    """Interpolate attributes at the hit: barycentric normal and uv,
    two-sided flip toward wo, frame build.  Missed lanes read triangle 0
    and are masked by the caller.

    With `geom_grads`, the hit (t, beta, gamma) is solved again by
    Moller-Trumbore from the (detached) triangle id on the vertex arrays
    and the rays, which carry gradients, and attached straight-through:
    the values stay the kernel's bit for bit, while gradients see
    d(t, beta, gamma)/d(vertex positions), the hit-point
    reparameterisation of the JAX package (interior term only).

    In scene-sharded mode (parallel/scene_shard.py) the triangles' fields
    come from their owners' shading rows (`shading_triangles`, one
    all_reduce); geom_grads needs the replicated vertex arrays there and
    is refused, as in the JAX package."""
    tris = scene.triangles
    m = scene.materials
    tri = torch.clamp(hit.tri, min=0).long()
    if scene.sharded:
        if geom_grads:
            raise NotImplementedError(
                "geom_grads requires a replicated triangle table "
                "(scene_shards=0)")
        tris = scene.bvh.shading_triangles(tri)
        tri = torch.arange(tri.shape[0], device=tri.device)
    beta = hit.u
    gamma = hit.v
    t_hit = hit.t
    if geom_grads:
        t_r, u_r, v_r, ok = _mt_test(tris, tri, o, d)
        # only real hits: a missed lane (triangle 0) would feed its
        # derivatives into the backward
        val = (hit.tri >= 0) & ok

        def att(a, r):
            return a + torch.where(val, r - r.detach(), 0.0)
        t_hit = att(t_hit, t_r)
        beta = att(beta, u_r)
        gamma = att(gamma, v_r)
    alpha = 1.0 - beta - gamma
    n = (tris.n0.gather(tri) * alpha + tris.n1.gather(tri) * beta
         + tris.n2.gather(tri) * gamma).normalize()
    uv0, uv1, uv2 = tris.uv0[tri], tris.uv1[tri], tris.uv2[tri]
    u_attr = uv0[:, 0] * alpha + uv1[:, 0] * beta + uv2[:, 0] * gamma
    v_attr = uv0[:, 1] * alpha + uv1[:, 1] * beta + uv2[:, 1] * gamma
    # gn is canonicalised at load time to agree with vertex normal 0
    gn = tris.gn.gather(tri)
    light_id = tris.light_id[tri]
    # missed lanes carry the BIG_T sentinel: clamp so x stays finite
    x = o + d * torch.clamp(t_hit, max=1e12)
    wo = -d
    mid = tris.mat_id[tri].long()
    tid = m.albedo_tex[mid]
    tex_col = tex_mod.sample(scene.textures, tid, u_attr, v_attr)
    albedo = vwhere(tid >= 0, tex_col, m.albedo.gather(mid))
    mp = bsdf_mod.MatParams(
        mtype=m.mtype[mid],
        albedo=albedo,
        eta=m.eta.gather(mid),
        k=m.k.gather(mid),
        int_ior=m.int_ior[mid],
        ext_ior=m.ext_ior[mid],
        alpha=torch.clamp(m.alpha[mid], min=bsdf_mod.MIN_ALPHA),
        sigma=m.sigma[mid],
        emission=m.emission.gather(mid),
        is_emissive=m.is_emissive[mid],
        coat_thickness=m.coat_thickness[mid],
        coat_sigma_a=m.coat_sigma_a.gather(mid),
        coat_int_ior=m.coat_int_ior[mid],
        coat_ext_ior=m.coat_ext_ior[mid])
    two = bsdf_mod.is_two_sided(mp.mtype)
    flip_s = two & (wo.dot(n) < 0.0)
    flip_g = two & (wo.dot(gn) < 0.0)
    sn = vwhere(flip_s, -n, n)
    gn_raw = gn
    gn = vwhere(flip_g, -gn, gn)
    frame = Frame.from_normal(sn)
    return Shading(x=x, sn=sn, gn=gn, gn_raw=gn_raw, frame=frame,
                   wo_local=frame.to_local(wo), uv_u=u_attr, uv_v=v_attr,
                   mp=mp, light_id=light_id)


def balance_heuristic(pdf_a, pdf_b):
    """RTBase Renderer.h:408-410, guarded against a zero denominator."""
    den = pdf_a + pdf_b
    ok = den > 1e-12
    return torch.where(ok, pdf_a / torch.where(ok, den, 1.0), 0.0)


@spanned("rtr.nee")
def compute_direct(scene: Scene, sh: Shading, active, r_pick, r1, r2,
                   mis: bool, types=None, r3=None, presorted: bool = False,
                   geom_grads: bool = False, saved_occ=None,
                   power: bool = False):
    """One-light one-sample NEE; with `mis` the light-strategy term is
    balance-weighted against the BSDF pdf (computeDirectMIS light half).
    The BSDF-strategy half lives in the bounce loop (emission weighting).
    `presorted` is handed to the shadow rays' `occluded`.

    Returns (contribution, occlusion mask).  `saved_occ` replays a mask
    recorded earlier instead of tracing the shadow rays (the backward's
    recompute, path.bounce_step).
    """
    ls = lights_mod.sample_one(scene, sh.x, sh.sn, r_pick, r1, r2, r3,
                               geom_grads=geom_grads, power=power)
    specular = bsdf_mod.is_specular(sh.mp.mtype)
    cand = active & ls.valid & ~specular
    wi_local = sh.frame.to_local(ls.wi)
    f = bsdf_mod.evaluate(sh.mp, sh.wo_local, wi_local, types)
    contrib = f * ls.emitted * ls.g_over_pdf
    if mis:
        pdf_b = bsdf_mod.pdf_fn(sh.mp, sh.wo_local, wi_local, types)
        contrib = contrib * balance_heuristic(ls.pdf_solid, pdf_b)
    worth = cand & (contrib.max_comp() > 0.0)
    if saved_occ is not None:
        occ = saved_occ
    else:
        # Shadow ray (RTBase Scene::visible: epsilon pullback at both
        # ends).  Finite-light lanes trace from the light toward the
        # surface, as the JAX package does; infinite lights keep the
        # surface-out direction.  Built without autograd: the occlusion
        # bits are detached, and a replaying recompute (saved_occ) must
        # record the same graph as this forward.
        with torch.no_grad():
            finite = ls.dist < lights_mod.INF_DIST
            max_t = torch.where(finite, ls.dist - 2.0 * EPSILON, 1e30)
            shadow_o = vwhere(finite, sh.x + ls.wi * (ls.dist - EPSILON),
                              sh.x + ls.wi * EPSILON)
            shadow_d = vwhere(finite, -ls.wi, ls.wi)
            # inactive lanes: a fixed direction, a negative radius (no test)
            occ = occluded(
                scene, shadow_o,
                vwhere(worth, shadow_d, V3(0.0, 0.0, 1.0)),
                torch.where(worth, max_t, -1.0), presorted=presorted)
    lit = worth & ~occ
    return vwhere(lit, contrib, 0.0), occ
