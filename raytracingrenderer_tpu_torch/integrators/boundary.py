"""Visibility boundary term of NEE (edge sampling) for gradients.

Counterpart of raytracingrenderer_tpu/integrators/boundary.py.  The
detached estimator (diff.py) differentiates only the interior of the
rendering integral: the occlusion bits carry no gradient, so the edge
integral of a moving shadow boundary is missing (the JAX package
measured 253% wrong-signed bias on a shadow-edge loss without it).  This
module estimates that term for the direct (NEE) integral over area
lights, after Li et al. 2018 ("Differentiable Monte Carlo Ray Tracing
through Edge Sampling"), with the radiance jump found by two visibility
probes, one each side of the boundary:

    dL/dtheta |boundary = sum over the occlusion boundaries C on the
    light of  INT_C  -J(y) h(y) (dy/dtheta . m) dsigma(y)

h = f * Le * G is the direct integrand without V, m a unit normal of C
in the light's plane and J = lit(y + eps m) - lit(y - eps m) in
{-1, 0, +1}.  A sample picks a point z on a mesh edge (length-weighted
candidates, resampled by how much of the edge projects into the light),
projects it from the shading point x onto the light's plane (y), probes
both sides and weights by |dy/dt| over the sampling density.  Edges that
are no silhouette, or that lie behind other occluders, give J = 0.

It is injected with a value of zero: -J * detach(h w) * (y.m -
detach(y.m)) leaves every image bit for bit as it was, and its gradient
is the boundary integral.  y moves with the edge's endpoints and with x
(which carries d(hit)/d(vertex) under geom_grads); the probe rays start
from the detached x.

The random streams are the JAX package's: rng.fold_in(key, 0xB0 + e) a
sample, fold_in(ekey, 0xE0 + j) for the RIS candidates and 0xEF for the
pick, with the decisions BND_PICK, BND_EDGE, BND_T, BND_CELL, all keyed
by pixel id.  The probes are `occluded` calls (B1 on brute-force scenes,
B2 with B1's proxy pre-pass on BVH scenes); their bits are returned so
that the backward's recompute (path.step) replays them instead of
tracing again.

Scope (the JAX package's): area lights only, and only the NEE
visibility boundary; neither the indirect boundaries nor the primary
camera silhouette are estimated.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import EPSILON, RenderConfig
from ..core.vec import V3, vwhere
from ..geometry.intersect import occluded
from ..lights import lights as lights_mod
from ..materials import bsdf as bsdf_mod
from ..sampling import rng
from ..scene.types import Scene, Triangles
from ..utils.profiling import span, spanned
from .common import Shading

S_CELLS = 8      # cells of an edge for the guided choice of t
E_TRY = 4        # RIS candidates a sample
RIS_EPS = 0.05   # added to a candidate's valid cells: p_hat > 0 anywhere
GUIDED = 0.9     # share of the guided cells in t's mixture density
UNIFORM = 0.1    # and of the uniform draw


def _det(v: V3) -> V3:
    return V3(*(c.detach() for c in v))


def _edge_table(scene: Scene):
    """(3T,) edge lengths, their cdf and total, for length-weighted edge
    sampling (edge k = 3 * triangle + which).  Detached: the sampling
    density belongs to the estimator, not the integrand."""
    tr = scene.triangles
    e1, e2 = _det(tr.e1), _det(tr.e2)
    lens = torch.stack([e1.length(), (e2 - e1).length(), e2.length()],
                       dim=1).reshape(-1)
    cdf = torch.cumsum(lens, 0)
    return lens, cdf, torch.clamp(cdf[-1], min=1e-20)


def _edge_endpoints(tr: Triangles, tri: torch.Tensor, which: torch.Tensor):
    """Endpoints of edge `which` of triangle `tri`: 0 = (p0, p0 + e1),
    1 = (p0 + e1, p0 + e2), 2 = (p0 + e2, p0); gathered from the live
    triangle arrays, so d(endpoint)/d(tri_p0) flows."""
    p0, e1, e2 = tr.p0.gather(tri), tr.e1.gather(tri), tr.e2.gather(tri)
    a = vwhere(which == 0, p0, vwhere(which == 1, p0 + e1, p0 + e2))
    b = vwhere(which == 0, p0 + e1, vwhere(which == 1, p0 + e2, p0))
    return a, b


class _Light(NamedTuple):
    """A lane's picked light (detached), with the terms of the
    barycentric inside test; `unsqueeze` broadcasts it over a leading
    dimension."""
    q0: V3
    e1: V3
    e2: V3
    d00: torch.Tensor
    d01: torch.Tensor
    d11: torch.Tensor
    det: torch.Tensor

    @staticmethod
    def of(q0: V3, e1: V3, e2: V3) -> "_Light":
        d00, d01, d11 = e1.dot(e1), e1.dot(e2), e2.dot(e2)
        det = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
        return _Light(q0, e1, e2, d00, d01, d11, det)

    def unsqueeze(self) -> "_Light":
        return _Light(*(V3(*(c[None] for c in f)) if isinstance(f, V3)
                        else f[None] for f in self))

    def inside(self, p: V3) -> torch.Tensor:
        pq = p - self.q0
        dp1, dp2 = pq.dot(self.e1), pq.dot(self.e2)
        al = (self.d11 * dp1 - self.d01 * dp2) / self.det
        be = (self.d00 * dp2 - self.d01 * dp1) / self.det
        return (al >= 0.0) & (be >= 0.0) & (al + be <= 1.0)


@spanned("rtr.boundary.cells")
def _valid_cells(light: _Light, n_l: V3, num: torch.Tensor, x: V3, a: V3,
                 b: V3) -> torch.Tensor:
    """(S_CELLS, N) bool: the cells of edge (a, b) with an end whose
    projection from x lands inside the light beyond the edge (s > 1).
    All inputs detached; the S_CELLS + 1 ends are taken at once, one row
    each (so that sums and scans over the cells run across rows)."""
    tv = torch.arange(S_CELLS + 1, dtype=torch.float32,
                      device=num.device)[:, None] / S_CELLS
    row = lambda v: V3(*(c[None] for c in v))  # noqa: E731
    a, b, x, n_l = row(a), row(b), row(x), row(n_l)
    zt = a + (b - a) * tv
    den = n_l.dot(zt - x)
    small = torch.abs(den) < 1e-12
    st = torch.where(small, -1.0, num[None] / torch.where(small, 1.0, den))
    yt = x + (zt - x) * st
    ends = (st > 1.0 + 1e-5) & light.unsqueeze().inside(yt)
    return ends[:-1] | ends[1:]


@spanned("rtr.boundary")
def boundary_direct(scene: Scene, sh: Shading, active: torch.Tensor, key,
                    depth: int, ids: torch.Tensor, cfg: RenderConfig,
                    saved_occ: Optional[torch.Tensor] = None
                    ) -> Tuple[V3, torch.Tensor]:
    """(V3 of value zero whose gradient is the NEE visibility boundary
    term at this bounce's shading points, the probes' occlusion bits
    (2 * cfg.boundary_samples, N)).  The caller adds the V3, times the
    throughput, to the radiance beside compute_direct's.  `saved_occ`
    replays bits recorded earlier instead of tracing the probes."""
    n = sh.uv_u.shape[0]
    dev = sh.uv_u.device
    out = V3.zeros((n,), device=dev)
    occs = []
    if scene.num_lights == 0:
        return out, torch.zeros((0, n), dtype=torch.bool, device=dev)
    lens, cdf, total_len = _edge_table(scene)
    has_bg = lights_mod.background_enabled(scene)
    x = sh.x
    x_det = _det(x)
    lt = scene.lights
    tr_det = scene.triangles._replace(p0=_det(scene.triangles.p0))

    for e in range(cfg.boundary_samples):
        ekey = rng.fold_in(key, 0xB0 + e)
        r_pick = rng.uniform_ids(ekey, depth, rng.BND_PICK, ids)
        r_t = rng.uniform_ids(ekey, depth, rng.BND_T, ids)
        # the light pick of NEE; lanes that draw the background are
        # dropped (is_area False): its boundary term is out of scope
        pick, pmf_pick, _ = lights_mod.pick_light(scene, r_pick,
                                                  cfg.power_lights, has_bg)
        is_area = pick < scene.num_lights
        li = torch.clamp(pick, max=scene.num_lights - 1)
        # the light's geometry: differentiable under geom_grads
        if cfg.geom_grads:
            ltri = lt.tri[li].long()
            tr = scene.triangles
            q0, le1, le2 = (tr.p0.gather(ltri), tr.e1.gather(ltri),
                            tr.e2.gather(ltri))
        else:
            q0, le1, le2 = lt.p0.gather(li), lt.e1.gather(li), lt.e2.gather(li)
        n_l = le1.cross(le2)
        area2 = torch.clamp(n_l.length(), min=1e-20)   # twice the area
        n_l = n_l * (1.0 / area2)
        # the canonical one-sided emission normal (the raw cross product
        # can point the other way)
        gn_l = _det(lt.gn.gather(li))
        light_le = _det(lt.le.gather(li))
        light = _Light.of(_det(q0), _det(le1), _det(le2))
        n_ld = _det(n_l)
        num_det = n_ld.dot(light.q0 - x_det)

        with torch.no_grad():
            # RIS over E_TRY length-weighted candidate edges, target
            # p_hat = valid cells + RIS_EPS; the pick carries the Talbot
            # factor mean(p_hat / p_len) / p_hat_pick in place of 1/p_len
            cand_k, cand_ph, cand_w = [], [], []
            for j in range(E_TRY):
                r_ej = rng.uniform_ids(rng.fold_in(ekey, 0xE0 + j), depth,
                                       rng.BND_EDGE, ids)
                kj = torch.clamp(torch.searchsorted(cdf, r_ej * total_len,
                                                    right=True),
                                 0, lens.shape[0] - 1)
                tj = kj // 3
                aj, bj = _edge_endpoints(tr_det, tj, kj - 3 * tj)
                ph = _valid_cells(light, n_ld, num_det, x_det, aj, bj).sum(
                    0).to(torch.float32) + RIS_EPS
                cand_k.append(kj)
                cand_ph.append(ph)
                cand_w.append(ph / (torch.clamp(lens[kj], min=1e-12)
                                    / total_len))
            wsum = sum(cand_w)
            r_ris = rng.uniform_ids(rng.fold_in(ekey, 0xEF), depth,
                                    rng.BND_EDGE, ids)
            target = r_ris * wsum
            acc = torch.zeros_like(wsum)
            pick_j = torch.zeros_like(cand_k[0])
            for j in range(E_TRY):
                prev = acc
                acc = acc + cand_w[j]
                pick_j = torch.where((target >= prev) & (target < acc), j,
                                     pick_j)
            rows = torch.arange(n, device=dev)
            k = torch.stack(cand_k, 1)[rows, pick_j]
            ph_pick = torch.stack(cand_ph, 1)[rows, pick_j]
            ris_w = wsum / (E_TRY * torch.clamp(ph_pick, min=1e-6))

        tri = k // 3
        which = k - 3 * tri
        a, b = _edge_endpoints(scene.triangles, tri, which)
        # never the picked light's own edges: its domain boundary belongs
        # to the area sampling
        on_light = tri == lt.tri[li]

        with torch.no_grad():
            # t along the edge: GUIDED from the valid cells, the rest
            # uniform, so the density is positive wherever the integrand
            # is; it is the mixture's density at the t drawn
            vcell = _valid_cells(light, n_ld, num_det, x_det, _det(a),
                                 _det(b))
            n_valid = vcell.sum(0)
            csum = torch.cumsum(vcell.to(torch.int32), 0)
            u = rng.uniform_ids(ekey, depth, rng.BND_CELL, ids)
            guided = (u < GUIDED) & (n_valid > 0)
            # the k-th (0-based) valid cell, k = floor(u / 0.9 * n_valid)
            kth = torch.minimum((u / GUIDED * n_valid).to(torch.int32),
                                torch.clamp(n_valid - 1, min=0))
            cell = (csum <= kth).sum(0)
            t_guided = (cell.to(torch.float32) + r_t) / S_CELLS
            t_unif = torch.clamp((u - GUIDED) / UNIFORM, 0.0,
                                 1.0 - 1e-7)
            t_unif = torch.where(n_valid > 0, t_unif, r_t)
            t_s = torch.where(guided, t_guided, t_unif)
            cell_at = torch.clamp((t_s * S_CELLS).to(torch.int32),
                                  max=S_CELLS - 1).long()
            g_at = torch.where(
                torch.gather(vcell, 0, cell_at[None])[0],
                S_CELLS / torch.clamp(n_valid, min=1), 0.0)
            dens = torch.where(n_valid > 0, GUIDED * g_at + UNIFORM,
                               1.0)
        z = a + (b - a) * t_s

        # z projected from x onto the light's plane
        zx = z - x
        denom = n_l.dot(zx)
        num = n_l.dot(q0 - x)
        small = torch.abs(denom) < 1e-12
        safe_den = torch.where(small, 1.0, denom)
        s = torch.where(small, -1.0, num / safe_den)
        y = x + zx * s
        # z strictly between x and the light's plane: it can occlude
        valid = is_area & ~on_light & (s > 1.0 + 1e-5) & active

        with torch.no_grad():
            # the boundary curve's tangent dy/dt and its normal m in the
            # light's plane
            dz = b - a
            ds = -(s / safe_den) * n_l.dot(dz)
            dy = dz * s + zx * ds
            speed = dy.length()
            m_hat = n_ld.cross(dy).normalize()
            valid = valid & (speed > 1e-12)

            # two-sided probes
            eps_y = 1e-3 * torch.sqrt(torch.clamp(area2 * 0.5, min=1e-12))
            y_det = _det(y)
            off = m_hat * eps_y
            worth = valid & light.inside(y_det + off) & light.inside(
                y_det - off)

            def probe(p: V3, i: int):
                """lit(x -> p): inside the light and unoccluded."""
                seg = p - x_det
                dist = torch.clamp(seg.length(), min=1e-12)
                wi = seg * (1.0 / dist)
                ok = worth & light.inside(p)
                if saved_occ is not None:
                    occ = saved_occ[i]
                else:
                    # inactive lanes: a fixed direction, a negative radius
                    with span("rtr.boundary.probes"):
                        occ = occluded(
                            scene, x_det + wi * EPSILON,
                            vwhere(ok, wi, V3(0.0, 0.0, 1.0)),
                            torch.where(ok, dist - 2.0 * EPSILON, -1.0))
                occs.append(occ)
                return ok & ~occ, wi, dist

            lit_p, wi, dist = probe(y_det + off, 2 * e)
            lit_m, _, _ = probe(y_det - off, 2 * e + 1)
            jump = lit_p.to(torch.float32) - lit_m.to(torch.float32)

            # h(y) = f Le G
            f = bsdf_mod.evaluate(sh.mp, sh.wo_local, sh.frame.to_local(wi),
                                  cfg.mat_types)
            cos_s = torch.clamp(wi.dot(sh.sn), min=0.0)
            cos_l = torch.clamp(-wi.dot(gn_l), min=0.0)  # one-sided
            g_term = cos_s * cos_l / torch.clamp(dist * dist, min=1e-12)
            h = f * light_le * g_term
            # ris_w replaces a plain length-weighted draw's 1/p_len(k);
            # edge_mult divides out an edge shared by two triangles
            mult = 1.0 if scene.edge_mult is None else scene.edge_mult[k]
            w = torch.where(worth, speed * ris_w / (
                pmf_pick * dens * mult * cfg.boundary_samples), 0.0)

        # zero-valued injection: primal 0, gradient dy/dtheta . m
        ym = y.dot(m_hat)
        vel = ym - ym.detach()
        out = out + h * (-jump * w * vel)
    return out, torch.stack(occs)
