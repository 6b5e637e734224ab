"""Batched ray-scene intersection: brute force, BVH walks and dispatch.

Counterpart of raytracingrenderer_tpu/geometry/intersect.py.

- Scenes of 64 triangles or fewer (cornell-box's 36) test every ray
  against every triangle through the MT kernel wrapper
  (ops/mt_kernel.py).
- Larger scenes with a BVH take the packet route, as the JAX package
  does on its accelerator: the rays are sorted by a coherence key
  (`_sort_key`; the wavefront integrator passes `presorted` batches)
  and walked by the BVH kernel wrapper (ops/bvh_kernel.py); any-hit
  first runs the proxy pre-pass, the MT kernel over the 128 largest
  triangles.  A tree too deep for the kernel's stack (`usable` false)
  takes `_traverse_stackless`, counted in `stackless_calls`.
- A tree with a treelet cut (`ops/treelet.attach_treelets`, opt-in as in
  the JAX package) takes the treelet route ahead of both, in
  `closest_hit` and `occluded`: the proxy pre-pass bounds each ray's
  search, the pair-test kernel tests the (ray, treelet) pairs and the
  BVH kernel walks the overflowed rays (ops/treelet.py); counted in
  `treelet_calls`.  `presorted` plays no part there.
- Each wrapper launches its CUDA kernel for CUDA tensors and runs its
  plain torch version for CPU tensors, so both devices take the same
  route.  The JAX package's VMEM budget for the packet tables
  (`_packet_fits`, 96 MB) is a TPU limit and is not ported.
- `_traverse_stackless` (with `closest_hit_bvh` / `any_hit_bvh`) is the
  oracle: a lockstep walk over the DFS skip links in plain torch.
- A scene-sharded scene (parallel/scene_shard.ShardedBVH, ahead of all
  the above) walks each rank's shard through the same dispatch (`_walk`)
  and merges the ranks' hits.

Triangle test is Moller-Trumbore on (p0, e1, e2); barycentrics map as
alpha = 1-u-v (v0), beta = u (v1), gamma = v (v2).

Contracts (as in the JAX package): a miss is t = BIG_T, tri = -1; a lane
whose search radius t_init is negative is dead and never hits; any-hit
is tri >= 0 with t_init = max_t.  Hits are returned detached.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.vec import V3
from ..scene.types import BVH, Triangles
from ..utils.profiling import spanned

DET_EPS = 1e-12
BIG_T = 3.4e38
BRUTE_FORCE_MAX_TRIS = 64   # at most this many: every ray vs every triangle
# Proxy pre-pass (any-hit): the rays are first tested against the K
# largest triangles; a segment blocked by one of them (walls, floors)
# resolves there and skips traversal.
_PREPASS_K = 128

stackless_calls = 0   # walks that took _traverse_stackless (deep trees)
treelet_calls = 0     # calls that took the treelet route


class Hit(NamedTuple):
    t: torch.Tensor      # (N,) hit distance (BIG_T if miss)
    tri: torch.Tensor    # (N,) int32 triangle id (-1 if miss)
    u: torch.Tensor      # (N,) barycentric beta (weight of v1)
    v: torch.Tensor      # (N,) barycentric gamma (weight of v2)

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def on_live_lanes(plain, o: V3, d: V3, t_init: torch.Tensor) -> Hit:
    """plain(o, d, t_init) -> Hit run on the live lanes only (t_init > 0),
    the others given the miss every walk gives a dead lane: (t_init, -1,
    0, 0).  The kernels' wrappers take this for CPU tensors, where the
    plain versions pay for every lane (a VPL gather's shadow batches are
    mostly dead); on the card the kernels skip dead lanes themselves."""
    live = t_init > 0.0
    n = t_init.shape[0]
    if bool(live.all()):
        return plain(o, d, t_init)
    idx = torch.nonzero(live)[:, 0]
    out = Hit(t_init.to(torch.float32).clone(),
              torch.full((n,), -1, dtype=torch.int32, device=t_init.device),
              torch.zeros(n, dtype=torch.float32, device=t_init.device),
              torch.zeros(n, dtype=torch.float32, device=t_init.device))
    if idx.numel():
        h = plain(V3(*(c[idx] for c in o)), V3(*(c[idx] for c in d)),
                  t_init[idx])
        for a, b in zip(out, h):
            a[idx] = b
    return out


def _mt_test(tris: Triangles, idx, o: V3, d: V3):
    """Moller-Trumbore for rays (N,) against gathered triangles idx (N,)
    or broadcast (N, C).  Returns (t, u, v, hit)."""
    p0 = tris.p0.gather(idx)
    e1 = tris.e1.gather(idx)
    e2 = tris.e2.gather(idx)
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    # double-where: 1/det is never evaluated at det~0
    bad = torch.abs(det) < DET_EPS
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    tvec = o - p0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    hit = ((torch.abs(det) >= DET_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > 0.0))
    return t, u, v, hit


def miss_all(n_ray: int, device=None) -> Hit:
    return Hit(torch.full((n_ray,), BIG_T, dtype=torch.float32,
                          device=device),
               torch.full((n_ray,), -1, dtype=torch.int32, device=device),
               torch.zeros(n_ray, dtype=torch.float32, device=device),
               torch.zeros(n_ray, dtype=torch.float32, device=device))


def closest_hit_brute(tris: Triangles, o: V3, d: V3,
                      chunk: int = 4096) -> Hit:
    """Every ray against every triangle, `chunk` triangles at a time (the
    plain version of the MT kernel with an unbounded search radius)."""
    from ..ops import mt_kernel
    n_ray = o.x.shape[0]
    if tris.count == 0:
        return miss_all(n_ray, o.x.device)
    t_init = torch.full((n_ray,), BIG_T, dtype=torch.float32,
                        device=o.x.device)
    return mt_kernel.intersect_plain(tris, o, d, t_init, chunk)


def any_hit_brute(tris: Triangles, o: V3, d: V3, max_t: torch.Tensor,
                  chunk: int = 4096) -> torch.Tensor:
    """True where segment [0, max_t] is occluded."""
    hit = closest_hit_brute(tris, o, d, chunk)
    return hit.valid & (hit.t < max_t)


def _slab(lo, hi, o: V3, inv_d: V3, t_max):
    """Ray-AABB slab test (RTBase AABB::rayAABB, Geometry.h:151-183);
    lo/hi are (N, 3) gathered node bounds."""
    t0x = (lo[..., 0] - o.x) * inv_d.x
    t1x = (hi[..., 0] - o.x) * inv_d.x
    t0y = (lo[..., 1] - o.y) * inv_d.y
    t1y = (hi[..., 1] - o.y) * inv_d.y
    t0z = (lo[..., 2] - o.z) * inv_d.z
    t1z = (hi[..., 2] - o.z) * inv_d.z
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    return tmin, (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < t_max)


def _traverse_stackless(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
                        any_hit: bool, max_leaf: int) -> Hit:
    """Stackless threaded traversal over the DFS skip links: per ray only
    the current node; descend to i+1 on a box hit, jump to skip[i] on a
    miss.  Fixed DFS child order (no near-first), but the t_best test
    still prunes boxes."""
    n = o.x.shape[0]
    b = bvh.n_nodes
    dev = o.x.device
    inv_d = V3(1.0 / torch.where(torch.abs(d.x) < 1e-20, 1e-20, d.x),
               1.0 / torch.where(torch.abs(d.y) < 1e-20, 1e-20, d.y),
               1.0 / torch.where(torch.abs(d.z) < 1e-20, 1e-20, d.z))
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    t_b = torch.broadcast_to(t_init, (n,)).float()
    tri_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_b = torch.zeros(n, dtype=torch.float32, device=dev)
    v_b = torch.zeros(n, dtype=torch.float32, device=dev)
    right, skip = bvh.right.long(), bvh.skip.long()
    for _ in range(2 * b + 2):
        active = node < b
        if not bool(active.any()):
            break
        nd = torch.clamp(node, max=b - 1)
        _, box_hit = _slab(bvh.lo[nd], bvh.hi[nd], o, inv_d, t_b)
        box_hit = box_hit & active
        is_leaf = right[nd] == -1
        start = bvh.start[nd]
        count = bvh.count[nd]
        leaf_active = box_hit & is_leaf
        for k in range(max_leaf):
            tri_idx = torch.clamp(start + k, max=tris.count - 1).long()
            t, u, v, hit = _mt_test(tris, tri_idx, o, d)
            hit = hit & leaf_active & (k < count) & (t < t_b)
            t_b = torch.where(hit, t, t_b)
            tri_b = torch.where(hit, tri_idx.int(), tri_b)
            u_b = torch.where(hit, u, u_b)
            v_b = torch.where(hit, v, v_b)
        nxt = torch.where(box_hit & ~is_leaf, nd + 1, skip[nd])
        if any_hit:
            nxt = torch.where(tri_b >= 0, b, nxt)   # early out
        node = torch.where(active, nxt, node)
    return Hit(t_b, tri_b, u_b, v_b)


def closest_hit_bvh(bvh: BVH, tris: Triangles, o: V3, d: V3,
                    max_leaf: Optional[int] = None) -> Hit:
    n = o.x.shape[0]
    return _traverse_stackless(
        bvh, tris, o, d,
        torch.full((n,), BIG_T, dtype=torch.float32, device=o.x.device),
        False, max_leaf or bvh.leaf_max)


def any_hit_bvh(bvh: BVH, tris: Triangles, o: V3, d: V3,
                max_t: torch.Tensor, max_leaf: Optional[int] = None
                ) -> torch.Tensor:
    return _traverse_stackless(bvh, tris, o, d, max_t, True,
                               max_leaf or bvh.leaf_max).tri >= 0


def _sort_key(scene, o: V3, d: V3, active) -> torch.Tensor:
    """Coherence key for ray sorting: [active | direction octant | 6-bit
    per axis Morton cell of the origin], in int64 with the values of the
    JAX package's uint32 key; inactive rays get 0x7FFFFFFF and sort to
    the back."""
    c = scene.bounds.centre
    r = torch.clamp(scene.bounds.radius, min=1e-6)

    def cell(x, cx):
        q = torch.clamp((x - cx) / (2.0 * r) + 0.5, 0.0, 0.999)
        return (q * 64.0).to(torch.int64)            # 6 bits

    def spread3(v):
        # 10-bit Morton spread (bit i -> bit 3i); the inputs are 6-bit
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    morton = (spread3(cell(o.x, c.x))
              | (spread3(cell(o.y, c.y)) << 1)
              | (spread3(cell(o.z, c.z)) << 2))     # 18 bits
    octant = ((d.x > 0).long() | ((d.y > 0).long() << 1)
              | ((d.z > 0).long() << 2))            # 3 bits
    key = (octant << 18) | morton
    return torch.where(active, key, 0x7FFFFFFF)


def _sorted_call(scene, o: V3, d: V3, active, payload, fn):
    """Sort the rays by coherence key (stable), run fn(o, d, *payload) on
    the sorted batch, and return its per-ray output (a tensor or a
    NamedTuple of tensors) in the callers' order."""
    perm = torch.sort(_sort_key(scene, o, d, active), stable=True).indices
    out = fn(V3(*(c[perm] for c in o)), V3(*(c[perm] for c in d)),
             *(p[perm] for p in payload))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    if isinstance(out, torch.Tensor):
        return out[inv]
    return type(out)(*(a[inv] for a in out))


def _proxy_tris(scene):
    """(ids, triangles) of the _PREPASS_K largest triangles, by a stable
    descending sort of the areas (lax.top_k's tie order: lower id
    first).  Kept in the tree's cache, keyed on the areas and on every
    vertex component the triangles are gathered from: a geometry step
    that keeps the areas still gathers the moved triangles."""
    tris = scene.triangles

    def build():
        k = min(_PREPASS_K, tris.count)
        idx = torch.sort(tris.area, descending=True, stable=True
                         ).indices[:k]
        sub = Triangles(*(f.gather(idx) if isinstance(f, V3) else f[idx]
                          for f in tris))
        return idx.int(), sub

    return scene.bvh.cached(
        "proxy", (tris.area, *tris.p0, *tris.e1, *tris.e2), build)


def _proxy_prepass(scene, o: V3, d: V3, t_init) -> Hit:
    """The MT kernel over the largest triangles; triangle ids come back
    in the scene's numbering."""
    from ..ops import mt_kernel
    idx, sub = _proxy_tris(scene)
    h = mt_kernel.intersect(sub, o, d, t_init)
    return h._replace(tri=torch.where(h.tri >= 0, idx[h.tri.long()], -1))


def _use_bvh(scene) -> bool:
    return (scene.bvh is not None
            and scene.triangles.count > BRUTE_FORCE_MAX_TRIS)


def _rays(o: V3, d: V3):
    return (V3(*(c.detach().contiguous() for c in o)),
            V3(*(c.detach().contiguous() for c in d)))


@spanned("rtr.intersect")
def _walk(scene, o: V3, d: V3, t_init: torch.Tensor, any_hit: bool,
          presorted: bool) -> Hit:
    """The dispatch over one whole triangle set: `scene` is anything with
    `triangles`, `bvh` and `bounds` (a Scene, or one shard of a
    scene-sharded one, parallel/scene_shard.py).  Rays are detached and
    contiguous; t_init seeds each ray's search (negative: a dead lane).
    Any-hit: occluded where tri >= 0."""
    global stackless_calls, treelet_calls
    from ..ops import bvh_kernel, mt_kernel, treelet
    tris, bvh = scene.triangles, scene.bvh
    if not _use_bvh(scene):
        return mt_kernel.intersect(tris, o, d, t_init)
    if treelet.has_treelets(bvh):
        treelet_calls += 1
        pre = _proxy_prepass(scene, o, d, t_init)
        if not any_hit:
            # the proxy pre-pass's t is the candidate search's radius
            return treelet.closest_hit_treelet(bvh, tris, o, d,
                                               torch.minimum(pre.t, t_init))
        return _first_hit(pre, treelet.traverse_treelet(
            bvh, tris, o, d, torch.where(pre.tri >= 0, -1.0, t_init),
            any_hit=True))
    if not bvh_kernel.usable(bvh):
        stackless_calls += 1
        return _traverse_stackless(bvh, tris, o, d, t_init, any_hit,
                                   bvh.leaf_max)
    pre = None
    if any_hit:
        # segments blocked by a big surface resolve in the pre-pass and
        # skip traversal (their radius goes negative)
        pre = _proxy_prepass(scene, o, d, t_init)
        t_init = torch.where(pre.tri >= 0, -1.0, t_init)
    if presorted:
        h = bvh_kernel.traverse_packet(bvh, tris, o, d, t_init,
                                       any_hit=any_hit)
    else:
        h = _sorted_call(scene, o, d, t_init > 0.0, (t_init,),
                         lambda so, sd, st: bvh_kernel.traverse_packet(
                             bvh, tris, so, sd, st, any_hit=any_hit))
    return h if pre is None else _first_hit(pre, h)


def _first_hit(pre: Hit, h: Hit) -> Hit:
    """The pre-pass's hit where it has one, else the walk's."""
    got = pre.tri >= 0
    return Hit(*(torch.where(got, a, b) for a, b in zip(pre, h)))


def closest_hit(scene, o: V3, d: V3, active=None,
                presorted: bool = False) -> Hit:
    """Scene-level closest hit (RTBase Scene::traverse, Scene.h:107-130).

    `active` marks live lanes; inactive lanes return misses without
    paying for the test (their search radius is negative).  `presorted`
    promises that the caller already sorted the batch by the coherence
    key (wavefront mode), which skips the sort and unsort here.  A
    scene-sharded scene (parallel/scene_shard.ShardedBVH) walks every
    rank's shard and merges the hits there."""
    o, d = _rays(o, d)
    n = o.x.shape[0]
    t_init = torch.full((n,), BIG_T, dtype=torch.float32, device=o.x.device)
    if active is not None:
        t_init = torch.where(active.detach(), t_init, -1.0)
    with torch.no_grad():
        if scene.sharded:
            return scene.bvh.closest_hit(o, d, t_init)
        h = _walk(scene, o, d, t_init, False, presorted)
        return h._replace(t=torch.where(h.tri >= 0, h.t, BIG_T))


def occluded(scene, o: V3, d: V3, max_t: torch.Tensor,
             presorted: bool = False) -> torch.Tensor:
    """Scene-level any-hit (RTBase Scene::visible, Scene.h:161-169).
    Lanes with max_t < 0 are inactive and never occluded.  `presorted`:
    the batch is already coherence-sorted, so it is walked as it is."""
    o, d = _rays(o, d)
    max_t = max_t.detach().contiguous()
    with torch.no_grad():
        if scene.sharded:
            return scene.bvh.occluded(o, d, max_t)
        return _walk(scene, o, d, max_t, True, presorted).tri >= 0
