"""Ray-major pair testing over a treelet cut of the BVH: CUDA kernel
wrapper, the route around it and its plain torch version.

Counterpart of raytracingrenderer_tpu/ops/treelet.py, whose Pallas
kernel `_pair_kernel` (launched by `_pair_test`) tests (ray, treelet)
pairs as four (16, T_LEAF) x (16, PAIR_TILE) matrix products on the
TPU's MXU.  Here the kernel is csrc/treelet_kernel.cu, written for
Hopper: several pairs a thread against a treelet's constants in shared
memory, in IEEE fp32 on the CUDA cores.  The route
(`traverse_treelet`) is the JAX package's, step for step:

  1. `candidates`: per ray, the treelets whose box the ray enters within
     its search radius (two-level box test: coarse groups, then their
     fine children), at most M_SLOTS per ray in ascending order of their
     position in the hit matrix, coarse slots first; a ray over a cap at
     either level overflows;
  2. the (ray, treelet) pairs, sorted (stably) by treelet id, so that
     neighbouring pairs share a treelet's constants tile;
  3. `pair_test`: per pair the constant-form Moller-Trumbore over the
     treelet's T_LEAF triangles -> the nearest t and its first column;
  4. resolve: per ray the nearest pair, the winner's triangle from
     `tl_start`; overflowed rays re-walk the BVH with the binary kernel
     (every other lane's radius negative), and u, v come from one MT
     re-solve on the winners.

Constant-form algebra (as bvh_kernel.pack_leaves16): with per-ray
features [d, o, G = o x d] and per-triangle constants [N = e1 x e2, e1,
e2, P1 = p0 x e1, P2 = p0 x e2, c0 = p0 . N]:

    det   = -(d . N)                 t*det =  o . N - c0
    u*det =  G . e2 + d . P2         v*det = -(G . e1 + d . P1)

Departures from the JAX route, none of which changes a value: the
fine boxes are gathered per (ray, coarse slot) directly rather than
through one packed 256-lane row; only the pairs of real slots go to the
pair test (the sentinel pairs sort to the back and are cut off); the
results go back to (ray, slot) order by a scatter to unique indices
rather than a second sort; the candidate stage runs in chunks of
65,536 rays in a plain loop.

`pair_test` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs `pair_test_plain`, the plain torch
version (also the kernel's reference on the card).  `launches` counts
kernel launches, `pairs` the (ray, treelet) pairs handed to them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.vec import V3
from ..geometry.intersect import DET_EPS, Hit, _mt_test
from ..scene.types import BVH, Triangles
from .launch import I32, PTR, bind, launch

T_LEAF = 128        # triangles per treelet (a constants tile's width)
M_SLOTS = 12        # per-ray candidate cap
M_COARSE = 6        # per-ray coarse-group cap
G_CHILD = 24        # most fine treelets per coarse group (the cut keeps it)
PAIR_TILE = 1024    # pairs per tile of the TPU kernel (its unit of work)
SENTINEL = 0x7FFFFF
INF = 3.0e38
_CAND_CHUNK = 65536     # rays per chunk of the candidate stage
_PAIR_CHUNK = 8192      # pairs per chunk of the plain pair test (its
                        # gathered (chunk, 16, T_LEAF) tiles: 64 MB)

launches = 0            # kernel launches since import (or the last reset)
pairs = 0               # the pairs of those launches
_lib = None


def attach_treelets(bvh: BVH, t_max: int = T_LEAF,
                    g_child: int = G_CHILD) -> BVH:
    """Host-side: cut the BVH into treelets (subtrees of at most t_max
    triangles, contiguous triangle ranges in the DFS layout) and group
    them (at most g_child treelets a group) for the two-level candidate
    search.  Topology only: the boxes are read from bvh.lo/hi."""
    right = bvh.right.cpu().numpy()
    start = bvh.start.cpu().numpy()
    count = bvh.count.cpu().numpy()
    b = right.shape[0]
    cnt = np.zeros(b, np.int64)
    st = np.zeros(b, np.int64)
    for i in range(b - 1, -1, -1):
        if right[i] < 0:
            cnt[i] = count[i]
            st[i] = start[i]
        else:
            cnt[i] = cnt[i + 1] + cnt[right[i]]
            st[i] = min(st[i + 1], st[right[i]])

    def cut_fine(i):
        out, s = [], [i]
        while s:
            j = s.pop()
            if right[j] < 0 or cnt[j] <= t_max:
                out.append(j)
            else:
                s.append(right[j])   # push right first -> pop left first
                s.append(j + 1)
        return out

    fine, coarse = [], []
    s = [0]
    while s:
        i = s.pop()
        f = cut_fine(i)
        if len(f) <= g_child:
            coarse.append((i, len(fine), len(f)))
            fine.extend(f)
        else:
            s.append(right[i])
            s.append(i + 1)
    tl_nodes = np.array(fine, np.int32)
    return bvh.replace_treelets(
        tl_nodes, st[tl_nodes], cnt[tl_nodes],
        [c[0] for c in coarse], [c[1] for c in coarse],
        [c[2] for c in coarse])


def has_treelets(bvh) -> bool:
    return (isinstance(bvh, BVH) and bvh.tl_nodes is not None
            and bvh.tc_nodes is not None)


def pack_constants(bvh: BVH, tris: Triangles) -> torch.Tensor:
    """(K*16, T_LEAF) f32 per-treelet constants: rows [N(3) e1(3) e2(3)
    P1(3) P2(3) c0] of each treelet, one column per triangle; empty
    columns are zero (det = 0 fails |det| >= eps).  Built once per
    (tree, triangles) and kept in the tree's cache, keyed on every vertex
    component.  The cross products are rounded as XLA rounds the JAX
    package's (an FMA each), so the table equals JAX's bit for bit."""
    from .bvh_kernel import geometry_deps
    return bvh.cached("treelet", geometry_deps(bvh, tris),
                      lambda: _pack_constants(bvh, tris))


def _pack_constants(bvh: BVH, tris: Triangles) -> torch.Tensor:
    from .bvh_kernel import _cross_fused
    k = bvh.tl_nodes.shape[0]
    s = bvh.tl_start.long()
    c = bvh.tl_count.long()
    j = torch.arange(T_LEAF, device=s.device)
    ti = torch.clamp(s[:, None] + j[None, :], 0, max(tris.count - 1, 0))
    valid = j[None, :] < c[:, None]
    p0, e1, e2 = tris.p0, tris.e1, tris.e2
    n = _cross_fused(e1, e2)
    p1 = _cross_fused(p0, e1)
    p2 = _cross_fused(p0, e2)
    c0 = p0.x * n.x + p0.y * n.y + p0.z * n.z
    tri16 = torch.stack([n.x, n.y, n.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z,
                         p1.x, p1.y, p1.z, p2.x, p2.y, p2.z, c0],
                        dim=-1).float()                   # (T, 16)
    g = torch.where(valid[..., None], tri16[ti], 0.0)     # (K, T_LEAF, 16)
    return g.transpose(1, 2).reshape(k * 16, T_LEAF).contiguous()


# --------------------------------------------------------------------------
# candidates: per-ray treelets (two-level box test)

def _slab_hits(box, o: V3, inv: V3, t_seed):
    """Rays (N,) against boxes given as 6 component tensors (lox, loy,
    loz, hix, hiy, hiz), each broadcastable to (N, B): True where the
    ray enters the box before t_seed."""
    lox, loy, loz, hix, hiy, hiz = box
    t0x = (lox - o.x[:, None]) * inv.x[:, None]
    t1x = (hix - o.x[:, None]) * inv.x[:, None]
    t0y = (loy - o.y[:, None]) * inv.y[:, None]
    t1y = (hiy - o.y[:, None]) * inv.y[:, None]
    t0z = (loz - o.z[:, None]) * inv.z[:, None]
    t1z = (hiz - o.z[:, None]) * inv.z[:, None]
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    te = torch.clamp(tmin, min=0.0)
    return (tmax >= te) & (te < t_seed[:, None])


def _extract_slots(hit, ids, m_slots: int):
    """hit (N, B) bool, ids (B,) or (N, B) -> (slots (N, m) int64, -1
    empty: the ids of the first m hits in column order; overflow (N,)
    bool: more than m hits)."""
    ids = torch.broadcast_to(ids, hit.shape)
    pos = torch.cumsum(hit.int(), dim=1) - 1
    slots = [torch.where(hit & (pos == m), ids, -1).amax(dim=1)
             for m in range(m_slots)]
    return torch.stack(slots, dim=1), (pos[:, -1] + 1) > m_slots


def candidates(bvh: BVH, o: V3, d: V3, t_seed
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray fine-treelet candidate slots (N, M_SLOTS) int64 (-1
    empty) and overflow flags (a cap exceeded at either level).  t_seed
    bounds the ray's closest hit (negative: a dead lane, no candidate),
    so the candidate set holds the winning treelet.  Chunked: the fine
    stage is (N, M_COARSE * G_CHILD) per box component."""
    out = [_candidates_chunk(bvh, V3(*(c[a:a + _CAND_CHUNK] for c in o)),
                             V3(*(c[a:a + _CAND_CHUNK] for c in d)),
                             t_seed[a:a + _CAND_CHUNK])
           for a in range(0, max(o.x.shape[0], 1), _CAND_CHUNK)]
    return (torch.cat([s for s, _ in out]), torch.cat([v for _, v in out]))


def _candidates_chunk(bvh: BVH, o: V3, d: V3, t_seed):
    inv = V3(1.0 / torch.where(torch.abs(d.x) < 1e-20, 1e-20, d.x),
             1.0 / torch.where(torch.abs(d.y) < 1e-20, 1e-20, d.y),
             1.0 / torch.where(torch.abs(d.z) < 1e-20, 1e-20, d.z))
    comp = (bvh.lo[:, 0], bvh.lo[:, 1], bvh.lo[:, 2],
            bvh.hi[:, 0], bvh.hi[:, 1], bvh.hi[:, 2])
    tc_nodes = bvh.tc_nodes.long()
    k2 = tc_nodes.shape[0]
    hit_c = _slab_hits(tuple(a[tc_nodes][None, :] for a in comp), o, inv,
                       t_seed)
    cslots, over_c = _extract_slots(
        hit_c, torch.arange(k2, device=tc_nodes.device), M_COARSE)
    # fine children of each coarse slot: G_CHILD boxes a group, empty
    # ones a far point (masked out below)
    g = G_CHILD
    fall = torch.arange(g, device=tc_nodes.device)
    cid = bvh.tc_start.long()[:, None] + fall[None, :]    # (K2, G)
    cvalid = fall[None, :] < bvh.tc_count.long()[:, None]
    cid = torch.where(cvalid, cid, 0)
    f_nodes = bvh.tl_nodes.long()[cid]                     # (K2, G)
    safe_c = torch.clamp(cslots, min=0)                    # (N, Mc)
    n = safe_c.shape[0]

    def take(a):               # (K2, G) -> (N, Mc * G) per coarse slot
        return a[safe_c].reshape(n, M_COARSE * g)

    fbox = tuple(take(torch.where(cvalid, a[f_nodes], 3.0e38))
                 for a in comp)
    fid = take(torch.where(cvalid, cid, -1))
    fvalid = (fid >= 0) & (cslots >= 0).repeat_interleave(g, dim=1)
    hit_f = _slab_hits(fbox, o, inv, t_seed) & fvalid
    slots, over_f = _extract_slots(hit_f, torch.clamp(fid, min=0), M_SLOTS)
    return slots, over_c | over_f


# --------------------------------------------------------------------------
# the pair test

def _feats(o: V3, d: V3, radius) -> torch.Tensor:
    """(N, 16) per-ray feature rows [d, o, G = o x d, 1, radius, 0...]:
    lane 10 carries the search radius, so a pair needs one row."""
    g = o.cross(d)
    z = torch.zeros_like(o.x)
    return torch.stack([d.x, d.y, d.z, o.x, o.y, o.z, g.x, g.y, g.z,
                        torch.ones_like(o.x), radius, z, z, z, z, z], dim=1)


def pair_test_plain(consts: torch.Tensor, feats_p: torch.Tensor,
                    tid_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the pair kernel, _PAIR_CHUNK pairs at a time.
    Per pair: the constant-form MT of its ray (feats row, radius in lane
    10) against the T_LEAF triangles of treelet tid -> (t (P,) f32, the
    nearest hit with t < radius, INF if none; col (P,) int32, its first
    column among equal t, -1 if none).  A tid outside [0, K) (the
    sentinel) is no pair.  Sums run left to right over the nonzero terms
    in constant-row order, as the kernel sums them."""
    k = consts.shape[0] // 16
    tab = consts.view(k, 16, T_LEAF)
    t_out, col_out = [], []
    for a in range(0, max(tid_p.shape[0], 1), _PAIR_CHUNK):
        f = feats_p[a:a + _PAIR_CHUNK]
        tid = tid_p[a:a + _PAIR_CHUNK].long()
        valid = (tid >= 0) & (tid < k)
        tile = tab[torch.where(valid, tid, 0)]             # (C, 16, T)
        r = [tile[:, i] for i in range(16)]
        dx, dy, dz, ox, oy, oz, gx, gy, gz = (f[:, i:i + 1] for i in range(9))
        maxt = f[:, 10:11]
        det = (-dx) * r[0] + (-dy) * r[1] + (-dz) * r[2]
        tdt = ox * r[0] + oy * r[1] + oz * r[2] - r[15]
        udt = (gx * r[6] + gy * r[7] + gz * r[8]
               + dx * r[12] + dy * r[13] + dz * r[14])
        vdt = ((-gx) * r[3] + (-gy) * r[4] + (-gz) * r[5]
               + (-dx) * r[9] + (-dy) * r[10] + (-dz) * r[11])
        sgn = torch.where(det < 0.0, -1.0, 1.0)
        ad = det * sgn
        su = udt * sgn
        sv = vdt * sgn
        st = tdt * sgn
        hit = ((ad >= DET_EPS) & (su >= 0.0) & (sv >= 0.0) & (su + sv <= ad)
               & (st > 0.0) & (st < maxt * ad))
        cand = torch.where(hit, st / torch.where(hit, ad, 1.0), INF)
        tmin, col = cand.min(dim=1)          # the first column among equals
        upd = valid & (tmin < INF)
        t_out.append(torch.where(upd, tmin, INF))
        col_out.append(torch.where(upd, col, -1).int())
    return torch.cat(t_out), torch.cat(col_out)


def _library():
    """csrc/treelet_kernel.cu's launchers, bound once."""
    global _lib
    if _lib is None:
        _lib = bind("treelet_kernel",
                    {"treelet_pair_test": [PTR] * 5 + [I32] * 2})
    return _lib


def pair_test(consts: torch.Tensor, feats_p: torch.Tensor,
              tid_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair test of `pair_test_plain` (same contract) over P pairs:
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global launches, pairs
    if consts.dim() != 2 or consts.shape[1] != T_LEAF or consts.shape[0] % 16:
        raise ValueError(f"constants must be (K*16, {T_LEAF}), got "
                         f"{tuple(consts.shape)}")
    p = tid_p.shape[0]
    if feats_p.shape != (p, 16) or tid_p.dim() != 1:
        raise ValueError(f"feats must be ({p}, 16) beside tid ({p},), got "
                         f"{tuple(feats_p.shape)} and {tuple(tid_p.shape)}")
    for name, a, dtype in (("consts", consts, torch.float32),
                           ("feats", feats_p, torch.float32),
                           ("tid", tid_p, torch.int32)):
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != consts.device:
            raise ValueError(f"{name} is on {a.device}, constants on "
                             f"{consts.device}")
    dev = consts.device
    if dev.type == "cpu":
        return pair_test_plain(consts, feats_p, tid_p)
    if dev.type != "cuda":
        raise ValueError(f"no pair-test kernel for device {dev}")
    if feats_p.data_ptr() % 16 or consts.data_ptr() % 16:
        raise ValueError("feats and consts must be 16-byte aligned (read as "
                         "float4, copied in bulk)")
    t = torch.empty(p, dtype=torch.float32, device=dev)
    col = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return t, col
    launch(_library()["treelet_pair_test"], dev,
           consts.data_ptr(), feats_p.data_ptr(), tid_p.data_ptr(),
           t.data_ptr(), col.data_ptr(), p, consts.shape[0] // 16)
    launches += 1
    pairs += p
    return t, col


# --------------------------------------------------------------------------
# the route

def traverse_treelet(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
                     any_hit: bool = False) -> Hit:
    """Closest-hit (or any-hit) through candidate pairs and the pair
    test; overflowed rays fall back to the binary packet walk (every
    other lane's radius negative).  The contract of
    bvh_kernel.traverse_packet: misses keep the caller's t_init and
    tri = -1; a negative t_init is a dead lane."""
    from . import bvh_kernel
    n = o.x.shape[0]
    dev = o.x.device
    k = bvh.tl_nodes.shape[0]
    t_in = torch.broadcast_to(t_init, (n,)).float()
    t_seed = torch.clamp(t_in, max=1e30)
    active = t_seed > 0.0
    # closest-hit: inflate the radius slightly so that the proxy hit that
    # produced the seed is itself admitted (a strict `<` at t == seed
    # would drop it and report a miss)
    radius = t_seed if any_hit else t_seed * 1.0001 + 1e-5
    slots, overflow = candidates(bvh, o, d,
                                 torch.where(active, radius, -1.0))
    overflow = overflow & active

    # pairs sorted (stably) by treelet id; empty slots key to the
    # sentinel and sort to the back, where they are cut off
    m = M_SLOTS
    p_n = n * m
    tid_f = torch.where(slots >= 0, slots, SENTINEL).reshape(-1)
    tid_s, pidx_s = torch.sort(tid_f, stable=True)
    n_pairs = int((slots >= 0).sum())
    tid_s = tid_s[:n_pairs].int()
    pidx_s = pidx_s[:n_pairs]
    feats_p = _feats(o, d, radius)[pidx_s // m]
    t_pair, col_pair = pair_test(pack_constants(bvh, tris), feats_p, tid_s)

    # resolve: back to (ray, slot) order, the nearest slot per ray (the
    # first among equals); the winner's treelet and column ride in one
    # code tid * (T_LEAF + 1) + col
    ok = t_pair < INF
    code_pair = torch.where(
        ok, tid_s.long() * (T_LEAF + 1) + torch.clamp(col_pair, max=T_LEAF),
        -1)
    t_nm = torch.full((p_n,), INF, dtype=torch.float32, device=dev)
    code_nm = torch.full((p_n,), -1, dtype=torch.int64, device=dev)
    t_nm[pidx_s] = torch.where(ok, t_pair, INF)
    code_nm[pidx_s] = code_pair
    t_nm = t_nm.view(n, m)
    t_best, sel = t_nm.min(dim=1)
    code_best = torch.take_along_dim(code_nm.view(n, m), sel[:, None],
                                     1)[:, 0]
    tid_best = torch.clamp(code_best, min=0) // (T_LEAF + 1)
    col_best = torch.clamp(code_best, min=0) % (T_LEAF + 1)
    tri_best = torch.where(
        code_best >= 0,
        bvh.tl_start.long()[torch.clamp(tid_best, 0, max(k - 1, 0))]
        + col_best, -1)
    found = (t_best < INF) & active & ~overflow

    # fallback: the binary walk; only overflowed lanes keep a radius.
    # any-hit: a pair hit is already an occlusion, so only overflowed
    # unoccluded rays walk; closest-hit: overflowed rays search below
    # min(radius, their partial best)
    if any_hit:
        fb_t = torch.where(overflow & ~(t_best < INF), t_seed, -1.0)
    else:
        fb_t = torch.where(overflow, torch.minimum(radius, t_best), -1.0)
    h_fb = bvh_kernel.traverse_packet(bvh, tris, o, d, fb_t, any_hit=any_hit)
    fb_hit = overflow & (h_fb.tri >= 0)
    # overflow lanes: the walk's hit if it found one, else the partial
    # pair result (a real hit where t_best < INF)
    part = overflow & (t_best < INF) & ~fb_hit
    t_out = torch.where(found | part, t_best, t_in)
    t_out = torch.where(fb_hit, h_fb.t, t_out)
    tri_out = torch.where(found | part, tri_best, -1)
    tri_out = torch.where(fb_hit, h_fb.tri.long(), tri_out)

    # barycentrics: one MT re-solve on the winners
    _, uu, vv, _ = _mt_test(tris, torch.clamp(tri_out, min=0), o, d)
    has = tri_out >= 0
    return Hit(torch.where(has, t_out, t_in),
               torch.where(has, tri_out, -1).int(),
               torch.where(has, uu, 0.0), torch.where(has, vv, 0.0))


def closest_hit_treelet(bvh: BVH, tris: Triangles, o: V3, d: V3,
                        t_seed) -> Hit:
    """t_seed: per-ray upper bound of the closest hit (the proxy
    pre-pass's t; BIG_T where unknown; negative = dead lane)."""
    return traverse_treelet(bvh, tris, o, d, t_seed)


def any_hit_treelet(bvh: BVH, tris: Triangles, o: V3, d: V3, max_t
                    ) -> torch.Tensor:
    return traverse_treelet(bvh, tris, o, d, max_t, any_hit=True).tri >= 0
