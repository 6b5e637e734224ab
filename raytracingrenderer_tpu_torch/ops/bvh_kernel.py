"""Ordered binary-BVH traversal (closest-hit and any-hit): CUDA kernel
wrapper, its packed tables and its plain torch version.

Counterpart of raytracingrenderer_tpu/ops/bvh_kernel.py, whose Pallas
kernel `_kernel` (launched by `traverse_packet`) walks the tree once for
a whole block of rays on the TPU.  Here the kernel is csrc/bvh_kernel.cu,
written for Hopper: one ray per thread, each with its own stack.  It
computes what the TPU kernel computes, over the same tables:

- nodes (I, 16) f32, one row per internal node holding both children:
  `[llo lhi rlo rhi] lcode rcode axisbits 0`, codes as f32 integers (an
  internal child is its row, a leaf child -(leaf_row + 1));
- leaves, raw (L, 128) f32 rows of 14 x [p0 e1 e2] + start + count for
  closest-hit, or constant-form (2L, 128) f32 row pairs of 14 x
  [N e1 e2 P1 P2 c0] with start/count at lanes 120/121 of the odd row
  for any-hit (`pack_leaves16`);
- per ray: `t_entry < t_best` re-pruning of every popped subtree, the
  near child first, leaves of up to 14 triangles tested densely,
  any-hit stopping at the first hit, a 64-entry stack and an iteration
  cap of 4 * nodes + 64.

One departure, by design: the near child is chosen by the ray's own
direction sign on the node's split axis, not by the sign of the ray
block's summed direction, which only a packet walk needs.  Order
decides nothing but ties between equal t in different leaves.

`traverse_packet` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs `traverse_plain`, the plain torch
version (a lockstep loop over the batch with per-ray stacks, the same
near-child rule and arithmetic), which is also the kernel's reference
on the card.  `launches` counts kernel launches per variant.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..core.vec import V3
from ..geometry.intersect import BIG_T, DET_EPS, Hit
from ..scene.types import BVH, Triangles

MAX_STACK = 64          # >= tree depth
INF = 3.0e38            # box-miss sentinel, below BIG_T
SEED_CLAMP = 1e30       # seeds stay below INF so that pruning engages
SLOTS = 14              # triangles per leaf row: 14 * 9 = 126 lanes
LANE_START = 126        # raw leaf row lane of the base triangle index
LANE16_START = 120      # its lane in the odd constant-form row

# kernel launches since import (or the last reset), per variant
launches: Dict[str, int] = {"closest_hit": 0, "any_hit": 0}
_lib = None


def _leaf_slots(bvh: BVH, tris: Triangles):
    """Per leaf row: start, count, and the (L, SLOTS) triangle ids and
    validity of its slots."""
    is_int = bvh.right >= 0
    n_leaf = (bvh.n_nodes + 1) // 2
    leaf_ids = torch.nonzero(~is_int)[:n_leaf, 0]
    start = bvh.start[leaf_ids]
    count = bvh.count[leaf_ids]
    k = torch.arange(SLOTS, dtype=torch.int32, device=start.device)
    ti = torch.clamp(start[:, None] + k[None, :], 0,
                     max(tris.count - 1, 0)).long()
    valid = k[None, :] < count[:, None]
    return start, count, ti, valid


def pack_leaves(bvh: BVH, tris: Triangles) -> torch.Tensor:
    """(L, 128) f32 leaf rows: SLOTS triangles x 9 floats [p0 e1 e2],
    then the base triangle index and the count; empty slots are zero."""
    start, count, ti, valid = _leaf_slots(bvh, tris)
    n_leaf = start.shape[0]
    tri9 = torch.stack([
        tris.p0.x, tris.p0.y, tris.p0.z,
        tris.e1.x, tris.e1.y, tris.e1.z,
        tris.e2.x, tris.e2.y, tris.e2.z], dim=-1).float()
    g = torch.where(valid[..., None], tri9[ti], 0.0)   # (L, SLOTS, 9)
    return torch.cat([g.reshape(n_leaf, SLOTS * 9),
                      start.float()[:, None], count.float()[:, None]],
                     dim=1).contiguous()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with a single rounding, as a fused multiply-add.
    The sum is formed in f64 (the product is exact there) with its
    TwoSum error; a sum that lands on an f32 rounding midpoint is
    resolved by the error's sign, so the result is correctly rounded."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    rd = r.double()
    toward_s = torch.where(rd < s, float("inf"), float("-inf")).float()
    other = torch.nextafter(r, toward_s)
    mid = (other.double() + rd) * 0.5 == s
    return torch.where(mid & (err != 0) & ((err > 0) == (s > rd)), other, r)


def _cross_fused(a: V3, b: V3) -> V3:
    """a x b as XLA evaluates the JAX package's `jnp.cross` on the CPU:
    each component a1*b2 - a2*b1 contracted to fma(a1, b2, -(a2*b1)),
    so the constant-form tables equal the JAX package's bit for bit."""
    return V3(_fma(a.y, b.z, -(a.z * b.y)),
              _fma(a.z, b.x, -(a.x * b.z)),
              _fma(a.x, b.y, -(a.y * b.x)))


def pack_leaves16(bvh: BVH, tris: Triangles) -> torch.Tensor:
    """(2L, 128) f32 constant-form leaf rows: per slot the 16 constants
    [N e1 e2 P1 P2 c0] with N = e1 x e2, P1 = p0 x e1, P2 = p0 x e2,
    c0 = p0 . N, so that with G = o x d

        det = -(d . N),  t*det = o . N - c0,
        u*det = G . e2 + d . P2,  v*det = -(G . e1 + d . P1).

    Slots 0-7 fill row 2i; slots 8-13 take 96 lanes of row 2i+1, whose
    lanes 120/121 hold the base triangle index and the count.  Empty
    slots are zero, so det = 0 fails the |det| >= eps test."""
    start, count, ti, valid = _leaf_slots(bvh, tris)
    n_leaf = start.shape[0]
    p0, e1, e2 = tris.p0, tris.e1, tris.e2
    n = _cross_fused(e1, e2)
    p1 = _cross_fused(p0, e1)
    p2 = _cross_fused(p0, e2)
    c0 = p0.x * n.x + p0.y * n.y + p0.z * n.z
    tri16 = torch.stack([n.x, n.y, n.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z,
                         p1.x, p1.y, p1.z, p2.x, p2.y, p2.z, c0],
                        dim=-1).float()                # (T, 16)
    g = torch.where(valid[..., None], tri16[ti], 0.0)  # (L, SLOTS, 16)
    zeros = torch.zeros((n_leaf, 24), dtype=torch.float32,
                        device=g.device)
    row_a = g[:, :8].reshape(n_leaf, 128)
    row_b = torch.cat([g[:, 8:].reshape(n_leaf, 96), zeros,
                       start.float()[:, None], count.float()[:, None],
                       zeros[:, :6]], dim=1)
    return torch.stack([row_a, row_b], dim=1).reshape(2 * n_leaf,
                                                      128).contiguous()


def pack_tables(bvh: BVH, tris: Triangles, leaf16: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nodes (I, 16) f32, leaves f32): constant-form (2L, 128) leaves
    with leaf16 (any-hit's form), raw (L, 128) without (closest-hit's).
    Codes are f32 integers (exact: every index is below 2^24)."""
    if bvh.leaf_max > SLOTS:
        raise ValueError(
            f"BVH leaf_max {bvh.leaf_max} exceeds the kernel's {SLOTS} "
            f"slots per leaf row; rebuild with max_leaf <= {SLOTS}")
    right = bvh.right
    b = bvh.n_nodes
    is_int = right >= 0
    n_int = max((b - 1) // 2, 1)
    iid = torch.cumsum(is_int.int(), 0) - 1
    lid = torch.cumsum((~is_int).int(), 0) - 1
    int_ids = torch.nonzero(is_int)[:n_int, 0]
    if int_ids.numel() == 0:         # a single-leaf root: one dummy row
        int_ids = torch.zeros(1, dtype=torch.int64, device=right.device)
    leaves = pack_leaves16(bvh, tris) if leaf16 else pack_leaves(bvh, tris)

    left = torch.clamp(int_ids + 1, max=b - 1)
    rgt = right[int_ids].long()

    def code_of(orig):
        return torch.where(is_int[orig], iid[orig],
                           -(lid[orig] + 1)).float()

    lc = (bvh.lo[left] + bvh.hi[left]) * 0.5
    rc = (bvh.lo[rgt] + bvh.hi[rgt]) * 0.5
    axis = torch.argmax(torch.abs(rc - lc), dim=1)
    l_low = (torch.take_along_dim(lc, axis[:, None], 1)[:, 0]
             <= torch.take_along_dim(rc, axis[:, None], 1)[:, 0])
    ab = (axis | torch.where(l_low, 4, 0)).float()
    nodes = torch.cat([
        bvh.lo[left].float(), bvh.hi[left].float(),
        bvh.lo[rgt].float(), bvh.hi[rgt].float(),
        code_of(left)[:, None], code_of(rgt)[:, None], ab[:, None],
        torch.zeros((int_ids.shape[0], 1), dtype=torch.float32,
                    device=right.device)], dim=1)
    return nodes.contiguous(), leaves


def tables(bvh: BVH, tris: Triangles, leaf16: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pack_tables`, built once per (tree, triangles, leaf form) and
    kept in the tree's cache."""
    key = ("packet", leaf16, id(tris.p0.x))
    hit = bvh.cache.get(key)
    if hit is None or hit[0] is not tris.p0.x:
        hit = (tris.p0.x, pack_tables(bvh, tris, leaf16=leaf16))
        bvh.cache[key] = hit
    return hit[1]


def _init_code(bvh: BVH) -> int:
    """Root code: 0 (the first internal row), or -1 (leaf row 0) when the
    root is a leaf."""
    return 0 if int(bvh.right[0]) >= 0 else -1


def max_iters(bvh: BVH) -> int:
    return 4 * bvh.n_nodes + 64


def wide_ok(bvh: BVH) -> bool:
    """Stack bound of the 4-wide walk (not ported yet: the 4-wide fields
    stay None, so this is False for every tree the port builds)."""
    return (bvh.wsel is not None
            and 3 * ((bvh.depth + 1) // 2) + 1 <= MAX_STACK)


def usable(bvh: BVH) -> bool:
    """Dispatch guard: leaves hold at most SLOTS triangles and the tree
    fits the fixed traversal stack (depth 0 means unknown)."""
    return (bvh.leaf_max <= SLOTS and 0 < bvh.depth
            and (bvh.depth <= MAX_STACK or wide_ok(bvh)))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _leaf9(rows, ray, t_b, any_hit):
    """Raw-form MT of gathered leaf rows (k, 128) against their rays;
    -> (hit (k,), slot (k,), t, u, v) of the hit each ray records."""
    ox, oy, oz, dx, dy, dz = (c[:, None] for c in ray)
    s = rows[:, :SLOTS * 9].reshape(-1, SLOTS, 9)
    p0x, p0y, p0z = s[..., 0], s[..., 1], s[..., 2]
    e1x, e1y, e1z = s[..., 3], s[..., 4], s[..., 5]
    e2x, e2y, e2z = s[..., 6], s[..., 7], s[..., 8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(torch.abs(det) < DET_EPS, 0.0, 1.0 / det)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    cand = ((torch.abs(det) >= DET_EPS) & (uu >= 0.0) & (vv >= 0.0)
            & (uu + vv <= 1.0) & (tt > 0.0) & (tt < t_b[:, None]))
    if any_hit:
        # the first hit stops the ray (t_best goes negative)
        j = cand.int().argmax(dim=1, keepdim=True)
    else:
        # slots in order with a strict `t < t_best`: the nearest wins,
        # the first slot among equals
        j = torch.where(cand, tt, float("inf")).argmin(dim=1, keepdim=True)
    pick = lambda a: torch.take_along_dim(a, j, 1)[:, 0]  # noqa: E731
    return cand.any(dim=1), j[:, 0], pick(tt), pick(uu), pick(vv)


def _leaf16(rows, ray, g, t_b, any_hit):
    """Constant-form MT of gathered leaf row pairs (k, 2, 128); same
    return as _leaf9."""
    ox, oy, oz, dx, dy, dz = (c[:, None] for c in ray)
    gx, gy, gz = (c[:, None] for c in g)
    s = torch.cat([rows[:, 0].reshape(-1, 8, 16),
                   rows[:, 1, :96].reshape(-1, 6, 16)], dim=1)
    nx_, ny_, nz_ = s[..., 0], s[..., 1], s[..., 2]
    e1x, e1y, e1z = s[..., 3], s[..., 4], s[..., 5]
    e2x, e2y, e2z = s[..., 6], s[..., 7], s[..., 8]
    p1x, p1y, p1z = s[..., 9], s[..., 10], s[..., 11]
    p2x, p2y, p2z = s[..., 12], s[..., 13], s[..., 14]
    c0 = s[..., 15]
    det = -(dx * nx_ + dy * ny_ + dz * nz_)
    tp = ox * nx_ + oy * ny_ + oz * nz_ - c0
    up = (gx * e2x + gy * e2y + gz * e2z
          + dx * p2x + dy * p2y + dz * p2z)
    vp = -(gx * e1x + gy * e1y + gz * e1z
           + dx * p1x + dy * p1y + dz * p1z)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    ad = det * sgn
    su = up * sgn
    sv = vp * sgn
    st = tp * sgn
    pre = ((ad >= DET_EPS) & (su >= 0.0) & (sv >= 0.0) & (su + sv <= ad)
           & (st > 0.0))
    n = rows.shape[0]
    if any_hit:
        cand = pre & (st < t_b[:, None] * ad)
        return cand.any(dim=1), cand.int().argmax(dim=1), None, None, None
    # closest-hit: the bound moves with every hit (`st < t_b * ad` does
    # not order slots as their t would), so the slots go in order
    hit_any = torch.zeros(n, dtype=torch.bool, device=rows.device)
    j = torch.zeros(n, dtype=torch.int64, device=rows.device)
    t_o, u_o, v_o = t_b, torch.zeros_like(t_b), torch.zeros_like(t_b)
    for k in range(SLOTS):
        hit = pre[:, k] & (st[:, k] < t_o * ad[:, k])
        r = 1.0 / torch.where(hit, ad[:, k], 1.0)
        t_o = torch.where(hit, st[:, k] * r, t_o)
        u_o = torch.where(hit, su[:, k] * r, u_o)
        v_o = torch.where(hit, sv[:, k] * r, v_o)
        j = torch.where(hit, k, j)
        hit_any = hit_any | hit
    return hit_any, j, t_o, u_o, v_o


def _walk(nodes, leaves, o: V3, d: V3, t0, init_code: int, iters: int,
          any_hit: bool, leaf16: bool):
    """Lockstep walk of every ray over the packed tables, one node visit
    per ray per step -> raw (t, tri, u, v) as the kernel writes them."""
    n = o.x.shape[0]
    dev = o.x.device
    ray = (o.x, o.y, o.z, d.x, d.y, d.z)
    ix = 1.0 / torch.where(torch.abs(d.x) < 1e-20, 1e-20, d.x)
    iy = 1.0 / torch.where(torch.abs(d.y) < 1e-20, 1e-20, d.y)
    iz = 1.0 / torch.where(torch.abs(d.z) < 1e-20, 1e-20, d.z)
    oix, oiy, oiz = o.x * ix, o.y * iy, o.z * iz
    g = (o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z,
         o.x * d.y - o.y * d.x)
    t_b = t0.clone()
    tri_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_b = torch.zeros(n, dtype=torch.float32, device=dev)
    v_b = torch.zeros(n, dtype=torch.float32, device=dev)
    code = torch.full((n,), init_code, dtype=torch.int64, device=dev)
    te = torch.zeros(n, dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    have = torch.ones(n, dtype=torch.bool, device=dev)
    tstack = torch.zeros((n, MAX_STACK), dtype=torch.float32, device=dev)
    nstack = torch.zeros((n, MAX_STACK), dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    inf = torch.full((n,), INF, dtype=torch.float32, device=dev)

    def slab(rows, base, idx):
        t0x = rows[:, base + 0] * ix[idx] - oix[idx]
        t1x = rows[:, base + 3] * ix[idx] - oix[idx]
        t0y = rows[:, base + 1] * iy[idx] - oiy[idx]
        t1y = rows[:, base + 4] * iy[idx] - oiy[idx]
        t0z = rows[:, base + 2] * iz[idx] - oiz[idx]
        t1z = rows[:, base + 5] * iz[idx] - oiz[idx]
        tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                           torch.minimum(t0y, t1y)),
                             torch.minimum(t0z, t1z))
        tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                           torch.maximum(t0y, t1y)),
                             torch.maximum(t0z, t1z))
        te_c = torch.clamp(tmin, min=0.0)
        ok = (tmax >= te_c) & (te_c < t_b[idx])
        return torch.where(ok, te_c, INF)

    for _ in range(iters):
        live = have | (sp > 0)
        if not bool(live.any()):
            break
        # refill from the stack where the walk ran out of a subtree
        pop = live & ~have
        slot = torch.clamp(sp - 1, min=0)
        code = torch.where(pop, nstack[lanes, slot], code)
        te = torch.where(pop, tstack[lanes, slot], te)
        sp = torch.where(pop, slot, sp)
        m = live & (te < t_b)
        is_leaf = code < 0

        # ---- leaf: every slot of one leaf row ---------------------------
        idx = torch.nonzero(m & is_leaf)[:, 0]
        if idx.numel():
            row = -code[idx] - 1
            rr = tuple(c[idx] for c in ray)
            if leaf16:
                rows = leaves.view(-1, 2, 128)[row]
                hit, j, t_h, u_h, v_h = _leaf16(
                    rows, rr, tuple(c[idx] for c in g), t_b[idx], any_hit)
                base = rows[:, 1, LANE16_START].int()
            else:
                rows = leaves[row]
                hit, j, t_h, u_h, v_h = _leaf9(rows, rr, t_b[idx], any_hit)
                base = rows[:, LANE_START].int()
            hi = idx[hit]
            tri_b[hi] = (base + j.int())[hit]
            if any_hit:
                t_b[hi] = -1.0
            else:
                t_b[hi] = t_h[hit]
                u_b[hi] = u_h[hit]
                v_b[hi] = v_h[hit]

        # ---- internal: both children from one row, near child first -----
        tel, ter = inf.clone(), inf.clone()
        lcode = torch.zeros(n, dtype=torch.int64, device=dev)
        rcode = torch.zeros_like(lcode)
        ab = torch.zeros_like(lcode)
        idx = torch.nonzero(m & ~is_leaf)[:, 0]
        if idx.numel():
            rows = nodes[code[idx]]
            tel[idx] = slab(rows, 0, idx)
            ter[idx] = slab(rows, 6, idx)
            lcode[idx] = rows[:, 12].long()
            rcode[idx] = rows[:, 13].long()
            ab[idx] = rows[:, 14].long()
        axis = ab & 3
        l_low = (ab & 4) > 0
        d_pos = torch.where(axis == 0, d.x > 0.0,
                            torch.where(axis == 1, d.y > 0.0, d.z > 0.0))
        left_near = d_pos == l_low
        code_f = torch.where(left_near, lcode, rcode)
        code_s = torch.where(left_near, rcode, lcode)
        te_f = torch.where(left_near, tel, ter)
        te_s = torch.where(left_near, ter, tel)
        any_f = te_f < INF
        any_s = te_s < INF
        # fork: push the far child, follow the near one
        fork = any_f & any_s & (sp < MAX_STACK)
        push = torch.nonzero(fork)[:, 0]
        if push.numel():
            nstack[push, sp[push]] = code_s[push]
            tstack[push, sp[push]] = te_s[push]
        sp = sp + fork.long()
        have = any_f | any_s
        code = torch.where(any_f, code_f, code_s)
        te = torch.where(any_f, te_f, te_s)
        if any_hit:
            done = t_b < 0.0
            have = have & ~done
            sp = torch.where(done, 0, sp)
    return t_b, tri_b, u_b, v_b


def _seed(t_init: torch.Tensor, n: int) -> torch.Tensor:
    """Per-ray seeds clamped below the miss sentinel INF, so that a ray
    that misses a box (te = INF) fails `te < t_best` at once."""
    return torch.clamp(torch.broadcast_to(t_init, (n,)).float(),
                       max=SEED_CLAMP).contiguous()


def _finish(t, tri, u, v, t_init, n) -> Hit:
    # misses keep the caller's seed (the clamp is internal)
    t = torch.where(tri >= 0, t, torch.broadcast_to(t_init, (n,)).float())
    return Hit(t, tri, u, v)


def traverse_plain(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
                   any_hit: bool = False, leaf16: bool = None) -> Hit:
    """The plain torch version of `traverse_packet`, on any device."""
    if leaf16 is None:
        leaf16 = any_hit
    n = o.x.shape[0]
    nodes, leaves = tables(bvh, tris, leaf16)
    t, tri, u, v = _walk(nodes, leaves, o, d, _seed(t_init, n),
                         _init_code(bvh), max_iters(bvh), any_hit, leaf16)
    return _finish(t, tri, u, v, t_init, n)


def _library():
    global _lib
    if _lib is None:
        from .build import load_library
        lib = load_library("bvh_kernel")
        ptr = ctypes.c_void_p
        lib.bvh_traverse.argtypes = ([ptr, ptr] + [ptr] * 7 + [ptr] * 4
                                     + [ctypes.c_int] * 5 + [ptr])
        lib.bvh_traverse.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(nodes, leaves, leaf16: bool, arrays, n: int) -> None:
    if nodes.dim() != 2 or nodes.shape[1] != 16:
        raise ValueError(f"node rows must be (I, 16), got "
                         f"{tuple(nodes.shape)}")
    if leaves.dim() != 2 or leaves.shape[1] != 128 or (
            leaf16 and leaves.shape[0] % 2):
        raise ValueError(f"leaf rows must be ({'2L' if leaf16 else 'L'}, "
                         f"128), got {tuple(leaves.shape)}")
    for name, a in (("nodes", nodes), ("leaves", leaves)) + tuple(arrays):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(a)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if name not in ("nodes", "leaves") and a.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != nodes.device:
            raise ValueError(f"{name} is on {a.device}, tables on "
                             f"{nodes.device}")


def traverse_packet(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
                    any_hit: bool = False, leaf16: bool = None) -> Hit:
    """Traversal of the whole ray batch.  t_init seeds each ray's search
    radius: BIG_T for closest-hit, the segment length for any-hit
    (occluded iff a triangle id is recorded); a negative seed marks a
    dead lane, which never hits.  `leaf16` picks the constant-form leaf
    table (default for any-hit) over the raw one (default for
    closest-hit).  CUDA tensors launch the kernel; CPU tensors take
    `traverse_plain`."""
    if leaf16 is None:
        leaf16 = any_hit
    n = o.x.shape[0]
    nodes, leaves = tables(bvh, tris, leaf16)
    _check(nodes, leaves, leaf16,
           (("o.x", o.x), ("o.y", o.y), ("o.z", o.z), ("d.x", d.x),
            ("d.y", d.y), ("d.z", d.z), ("t_init", t_init)), n)
    dev = nodes.device
    if dev.type == "cpu":
        return traverse_plain(bvh, tris, o, d, t_init, any_hit, leaf16)
    if dev.type != "cuda":
        raise ValueError(f"no BVH kernel for device {dev}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return Hit(t, tri, u, v)
    t0 = _seed(t_init, n)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bvh_traverse(
            nodes.data_ptr(), leaves.data_ptr(),
            o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
            d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(), t0.data_ptr(),
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            n, _init_code(bvh), max_iters(bvh), int(any_hit), int(leaf16),
            stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse launch failed with CUDA error "
                           f"{err}")
    launches["any_hit" if any_hit else "closest_hit"] += 1
    return _finish(t, tri, u, v, t_init, n)


def closest_hit_packet(bvh: BVH, tris: Triangles, o: V3, d: V3) -> Hit:
    n = o.x.shape[0]
    # misses keep t = BIG_T and tri = -1, as intersect.Hit
    return traverse_packet(bvh, tris, o, d,
                           torch.full((n,), BIG_T, dtype=torch.float32,
                                      device=o.x.device))


def any_hit_packet(bvh: BVH, tris: Triangles, o: V3, d: V3, max_t
                   ) -> torch.Tensor:
    return traverse_packet(bvh, tris, o, d, max_t, any_hit=True).tri >= 0
