"""Ordered BVH traversal (closest-hit and any-hit), binary and 4-wide:
CUDA kernel wrappers, their packed tables and their plain torch
versions.

Counterpart of raytracingrenderer_tpu/ops/bvh_kernel.py, whose Pallas
kernels `_kernel` (binary) and `_kernel_wide` (4-wide), both launched by
`traverse_packet`, walk the tree once for a whole block of rays on the
TPU.  Here both walks are one kernel template in csrc/bvh_kernel.cu,
written for Hopper: one ray per thread at a time, each with its own
stack, persistent warps that take their next rays from a counter,
leaves tested after nodes, rows read 16 bytes a load (see the source's
header).
They compute what the TPU kernels compute, over the same tables:

- binary nodes (I, 16) f32, one row per internal node holding both
  children: `[llo lhi rlo rhi] lcode rcode axisbits 0`, codes as f32
  integers (an internal child is its row, a leaf child -(leaf_row + 1));
- wide nodes (W, 32) f32 (`pack_tables_wide`, from the `widen` collapse
  that the loader attaches to every tree): lanes 6k..6k+5 hold child
  k's `lo hi`, children sorted ascending along the row's axis (lane 28),
  their codes in lanes 24..27; an empty slot is a point at +3e38;
- leaves, raw (L, 128) f32 rows of 14 x [p0 e1 e2] + start + count for
  closest-hit (and for both variants of the wide walk), or
  constant-form (2L, 128) f32 row pairs of 14 x [N e1 e2 P1 P2 c0] with
  start/count at lanes 120/121 of the odd row for binary any-hit
  (`pack_leaves16`);
- per ray: `t_entry < t_best` re-pruning of every popped subtree, the
  near child first (the wide walk pushes every live child but the
  nearest, far to near, and follows the nearest), leaves of up to 14
  triangles tested densely, any-hit stopping at the first hit, a
  64-entry stack and an iteration cap of 4 * nodes + 64.

One departure, by design: the near child is chosen by the ray's own
direction sign on the node's split axis, not by the sign of the ray
block's summed direction, which only a packet walk needs.  Order
decides nothing but ties between equal t in different leaves.

`traverse_packet` launches a kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs `traverse_plain`, the plain torch
version (a lockstep loop over the batch with per-ray stacks, the same
child order and arithmetic), which is also the kernels' reference on
the card.  `launches` counts kernel launches per variant, `rays`
the rays handed to them;
`plain_visits` counts the node visits of the plain walks and the
triangle tests their leaf visits need (filled slots, for an any-hit ray
up to its first hit).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.vec import V3
from ..geometry.intersect import BIG_T, DET_EPS, Hit, on_live_lanes
from ..scene.types import BVH, Triangles
from .launch import I32, PTR, bind, launch, stream_of

MAX_STACK = 64          # >= tree depth
INF = 3.0e38            # box-miss sentinel, below BIG_T
SEED_CLAMP = 1e30       # seeds stay below INF so that pruning engages
SLOTS = 14              # triangles per leaf row: 14 * 9 = 126 lanes
LANE_START = 126        # raw leaf row lane of the base triangle index
LANE16_START = 120      # its lane in the odd constant-form row

# kernel launches since import (or the last reset), per variant
launches: Dict[str, int] = {"closest_hit": 0, "any_hit": 0,
                             "wide_closest_hit": 0, "wide_any_hit": 0}
# the rays of those launches (dead lanes included), by the same variants
rays: Dict[str, int] = dict.fromkeys(launches, 0)
# node visits of the plain walks since import (or the last reset): rows of
# internal nodes and of leaves; each walk runs in lockstep with its kernel,
# so on the same rays these are the kernel's visits too
plain_visits: Dict[str, int] = {"internal": 0, "leaf": 0, "slots": 0}
_lib = None
# (device index, stream handle) -> the kernels' ray counter there
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


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


def widen(bvh: BVH) -> BVH:
    """Attach the 4-wide collapse (wsel, wcode, waxis) to a binary BVH, as
    the JAX package's `widen` does at load time (host code, numpy).

    Each wide row is a binary internal node with its internal children
    absorbed: its children are the node's grandchildren (or its leaf
    children), at most 4.  Rows are numbered in preorder; a row's
    children are sorted (stable) by centroid along the axis of largest
    child-centroid spread.  Leaf codes are the leaf rows of `pack_leaves`
    (-(row + 1)).  A single-leaf root gets one all-empty dummy row."""
    right = bvh.right.cpu().numpy()
    lo = bvh.lo.cpu().numpy()
    hi = bvh.hi.cpu().numpy()
    b = right.shape[0]
    is_int = right >= 0
    lid = np.cumsum(~is_int) - 1           # leaf row per binary node
    if b == 0 or not is_int[0]:
        return bvh.replace_wide(np.full((1, 4), -1, np.int32),
                                np.zeros((1, 4), np.int32),
                                np.zeros(1, np.int32))
    # children of every internal node, in the JAX order (left's, then
    # right's), empty slots (-1) moved to the back
    ints = np.nonzero(is_int)[0]
    cols = []
    for c in (ints + 1, right[ints]):
        c_int = is_int[c]
        cols += [np.where(c_int, c + 1, c), np.where(c_int, right[c], -1)]
    kids = np.stack(cols, axis=1)                          # (I, 4)
    kids = np.take_along_axis(
        kids, np.argsort(kids < 0, axis=1, kind="stable"), axis=1)
    kids_of = dict(zip(ints.tolist(), kids.tolist()))

    # preorder DFS assigns wide rows
    order = []
    stack = [0]
    while stack:
        i = stack.pop()
        order.append(i)
        stack.extend(c for c in reversed(kids_of[i])
                     if c >= 0 and is_int[c])
    order = np.asarray(order)
    w = order.shape[0]
    wid = np.full(b, -1, np.int64)
    wid[order] = np.arange(w)

    cs = kids[np.searchsorted(ints, order)]                 # (W, 4)
    valid = cs >= 0
    sel = np.maximum(cs, 0)
    cen = (lo[sel] + hi[sel]) * 0.5                          # (W, 4, 3)
    spread = (np.where(valid[..., None], cen, -np.inf).max(1)
              - np.where(valid[..., None], cen, np.inf).min(1))
    axis = np.argmax(spread, axis=1)
    key = np.where(valid, np.take_along_axis(
        cen, axis[:, None, None], axis=2)[..., 0], np.inf)
    cs = np.take_along_axis(cs, np.argsort(key, axis=1, kind="stable"),
                            axis=1)
    valid = cs >= 0
    sel = np.maximum(cs, 0)
    wcode = np.where(valid, np.where(is_int[sel], wid[sel], -(lid[sel] + 1)),
                     0)
    return bvh.replace_wide(cs, wcode, axis)


def pack_tables_wide(bvh: BVH, tris: Triangles
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wide nodes (W, 32) f32, raw leaves (L, 128) f32).  Row layout:
    lanes 6k..6k+5 child k's [lo hi], lanes 24..27 the child codes (f32
    integers), lane 28 the sort axis.  An empty slot is a point at
    +3e38, not an inverted box: the slab test normalizes lo/hi with
    min/max, so an inverted box would test as always hit, while the far
    point gives slab t's that are of mixed sign (a miss) or all beyond
    every clamped seed (1e30)."""
    if bvh.wsel is None:
        raise ValueError("the BVH has no 4-wide fields: call widen() first")
    if bvh.leaf_max > SLOTS:
        raise ValueError(
            f"BVH leaf_max {bvh.leaf_max} exceeds the kernel's {SLOTS} "
            f"slots per leaf row; rebuild with max_leaf <= {SLOTS}")
    wsel = bvh.wsel.long()
    valid = (wsel >= 0)[..., None]
    sel = torch.clamp(wsel, min=0)
    clo = torch.where(valid, bvh.lo[sel], 3.0e38)            # (W, 4, 3)
    chi = torch.where(valid, bvh.hi[sel], 3.0e38)
    w = wsel.shape[0]
    nodes = torch.cat([
        torch.cat([clo, chi], dim=-1).reshape(w, 24).float(),
        bvh.wcode.float(), bvh.waxis.float()[:, None],
        torch.zeros((w, 3), dtype=torch.float32, device=wsel.device)],
        dim=1)
    return nodes.contiguous(), pack_leaves(bvh, tris)


def tables(bvh: BVH, tris: Triangles, leaf16: bool, wide: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pack_tables` (or `pack_tables_wide`), built once per (tree,
    triangles, leaf form) and kept in the tree's cache, keyed on every
    vertex component and the node bounds it was packed from."""
    key = ("wide",) if wide else ("packet", leaf16)
    return bvh.cached(key, geometry_deps(bvh, tris), lambda: (
        pack_tables_wide(bvh, tris) if wide
        else pack_tables(bvh, tris, leaf16=leaf16)))


def geometry_deps(bvh: BVH, tris: Triangles) -> Tuple[torch.Tensor, ...]:
    """The tensors a packed table is made from: the node bounds and the
    nine vertex components (p0, e1, e2)."""
    return (bvh.lo, bvh.hi, *tris.p0, *tris.e1, *tris.e2)


def _init_code(bvh: BVH) -> int:
    """Root code: 0 (the first internal row), or -1 (leaf row 0) when the
    root is a leaf.  Read from the device once a tree and kept in its
    cache: reading it is a synchronisation, which a launch must not pay."""
    code = bvh.cache.get("init_code")
    if code is None:
        code = bvh.cache["init_code"] = 0 if int(bvh.right[0]) >= 0 else -1
    return code


def max_iters(bvh: BVH) -> int:
    return 4 * bvh.n_nodes + 64


def wide_ok(bvh: BVH) -> bool:
    """The 4-wide walk's stack bound: a visit pushes at most 3 entries, so
    the stack holds at most 3 * wide depth + 1."""
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


def _slots_needed(count, hit, j, any_hit: bool) -> int:
    """Triangle tests the leaf visits of one step need: the slots each
    row holds (`count`), for an any-hit ray only up to its first hit."""
    if any_hit:
        count = torch.where(hit, j + 1, count.long())
    return int(count.sum())


def _inv_dir(o: V3, d: V3):
    """(ix, iy, iz, o.x*ix, o.y*iy, o.z*iz) of the slab test, with
    1/where(|d| < 1e-20, 1e-20, d) as the kernels compute it."""
    ix = 1.0 / torch.where(torch.abs(d.x) < 1e-20, 1e-20, d.x)
    iy = 1.0 / torch.where(torch.abs(d.y) < 1e-20, 1e-20, d.y)
    iz = 1.0 / torch.where(torch.abs(d.z) < 1e-20, 1e-20, d.z)
    return ix, iy, iz, o.x * ix, o.y * iy, o.z * iz


def _slab(rows, base, inv, t_b):
    """Entry t of the child boxes [lo hi] at lanes base..base+5 of
    gathered node rows against their rays (`inv` and t_b gathered
    alike), INF where missed or not before t_b."""
    ix, iy, iz, oix, oiy, oiz = inv
    t0x = rows[:, base + 0] * ix - oix
    t1x = rows[:, base + 3] * ix - oix
    t0y = rows[:, base + 1] * iy - oiy
    t1y = rows[:, base + 4] * iy - oiy
    t0z = rows[:, base + 2] * iz - oiz
    t1z = rows[:, base + 5] * iz - oiz
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    te_c = torch.clamp(tmin, min=0.0)
    return torch.where((tmax >= te_c) & (te_c < t_b), te_c, INF)


class _State:
    """Per-ray walk state of the lockstep plain walks: best hit, current
    (code, t_entry), stack of (code, t_entry) and its pointer."""

    def __init__(self, t0, init_code: int):
        n = t0.shape[0]
        dev = t0.device
        self.t_b = t0.clone()
        self.tri_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.u_b = torch.zeros(n, dtype=torch.float32, device=dev)
        self.v_b = torch.zeros(n, dtype=torch.float32, device=dev)
        self.code = torch.full((n,), init_code, dtype=torch.int64,
                               device=dev)
        self.te = torch.zeros(n, dtype=torch.float32, device=dev)
        self.sp = torch.zeros(n, dtype=torch.int64, device=dev)
        self.have = torch.ones(n, dtype=torch.bool, device=dev)
        self.tstack = torch.zeros((n, MAX_STACK), dtype=torch.float32,
                                  device=dev)
        self.nstack = torch.zeros((n, MAX_STACK), dtype=torch.int64,
                                  device=dev)
        self.lanes = torch.arange(n, device=dev)

    def pop(self):
        """Refill from the stack where the walk ran out of a subtree ->
        (live, m): lanes still walking, and those whose current entry
        survives `t_entry < t_best`; None when every lane is done."""
        live = self.have | (self.sp > 0)
        if not bool(live.any()):
            return None
        pop = live & ~self.have
        slot = torch.clamp(self.sp - 1, min=0)
        self.code = torch.where(pop, self.nstack[self.lanes, slot],
                                self.code)
        self.te = torch.where(pop, self.tstack[self.lanes, slot], self.te)
        self.sp = torch.where(pop, slot, self.sp)
        return live & (self.te < self.t_b)

    def push(self, where, code, te):
        """Push (code, te) on the lanes `where` (bounded by the stack)."""
        where = where & (self.sp < MAX_STACK)
        idx = torch.nonzero(where)[:, 0]
        if idx.numel():
            self.nstack[idx, self.sp[idx]] = code[idx]
            self.tstack[idx, self.sp[idx]] = te[idx]
        self.sp = self.sp + where.long()

    def record(self, idx, hit, base, j, t_h, u_h, v_h, any_hit: bool):
        """Keep the leaf test's hits of the rays idx."""
        hi = idx[hit]
        self.tri_b[hi] = (base + j.int())[hit]
        if any_hit:
            self.t_b[hi] = -1.0
        else:
            self.t_b[hi] = t_h[hit]
            self.u_b[hi] = u_h[hit]
            self.v_b[hi] = v_h[hit]

    def finish_visit(self, any_hit: bool):
        if any_hit:   # an occluded ray is done
            done = self.t_b < 0.0
            self.have = self.have & ~done
            self.sp = torch.where(done, 0, self.sp)

    def out(self):
        return self.t_b, self.tri_b, self.u_b, self.v_b


def _d_pos(d: V3, axis):
    """The ray's direction sign on each lane's axis (0, 1, 2)."""
    return torch.where(axis == 0, d.x > 0.0,
                       torch.where(axis == 1, d.y > 0.0, d.z > 0.0))


def _walk(nodes, leaves, o: V3, d: V3, t0, init_code: int, iters: int,
          any_hit: bool, leaf16: bool):
    """Lockstep walk of every ray over the packed binary tables, one node
    visit per ray per step -> raw (t, tri, u, v) as the kernel writes
    them."""
    n = o.x.shape[0]
    dev = o.x.device
    ray = (o.x, o.y, o.z, d.x, d.y, d.z)
    inv = _inv_dir(o, d)
    g = (o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z,
         o.x * d.y - o.y * d.x)
    st = _State(t0, init_code)
    inf = torch.full((n,), INF, dtype=torch.float32, device=dev)

    for _ in range(iters):
        m = st.pop()
        if m is None:
            break
        code, t_b = st.code, st.t_b
        is_leaf = code < 0

        # ---- leaf: every slot of one leaf row ---------------------------
        idx = torch.nonzero(m & is_leaf)[:, 0]
        plain_visits["leaf"] += idx.numel()
        if idx.numel():
            row = -code[idx] - 1
            rr = tuple(c[idx] for c in ray)
            if leaf16:
                rows = leaves.view(-1, 2, 128)[row]
                hit, j, t_h, u_h, v_h = _leaf16(
                    rows, rr, tuple(c[idx] for c in g), t_b[idx], any_hit)
                base = rows[:, 1, LANE16_START].int()
                count = rows[:, 1, LANE16_START + 1]
            else:
                rows = leaves[row]
                hit, j, t_h, u_h, v_h = _leaf9(rows, rr, t_b[idx], any_hit)
                base = rows[:, LANE_START].int()
                count = rows[:, LANE_START + 1]
            plain_visits["slots"] += _slots_needed(count, hit, j, any_hit)
            st.record(idx, hit, base, j, t_h, u_h, v_h, any_hit)

        # ---- internal: both children from one row, near child first -----
        tel, ter = inf.clone(), inf.clone()
        lcode = torch.zeros(n, dtype=torch.int64, device=dev)
        rcode = torch.zeros_like(lcode)
        ab = torch.zeros_like(lcode)
        idx = torch.nonzero(m & ~is_leaf)[:, 0]
        plain_visits["internal"] += idx.numel()
        if idx.numel():
            rows = nodes[code[idx]]
            inv_i = tuple(c[idx] for c in inv)
            tel[idx] = _slab(rows, 0, inv_i, t_b[idx])
            ter[idx] = _slab(rows, 6, inv_i, t_b[idx])
            lcode[idx] = rows[:, 12].long()
            rcode[idx] = rows[:, 13].long()
            ab[idx] = rows[:, 14].long()
        l_low = (ab & 4) > 0
        left_near = _d_pos(d, ab & 3) == l_low
        code_f = torch.where(left_near, lcode, rcode)
        code_s = torch.where(left_near, rcode, lcode)
        te_f = torch.where(left_near, tel, ter)
        te_s = torch.where(left_near, ter, tel)
        any_f = te_f < INF
        any_s = te_s < INF
        # fork: push the far child, follow the near one
        st.push(any_f & any_s, code_s, te_s)
        st.have = any_f | any_s
        st.code = torch.where(any_f, code_f, code_s)
        st.te = torch.where(any_f, te_f, te_s)
        st.finish_visit(any_hit)
    return st.out()


def _walk_wide(nodes, leaves, o: V3, d: V3, t0, init_code: int, iters: int,
               any_hit: bool):
    """The 4-wide lockstep walk (the TPU's `_kernel_wide`, per ray): one
    visit slab-tests up to 4 children; they are taken far to near along
    the row's axis by the ray's direction sign, every live child but the
    last is pushed and the last (the nearest) followed.  Raw leaves."""
    n = o.x.shape[0]
    dev = o.x.device
    ray = (o.x, o.y, o.z, d.x, d.y, d.z)
    inv = _inv_dir(o, d)
    st = _State(t0, init_code)
    inf = torch.full((n,), INF, dtype=torch.float32, device=dev)

    for _ in range(iters):
        m = st.pop()
        if m is None:
            break
        code, t_b = st.code, st.t_b
        is_leaf = code < 0

        idx = torch.nonzero(m & is_leaf)[:, 0]
        plain_visits["leaf"] += idx.numel()
        if idx.numel():
            rows = leaves[-code[idx] - 1]
            hit, j, t_h, u_h, v_h = _leaf9(
                rows, tuple(c[idx] for c in ray), t_b[idx], any_hit)
            st.record(idx, hit, rows[:, LANE_START].int(), j, t_h, u_h, v_h,
                      any_hit)
            plain_visits["slots"] += _slots_needed(
                rows[:, LANE_START + 1], hit, j, any_hit)

        tes = [inf.clone() for _ in range(4)]
        cds = [torch.zeros(n, dtype=torch.int64, device=dev)
               for _ in range(4)]
        axis = torch.zeros(n, dtype=torch.int64, device=dev)
        idx = torch.nonzero(m & ~is_leaf)[:, 0]
        plain_visits["internal"] += idx.numel()
        if idx.numel():
            rows = nodes[code[idx]]
            inv_i = tuple(c[idx] for c in inv)
            for k in range(4):
                tes[k][idx] = _slab(rows, 6 * k, inv_i, t_b[idx])
                cds[k][idx] = rows[:, 24 + k].long()
            axis[idx] = rows[:, 28].long()
        d_pos = _d_pos(d, axis)
        have = torch.zeros(n, dtype=torch.bool, device=dev)
        code_n = torch.zeros(n, dtype=torch.int64, device=dev)
        te_n = inf
        for j in range(4):
            te_k = torch.where(d_pos, tes[3 - j], tes[j])
            code_k = torch.where(d_pos, cds[3 - j], cds[j])
            alive = te_k < INF
            st.push(alive & have, code_n, te_n)
            code_n = torch.where(alive, code_k, code_n)
            te_n = torch.where(alive, te_k, te_n)
            have = have | alive
        st.have, st.code, st.te = have, code_n, te_n
        st.finish_visit(any_hit)
    return st.out()


def _seed(t_init: torch.Tensor, n: int) -> torch.Tensor:
    """Per-ray seeds clamped below the miss sentinel INF, so that a ray
    that misses a box (te = INF) fails `te < t_best` at once."""
    return torch.clamp(torch.broadcast_to(t_init, (n,)).float(),
                       max=SEED_CLAMP).contiguous()


def _finish(t, tri, u, v, t_init, n) -> Hit:
    # misses keep the caller's seed (the clamp is internal)
    t = torch.where(tri >= 0, t, torch.broadcast_to(t_init, (n,)).float())
    return Hit(t, tri, u, v)


def _variant(bvh: BVH, any_hit: bool, leaf16, wide) -> Tuple[bool, bool]:
    """(wide, leaf16) of a call.  wide=None keeps the JAX package's rule:
    the 4-wide walk only for trees too deep for the binary stack that
    still fit the wide one (no tree passes both: `wide_ok` needs depth
    <= 42), so the binary walk is the default and wide=True reaches the
    4-wide one.  The wide walk always reads raw leaves."""
    if wide is None:
        wide = bvh.depth > MAX_STACK and wide_ok(bvh)
    if wide:
        if not wide_ok(bvh):
            raise ValueError(
                "the 4-wide walk needs the BVH's wide fields (widen()) and "
                f"3 * ceil(depth / 2) + 1 <= {MAX_STACK} (depth "
                f"{bvh.depth})")
        return True, False
    return False, any_hit if leaf16 is None else leaf16


def traverse_plain(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
                   any_hit: bool = False, leaf16: bool = None,
                   wide: bool = None) -> Hit:
    """The plain torch version of `traverse_packet`, on any device."""
    wide, leaf16 = _variant(bvh, any_hit, leaf16, wide)
    n = o.x.shape[0]
    nodes, leaves = tables(bvh, tris, leaf16, wide)
    args = (nodes, leaves, o, d, _seed(t_init, n), _init_code(bvh),
            max_iters(bvh), any_hit)
    t, tri, u, v = _walk_wide(*args) if wide else _walk(*args, leaf16)
    return _finish(t, tri, u, v, t_init, n)


# (tables, rays and seeds, outputs, n / init_code / max_iters / any_hit,
# then the ray counter); the binary walk adds leaf16 before the counter
SIGNATURES = {
    "bvh_traverse": [PTR] * 2 + [PTR] * 7 + [PTR] * 4 + [I32] * 5 + [PTR],
    "bvh_traverse_wide": [PTR] * 2 + [PTR] * 7 + [PTR] * 4 + [I32] * 4
    + [PTR]}


def _library():
    """csrc/bvh_kernel.cu's launchers, bound once."""
    global _lib
    if _lib is None:
        _lib = bind("bvh_kernel", SIGNATURES)
    return _lib


def _check(nodes, leaves, leaf16: bool, wide: bool, arrays, n: int) -> None:
    width = 32 if wide else 16
    if nodes.dim() != 2 or nodes.shape[1] != width:
        raise ValueError(f"node rows must be ({'W' if wide else 'I'}, "
                         f"{width}), got {tuple(nodes.shape)}")
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
    for name, a in (("nodes", nodes), ("leaves", leaves)):
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (its rows are "
                             f"read as float4)")


def _counter(dev: torch.device) -> torch.Tensor:
    """The kernels' scratch on the current stream of `dev`: one
    int32, the next ray a persistent warp takes, which the launcher
    zeroes on the stream before the kernel.  Kept, so that a launch
    allocates nothing; one per stream, because launches on two streams
    can run at the same time."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, stream_of(index))
    counter = _counters.get(key)
    if counter is None:
        counter = _counters[key] = torch.zeros(1, dtype=torch.int32,
                                               device=dev)
    return counter


def traverse_packet(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
                    any_hit: bool = False, leaf16: bool = None,
                    wide: bool = None) -> Hit:
    """Traversal of the whole ray batch.  t_init seeds each ray's search
    radius: BIG_T for closest-hit, the segment length for any-hit
    (occluded iff a triangle id is recorded); a negative seed marks a
    dead lane, which never hits.  `leaf16` picks the constant-form leaf
    table (default for any-hit) over the raw one (default for
    closest-hit); `wide` the 4-wide walk (see `_variant`).  CUDA tensors
    launch a kernel; CPU tensors take `traverse_plain`."""
    wide, leaf16 = _variant(bvh, any_hit, leaf16, wide)
    n = o.x.shape[0]
    nodes, leaves = tables(bvh, tris, leaf16, wide)
    _check(nodes, leaves, leaf16, wide,
           (("o.x", o.x), ("o.y", o.y), ("o.z", o.z), ("d.x", d.x),
            ("d.y", d.y), ("d.z", d.z), ("t_init", t_init)), n)
    dev = nodes.device
    if dev.type == "cpu":
        return on_live_lanes(
            lambda so, sd, st: traverse_plain(bvh, tris, so, sd, st, any_hit,
                                              leaf16, wide),
            o, d, torch.broadcast_to(t_init, (n,)))
    if dev.type != "cuda":
        raise ValueError(f"no BVH kernel for device {dev}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return Hit(t, tri, u, v)
    t0 = _seed(t_init, n)
    ptrs = (nodes.data_ptr(), leaves.data_ptr(),
            o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
            d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(), t0.data_ptr(),
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            n, _init_code(bvh), max_iters(bvh), int(any_hit))
    name = ("wide_" if wide else "") + ("any_hit" if any_hit
                                         else "closest_hit")
    counter = _counter(dev).data_ptr()
    if wide:
        launch(_library()["bvh_traverse_wide"], dev, *ptrs, counter)
    else:
        launch(_library()["bvh_traverse"], dev, *ptrs, int(leaf16), counter)
    launches[name] += 1
    rays[name] += n
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
