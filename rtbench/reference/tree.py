"""The reference's tree: an object-median bounding-volume hierarchy over
the triangles and a batched stack walk in plain torch, for
configurations too large for every ray against every triangle.

It returns what `pt.geometry.intersect.brute_force` returns, bit for
bit: the same Moller-Trumbore (`intersect.mt`) on the same (ray,
triangle) pairs, and the same rule, the nearest hit with t below the
lane's t_init, the lower triangle id at exactly equal t.  The tree only
decides which pairs are tested, and it leaves out a pair only when no
hit in it could win:

  - the topology (an object-median split on the longest axis of the
    centroids' box, leaves of at most LEAF triangles; not the
    renderer's binned SAH) is built once per triangle count, from the
    triangles it first sees; which triangles share a leaf changes only
    how many pairs are tested;
  - the node boxes are made again from the current triangles at every
    call (so an SGD step that moves tri_p0 needs no refit here), in
    float64 and padded by PAD of the scene's extent, far more than
    float32's rounding of a hit;
  - a box is pruned only when its entry t is strictly greater than the
    lane's running best (a triangle at exactly that t with a lower id
    may lie in it), and hits are compared by (t, id).

Any-hit stops a lane at its first hit (`occluded` reads tri >= 0 only).
Only the live lanes (t_init > 0) are walked.  `installed()` puts the
walk in place of `intersect._walk` for a block.  numpy and torch only.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import numpy as np
import torch

from .pt.core.vec import V3
from .pt.geometry import intersect

LEAF = 8                  # triangles a leaf, at most
PAD = 2.0 ** -14          # the boxes' padding, of the scene's extent
I32_MAX = 2 ** 31 - 1
FLUSH = 4                 # walk steps between two tests of the leaves met


class Tree(NamedTuple):
    """Nodes in breadth-first order, the root 0.  An inner node has
    children left, right (> it); a leaf has left = -1 and its triangles
    in `tris` (its row, -1 past its count).  The walk steps two levels
    at a time: `kids` holds, for an inner node, each child that is a leaf
    and the two children of each child that is not (-1 pads)."""
    left: torch.Tensor        # (B,) int64, -1 at a leaf
    right: torch.Tensor       # (B,) int64
    leaf_row: torch.Tensor    # (B,) int64 row of `tris`, -1 at an inner node
    tris: torch.Tensor        # (n_leaves, LEAF) int64 triangle ids, -1 pad
    tri_leaf: torch.Tensor    # (T,) int64 node of each triangle's leaf
    kids: torch.Tensor        # (B, 4) an inner node's children's children
    levels: tuple             # inner nodes by depth, deepest first
    depth: int                # nodes on the longest root-to-leaf path


def build(centroids: np.ndarray, device) -> Tree:
    """The topology over triangles with these centroids (T, 3): each node
    of more than LEAF triangles is split at the median of its centroids
    along the longest axis of their box (ties in file order)."""
    t = len(centroids)
    perm = np.arange(t)
    seg_s, seg_e = np.array([0]), np.array([t])
    seg_node = np.array([0])
    n_nodes = 1
    left, right, leaf_of = [-1], [-1], {}
    level_nodes = []
    while len(seg_s):
        split = seg_e - seg_s > LEAF
        for n, s, e in zip(seg_node[~split], seg_s[~split], seg_e[~split]):
            leaf_of[int(n)] = perm[s:e]
        if not split.any():
            break
        s, e, node = seg_s[split], seg_e[split], seg_node[split]
        level_nodes.append(node)
        # each split segment sorted along the longest axis of its
        # centroids' box (stable: ties keep their order), the rest kept
        sizes = e - s
        inside = np.repeat(np.arange(len(s)), sizes)
        at = np.concatenate([np.arange(a, b) for a, b in zip(s, e)])
        cs = centroids[perm[at]]
        first = np.r_[0, np.cumsum(sizes)[:-1]]
        lo = np.minimum.reduceat(cs, first, axis=0)
        hi = np.maximum.reduceat(cs, first, axis=0)
        axis = np.argmax(hi - lo, axis=1)
        group = np.arange(t)
        group[at] = s[inside]
        key = np.zeros(t)
        key[at] = cs[np.arange(len(at)), axis[inside]]
        order = np.lexsort((key, group))
        perm = perm[order]
        mid = s + (e - s) // 2
        kids = n_nodes + 2 * np.arange(len(s))
        left.extend([-1] * (2 * len(s)))
        right.extend([-1] * (2 * len(s)))
        for n, k in zip(node, kids):
            left[n], right[n] = int(k), int(k + 1)
        n_nodes += 2 * len(s)
        seg_s = np.stack([s, mid], 1).ravel()
        seg_e = np.stack([mid, e], 1).ravel()
        seg_node = np.stack([kids, kids + 1], 1).ravel()
    left = np.asarray(left)
    right = np.asarray(right)
    kids = np.full((n_nodes, 4), -1)
    inner = np.nonzero(left >= 0)[0]
    for k, child in enumerate((left[inner], right[inner])):
        leaf = left[child] < 0
        kids[inner, 2 * k] = np.where(leaf, child, left[child])
        kids[inner, 2 * k + 1] = np.where(leaf, -1, right[child])
    leaf_nodes = sorted(leaf_of)
    leaf_row = np.full(n_nodes, -1)
    tris = np.full((len(leaf_nodes), LEAF), -1)
    tri_leaf = np.zeros(t, np.int64)
    for row, n in enumerate(leaf_nodes):
        ids = leaf_of[n]
        leaf_row[n] = row
        tris[row, :len(ids)] = ids
        tri_leaf[ids] = n

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    return Tree(left=dev(left), right=dev(right), leaf_row=dev(leaf_row),
                tris=dev(tris), tri_leaf=dev(tri_leaf), kids=dev(kids),
                levels=tuple(dev(n) for n in reversed(level_nodes)),
                depth=len(level_nodes) + 1)


def centroids(tris) -> np.ndarray:
    """(T, 3) float64 centroids of the triangles (p0, p0 + e1, p0 + e2)."""
    p0 = np.stack([c.detach().cpu().double().numpy() for c in tris.p0], 1)
    e1 = np.stack([c.detach().cpu().double().numpy() for c in tris.e1], 1)
    e2 = np.stack([c.detach().cpu().double().numpy() for c in tris.e2], 1)
    return p0 + (e1 + e2) / 3.0


def boxes(tree: Tree, tris):
    """(lo, hi), (B, 3) float64: every node's box of the current
    triangles' vertices, padded by PAD of the scene's extent."""
    p0 = torch.stack([c.detach().double() for c in tris.p0], 1)
    p1 = p0 + torch.stack([c.detach().double() for c in tris.e1], 1)
    p2 = p0 + torch.stack([c.detach().double() for c in tris.e2], 1)
    tlo = torch.minimum(torch.minimum(p0, p1), p2)
    thi = torch.maximum(torch.maximum(p0, p1), p2)
    b = tree.left.shape[0]
    idx = tree.tri_leaf[:, None].expand(-1, 3)
    lo = torch.full((b, 3), float("inf"), dtype=torch.float64,
                    device=p0.device).scatter_reduce(0, idx, tlo, "amin")
    hi = torch.full((b, 3), float("-inf"), dtype=torch.float64,
                    device=p0.device).scatter_reduce(0, idx, thi, "amax")
    for nodes in tree.levels:
        lo[nodes] = torch.minimum(lo[tree.left[nodes]], lo[tree.right[nodes]])
        hi[nodes] = torch.maximum(hi[tree.left[nodes]], hi[tree.right[nodes]])
    pad = PAD * float((hi[0] - lo[0]).max().clamp_min(1.0))
    return lo - pad, hi + pad


def _slab(lo, hi, o, inv):
    """Entry and exit t of rays (o, 1/d: (..., 3) float64) through boxes
    (..., 3); a NaN of 0 * inf (a ray in a slab's plane) is ignored."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    entry = torch.fmin(t0, t1).amax(-1)
    exit_ = torch.fmax(t0, t1).amin(-1)
    return entry, exit_


def _test_pairs(tree: Tree, tris, lanes, leaves, ol: V3, dl: V3, state,
                any_hit: bool):
    """Every triangle of leaf `leaves[i]` against the ray of lane
    `lanes[i]` (pairs (P,)); each lane keeps its best hit by (t, id)."""
    t0, bt, bid, bu, bv, sp = state
    ids = tree.tris[tree.leaf_row[leaves]]                  # (P, LEAF)
    safe = ids.clamp_min(0)
    ob = V3(*(c[lanes][:, None] for c in ol))
    db = V3(*(c[lanes][:, None] for c in dl))
    t, u, v, hit = intersect.mt(tris.p0.gather(safe), tris.e1.gather(safe),
                                tris.e2.gather(safe), ob, db)
    bl, il = bt[lanes][:, None], bid[lanes][:, None]
    win = (hit & (ids >= 0) & (t < t0[lanes][:, None])
           & ((t < bl) | ((t == bl) & (ids < il))))
    # a pair's best, then a lane's best over its pairs
    tw = torch.where(win, t, float("inf"))
    tp = tw.amin(1, keepdim=True)
    j = torch.where(win & (tw == tp), ids, I32_MAX).argmin(1, keepdim=True)
    got = win.any(1)
    g = lanes[got]
    tg = tp[got, 0]
    idg = torch.take_along_dim(ids, j, 1)[got, 0]
    t_lane = torch.full_like(bt, float("inf")).scatter_reduce(
        0, g, tg, "amin")
    near = tg == t_lane[g]
    id_lane = torch.full_like(bid, I32_MAX).scatter_reduce(
        0, g[near], idg[near], "amin")
    won = near & (idg == id_lane[g])
    w = g[won]
    bt[w] = tg[won]
    bid[w] = idg[won]
    bu[w] = torch.take_along_dim(u, j, 1)[got, 0][won]
    bv[w] = torch.take_along_dim(v, j, 1)[got, 0][won]
    if any_hit:
        sp[w] = 0


def walk(tree: Tree, tris, o: V3, d: V3, t_init: torch.Tensor,
         any_hit: bool) -> intersect.Hit:
    """brute_force's Hit (t_init and tri -1 where nothing hits below it)
    by a stack walk of the tree over the live lanes.  Each step pops one
    inner node a lane (skipped where its entry t has passed the lane's
    best since it was pushed) and tests the boxes of its `kids`: the
    inner ones hit are pushed with their entry t, the nearest last; the
    leaves hit join a list of (lane, leaf) pairs whose triangles are
    tested every FLUSH steps and at the end (a best found later prunes
    less, never wrongly)."""
    n = o.x.shape[0]
    dev = o.x.device
    best_t = t_init.to(torch.float32).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    live = torch.nonzero(best_t > 0.0)[:, 0]
    if live.numel() == 0 or tris.count == 0:
        return intersect.Hit(best_t, best_tri, best_u, best_v)
    lo, hi = boxes(tree, tris)
    # the live lanes' rays, in the walk's own numbering
    ol = V3(*(c[live] for c in o))
    dl = V3(*(c[live] for c in d))
    o64 = torch.stack([c.double() for c in ol], 1)
    inv = 1.0 / torch.stack([c.double() for c in dl], 1)
    t0 = best_t[live]
    m = live.numel()
    bt = t0.clone()
    bid = torch.full((m,), I32_MAX, dtype=torch.int64, device=dev)
    bu = torch.zeros_like(t0)
    bv = torch.zeros_like(t0)
    sp = torch.zeros(m, dtype=torch.int64, device=dev)
    state = (t0, bt, bid, bu, bv, sp)
    act = torch.arange(m, device=dev)
    if int(tree.left[0]) < 0:                  # the root is a leaf
        _test_pairs(tree, tris, act, torch.zeros_like(act), ol, dl, state,
                    any_hit)
        act = act[:0]
    size = 3 * ((tree.depth + 1) // 2) + 5
    stack = torch.zeros((m, size), dtype=torch.int64, device=dev)
    entry = torch.zeros((m, size), dtype=torch.float64, device=dev)
    en, ex = _slab(lo[0], hi[0], o64, inv)
    sp[act] = ((en <= ex) & (ex >= 0.0) & (en <= bt.double()))[act].long()
    entry[:, 0] = en
    act = act[sp[act] > 0]
    slots = torch.arange(4, device=dev)
    pairs, steps = [], 0
    while act.numel():
        top = sp[act] - 1
        node = stack[act, top]
        bi = bt[act].double()[:, None]
        keep = (entry[act, top] <= bi[:, 0])[:, None]
        ch = tree.kids[node]                                    # (K, 4)
        cs = ch.clamp_min(0)
        en, ex = _slab(lo[cs], hi[cs], o64[act][:, None], inv[act][:, None])
        hit = keep & (ch >= 0) & (en <= ex) & (ex >= 0.0) & (en <= bi)
        leaf = tree.left[cs] < 0
        # the inner kids hit, the farthest first: the nearest is popped next
        inner = hit & ~leaf
        order = torch.where(inner, -en, float("inf")).argsort(1)
        pos = top[:, None] + slots
        stack[act[:, None], pos] = torch.take_along_dim(ch, order, 1)
        entry[act[:, None], pos] = torch.take_along_dim(en, order, 1)
        sp[act] = top + inner.sum(1)
        lanes, k = torch.nonzero(hit & leaf, as_tuple=True)
        pairs.append((act[lanes], ch[lanes, k]))
        steps += 1
        if steps % FLUSH == 0:
            _test_pairs(tree, tris, *map(torch.cat, zip(*pairs)), ol, dl,
                        state, any_hit)
            pairs = []
        act = act[sp[act] > 0]
        if not act.numel() and pairs:
            _test_pairs(tree, tris, *map(torch.cat, zip(*pairs)), ol, dl,
                        state, any_hit)
            pairs = []
            act = act[sp[act] > 0]
    found = bid < I32_MAX
    best_t[live] = bt
    best_tri[live] = torch.where(found, bid, -1).to(torch.int32)
    best_u[live] = bu
    best_v[live] = bv
    return intersect.Hit(best_t, best_tri, best_u, best_v)


class _Walker:
    """intersect._walk's signature over trees kept by triangle count and
    device (any topology gives brute_force's answer; one built from the
    scene's own triangles prunes best)."""

    def __init__(self):
        self.trees: Dict[tuple, Tree] = {}

    def tree(self, tris) -> Tree:
        key = (tris.count, str(tris.p0.x.device))
        if key not in self.trees:
            self.trees[key] = build(centroids(tris), tris.p0.x.device)
        return self.trees[key]

    def __call__(self, scene, o: V3, d: V3, t_init: torch.Tensor,
                 any_hit: bool) -> intersect.Hit:
        tris = scene.triangles
        return walk(self.tree(tris), tris, o, d, t_init, any_hit)


@contextlib.contextmanager
def installed():
    """The tree walk in place of intersect._walk inside the block; the
    original back on exit, also after an exception."""
    was = intersect._walk
    intersect._walk = _Walker()
    try:
        yield intersect._walk
    finally:
        intersect._walk = was
