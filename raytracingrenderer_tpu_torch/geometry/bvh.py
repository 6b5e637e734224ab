"""Host-side binned-SAH BVH build -> flat arrays (numpy).

Counterpart of raytracingrenderer_tpu/geometry/bvh.py, the builder the
JAX package keeps as its oracle: the same numpy arithmetic in float64,
so the two emit identical trees.  The build is per scene, not per
frame; the loader calls the native C++ builder (geometry/bvh_native.py)
behind the same array contract, and this one is its reference.

Nodes are emitted in depth-first order: node i's left child is i+1 and
`right` holds the right child's index, or -1 for a leaf.  The JAX
package's `presplit` (early split clipping) is not ported: it measured
worse and is off by default there.
"""
from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from ..scene.types import BVH, tree_depth

NUM_BINS = 16
MAX_LEAF = 4
TRAVERSE_COST = 1.0
TRIANGLE_COST = 2.0


def make_bvh(lo, hi, right, start, count) -> BVH:
    """Flat arrays (numpy) -> BVH of CPU tensors, with skip links, the
    leaf-size cap and the depth filled in."""
    right = np.asarray(right, np.int32)
    count = np.asarray(count, np.int32)
    return BVH(
        lo=torch.from_numpy(np.asarray(lo, np.float32).reshape(-1, 3)),
        hi=torch.from_numpy(np.asarray(hi, np.float32).reshape(-1, 3)),
        right=torch.from_numpy(right),
        start=torch.from_numpy(np.asarray(start, np.int32)),
        count=torch.from_numpy(count),
        skip=torch.from_numpy(compute_skip(right)),
        leaf_max=int(count.max(initial=0)) or 1,
        depth=tree_depth(right))


def build(tp: np.ndarray, max_leaf: int = MAX_LEAF, bins: int = NUM_BINS,
          all_axes: bool = False) -> Tuple[BVH, np.ndarray]:
    """tp: (T, 3, 3) triangle vertex positions -> (flat BVH, triangle
    order); triangles must be reordered by `order` so that leaves
    reference contiguous ranges.

    bins/all_axes: SAH quality knobs.  By default the largest centroid
    axis is split at 16 bins; all_axes sweeps every axis's bins and
    takes the global best."""
    t_count = len(tp)
    cent = tp.mean(axis=1).astype(np.float64)
    tri_lo = tp.min(axis=1).astype(np.float64)
    tri_hi = tp.max(axis=1).astype(np.float64)
    order = np.arange(t_count)
    lo_list, hi_list, right_list, start_list, count_list = [], [], [], [], []

    def emit(lo, hi, right, start, count) -> int:
        lo_list.append(lo)
        hi_list.append(hi)
        right_list.append(right)
        start_list.append(start)
        count_list.append(count)
        return len(lo_list) - 1

    def node_bounds(ids):
        return tri_lo[ids].min(axis=0), tri_hi[ids].max(axis=0)

    def surface(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def rec(ids: np.ndarray, start: int) -> int:
        lo, hi = node_bounds(ids)
        n = len(ids)
        if n <= max_leaf:
            order[start:start + n] = ids
            return emit(lo, hi, -1, start, n)
        c = cent[ids]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        axes = (range(3) if all_axes
                else (int(np.argmax(cmax - cmin)),))
        root_area = max(surface(lo, hi), 1e-30)
        best_cost, best_mask = np.inf, None
        for axis in axes:
            extent = cmax[axis] - cmin[axis]
            if extent < 1e-12:
                continue
            rel = (c[:, axis] - cmin[axis]) / extent
            bix = np.minimum((rel * bins).astype(np.int64), bins - 1)
            counts = np.bincount(bix, minlength=bins)
            bin_lo = np.full((bins, 3), np.inf)
            bin_hi = np.full((bins, 3), -np.inf)
            for b in range(bins):
                m = bix == b
                if counts[b]:
                    bin_lo[b] = tri_lo[ids[m]].min(axis=0)
                    bin_hi[b] = tri_hi[ids[m]].max(axis=0)
            # prefix/suffix sweep of the bins' areas
            lcnt = np.cumsum(counts)[:-1]
            rcnt = n - lcnt
            l_lo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            l_hi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            r_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            r_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
            l_area = np.array([surface(l_lo[i], l_hi[i])
                               for i in range(bins - 1)])
            r_area = np.array([surface(r_lo[i], r_hi[i])
                               for i in range(bins - 1)])
            with np.errstate(invalid="ignore"):
                cost = (TRAVERSE_COST + TRIANGLE_COST
                        * (l_area * lcnt + r_area * rcnt) / root_area)
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            b = int(np.argmin(cost))
            if np.isfinite(cost[b]) and cost[b] < best_cost:
                best_cost = float(cost[b])
                best_mask = bix <= b
        if best_mask is None:
            # degenerate: all centroids coincide, split evenly
            half = n // 2
            left_ids, right_ids = ids[:half], ids[half:]
        else:
            left_ids, right_ids = ids[best_mask], ids[~best_mask]
        node = emit(lo, hi, 0, 0, 0)  # right child patched below
        rec(left_ids, start)
        right_idx = rec(right_ids, start + len(left_ids))
        right_list[node] = right_idx
        return node

    if t_count:
        rec(order.copy(), 0)
    else:
        emit(np.zeros(3), np.zeros(3), -1, 0, 0)
    return make_bvh(np.asarray(lo_list), np.asarray(hi_list), right_list,
                    start_list, count_list), order


def sah_cost(bvh: BVH) -> float:
    """Total SAH cost of a flat tree, normalised by the root's area (the
    builder's own objective, a host-side quality measure)."""
    lo = bvh.lo.cpu().numpy().astype(np.float64)
    hi = bvh.hi.cpu().numpy().astype(np.float64)
    right = bvh.right.cpu().numpy()
    count = bvh.count.cpu().numpy()
    d = np.maximum(hi - lo, 0.0)
    area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                  + d[:, 2] * d[:, 0])
    root = max(area[0], 1e-30)
    leaf = right == -1
    return float((np.where(leaf, TRIANGLE_COST * count, TRAVERSE_COST)
                  * area).sum() / root)


def compute_skip(right: np.ndarray) -> np.ndarray:
    """DFS-successor ("skip") links from the right-child array:
    skip[root] = B; for an inner node i, skip[i+1] = right[i] and
    skip[right[i]] = skip[i]."""
    right = np.asarray(right)
    b = len(right)
    skip = np.full(b, b, np.int32)
    for i in range(b):
        r = right[i]
        if r != -1:
            skip[i + 1] = r
            skip[r] = skip[i]
    return skip


def validate(bvh: BVH, tp_reordered: np.ndarray) -> None:
    """Host-side invariant check: every triangle inside its leaf's
    bounds, children inside their parents, every triangle covered.
    Raises AssertionError on a violation."""
    lo = bvh.lo.cpu().numpy()
    hi = bvh.hi.cpu().numpy()
    right = bvh.right.cpu().numpy()
    start = bvh.start.cpu().numpy()
    count = bvh.count.cpu().numpy()
    eps = 1e-3
    covered = np.zeros(len(tp_reordered), bool)
    for i in range(len(lo)):
        if right[i] == -1:
            s, c = start[i], count[i]
            covered[s:s + c] = True
            if c:
                t = tp_reordered[s:s + c].reshape(-1, 3)
                assert (t >= lo[i] - eps).all() and (t <= hi[i] + eps).all(), i
        else:
            for ch in (i + 1, right[i]):
                assert (lo[ch] >= lo[i] - eps).all(), (i, ch)
                assert (hi[ch] <= hi[i] + eps).all(), (i, ch)
    assert covered.all(), "leaf ranges must cover every triangle"
