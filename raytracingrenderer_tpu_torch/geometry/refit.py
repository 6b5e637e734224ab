"""BVH refit after geometry steps: host numpy over the fixed topology.

Counterpart of raytracingrenderer_tpu/geometry/refit.py.  A training
step that moves `tri_p0` (diff.train_step) leaves the node bounds, the
light table's copy of the emitter geometry and the scene bounds as they
were at load, so rays would miss geometry that moved out of its leaf
box.  `refit(scene)` recomputes all three; call it after every step (or
every few) that moves vertices.

Node bounds are recomputed bottom up over the existing topology: leaves
from their triangles, then inner nodes level by level, deepest first
(the DFS layout puts children at larger indices than their parent).  The
4-wide collapse and the treelet cut are kept.  The result is a new BVH,
whose cache starts empty, so the kernels' packed tables are made again
from the new bounds.  Partition quality degrades as triangles travel far
from their build positions: rebuild with scene.loader for large motions.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.vec import V3
from ..scene.types import BVH, Scene, SceneBounds
from ..utils.profiling import spanned

# level lists by topology: (size, blake2b of `right`), not id(), which a
# freed array's address can alias
_LEVELS_CACHE: Dict[Tuple[int, bytes], List[np.ndarray]] = {}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _internal_levels(right: np.ndarray) -> List[np.ndarray]:
    """Internal-node index arrays grouped by depth, deepest first (depth by
    vectorised ancestor chasing on the parent array; cached per
    topology, which a refit never changes)."""
    right = np.ascontiguousarray(right)
    key = (right.shape[0],
           hashlib.blake2b(right.tobytes(), digest_size=16).digest())
    hit = _LEVELS_CACHE.get(key)
    if hit is not None:
        return hit
    b = right.shape[0]
    parent = np.full(b, -1, np.int64)
    ii = np.nonzero(right >= 0)[0]
    parent[ii + 1] = ii
    parent[right[ii]] = ii
    depth = np.zeros(b, np.int32)
    jmp = parent.copy()
    while (jmp >= 0).any():
        live = jmp >= 0
        depth += live
        jmp = np.where(live, parent[np.maximum(jmp, 0)], -1)
    is_int = right >= 0
    levels = []
    for d in range(int(depth.max()) if b else 0, -1, -1):
        idx = np.nonzero(is_int & (depth == d))[0]
        if idx.size:
            levels.append(idx)
    _LEVELS_CACHE[key] = levels
    return levels


def refit_bvh(bvh: BVH, tris) -> BVH:
    """Node bounds recomputed from the (possibly moved) triangles; the
    topology (right/start/count/skip, the wide and treelet fields) is
    kept, only lo/hi are new.  Returns a new BVH on the tree's device."""
    right = _np(bvh.right)
    start = _np(bvh.start)
    count = _np(bvh.count)
    p0 = np.stack([_np(c) for c in tris.p0], axis=-1)
    p1 = p0 + np.stack([_np(c) for c in tris.e1], axis=-1)
    p2 = p0 + np.stack([_np(c) for c in tris.e2], axis=-1)
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    t_count = tri_lo.shape[0]

    lo = _np(bvh.lo).copy()
    hi = _np(bvh.hi).copy()

    leaf = np.nonzero(right < 0)[0]
    acc_lo = np.full((leaf.size, 3), np.inf, np.float32)
    acc_hi = np.full((leaf.size, 3), -np.inf, np.float32)
    for k in range(int(bvh.leaf_max)):
        m = (k < count[leaf])[:, None]
        t = np.minimum(start[leaf] + k, max(t_count - 1, 0))
        acc_lo = np.where(m, np.minimum(acc_lo, tri_lo[t]), acc_lo)
        acc_hi = np.where(m, np.maximum(acc_hi, tri_hi[t]), acc_hi)
    lo[leaf] = acc_lo
    hi[leaf] = acc_hi

    for idx in _internal_levels(right):
        l, r = idx + 1, right[idx]
        lo[idx] = np.minimum(lo[l], lo[r])
        hi[idx] = np.maximum(hi[r], hi[l])
    dev = bvh.lo.device
    return bvh._copy(lo=torch.from_numpy(lo).to(dev),
                     hi=torch.from_numpy(hi).to(dev))


@spanned("rtr.refit")
def refit(scene: Scene) -> Scene:
    """Refresh every position-derived table after `tri_p0` moved:

    - the light table's copy of the emitter geometry (p0/e1/e2/gn gathered
      from the triangles through LightTable.tri; area and power, Lum(Le)
      times area, recomputed as the loader computes them),
    - the BVH node bounds (refit_bvh),
    - the scene bounds (centre and radius of the new root box), which the
      coherence sort key reads.

    Scenes without a BVH get the light-table refresh only."""
    out = scene
    with torch.no_grad():
        if scene.num_lights:
            lt = scene.lights
            ti = lt.tri.long()
            tr = scene.triangles
            e1, e2 = tr.e1.gather(ti), tr.e2.gather(ti)
            cr = e1.cross(e2)
            area = 0.5 * torch.sqrt(cr.dot(cr))
            out = out._replace(lights=lt._replace(
                p0=tr.p0.gather(ti), e1=e1, e2=e2, gn=tr.gn.gather(ti),
                area=area, power=lt.le.lum() * area))
    if scene.bvh is not None:
        bvh = refit_bvh(scene.bvh, scene.triangles)
        lo0 = _np(bvh.lo[0])
        hi0 = _np(bvh.hi[0])
        centre = (lo0 + hi0) * 0.5
        radius = float(np.linalg.norm(hi0 - centre))
        dev = scene.device
        out = out._replace(bvh=bvh, bounds=SceneBounds(
            centre=V3.of(*centre, device=dev),
            radius=torch.tensor(max(radius, 1e-6), dtype=torch.float32,
                                device=dev)))
    return out
