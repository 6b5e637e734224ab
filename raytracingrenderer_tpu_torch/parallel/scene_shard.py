"""Primitive-sharded intersection: the model-parallel axis.

Counterpart of raytracingrenderer_tpu/parallel/scene_shard.py.  For a
scene beyond one card's memory, the traversal working set (triangle
geometry and a BVH over it) is split over the ranks of a mesh instead
of replicated: every rank walks the whole ray batch against its own
shard's sub-BVH, and the per-shard hits merge across ranks.  The merge
keeps the JAX package's rules: the least t wins, ties go to the lowest
shard (JAX's argmin), and any-hit is an OR (the first shard with a hit
gives its fields).

Shards are contiguous ranges of the globally SAH-ordered triangles,
ceil(T / n) each (the order is padded with -1 slots to n * shard_size),
so each sub-BVH covers a spatially coherent chunk.  Triangle ids stay
global: shard i's local id j is i * shard_size + j.  Each rank holds
only its own shard: its sub-BVH, its triangles' geometry and its
shading rows (`attach_attrs`; `gather_attrs_sharded` serves them by
owner); the scene keeps a one-row stub of the triangle table
(`stub_triangles`), as in the JAX package.

Each rank walks its shard through the port's own dispatch
(geometry/intersect._walk): the BVH kernel (csrc/bvh_kernel.cu) where the
sub-tree fits its stack, the MT kernel (csrc/mt_kernel.cu) for a shard
of 64 triangles or fewer, and for any-hit the proxy pre-pass over the
shard's own 128 largest triangles.  The JAX package walks every shard
stackless; the kernels find the same closest hit.  The JAX package's
node padding, which makes its SPMD program shape-uniform, is not needed.

The merge costs two all_reduces a traversal (closest-hit: the least of
(t, shard) as one int64 key, then the winner's id and barycentrics as an
owner-masked sum; the renderer's shadow rays: one max of the occlusion
bits).  Every rank walks the whole batch, so closest-hit work is paid
n_shards times and the wavefront integrator's compaction is off
(render._use_wavefront): an escape hatch for scenes that do not fit a
card, not a speed-up for scenes that do.

    scene = load_scene(DIR, scene_shards=N)   # under N ranks
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.vec import V3
from ..geometry.intersect import BIG_T, Hit
from ..scene.types import (BVH, SceneBounds, Triangles, map_triangles,
                           v3_from_np)
from .mesh import Mesh, make_mesh

# the shading rows: what integrators/common.shading_data reads by
# triangle id, as int32 columns (a float as its bits), so that an
# owner-masked sum over the ranks returns each row bit for bit; the
# first 19 columns are the JAX package's pack_attrs's, whose 25 more
# are the material row (the port reads the materials by mat_id)
ATTR_FIELDS = (("n0", 3), ("n1", 3), ("n2", 3), ("gn", 3), ("uv0", 2),
               ("uv1", 2), ("uv2", 2), ("light_id", 1), ("mat_id", 1))
ATTR_WIDTH = sum(w for _, w in ATTR_FIELDS)


class Shard(NamedTuple):
    """One shard, in the form the intersection dispatch walks."""
    triangles: Triangles            # shard_size rows: geometry and area
    bvh: BVH                        # the sub-tree over them
    bounds: SceneBounds             # the whole scene's (the rays' sort key)
    attrs: Optional[torch.Tensor] = None   # (shard_size, ATTR_WIDTH) int32


@dataclasses.dataclass(eq=False)
class ShardedBVH:
    """The shards a process holds, by shard index: every shard after
    `build_sharded` (on the CPU), this rank's alone after
    `place_sharded`, which also records the mesh."""
    shards: Dict[int, Shard]
    n_shards: int
    shard_size: int
    leaf_max: int
    mesh: Optional[Mesh] = None
    # Scene.sharded reads this; the geometry and shading layers then walk
    # and shade through the methods below
    sharded = True

    def closest_hit(self, o: V3, d: V3, t_init) -> Hit:
        return traverse_sharded(self, o, d, t_init)

    def occluded(self, o: V3, d: V3, max_t: torch.Tensor) -> torch.Tensor:
        return occluded_sharded(self, o, d, max_t)

    def shading_triangles(self, tri: torch.Tensor) -> Triangles:
        return shading_triangles(self, tri)


def _bounds(tp: np.ndarray) -> SceneBounds:
    """The loader's bounding sphere of the vertices."""
    if len(tp):
        lo = tp.reshape(-1, 3).min(axis=0)
        hi = tp.reshape(-1, 3).max(axis=0)
    else:
        lo = hi = np.zeros(3, np.float32)
    centre = 0.5 * (lo + hi)
    return SceneBounds(centre=V3.of(*centre),
                       radius=torch.tensor(
                           np.float32(np.linalg.norm(hi - centre))))


def _geometry(v: np.ndarray) -> Triangles:
    """(S, 3, 3) vertices -> Triangles with p0, e1, e2 and area; the
    shading fields are zeros (the shard's shading rows are `attrs`)."""
    s = len(v)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    z = torch.zeros(()).expand(s)
    zv = V3(z, z, z)
    z2 = torch.zeros(()).expand(s, 2)
    return Triangles(
        p0=v3_from_np(v[:, 0]), e1=v3_from_np(e1), e2=v3_from_np(e2),
        gn=zv, n0=zv, n1=zv, n2=zv, uv0=z2, uv1=z2, uv2=z2,
        area=torch.from_numpy(area.astype(np.float32)),
        mat_id=torch.zeros((), dtype=torch.int32).expand(s),
        light_id=torch.full((), -1, dtype=torch.int32).expand(s))


def _never_hit() -> BVH:
    """One leaf with an empty box and no triangles: an empty shard's
    tree (the native builder's behaviour at n = 0 is undefined)."""
    return BVH(lo=torch.full((1, 3), float("inf")),
               hi=torch.full((1, 3), float("-inf")),
               right=torch.full((1,), -1, dtype=torch.int32),
               start=torch.zeros(1, dtype=torch.int32),
               count=torch.zeros(1, dtype=torch.int32),
               skip=torch.ones(1, dtype=torch.int32), leaf_max=1, depth=1)


def build_sharded(tp: np.ndarray, n_shards: int, max_leaf: int = 14
                  ) -> Tuple[ShardedBVH, np.ndarray]:
    """(T, 3, 3) vertex positions -> (every shard on the CPU, the padded
    global order).

    A global binned-SAH build (native/, 64 bins, all axes) gives the
    order; its contiguous chunks of ceil(T / n_shards) become the
    shards, each with its own sub-build (with the 4-wide collapse the
    loader attaches to every tree) and reordered by it.  The order has
    n_shards * shard_size slots, -1 marking padding (callers pad their
    triangle table to match, with triangles that are never hit)."""
    from ..geometry import bvh_native
    from ..ops.bvh_kernel import widen
    t = len(tp)
    _, order = bvh_native.build(tp, max_leaf=max_leaf, bins=64,
                                all_axes=True)
    shard = -(-t // n_shards)
    padded = np.full(n_shards * shard, -1, np.int64)
    padded[:t] = order
    bounds = _bounds(tp)
    shards, leaf_max = {}, 1
    for i in range(n_shards):
        ids = padded[i * shard:(i + 1) * shard]
        ids = ids[ids >= 0]
        if len(ids):
            sub, sub_order = bvh_native.build(tp[ids], max_leaf=max_leaf,
                                              bins=64, all_axes=True)
            ids = ids[sub_order]
            padded[i * shard:i * shard + len(ids)] = ids
            sub = widen(sub)
        else:
            sub = _never_hit()
        v = np.zeros((shard, 3, 3), np.float32)
        v[:len(ids)] = tp[ids]
        shards[i] = Shard(_geometry(v), sub, bounds)
        leaf_max = max(leaf_max, sub.leaf_max)
    return ShardedBVH(shards, n_shards, shard, leaf_max), padded


def _shard_to(sh: Shard, device) -> Shard:
    return Shard(map_triangles(lambda a: a.to(device), sh.triangles),
                 sh.bvh.to(device),
                 SceneBounds(V3(*(c.to(device) for c in sh.bounds.centre)),
                             sh.bounds.radius.to(device)),
                 None if sh.attrs is None else sh.attrs.to(device))


def place_sharded(sb: ShardedBVH, mesh: Mesh, device=None) -> ShardedBVH:
    """This rank's shard alone, on `device` (the mesh's by default), with
    the mesh recorded: the memory win.  The mesh must have one rank a
    shard."""
    _check_mesh(sb, mesh)
    i = mesh.rank
    dev = mesh.device if device is None else torch.device(device)
    return ShardedBVH({i: _shard_to(sb.shards[i], dev)}, sb.n_shards,
                      sb.shard_size, sb.leaf_max, mesh)


def pack_attrs(tris: Triangles) -> torch.Tensor:
    """(T, ATTR_WIDTH) int32 shading rows of a triangle table."""
    cols = []
    for name, width in ATTR_FIELDS:
        f = getattr(tris, name)
        if isinstance(f, V3):
            cols.extend(f)
        elif width == 1:
            cols.append(f)
        else:
            cols.extend(f[:, k] for k in range(width))
    return torch.stack([c.contiguous().view(torch.int32)
                        if c.dtype == torch.float32 else c.to(torch.int32)
                        for c in cols], dim=-1)


def attach_attrs(sb: ShardedBVH, tris: Triangles) -> ShardedBVH:
    """Each held shard with its shading rows, packed from `tris`, the
    padded, globally ordered triangle table (the order the global ids
    index), on the shard's device."""
    s = sb.shard_size
    out = {}
    for i, sh in sb.shards.items():
        rows = pack_attrs(map_triangles(lambda a: a[i * s:(i + 1) * s], tris))
        out[i] = sh._replace(attrs=rows.to(sh.triangles.area.device))
    return dataclasses.replace(sb, shards=out)


def stub_triangles(tris: Triangles) -> Triangles:
    """The one-row stand-in for the triangle table in scene-sharded mode:
    every consumer by triangle id reads the shards (traversal) or their
    shading rows (`gather_attrs_sharded`), and the light table keeps its
    own copy of the emitters' geometry."""
    return map_triangles(lambda a: a[:1].clone(), tris)


def _check_mesh(sb: ShardedBVH, mesh: Mesh) -> None:
    if mesh.size != sb.n_shards:
        raise ValueError(
            f"{sb.n_shards} shards need a mesh of {sb.n_shards} ranks, one a "
            f"shard; this one has {mesh.size} (torchrun --nproc_per_node "
            f"{sb.n_shards})")


def _local(sb: ShardedBVH, mesh: Optional[Mesh]) -> Tuple[Mesh, int, Shard]:
    mesh = mesh or sb.mesh or make_mesh(sb.n_shards)
    _check_mesh(sb, mesh)
    if mesh.rank not in sb.shards:
        raise ValueError(f"rank {mesh.rank} does not hold its shard "
                         f"(place_sharded)")
    return mesh, mesh.rank, sb.shards[mesh.rank]


def gather_attrs_sharded(sb: ShardedBVH, tri: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """(N,) global triangle ids -> (N, ATTR_WIDTH) int32 shading rows, by
    owner: each rank serves the rows of its shard (zeros elsewhere) and
    an all_reduce sum merges them, bit for bit.  The collective takes
    the place of a gather from a replicated table."""
    mesh, i, sh = _local(sb, mesh)
    s = sb.shard_size
    local = tri.long() - i * s
    own = (local >= 0) & (local < s)
    rows = torch.where(own[:, None], sh.attrs[torch.clamp(local, 0, s - 1)],
                       0)
    mesh.all_reduce(rows)
    return rows


def shading_triangles(sb: ShardedBVH, tri: torch.Tensor) -> Triangles:
    """The shading fields of triangles `tri` (global ids, >= 0) as an (N,)
    Triangles, row k for tri[k] (geometry and area are zeros):
    integrators/common.shading_data reads these in scene-sharded mode."""
    rows = gather_attrs_sharded(sb, tri)
    n = rows.shape[0]
    fields, k = {}, 0
    for name, width in ATTR_FIELDS:
        cols = rows[:, k:k + width]
        if name in ("mat_id", "light_id"):
            fields[name] = cols[:, 0].contiguous()
        else:
            cols = cols.contiguous().view(torch.float32)
            fields[name] = (V3(*(cols[:, j].contiguous() for j in range(3)))
                            if width == 3 else cols)
        k += width
    z = torch.zeros(n, dtype=torch.float32, device=rows.device)
    zv = V3(z, z, z)
    return Triangles(p0=zv, e1=zv, e2=zv, area=z, **fields)


def _rays(o: V3, d: V3):
    return (V3(*(c.detach().contiguous() for c in o)),
            V3(*(c.detach().contiguous() for c in d)))


def _merge_closest(mesh: Mesh, h: Hit, base: int, index: int) -> Hit:
    """The least t over the ranks, ties to the lowest shard index: one
    int64 min of (t's bits, shard index) -- t >= 0 orders as its bits --
    then the winner's id (global: base + local) and barycentrics by an
    owner-masked sum."""
    hit = h.tri >= 0
    t_key = torch.where(hit, h.t, BIG_T).contiguous()
    key = (t_key.view(torch.int32).to(torch.int64) << 32) | index
    mesh.all_reduce(key, "min")
    own = (key & 0xFFFFFFFF) == index
    tri_g = torch.where(hit, h.tri + base, -1).to(torch.int32)
    payload = torch.stack([tri_g, h.u.contiguous().view(torch.int32),
                           h.v.contiguous().view(torch.int32)], dim=-1)
    payload = torch.where(own[:, None], payload, 0)
    mesh.all_reduce(payload)
    tri = payload[:, 0].contiguous()
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return Hit(torch.where(tri >= 0, t, BIG_T), tri,
               payload[:, 1].contiguous().view(torch.float32),
               payload[:, 2].contiguous().view(torch.float32))


def traverse_sharded(sb: ShardedBVH, o: V3, d: V3, t_init,
                     any_hit: bool = False,
                     mesh: Optional[Mesh] = None) -> Hit:
    """The whole ray batch (the same on every rank) against the sharded
    scene: this rank walks its shard, then the hits merge over the mesh
    (closest: the least t, ties to the lowest shard; any-hit: the first
    shard with a hit gives t, id and barycentrics, misses keep t_init).
    Ids are global.  Every rank must call this with the same rays."""
    from ..geometry import intersect
    mesh, i, sh = _local(sb, mesh)
    o, d = _rays(o, d)
    n = o.x.shape[0]
    t0 = torch.broadcast_to(torch.as_tensor(t_init, device=o.x.device),
                            (n,)).to(torch.float32).contiguous()
    base = i * sb.shard_size
    with torch.no_grad():
        h = intersect._walk(sh, o, d, t0, any_hit, presorted=False)
        if not any_hit:
            return _merge_closest(mesh, h, base, i)
        hit = h.tri >= 0
        first = torch.where(hit, i, sb.n_shards).to(torch.int32)
        mesh.all_reduce(first, "min")
        own = first == i
        payload = torch.stack(
            [h.t.contiguous().view(torch.int32),
             torch.where(hit, h.tri + base, -1).to(torch.int32),
             h.u.contiguous().view(torch.int32),
             h.v.contiguous().view(torch.int32)], dim=-1)
        payload = torch.where(own[:, None], payload, 0)
        mesh.all_reduce(payload)
        found = first < sb.n_shards
        f = payload.view(torch.float32)
        return Hit(torch.where(found, f[:, 0], t0),
                   torch.where(found, payload[:, 1], -1),
                   f[:, 2].contiguous(), f[:, 3].contiguous())


def occluded_sharded(sb: ShardedBVH, o: V3, d: V3, max_t: torch.Tensor,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Any-hit bits alone (the renderer's shadow rays): this rank's walk,
    then one max of the bits over the mesh."""
    from ..geometry import intersect
    mesh, _, sh = _local(sb, mesh)
    o, d = _rays(o, d)
    with torch.no_grad():
        h = intersect._walk(sh, o, d, max_t.detach().contiguous(), True,
                            presorted=False)
        occ = (h.tri >= 0).to(torch.uint8)
        mesh.all_reduce(occ, "max")
    return occ.bool()


# ---------------------------------------------------------------------------
# the brute-force variant (small scenes; an oracle for the BVH path)

def pad_triangles(tris: Triangles, multiple: int) -> Triangles:
    """The triangle table padded to a multiple of `multiple` rows with
    degenerate triangles (zero geometry, material 0, no light), which
    are never hit."""
    pad = (-tris.count) % multiple
    if pad == 0:
        return tris

    def pz(x):
        fill = -1 if x is tris.light_id else 0
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])
    return map_triangles(pz, tris)


def shard_triangles(mesh: Mesh, tris: Triangles) -> Triangles:
    """This rank's contiguous share of a (padded) triangle table, whose
    row count is a multiple of the mesh's size."""
    if tris.count % mesh.size:
        raise ValueError(f"{tris.count} triangles do not split over "
                         f"{mesh.size} ranks: pad_triangles first")
    s = tris.count // mesh.size
    lo = mesh.rank * s
    return map_triangles(lambda a: a[lo:lo + s], tris)


def closest_hit_sharded(tris: Triangles, o: V3, d: V3, mesh: Mesh) -> Hit:
    """Closest hit with the triangles sharded over `mesh`: `tris` is this
    rank's shard (`shard_triangles`), every shard the same size; each
    rank tests every ray against its shard by brute force (the MT
    kernel, csrc/mt_kernel.cu, up to its 4096 triangles), and the hits
    merge as in `traverse_sharded`."""
    from ..ops import mt_kernel
    o, d = _rays(o, d)
    h = mt_kernel.closest_hit(tris, o, d)
    return _merge_closest(mesh, h, mesh.rank * tris.count, mesh.rank)
