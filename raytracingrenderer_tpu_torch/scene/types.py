"""Scene representation: flat structure-of-arrays tensors on one device.

Counterpart of raytracingrenderer_tpu/scene/types.py, with the same
field names so the JAX scene converts field by field
(scene/convert.py).  Triangles, materials, lights and bounds are
NamedTuples of tensors; the background and camera are small dataclasses
whose integer metadata (background kind, image size) are plain Python
ints.  Every tensor of a scene lies on the scene's device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.vec import V3

# Material type enum (the RTBase BSDF subclass set, Materials.h:118-511).
MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_CONDUCTOR = 2
MAT_GLASS = 3
MAT_DIELECTRIC = 4  # rough glass
MAT_OREN_NAYAR = 5
MAT_PLASTIC = 6
NUM_MAT_TYPES = 7

# Background type enum (RTBase Lights.h:84-201).
BG_NONE = 0      # black background
BG_CONST = 1     # constant colour
BG_ENVMAP = 2    # lat-long environment map (lights/envmap.py)


class Triangles(NamedTuple):
    """SoA triangle buffer; every component is a (T,) tensor."""
    p0: V3          # vertex 0 position
    e1: V3          # p1 - p0
    e2: V3          # p2 - p0
    gn: V3          # unit geometric normal, agreeing with n0
    n0: V3          # shading normals at the three vertices
    n1: V3
    n2: V3
    uv0: torch.Tensor  # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    area: torch.Tensor      # (T,)
    mat_id: torch.Tensor    # (T,) int32 index into MaterialTable
    light_id: torch.Tensor  # (T,) int32 index into LightTable, -1 if none

    @property
    def count(self) -> int:
        return self.area.shape[0]


class MaterialTable(NamedTuple):
    """Enum-tagged SoA material table; every component is (M,)."""
    mtype: torch.Tensor       # (M,) int32, MAT_*
    albedo: V3                # constant reflectance colour
    albedo_tex: torch.Tensor  # (M,) int32 atlas index, -1 = constant
    emission: V3              # radiance for emissive materials
    is_emissive: torch.Tensor # (M,) bool
    eta: V3                   # conductor complex IOR (real part)
    k: V3                     # conductor complex IOR (imaginary part)
    int_ior: torch.Tensor     # (M,)
    ext_ior: torch.Tensor     # (M,)
    alpha: torch.Tensor       # (M,) GGX roughness alpha
    sigma: torch.Tensor       # (M,) Oren-Nayar sigma
    coat_thickness: torch.Tensor  # (M,) 0 = uncoated
    coat_sigma_a: V3
    coat_int_ior: torch.Tensor
    coat_ext_ior: torch.Tensor

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


class TextureAtlas(NamedTuple):
    """Non-constant textures padded to a common (H, W) grid.  Constant
    1x1 textures are folded into MaterialTable.albedo at load time."""
    data: torch.Tensor   # (N, Hmax, Wmax, 3) f32
    alpha: torch.Tensor  # (N, Hmax, Wmax) f32 (1.0 where absent)
    hw: torch.Tensor     # (N, 2) int32
    # (N*Hmax*Wmax, 16) f32 rows: the 2x2 bilinear footprint with wrap
    # pre-applied (see the JAX package); None when not built.
    quad: Optional[torch.Tensor] = None


class LightTable(NamedTuple):
    """Area lights: one row per emissive triangle, with its own copy of
    the emitter geometry."""
    tri: torch.Tensor   # (L,) int32 triangle index
    le: V3              # emitted radiance
    area: torch.Tensor  # (L,)
    power: torch.Tensor # (L,) Lum(Le)*area
    p0: V3
    e1: V3
    e2: V3
    gn: V3


class EnvMap(NamedTuple):
    """Lat-long environment map with a luminance alias table
    (lights/envmap.py builds it): one row gather picks a texel's slot,
    one more its radiance and density."""
    data: torch.Tensor        # (H, W, 3) radiance
    alias_row: torch.Tensor   # (H*W, 2) [accept prob, alias index as f32]
    texel_row: torch.Tensor   # (H*W, 4) [R, G, B, pdf2d]
    pdf2d: torch.Tensor       # (H, W) density over (u, v) in [0, 1]^2
    mean_power: torch.Tensor  # 0-d: sin-weighted mean luminance * 4pi


@dataclasses.dataclass
class Background:
    kind: int            # BG_NONE / BG_CONST / BG_ENVMAP
    colour: V3           # 0-d components, for BG_CONST
    envmap: Optional[EnvMap] = None


@dataclasses.dataclass
class Camera:
    """Pinhole camera (RTBase Scene.h:10-70 conventions): P is DX-style
    perspective, `cam_to_world` = lookAt(from, to, up)^-1."""
    p: torch.Tensor              # (4,4) projection
    p_inv: torch.Tensor          # (4,4)
    cam_to_world: torch.Tensor   # (4,4) view -> world
    world_to_cam: torch.Tensor   # (4,4) world -> view
    width: int
    height: int
    origin: V3                   # 0-d components: camera position
    a_film: torch.Tensor         # film area (light-tracing importance)


class SceneBounds(NamedTuple):
    centre: V3              # 0-d components
    radius: torch.Tensor


@dataclasses.dataclass(eq=False)
class BVH:
    """Flattened binary BVH in depth-first order.

    Node i has bounds (lo, hi); a leaf's triangles are [start,
    start+count) of the (reordered) triangle arrays; an inner node's
    left child is i+1 and `right` holds its right child (-1 marks a
    leaf).  `skip` is the DFS successor of node i's subtree (B for
    "done"), which the stackless walk follows on a box miss.
    `leaf_max` is the build's leaf-size cap and `depth` its depth
    (root = 1): the packet kernel's fixed stack is only safe when
    depth <= its MAX_STACK.

    Optional, as in the JAX BVH: the 4-wide collapse of
    `ops/bvh_kernel.widen` (wsel (W, 4) binary node per child slot, -1
    empty; wcode (W, 4) wide row of an internal child or -(leaf_row+1);
    waxis (W,) sort axis), and the treelet cut of
    `ops/treelet.attach_treelets` (tl_nodes/tl_start/tl_count (K,): node,
    first triangle and triangle count of each treelet; tc_nodes/tc_start/
    tc_count (K2,): node and tl_* range of each coarse group).

    `cache` holds tables derived from the tree (the kernel's packed
    rows, the proxy pre-pass's triangles), built once per scene; the
    JAX package gets the same effect from jit hoisting them out of its
    loops.  Every copy (`to`, `replace_*`) starts with an empty one.
    `cached` keys each table on the tensors it was made from, so a
    geometry step (new tensors, or an in-place update) repacks it."""
    lo: torch.Tensor       # (B, 3) f32
    hi: torch.Tensor       # (B, 3) f32
    right: torch.Tensor    # (B,) int32: right-child index, -1 for a leaf
    start: torch.Tensor    # (B,) int32: first triangle (leaf)
    count: torch.Tensor    # (B,) int32: triangle count (0 for inner)
    skip: torch.Tensor     # (B,) int32: DFS successor after the subtree
    leaf_max: int = 4
    depth: int = 0
    wsel: Optional[torch.Tensor] = None
    wcode: Optional[torch.Tensor] = None
    waxis: Optional[torch.Tensor] = None
    tl_nodes: Optional[torch.Tensor] = None
    tl_start: Optional[torch.Tensor] = None
    tl_count: Optional[torch.Tensor] = None
    tc_nodes: Optional[torch.Tensor] = None
    tc_start: Optional[torch.Tensor] = None
    tc_count: Optional[torch.Tensor] = None
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_nodes(self) -> int:
        return self.right.shape[0]

    def cached(self, key, deps, build):
        """build() kept in the cache under `key`, made again when a tensor
        of `deps` holds other data (`same_data`) or was changed in place
        (its `_version`) since; one entry a key, so stale tables are
        freed."""
        hit = self.cache.get(key)
        if hit is not None and len(hit[0]) == len(deps) and all(
                same_data(a, b, v) for a, (b, v) in zip(deps, hit[0])):
            return hit[1]
        value = build()
        self.cache[key] = (tuple((a, a._version) for a in deps), value)
        return value

    def _copy(self, **arrays) -> "BVH":
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self) if f.name != "cache"}
        fields.update(arrays)
        return BVH(**fields)

    def to(self, device) -> "BVH":
        return self._copy(**{
            f: a.to(device) for f, a in
            ((f, getattr(self, f)) for f in BVH_ARRAYS) if a is not None})

    def replace_wide(self, wsel, wcode, waxis) -> "BVH":
        dev = self.right.device
        return self._copy(wsel=_int32(wsel, dev), wcode=_int32(wcode, dev),
                          waxis=_int32(waxis, dev))

    def replace_treelets(self, tl_nodes, tl_start, tl_count,
                         tc_nodes, tc_start, tc_count) -> "BVH":
        dev = self.right.device
        return self._copy(
            tl_nodes=_int32(tl_nodes, dev), tl_start=_int32(tl_start, dev),
            tl_count=_int32(tl_count, dev), tc_nodes=_int32(tc_nodes, dev),
            tc_start=_int32(tc_start, dev), tc_count=_int32(tc_count, dev))


def same_data(a: torch.Tensor, b: torch.Tensor, version: int) -> bool:
    """True when `a` is `b`, or an alias of it (the same storage, offset,
    shape and strides, as an identity autograd op returns), and neither
    was changed in place since `b` was at `version` (an alias shares its
    base's version counter).  The caller keeps `b` alive, so its memory
    is not another tensor's."""
    return a._version == version and (a is b or (
        a.data_ptr() == b.data_ptr() and a.shape == b.shape
        and a.stride() == b.stride() and a.dtype == b.dtype
        and a.device == b.device))


BVH_ARRAYS = ("lo", "hi", "right", "start", "count", "skip",
               "wsel", "wcode", "waxis", "tl_nodes", "tl_start", "tl_count",
               "tc_nodes", "tc_start", "tc_count")


def _int32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32)).to(device)


def map_triangles(fn, tris: Triangles) -> Triangles:
    """fn over every tensor of a triangle table (each V3 componentwise)."""
    return Triangles(*(V3(*(fn(c) for c in f)) if isinstance(f, V3)
                       else fn(f) for f in tris))


def tree_depth(right: np.ndarray) -> int:
    """Max depth (root = 1) of the DFS-flattened binary BVH."""
    right = np.asarray(right)
    b = right.shape[0]
    depth = np.ones(b, np.int32)
    for i in range(b):
        r = right[i]
        if r >= 0:
            depth[i + 1] = depth[i] + 1
            depth[r] = depth[i] + 1
    return int(depth.max()) if b else 0


class Scene(NamedTuple):
    triangles: Triangles
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    background: Background
    camera: Camera
    bounds: SceneBounds
    bvh: Optional[BVH] = None
    edge_mult: Optional[torch.Tensor] = None  # (3T,) shared-edge counts

    @property
    def num_lights(self) -> int:
        return self.lights.tri.shape[0]

    @property
    def device(self) -> torch.device:
        return self.triangles.area.device

    @property
    def sharded(self) -> bool:
        """True where the triangles are split over ranks
        (parallel/scene_shard.ShardedBVH): `bvh` then walks the rays and
        serves the shading rows, and `triangles` is a stub."""
        return getattr(self.bvh, "sharded", False)


def scene_device(device) -> torch.device:
    """`device` as a torch.device for a scene's tensors.  A CUDA device
    where torch.cuda.is_available() is false raises: a scene asked for
    on the card never quietly lands on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested, but torch.cuda.is_available() "
            f"is false; pass device='cpu' to load onto the CPU")
    return device


def v3_from_np(a: np.ndarray, device=None) -> V3:
    a = np.asarray(a, np.float32)
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[..., i])).to(device)
                for i in range(3)))
