"""scene.json + .gem -> Scene of tensors on one device (host-side numpy).

Counterpart of raytracingrenderer_tpu/scene/loader.py with the same
handling of the RTBase scene format: bsdf-string mapping and parameter
defaults, vertex/normal transforms, constant-colour textures folded into
albedo, zero-area triangle culling, geometric normals canonicalised to
vertex normal 0, the emissive-material light table, scene bounds and the
camera.  All of that runs in numpy exactly as the JAX loader runs it;
only the final arrays become tensors, on `device`.

With `build_bvh` (the default) a non-empty scene gets the JAX
loader's BVH: the native binned-SAH builder (geometry/bvh_native.py)
with 14-triangle leaves, 64 bins and all three axes swept, after which
the triangles are reordered so that every leaf is a contiguous range
and the light table's triangle ids are remapped; the tree carries the
4-wide collapse (`ops/bvh_kernel.widen`) as the JAX loader's does; the
build and the collapse run inside the span `rtr.load.bvh`.
Scenes of 64 triangles or fewer still brute-force every ray
(geometry/intersect.py), as in the JAX package, which builds their tree
all the same.  A scene.json "envmap" makes the background that map, its
sampling tables built as the JAX loader builds them (lights/envmap.py).
The JAX loader's sharded trees (`scene_shards`) are not ported.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import matrix
from ..core.vec import V3
from ..io.hdr import read_hdr
from ..io.png import read_png_float
from ..utils.profiling import span
from .gem import load_gem
from .types import (BG_ENVMAP, BG_NONE, MAT_CONDUCTOR, MAT_DIELECTRIC,
                    MAT_DIFFUSE, MAT_GLASS, MAT_MIRROR, MAT_OREN_NAYAR,
                    MAT_PLASTIC, Background, Camera, LightTable,
                    MaterialTable, Scene, SceneBounds, TextureAtlas,
                    Triangles, map_triangles, scene_device, v3_from_np)

# Leaf size and SAH quality of the loader's build, as the JAX loader's:
# 14 triangles fill one 128-lane leaf row of the packet kernel's tables;
# 64 bins swept on every axis.
BVH_MAX_LEAF = 14
BVH_BINS = 64


def _get(props: Dict, key: str, default):
    """Typed property fetch: missing or null -> default; strings parsed to
    the default's type."""
    v = props.get(key)
    if v is None:
        return default
    if isinstance(default, float):
        return float(v)
    if isinstance(default, int) and not isinstance(default, bool):
        return int(float(v))
    return v


def _get_vec3(props: Dict, key: str, default=(0.0, 0.0, 0.0)):
    v = props.get(key)
    if v is None:
        return np.asarray(default, np.float32)
    parts = str(v).split()
    return np.asarray([float(p) for p in parts[:3]], np.float32)


class _TextureManager:
    """Path-keyed texture cache.  Constant-colour textures (every 1x1 PNG
    the scenes ship) fold into a colour; real textures go to the atlas.
    Missing files -> 1x1 white."""

    def __init__(self):
        self.cache: Dict[str, tuple] = {}
        self.images: List[np.ndarray] = []   # (H, W, 3)
        self.alphas: List[Optional[np.ndarray]] = []

    def load(self, path: str):
        """-> (const_colour or None, atlas_index or -1)"""
        if path in self.cache:
            return self.cache[path]
        img = None
        alpha = None
        if os.path.isfile(path):
            try:
                if path.endswith(".hdr"):
                    img = read_hdr(path)
                else:
                    raw = read_png_float(path)
                    if raw.shape[-1] == 1:
                        raw = np.repeat(raw, 3, axis=-1)
                    if raw.shape[-1] == 4:
                        alpha = raw[..., 3].copy()
                    img = raw[..., :3].copy()
            except ValueError:
                img = None
        if img is None:
            result = (np.ones(3, np.float32), -1)  # default white
        elif (img.std(axis=(0, 1)).max() < 1e-6
              and (alpha is None or alpha.std() < 1e-6)):
            result = (img.reshape(-1, 3)[0].copy(), -1)
        else:
            self.images.append(img.astype(np.float32))
            self.alphas.append(alpha)
            result = (None, len(self.images) - 1)
        self.cache[path] = result
        return result

    def build_atlas(self, device) -> TextureAtlas:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        if not self.images:
            # zero-length leading axis = "no textures" (texture.sample
            # short-circuits on it)
            return TextureAtlas(data=t(np.zeros((0, 1, 1, 3), np.float32)),
                                alpha=t(np.ones((0, 1, 1), np.float32)),
                                hw=t(np.ones((0, 2), np.int32)))
        hmax = max(i.shape[0] for i in self.images)
        wmax = max(i.shape[1] for i in self.images)
        n = len(self.images)
        data = np.zeros((n, hmax, wmax, 3), np.float32)
        alpha = np.ones((n, hmax, wmax), np.float32)
        hw = np.zeros((n, 2), np.int32)
        for i, img in enumerate(self.images):
            h, w = img.shape[:2]
            data[i, :h, :w] = img
            if self.alphas[i] is not None:
                alpha[i, :h, :w] = self.alphas[i]
            hw[i] = (h, w)
        # 2x2 footprint rows, wrap pre-applied on each texture's true h/w
        quad = np.zeros((n, hmax, wmax, 16), np.float32)
        for i in range(n):
            h, w = hw[i]
            c = data[i, :h, :w]
            a = alpha[i, :h, :w]
            cx = np.roll(c, -1, axis=1)
            cy = np.roll(c, -1, axis=0)
            cxy = np.roll(cx, -1, axis=0)
            ax = np.roll(a, -1, axis=1)
            ay = np.roll(a, -1, axis=0)
            axy = np.roll(ax, -1, axis=0)
            quad[i, :h, :w] = np.concatenate(
                [c, cx, cy, cxy, a[..., None], ax[..., None],
                 ay[..., None], axy[..., None]], axis=-1)
        return TextureAtlas(data=t(data), alpha=t(alpha), hw=t(hw),
                            quad=t(quad.reshape(n * hmax * wmax, 16)))


class _MaterialRows:
    """Accumulates per-instance material rows for the SoA table."""

    def __init__(self, scene_dir: str, tex: _TextureManager):
        self.scene_dir = scene_dir
        self.tex = tex
        self.rows: List[dict] = []

    def add(self, props: Dict) -> Optional[int]:
        bsdf = _get(props, "bsdf", "")
        refl_file = _get(props, "reflectance", "")
        const_col, tex_id = self.tex.load(
            os.path.join(self.scene_dir, refl_file))
        row = dict(
            mtype=MAT_DIFFUSE,
            albedo=const_col if const_col is not None
            else np.ones(3, np.float32),
            albedo_tex=tex_id,
            emission=np.zeros(3, np.float32),
            eta=np.ones(3, np.float32), k=np.zeros(3, np.float32),
            int_ior=1.33, ext_ior=1.0, alpha=1.62142, sigma=1.0,
            coat_thickness=0.0, coat_sigma_a=np.zeros(3, np.float32),
            coat_int_ior=1.33, coat_ext_ior=1.0)
        # alpha = 1.62142*sqrt(roughness): RTBase Materials.h:216,333,427
        if bsdf == "diffuse":
            row["mtype"] = MAT_DIFFUSE
        elif bsdf == "orennayar":
            row["mtype"] = MAT_OREN_NAYAR
            row["sigma"] = _get(props, "alpha", 1.0)
        elif bsdf == "mirror":
            row["mtype"] = MAT_MIRROR
        elif bsdf == "glass":
            row["mtype"] = MAT_GLASS
            row["int_ior"] = _get(props, "intIOR", 1.33)
            row["ext_ior"] = _get(props, "extIOR", 1.0)
        elif bsdf == "plastic":
            row["mtype"] = MAT_PLASTIC
            row["int_ior"] = _get(props, "intIOR", 1.33)
            row["ext_ior"] = _get(props, "extIOR", 1.0)
            row["alpha"] = 1.62142 * np.sqrt(_get(props, "roughness", 1.0))
        elif bsdf == "dielectric":
            rough = _get(props, "roughness", 1.0)
            row["int_ior"] = _get(props, "intIOR", 1.33)
            row["ext_ior"] = _get(props, "extIOR", 1.0)
            if rough < 0.001:  # RTBase SceneLoader.h:149-156
                row["mtype"] = MAT_GLASS
            else:
                row["mtype"] = MAT_DIELECTRIC
                row["alpha"] = 1.62142 * np.sqrt(rough)
        elif bsdf == "conductor":
            row["mtype"] = MAT_CONDUCTOR
            row["eta"] = _get_vec3(props, "eta", (1.0, 1.0, 1.0))
            row["k"] = _get_vec3(props, "k", (0.0, 0.0, 0.0))
            row["alpha"] = 1.62142 * np.sqrt(_get(props, "roughness", 1.0))
        else:
            return None  # unknown bsdf: skip the instance
        if _get(props, "emission", "") != "":
            row["emission"] = _get_vec3(props, "emission")
        if _get(props, "coatingThickness", 0.0) > 0:
            row["coat_thickness"] = _get(props, "coatingThickness", 0.0)
            row["coat_sigma_a"] = _get_vec3(props, "coatingSigmaA")
            row["coat_int_ior"] = _get(props, "coatingIntIOR", 1.33)
            row["coat_ext_ior"] = _get(props, "coatingExtIOR", 1.0)
        self.rows.append(row)
        return len(self.rows) - 1

    def build(self, device) -> MaterialTable:
        r = self.rows or [dict(
            mtype=MAT_DIFFUSE, albedo=np.ones(3, np.float32), albedo_tex=-1,
            emission=np.zeros(3, np.float32), eta=np.ones(3, np.float32),
            k=np.zeros(3, np.float32), int_ior=1.33, ext_ior=1.0,
            alpha=1.62142, sigma=1.0, coat_thickness=0.0,
            coat_sigma_a=np.zeros(3, np.float32), coat_int_ior=1.33,
            coat_ext_ior=1.0)]

        def col(k):
            return np.asarray([row[k] for row in r])

        def t(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype)).to(device)

        def v3(k):
            return v3_from_np(col(k), device)

        emission = col("emission").astype(np.float32)
        return MaterialTable(
            mtype=t(col("mtype"), np.int32),
            albedo=v3("albedo"),
            albedo_tex=t(col("albedo_tex"), np.int32),
            emission=v3_from_np(emission, device),
            is_emissive=t(emission.max(axis=1) > 0.0, bool),
            eta=v3("eta"), k=v3("k"),
            int_ior=t(col("int_ior"), np.float32),
            ext_ior=t(col("ext_ior"), np.float32),
            alpha=t(col("alpha"), np.float32),
            sigma=t(col("sigma"), np.float32),
            coat_thickness=t(col("coat_thickness"), np.float32),
            coat_sigma_a=v3("coat_sigma_a"),
            coat_int_ior=t(col("coat_int_ior"), np.float32),
            coat_ext_ior=t(col("coat_ext_ior"), np.float32))


def load_scene(scene_dir: str, device="cuda", build_bvh: bool = True,
               scene_shards: int = 0) -> Scene:
    """Load an RTBase-format scene directory onto `device` (the card
    unless the caller names another; "cuda" without a card raises).

    scene_shards > 0 builds the primitive-sharded form
    (parallel/scene_shard.py) under a process group of that many ranks
    (parallel/distributed.init_distributed first): the triangles are
    globally SAH-ordered and chunked into that many shards, each with its
    own sub-BVH; this rank keeps its own shard and its shading rows on
    `device`, the scene's triangle table is a one-row stub, and the light
    table's triangle ids follow the padded global order."""
    ranks = None
    if scene_shards and build_bvh:
        from ..parallel.mesh import make_mesh
        ranks = make_mesh()
        if ranks.size != scene_shards:
            raise ValueError(
                f"scene_shards={scene_shards} needs {scene_shards} ranks, one "
                f"a shard, and this process group has {ranks.size}: start "
                f"them with torchrun --nproc_per_node {scene_shards} and call "
                f"parallel.distributed.init_distributed() first")
    device = scene_device(device)
    with open(os.path.join(scene_dir, "scene.json")) as f:
        desc = json.load(f)

    width = _get(desc, "width", 1920)
    height = _get(desc, "height", 1080)
    fov = _get(desc, "fov", 45.0)
    P = matrix.perspective(0.001, 10000.0, width / height, fov)
    if _get(desc, "flipX", 0) == 1:
        P[0, 0] = -P[0, 0]
    V = matrix.look_at(_get_vec3(desc, "from"), _get_vec3(desc, "to"),
                       _get_vec3(desc, "up", (0.0, 1.0, 0.0)))
    cam_to_world = matrix.invert(V)

    tex = _TextureManager()
    mat = _MaterialRows(scene_dir, tex)
    pos_list, n_list, uv_list, mid_list = [], [], [], []
    for inst in desc.get("instances", []):
        if not os.path.isfile(os.path.join(scene_dir, inst["filename"])):
            continue  # missing mesh: skip the instance, keep loading
        mat_id = mat.add(inst)
        if mat_id is None:
            continue
        world = np.asarray(inst.get("world", np.eye(4).ravel()),
                           np.float32).reshape(4, 4)
        nrm_xform = matrix.invert(world).T
        verts_p, verts_n, verts_uv, index_chunks = [], [], [], []
        voffset = 0
        for mesh in load_gem(os.path.join(scene_dir, inst["filename"])):
            p = mesh.positions @ world[:3, :3].T + world[:3, 3]
            n = mesh.normals @ nrm_xform[:3, :3].T
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
            verts_p.append(p.astype(np.float32))
            verts_n.append(n.astype(np.float32))
            verts_uv.append(mesh.uvs)
            index_chunks.append(mesh.indices.astype(np.int64) + voffset)
            voffset += len(p)
        p = np.concatenate(verts_p)
        n = np.concatenate(verts_n)
        uv = np.concatenate(verts_uv)
        idx = np.concatenate(index_chunks).reshape(-1, 3)
        pos_list.append(p[idx])        # (T, 3, 3)
        n_list.append(n[idx])
        uv_list.append(uv[idx])        # (T, 3, 2)
        mid_list.append(np.full(len(idx), mat_id, np.int32))

    if pos_list:
        tp = np.concatenate(pos_list)
        tn = np.concatenate(n_list)
        tuv = np.concatenate(uv_list)
        tmid = np.concatenate(mid_list)
    else:
        tp = np.zeros((0, 3, 3), np.float32)
        tn = np.zeros((0, 3, 3), np.float32)
        tuv = np.zeros((0, 3, 2), np.float32)
        tmid = np.zeros((0,), np.int32)

    e1 = tp[:, 1] - tp[:, 0]
    e2 = tp[:, 2] - tp[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=1)
    keep = area > 0.0  # cull zero-area triangles
    tp, tn, tuv, tmid = tp[keep], tn[keep], tuv[keep], tmid[keep]
    e1, e2, cr, area = e1[keep], e2[keep], cr[keep], area[keep]
    gn = cr / np.maximum(np.linalg.norm(cr, axis=1, keepdims=True), 1e-20)
    # geometric normal agrees with vertex normal 0 (RTBase
    # Triangle::gNormal): emission sidedness and shading key off it
    gn = np.where((gn * tn[:, 0]).sum(axis=1, keepdims=True) >= 0.0,
                  gn, -gn)

    materials = mat.build(device)
    # emissive-material scan -> light table
    em = np.asarray([row["emission"] for row in mat.rows]) \
        if mat.rows else np.zeros((1, 3))
    is_em = em.max(axis=1) > 0.0 if len(em) else np.zeros(0, bool)
    light_tri = np.nonzero(is_em[tmid])[0].astype(np.int32)
    light_le = em[tmid[light_tri]].astype(np.float32)
    light_area = area[light_tri].astype(np.float32)
    lum = (0.2126 * light_le[:, 0] + 0.7152 * light_le[:, 1]
           + 0.0722 * light_le[:, 2])
    light_id = np.full(len(tp), -1, np.int32)
    light_id[light_tri] = np.arange(len(light_tri), dtype=np.int32)

    def t(a, dtype=None, dev=None):
        a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
        return torch.from_numpy(a).to(device if dev is None else dev)

    def v3(a):
        return v3_from_np(a, device)

    lights = LightTable(
        tri=t(light_tri), le=v3(light_le), area=t(light_area),
        power=t(lum * light_area, np.float32),
        p0=v3(tp[light_tri, 0]), e1=v3(e1[light_tri]),
        e2=v3(e2[light_tri]), gn=v3(gn[light_tri]))

    bvh = None
    tri_device = device
    verts = tp      # the bounds' vertices (padding slots are not geometry)
    if ranks is not None and len(tp):
        from ..parallel.scene_shard import build_sharded, place_sharded
        bvh, order = build_sharded(tp, scene_shards, max_leaf=BVH_MAX_LEAF)
        bvh = place_sharded(bvh, ranks, device)
        pad = order < 0
        inv = np.empty(len(tp), np.int64)
        inv[order[~pad]] = np.nonzero(~pad)[0]
        lights = lights._replace(tri=t(inv[light_tri], np.int32))
        # padding slots: degenerate triangles (zero geometry, material 0,
        # no light), the other fields triangle 0's, as the JAX loader's
        safe = np.where(pad, 0, order)
        tp, tn, tuv, tmid = tp[safe], tn[safe], tuv[safe], tmid[safe]
        e1, e2, area, gn = e1[safe], e2[safe], area[safe], gn[safe]
        light_id = light_id[safe]
        tp[pad] = 0.0
        e1[pad] = 0.0
        e2[pad] = 0.0
        area[pad] = 0.0
        tmid[pad] = 0
        light_id[pad] = -1
        # the padded table stays on the host: each rank's shading rows
        # are cut from it and only the one-row stub reaches the device
        tri_device = torch.device("cpu")
    elif build_bvh and len(tp):
        from ..geometry.bvh_native import build as bvh_build
        from ..ops.bvh_kernel import widen
        with span("rtr.load.bvh"):
            bvh, order = bvh_build(tp, max_leaf=BVH_MAX_LEAF, bins=BVH_BINS,
                                   all_axes=True)
            # the 4-wide collapse, as the JAX loader attaches it
            bvh = widen(bvh).to(device)
        # leaves index contiguous ranges of the reordered triangles; the
        # light table's triangle ids follow them
        inv = np.empty(len(order), np.int64)
        inv[order] = np.arange(len(order))
        lights = lights._replace(tri=t(inv[light_tri], np.int32))
        tp, tn, tuv, tmid = tp[order], tn[order], tuv[order], tmid[order]
        e1, e2, area, gn = e1[order], e2[order], area[order], gn[order]
        light_id = light_id[order]

    def tv3(a):
        return v3_from_np(a, tri_device)

    def tt(a, dtype=None):
        return t(a, dtype, tri_device)

    triangles = Triangles(
        p0=tv3(tp[:, 0]), e1=tv3(e1), e2=tv3(e2), gn=tv3(gn),
        n0=tv3(tn[:, 0]), n1=tv3(tn[:, 1]), n2=tv3(tn[:, 2]),
        uv0=tt(tuv[:, 0]), uv1=tt(tuv[:, 1]), uv2=tt(tuv[:, 2]),
        area=tt(area, np.float32), mat_id=tt(tmid, np.int32),
        light_id=tt(light_id))
    if ranks is not None and len(tp):
        from ..parallel.scene_shard import attach_attrs, stub_triangles
        bvh = attach_attrs(bvh, triangles)
        triangles = map_triangles(lambda a: a.to(device),
                                  stub_triangles(triangles))

    envmap_file = _get(desc, "envmap", "")
    if envmap_file:
        from ..lights.envmap import build_envmap
        path = os.path.join(scene_dir, envmap_file)
        # a missing file lights the scene with a constant white map
        env_img = (read_hdr(path) if os.path.isfile(path)
                   else np.ones((2, 4, 3), np.float32))
        background = Background(BG_ENVMAP,
                                V3.of(0.0, 0.0, 0.0, device=device),
                                build_envmap(env_img, device))
    else:
        # black background, power 0, not in the light list
        background = Background(BG_NONE,
                                V3.of(0.0, 0.0, 0.0, device=device))

    if len(verts):
        lo = verts.reshape(-1, 3).min(axis=0)
        hi = verts.reshape(-1, 3).max(axis=0)
    else:
        lo = hi = np.zeros(3, np.float32)
    centre = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - centre))
    bounds = SceneBounds(centre=V3.of(*centre, device=device),
                         radius=t(np.float32(radius)))

    # film area from the projection (RTBase Scene.h:22-32)
    w_lens = 2.0 / P[1, 1]
    h_lens = w_lens * (P[0, 0] / P[1, 1])
    a_film = abs(w_lens * h_lens)
    origin = matrix.mul_point_np(cam_to_world, [0.0, 0.0, 0.0])
    camera = Camera(
        p=t(P), p_inv=t(matrix.invert(P)), cam_to_world=t(cam_to_world),
        world_to_cam=t(V), width=width, height=height,
        origin=V3.of(*origin, device=device), a_film=t(np.float32(a_film)))

    return Scene(triangles=triangles, materials=materials,
                 textures=tex.build_atlas(device), lights=lights,
                 background=background, camera=camera, bounds=bounds,
                 bvh=bvh, edge_mult=_edge_multiplicity(triangles))


def _edge_multiplicity(tris: Triangles) -> torch.Tensor:
    """(3T,) f32: how many triangles share each geometric edge (exact
    endpoint match, orientation-free), on the triangles' device."""
    def np3(v):
        return np.stack([v.x.cpu().numpy(), v.y.cpu().numpy(),
                         v.z.cpu().numpy()], -1)

    p0 = np3(tris.p0)
    p1 = p0 + np3(tris.e1)
    p2 = p0 + np3(tris.e2)
    ends = np.stack([np.stack([p0, p1], 1), np.stack([p1, p2], 1),
                     np.stack([p2, p0], 1)], 1)      # (T, 3, 2, 3)
    t = ends.shape[0]
    flat = ends.reshape(t * 3, 2, 3)
    # canonical endpoint order (lexicographic), then exact-byte keys
    a, b = flat[:, 0], flat[:, 1]
    a_first = ((a[:, 0] < b[:, 0])
               | ((a[:, 0] == b[:, 0])
                  & ((a[:, 1] < b[:, 1])
                     | ((a[:, 1] == b[:, 1]) & (a[:, 2] <= b[:, 2])))))
    lo = np.where(a_first[:, None], a, b)
    hi = np.where(a_first[:, None], b, a)
    keys = np.concatenate([lo, hi], 1).astype(np.float32).view(np.uint8)
    keys = keys.reshape(t * 3, -1)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    return torch.from_numpy(
        counts[inverse.reshape(-1)].astype(np.float32)).to(tris.area.device)
