"""In-repo test scenes, written as `.gem` + `scene.json` + constant PNGs:
the cornell box (`write_cornell`) and the cornell box with 16 icospheres
(`write_spheres`, 5,156 to 327,716 triangles, for the BVH path).

A numpy-only helper (no JAX, no torch) shared by the JAX package's loader,
the PyTorch port's loader and the port's card tests, so that both
packages read the same scene from disk.

The geometry follows the published Cornell Box data (Cornell University
Program of Computer Graphics, "Cornell Box Data": a 556 x 548.8 x 559.2 mm
room with a short and a tall block and a 130 x 105 mm light), mapped onto
the frame of the renderer's reference cornell-box scene: the room spans
x, z in [-1, 1] and y in [0, 2], the open side faces +z and the camera
sits at (0, 1, 6.8) looking toward -z.  The light keeps the published
centre but is sized 0.47 x 0.38 (area 0.1786), the emitter of that
reference scene, and hangs at y = 1.98 just below the ceiling.

Facts the scene pins (as the reference cornell-box does): 36 triangles
(five walls, two blocks of six faces, a light quad), 8 all-diffuse
materials, wall albedo (184, 181, 173)/255, a red wall (0.63, 0.065,
0.05), two emissive triangles with Le (17, 12, 4).
"""
from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

GEM_MAGIC = 4058972161

WHITE = (184, 181, 173)           # = (0.7216, 0.7098, 0.6784)
RED = (161, 17, 13)               # = (0.63, 0.065, 0.05) in 8 bits
GREEN = (36, 115, 23)             # = (0.14, 0.45, 0.091) in 8 bits
LE = "17 12 4"

_SX = 2.0 / 556.0                 # published x extent -> [-1, 1]
_SY = 2.0 / 548.8                 # published y extent -> [0, 2]
_SZ = 2.0 / 559.2                 # published z extent -> [-1, 1]


def _map(p):
    """Published Cornell coordinates (mm) -> scene frame.  The published
    camera looks down +z; x and z flip so that ours looks down -z with
    the red wall still on the left."""
    x, y, z = p
    return (-(x - 278.0) * _SX, y * _SY, -(z - 279.6) * _SZ)


# Published quads (mm), each four corners in order around the face.
_WALLS = {
    "floor": [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2),
              (549.6, 0.0, 559.2)],
    "ceiling": [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2),
                (0.0, 548.8, 559.2), (0.0, 548.8, 0.0)],
    "back": [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2),
             (556.0, 548.8, 559.2)],
    "green": [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0),
              (0.0, 548.8, 559.2)],
    "red": [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2),
            (556.0, 548.8, 0.0)],
}
_SHORT = [(130.0, 65.0), (82.0, 225.0), (240.0, 272.0), (290.0, 114.0)]
_TALL = [(423.0, 247.0), (265.0, 296.0), (314.0, 456.0), (472.0, 406.0)]
_SHORT_H, _TALL_H = 165.0, 330.0
_LIGHT_CENTRE = (278.0, 279.5)    # published light centre (x, z), mm
_LIGHT_SIZE = (0.47, 0.38)        # scene units
_LIGHT_Y = 1.98

_ROOM_CENTRE = np.array([0.0, 1.0, 0.0])


def _quad_tris(corners, toward):
    """Two triangles of a planar quad, wound so that their normal points
    along `toward`; returns (positions (6, 3), normal (3,))."""
    c = np.asarray(corners, np.float64)
    n = np.cross(c[1] - c[0], c[2] - c[0])
    n /= np.linalg.norm(n)
    if np.dot(n, toward) < 0.0:
        c = c[::-1]
        n = -n
    return c[[0, 1, 2, 0, 2, 3]], n


def _block(footprint, height):
    """Six faces of a block with outward normals."""
    base = [_map((x, 0.0, z)) for x, z in footprint]
    top = [_map((x, height, z)) for x, z in footprint]
    centre = np.mean(np.asarray(base + top), axis=0)
    faces = [top, base]
    for i in range(4):
        j = (i + 1) % 4
        faces.append([base[i], base[j], top[j], top[i]])
    return [_quad_tris(f, np.mean(np.asarray(f), axis=0) - centre)
            for f in faces]


def cornell_meshes():
    """-> list of (name, [(positions (6, 3), normal (3,)), ...])."""
    meshes = []
    for name, quad in _WALLS.items():
        corners = [_map(p) for p in quad]
        toward = _ROOM_CENTRE - np.mean(np.asarray(corners), axis=0)
        meshes.append((name, [_quad_tris(corners, toward)]))
    meshes.append(("short_block", _block(_SHORT, _SHORT_H)))
    meshes.append(("tall_block", _block(_TALL, _TALL_H)))
    cx, _, cz = _map((_LIGHT_CENTRE[0], 0.0, _LIGHT_CENTRE[1]))
    hx, hz = _LIGHT_SIZE[0] / 2.0, _LIGHT_SIZE[1] / 2.0
    light = [(cx - hx, _LIGHT_Y, cz - hz), (cx + hx, _LIGHT_Y, cz - hz),
             (cx + hx, _LIGHT_Y, cz + hz), (cx - hx, _LIGHT_Y, cz + hz)]
    meshes.append(("light", [_quad_tris(light, (0.0, -1.0, 0.0))]))
    return meshes


def write_gem(path, faces, vertex_normals=None):
    """One static mesh of the given (positions (k, 3), normal) face groups
    (three rows per triangle): 44-byte vertices (position, normal,
    tangent, uv), u32 indices.  Each group's normal goes to all its
    vertices, unless `vertex_normals` (one row per position row) is
    given."""
    pos = np.concatenate([p for p, _ in faces]).astype(np.float32)
    if vertex_normals is not None:
        nrm = np.asarray(vertex_normals, np.float32)
    else:
        nrm = np.concatenate([np.repeat(n[None], len(p), 0)
                              for p, n in faces]).astype(np.float32)
    verts = np.zeros((len(pos), 11), np.float32)
    verts[:, 0:3] = pos
    verts[:, 3:6] = nrm
    verts[:, 6] = 1.0                      # tangent, unused by the renderer
    idx = np.arange(len(pos), dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", GEM_MAGIC, 0, 1))
        f.write(struct.pack("<I", 0))      # no mesh properties
        f.write(struct.pack("<I", len(verts)))
        f.write(verts.tobytes())
        f.write(struct.pack("<I", len(idx)))
        f.write(idx.tobytes())


def write_png_1x1(path, rgb):
    """A 1x1 8-bit RGB PNG of one colour."""
    def chunk(tag, payload):
        crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", crc))
    ihdr = struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0)
    idat = zlib.compress(bytes([0, *rgb]))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def write_cornell(scene_dir, width=1024, height=1024):
    """Write the cornell box into `scene_dir`; returns `scene_dir`."""
    os.makedirs(scene_dir, exist_ok=True)
    for name, rgb in (("white", WHITE), ("red", RED), ("green", GREEN)):
        write_png_1x1(os.path.join(scene_dir, f"{name}.png"), rgb)
    colour = {"red": "red.png", "green": "green.png"}
    instances = []
    for name, faces in cornell_meshes():
        write_gem(os.path.join(scene_dir, f"{name}.gem"), faces)
        inst = {"filename": f"{name}.gem", "bsdf": "diffuse",
                "reflectance": colour.get(name, "white.png")}
        if name == "light":
            inst["emission"] = LE
        instances.append(inst)
    desc = {"width": width, "height": height, "fov": 19.5,
            "from": "0 1 6.8", "to": "0 1 0", "up": "0 1 0",
            "instances": instances}
    with open(os.path.join(scene_dir, "scene.json"), "w") as f:
        json.dump(desc, f, indent=1)
    return scene_dir


# Sphere grid of write_spheres: 4 x 4 centres in x, z, one height.
_SPHERE_XZ = (-0.6, -0.2, 0.2, 0.6)
_SPHERE_Y = 1.45
_SPHERE_R = 0.17


def icosphere(subdiv):
    """Unit icosphere: an icosahedron whose faces are split in four
    `subdiv` times, new vertices pushed onto the sphere.  Returns
    (vertices (V, 3) f64, faces (20 * 4**subdiv, 3) int64), faces wound
    outward."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                  [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                  [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]], float)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                  [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                  [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        # one new vertex per edge, shared by the two faces of the edge
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        key = np.sort(edges, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(3, -1)       # (3, F): a-b, b-c, c-a
        v = np.concatenate([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = m[0], m[1], m[2]
        f = np.concatenate([np.stack([a, ab, ca], 1),
                            np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1),
                            np.stack([ab, bc, ca], 1)])
    return v, f


def write_spheres(scene_dir, width=1024, height=1024, subdiv=5):
    """The cornell box plus 16 diffuse icospheres (20 * 4**subdiv
    triangles each, per-vertex normals) in a 4 x 4 grid above its floor,
    alternating the box's white and green reflectances.  subdiv=5 gives
    327,716 triangles (about the bathroom's size), subdiv=2 gives 5,156.
    Returns `scene_dir`."""
    write_cornell(scene_dir, width, height)
    v, f = icosphere(subdiv)
    corners = v[f].reshape(-1, 3)             # three rows per triangle
    with open(os.path.join(scene_dir, "scene.json")) as fh:
        desc = json.load(fh)
    for i in range(16):
        cx, cz = _SPHERE_XZ[i % 4], _SPHERE_XZ[i // 4]
        pos = corners * _SPHERE_R + [cx, _SPHERE_Y, cz]
        name = f"sphere{i:02d}.gem"
        write_gem(os.path.join(scene_dir, name), [(pos, None)],
                  vertex_normals=corners)
        desc["instances"].append({
            "filename": name, "bsdf": "diffuse",
            "reflectance": "white.png" if (i + i // 4) % 2 == 0
            else "green.png"})
    with open(os.path.join(scene_dir, "scene.json"), "w") as fh:
        json.dump(desc, fh, indent=1)
    return scene_dir


# Sun of write_sky's map: its direction in the map's (u, v) and its disc.
_SUN_UV = (0.125, 0.25)           # azimuth 45 deg toward +x +z, 45 deg up
_SUN_TEXELS = 3.0                 # disc radius in texel rows
_SUN_GAIN = 1000.0                # the disc's radiance over the zenith's


def sky_map(env_h, env_w):
    """A synthetic lat-long sky (env_h, env_w, 3) float32 in the
    renderer's convention (v = acos(y) / pi down the rows, u = atan2(z, x)
    / 2 pi across): a smooth gradient from a blue zenith to a pale
    horizon over a dim brown ground, and a sun disc of a few texels at
    about 10^3 times the zenith's radiance, so that importance sampling
    matters.  Rows are constant apart from the sun."""
    v = (np.arange(env_h) + 0.5) / env_h
    u = (np.arange(env_w) + 0.5) / env_w
    elev = np.cos(v * np.pi)                   # y of each row
    zenith = np.array([0.04, 0.08, 0.18])
    horizon = np.array([0.18, 0.20, 0.22])
    ground = np.array([0.03, 0.024, 0.016])
    t = np.clip(elev, 0.0, 1.0)[:, None] ** 0.5
    rows = np.where(elev[:, None] > 0.0, horizon + (zenith - horizon) * t,
                    ground)
    img = np.repeat(rows[:, None, :], env_w, axis=1)
    # the sun: texels within _SUN_TEXELS rows' angle of its direction
    su, sv = _SUN_UV
    sun = np.array([np.sin(sv * np.pi) * np.cos(su * 2 * np.pi),
                    np.cos(sv * np.pi),
                    np.sin(sv * np.pi) * np.sin(su * 2 * np.pi)])
    phi, theta = u[None, :] * 2 * np.pi, v[:, None] * np.pi
    dirs = np.stack([np.sin(theta) * np.cos(phi),
                     np.broadcast_to(np.cos(theta), (env_h, env_w)),
                     np.sin(theta) * np.sin(phi)], axis=-1)
    ang = np.arccos(np.clip(dirs @ sun, -1.0, 1.0))
    disc = ang <= _SUN_TEXELS * np.pi / env_h
    img[disc] = zenith.max() * _SUN_GAIN * np.array([1.0, 0.95, 0.85])
    return img.astype(np.float32)


def write_sky(scene_dir, width=1024, height=1024, subdiv=5, env_h=1024,
              env_w=2048):
    """The 16 icospheres of write_spheres above the cornell box's floor
    quad (no walls, no area light), lit only by sky_map(env_h, env_w)
    written as sky.hdr (through the port's io/hdr.write_hdr, numpy
    only).  subdiv=5 gives 327,682 triangles, subdiv=2 5,122.  Returns
    `scene_dir`."""
    from raytracingrenderer_tpu_torch.io.hdr import write_hdr
    write_spheres(scene_dir, width, height, subdiv)
    with open(os.path.join(scene_dir, "scene.json")) as fh:
        desc = json.load(fh)
    desc["instances"] = [i for i in desc["instances"]
                         if i["filename"] == "floor.gem"
                         or i["filename"].startswith("sphere")]
    write_hdr(os.path.join(scene_dir, "sky.hdr"), sky_map(env_h, env_w))
    desc["envmap"] = "sky.hdr"
    with open(os.path.join(scene_dir, "scene.json"), "w") as fh:
        json.dump(desc, fh, indent=1)
    return scene_dir


PAIR_PATTERNS = ("one", "each", "runs", "sentinel_tail", "sentinel_mid",
                 "equal_t")
PAIR_SENTINEL = 0x7FFFFF


def pair_case(p, pattern, seed=0):
    """Synthetic inputs of the treelet pair test at the shapes its
    partition could break -> (consts (K*16, 128) f32, feats (P, 16) f32,
    tid (P,) i32), numpy arrays in the layout of `pack_constants`,
    `_feats` and the sorted pair ids.  Patterns: "one" treelet for every
    pair; "each": a new treelet every pair; "runs" of 1 to 5 pairs a
    treelet; "sentinel_tail": the last tenth (at least one pair) keyed
    to the sentinel; "sentinel_mid": ids out of range (the sentinel, -1
    and K) strewn through the middle; "equal_t": one treelet whose
    columns 9, 70 and 71 repeat the triangle of column 5 (a large one
    that many rays hit first), so that equal t meet at several columns.
    Each treelet has 100 to 128 triangles around the origin (the other
    columns are zero) and each ray starts near the origin with a radius
    of 0.3 to 4."""
    g = np.random.default_rng([seed, p, PAIR_PATTERNS.index(pattern)])
    if pattern in ("one", "equal_t"):
        tid = np.full(p, 3)
    elif pattern == "each":
        tid = np.arange(p)
    else:
        tid = np.repeat(np.arange(p), g.integers(1, 6, p))[:p]
    k = max(int(tid.max()) + 1, 4)
    if pattern == "sentinel_tail":
        tid[p - max(p // 10, 1):] = PAIR_SENTINEL
    if pattern == "sentinel_mid":
        bad = g.random(p) < 0.2
        bad[p // 2] = True
        tid[bad] = g.choice([PAIR_SENTINEL, -1, k], int(bad.sum()))
    p0 = g.uniform(-1, 1, (k, 128, 3)).astype(np.float32)
    e1 = (g.standard_normal((k, 128, 3)) * 0.6).astype(np.float32)
    e2 = (g.standard_normal((k, 128, 3)) * 0.6).astype(np.float32)
    if pattern == "equal_t":
        # a large triangle just above the rays' origins: many rays' nearest
        p0[:, 5], e1[:, 5], e2[:, 5] = (-2, -2, 0.5), (8, 0, 0), (0, 8, 0)
        for a in (p0, e1, e2):
            a[:, 9] = a[:, 5]
            a[:, 70] = a[:, 5]
            a[:, 71] = a[:, 70]
    n = np.cross(e1, e2)
    rows = np.concatenate([n, e1, e2, np.cross(p0, e1), np.cross(p0, e2),
                           (p0 * n).sum(-1, keepdims=True)], axis=-1)
    filled = np.arange(128)[None, :] < g.integers(100, 129, k)[:, None]
    rows = np.where(filled[..., None], rows, 0.0).astype(np.float32)
    consts = np.ascontiguousarray(rows.transpose(0, 2, 1)).reshape(k * 16,
                                                                   128)
    o = g.uniform(-0.3, 0.3, (p, 3)).astype(np.float32)
    d = g.standard_normal((p, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    feats = np.zeros((p, 16), np.float32)
    feats[:, 0:3], feats[:, 3:6], feats[:, 6:9] = d, o, np.cross(o, d)
    feats[:, 9] = 1.0
    feats[:, 10] = g.uniform(0.3, 4.0, p)
    return consts, feats, tid.astype(np.int32)
