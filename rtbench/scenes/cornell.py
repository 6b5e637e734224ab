"""The cornell box, written as `.gem` + `scene.json` + constant PNGs (a
frozen copy of the repository's test-scene writer, so that the scenes
the benchmark measures do not change with it).

The geometry follows the published Cornell Box data (Cornell University
Program of Computer Graphics, "Cornell Box Data": a 556 x 548.8 x 559.2 mm
room with a short and a tall block and a 130 x 105 mm light), mapped onto
the frame of RTBase's cornell-box scene: the room spans x, z in [-1, 1]
and y in [0, 2], the open side faces +z and the camera sits at
(0, 1, 6.8) looking toward -z.  The light keeps the published centre but
is sized 0.47 x 0.38 (area 0.1786), the emitter of that scene, and hangs
at y = 1.98 just below the ceiling.

36 triangles (five walls, two blocks of six faces, a light quad), 8
all-diffuse materials, wall albedo (184, 181, 173)/255, a red wall
(0.63, 0.065, 0.05), two emissive triangles with Le (17, 12, 4).
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


def write(scene_dir, width, height):
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
