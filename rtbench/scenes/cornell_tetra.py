"""The cornell box with Haines' fractal tetrahedron in place of its two
blocks, written as `.gem` + `scene.json` + constant PNGs.

Geometry: the `tetra` scene of E. Haines' Standard Procedural Databases
("A Proposal for Standard Graphics Environments", IEEE CG&A 7(11), 1987),
after Mandelbrot's fractal tetrahedron: each tetrahedron is replaced by
its four half-size copies, each scaled by 1/2 about one of its vertices,
`depth` times.  Depth 8 gives 4^8 = 65,536 tetrahedra, written as their
4 outward faces each: 262,144 triangles.

The tetrahedron is regular with edge 1.2: its base face lies in the
plane y = 0.002 (so no face is coplanar with the floor), its apex points
up, the base face's centroid is at (x, z) = (0, -0.15) and one base
vertex points at the back wall.  It stands in the published Cornell Box
room, lit by the box's light (`cornell.py`: the five walls and the light
quad, the frame and the camera), as one instance with its own diffuse
material of the box's white.  So the scene has 4^(depth+1) + 12
triangles and 7 materials, one an instance: five walls, the light, the
tetrahedron.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from rtbench.harness import load_module

cornell = load_module(Path(__file__).resolve().parent / "cornell.py",
                      "rtbench_scene_cornell")

EDGE = 1.2
BASE_Y = 0.002
BASE_CENTRE = (0.0, -0.15)        # (x, z) of the base face's centroid
DEPTH = 8


def tetrahedron():
    """The four vertices (4, 3), float64: v0 the base vertex toward the
    back wall (-z), v1 and v2 the other base vertices, v3 the apex."""
    r = EDGE / np.sqrt(3.0)                   # the base's circumradius
    cx, cz = BASE_CENTRE
    base = [(cx + r * np.sin(a), BASE_Y, cz - r * np.cos(a))
            for a in (0.0, 2.0 * np.pi / 3.0, 4.0 * np.pi / 3.0)]
    apex = (cx, BASE_Y + EDGE * np.sqrt(2.0 / 3.0), cz)
    return np.asarray(base + [apex], np.float64)


def leaves(depth: int) -> np.ndarray:
    """The 4^depth tetrahedra of the recursion, (4^depth, 4, 3) float64:
    child i of (v0, v1, v2, v3) is (v_i, (v_i + v_j) / 2 for j != i)."""
    tets = tetrahedron()[None]
    for _ in range(depth):
        mid = 0.5 * (tets[:, :, None, :] + tets[:, None, :, :])  # (n,4,4,3)
        kids = [np.stack([tets[:, i]] + [mid[:, i, j] for j in range(4)
                                         if j != i], axis=1)
                for i in range(4)]
        tets = np.stack(kids, axis=1).reshape(-1, 4, 3)
    return tets


def faces(tets: np.ndarray):
    """The 4 faces of each tetrahedron wound outward: (positions
    (4 n, 3, 3), face normals (4 n, 3)), float64, face k of a leaf
    opposite its vertex k."""
    tris = []
    for k in range(4):
        a, b, c = (tets[:, j] for j in range(4) if j != k)
        n = np.cross(b - a, c - a)
        inward = np.einsum("ij,ij->i", n, tets[:, k] - a) > 0.0
        b2 = np.where(inward[:, None], c, b)
        c2 = np.where(inward[:, None], b, c)
        tris.append(np.stack([a, b2, c2], axis=1))
    pos = np.stack(tris, axis=1).reshape(-1, 3, 3)
    n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    return pos, n / np.linalg.norm(n, axis=1, keepdims=True)


def write(scene_dir, width, height, depth: int = DEPTH):
    """Write the scene into `scene_dir`; returns `scene_dir`."""
    os.makedirs(scene_dir, exist_ok=True)
    for name, rgb in (("white", cornell.WHITE), ("red", cornell.RED),
                      ("green", cornell.GREEN)):
        cornell.write_png_1x1(os.path.join(scene_dir, f"{name}.png"), rgb)
    colour = {"red": "red.png", "green": "green.png"}
    meshes = [(name, fs) for name, fs in cornell.cornell_meshes()
              if name not in ("short_block", "tall_block")]
    instances = []
    for name, fs in meshes:
        cornell.write_gem(os.path.join(scene_dir, f"{name}.gem"), fs)
        inst = {"filename": f"{name}.gem", "bsdf": "diffuse",
                "reflectance": colour.get(name, "white.png")}
        if name == "light":
            inst["emission"] = cornell.LE
        instances.append(inst)
    pos, nrm = faces(leaves(int(depth)))
    cornell.write_gem(os.path.join(scene_dir, "tetra.gem"),
                      [(pos.reshape(-1, 3), None)],
                      vertex_normals=np.repeat(nrm, 3, axis=0))
    instances.append({"filename": "tetra.gem", "bsdf": "diffuse",
                      "reflectance": "white.png"})
    desc = {"width": width, "height": height, "fov": 19.5,
            "from": "0 1 6.8", "to": "0 1 0", "up": "0 1 0",
            "instances": instances}
    with open(os.path.join(scene_dir, "scene.json"), "w") as f:
        json.dump(desc, f, indent=1)
    return scene_dir
