"""Binary `.gem` mesh loader (numpy, host-side).

Carried over unchanged from raytracingrenderer_tpu/scene/gem.py.  Format
of the RTBase renderer's GEM loader (GEMLoader.h:218-411, vendored MIT
GEM loader; reimplemented from its observable layout):

  u32 magic = 4058972161
  u32 isAnimated
  u32 meshCount
  per mesh:
    u32 propCount; per prop: (i32 len, bytes name, i32 len, bytes value)
    u32 vertCount; vertices:
        static:   pos(3f) normal(3f) tangent(3f) u,v      = 44 bytes
        animated: static + 4*u32 boneIDs + 4*f32 weights  = 76 bytes
    u32 indexCount; u32 indices[]

Everything is little-endian.  Skeleton/animation trailer (animated models)
is parsed but ignored by the renderer, as in the reference.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

GEM_MAGIC = 4058972161


@dataclass
class GemMesh:
    properties: Dict[str, str]
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    tangents: np.ndarray   # (V, 3) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (I,) u32


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.data[self.pos:self.pos + n]
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def bytes_(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b


def load_gem(path: str) -> List[GemMesh]:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u32() != GEM_MAGIC:
        raise ValueError(f"{path}: not a GEM model file")
    is_animated = r.u32()
    mesh_count = r.u32()
    meshes: List[GemMesh] = []
    vstride = 76 if is_animated else 44
    for _ in range(mesh_count):
        props = {}
        for _ in range(r.u32()):
            name = r.string()
            props[name] = r.string()
        nverts = r.u32()
        vdata = np.frombuffer(r.bytes_(nverts * vstride), np.uint8)
        vdata = vdata.reshape(nverts, vstride) if nverts else vdata.reshape(0, vstride)
        fdata = vdata[:, :44].copy().view(np.float32).reshape(-1, 11)
        nidx = r.u32()
        idx = np.frombuffer(r.bytes_(nidx * 4), np.uint32).copy()
        meshes.append(GemMesh(
            properties=props,
            positions=fdata[:, 0:3].copy(),
            normals=fdata[:, 3:6].copy(),
            tangents=fdata[:, 6:9].copy(),
            uvs=fdata[:, 9:11].copy(),
            indices=idx,
        ))
    return meshes
