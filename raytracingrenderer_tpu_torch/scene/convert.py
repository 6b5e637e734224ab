"""Carry a scene's arrays across from the JAX package.

`scene_from_numpy` takes the JAX `Scene`'s arrays as numpy, with the same
field names (for example `jax.tree_util.tree_map(np.asarray, scene)`),
and returns this package's `Scene` on `device`.  It only reads
attributes by name, so this package never imports JAX; it lets every
parity test feed identical scene data to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.vec import V3
from .types import (Background, Camera, LightTable, MaterialTable, Scene,
                    SceneBounds, TextureAtlas, Triangles)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _value(x, device):
    if x is None:
        return None
    if getattr(x, "_fields", None) == ("x", "y", "z"):
        return V3(*(_tensor(c, device) for c in x))
    return _tensor(x, device)


def _fields(cls, src, device):
    return cls(**{f: _value(getattr(src, f, None), device)
                  for f in cls._fields})


def scene_from_numpy(tree, device="cpu") -> Scene:
    """JAX scene arrays (numpy leaves, same field names) -> Scene."""
    device = torch.device(device)
    if tree.bvh is not None:
        raise NotImplementedError(
            "the BVH slice is not ported yet; load the JAX scene with "
            "build_bvh=False")
    bg = tree.background
    if bg.envmap is not None:
        raise NotImplementedError("environment maps are not ported yet")
    cam = tree.camera
    return Scene(
        triangles=_fields(Triangles, tree.triangles, device),
        materials=_fields(MaterialTable, tree.materials, device),
        textures=_fields(TextureAtlas, tree.textures, device),
        lights=_fields(LightTable, tree.lights, device),
        background=Background(int(bg.kind), _value(bg.colour, device)),
        camera=Camera(
            p=_tensor(cam.p, device), p_inv=_tensor(cam.p_inv, device),
            cam_to_world=_tensor(cam.cam_to_world, device),
            world_to_cam=_tensor(cam.world_to_cam, device),
            width=int(cam.width), height=int(cam.height),
            origin=_value(cam.origin, device),
            a_film=_tensor(cam.a_film, device)),
        bounds=_fields(SceneBounds, tree.bounds, device),
        bvh=None,
        edge_mult=_value(tree.edge_mult, device))
