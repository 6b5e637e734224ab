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
from .types import (BVH_ARRAYS, BVH, Background, Camera, EnvMap, LightTable,
                    MaterialTable, Scene, SceneBounds, TextureAtlas,
                    Triangles, scene_device)


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


def _bvh(b, device):
    """A JAX BVH: the binary tree, and its 4-wide and treelet fields
    where it has them."""
    if b is None:
        return None
    if not hasattr(b, "skip"):
        raise NotImplementedError("sharded BVHs are not ported yet")
    return BVH(**{f: _value(getattr(b, f, None), device)
                  for f in BVH_ARRAYS},
               leaf_max=int(b.leaf_max), depth=int(b.depth))


def scene_from_numpy(tree, device="cuda") -> Scene:
    """JAX scene arrays (numpy leaves, same field names) -> Scene on
    `device` (the card unless the caller names another; "cuda" without a
    card raises)."""
    device = scene_device(device)
    bg = tree.background
    env = None if bg.envmap is None else _fields(EnvMap, bg.envmap, device)
    cam = tree.camera
    return Scene(
        triangles=_fields(Triangles, tree.triangles, device),
        materials=_fields(MaterialTable, tree.materials, device),
        textures=_fields(TextureAtlas, tree.textures, device),
        lights=_fields(LightTable, tree.lights, device),
        background=Background(int(bg.kind), _value(bg.colour, device), env),
        camera=Camera(
            p=_tensor(cam.p, device), p_inv=_tensor(cam.p_inv, device),
            cam_to_world=_tensor(cam.cam_to_world, device),
            world_to_cam=_tensor(cam.world_to_cam, device),
            width=int(cam.width), height=int(cam.height),
            origin=_value(cam.origin, device),
            a_film=_tensor(cam.a_film, device)),
        bounds=_fields(SceneBounds, tree.bounds, device),
        bvh=_bvh(tree.bvh, device),
        edge_mult=_value(tree.edge_mult, device))
