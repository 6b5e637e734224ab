"""The control: the reference computed in the next precision below the
configurations' float32, bfloat16.

Every float tensor of the scene, the camera rays and the bounce state
after each bounce is rounded to bfloat16 and carried on in float32 (the
storage precision of a bfloat16 renderer, whose arithmetic a GPU does in
float32).  Rounding goes through `.to()`, so gradients pass it.
"""
from __future__ import annotations

import dataclasses

import torch


def round_bf16(x):
    """x rounded to bfloat16 where it is a float tensor, else x; tuples
    (V3, the scene's tables), dicts and dataclasses mapped through."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            return x.to(torch.bfloat16).to(x.dtype)
        return x
    if isinstance(x, dict):
        return {k: round_bf16(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(round_bf16(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: round_bf16(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def lower_scene(scene):
    """The scene with every float table rounded (the reference's BVH is
    rebuilt by the caller over the rounded triangles)."""
    return scene._replace(**{k: round_bf16(getattr(scene, k))
                             for k in scene._fields if k != "bvh"})
