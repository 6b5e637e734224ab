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


@dataclasses.dataclass
class Background:
    kind: int            # BG_NONE / BG_CONST
    colour: V3           # 0-d components, for BG_CONST


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


class Scene(NamedTuple):
    triangles: Triangles
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    background: Background
    camera: Camera
    bounds: SceneBounds
    bvh: None = None                  # the reference walks no tree
    edge_mult: Optional[torch.Tensor] = None  # (3T,) shared-edge counts

    @property
    def num_lights(self) -> int:
        return self.lights.tri.shape[0]

    @property
    def device(self) -> torch.device:
        return self.triangles.area.device


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
