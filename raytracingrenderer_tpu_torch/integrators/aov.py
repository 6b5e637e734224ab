"""Debug/AOV integrators: direct lighting, albedo, view normals.

Counterpart of raytracingrenderer_tpu/integrators/aov.py (RTBase
RayTracer::direct / albedo / viewNormals, Renderer.h:393-407,558-581):
one primary hit per pixel on the scene's device, then one image.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..lights import lights as lights_mod
from ..render import pixel_grid
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene
from .common import compute_direct, shading_data


def _primary(scene: Scene, key: rng.Key, cfg: RenderConfig):
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width, scene.device)
    if cfg.jitter:
        jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, xs.shape, xs.device)
        jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, ys.shape, ys.device)
    else:
        jx = jy = 0.5
    o, d = generate_rays(cam, xs + jx, ys + jy)
    return o, d, intersect.closest_hit(scene, o, d)


def _image(scene: Scene, v: V3) -> torch.Tensor:
    cam = scene.camera
    return v.stacked().reshape(cam.height, cam.width, 3)


def direct_image(scene: Scene, key: rng.Key, cfg: RenderConfig
                 ) -> torch.Tensor:
    """One-bounce direct lighting (Renderer.h:393-407) -> (H, W, 3)."""
    o, d, hit = _primary(scene, key, cfg)
    sh = shading_data(scene, hit, o, d)
    n = o.x.shape[0]
    dev = o.x.device
    found = hit.valid
    is_light = found & sh.mp.is_emissive
    out = vwhere(is_light & (d.dot(sh.gn_raw) < 0.0), sh.mp.emission, 0.0)
    r_pick = rng.uniform(key, 0, rng.LIGHT_PICK, (n,), dev)
    r1 = rng.uniform(key, 0, rng.LIGHT_POS_U, (n,), dev)
    r2 = rng.uniform(key, 0, rng.LIGHT_POS_V, (n,), dev)
    r3 = rng.uniform(key, 0, rng.LIGHT_AUX, (n,), dev)
    direct, _ = compute_direct(scene, sh, found & ~is_light, r_pick, r1, r2,
                               cfg.mis, r3=r3, power=cfg.power_lights)
    return _image(scene, out + direct)


def albedo_image(scene: Scene, key: rng.Key, cfg: RenderConfig
                 ) -> torch.Tensor:
    """Albedo AOV: emissive -> Le, else the material's albedo; a miss ->
    the background (Renderer.h:558-571)."""
    o, d, hit = _primary(scene, key, cfg)
    sh = shading_data(scene, hit, o, d)
    col = vwhere(sh.mp.is_emissive, sh.mp.emission, sh.mp.albedo)
    return _image(scene, vwhere(hit.valid, col,
                                lights_mod.eval_background(scene, d)))


def normals_image(scene: Scene, key: rng.Key, cfg: RenderConfig
                  ) -> torch.Tensor:
    """|shading normal| as RGB; black on a miss (Renderer.h:572-581)."""
    o, d, hit = _primary(scene, key, cfg)
    sh = shading_data(scene, hit, o, d)
    sn = V3(torch.abs(sh.sn.x), torch.abs(sh.sn.y), torch.abs(sh.sn.z))
    return _image(scene, vwhere(hit.valid, sn, 0.0))
