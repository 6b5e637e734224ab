"""One sample pass of the path tracer over the pixel grid (or a band of
its rows), the frozen copy of the renderer's scan route: every pixel's
jitter and path numbers keyed by its index in the whole image, pass s by
spp_key(PRNGKey(cfg.seed), s), so the reference draws the renderer's
random numbers."""
from __future__ import annotations

import dataclasses

import torch

from .config import RenderConfig
from .integrators import path as path_mod
from .sampling import rng
from .scene.camera import generate_rays
from .scene.types import Scene


def specialize_config(cfg: RenderConfig, scene: Scene) -> RenderConfig:
    """Fill cfg.mat_types with the material types the scene uses, so the
    BSDF evaluates only those lobes (materials/bsdf.py:_has)."""
    if cfg.mat_types is not None:
        return cfg
    types = tuple(sorted(set(scene.materials.mtype.tolist())))
    return dataclasses.replace(cfg, mat_types=types)


def _check_supported(cfg: RenderConfig) -> None:
    """Refuse every integrator but "path": the reference traces paths
    only."""
    if cfg.integrator != "path":
        raise NotImplementedError(
            f"integrator={cfg.integrator!r}: the reference runs the path "
            f"tracer only")


def pixel_grid(height: int, width: int, device=None):
    """Flat pixel index tensors (x, y) in raster order."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return (xs.reshape(-1).to(torch.float32),
            ys.reshape(-1).to(torch.float32))


def sample_image(scene: Scene, key: rng.Key, cfg: RenderConfig,
                 rows=None, post=None) -> torch.Tensor:
    """One radiance sample per pixel -> (H, W, 3).  `rows` = (r0, r1)
    renders that band of rows alone -> (r1 - r0, W, 3), equal bit for
    bit to those rows of the whole image: its pixels draw their jitter
    and their paths' numbers by their index in the whole image."""
    cfg = specialize_config(cfg, scene)
    cam = scene.camera
    r0, r1 = (0, cam.height) if rows is None else rows
    xs, ys = pixel_grid(r1 - r0, cam.width, scene.device)
    ys = ys + float(r0)
    first = r0 * cam.width
    if cfg.jitter:
        jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, xs.shape, xs.device,
                         first)
        jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, ys.shape, ys.device,
                         first)
    else:
        jx = jy = 0.5  # pixel centres only
    o, d = generate_rays(cam, xs + jx, ys + jy)
    if post is not None:
        rays = post(dict(o=o, d=d))
        o, d = rays["o"], rays["d"]
    radiance = path_mod.trace_radiance(scene, o, d, key, cfg, first, post)
    return radiance.stacked().reshape(r1 - r0, cam.width, 3)
