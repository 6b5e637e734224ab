"""Render entry point: progressive per-sample frames accumulated into a Film.

Counterpart of raytracingrenderer_tpu/render.py.  Every sample pass
renders the full pixel grid as one flat ray batch on the scene's device;
pass s uses the key spp_key(PRNGKey(cfg.seed), s), as in the JAX package,
so a film resumes where it stopped and both packages draw the same
random numbers.  The JAX package groups passes into power-of-two chunks
for its compiler; here one loop runs them in order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .config import RenderConfig
from .imaging import film as film_mod
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
    # layered-coat sentinel: the coat lobe only where a material has one
    if bool(scene.materials.coat_thickness.max() > 0.0):
        from .materials.bsdf import COAT
        types = types + (COAT,)
    return dataclasses.replace(cfg, mat_types=types)


def _check_supported(cfg: RenderConfig) -> None:
    later = [name for name, on in (
        ("geom_grads", cfg.geom_grads),
        ("boundary_grads", cfg.boundary_grads),
        ("wavefront=True", cfg.wavefront is True),
        (f"integrator={cfg.integrator!r}", cfg.integrator != "path"))
        if on]
    if later:
        raise NotImplementedError(
            f"not ported yet: {', '.join(later)} (only the forward path "
            f"tracer is)")


def pixel_grid(height: int, width: int, device=None):
    """Flat pixel index tensors (x, y) in raster order."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return (xs.reshape(-1).to(torch.float32),
            ys.reshape(-1).to(torch.float32))


def sample_image(scene: Scene, key: rng.Key, cfg: RenderConfig
                 ) -> torch.Tensor:
    """One radiance sample per pixel -> (H, W, 3)."""
    cfg = specialize_config(cfg, scene)
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width, scene.device)
    if cfg.jitter:
        jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, xs.shape, xs.device)
        jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, ys.shape, ys.device)
    else:
        jx = jy = 0.5  # pixel centres only
    o, d = generate_rays(cam, xs + jx, ys + jy)
    radiance = path_mod.trace_radiance(scene, o, d, key, cfg)
    return radiance.stacked().reshape(cam.height, cam.width, 3)


def render(scene: Scene, cfg: Optional[RenderConfig] = None,
           spp: Optional[int] = None,
           film: Optional[film_mod.Film] = None,
           on_sample: Optional[Callable] = None) -> film_mod.Film:
    """Progressive render: `spp` passes of 1 sample/pixel.

    `film` may carry a previous render's accumulation (resume);
    `on_sample(s, film)` is called after every pass."""
    cfg = cfg or RenderConfig()
    _check_supported(cfg)
    cfg = specialize_config(cfg, scene)
    spp = spp if spp is not None else cfg.spp
    cam = scene.camera
    if film is None:
        film = film_mod.new_film(cam.height, cam.width, scene.device)
    base = rng.PRNGKey(cfg.seed)
    start = int(film.spp)
    with torch.no_grad():
        for s in range(start, start + spp):
            img = sample_image(scene, rng.spp_key(base, s), cfg)
            film = film_mod.add_sample_image(film, img)
            if on_sample is not None:
                on_sample(s, film)
    return film
