"""Render entry point: progressive per-sample frames accumulated into a Film.

Counterpart of raytracingrenderer_tpu/render.py.  Every sample pass
renders the full pixel grid as one flat ray batch on the scene's device;
pass s uses the key spp_key(PRNGKey(cfg.seed), s), as in the JAX package,
so a film resumes where it stopped and both packages draw the same
random numbers.  The JAX package groups passes into power-of-two chunks
for its compiler; here one loop runs them in order.  Scenes with a BVH
and more than 4096 triangles (or any scene with cfg.wavefront=True)
take the compacting wavefront integrator (integrators/wavefront.py),
as in the JAX package.
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
from .utils.profiling import span


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
    """Refuse every integrator but "path": render, sample_image and the
    gradients (diff.py) trace paths only, where the JAX package's render
    ignores cfg.integrator.  The other integrators run through
    integrators.dispatch.render_with."""
    if cfg.integrator != "path":
        raise NotImplementedError(
            f"integrator={cfg.integrator!r}: render() and the gradients "
            f"run the path tracer only; call "
            f"integrators.dispatch.render_with for the others")


def _use_wavefront(scene: Scene, cfg: RenderConfig) -> bool:
    """Auto policy for the wavefront integrator: BVH-scale scenes, where
    per-bounce traversal dominates, but not a scene-sharded one (every
    rank walks the whole batch there); cfg.wavefront overrides it."""
    if cfg.wavefront is not None:
        return cfg.wavefront
    return (scene.bvh is not None and not scene.sharded
            and scene.triangles.count > 4096)


def pixel_grid(height: int, width: int, device=None):
    """Flat pixel index tensors (x, y) in raster order."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return (xs.reshape(-1).to(torch.float32),
            ys.reshape(-1).to(torch.float32))


def sample_image(scene: Scene, key: rng.Key, cfg: RenderConfig,
                 rows=None) -> torch.Tensor:
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
    radiance = path_mod.trace_radiance(scene, o, d, key, cfg, first)
    return radiance.stacked().reshape(r1 - r0, cam.width, 3)


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
    sample = sample_image
    if _use_wavefront(scene, cfg):
        from .integrators.wavefront import sample_image_wavefront
        sample = sample_image_wavefront
    with torch.no_grad():
        for s in range(start, start + spp):
            with span("rtr.pass"):
                img = sample(scene, rng.spp_key(base, s), cfg)
                film = film_mod.add_sample_image(film, img)
            if on_sample is not None:
                on_sample(s, film)
    return film
