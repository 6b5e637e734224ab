"""Integrator dispatch: cfg.integrator -> progressive render loop.

Counterpart of raytracingrenderer_tpu/integrators/dispatch.py (RTBase
switches integrators by editing RayTracer::render, Renderer.h:876-885).
One Python loop over passes replaces the JAX package's jitted pass; pass
s draws its numbers from spp_key(PRNGKey(cfg.seed), s), so a film
resumes where it stopped and both packages draw the same numbers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import RenderConfig
from ..imaging import film as film_mod
from ..sampling import rng
from ..scene.types import Scene


def _pass_fn(cfg: RenderConfig, n_paths: int) -> Callable:
    """(scene, film, key) -> film for one pass of cfg.integrator."""
    if cfg.integrator in ("direct", "albedo", "normals"):
        from . import aov
        fn = {"direct": aov.direct_image, "albedo": aov.albedo_image,
              "normals": aov.normals_image}[cfg.integrator]
        return lambda sc, f, k: film_mod.add_sample_image(f, fn(sc, k, cfg))
    if cfg.integrator == "lighttrace":
        from .lighttracer import light_trace_pass
        return lambda sc, f, k: light_trace_pass(sc, f, k, cfg, n_paths)
    if cfg.integrator == "vpl":
        from .vpl import vpl_pass
        return lambda sc, f, k: vpl_pass(sc, f, k, cfg)
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def render_with(scene: Scene, cfg: RenderConfig, spp: int,
                film: Optional[film_mod.Film] = None,
                on_sample: Optional[Callable] = None) -> film_mod.Film:
    """`spp` passes of cfg.integrator ("direct", "albedo", "normals",
    "lighttrace": width * height light paths a pass, "vpl") into `film`
    (a new one on the scene's device by default); `on_sample(s, film)`
    after every pass.  "adaptive" spends a budget of `spp` samples a
    pixel through integrators.adaptive.adaptive_render.  The path tracer
    is render.render's."""
    from ..render import specialize_config
    cam = scene.camera
    if film is None:
        film = film_mod.new_film(cam.height, cam.width, scene.device)
    if cfg.integrator == "adaptive":
        from .adaptive import adaptive_render
        return adaptive_render(scene, cfg, total_spp=spp, film=film,
                               on_sample=on_sample)
    # the scene's material set: the BSDF evaluates only the lobes present,
    # with the same values
    pass_fn = _pass_fn(specialize_config(cfg, scene), cam.height * cam.width)
    base = rng.PRNGKey(cfg.seed)
    start = int(film.spp)
    with torch.no_grad():
        for s in range(start, start + spp):
            film = pass_fn(scene, film, rng.spp_key(base, s))
            if on_sample is not None:
                on_sample(s, film)
    return film
