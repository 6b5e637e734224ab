"""Compacting wavefront path tracer: a host-level bounce loop that packs
the live rays to the front and shrinks the batch to a width bucket.

Counterpart of raytracingrenderer_tpu/integrators/wavefront.py.  The
scan-mode integrator (path.trace_radiance) pays the full batch width at
every bounce, though Russian roulette and escapes kill most rays after
a couple of bounces.  Here, before every bounce after the first:

  sort the state by the coherence key (live rays first), add the
  radiance of dead rays into the image and zero it (`_sort_flush`)
  -> read the live count, slice the live prefix to the next width
     bucket (`_bucket`)
  -> bounce_step at that width, `presorted`

The sort doubles as the traversal's coherence sort, so the closest-hit
dispatch skips its own.  A ray's radiance reaches the image once, when
it dies (then it is zeroed, so a dead ray kept by the bucket rounding
adds nothing twice), and the rest at the end (`_final_flush`).  Every
random decision is keyed by the pixel id, so the image is the scan
integrator's image: the same paths in another lane order.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.vec import V3
from ..geometry import intersect
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene
from ..utils import profiling
from . import path as path_mod

# Bucket widths are multiples of n/16 with a floor of n/8 (and of
# _MIN_WIDTH), as in the JAX package: few distinct widths, which bounds
# the number of shapes a captured bounce graph would need.
_MIN_WIDTH = 1 << 15


def _bucket(n_live: int, n: int) -> int:
    step = max(_MIN_WIDTH, n // 16)
    floor = max(_MIN_WIDTH, n // 8)
    w = max(((n_live + step - 1) // step) * step, floor)
    return min(w, n)


def _map(state: dict, fn) -> dict:
    """fn applied to every per-ray tensor of the state (V3 componentwise)."""
    return {k: V3(*map(fn, v)) if isinstance(v, V3) else fn(v)
            for k, v in state.items()}


@profiling.spanned("rtr.compact")
def _sort_flush(scene: Scene, img: torch.Tensor, state: dict):
    """Add the radiance of dead rays into `img` (in place) and zero it,
    sort the state by the coherence key (live rays first, stable) and
    count the live rays."""
    alive = state["alive"]
    dead_rgb = torch.where(alive[:, None], 0.0, state["radiance"].stacked())
    img.index_add_(0, state["ids"], dead_rgb)
    state = dict(state, radiance=V3(*(torch.where(alive, c, 0.0)
                                      for c in state["radiance"])))
    key = intersect._sort_key(scene, state["o"], state["d"], alive)
    perm = torch.sort(key, stable=True).indices
    return img, _map(state, lambda a: a[perm]), int(alive.sum())


def _final_flush(img: torch.Tensor, state: dict) -> torch.Tensor:
    return img.index_add_(0, state["ids"], state["radiance"].stacked())


def sample_image_wavefront(scene: Scene, key: rng.Key, cfg: RenderConfig
                           ) -> torch.Tensor:
    """One radiance sample per pixel -> (H, W, 3); the image of
    render.sample_image, with per-bounce live-ray compaction.  Inside
    profiling.counting(), each bounce adds its width to `lanes` and the
    live count it was cut to to `live` (both known on the host here)."""
    from ..render import pixel_grid, specialize_config
    cfg = specialize_config(cfg, scene)
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width, scene.device)
    if cfg.jitter:
        jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, xs.shape, xs.device)
        jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, ys.shape, ys.device)
    else:
        jx = jy = 0.5
    o, d = generate_rays(cam, xs + jx, ys + jy)
    n = cam.height * cam.width
    state = path_mod.init_state(o, d)
    img = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
    w = n_live = n
    counts = profiling.counts()
    for depth in range(cfg.max_depth + 2):
        # primaries skip the sort: every ray is live and the raster order
        # is as coherent as the sort would make it
        if depth > 0:
            img, state, n_live = _sort_flush(scene, img, state)
            if n_live == 0:
                break
            w2 = _bucket(n_live, n)
            if w2 < w:
                state = _map(state, lambda a: a[:w2])
                w = w2
        if counts is not None:
            counts["lanes"] += w
            counts["live"] += n_live
        state = path_mod.step(scene, state, depth, key, cfg,
                              presorted=True)
    img = _final_flush(img, state)
    return img.reshape(cam.height, cam.width, 3)
