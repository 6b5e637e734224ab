"""Adaptive sampling: variance-driven sample reallocation.

Counterpart of raytracingrenderer_tpu/integrators/adaptive.py (RTBase's
two-phase scheme, Renderer.h:583-749): INIT_SAMPLES uniform passes,
then `rounds` batches of a fixed number of rays, each drawn from the
per-32x32-tile variance of the mean (systematic resampling), traced and
scatter-added into the state.  The variance refreshes from the
accumulated buffers every round.

Keys as in the JAX package: init pass s on spp_key(base, start + s),
round r on spp_key(base, 10_000 + start + r), split into the draw's key
and the trace's.  Tile ids come from a searchsorted over a float32
cumsum, which torch and XLA may round differently by an ulp; a draw
whose u lies that close to a tile boundary may land in the neighbouring
tile, and every other draw lands alike (tests/test_torch_adaptive.py).

The film contract: an incoming film resumes as a uniform-count prior
(its variance population restarts empty), `on_sample` fires after every
init pass and round, and the returned film divides to the per-pixel
mean under Film.spp.

Under a mesh of ranks (parallel/mesh.py) the init passes are
mesh.render_sharded's (each rank renders a band of rows), and each
round is `_sharded_round`: every rank draws ceil(round_rays / size)
rays from the same state with the round's key folded with its rank,
traces and scatters them into zeros, and an all_reduce sum of those
partials is added to the state, so every rank holds the same state
(the collective stands for RTBase's shared variance array and its
mutex, Renderer.h:636-639).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import INIT_SAMPLES, TILE_SIZE, RenderConfig
from ..imaging import film as film_mod
from ..integrators import path as path_mod
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene


class AdaptiveState(NamedTuple):
    """Display accumulation (sum1 / count) and this run's variance
    statistics: lsum, sum2 and vcount cover only the samples traced in
    this run (a resumed film's mean says nothing of its noise)."""
    sum1: torch.Tensor    # (H, W, 3) radiance sum (display, incl. prior)
    count: torch.Tensor   # (H, W) display samples a pixel (incl. prior)
    lsum: torch.Tensor    # (H, W) luminance sum, this run only
    sum2: torch.Tensor    # (H, W) luminance^2 sum, this run only
    vcount: torch.Tensor  # (H, W) samples in the variance population


def _trace_pixels(scene: Scene, px: torch.Tensor, py: torch.Tensor,
                  key: rng.Key, cfg: RenderConfig):
    """Radiance of one jittered ray through each pixel (px[i], py[i])."""
    jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, px.shape, px.device)
    jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, py.shape, py.device)
    o, d = generate_rays(scene.camera, px.to(torch.float32) + jx,
                         py.to(torch.float32) + jy)
    return path_mod.trace_radiance(scene, o, d, key, cfg)


def _tile_variance(st: AdaptiveState) -> torch.Tensor:
    """(th, tw) mean over each TILE_SIZE^2 tile of the per-pixel variance
    of the mean estimate; a pixel with fewer than 2 samples in the
    variance population counts 1 (maximally noisy), padding counts 0."""
    h, w = st.count.shape
    ts = TILE_SIZE
    vc = torch.clamp(st.vcount, min=1.0)
    m = st.lsum / vc
    var = torch.clamp(st.sum2 / vc - m * m, min=0.0)
    var_of_mean = torch.where(st.vcount >= 2.0, var / vc, 1.0)
    v_p = torch.nn.functional.pad(var_of_mean, (0, (-w) % ts, 0, (-h) % ts))
    th, tw = v_p.shape[0] // ts, v_p.shape[1] // ts
    tiles = v_p.reshape(th, ts, tw, ts).permute(0, 2, 1, 3)
    return tiles.reshape(th, tw, ts * ts).mean(dim=-1)


def _sample_pixels(st: AdaptiveState, key: rng.Key, n_rays: int,
                   height: int, width: int):
    """Systematic resampling of n_rays pixels (px, py), int64, with tile
    probability proportional to its variance, uniform within a tile."""
    dev = st.count.device
    var = _tile_variance(st) + 1e-8
    p = (var / var.sum()).reshape(-1)
    cdf = torch.cumsum(p, dim=0)
    u = (torch.arange(n_rays, dtype=torch.float32, device=dev)
         + rng.raw_uniform(key, (n_rays,), dev)) / n_rays
    # left side, as jnp.searchsorted: the first k with u <= cdf[k]
    tile_id = torch.clamp(torch.searchsorted(cdf, u, right=False), 0,
                          p.shape[0] - 1)
    ts = TILE_SIZE
    tw = -(-width // ts)
    ty = tile_id // tw
    tx = tile_id % tw
    k1, k2 = rng.split(rng.fold_in(key, 1))
    ox = rng.randint(k1, (n_rays,), 0, ts, dev)
    oy = rng.randint(k2, (n_rays,), 0, ts, dev)
    px = torch.clamp(tx * ts + ox, max=width - 1)
    py = torch.clamp(ty * ts + oy, max=height - 1)
    return px, py


def _scatter_round(scene: Scene, st: AdaptiveState, key: rng.Key,
                   cfg: RenderConfig, n_rays: int, h: int, w: int
                   ) -> AdaptiveState:
    """One variance-allocated batch of n_rays traced and scattered into
    the state: one index_add_ a buffer over the flat pixel id (sums of
    duplicates differ from the JAX package's only in their order)."""
    kp, kt = rng.split(key)
    px, py = _sample_pixels(st, kp, n_rays, h, w)
    return _scatter(st, _trace_pixels(scene, px, py, kt, cfg), px, py, w)


def _scatter(st: AdaptiveState, radiance, px, py, w: int) -> AdaptiveState:
    """The traced radiance of pixels (px, py) added into the state."""
    h = st.count.shape[0]
    rgb = radiance.stacked()
    lum = rgb.mean(dim=-1)
    flat = py * w + px
    ones = torch.ones_like(lum)

    def add(buf, val):
        return buf.reshape(h * w, *buf.shape[2:]).index_add(
            0, flat, val).reshape(buf.shape)

    return AdaptiveState(add(st.sum1, rgb), add(st.count, ones),
                         add(st.lsum, lum), add(st.sum2, lum * lum),
                         add(st.vcount, ones))


def _sharded_round(scene: Scene, st: AdaptiveState, key: rng.Key,
                   cfg: RenderConfig, rays_per_shard: int, h: int, w: int,
                   mesh) -> AdaptiveState:
    """A round over `mesh`: this rank's rays_per_shard rays, drawn with
    the key folded with its rank from the state every rank holds,
    scattered into zeros; the partials' all_reduce sum joins the
    state."""
    zero = AdaptiveState(*(torch.zeros_like(a) for a in st))
    k = rng.fold_in(key, mesh.rank)
    kp, kt = rng.split(k)
    px, py = _sample_pixels(st, kp, rays_per_shard, h, w)
    part = _scatter(zero, _trace_pixels(scene, px, py, kt, cfg), px, py, w)
    flat = torch.cat([a.reshape(-1) for a in part])
    mesh.all_reduce(flat)
    sizes = [a.numel() for a in st]
    return AdaptiveState(*(a + d.reshape(a.shape) for a, d in
                           zip(st, torch.split(flat, sizes))))


def _to_film(st: AdaptiveState) -> film_mod.Film:
    """The non-uniform accumulation under the Film contract:
    buffer / spp = per-pixel mean, spp = mean sample count."""
    spp = torch.clamp(st.count.mean(), min=1.0)
    mean = st.sum1 / torch.clamp(st.count[..., None], min=1.0)
    return film_mod.Film(buffer=mean * spp, spp=spp)


def adaptive_render(scene: Scene, cfg: RenderConfig, total_spp: int,
                    init_spp: int = INIT_SAMPLES, rounds: int = 8,
                    film: Optional[film_mod.Film] = None,
                    on_sample: Optional[Callable] = None,
                    mesh=None) -> film_mod.Film:
    """A budget of total_spp * npixels rays on the scene's device:
    `init_spp` uniform passes (render.sample_image), the rest in
    `rounds` variance-allocated batches of equal size
    (path.trace_radiance on the drawn pixels).  An incoming `film`
    resumes as a uniform-count prior; `on_sample(step, film)` fires
    after every init pass and round.  With `mesh` (a
    parallel.mesh.Mesh) the passes and rounds are split over its ranks,
    and every rank returns the same film."""
    from ..parallel.mesh import Mesh, render_sharded
    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"adaptive_render(mesh={mesh!r}): not a port Mesh "
            f"(parallel.mesh.make_mesh); other meshes have no counterpart "
            f"here")
    if mesh is not None and scene.sharded:
        raise ValueError("a scene-sharded scene walks every ray on every "
                         "rank: call adaptive_render without a mesh")
    from ..render import sample_image, specialize_config
    cfg = specialize_config(cfg, scene)
    cam = scene.camera
    h, w = cam.height, cam.width
    dev = scene.device
    base = rng.PRNGKey(cfg.seed)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if film is not None and float(film.spp) > 0:
        prior = torch.full((h, w), float(film.spp), dtype=torch.float32,
                           device=dev)
        st = AdaptiveState(film.buffer.to(dev, torch.float32), prior,
                           zeros(h, w), zeros(h, w), zeros(h, w))
        start = int(film.spp)
    else:
        st = AdaptiveState(zeros(h, w, 3), zeros(h, w), zeros(h, w),
                           zeros(h, w), zeros(h, w))
        start = 0

    step = start
    with torch.no_grad():
        for s in range(init_spp):
            key = rng.spp_key(base, start + s)
            img = (sample_image(scene, key, cfg) if mesh is None
                   else render_sharded(scene, key, cfg, mesh))
            lum = img.mean(dim=-1)
            st = AdaptiveState(st.sum1 + img, st.count + 1.0,
                               st.lsum + lum, st.sum2 + lum * lum,
                               st.vcount + 1.0)
            step += 1
            if on_sample is not None:
                on_sample(step - 1, _to_film(st))

        budget = max(total_spp - init_spp, 0) * h * w
        round_rays = max(budget // max(rounds, 1), 0)
        if round_rays:
            for r in range(rounds):
                key = rng.spp_key(base, 10_000 + start + r)
                if mesh is None:
                    st = _scatter_round(scene, st, key, cfg, round_rays, h, w)
                else:
                    st = _sharded_round(scene, st, key, cfg,
                                        -(-round_rays // mesh.size), h, w,
                                        mesh)
                step += 1
                if on_sample is not None:
                    on_sample(step - 1, _to_film(st))
    return _to_film(st)
