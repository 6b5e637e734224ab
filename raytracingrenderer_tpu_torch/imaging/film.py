"""Film: progressive accumulation buffer and tonemap.

Counterpart of raytracingrenderer_tpu/imaging/film.py (RTBase Film,
Imaging.h:132-272): a (H, W, 3) radiance-sum tensor plus an spp counter.
`to_hdr` divides by spp (Film::save); `tonemap` is exposure*x/spp then
gamma 1/2.2, clamped.  `splat` scatter-adds the light tracer's point
samples anywhere on the film, with a filter footprint.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Film(NamedTuple):
    buffer: torch.Tensor  # (H, W, 3) radiance sum
    spp: torch.Tensor     # 0-d f32


def new_film(height: int, width: int, device=None) -> Film:
    return Film(buffer=torch.zeros((height, width, 3), dtype=torch.float32,
                                   device=device),
                spp=torch.zeros((), dtype=torch.float32, device=device))


def add_sample_image(film: Film, img: torch.Tensor, inc_spp: float = 1.0
                     ) -> Film:
    """Accumulate one full-frame sample image (H, W, 3)."""
    return Film(film.buffer + img, film.spp + inc_spp)


def splat(film: Film, x: torch.Tensor, y: torch.Tensor, rgb: torch.Tensor,
          filter_size: int = 0, filter_name: str = "gaussian") -> Film:
    """Scatter-add point samples rgb (N, 3) at continuous pixel
    coordinates (x, y).

    filter_size 0 is the single-pixel box (the reference's active
    BoxFilter, Renderer.h:50); above 0 a normalised kernel ("box",
    "gaussian", "mitchell": imaging/filters.py) over the (2s+1)^2
    footprint (Film::splat, Imaging.h:209-232)."""
    h, w = film.buffer.shape[:2]
    px = torch.floor(x).to(torch.int32)
    py = torch.floor(y).to(torch.int32)
    # index_add_ into a copy of the flattened (H*W, 3) buffer: the JAX
    # package's .at[py, px].add (on the card, atomics that sum in no
    # fixed order)
    flat = film.buffer.reshape(h * w, 3).clone()

    def add(cy, cx, val):
        flat.index_add_(0, (torch.clamp(cy, 0, h - 1) * w
                            + torch.clamp(cx, 0, w - 1)).long(), val)

    if filter_size == 0:
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        add(py, px, torch.where(inside[:, None], rgb, 0.0))
        return Film(flat.reshape(h, w, 3), film.spp)
    from . import filters as filt_mod
    kernel = {"box": filt_mod.box, "gaussian": filt_mod.gaussian,
              "mitchell": filt_mod.mitchell}[filter_name]
    s = filter_size
    taps = []
    wsum = torch.zeros_like(x)
    for dy in range(-s, s + 1):
        for dx in range(-s, s + 1):
            cx = px + dx
            cy = py + dy
            wt = kernel(cx.to(torch.float32) + 0.5 - x,
                        cy.to(torch.float32) + 0.5 - y, s)
            taps.append((cx, cy, wt))
            wsum = wsum + wt
    wsum = torch.clamp(wsum, min=1e-12)
    for cx, cy, wt in taps:
        inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        add(cy, cx, rgb * torch.where(inside, wt / wsum, 0.0)[:, None])
    return Film(flat.reshape(h, w, 3), film.spp)


def to_hdr(film: Film) -> torch.Tensor:
    """Radiance image = buffer / spp."""
    return film.buffer / torch.clamp(film.spp, min=1.0)


def tonemap(film: Film, exposure: float = 1.0) -> torch.Tensor:
    """LDR floats: (exposure*x/spp)^(1/2.2) clamped to [0, 1]."""
    img = to_hdr(film) * exposure
    return torch.clamp(torch.pow(torch.clamp(img, min=0.0), 1.0 / 2.2),
                       0.0, 1.0)
