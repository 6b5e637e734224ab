"""Film: progressive accumulation buffer and tonemap.

Counterpart of raytracingrenderer_tpu/imaging/film.py (RTBase Film,
Imaging.h:132-272): a (H, W, 3) radiance-sum tensor plus an spp counter.
`to_hdr` divides by spp (Film::save); `tonemap` is exposure*x/spp then
gamma 1/2.2, clamped.  Light-tracing splats come with the light tracer.
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


def to_hdr(film: Film) -> torch.Tensor:
    """Radiance image = buffer / spp."""
    return film.buffer / torch.clamp(film.spp, min=1.0)


def tonemap(film: Film, exposure: float = 1.0) -> torch.Tensor:
    """LDR floats: (exposure*x/spp)^(1/2.2) clamped to [0, 1]."""
    img = to_hdr(film) * exposure
    return torch.clamp(torch.pow(torch.clamp(img, min=0.0), 1.0 / 2.2),
                       0.0, 1.0)
