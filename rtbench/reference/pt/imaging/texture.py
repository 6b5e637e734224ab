"""Bilinear texture sampling over a padded texture atlas.

Counterpart of raytracingrenderer_tpu/imaging/texture.py (RTBase
Texture::sample, Imaging.h:72-95): u' = |u|*w, v' = |v|*h, bilinear over
floor neighbours with integer-mod wrap.  Constant textures never reach
here (folded into material albedo at load time).
"""
from __future__ import annotations

import torch

from ..core.vec import V3
from ..scene.types import TextureAtlas


def _gather_texel(atlas: TextureAtlas, tid, x, y) -> V3:
    t = atlas.data[tid, y, x]  # (..., 3) advanced-index gather
    return V3(t[..., 0], t[..., 1], t[..., 2])


def has_textures(atlas: TextureAtlas) -> bool:
    """An empty atlas has a zero-length leading axis."""
    return atlas.data.shape[0] > 0


def sample(atlas: TextureAtlas, tid: torch.Tensor, u: torch.Tensor,
           v: torch.Tensor) -> V3:
    """Bilinear RGB sample; tid may be -1 (white, like RTBase's 1x1
    default texture)."""
    if not has_textures(atlas):
        one = torch.ones(torch.broadcast_shapes(tid.shape, u.shape),
                         dtype=torch.float32, device=u.device)
        return V3(one, one, one)
    safe_tid = torch.clamp(tid, min=0).long()
    h = atlas.hw[safe_tid, 0].long()
    w = atlas.hw[safe_tid, 1].long()
    uu = torch.abs(u) * w.to(torch.float32)
    vv = torch.abs(v) * h.to(torch.float32)
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fu = uu - x0
    fv = vv - y0
    x0 = x0.to(torch.int64) % w
    y0 = y0.to(torch.int64) % h
    if atlas.quad is not None:
        # one 16-float row carries the whole 2x2 footprint
        wmax = atlas.data.shape[2]
        rows = atlas.quad[safe_tid * (atlas.data.shape[1] * wmax)
                          + y0 * wmax + x0]
        s00 = V3(rows[..., 0], rows[..., 1], rows[..., 2])
        s10 = V3(rows[..., 3], rows[..., 4], rows[..., 5])
        s01 = V3(rows[..., 6], rows[..., 7], rows[..., 8])
        s11 = V3(rows[..., 9], rows[..., 10], rows[..., 11])
    else:
        x1 = (x0 + 1) % w
        y1 = (y0 + 1) % h
        s00 = _gather_texel(atlas, safe_tid, x0, y0)
        s10 = _gather_texel(atlas, safe_tid, x1, y0)
        s01 = _gather_texel(atlas, safe_tid, x0, y1)
        s11 = _gather_texel(atlas, safe_tid, x1, y1)
    out = (s00 * ((1 - fu) * (1 - fv)) + s10 * (fu * (1 - fv))
           + s01 * ((1 - fu) * fv) + s11 * (fu * fv))
    return out.where(tid >= 0, 1.0)
