"""Lat-long environment map: evaluation and luminance importance sampling.

Counterpart of raytracingrenderer_tpu/lights/envmap.py (RTBase
EnvironmentMap, Lights.h:150-199): y-up, u = atan2(z, x) / 2pi,
v = acos(y) / pi.  The tables are built on the host in float64 numpy, as
there: a Walker/Vose alias table over the sin-weighted texel luminances
(the native builder's `alias_build`, with a Python fallback of the same
pop order), so a sample costs two row gathers on the device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from ..core.vec import V3
from ..scene.types import EnvMap

TWO_PI = 2.0 * math.pi
INV_2PI = 1.0 / TWO_PI
INV_PI = 1.0 / math.pi
# solid-angle Jacobian of the (u, v) square: 2 pi^2 sin(theta)
_JACOBIAN = 2.0 * math.pi * math.pi


def build_envmap(data: np.ndarray, device="cpu") -> EnvMap:
    """(H, W, 3) radiance -> EnvMap on `device` (tables built on the host)."""
    data = np.asarray(data, np.float32)
    h, w, _ = data.shape
    lum = (0.2126 * data[..., 0] + 0.7152 * data[..., 1]
           + 0.0722 * data[..., 2]).astype(np.float64)
    # each texel weighted by the mean of its cell's 4 corners (wrapping
    # as the sampler does), so that the pdf and the bilinear evaluate()
    # describe the same signal
    lum_cell = 0.25 * (lum + np.roll(lum, -1, axis=1)
                       + np.roll(lum, -1, axis=0)
                       + np.roll(np.roll(lum, -1, axis=0), -1, axis=1))
    # sin(theta) at texel centres
    st = np.sin((np.arange(h) + 0.5) / h * np.pi)
    weights = lum_cell * st[:, None] + 1e-12
    p_texel = weights / weights.sum()                     # (H, W)
    prob, alias = _alias_table(p_texel.reshape(-1))
    pdf2d = p_texel * (h * w)                             # over (u, v)
    # RTBase's power estimate (Lights.h:171-184): sin(i/H*pi)-weighted
    # mean luminance * 4pi
    st_ref = np.sin(np.arange(h) / h * np.pi)
    mean_power = float((lum * st_ref[:, None]).mean() * 4.0 * np.pi)
    alias_row = np.stack([prob, alias.astype(np.float32)], axis=1)
    texel_row = np.concatenate(
        [data.reshape(-1, 3), pdf2d.reshape(-1, 1)], axis=1)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return EnvMap(data=t(data), alias_row=t(alias_row),
                  texel_row=t(texel_row), pdf2d=t(pdf2d),
                  mean_power=t(np.float32(mean_power)))


def _alias_table(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker/Vose alias table of a pmf -> (prob f32, alias int32): the
    native builder's `alias_build` where the library has it, else
    `_alias_vose`."""
    n = len(p)
    p = np.asarray(p, np.float64)
    p = np.ascontiguousarray(p / p.sum())
    from ..geometry.bvh_native import _load
    lib = _load()
    if not hasattr(lib, "alias_build"):
        return _alias_vose(p)
    prob = np.empty(n, np.float32)
    alias = np.empty(n, np.int32)
    lib.alias_build(p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
                    prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return prob, alias


def _alias_vose(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose's alias table in Python, popping from the ends of the small
    and large lists as the native builder does (seconds at millions of
    texels)."""
    n = len(p)
    scaled = np.asarray(p, np.float64) * n
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    return prob, alias


def dir_to_uv(wi: V3) -> Tuple[torch.Tensor, torch.Tensor]:
    u = torch.atan2(wi.z, wi.x)
    u = torch.where(u < 0.0, u + TWO_PI, u) * INV_2PI
    v = torch.acos(torch.clamp(wi.y, -1.0, 1.0)) * INV_PI
    return u, v


def uv_to_dir(u: torch.Tensor, v: torch.Tensor) -> V3:
    phi = u * TWO_PI
    theta = v * math.pi
    st = torch.sin(theta)
    return V3(st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi))


def evaluate(env: EnvMap, wi: V3) -> V3:
    """Radiance along wi: bilinear with wrap on the floor grid, no
    half-texel offset (RTBase Texture::sample, Imaging.h:72-95)."""
    u, v = dir_to_uv(wi)
    h, w = env.data.shape[0], env.data.shape[1]
    uu = u * w
    vv = v * h
    x0f = torch.floor(uu)
    y0f = torch.floor(vv)
    fu = uu - x0f
    fv = vv - y0f
    x0 = x0f.long() % w
    y0 = y0f.long() % h
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h

    def tex(y, x):
        return V3.from_stacked(env.data[y, x])

    return (tex(y0, x0) * ((1 - fu) * (1 - fv))
            + tex(y0, x1) * (fu * (1 - fv))
            + tex(y1, x0) * ((1 - fu) * fv)
            + tex(y1, x1) * (fu * fv))


def sample_le(env: EnvMap, r1: torch.Tensor, r2: torch.Tensor,
              r3: torch.Tensor = None) -> Tuple[V3, torch.Tensor, V3]:
    """Importance-sample a direction -> (wi, solid-angle pdf, the sampled
    texel's radiance).

    r1 picks the alias slot (r1 * n in float32, truncated), r3 the
    accept-or-alias test, whose conditional remainder places u inside the
    texel; r2 places v.  Without r3 the slot's fractional part stands in
    for it (the JAX package's legacy form).  Two row gathers: [prob,
    alias] at the slot, [R, G, B, pdf] at the texel."""
    h, w = env.data.shape[0], env.data.shape[1]
    n = h * w
    scaled = r1 * n
    j = torch.clamp(scaled.to(torch.int32), 0, n - 1).long()
    rp = scaled - j.to(torch.float32) if r3 is None else r3
    arow = env.alias_row[j]
    pj = arow[:, 0]
    take = rp < pj
    idx = torch.where(take, j, arow[:, 1].long())
    # the conditional remainder is uniform on the chosen branch
    du = torch.where(take, rp / torch.clamp(pj, min=1e-12),
                     (rp - pj) / torch.clamp(1.0 - pj, min=1e-12))
    du = torch.clamp(du, 0.0, 1.0)
    y = idx // w
    x = idx % w
    u = (x.to(torch.float32) + du) / w
    v = (y.to(torch.float32) + r2) / h
    wi = uv_to_dir(u, v)
    sin_theta = torch.sqrt(torch.clamp(1.0 - wi.y * wi.y, min=1e-12))
    trow = env.texel_row[idx]
    pdf = trow[:, 3] / (_JACOBIAN * sin_theta)
    return wi, pdf, V3(trow[:, 0], trow[:, 1], trow[:, 2])


def sample(env: EnvMap, r1: torch.Tensor, r2: torch.Tensor
           ) -> Tuple[V3, torch.Tensor]:
    """(wi, pdf) form of sample_le."""
    wi, pdf, _ = sample_le(env, r1, r2)
    return wi, pdf


def with_data(env: EnvMap, data: torch.Tensor) -> EnvMap:
    """Replace the radiance, keeping the sampling tables: the texel rows
    carry the same radiance tensor (so NEE's gradients reach it), the pdf
    column and the alias table stay the fixed, detached distribution."""
    texel_row = torch.cat([data.reshape(-1, 3),
                           env.texel_row[:, 3:4].detach()], dim=1)
    return env._replace(data=data, texel_row=texel_row)


def pdf(env: EnvMap, wi: V3) -> torch.Tensor:
    """Solid-angle pdf of `sample` for any direction."""
    u, v = dir_to_uv(wi)
    h, w = env.data.shape[0], env.data.shape[1]
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    sin_theta = torch.sqrt(torch.clamp(1.0 - wi.y * wi.y, min=1e-12))
    return env.pdf2d[y, x] / (_JACOBIAN * sin_theta)
