"""Edge-aware denoiser: a-trous wavelet filter with optional AOV guides.

Counterpart of raytracingrenderer_tpu/imaging/denoise.py, which fills
the role of RTBase's vendored Intel OIDN (Renderer.h:752-793) with an
edge-avoiding a-trous filter (Dammertz et al. 2010): multi-scale 5x5
B3-spline convolutions whose weights fall off with colour (and,
optionally, albedo and normal) differences.  Plain torch on the image's
device, differentiable; the borders wrap (torch.roll), as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# the 5x5 weights as the float32 products the JAX package forms
_KERNEL = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / np.float32(16)


def _atrous_pass(img: torch.Tensor, guide_col: torch.Tensor,
                 albedo: Optional[torch.Tensor],
                 normal: Optional[torch.Tensor], step: int,
                 sigma_col: float, sigma_alb: float, sigma_nrm: float
                 ) -> torch.Tensor:
    h, w, _ = img.shape
    acc = torch.zeros_like(img)
    wsum = torch.zeros((h, w, 1), dtype=img.dtype, device=img.device)

    def diff2(g: torch.Tensor, shift) -> torch.Tensor:
        return ((g - torch.roll(g, shift, dims=(0, 1))) ** 2).sum(
            -1, keepdim=True)

    for dy in range(-2, 3):
        for dx in range(-2, 3):
            kw = float(_KERNEL[dy + 2] * _KERNEL[dx + 2])
            shift = (-dy * step, -dx * step)
            sh = torch.roll(img, shift, dims=(0, 1))
            wt = kw * torch.exp(-diff2(guide_col, shift) / sigma_col)
            if albedo is not None:
                wt = wt * torch.exp(-diff2(albedo, shift) / sigma_alb)
            if normal is not None:
                wt = wt * torch.exp(-diff2(normal, shift) / sigma_nrm)
            acc = acc + sh * wt
            wsum = wsum + wt
    return acc / torch.clamp(wsum, min=1e-8)


def denoise(img, albedo: Optional[torch.Tensor] = None,
            normal: Optional[torch.Tensor] = None, passes: int = 4,
            sigma_col: float = 0.5, sigma_alb: float = 0.01,
            sigma_nrm: float = 0.1) -> torch.Tensor:
    """Denoise an HDR (H, W, 3) image (a tensor, or an array put on the
    CPU); the guides are optional AOVs from integrators.aov
    (albedo_image / normals_image) on the image's device."""
    img = torch.as_tensor(img, dtype=torch.float32)
    out = img
    for p in range(passes):
        out = _atrous_pass(out, out, albedo, normal, 1 << p,
                           sigma_col * (2.0 ** -p), sigma_alb, sigma_nrm)
    return out
