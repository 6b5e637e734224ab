"""Structure-of-arrays 3-vectors on torch tensors.

Counterpart of raytracingrenderer_tpu/core/vec.py.  A vector batch stays
three flat ``(N,)`` tensors rather than one ``(N, 3)`` tensor, so shapes
line up with the JAX package in the parity tests and every elementwise
op reads three contiguous arrays.

Constructors take the device explicitly; arithmetic follows the
operands.  Operation order matches the JAX package term for term (dot
products sum x, y, z left to right), so both round alike.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..ops.gather import gather_cols

Scalar = Union[float, torch.Tensor]


def _as(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class V3(NamedTuple):
    """A batch of 3-vectors (or RGB colours) as three component tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # ---- constructors -------------------------------------------------
    @staticmethod
    def of(x, y, z, device=None) -> "V3":
        return V3(_as(x, device), _as(y, device), _as(z, device))

    @staticmethod
    def full(shape, x: float, y: float, z: float, device=None,
             dtype=torch.float32) -> "V3":
        return V3(torch.full(shape, x, dtype=dtype, device=device),
                  torch.full(shape, y, dtype=dtype, device=device),
                  torch.full(shape, z, dtype=dtype, device=device))

    @staticmethod
    def zeros(shape, device=None, dtype=torch.float32) -> "V3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return V3(z, z, z)

    @staticmethod
    def zeros_like(t: torch.Tensor) -> "V3":
        z = torch.zeros_like(t)
        return V3(z, z, z)

    @staticmethod
    def from_stacked(a: torch.Tensor) -> "V3":
        """From an (..., 3) tensor (host/scene code only; not the hot path)."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def stacked(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    # ---- arithmetic ----------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # ---- geometry ------------------------------------------------------
    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.length_sq())

    def normalize(self, eps: float = 1e-20) -> "V3":
        inv = torch.rsqrt(torch.clamp(self.length_sq(), min=eps))
        return self * inv

    # ---- colour --------------------------------------------------------
    def lum(self) -> torch.Tensor:
        """Rec.709 luminance (reference Colour::Lum, Core.h:88-92)."""
        return 0.2126 * self.x + 0.7152 * self.y + 0.0722 * self.z

    def max_comp(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    # ---- utility -------------------------------------------------------
    def where(self, pred: torch.Tensor, other) -> "V3":
        """Select self where pred else other (a V3 or a float; broadcasts)."""
        if not isinstance(other, V3):
            other = V3(other, other, other)
        return V3(torch.where(pred, self.x, other.x),
                  torch.where(pred, self.y, other.y),
                  torch.where(pred, self.z, other.z))

    def gather(self, idx: torch.Tensor) -> "V3":
        """Rows `idx` of each component: plain indexing, whose backward
        is one launch of the transpose kernel for the three where a
        gradient is recorded on the card (ops/gather.gather_cols)."""
        return V3(*gather_cols(self, idx))

    @property
    def shape(self):
        return self.x.shape


def vdot(a: V3, b: V3) -> torch.Tensor:
    return a.dot(b)


def vcross(a: V3, b: V3) -> V3:
    return a.cross(b)


def vmax(a: V3, b: V3) -> V3:
    return V3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
              torch.maximum(a.z, b.z))


def vmin(a: V3, b: V3) -> V3:
    return V3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
              torch.minimum(a.z, b.z))


def vclamp(a: V3, lo: float, hi: float) -> V3:
    return V3(torch.clamp(a.x, lo, hi), torch.clamp(a.y, lo, hi),
              torch.clamp(a.z, lo, hi))


def vwhere(pred: torch.Tensor, a: V3, b) -> V3:
    return a.where(pred, b)


def vlerp(a: V3, b: V3, t: Scalar) -> V3:
    return a * (1.0 - t) + b * t


def reflect_z(w: V3) -> V3:
    """Mirror about the local +z axis: (-x, -y, z)."""
    return V3(-w.x, -w.y, w.z)
