"""Fly-camera controls: WASD/QE moves and yaw rotation on a Camera.

Counterpart of raytracingrenderer_tpu/scene/controls.py (RTBase
RTCamera, SceneLoader.h:8-90): forward/back along the view direction,
strafe left/right, up/down, and left/right yaw by a Rodrigues rotation
of the view offset about `up`.  The state stays on the host in float64,
as in the JAX package; `camera(device)` builds the port's Camera on a
device.  The caller clears the film on a move, as RTBase's main loop
does (Main.cpp:84-109 calls rt.clear()).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import matrix
from ..core.vec import V3
from .types import Camera


class FlyCamera:
    """Host-side mutable from/to/up state, producing Cameras."""

    def __init__(self, from_p, to_p, up, projection: np.ndarray,
                 width: int, height: int, movespeed: float = 1.0,
                 rotspeed_deg: float = 5.0):
        self.from_p = np.asarray(from_p, np.float64)
        self.to_p = np.asarray(to_p, np.float64)
        self.up = np.asarray(up, np.float64)
        self.p = np.asarray(projection, np.float32)
        self.width = width
        self.height = height
        self.movespeed = movespeed
        self.rotspeed = math.radians(rotspeed_deg)

    # -- movement (RTBase SceneLoader.h:20-60) ---------------------------
    def _dir(self):
        d = self.to_p - self.from_p
        return d / np.linalg.norm(d)

    def _move(self, step):
        self.from_p += step
        self.to_p += step

    def forward(self, sign=1.0):
        self._move(self._dir() * (sign * self.movespeed))

    def back(self):
        self.forward(-1.0)

    def strafe(self, sign=1.0):
        right = np.cross(self._dir(), self.up)
        right /= np.linalg.norm(right)
        self._move(right * (sign * self.movespeed))

    def rise(self, sign=1.0):
        u = self.up / np.linalg.norm(self.up)
        self._move(u * (sign * self.movespeed))

    def yaw(self, sign=1.0):
        """Rodrigues rotation of (to - from) about up
        (RTBase SceneLoader.h:61-86)."""
        theta = sign * self.rotspeed
        k = self.up / np.linalg.norm(self.up)
        v = self.to_p - self.from_p
        v_rot = (v * math.cos(theta) + np.cross(k, v) * math.sin(theta)
                 + k * k.dot(v) * (1 - math.cos(theta)))
        self.to_p = self.from_p + v_rot

    # -- key dispatch (RTBase keys W/S/A/D/Q/E and the arrows) -----------
    _KEYS = {"w": ("forward", 1.0), "s": ("forward", -1.0),
             "a": ("strafe", -1.0), "d": ("strafe", 1.0),
             "q": ("rise", 1.0), "e": ("rise", -1.0),
             "left": ("yaw", 1.0), "right": ("yaw", -1.0)}

    def key(self, k: str):
        move = self._KEYS.get(k.lower())
        if move is not None:
            getattr(self, move[0])(move[1])

    def camera(self, device="cuda") -> Camera:
        """The Camera of the current state, its tensors on `device`."""
        V = matrix.look_at(self.from_p, self.to_p, self.up)
        c2w = matrix.invert(V)
        w_lens = 2.0 / self.p[1, 1]
        h_lens = w_lens * (self.p[0, 0] / self.p[1, 1])
        origin = matrix.mul_point_np(c2w, [0.0, 0.0, 0.0])

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return Camera(
            p=t(self.p), p_inv=t(matrix.invert(self.p)),
            cam_to_world=t(c2w), world_to_cam=t(V),
            width=self.width, height=self.height,
            origin=V3.of(*origin, device=device),
            a_film=t(np.float32(abs(w_lens * h_lens))))
