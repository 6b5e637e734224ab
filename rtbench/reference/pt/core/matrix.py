"""4x4 matrix helpers (host-side numpy + batched torch application).

Counterpart of raytracingrenderer_tpu/core/matrix.py.  Row-major 4x4
matrices with the RTBase renderer's conventions (Core.h:205-505):
DirectX-style perspective (z in [0,1], row 3 = [0,0,-1,0]), lookAt that
maps world->view.  Matrices are built once per scene on the host in
numpy; the batched `apply_*` functions take a (4, 4) float32 tensor on
the batch's device and V3 batches.
"""
from __future__ import annotations

import math

import numpy as np

from .vec import V3


def perspective(n: float, f: float, aspect: float, fov_deg: float) -> np.ndarray:
    """DX-style perspective; FOV in degrees is the *vertical* field of view."""
    t = 1.0 / math.tan(math.radians(fov_deg) * 0.5)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = t / aspect
    P[1, 1] = t
    P[2, 2] = -f / (f - n)
    P[2, 3] = -(f * n) / (f - n)
    P[3, 2] = -1.0
    return P


def look_at(from_p, to_p, up) -> np.ndarray:
    """World -> view matrix (RTBase Matrix::lookAt, Core.h:439-459)."""
    from_p = np.asarray(from_p, np.float64)
    to_p = np.asarray(to_p, np.float64)
    up = np.asarray(up, np.float64)
    dir_ = from_p - to_p
    dir_ = dir_ / np.linalg.norm(dir_)
    left = np.cross(up, dir_)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dir_, left)
    M = np.zeros((4, 4), dtype=np.float64)
    M[0, :3] = left
    M[1, :3] = new_up
    M[2, :3] = dir_
    M[0, 3] = -from_p.dot(left)
    M[1, 3] = -from_p.dot(new_up)
    M[2, 3] = -from_p.dot(dir_)
    M[3, 3] = 1.0
    return M.astype(np.float32)


def invert(M: np.ndarray) -> np.ndarray:
    return np.linalg.inv(M.astype(np.float64)).astype(np.float32)


def mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    return (A.astype(np.float64) @ B.astype(np.float64)).astype(np.float32)


# ---- host-side single-point application (numpy) -------------------------

def mul_point_np(M: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, np.float64)
    q = M[:3, :3].astype(np.float64) @ p + M[:3, 3].astype(np.float64)
    return q.astype(np.float32)


# ---- batched device application (torch, V3 batches) ---------------------

def apply_point(M, p: V3) -> V3:
    """(M @ [p,1]).xyz for a batch of points; M is a (4,4) tensor."""
    return V3(M[0, 0] * p.x + M[0, 1] * p.y + M[0, 2] * p.z + M[0, 3],
              M[1, 0] * p.x + M[1, 1] * p.y + M[1, 2] * p.z + M[1, 3],
              M[2, 0] * p.x + M[2, 1] * p.y + M[2, 2] * p.z + M[2, 3])


def apply_vec(M, v: V3) -> V3:
    return V3(M[0, 0] * v.x + M[0, 1] * v.y + M[0, 2] * v.z,
              M[1, 0] * v.x + M[1, 1] * v.y + M[1, 2] * v.z,
              M[2, 0] * v.x + M[2, 1] * v.y + M[2, 2] * v.z)
