"""Film checkpoint and resume.

Counterpart of raytracingrenderer_tpu/utils/checkpoint.py: a film's
{buffer, spp} round-trips through one .npz file with the same keys, and
the write is an atomic replace, so a film saved by either package loads
in the other.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..imaging.film import Film
from ..scene.types import scene_device


def save_film(path: str, film: Film) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, buffer=film.buffer.detach().cpu().numpy(),
             spp=film.spp.detach().cpu().numpy())
    os.replace(tmp, path)


def load_film(path: str, device="cuda") -> Optional[Film]:
    """The film saved at `path` on `device` (the card unless the caller
    names another; "cuda" without a card raises), or None if there is
    no file."""
    if not os.path.isfile(path):
        return None
    device = scene_device(device)
    with np.load(path) as z:
        return Film(
            buffer=torch.as_tensor(np.asarray(z["buffer"], np.float32),
                                   device=device),
            spp=torch.as_tensor(np.asarray(z["spp"], np.float32),
                                device=device))
