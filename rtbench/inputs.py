"""Inputs made from `--seed`, the same for the renderer and the reference:
the scene files, the render seed, the training keys' seed, the target's
perturbation and which pixels and passes the check compares.  numpy and
the standard library only: both sides import this module.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

from .harness import ROOT, writer

# written scenes: one directory a configuration and frame size, inside the
# checkout (build/ is not committed), reused by every later run
SCENE_ROOT = ROOT / "build" / "rtbench" / "scenes"


def seed32(seed: int) -> int:
    """The renderer's RenderConfig.seed (PRNGKey takes 31 bits here)."""
    return int(seed) % (1 << 31)


def target_seed(seed: int) -> int:
    """RenderConfig.seed of the training target's render."""
    return (seed32(seed) + 0x2545F491) % (1 << 31)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def scene_dir(conf: dict, width: int, height: int) -> Path:
    """The configuration's scene written at width x height, or the copy
    an earlier run wrote (keyed by the writer's source and parameters)."""
    sc = conf["scene"]
    src = (Path(__file__).resolve().parent / "scenes"
           / f"{sc['writer']}.py").read_bytes()
    key = hashlib.sha256(src + json.dumps(
        [sc, width, height], sort_keys=True).encode()).hexdigest()[:12]
    out = SCENE_ROOT / f"{conf['entry']['name']}-{width}x{height}-{key}"
    if (out / "scene.json").is_file():
        return out
    tmp = out.with_name(out.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    writer(sc["writer"]).write(str(tmp), width, height,
                               **sc.get("params", {}))
    os.replace(tmp, out)
    return out


def band(seed: int, height: int, rows: int) -> int:
    """First row of the band of rows whose every pass is kept."""
    return int(rng(seed, 1).integers(0, height - rows + 1))


def checked_passes(seed: int, done: int, k: int) -> list:
    """The passes compared, drawn from the `done` completed ones."""
    k = min(k, done)
    return sorted(int(s) for s in rng(seed, 2).choice(done, k,
                                                      replace=False))


def perturbation(seed: int, n_mat: int, n_light: int, spec: dict):
    """(albedo factors (M, 3), light Le factors (L, 3)), float32: the
    target scene is the loaded one with its albedo and Le scaled by
    them."""
    g = rng(seed, 3)
    lo, hi = spec["albedo"]
    fa = g.uniform(lo, hi, (n_mat, 3)).astype(np.float32)
    lo, hi = spec["light_le"]
    fl = g.uniform(lo, hi, (n_light, 3)).astype(np.float32)
    return fa, fl
