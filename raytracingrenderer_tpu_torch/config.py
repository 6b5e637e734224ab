"""Render configuration: the same fields and defaults as
raytracingrenderer_tpu/config.py, so one RenderConfig reads alike in both
packages.

Fields that belong to slices this package has not ported yet are kept
(so configurations carry over) and `render.render` refuses them:
`geom_grads`, `boundary_grads`, `wavefront=True` and any `integrator`
other than "path".  `batch_rays` and `remat` have no effect here: the
port renders one full frame per sample pass and has no backward yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# RTBase constants (Renderer.h:18-24, Geometry.h:60)
TILE_SIZE = 32
MAX_DEPTH = 4
MAX_SAMPLES = 10240
MIN_SAMPLES = 1
INIT_SAMPLES = 2
MAX_VPL = 50
EPSILON = 1e-4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    spp: int = 8192                  # RTBase default (Main.cpp:26)
    max_depth: int = MAX_DEPTH       # NEE continues one extra bounce
    rr_cap: float = 0.9              # Russian roulette cap (Renderer.h:353)
    rr: bool = True                  # Russian roulette on/off
    mis: bool = True                 # balance-heuristic MIS
    jitter: bool = False             # sub-pixel jitter
    integrator: str = "path"         # only "path" is ported
    batch_rays: int = 1 << 18        # kept for parity; unused here
    exposure: float = 1.0
    seed: int = 0
    # Debug switches: zero out one MIS strategy (estimator tests).
    debug_no_nee: bool = False
    debug_no_emission: bool = False
    # Static set of MAT_* types present in the scene; None = assume all.
    # render() fills it in from the material table so only the BSDF
    # lobes the scene uses are evaluated (materials/bsdf.py:_has).
    mat_types: Optional[Tuple[int, ...]] = None
    # Power-weighted NEE light selection (lights.selection_pmf).
    power_lights: bool = False
    # Later slices (render() raises NotImplementedError when set):
    geom_grads: bool = False
    boundary_grads: bool = False
    boundary_samples: int = 4
    wavefront: Optional[bool] = None
    remat: bool = True
