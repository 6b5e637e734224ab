"""Render configuration: the same fields and defaults as
raytracingrenderer_tpu/config.py, so one RenderConfig reads alike in both
packages.

`render.render` and the gradient entry points (diff.py) run the path
tracer and refuse any other `integrator`; "direct", "albedo",
"normals", "lighttrace", "vpl" and "adaptive" run through
integrators.dispatch.render_with.
`geom_grads` attaches the hit-point reparameterisation (diff.py turns it
on); `boundary_grads` adds the NEE visibility boundary term
(integrators/boundary.py, `boundary_samples` edge samples a bounce, each
two probe rays), which leaves images bit for bit as they are and adds
the shadow edges' integral to the gradients.  `wavefront` picks the
integrator as in the JAX package (None: the wavefront one for BVH scenes
of more than 4096 triangles).  `remat`, when autograd is recording,
checkpoints every bounce (integrators/path.step): the backward runs a
bounce again with its recorded hits and occlusion bits instead of
keeping its intermediates, so it traverses nothing.  `batch_rays` has no
effect here: the port renders one full frame per sample pass.
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
    integrator: str = "path"         # others: dispatch.render_with
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
    geom_grads: bool = False         # hit-point reparameterisation
    # NEE visibility boundary term (integrators/boundary.py): 2 probe
    # rays per edge sample, boundary_samples samples a bounce
    boundary_grads: bool = False
    boundary_samples: int = 4
    # Compacting wavefront integrator: None = automatic (BVH scenes of
    # more than 4096 triangles), True/False force it on or off.
    wavefront: Optional[bool] = None
    remat: bool = True               # checkpoint the bounces (backward)
