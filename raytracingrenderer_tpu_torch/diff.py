"""Differentiable rendering: gradients of the path-traced estimate with
respect to scene parameters, and SGD steps on them.

Counterpart of raytracingrenderer_tpu/diff.py.  The same estimator: the
discrete path structure (hit ids, barycentrics from the kernels, RR and
lobe decisions, occlusion bits) is detached, radiometric quantities and
the hit-point reparameterisation (integrators/common.shading_data with
geom_grads) carry gradients: the interior term.  With
cfg.boundary_grads the NEE visibility boundary term joins it
(integrators/boundary.py, edge sampling with two-sided probes): the
gradient of a shadow edge that moves with the geometry, which the
interior term misses.  The parameters and their keys are the JAX
package's: `albedo`, `emission`, `alpha` (materials), `light_le` (the
light table's radiance), `tri_p0` (each triangle's anchor vertex; e1
and e2 ride along, so a triangle translates rigidly) and, where the
background is an environment map, `env_data` (its texel radiance; the
alias table and the pdf stay the fixed, detached sampling distribution).

Where JAX takes jax.value_and_grad of a pure function, here the
parameters become leaf tensors with requires_grad, the image is rendered
with autograd recording, and torch.autograd.grad returns the gradients.
The traversal kernels run under torch.no_grad (geometry/intersect.py):
none has, or needs, a backward; the one kernel of the backward is the
transpose of the shading path's row gathers (ops/gather.py).  SGD is
out of place (p - lr * g), so a step's scene holds new tensors and the
kernels' cached tables (keyed on them) are packed again.  A step that
moves `tri_p0` leaves the BVH bounds and the light table's geometry copy
stale: call geometry.refit.refit(scene) after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Tuple

import torch

from .config import RenderConfig
from .core.vec import V3
from .sampling import rng
from .scene.types import Scene
from .utils.profiling import span, spanned

# every scene's parameters; an envmap scene's add ENV_KEY
PARAM_KEYS = ("albedo", "emission", "alpha", "light_le", "tri_p0")
ENV_KEY = "env_data"


def param_keys(params) -> Tuple[str, ...]:
    """The keys of `params` in their fixed order."""
    return PARAM_KEYS + ((ENV_KEY,) if ENV_KEY in params else ())


def _split_scene(scene: Scene):
    """(differentiable parameters by key, the scene as the rest)."""
    params = dict(
        albedo=scene.materials.albedo,
        emission=scene.materials.emission,
        alpha=scene.materials.alpha,
        light_le=scene.lights.le,
        tri_p0=scene.triangles.p0,
    )
    if scene.background.envmap is not None:
        params[ENV_KEY] = scene.background.envmap.data
    return params, scene


def _merge_scene(params, scene: Scene) -> Scene:
    mats = scene.materials._replace(albedo=params["albedo"],
                                    emission=params["emission"],
                                    alpha=params["alpha"])
    lights = scene.lights._replace(le=params["light_le"])
    tris = scene.triangles._replace(p0=params["tri_p0"])
    out = scene._replace(materials=mats, lights=lights, triangles=tris)
    if ENV_KEY in params:
        from .lights.envmap import with_data
        bg = scene.background
        out = out._replace(background=dataclasses.replace(
            bg, envmap=with_data(bg.envmap, params[ENV_KEY])))
    return out


def _leaves(params) -> list:
    """The parameters' tensors in key order (a V3 componentwise)."""
    out = []
    for k in param_keys(params):
        p = params[k]
        out.extend(p if isinstance(p, V3) else (p,))
    return out


def _rebuild(params, flat) -> Dict:
    """`flat` (in `_leaves` order) in the structure of `params`."""
    out, i = {}, 0
    for k in param_keys(params):
        if isinstance(params[k], V3):
            out[k] = V3(*flat[i:i + 3])
            i += 3
        else:
            out[k] = flat[i]
            i += 1
    return out


def render_loss(params, scene: Scene, target: torch.Tensor, key,
                cfg: RenderConfig, sample: Callable = None) -> torch.Tensor:
    """MSE of one sample per pixel against `target`.  `sample` is the
    image function (render.sample_image by default)."""
    if sample is None:
        from .render import sample_image as sample
    img = sample(_merge_scene(params, scene), key, cfg)
    return torch.mean((img - target) ** 2)


def _diff_cfg(cfg: RenderConfig, scene: Scene) -> RenderConfig:
    """cfg for a gradient pass: the scene's material set filled in and
    geom_grads on (boundary_grads as the caller set it).  Refuses what is
    not ported yet."""
    from .render import _check_supported, specialize_config
    _check_supported(cfg)
    return dataclasses.replace(specialize_config(cfg, scene),
                               geom_grads=True)


def value_and_grad(scene: Scene, target: torch.Tensor, key,
                   cfg: RenderConfig, sample: Callable = None,
                   around: Callable = None) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients by parameter key) of render_loss at the scene's
    parameters, with `cfg` as given (callers pass `_diff_cfg`'s).
    `around(half)`, where given, makes a context manager that is entered
    around each half, "forward" (render_loss, recorded for autograd) then
    "backward" (torch.autograd.grad): probes.profile_train_step times the
    halves through it."""
    if around is None:
        around = lambda half: contextlib.nullcontext()  # noqa: E731
    params, _ = _split_scene(scene)
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    live = _rebuild(params, leaves)
    with torch.enable_grad():
        with around("forward"), span("rtr.forward"):
            loss = render_loss(live, scene, target, key, cfg, sample)
        with around("backward"), span("rtr.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _rebuild(params, grads)


@spanned("rtr.sgd")
def _sgd(scene: Scene, grads, lr: float) -> Scene:
    """p - lr * g for every parameter: new tensors, no graph."""
    params, _ = _split_scene(scene)
    with torch.no_grad():
        new = [p.detach() - lr * g
               for p, g in zip(_leaves(params), _leaves(grads))]
    return _merge_scene(_rebuild(params, new), scene)


def loss_and_grads(scene: Scene, target, key, cfg: RenderConfig,
                   around: Callable = None) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients by parameter key), dispatched as render() does:
    BVH-scale scenes (or cfg.wavefront) through the compacting wavefront,
    the rest through the scan.  `around` as in value_and_grad."""
    from .render import _use_wavefront
    if _use_wavefront(scene, cfg):
        from .integrators import wavefront_diff
        return wavefront_diff.loss_and_grads(scene, target, key, cfg, around)
    return value_and_grad(scene, target, key, _diff_cfg(cfg, scene),
                          around=around)


@spanned("rtr.train_step")
def train_step(scene: Scene, target: torch.Tensor, key, cfg: RenderConfig,
               lr: float = 0.1) -> Tuple[Scene, torch.Tensor]:
    """One SGD step on (albedo, emission, roughness, light Le, vertex
    positions) -> (new scene, loss).  BVH-scale scenes take the
    compacting wavefront backward (integrators/wavefront_diff.py), the
    policy render() uses for the forward; cfg.wavefront forces it.  The
    gradients are equal either way (tests/test_torch_diff.py)."""
    loss, grads = loss_and_grads(scene, target, key, cfg)
    return _sgd(scene, grads, lr), loss


def train_steps(scene: Scene, target: torch.Tensor, base_key,
                cfg: RenderConfig, lr: float = 0.1, n: int = 8):
    """`n` SGD steps, step i keyed by rng.fold_in(base_key, i): the JAX
    package's lax.scan over steps as a Python loop, so it equals n
    sequential train_step calls with those keys.  Returns (scene, (n,)
    losses)."""
    losses = []
    for i in range(n):
        scene, loss = train_step(scene, target, rng.fold_in(base_key, i),
                                 cfg, lr)
        losses.append(loss)
    return scene, torch.stack(losses)


def param_grads(scene: Scene, target: torch.Tensor, key,
                cfg: RenderConfig) -> Dict:
    """Gradients only, by parameter key (for gradient checks), through
    the scan integrator as in the JAX package."""
    return value_and_grad(scene, target, key, _diff_cfg(cfg, scene))[1]
