"""A data-parallel training step whose gradient all_reduce runs inside the
backward, one a bounce.

Counterpart of raytracingrenderer_tpu/parallel/overlap.py.  Each rank
traces its band of the pixels (ceil(H * W / size) a rank) with the
parameters replicated.  The parameters enter every bounce through
`_AllreduceInBwd`, an identity whose backward starts an asynchronous
all_reduce of that bounce's parameter gradient and keeps the handle.
The backward reaches bounce k's identity as soon as bounce k's backward
is done, so its reduction runs while bounce k-1's backward computes:
the data-parallel bucket overlap, a bucket a bounce.  The step waits on
every handle before it reads the gradients.  overlap=False applies the
identity once, outside the bounces: one reduction at the end of the
backward, the barriered baseline.  sum_k allreduce(g_k) =
allreduce(sum_k g_k), so the two give the same gradients up to the
order of the float sums.

The identity sits outside path.step's checkpoint, so the recompute of a
checkpointed bounce (cfg.remat) runs its forward again and never its
backward: one reduction a bounce (`reductions` counts them).  Its
outputs alias the parameters, so the kernels' packed tables, keyed on
the vertex arrays (scene/types.same_data), are not packed again a
bounce.  The identity's backward hands autograd no gradient: the
reduced buckets are the gradients.

Pixel jitter is keyed by the pixel's global id (rng.uniform_ids), and so
is every path decision (path.init_state), so the estimate does not
depend on the number of ranks; render.sample_image keys its jitter by
lane, so diff.param_grads agrees with this step with jitter off.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..config import RenderConfig
from ..core.vec import V3
from ..integrators import path as path_mod
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene
from .mesh import Mesh

reductions = 0   # all_reduces the in-backward reduction has started


class _Bucket:
    """The parameter gradients' reductions of one step: each reduction
    is a flat copy of the gradients, reduced in place asynchronously."""

    def __init__(self, mesh: Mesh, leaves: List[torch.Tensor]):
        self.mesh = mesh
        self.shapes = [p.shape for p in leaves]
        self.numel = sum(p.numel() for p in leaves)
        self.device = leaves[0].device
        self.pending = []

    def reduce(self, grads) -> None:
        global reductions
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        work = self.mesh.all_reduce(flat, async_op=True)
        self.pending.append((work, flat))
        reductions += 1

    def wait(self, expected: int) -> List[torch.Tensor]:
        """The reduced gradients in the leaves' shapes, after every
        handle is waited on.  A rank whose backward made fewer reductions
        than `expected` (a band with no pixels) reduces zeros for the
        rest, so that every rank makes the same collectives."""
        while len(self.pending) < expected:
            self.reduce([torch.zeros(self.numel, device=self.device)])
        total = None
        for work, flat in self.pending:
            if work is not None:
                work.wait()
            total = flat if total is None else total + flat
        return [g.reshape(s) for g, s in
                zip(torch.split(total, [s.numel() for s in self.shapes]),
                    self.shapes)]


class _AllreduceInBwd(torch.autograd.Function):
    """Identity on the parameters' tensors whose backward starts the
    bucket's reduction of their gradients and returns none to autograd."""

    @staticmethod
    def forward(ctx, bucket: _Bucket, *leaves):
        ctx.bucket = bucket
        return tuple(p.view_as(p) for p in leaves)

    @staticmethod
    def backward(ctx, *grads):
        ctx.bucket.reduce(grads)
        return (None,) * (1 + len(grads))


def _through(leaves, params, bucket: _Bucket):
    """The parameters rebuilt from the identity's outputs."""
    from ..diff import _rebuild
    return _rebuild(params, list(_AllreduceInBwd.apply(bucket, *leaves)))


def _trace_shard(leaves, params, scene: Scene, lo: int, hi: int, key,
                 cfg: RenderConfig, overlap: bool, bucket: _Bucket) -> V3:
    """Radiance of pixels [lo, hi) in raster order, each drawing by its
    global id; the parameters enter every bounce through the identity
    (overlap) or once before the first (the barriered baseline)."""
    from ..diff import _merge_scene
    w = scene.camera.width
    ids = torch.arange(lo, hi, dtype=torch.int64, device=scene.device)
    xs = (ids % w).to(torch.float32)
    ys = (ids // w).to(torch.float32)
    if cfg.jitter:
        jx = rng.uniform_ids(key, 0, rng.PIXEL_JITTER_X, ids)
        jy = rng.uniform_ids(key, 0, rng.PIXEL_JITTER_Y, ids)
    else:
        jx = jy = 0.5
    fixed = None if overlap else _through(leaves, params, bucket)
    o, d = generate_rays(scene.camera, xs + jx, ys + jy)
    state = path_mod.init_state(o, d, lo)
    for depth in range(cfg.max_depth + 2):
        p = _through(leaves, params, bucket) if overlap else fixed
        state = path_mod.step(_merge_scene(p, scene), state, depth, key,
                              cfg)
    return state["radiance"]


def _sharded_step(scene: Scene, target: torch.Tensor, key,
                  cfg: RenderConfig, mesh: Mesh, overlap: bool
                  ) -> Tuple[torch.Tensor, Dict]:
    """(loss over every pixel, reduced gradients by key) on every rank."""
    from ..diff import _leaves, _rebuild, _split_scene
    params, _ = _split_scene(scene)
    cam = scene.camera
    n = cam.height * cam.width
    lo, hi = mesh.band(n)
    dev = scene.device
    tgt = target.reshape(n, 3)[lo:hi]
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    bucket = _Bucket(mesh, leaves)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    if hi > lo:
        with torch.enable_grad():
            rad = _trace_shard(leaves, params, scene, lo, hi, key, cfg,
                               overlap, bucket)
            err = rad.stacked() - tgt
            # this band's sum over the global pixel count: the reductions
            # make the replicated parameters' gradients global
            loss = torch.sum(err * err) / (n * 3.0)
            torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = bucket.wait(cfg.max_depth + 2 if overlap else 1)
    loss = loss.detach().clone()
    mesh.all_reduce(loss)
    return loss, _rebuild(params, grads)


def train_step_overlap(scene: Scene, target: torch.Tensor, key,
                       cfg: RenderConfig, mesh: Mesh, lr: float = 0.1,
                       overlap: bool = True) -> Tuple[Scene, torch.Tensor]:
    """One SGD step over `mesh` -> (new scene, loss), the same on every
    rank.  overlap=True: a reduction a bounce inside the backward;
    overlap=False: the same gradients with one reduction at its end."""
    from ..diff import _diff_cfg, _sgd
    loss, grads = _sharded_step(scene, target, key, _diff_cfg(cfg, scene),
                                mesh, overlap)
    return _sgd(scene, grads, lr), loss


def param_grads_sharded(scene: Scene, target: torch.Tensor, key,
                        cfg: RenderConfig, mesh: Mesh,
                        overlap: bool = True) -> Tuple[Dict, torch.Tensor]:
    """(gradients by parameter key, loss) under the step's schedule."""
    from ..diff import _diff_cfg
    loss, grads = _sharded_step(scene, target, key, _diff_cfg(cfg, scene),
                                mesh, overlap)
    return grads, loss
