"""Differentiable compacting wavefront: gradients through the host-level
bounce loop of integrators/wavefront.py.

Counterpart of raytracingrenderer_tpu/integrators/wavefront_diff.py.
There, jax.grad cannot wrap a host loop whose widths depend on the data,
so the JAX package records a tape of each bounce's inputs and traversal
results and chains the VJPs by hand in reverse.  PyTorch's autograd
records that loop as it runs, so here the forward wavefront itself runs
with gradients enabled:

  - each bounce is checkpointed (path.step, with cfg.remat): it keeps its
    inputs and its hits and occlusion bits, and the backward runs it
    again with them replayed, at the compacted width, walking nothing;
  - the coherence sort is a gather (its backward a scatter), the slice
    to the width bucket a view, and the dead rays' radiance flush an
    index_add into the image (its backward a gather).

Every random decision is keyed by pixel id, so the widths and the image
are the forward wavefront's bit for bit, and the gradients equal the
scan integrator's to float tolerance (tests/test_torch_diff.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import RenderConfig
from ..scene.types import Scene


def loss_and_grads(scene: Scene, target: torch.Tensor, key,
                   cfg: RenderConfig) -> Tuple[torch.Tensor, Dict]:
    """MSE loss against `target` and its gradient by parameter key
    (diff.PARAM_KEYS), through the compacting wavefront: the
    counterpart of diff.value_and_grad for BVH-scale scenes."""
    from .. import diff
    from .wavefront import sample_image_wavefront
    return diff.value_and_grad(scene, target, key,
                               diff._diff_cfg(cfg, scene),
                               sample=sample_image_wavefront)


def train_step(scene: Scene, target: torch.Tensor, key, cfg: RenderConfig,
               lr: float = 0.1) -> Tuple[Scene, torch.Tensor]:
    """One SGD step through the wavefront backward -> (scene, loss)."""
    from .. import diff
    loss, grads = loss_and_grads(scene, target, key, cfg)
    return diff._sgd(scene, grads, lr), loss
