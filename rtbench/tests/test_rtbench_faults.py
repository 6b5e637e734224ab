"""A run with the timed path broken underneath comes out not correct:
every fault a cell can have, planted in the renderer, driven through the
whole run but the card's look (CPU, test size).  One chip, so no
exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from raytracingrenderer_tpu_torch import diff
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from rtbench import harness
from rtbench.tests.conftest import run_small

MAN = harness.manifest()
RENDER = [w["name"] for w in MAN["workloads"] if "render" in w["traffic"]]
TRAIN = [w["name"] for w in MAN["workloads"] if "train" in w["traffic"]]


def every_other(img):
    """Half of a pass's pixels left out (every second one)."""
    flat = img.reshape(-1, 3).clone()
    flat[1::2] = 0.0
    return flat.reshape(img.shape)


RENDER_FAULTS = {
    # a pass that leaves the film as it was
    "state_unchanged": lambda real: (lambda f, img, inc=1.0: f),
    "half_left_out": lambda real: (
        lambda f, img, inc=1.0: real(f, every_other(img), inc)),
    # each pass's image altered where it is produced
    "answer_altered": lambda real: (
        lambda f, img, inc=1.0: real(f, img * 1.01, inc)),
}


@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
@pytest.mark.parametrize("cell", RENDER)
def test_render_fault_is_caught(cell, fault, monkeypatch):
    real = film_mod.add_sample_image
    monkeypatch.setattr(film_mod, "add_sample_image",
                        RENDER_FAULTS[fault](real))
    out = run_small(cell, seconds=0.3)
    assert not out["correct"], out["checks"]


def unchanged_step(scene, target, key, cfg, lr=0.1):
    loss, _ = diff.loss_and_grads(scene, target, key, cfg)
    return scene, loss


def half_loss(real):
    def loss(params, scene, target, key, cfg, sample=None):
        if sample is None:
            from raytracingrenderer_tpu_torch.render import sample_image
            sample = sample_image
        img = sample(diff._merge_scene(params, scene), key, cfg)
        return torch.mean((img[::2] - target[::2]) ** 2)
    return loss


def altered_sgd(real):
    def sgd(scene, grads, lr):
        a = grads["albedo"]
        return real(scene, dict(grads, albedo=type(a)(*(1.1 * c for c in a))),
                    lr)
    return sgd


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_train_fault_is_caught(cell, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(diff, "train_step", unchanged_step)
    elif fault == "half_left_out":
        monkeypatch.setattr(diff, "render_loss", half_loss(diff.render_loss))
    else:
        monkeypatch.setattr(diff, "_sgd", altered_sgd(diff._sgd))
    out = run_small(cell, seconds=0.3)
    assert not out["correct"], out["checks"]
