"""The slice whole: the port's `render` against the JAX package's on the
in-repo cornell box at 32x32, 2 spp, with the configuration bench.py
times first (mis, jitter, max_depth 4).

Both packages draw the same threefry numbers, so each pixel follows the
same paths; the images are compared per pixel: >= 99% of pixels within
rtol 1e-3 (atol 1e-6), and image means within 0.5%.  Tolerance, not bit
parity: a Russian-roulette or hit decision can flip on an ulp of a
transcendental function (XLA's CPU math against torch's)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.imaging import film as jfilm
from raytracingrenderer_tpu.render import render as jrender
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.io.hdr import read_hdr, write_hdr
from raytracingrenderer_tpu_torch.render import (pixel_grid, render,
                                                 sample_image,
                                                 specialize_config)
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from torch_scenes import write_cornell

torch.set_num_threads(2)

RES, SPP = 32, 2
BENCH = dict(mis=True, jitter=True, max_depth=4)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_cornell(str(tmp_path_factory.mktemp("cornell")), RES, RES)


@pytest.fixture(scope="module")
def scene(scene_dir):
    return load_scene(scene_dir, "cpu")


@pytest.fixture(scope="module")
def port_img(scene):
    return film_mod.to_hdr(render(scene, RenderConfig(**BENCH),
                                  spp=SPP)).numpy()


def _agree(a, b):
    close = np.isclose(a, b, rtol=1e-3, atol=1e-6).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


@pytest.mark.parametrize("cfg", [BENCH, dict(mis=False, jitter=False,
                                              max_depth=2)],
                         ids=["bench", "nomis"])
def test_render_matches_jax(scene_dir, scene, port_img, cfg):
    want = np.asarray(jfilm.to_hdr(jrender(
        jload(scene_dir, build_bvh=False), JConfig(**cfg), spp=SPP)))
    got = (port_img if cfg is BENCH else film_mod.to_hdr(
        render(scene, RenderConfig(**cfg), spp=SPP)).numpy())
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all()
    assert 0.03 < got.mean() < 0.5
    _agree(got, want)


def test_film_resume_and_on_sample(scene, port_img):
    cfg = RenderConfig(**BENCH)
    seen = []
    film = render(scene, cfg, spp=1, on_sample=lambda s, f: seen.append(s))
    film = render(scene, cfg, spp=1, film=film,
                  on_sample=lambda s, f: seen.append(s))
    assert seen == [0, 1] and film.spp.item() == 2.0
    np.testing.assert_array_equal(film_mod.to_hdr(film).numpy(), port_img)
    tm = film_mod.tonemap(film).numpy()
    assert tm.min() >= 0.0 and tm.max() <= 1.0


def test_sample_image_is_one_pass(scene):
    cfg = specialize_config(RenderConfig(**BENCH), scene)
    assert cfg.mat_types == (0,)
    img = sample_image(scene, rng.spp_key(rng.PRNGKey(0), 0), cfg)
    f = film_mod.add_sample_image(film_mod.new_film(RES, RES), img)
    first = render(scene, RenderConfig(**BENCH), spp=1)
    np.testing.assert_array_equal(f.buffer.numpy(), first.buffer.numpy())
    xs, ys = pixel_grid(2, 3)
    assert xs.tolist() == [0, 1, 2, 0, 1, 2] and ys.tolist() == [0, 0, 0,
                                                                  1, 1, 1]


def test_write_hdr_round_trip(tmp_path, port_img):
    path = os.path.join(tmp_path, "out.hdr")
    write_hdr(path, port_img)
    back = read_hdr(path)
    assert back.shape == port_img.shape
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    scale = port_img.max(-1, keepdims=True)
    assert (np.abs(back - port_img) <= scale / 128.0 + 1e-30).all()


@pytest.mark.parametrize("change", [
    dict(geom_grads=True), dict(boundary_grads=True),
    dict(wavefront=True), dict(integrator="lighttrace")])
def test_refuses_later_slices(scene, change):
    cfg = dataclasses.replace(RenderConfig(), **change)
    with pytest.raises(NotImplementedError):
        render(scene, cfg, spp=1)
