"""The slices whole: the port's `render` against the JAX package's on the
in-repo cornell box at 32x32, 2 spp, with the configuration bench.py
times first (mis, jitter, max_depth 4), and on the 5,156-triangle
spheres scene at 32x32, 2 spp (mis, jitter, max_depth 3), which both
packages render through the BVH and the wavefront integrator.

Both packages draw the same threefry numbers, so each pixel follows the
same paths; the images are compared per pixel: >= 99% of pixels within
rtol 1e-3 (atol 1e-6 on cornell, 1e-5 on the spheres), and image means
within 0.5%.  Tolerance, not bit parity: a Russian-roulette or hit
decision can flip on an ulp of a transcendental function (XLA's CPU
math against torch's).  The port's wavefront image equals its scan
image within rtol 1e-5 / atol 1e-6 (the same paths in another lane
order), with the default compaction width and with one small enough to
compact at this size."""
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
from raytracingrenderer_tpu_torch.geometry import intersect
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.integrators import wavefront
from raytracingrenderer_tpu_torch.io.hdr import read_hdr, write_hdr
from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
from raytracingrenderer_tpu_torch.render import (_use_wavefront, pixel_grid,
                                                 render, sample_image,
                                                 specialize_config)
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

RES, SPP = 32, 2
BENCH = dict(mis=True, jitter=True, max_depth=4)
SPHERES = dict(mis=True, jitter=True, max_depth=3)


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


@pytest.fixture(scope="module")
def spheres_dir(tmp_path_factory):
    return write_spheres(str(tmp_path_factory.mktemp("spheres")), RES, RES,
                         subdiv=2)


@pytest.fixture(scope="module")
def spheres(spheres_dir):
    return load_scene(spheres_dir, "cpu")


@pytest.fixture(scope="module")
def spheres_scan(spheres):
    cfg = RenderConfig(wavefront=False, **SPHERES)
    return film_mod.to_hdr(render(spheres, cfg, spp=SPP)).numpy()


def _agree(a, b, atol=1e-6):
    close = np.isclose(a, b, rtol=1e-3, atol=atol).all(-1).mean()
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


def test_spheres_render_matches_jax(spheres_dir, spheres):
    """The BVH leg: the port picks the wavefront integrator on its own,
    walks the packet route (plain versions here), never the stackless
    fall-back, and agrees with the JAX package per pixel."""
    cfg = RenderConfig(**SPHERES)
    assert _use_wavefront(spheres, cfg)
    before = intersect.stackless_calls
    got = film_mod.to_hdr(render(spheres, cfg, spp=SPP)).numpy()
    assert intersect.stackless_calls == before
    assert not any(bvh_kernel.launches.values())
    assert mt_kernel.launches == 0
    want = np.asarray(jfilm.to_hdr(jrender(jload(spheres_dir),
                                           JConfig(**SPHERES), spp=SPP)))
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all()
    assert 0.03 < got.mean() < 0.5
    _agree(got, want, atol=1e-5)


@pytest.mark.parametrize("min_width", [wavefront._MIN_WIDTH, 64],
                         ids=["no-compaction", "compacting"])
def test_wavefront_matches_scan(monkeypatch, spheres, spheres_scan,
                                min_width):
    monkeypatch.setattr(wavefront, "_MIN_WIDTH", min_width)
    widths = []
    step = wavefront.path_mod.bounce_step

    def spy(scene, state, *args, **kw):
        widths.append(state["alive"].shape[0])
        return step(scene, state, *args, **kw)

    monkeypatch.setattr(wavefront.path_mod, "bounce_step", spy)
    got = film_mod.to_hdr(render(spheres, RenderConfig(wavefront=True,
                                                       **SPHERES),
                                 spp=SPP)).numpy()
    np.testing.assert_allclose(got, spheres_scan, rtol=1e-5, atol=1e-6)
    assert widths[0] == RES * RES
    if min_width == 64:
        assert min(widths) < RES * RES     # live rays were compacted
    else:
        assert set(widths) == {RES * RES}
    assert wavefront._bucket(10, 1 << 20) == 1 << 17
    assert wavefront._bucket(70_000, 1 << 20) == 131_072
    assert wavefront._bucket(900_000, 1 << 20) == 917_504


@pytest.mark.parametrize("change", [
    dict(integrator="adaptive"),
    dict(integrator="vpl"), dict(integrator="lighttrace")])
def test_refuses_later_slices(scene, change):
    cfg = dataclasses.replace(RenderConfig(), **change)
    with pytest.raises(NotImplementedError):
        render(scene, cfg, spp=1)
