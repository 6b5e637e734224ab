"""The port's filters, film.splat and the AOV, light-tracer and VPL
integrators (integrators/aov.py, lighttracer.py, vpl.py, behind
integrators/dispatch.render_with) against the JAX package, on the
in-repo cornell box and on the cornell box under a 64 x 128 sky (area
lights and an envmap, so the light tracer's and the VPLs' background
branches run), at 24x24 and 32x32; tests/test_torch_render_with.py holds whole
render_with runs.

Tolerances: the filters and the splat within rtol 1e-5 / atol 1e-7
(the same float32 arithmetic; the splat's sums in index order on the
CPU).  Images, one pass or a whole render_with, hold the render tests'
bar: >= 99% of pixels within rtol 1e-3 / atol 1e-5 and means within
0.5% (a hit, a Russian-roulette decision or an occlusion bit can flip
on an ulp of XLA's CPU math against torch's).  The VPL table: kinds and
validity equal on >= 98% of slots, and on those slots every float field
within rtol 1e-4 / atol 1e-5 on >= 98% of them."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.imaging import film as jfilm
from raytracingrenderer_tpu.imaging import filters as jfilters
from raytracingrenderer_tpu.integrators import aov as jaov
from raytracingrenderer_tpu.integrators import lighttracer as jlt
from raytracingrenderer_tpu.integrators import vpl as jvpl
from raytracingrenderer_tpu.scene import camera as jcam
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.imaging import filters
from raytracingrenderer_tpu_torch.integrators import aov, lighttracer, vpl
from raytracingrenderer_tpu_torch.io.hdr import write_hdr
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene import camera as tcam
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from torch_scenes import sky_map, write_cornell

torch.set_num_threads(2)

RES = 32
CFG = dict(mis=True, jitter=True, max_depth=3)
VPL_CFG = dict(mis=True, jitter=True, max_depth=2)   # 200 slots a pass


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if hasattr(x, "stacked"):
        return _np(x.stacked()) if isinstance(x.x, torch.Tensor) \
            else np.asarray(x.stacked())
    return np.asarray(x)


def agree(a, b):
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


@pytest.fixture(scope="module")
def cornell_dir(tmp_path_factory):
    return write_cornell(str(tmp_path_factory.mktemp("cornell")), RES, RES)


@pytest.fixture(scope="module")
def cornell(cornell_dir):
    return load_scene(cornell_dir, "cpu"), jload(cornell_dir,
                                                  build_bvh=False)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The cornell box at 24x24 under a 64 x 128 sky as well."""
    d = write_cornell(str(tmp_path_factory.mktemp("mixed")), 24, 24)
    write_hdr(os.path.join(d, "sky.hdr"), sky_map(64, 128))
    with open(os.path.join(d, "scene.json")) as f:
        desc = json.load(f)
    desc["envmap"] = "sky.hdr"
    with open(os.path.join(d, "scene.json"), "w") as f:
        json.dump(desc, f)
    return load_scene(d, "cpu"), jload(d, build_bvh=False)


def _offsets(seed, n=2000):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-3.0, 3.0, n).astype(np.float32),
            rs.uniform(-3.0, 3.0, n).astype(np.float32))


@pytest.mark.parametrize("size", [0, 1, 2])
@pytest.mark.parametrize("name", ["box", "gaussian", "mitchell"])
def test_filters_match_jax(name, size):
    dx, dy = _offsets(1)
    got = getattr(filters, name)(torch.from_numpy(dx), torch.from_numpy(dy),
                                 size)
    want = getattr(jfilters, name)(jnp.asarray(dx), jnp.asarray(dy), size)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("size,name", [(0, "box"), (1, "box"),
                                       (1, "gaussian"), (1, "mitchell"),
                                       (2, "box"), (2, "gaussian"),
                                       (2, "mitchell")])
def test_splat_matches_jax(size, name):
    """Point samples inside and outside a 24 x 20 film onto a film that
    already holds radiance."""
    rs = np.random.RandomState(2 + size)
    n, h, w = 3000, 20, 24
    x = rs.uniform(-2.0, w + 2.0, n).astype(np.float32)
    y = rs.uniform(-2.0, h + 2.0, n).astype(np.float32)
    rgb = rs.rand(n, 3).astype(np.float32)
    buf = rs.rand(h, w, 3).astype(np.float32)
    tbuf = torch.from_numpy(buf.copy())
    got = film_mod.splat(
        film_mod.Film(tbuf, torch.tensor(3.0)),
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(rgb),
        size, name)
    want = jfilm.splat(jfilm.Film(jnp.asarray(buf), jnp.float32(3.0)),
                       jnp.asarray(x), jnp.asarray(y), jnp.asarray(rgb),
                       size, name)
    np.testing.assert_allclose(_np(got.buffer), _np(want.buffer),
                               rtol=1e-5, atol=1e-6)
    assert float(got.spp) == 3.0
    # the film passed in is left as it was
    np.testing.assert_array_equal(_np(tbuf), buf)


def test_view_direction_matches_jax(cornell):
    ts, js = cornell
    np.testing.assert_allclose(_np(tcam.view_direction(ts.camera)),
                               _np(jcam.view_direction(js.camera)),
                               rtol=1e-6, atol=1e-7)
    d = V3.of(0.1, -0.2, -0.97).normalize()
    from raytracingrenderer_tpu.core.vec import V3 as JV3
    jd = JV3.of(0.1, -0.2, -0.97).normalize()
    assert float(tcam.cos_theta_to_pixel(ts.camera, d)) == pytest.approx(
        float(jcam.cos_theta_to_pixel(js.camera, jd)), rel=1e-6)


@pytest.mark.parametrize("fn", ["direct_image", "albedo_image",
                                "normals_image"])
@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_aov_images_match_jax(request, which, fn):
    ts, js = request.getfixturevalue(which)
    got = _np(getattr(aov, fn)(ts, rng.PRNGKey(3), RenderConfig(**CFG)))
    want = _np(getattr(jaov, fn)(js, jax.random.PRNGKey(3), JConfig(**CFG)))
    cam = ts.camera
    assert got.shape == want.shape == (cam.height, cam.width, 3)
    agree(got, want)


@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_light_trace_pass_matches_jax(request, which):
    """One pass of 1500 light paths (not the film's pixel count) onto a
    film that already holds a pass."""
    ts, js = request.getfixturevalue(which)
    cam = ts.camera
    buf = np.random.RandomState(4).rand(cam.height, cam.width, 3) \
        .astype(np.float32) * 0.1
    got = lighttracer.light_trace_pass(
        ts, film_mod.Film(torch.from_numpy(buf), torch.tensor(1.0)),
        rng.PRNGKey(5), RenderConfig(**CFG), 1500)
    want = jlt.light_trace_pass(
        js, jfilm.Film(jnp.asarray(buf), jnp.float32(1.0)),
        jax.random.PRNGKey(5), JConfig(**CFG), 1500)
    assert float(got.spp) == float(want.spp) == 2.0
    agree(_np(got.buffer), _np(want.buffer))
    assert _np(got.buffer).sum() > buf.sum()


@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_trace_vpls_matches_jax(request, which):
    ts, js = request.getfixturevalue(which)
    cfg = dict(CFG, max_depth=4)
    got = vpl.trace_vpls(ts, rng.PRNGKey(6), RenderConfig(**cfg))
    want = jvpl.trace_vpls(js, jax.random.PRNGKey(6), JConfig(**cfg))
    n = vpl.MAX_VPL * (cfg["max_depth"] + 2)
    assert got.valid.shape == (n,)
    kind, valid = _np(got.kind), _np(got.valid)
    same = (kind == _np(want.kind)) & (valid == _np(want.valid))
    assert same.mean() >= 0.98, same.mean()
    if which == "mixed":
        assert (kind == vpl.VPL_BG).any() and (kind == vpl.VPL_EMITTER).any()
    assert valid[n // 6:].any()          # bounces deposited VPLs
    fields = [("x", got.x, want.x), ("n", got.n, want.n),
              ("wo", got.wo, want.wo), ("le", got.le, want.le)]
    fields += [(f"mp.{f}", getattr(got.mp, f), getattr(want.mp, f))
               for f in got.mp._fields]
    for name, a, b in fields:
        a, b = _np(a), _np(b)
        assert a.shape[0] == n, name
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5).reshape(n, -1).all(1)
        assert (close[same]).mean() >= 0.98, (name, close[same].mean())


def test_vpl_pass_matches_jax(mixed):
    """One whole pass (trace_vpls, then the gather over 200 slots) on the
    scene with an envmap; the cornell box's runs in render_with."""
    ts, js = mixed
    cam = ts.camera
    got = vpl.vpl_pass(ts, film_mod.new_film(cam.height, cam.width),
                       rng.PRNGKey(7), RenderConfig(**VPL_CFG))
    want = jvpl.vpl_pass(js, jfilm.new_film(cam.height, cam.width),
                         jax.random.PRNGKey(7), JConfig(**VPL_CFG))
    assert float(got.spp) == 1.0
    img = _np(got.buffer)
    assert np.isfinite(img).all() and img.mean() > 0.0
    agree(img, _np(want.buffer))
