"""The port's environment map (lights/envmap.py, the BG_ENVMAP branches of
lights/lights.py, the loader's envmap background, env_data in diff.py)
against the JAX package, on a synthetic 64 x 128 sky with a sun
(tests/torch_scenes.py::sky_map, times a random texture from a numpy
seed) and on the write_sky scene (5,122 triangles, 32x32).

Tolerances: the tables are host numpy in float64 in both packages, so
`alias_row` (the native builder in both) and the Vose fallback are
equal, the rest within rtol 1e-6.  The lookups go through atan2, acos,
sin and cos, which XLA's CPU math and torch's round an ulp apart, so a
lane's texel can move by one, and the bilinear fractions carry that ulp
into the value (times the step to the neighbour texel: the sun's edge is
a 10^3 step): texel ids equal, and values within rtol 1e-5 / atol 1e-6,
on >= 99.9% of 4096 lanes.  `sample_le`'s
slot pick is float32 products and truncations, equal on every lane.
Renders and gradients hold the render and diff tests' bars (>= 99% of
pixels within rtol 1e-3 / atol 1e-5, means within 0.5%; loss rel 1e-4,
arrays rtol 1e-3 / atol 1e-3 * max|g|, tri_p0 relative L2 1e-2)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu import diff as jdiff
from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.geometry import bvh_native as jnative
from raytracingrenderer_tpu.imaging import film as jfilm
from raytracingrenderer_tpu.lights import envmap as jenv
from raytracingrenderer_tpu.lights import lights as jlights
from raytracingrenderer_tpu.render import render as jrender
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch import diff
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.io.hdr import write_hdr
from raytracingrenderer_tpu_torch.lights import envmap
from raytracingrenderer_tpu_torch.lights import lights
from raytracingrenderer_tpu_torch.render import render
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.convert import scene_from_numpy
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from raytracingrenderer_tpu_torch.scene.types import BG_ENVMAP
from torch_scenes import sky_map, write_cornell, write_sky

torch.set_num_threads(2)

H, W = 64, 128
LANES = 4096
RES = 32


@pytest.fixture(scope="module")
def sky_img():
    rs = np.random.RandomState(7)
    return (sky_map(H, W) * (0.5 + rs.rand(H, W, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def envs(sky_img):
    return envmap.build_envmap(sky_img, "cpu"), jenv.build_envmap(sky_img)


@pytest.fixture(scope="module")
def sky_dir(tmp_path_factory):
    return write_sky(str(tmp_path_factory.mktemp("sky")), RES, RES,
                     subdiv=2, env_h=H, env_w=W)


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory, sky_img):
    """The cornell box (two area lights) under the sky as well."""
    d = write_cornell(str(tmp_path_factory.mktemp("mixed")), 24, 24)
    write_hdr(os.path.join(d, "sky.hdr"), sky_img)
    with open(os.path.join(d, "scene.json")) as f:
        desc = json.load(f)
    desc["envmap"] = "sky.hdr"
    with open(os.path.join(d, "scene.json"), "w") as f:
        json.dump(desc, f)
    return d


@pytest.fixture(scope="module")
def mixed(mixed_dir):
    return load_scene(mixed_dir, "cpu"), jload(mixed_dir)


def _dirs(seed, n=LANES):
    """Unit directions from a numpy seed, as (torch V3, JAX V3)."""
    a = np.random.RandomState(seed).randn(3, n).astype(np.float32)
    a /= np.linalg.norm(a, axis=0)
    return (V3(*(torch.from_numpy(c.copy()) for c in a)),
            JV3(*(jnp.asarray(c) for c in a)))


def _u(seed, n=LANES):
    u = np.random.RandomState(seed).rand(n).astype(np.float32)
    return torch.from_numpy(u), jnp.asarray(u)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if hasattr(x, "stacked"):
        return _np(x.stacked()) if isinstance(x.x, torch.Tensor) \
            else np.asarray(x.stacked())
    return np.asarray(x)


def _texels(u, v):
    return np.floor(_np(u) * W).astype(int), np.floor(_np(v) * H).astype(int)


def test_build_envmap_matches_jax(envs):
    te, je = envs
    assert hasattr(jnative._load(), "alias_build")
    np.testing.assert_array_equal(_np(te.alias_row), _np(je.alias_row))
    for f in ("data", "texel_row", "pdf2d", "mean_power"):
        np.testing.assert_allclose(_np(getattr(te, f)), _np(getattr(je, f)),
                                   rtol=1e-6, atol=0, err_msg=f)
    assert te.mean_power.shape == ()


def test_alias_fallback_matches_jax(monkeypatch, sky_img):
    """The Vose fallback pops as JAX's fallback and as the native
    builder do: the three tables are equal."""
    p = np.random.RandomState(3).rand(H * W) ** 4
    p = p / p.sum()
    prob, alias = envmap._alias_vose(p)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    jprob, jalias = jenv._alias_table(p)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(alias, jalias)
    nprob, nalias = envmap._alias_table(p)
    np.testing.assert_array_equal(prob, nprob)
    np.testing.assert_array_equal(alias, nalias)
    # an alias table reproduces the pmf
    back = prob.astype(np.float64)
    np.add.at(back, alias, 1.0 - prob)
    np.testing.assert_allclose(back / len(p), p, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("fn", ["dir_to_uv", "uv_to_dir", "evaluate",
                                "pdf"])
def test_lookups_match_jax(envs, fn):
    te, je = envs
    if fn == "uv_to_dir":
        (u, ju), (v, jv) = _u(1), _u(2)
        np.testing.assert_allclose(_np(envmap.uv_to_dir(u, v)),
                                   _np(jenv.uv_to_dir(ju, jv)),
                                   rtol=1e-5, atol=1e-6)
        return
    d, jd = _dirs(4)
    u, v = envmap.dir_to_uv(d)
    ju, jv = jenv.dir_to_uv(jd)
    tx, ty = _texels(u, v)
    jx, jy = _texels(ju, jv)
    same = (tx == jx) & (ty == jy)
    assert same.mean() >= 0.999, same.mean()
    if fn == "dir_to_uv":
        got, want = np.stack([_np(u), _np(v)]), np.stack([_np(ju), _np(jv)])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    got = _np(getattr(envmap, fn)(te, d))
    want = _np(getattr(jenv, fn)(je, jd))
    _mostly_equal(got, want, same)


def _mostly_equal(got, want, same):
    """Texel ids and values agree on >= 99.9% of lanes."""
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    close = close.reshape(len(same), -1).all(1) & same
    assert close.mean() >= 0.999, close.mean()


@pytest.mark.parametrize("aux", [True, False], ids=["r3", "folded"])
def test_sample_le_matches_jax(envs, aux):
    te, je = envs
    (r1, j1), (r2, j2), (r3, j3) = _u(5), _u(6), _u(7)
    wi, pdf, le = envmap.sample_le(te, r1, r2, r3 if aux else None)
    jwi, jpdf, jle = jenv.sample_le(je, j1, j2, j3 if aux else None)
    # the slot pick is float32 products and truncations: the same texel
    np.testing.assert_array_equal(_np(le), _np(jle))
    np.testing.assert_allclose(_np(wi), _np(jwi), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(pdf), _np(jpdf), rtol=1e-5)
    swi, spdf = envmap.sample(te, r1, r2)
    np.testing.assert_array_equal(_np(spdf), _np(envmap.sample_le(
        te, r1, r2)[1]))


def test_pdf_of_sample_is_its_pdf(envs):
    """pdf() at a sampled direction is the sampling pdf, where the
    recomputed (u, v) falls in the sampled texel (all but the lanes an
    ulp from a texel's edge)."""
    te, _ = envs
    (r1, _), (r2, _), (r3, _) = _u(8), _u(9), _u(10)
    wi, pdf_s, _ = envmap.sample_le(te, r1, r2, r3)
    ratio = _np(envmap.pdf(te, wi)) / _np(pdf_s)
    ok = np.isclose(ratio, 1.0, rtol=1e-4)
    assert ok.mean() >= 0.999, ok.mean()


def test_sample_le_is_unbiased(envs):
    """E[le cos / pdf] about +y equals the texel quadrature (each texel's
    radiance constant over its cell) within 3 sigma."""
    te, _ = envs
    n = 1 << 18
    g = torch.Generator().manual_seed(11)
    r1, r2, r3 = (torch.rand(n, generator=g) for _ in range(3))
    wi, pdf, le = envmap.sample_le(te, r1, r2, r3)
    x = (le.lum() * torch.clamp(wi.y, min=0.0) / pdf).double().numpy()
    img = _np(te.data).astype(np.float64)
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    th = np.arange(H + 1) / H * np.pi
    # int over a row of cos+ sin dtheta dphi = dphi (sin^2 b - sin^2 a)/2
    c = np.clip(np.cos(th), 0.0, None)
    s2 = 1.0 - c * c
    row = np.where(np.cos(th[1:]) >= 0.0, (s2[1:] - s2[:-1]) / 2.0, 0.0)
    want = (lum * row[:, None]).sum() * (2 * np.pi / W)
    assert abs(x.mean() - want) <= 3.0 * x.std() / np.sqrt(n), (
        x.mean(), want)


def test_with_data(envs):
    te, _ = envs
    data = (te.data * 2.0).requires_grad_(True)
    e2 = envmap.with_data(te, data)
    assert e2.data is data
    np.testing.assert_array_equal(_np(e2.texel_row[:, :3]),
                                  _np(data.reshape(-1, 3)))
    np.testing.assert_array_equal(_np(e2.texel_row[:, 3]),
                                  _np(te.texel_row[:, 3]))
    assert e2.alias_row is te.alias_row and e2.pdf2d is te.pdf2d
    (g,) = torch.autograd.grad(e2.texel_row[:, :3].sum(), data)
    assert float(g.sum()) == H * W * 3


@pytest.mark.parametrize("what", ["eval_background", "background_pdf",
                                  "selection_pmf", "selection_pmf_power",
                                  "sample_one", "sample_one_power"])
def test_background_matches_jax(mixed, what):
    ts, js = mixed
    assert ts.background.kind == BG_ENVMAP
    assert lights.background_enabled(ts) and jlights.background_enabled(js)
    assert lights.num_lights(ts) == jlights.num_lights(js) == 3
    power = what.endswith("power")
    if what.startswith("selection_pmf"):
        pa, pb = lights.selection_pmf(ts, power)
        ja, jb = jlights.selection_pmf(js, power)
        np.testing.assert_allclose(_np(pa), _np(ja), rtol=1e-6)
        np.testing.assert_allclose(_np(pb), _np(jb), rtol=1e-6)
        return
    d, jd = _dirs(12)
    if what in ("eval_background", "background_pdf"):
        got = _np(getattr(lights, what)(ts, d))
        want = _np(getattr(jlights, what)(js, jd))
        u, v = envmap.dir_to_uv(d)
        ju, jv = jenv.dir_to_uv(jd)
        same = np.all(np.stack(_texels(u, v)) == np.stack(_texels(ju, jv)),
                      axis=0)
        _mostly_equal(got, want, same)
        return
    # shading points inside the box, normals the sampled directions
    p = np.random.RandomState(13).rand(3, LANES).astype(np.float32)
    p = p * np.array([[1.6], [1.8], [1.6]], np.float32) \
        - np.array([[0.8], [-0.1], [0.8]], np.float32)
    x = V3(*(torch.from_numpy(c.copy()) for c in p))
    jx = JV3(*(jnp.asarray(c) for c in p))
    us = [_u(20 + i) for i in range(4)]
    got = lights.sample_one(ts, x, d, *(u for u, _ in us), power=power)
    want = jlights.sample_one(js, jx, jd, *(j for _, j in us), power=power)
    for f in got._fields:
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        if a.dtype == bool:
            assert (a == b).mean() >= 0.999, f
        else:
            close = np.isclose(a, b, rtol=1e-4, atol=1e-6)
            assert close.reshape(LANES, -1).all(1).mean() >= 0.999, f


def test_load_sky_scene_matches_jax(sky_dir):
    ts = load_scene(sky_dir, "cpu")
    js = jload(sky_dir)
    assert ts.triangles.count == 5122 and ts.num_lights == 0
    assert ts.background.kind == js.background.kind == BG_ENVMAP
    for f in ts.background.envmap._fields:
        np.testing.assert_array_equal(_np(getattr(ts.background.envmap, f)),
                                      _np(getattr(js.background.envmap, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(_np(ts.triangles.p0),
                                  _np(js.triangles.p0))
    np.testing.assert_array_equal(_np(ts.bvh.lo), _np(js.bvh.lo))
    # a missing map falls back to a constant one, as in JAX
    with open(os.path.join(sky_dir, "scene.json")) as f:
        desc = json.load(f)
    os.rename(os.path.join(sky_dir, "sky.hdr"),
              os.path.join(sky_dir, "sky.bak"))
    try:
        t2 = load_scene(sky_dir, "cpu", build_bvh=False)
        assert tuple(t2.background.envmap.data.shape) == (2, 4, 3)
        assert desc["envmap"] == "sky.hdr"
    finally:
        os.rename(os.path.join(sky_dir, "sky.bak"),
                  os.path.join(sky_dir, "sky.hdr"))


def test_scene_from_numpy_carries_envmap(mixed):
    _, js = mixed
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert ts.background.kind == BG_ENVMAP
    for f in ts.background.envmap._fields:
        np.testing.assert_array_equal(
            _np(getattr(ts.background.envmap, f)),
            _np(getattr(js.background.envmap, f)), err_msg=f)


def _agree(a, b):
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


@pytest.fixture(scope="module")
def jax_sky_img(sky_dir):
    cfg = JConfig(mis=True, jitter=True, max_depth=3)
    return np.asarray(jfilm.to_hdr(jrender(jload(sky_dir), cfg, spp=2)))


@pytest.mark.parametrize("wave", [False, True], ids=["scan", "wavefront"])
def test_sky_render_matches_jax(sky_dir, jax_sky_img, wave):
    sc = load_scene(sky_dir, "cpu")
    cfg = RenderConfig(mis=True, jitter=True, max_depth=3, wavefront=wave)
    got = film_mod.to_hdr(render(sc, cfg, spp=2)).numpy()
    assert got.shape == jax_sky_img.shape == (RES, RES, 3)
    assert np.isfinite(got).all() and 0.03 < got.mean() < 0.5
    _agree(got, jax_sky_img)


def test_param_grads_env_data_match_jax(mixed_dir, mixed):
    """env_data joins the parameters (scan integrator, mis + jitter) and
    its gradient matches JAX's with the other keys'."""
    ts, js = mixed
    cfg = dict(max_depth=2, mis=True, jitter=True, rr=False)
    res = ts.camera.height
    loss, got = diff.value_and_grad(
        ts, torch.zeros((res, res, 3)), rng.PRNGKey(4),
        diff._diff_cfg(RenderConfig(**cfg), ts))
    assert diff.param_keys(got)[-1] == diff.ENV_KEY
    params, _ = jdiff._split_scene(js)
    jloss, want = jax.value_and_grad(jdiff.render_loss)(
        params, js, jnp.zeros((res, res, 3)), jax.random.PRNGKey(4),
        jdiff._diff_cfg(JConfig(**cfg), js))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    for k in diff.param_keys(got):
        a, b = _np(got[k]), _np(want[k])
        assert np.isfinite(a).all(), k
        if k == "tri_p0":
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-2, (k, rel)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=1e-3 * np.abs(b).max(),
                                       err_msg=k)
    assert float(np.abs(_np(got[diff.ENV_KEY])).max()) > 0
    # an SGD step moves env_data and keeps the sampling tables
    new = diff._sgd(ts, got, 0.1)
    env = new.background.envmap
    assert env.alias_row is ts.background.envmap.alias_row
    assert not torch.equal(env.data, ts.background.envmap.data)
    np.testing.assert_array_equal(_np(env.texel_row[:, :3]),
                                  _np(env.data.reshape(-1, 3)))
    assert dataclasses.is_dataclass(new.background)
