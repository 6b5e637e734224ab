"""The port's light sampling against the JAX package on the in-repo
cornell box, converted with scene_from_numpy so both read identical
arrays: `sample_one` (uniform and power-weighted selection) and
`hit_light_pdf_solid`, rtol 1e-5 (atol 1e-6 for values near zero)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.lights import lights as jl
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu.scene.types import BG_CONST, BackgroundT
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.lights import lights as tl
from raytracingrenderer_tpu_torch.scene.convert import scene_from_numpy
from torch_scenes import write_cornell

torch.set_num_threads(2)

N = 2048
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = write_cornell(str(tmp_path_factory.mktemp("cornell")), 32, 32)
    js = jload(d, build_bvh=False)
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


def _with_const_background(js):
    return js._replace(background=BackgroundT(
        BG_CONST, JV3.of(0.2, 0.3, 0.4), None))


def _pair(a):
    return (JV3(*(jnp.asarray(a[:, i]) for i in range(3))),
            V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))))


def _shading_points(seed):
    g = np.random.default_rng(seed)
    x = (g.uniform(-0.9, 0.9, (N, 3)) + [0, 1, 0]).astype(np.float32)
    sn = g.standard_normal((N, 3))
    sn /= np.linalg.norm(sn, axis=1, keepdims=True)
    r = g.random((4, N)).astype(np.float32)
    return x, sn.astype(np.float32), r


def _close(got, want):
    if isinstance(got, V3):
        for a, b in zip(got, want):
            _close(a, b)
        return
    g_, w_ = got.numpy(), np.asarray(want)
    if g_.dtype == bool:
        np.testing.assert_array_equal(g_, w_)
    else:
        np.testing.assert_allclose(g_, w_, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("power,background", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_sample_one(scenes, power, background):
    js, ts = scenes
    if background:
        js = _with_const_background(js)
        ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    x, sn, r = _shading_points(seed=1 + 2 * power + background)
    (jx, tx), (jn, tn) = _pair(x), _pair(sn)
    want = jl.sample_one(js, jx, jn, *(jnp.asarray(v) for v in r[:3]),
                         jnp.asarray(r[3]), power=power)
    got = tl.sample_one(ts, tx, tn, *(torch.from_numpy(v) for v in r[:3]),
                        torch.from_numpy(r[3]), power=power)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))
    assert got.valid.float().mean() > 0.2
    assert tl.num_lights(ts) == jl.num_lights(js)


@pytest.mark.parametrize("power", [False, True])
def test_hit_light_pdf_solid(scenes, power):
    js, ts = scenes
    g = np.random.default_rng(5 + power)
    x, _, _ = _shading_points(seed=7)
    light_id = g.integers(-1, ts.num_lights, N).astype(np.int32)
    li = np.maximum(light_id, 0)
    lt = js.lights
    p0 = np.asarray(lt.p0.stacked())[li]
    e1 = np.asarray(lt.e1.stacked())[li]
    e2 = np.asarray(lt.e2.stacked())[li]
    b, c = g.random((2, N)).astype(np.float32) * 0.5
    hit_p = (p0 + e1 * b[:, None] + e2 * c[:, None]).astype(np.float32)
    gn = np.asarray(lt.gn.stacked())[li].astype(np.float32)
    (jx, tx), (jp, tp), (jg, tg) = _pair(x), _pair(hit_p), _pair(gn)
    want = jl.hit_light_pdf_solid(js, jnp.asarray(light_id), jx, jp, jg,
                                  power=power)
    got = tl.hit_light_pdf_solid(ts, torch.from_numpy(light_id), tx, tp, tg,
                                 power=power)
    _close(got, want)
    assert (got.numpy() > 0).mean() > 0.2


def test_background_helpers(scenes):
    js, ts = scenes
    _, d = _pair(_shading_points(seed=9)[1])
    assert not tl.background_enabled(ts)
    _close(tl.eval_background(ts, d), V3.zeros_like(d.x))
    js_c = _with_const_background(js)
    ts_c = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js_c))
    jd = JV3(*(jnp.asarray(c.numpy()) for c in d))
    assert tl.background_enabled(ts_c)
    _close(tl.eval_background(ts_c, d), jl.eval_background(js_c, jd))
    _close(tl.background_pdf(ts_c, d), jl.background_pdf(js_c, jd))
    for power in (False, True):
        tp, tb = tl.selection_pmf(ts_c, power)
        jp, jb = jl.selection_pmf(js_c, power)
        _close(tp, jp)
        _close(tb, jb)
