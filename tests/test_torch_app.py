"""The port's app layer against the JAX package's: the denoiser
(imaging/denoise.py), film checkpoints (utils/checkpoint.py), the
analytic primitives (geometry/primitives.py), the fly camera
(scene/controls.py), the interactive session (interactive.py), logging
and the profiling timer (utils/).

Inputs come from numpy.  The denoiser is held to JAX's within 1e-6
relative (+ 1e-6) with and without guides; checkpoints load across the
packages bit for bit; the primitives equal JAX's hit bits and t within
1e-6 relative on RTBase's RTtest cases and random batches; the fly
camera's state and matrices equal JAX's bit for bit (both in numpy);
a scripted session at 32x32 on the in-repo cornell box gives JAX's film
by the render tests' bar (>= 99% of pixels within rtol 1e-3 / atol
1e-5, means within 0.5%), and its .hdr and .png saves agree on >= 99%
of pixels within one RGBE mantissa step and one 8-bit level."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.core import matrix as jmatrix
from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.geometry import primitives as jprim
from raytracingrenderer_tpu.imaging import film as jfilm
from raytracingrenderer_tpu.imaging.denoise import denoise as jdenoise
from raytracingrenderer_tpu.interactive import run_scripted as jrun_scripted
from raytracingrenderer_tpu.scene.controls import FlyCamera as JFly
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu.utils import checkpoint as jck
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core import matrix
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import primitives as prim
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.imaging.denoise import denoise
from raytracingrenderer_tpu_torch.interactive import (InteractiveSession,
                                                      run_scripted)
from raytracingrenderer_tpu_torch.io.hdr import read_hdr
from raytracingrenderer_tpu_torch.io.png import read_png
from raytracingrenderer_tpu_torch.scene.controls import FlyCamera
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from raytracingrenderer_tpu_torch.utils import checkpoint, log, profiling
from test_torch_render_with import agree
from torch_scenes import write_cornell

torch.set_num_threads(2)

RES = 32


def within_rgbe_step(a, b, frac=0.99):
    """>= frac of the pixels of two decoded .hdr images within one RGBE
    mantissa step (2^(e-8) for the larger pixel's shared exponent e) on
    every channel, and means within 0.5%."""
    top = np.maximum(a.max(-1), b.max(-1))
    step = np.where(top > 0, np.ldexp(1.0, np.frexp(top)[1] - 8), 0.0)
    ok = (np.abs(a - b) <= step[..., None]).all(-1).mean()
    assert ok >= frac, ok
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


def within_one_level(a, b, frac=0.99):
    """>= frac of the pixels of two PNGs within one 8-bit level."""
    ok = (np.abs(a.astype(np.int32) - b.astype(np.int32)) <= 1).all(-1)
    assert ok.mean() >= frac, ok.mean()


# -- denoise ---------------------------------------------------------------

@pytest.mark.parametrize("guides", ["none", "albedo", "normal", "both"])
@pytest.mark.parametrize("h,w", [(32, 32), (24, 40)])
def test_denoise_matches_jax(guides, h, w):
    g = np.random.default_rng(h * w)
    img = (g.gamma(0.7, 0.5, (h, w, 3)) * (g.random((h, w, 1)) < 0.9)
           ).astype(np.float32)
    alb = g.random((h, w, 3)).astype(np.float32)
    nrm = np.abs(g.normal(size=(h, w, 3))).astype(np.float32)
    kw_t, kw_j = {}, {}
    if guides in ("albedo", "both"):
        kw_t["albedo"], kw_j["albedo"] = torch.from_numpy(alb), alb
    if guides in ("normal", "both"):
        kw_t["normal"], kw_j["normal"] = torch.from_numpy(nrm), nrm
    want = np.asarray(jdenoise(img, **{k: jnp.asarray(v)
                                       for k, v in kw_j.items()}))
    got = denoise(torch.from_numpy(img), **kw_t)
    assert got.dtype == torch.float32 and got.shape == (h, w, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # an array in gives the same as a tensor
    np.testing.assert_array_equal(denoise(img, **kw_t).numpy(),
                                  got.numpy())


# -- checkpoint ------------------------------------------------------------

def _film(seed):
    g = np.random.default_rng(seed)
    buf = g.random((7, 5, 3)).astype(np.float32) * 3
    return buf, np.float32(g.integers(1, 99))


def test_checkpoint_cross_loads(tmp_path):
    buf, spp = _film(1)
    mine = str(tmp_path / "port.npz")
    checkpoint.save_film(mine, film_mod.Film(torch.from_numpy(buf),
                                             torch.tensor(spp)))
    f = jck.load_film(mine)
    np.testing.assert_array_equal(np.asarray(f.buffer), buf)
    assert float(f.spp) == spp and np.asarray(f.spp).dtype == np.float32
    buf2, spp2 = _film(2)
    theirs = str(tmp_path / "jax.npz")
    jck.save_film(theirs, jfilm.Film(jnp.asarray(buf2), jnp.float32(spp2)))
    t = checkpoint.load_film(theirs, device="cpu")
    assert t.buffer.dtype == torch.float32 and t.spp.dtype == torch.float32
    np.testing.assert_array_equal(t.buffer.numpy(), buf2)
    assert float(t.spp) == spp2 and t.spp.shape == ()
    assert not (tmp_path / "port.npz.tmp.npz").exists()
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == ["buffer", "spp"]


def test_checkpoint_missing_and_default_device(tmp_path):
    assert checkpoint.load_film(str(tmp_path / "none.npz"), "cpu") is None
    path = str(tmp_path / "f.npz")
    checkpoint.save_film(path, film_mod.new_film(2, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            checkpoint.load_film(path)      # the card by default


# -- primitives ------------------------------------------------------------

def _v(*xs):
    a = np.asarray(xs, np.float32).reshape(-1, 3)
    return V3.from_stacked(torch.from_numpy(a)), JV3.from_stacked(
        jnp.asarray(a))


def _same(got, want):
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        if w_.dtype == bool:
            np.testing.assert_array_equal(g_.numpy(), w_)
        else:
            np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-6, atol=1e-6)


def test_primitives_rttest_cases():
    """RTtest.cpp:22-103, as tests/test_primitives.py runs them."""
    (n, jn), (o, jo), (d, jd) = (_v([0, 1, 0], [0, 1, 0]),
                                 _v([0, 1, 0], [0, 1, 0]),
                                 _v([0, -1, 0], [0, 1, 0]))
    t, hit = prim.ray_plane(o, d, n, 0.0)
    assert bool(hit[0]) and float(t[0]) == pytest.approx(1.0)
    assert not bool(hit[1])
    _same((t, hit), jprim.ray_plane(jo, jd, jn, 0.0))
    c, jc = _v([0, 0, 0])
    for oo, dd, want_t in (([0, 0, 3], [0, 0, -1], 2.0),
                           ([0, 0, 0], [0, 0, 1], 1.0),
                           ([0, 3, 3], [0, 0, -1], None)):
        (o, jo), (d, jd) = _v(oo), _v(dd)
        t, hit = prim.ray_sphere(o, d, c, 1.0)
        assert bool(hit[0]) == (want_t is not None)
        if want_t is not None:
            assert float(t[0]) == pytest.approx(want_t, abs=1e-4)
        _same((t, hit), jprim.ray_sphere(jo, jd, jc, 1.0))
    (o, jo), (d, jd) = _v([0, 0, -5], [5, 5, -5]), _v([0, 0, 1], [0, 0, 1])
    (lo, jlo), (hi, jhi) = _v([-1] * 3, [-1] * 3), _v([1] * 3, [1] * 3)
    inv = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    jinv = JV3(1.0 / jd.x, 1.0 / jd.y, 1.0 / jd.z)
    tmin, tmax, hit = prim.ray_aabb(o, inv, lo, hi)
    assert bool(hit[0]) and float(tmin[0]) == pytest.approx(4.0)
    assert not bool(hit[1])
    _same((tmin, tmax, hit), jprim.ray_aabb(jo, jinv, jlo, jhi))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primitives_random_batches(seed):
    g = np.random.default_rng(seed)
    n = 4096
    o = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    nrm = g.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    centre = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    lo = g.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + g.uniform(0.1, 2, (n, 3)).astype(np.float32)
    dist = g.uniform(-1, 1, n).astype(np.float32)
    radius = g.uniform(0.2, 2, n).astype(np.float32)
    T = lambda a: V3.from_stacked(torch.from_numpy(a))  # noqa: E731
    J = lambda a: JV3.from_stacked(jnp.asarray(a))      # noqa: E731
    _same(prim.ray_plane(T(o), T(d), T(nrm), torch.from_numpy(dist)),
          jprim.ray_plane(J(o), J(d), J(nrm), jnp.asarray(dist)))
    got = prim.ray_sphere(T(o), T(d), T(centre), torch.from_numpy(radius))
    _same(got, jprim.ray_sphere(J(o), J(d), J(centre), jnp.asarray(radius)))
    assert 0.02 < got[1].float().mean() < 0.98
    inv = 1.0 / d
    got = prim.ray_aabb(T(o), T(inv), T(lo), T(hi))
    _same(got, jprim.ray_aabb(J(o), J(inv), J(lo), J(hi)))
    assert 0.02 < got[2].float().mean() < 0.98


# -- fly camera ------------------------------------------------------------

KEYS = "w,a,s,d,q,e,left,right,left,left,w,W,D,x,right"


def test_fly_camera_matches_jax():
    P = matrix.perspective(0.001, 10000.0, 1.5, 40.0)
    np.testing.assert_array_equal(
        P, jmatrix.perspective(0.001, 10000.0, 1.5, 40.0))
    args = ([0.1, 1.0, 6.8], [0.0, 1.0, 5.8], [0, 1, 0], P, 48, 32)
    fc, jfc = FlyCamera(*args, movespeed=0.5), JFly(*args, movespeed=0.5)
    for k in KEYS.split(","):
        fc.key(k)
        jfc.key(k)
        np.testing.assert_array_equal(fc.from_p, jfc.from_p)
        np.testing.assert_array_equal(fc.to_p, jfc.to_p)
    assert not np.allclose(fc.from_p, args[0])
    cam, jcam = fc.camera("cpu"), jfc.camera()
    for f in ("p", "p_inv", "cam_to_world", "world_to_cam", "a_film"):
        t = getattr(cam, f)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jcam, f)))
    for a, b in zip(cam.origin, jcam.origin):
        assert a.shape == () and a.item() == float(b)
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (48, 32)


# -- interactive session ---------------------------------------------------

@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = write_cornell(str(tmp_path_factory.mktemp("cornell")), RES, RES)
    return d, load_scene(d, "cpu"), jload(d, build_bvh=False)


def test_run_scripted_matches_jax(cornell, tmp_path):
    d, ts, js = cornell
    cfg = dict(max_depth=2, mis=True, jitter=True)
    keys = "w,left,p,l,esc,w"
    s = run_scripted(ts, d, RenderConfig(**cfg), keys,
                     output=str(tmp_path / "port"))
    j = jrun_scripted(js, d, JConfig(**cfg), keys,
                      output=str(tmp_path / "jax"))
    assert not s.running and not j.running        # esc quit
    assert s.spp == j.spp == 1                    # moved, then one tick
    assert s.saves == [str(tmp_path / "port.hdr"), str(tmp_path / "port.png")]
    np.testing.assert_array_equal(s.fly.from_p, j.fly.from_p)
    np.testing.assert_array_equal(s.fly.to_p, j.fly.to_p)
    img = film_mod.to_hdr(s.film).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    agree(img, np.asarray(jfilm.to_hdr(j.film)))
    within_rgbe_step(read_hdr(str(tmp_path / "port.hdr")),
                     read_hdr(str(tmp_path / "jax.hdr")))
    within_one_level(read_png(str(tmp_path / "port.png")),
                     read_png(str(tmp_path / "jax.png")))


def test_session_move_clears_film(cornell):
    """RTBase's main loop: a move clears the film (rt.clear()) and the
    re-rendered view differs; a save key leaves it."""
    d, ts, _ = cornell
    s = InteractiveSession(ts, d, RenderConfig(max_depth=2, jitter=False,
                                               integrator="adaptive"))
    assert s.cfg.integrator == "path"
    s.step(2)
    assert s.spp == 2
    before = s.film.buffer.clone()
    s.key("left")
    assert s.spp == 0 and float(s.film.buffer.abs().sum()) == 0.0
    assert s.film.buffer.device == ts.device
    s.step(2)
    assert s.spp == 2 and not torch.allclose(before, s.film.buffer)


# -- logging and profiling -------------------------------------------------

def test_logger_and_timer(caplog):
    lg = log.get_logger("test")
    assert lg.name == "rtr.test"
    assert logging.getLogger("rtr").handlers
    with caplog.at_level(logging.INFO, logger="rtr"):
        lg.info("hello %d", 3)
    assert "hello 3" in caplog.text
    tm = profiling.Timer()
    x = torch.ones(4)
    for _ in range(2):
        with tm.phase("render", sync=x):
            x = x + 1
    with tm.phase("write"):
        pass
    assert tm.counts == {"render": 2, "write": 1}
    rep = tm.report(rays=1000)
    assert rep.splitlines()[0].startswith("render:") and "Mrays/s" in rep
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        torch.ones(8).sum()
    assert logdir == str(tmp_path / "tr")
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    # written when the block raises too (the CLI's time budget)
    with pytest.raises(StopIteration):
        with profiling.trace(str(tmp_path / "tr2")):
            raise StopIteration
    assert (tmp_path / "tr2" / "trace.json").exists()
