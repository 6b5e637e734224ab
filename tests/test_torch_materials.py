"""The port's BSDFs against the JAX package: `evaluate`, `pdf_fn` and
`sample` for every MAT_* type and for the layered coat, on the same
random wo / wi / r1 / r2 / rl and material parameters (numpy, seeded).

Tolerance rtol 1e-5, atol 1e-6.  Both packages compute the same float32
expressions in the same order; they differ only in the last one or two
bits of the math libraries' rsqrt, acos, sin, cos and exp (XLA's CPU
versions against torch's).  Where a formula amplifies such a bit, the
tolerance cannot hold on every lane, so it is required as follows:

- evaluate / pdf_fn: on >= 99.5% of lanes, and every lane within
  rtol 5e-2 (near-specular GGX half vectors and the rough dielectric's
  refraction half vector near its singularity amplify an ulp);
- sample: both packages draw their GGX microfacet normal from one shared
  warp (the JAX one's sqrt(1 - cos_t^2) cancels near the normal, so one
  ulp of rsqrt moves a coat direction by ~1e-4); then wi on every lane
  and `valid` exactly; colour and pdf, being D at a near-specular half
  vector for the sharp lobes, on >= 85% of lanes (about 91% measured
  for the coat over a conductor) and every lane within rtol 1e-1
  (2.3e-2 measured);
- the GGX warp itself is compared alone: cos_t to rtol 1e-5, the
  tangential components to atol 5e-5 (an ulp of cos_t moves sin_t by
  about 6e-8 / sin_t)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.materials import bsdf as jb
from raytracingrenderer_tpu.materials import fresnel as jf
from raytracingrenderer_tpu.sampling import warps as jw
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.materials import bsdf as tb
from raytracingrenderer_tpu_torch.materials import fresnel as tf
from raytracingrenderer_tpu_torch.sampling import warps as tw
from raytracingrenderer_tpu_torch.scene import types as tt

torch.set_num_threads(2)

N = 4096
RTOL, ATOL = 1e-5, 1e-6
CASES = [(m, False) for m in range(tt.NUM_MAT_TYPES)] + [
    (tt.MAT_DIFFUSE, True), (tt.MAT_CONDUCTOR, True),
    (tt.MAT_PLASTIC, True), (tt.MAT_OREN_NAYAR, True)]


def _unit(g, n, upper=False):
    v = g.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return v.astype(np.float32)


def _inputs(mtype, coat, seed):
    """Per-lane material parameters and directions for one MAT type."""
    g = np.random.default_rng(seed)
    f = lambda lo, hi, *s: g.uniform(lo, hi, s or (N,)).astype(np.float32)
    params = dict(
        mtype=np.full(N, mtype, np.int32),
        albedo=f(0.05, 0.95, N, 3), eta=f(0.2, 2.5, N, 3),
        k=f(0.0, 4.0, N, 3), int_ior=f(1.2, 1.8), ext_ior=f(1.0, 1.1),
        alpha=f(0.05, 1.2), sigma=f(0.0, 1.0),
        emission=np.zeros((N, 3), np.float32),
        is_emissive=np.zeros(N, bool),
        coat_thickness=(f(0.1, 1.0) if coat
                        else np.zeros(N, np.float32)),
        coat_sigma_a=f(0.0, 2.0, N, 3), coat_int_ior=f(1.3, 1.7),
        coat_ext_ior=np.ones(N, np.float32))
    two_sided = mtype not in (tt.MAT_GLASS, tt.MAT_DIELECTRIC)
    wo = _unit(g, N, upper=two_sided)
    wi = _unit(g, N)
    r = g.random((3, N)).astype(np.float32)
    return params, wo, wi, r


def _jparams(p):
    v3 = lambda a: JV3(*(jnp.asarray(a[:, i]) for i in range(3)))
    return jb.MatParams(**{k: (v3(a) if a.ndim == 2 else jnp.asarray(a))
                           for k, a in p.items()})


def _tparams(p):
    v3 = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                        for i in range(3)))
    return tb.MatParams(**{k: (v3(a) if a.ndim == 2 else torch.from_numpy(a))
                           for k, a in p.items()})


def _jv(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _close(got, want, frac=1.0, loose=None):
    """rtol 1e-5 / atol 1e-6 on at least `frac` of the lanes, and every
    lane within rtol `loose` if given."""
    if isinstance(got, V3):
        for g_, w_ in zip(got, want):
            _close(g_, w_, frac, loose)
        return
    g_, w_ = got.numpy(), np.asarray(want)
    if frac >= 1.0:
        np.testing.assert_allclose(g_, w_, rtol=RTOL, atol=ATOL)
        return
    ok = np.isclose(g_, w_, rtol=RTOL, atol=ATOL)
    assert ok.mean() >= frac, (ok.mean(), frac)
    np.testing.assert_allclose(g_, w_, rtol=loose, atol=ATOL)


def _shared_ggx_warp(monkeypatch):
    """Both packages' ggx_sample_half -> one float64 numpy warp."""
    def half(r1, r2, alpha):
        r1 = np.clip(np.asarray(r1, np.float64), 0.0, 1.0 - 1e-7)
        a = np.broadcast_to(np.asarray(alpha, np.float64), r1.shape)
        tan2 = a * a * r1 / (1.0 - r1)
        c = 1.0 / np.sqrt(1.0 + tan2)
        s = np.sqrt(tan2) * c
        phi = 2.0 * np.pi * np.asarray(r2, np.float64)
        return [x.astype(np.float32) for x in
                (s * np.cos(phi), s * np.sin(phi), c)]

    def to_np(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    monkeypatch.setattr(jw, "ggx_sample_half", lambda r1, r2, a: JV3(
        *(jnp.asarray(x) for x in half(to_np(r1), to_np(r2), to_np(a)))))
    monkeypatch.setattr(tw, "ggx_sample_half", lambda r1, r2, a: V3(
        *(torch.from_numpy(x) for x in half(to_np(r1), to_np(r2),
                                            to_np(a)))))


def _types(mtype, coat):
    return (mtype,) + ((tb.COAT,) if coat else ())


@pytest.mark.parametrize("mtype,coat", CASES)
def test_evaluate_and_pdf(mtype, coat):
    p, wo, wi, _ = _inputs(mtype, coat, seed=10 + mtype + 7 * coat)
    jp, tp = _jparams(p), _tparams(p)
    for types in (None, _types(mtype, coat)):
        _close(tb.evaluate(tp, _tv(wo), _tv(wi), types),
               jb.evaluate(jp, _jv(wo), _jv(wi), types), 0.995, 5e-2)
        _close(tb.pdf_fn(tp, _tv(wo), _tv(wi), types),
               jb.pdf_fn(jp, _jv(wo), _jv(wi), types), 0.995, 5e-2)


@pytest.mark.parametrize("mtype,coat", CASES)
def test_sample(mtype, coat, monkeypatch):
    _shared_ggx_warp(monkeypatch)
    p, wo, _, r = _inputs(mtype, coat, seed=30 + mtype + 7 * coat)
    jp, tp = _jparams(p), _tparams(p)
    types = _types(mtype, coat)
    rt = [torch.from_numpy(x) for x in r]
    rj = [jnp.asarray(x) for x in r]
    wi_t, col_t, pdf_t, ok_t = tb.sample(tp, _tv(wo), *rt, types)
    wi_j, col_j, pdf_j, ok_j = jb.sample(jp, _jv(wo), *rj, types)
    _close(wi_t, wi_j)
    _close(col_t, col_j, 0.85, 1e-1)
    _close(pdf_t, pdf_j, 0.85, 1e-1)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.mean() > 0.3   # the draws exercise real lobes


def test_warps_and_fresnel():
    g = np.random.default_rng(3)
    r1, r2 = (g.random(N).astype(np.float32) for _ in range(2))
    alpha = g.uniform(0.05, 1.0, N).astype(np.float32)
    t1, t2, ta = (torch.from_numpy(x) for x in (r1, r2, alpha))
    j1, j2, ja = (jnp.asarray(x) for x in (r1, r2, alpha))
    for tfn, jfn in ((tw.cosine_hemisphere, jw.cosine_hemisphere),
                     (tw.uniform_hemisphere, jw.uniform_hemisphere),
                     (tw.uniform_sphere, jw.uniform_sphere)):
        _close(tfn(t1, t2), jfn(j1, j2))
    h_t = tw.ggx_sample_half(t1, t2, ta)
    h_j = jw.ggx_sample_half(j1, j2, ja)
    _close(h_t.z, h_j.z)
    for a, b in zip(h_t[:2], h_j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=5e-5)
    for a, b in zip(tw.uniform_triangle(t1, t2), jw.uniform_triangle(j1, j2)):
        _close(a, b)
    cos = g.uniform(-1, 1, N).astype(np.float32)
    eta_i = g.uniform(1.0, 1.6, N).astype(np.float32)
    eta_t = g.uniform(1.0, 1.6, N).astype(np.float32)
    for a, b in zip(tf.fresnel_dielectric(*(torch.from_numpy(x) for x in
                                            (cos, eta_i, eta_t))),
                    jf.fresnel_dielectric(*(jnp.asarray(x) for x in
                                            (cos, eta_i, eta_t)))):
        _close(a, b)
    eta, k = (g.uniform(0.2, 3.0, (N, 3)).astype(np.float32)
              for _ in range(2))
    _close(tf.fresnel_conductor(torch.from_numpy(cos), _tv(eta), _tv(k)),
           jf.fresnel_conductor(jnp.asarray(cos), _jv(eta), _jv(k)))


@pytest.mark.parametrize("quad", [True, False])
def test_texture_sample(tmp_path, quad):
    """Bilinear atlas lookups on two random textures (one with alpha), as
    the loaders build them from PNG files; exact, since the arithmetic
    has no transcendental in it."""
    from raytracingrenderer_tpu.imaging import texture as jtex
    from raytracingrenderer_tpu.scene.loader import _TextureManager as JTM
    from raytracingrenderer_tpu_torch.imaging import texture as ttex
    from raytracingrenderer_tpu_torch.io.png import write_png
    from raytracingrenderer_tpu_torch.scene.loader import _TextureManager as TTM
    g = np.random.default_rng(4)
    paths = [str(tmp_path / "a.png"), str(tmp_path / "b.png")]
    write_png(paths[0], g.integers(0, 256, (5, 7, 3), dtype=np.uint8))
    write_png(paths[1], g.integers(0, 256, (4, 3, 4), dtype=np.uint8))
    jm, tm = JTM(), TTM()
    for p in paths:
        assert jm.load(p)[1] == tm.load(p)[1] >= 0
    ja, ta = jm.build_atlas(), tm.build_atlas("cpu")
    if not quad:
        ja, ta = ja._replace(quad=None), ta._replace(quad=None)
    for name in ("data", "alpha", "hw"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    tid = g.integers(-1, 2, N).astype(np.int32)
    u, v = (g.uniform(-3, 3, N).astype(np.float32) for _ in range(2))
    want = jtex.sample(ja, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v))
    got = ttex.sample(ta, torch.from_numpy(tid), torch.from_numpy(u),
                      torch.from_numpy(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert (got.x.numpy()[tid < 0] == 1.0).all()
