"""The port's NEE visibility boundary term (integrators/boundary.py) and
the gradient path with cfg.boundary_grads, against the JAX package.

- `boundary_direct` against JAX's on the analytic occluder scene of
  tests/test_boundary.py (one area light at z = 2, a half-plane occluder
  at z = 1 whose edge is at x = c, a diffuse point at the origin), built
  here for both packages, at N = 512 lanes and boundary_samples = 8,
  with the same key: the value is exactly 0 in both; d(mean)/dc agrees
  within rel 2e-2 (measured on the CPU: rel 7e-8, every jump equal);
  at least 99% of the (sample, lane) jumps agree, read from the probes'
  occlusion bits and their radii.  Tolerance, not equality: the probes
  sit on shadow edges by design, and XLA's CPU math and torch's differ
  by an ulp in rsqrt and friends, which can flip a jump.
- `diff.param_grads` with boundary_grads against JAX `render_loss`'s
  gradient on tests/torch_scenes.py's cornell box at 24x24, max_depth 2,
  boundary_samples 2: loss within rel 1e-4; tri_p0 within a relative
  L2 error of 1e-2 and nonzero; the materials and lights within rtol
  1e-3 / atol 1e-3 * max|g| (test_torch_diff.py's bars).  The boundary
  term's part of tri_p0 (the gradient less the one without the term)
  within a relative L2 error of 5e-2 of JAX's; the other keys exactly
  as without the term.  Measured (CPU): loss rel 3.6e-5, tri_p0 1.6e-4,
  its boundary part 3.5e-3 (4.5% of tri_p0's norm).
- the wavefront backward (compacting, the boundary streams keyed by pixel
  id after compaction) against the scan's with boundary_grads: loss rel
  1e-5, gradients rtol 2e-3 / atol 1e-6 (JAX's
  test_wavefront_backward_carries_boundary_term).
- images bit for bit the same with boundary_grads on and off.
- the backward traverses nothing: no `closest_hit` / `occluded` call and
  no kernel wrapper during torch.autograd.grad (the recompute replays
  the probes' recorded bits), and remat on and off agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu import diff as jdiff
from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.core.frame import Frame as JFrame
from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.integrators import boundary as jbnd
from raytracingrenderer_tpu.integrators.common import Shading as JShading
from raytracingrenderer_tpu.materials import bsdf as jbsdf
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch import diff
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.frame import Frame
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import intersect
from raytracingrenderer_tpu_torch.integrators import (boundary, common,
                                                      wavefront,
                                                      wavefront_diff)
from raytracingrenderer_tpu_torch.integrators.common import Shading
from raytracingrenderer_tpu_torch.materials import bsdf
from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
from raytracingrenderer_tpu_torch.render import render, sample_image
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from raytracingrenderer_tpu_torch.scene.types import (
    BG_NONE, Background, Camera, LightTable, MaterialTable, Scene,
    SceneBounds, TextureAtlas, Triangles)
from test_boundary import make_scene as jmake_scene
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

N = 512
C0 = 0.3
KEY = 0
ANALYTIC = dict(mis=False, jitter=False, rr=False, geom_grads=True,
                boundary_grads=True, boundary_samples=8)
RES = 24
CFG = dict(max_depth=2, mis=False, jitter=False, rr=False,
           boundary_samples=2)


def _quads(c):
    """(4, 3, 3) vertices of make_scene: the light quad over [-1, 1]^2 at
    z = 2 facing -z, then the occluder over x in [-2, c] at z = 1."""
    def quad(x0, x1, y0, y1, z):
        v = [(x0, y0, z), (x1, y0, z), (x1, y1, z), (x0, y1, z)]
        v = [torch.stack([torch.as_tensor(a, dtype=torch.float32) + 0 * c
                          for a in p]) for p in v]
        return [torch.stack([v[i] for i in t]) for t in ((0, 2, 1),
                                                          (0, 3, 2))]
    return torch.stack(quad(-1, 1, -1, 1, 2.0) + quad(-2, c, -2, 2, 1.0))


def make_scene(c):
    """tests/test_boundary.py::make_scene in this package, traced in c."""
    tp = _quads(c)
    p0 = V3(*tp[:, 0].unbind(1))
    e1 = V3(*(tp[:, 1] - tp[:, 0]).unbind(1))
    e2 = V3(*(tp[:, 2] - tp[:, 0]).unbind(1))
    cr = e1.cross(e2)
    gn = cr.normalize()
    area = 0.5 * cr.length()
    uv = torch.zeros((4, 2))
    tris = Triangles(p0=p0, e1=e1, e2=e2, gn=gn, n0=gn, n1=gn, n2=gn,
                     uv0=uv, uv1=uv, uv2=uv, area=area,
                     mat_id=torch.tensor([1, 1, 0, 0], dtype=torch.int32),
                     light_id=torch.tensor([0, 1, -1, -1],
                                           dtype=torch.int32))
    li = torch.tensor([0, 1])
    ones = torch.ones(2)
    lt = LightTable(tri=li.to(torch.int32), le=V3(ones, ones, ones),
                    area=area[:2], power=area[:2], p0=p0.gather(li),
                    e1=e1.gather(li), e2=e2.gather(li), gn=gn.gather(li))
    f1 = lambda v: torch.full((2,), v)  # noqa: E731
    z3 = V3(f1(0.0), f1(0.0), f1(0.0))
    mats = MaterialTable(
        mtype=torch.zeros(2, dtype=torch.int32), albedo=V3(ones, ones, ones),
        albedo_tex=torch.full((2,), -1, dtype=torch.int32), emission=z3,
        is_emissive=torch.tensor([False, True]), eta=z3, k=z3,
        int_ior=f1(1.5), ext_ior=f1(1.0), alpha=f1(0.5), sigma=f1(0.5),
        coat_thickness=f1(0.0), coat_sigma_a=z3, coat_int_ior=f1(1.33),
        coat_ext_ior=f1(1.0))
    atlas = TextureAtlas(data=torch.zeros((1, 1, 1, 3)),
                         alpha=torch.ones((1, 1, 1)),
                         hw=torch.ones((1, 2), dtype=torch.int32))
    eye = torch.eye(4)
    s0 = torch.tensor(0.0)
    cam = Camera(eye, eye, eye, eye, 4, 4, V3(s0, s0, -torch.tensor(1.0)),
                 torch.tensor(1.0))
    return Scene(triangles=tris, materials=mats, textures=atlas, lights=lt,
                 background=Background(BG_NONE, V3(s0, s0, s0)), camera=cam,
                 bounds=SceneBounds(V3(s0, s0, torch.tensor(1.0)),
                                    torch.tensor(3.0)))


def _shading():
    """A diffuse point at the origin, normal +z, seen from +z."""
    sn = V3.full((N,), 0.0, 0.0, 1.0)
    f1 = lambda v: torch.full((N,), v)  # noqa: E731
    z = V3.zeros((N,))
    mp = bsdf.MatParams(
        mtype=torch.zeros(N, dtype=torch.int32),
        albedo=V3.full((N,), 1.0, 1.0, 1.0), eta=z, k=z, int_ior=f1(1.5),
        ext_ior=f1(1.0), alpha=f1(0.5), sigma=f1(0.5), emission=z,
        is_emissive=torch.zeros(N, dtype=torch.bool),
        coat_thickness=f1(0.0), coat_sigma_a=z, coat_int_ior=f1(1.33),
        coat_ext_ior=f1(1.0))
    return Shading(x=z, sn=sn, gn=sn, gn_raw=sn, frame=Frame.from_normal(sn),
                   wo_local=V3.full((N,), 0.0, 0.0, 1.0), uv_u=f1(0.0),
                   uv_v=f1(0.0), mp=mp,
                   light_id=torch.full((N,), -1, dtype=torch.int32))


def _jshading():
    sn = JV3.full(N, 0.0, 0.0, 1.0)
    f1 = lambda v: jnp.full(N, v, jnp.float32)  # noqa: E731
    mp = jbsdf.MatParams(
        mtype=jnp.zeros(N, jnp.int32), albedo=JV3.full(N, 1.0, 1.0, 1.0),
        eta=JV3.zeros(N), k=JV3.zeros(N), int_ior=f1(1.5), ext_ior=f1(1.0),
        alpha=f1(0.5), sigma=f1(0.5), emission=JV3.zeros(N),
        is_emissive=jnp.zeros(N, bool), coat_thickness=f1(0.0),
        coat_sigma_a=JV3.zeros(N), coat_int_ior=f1(1.33),
        coat_ext_ior=f1(1.0))
    return JShading(x=JV3.zeros(N), sn=sn, gn=sn, gn_raw=sn,
                    frame=JFrame.from_normal(sn),
                    wo_local=JV3.full(N, 0.0, 0.0, 1.0),
                    uv_u=jnp.zeros(N), uv_v=jnp.zeros(N), mp=mp,
                    light_id=jnp.full(N, -1, jnp.int32))


def _jumps(probes):
    """(samples, N) jumps lit(+) - lit(-) from the probes' (radius,
    occluded) pairs in call order, two a sample: a probe is lit where its
    radius is not negative (inside the light, worth probing) and it is not
    occluded."""
    lit = np.stack([(t >= 0) & ~occ for t, occ in probes]).astype(np.int8)
    return lit[0::2] - lit[1::2]


@pytest.fixture(scope="module")
def analytic_jax():
    """JAX's value, d(mean)/dc and probes in one eager grad pass: the
    probes' bits read through a debug callback around its `occluded`."""
    probes, values = [], []
    orig = jbnd.occluded

    def spy(scene, o, d, max_t):
        r = orig(scene, o, d, max_t)
        jax.debug.callback(lambda t, occ: probes.append(
            (np.asarray(t), np.asarray(occ))), max_t, r, ordered=True)
        return r

    def mean_x(c):
        b = jbnd.boundary_direct(
            jmake_scene(c), _jshading(), jnp.ones(N, bool),
            jax.random.PRNGKey(KEY), 0, jnp.arange(N, dtype=jnp.uint32),
            dataclasses.replace(JConfig(), **ANALYTIC))
        jax.debug.callback(lambda v: values.append(np.asarray(v)), b.x,
                           ordered=True)
        return b.x.mean()

    jbnd.occluded = spy
    try:
        g = jax.grad(mean_x)(jnp.float32(C0))
    finally:
        jbnd.occluded = orig
    return dict(grad=float(g), value=values[0], jumps=_jumps(probes))


@pytest.fixture(scope="module")
def analytic_port():
    c = torch.tensor(C0, requires_grad=True)
    cfg = dataclasses.replace(RenderConfig(), **ANALYTIC)
    probes = []
    orig = boundary.occluded

    def spy(scene, o, d, max_t):
        r = orig(scene, o, d, max_t)
        probes.append((max_t.numpy().copy(), r.numpy().copy()))
        return r

    boundary.occluded = spy
    try:
        b, occ = boundary.boundary_direct(
            make_scene(c), _shading(), torch.ones(N, dtype=torch.bool),
            rng.PRNGKey(KEY), 0, torch.arange(N), cfg)
    finally:
        boundary.occluded = orig
    g, = torch.autograd.grad(b.x.mean(), c)
    assert np.array_equal(occ.numpy(), np.stack([p[1] for p in probes]))
    return dict(grad=float(g), value=b.stacked().detach().numpy(),
                jumps=_jumps(probes))


def test_analytic_scene_matches_jax_scene():
    """The scene built here is JAX's make_scene, field for field."""
    js = jmake_scene(jnp.float32(C0))
    ps = make_scene(torch.tensor(C0))
    for f in ("p0", "e1", "e2", "gn"):
        np.testing.assert_array_equal(
            getattr(ps.triangles, f).stacked().numpy(),
            np.asarray(getattr(js.triangles, f).stacked()))
    np.testing.assert_array_equal(ps.triangles.area.numpy(),
                                  np.asarray(js.triangles.area))


def test_boundary_value_is_zero(analytic_jax, analytic_port):
    assert not np.any(analytic_jax["value"])
    assert not np.any(analytic_port["value"])


def test_boundary_jumps_match_jax(analytic_jax, analytic_port):
    a, b = analytic_port["jumps"], analytic_jax["jumps"]
    assert a.shape == b.shape == (ANALYTIC["boundary_samples"], N)
    assert np.mean(a == b) >= 0.99
    assert np.count_nonzero(b) > 0.02 * b.size   # the probes find edges


def test_boundary_gradient_matches_jax(analytic_jax, analytic_port):
    """d(mean)/dc is the whole gradient here (the interior term sees
    none): JAX's is -0.217 at this key (-0.2334 at N = 4096, the finite
    difference -0.2344, tests/test_boundary.py)."""
    g, want = analytic_port["grad"], analytic_jax["grad"]
    assert want < -0.1
    assert g == pytest.approx(want, rel=2e-2)


@pytest.fixture(scope="module")
def cornell_dir(tmp_path_factory):
    return write_cornell(str(tmp_path_factory.mktemp("cornell")), RES, RES)


@pytest.fixture(scope="module")
def scene(cornell_dir):
    return load_scene(cornell_dir, "cpu")


@pytest.fixture(scope="module")
def spheres(tmp_path_factory):
    d = write_spheres(str(tmp_path_factory.mktemp("spheres")), RES, RES,
                      subdiv=2)
    return load_scene(d, "cpu")


def _zero():
    return torch.zeros((RES, RES, 3))


def _np(g):
    return (g.stacked() if isinstance(g, V3) else g).detach().numpy()


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def cornell_grads(cornell_dir, scene):
    """(port loss, port grads, JAX loss, JAX grads, port grads without the
    boundary term) at key 2."""
    key = 2
    cfg = RenderConfig(**CFG, boundary_grads=True)
    loss, got = diff.value_and_grad(scene, _zero(), rng.PRNGKey(key),
                                    diff._diff_cfg(cfg, scene))
    js = jload(cornell_dir)
    params, _ = jdiff._split_scene(js)
    jloss, want = jax.value_and_grad(jdiff.render_loss)(
        params, js, jnp.zeros((RES, RES, 3)), jax.random.PRNGKey(key),
        jdiff._diff_cfg(JConfig(**CFG, boundary_grads=True), js))
    off = diff.param_grads(scene, _zero(), rng.PRNGKey(key),
                           RenderConfig(**CFG))
    return (float(loss), {k: _np(v) for k, v in got.items()}, float(jloss),
            {k: np.asarray(want[k].stacked() if hasattr(want[k], "stacked")
                           else want[k]) for k in diff.PARAM_KEYS},
            {k: _np(v) for k, v in off.items()})


def test_param_grads_with_boundary_match_jax(cornell_grads):
    loss, got, jloss, want, _ = cornell_grads
    assert loss == pytest.approx(jloss, rel=1e-4)
    for k in diff.PARAM_KEYS:
        a, b = got[k], want[k]
        assert np.isfinite(a).all(), k
        if k == "tri_p0":
            assert _rel_l2(a, b) <= 1e-2
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=1e-3 * np.abs(b).max(),
                                       err_msg=k)


def test_boundary_term_moves_tri_p0(cornell_grads):
    """tri_p0's gradient is nonzero and the boundary term changes it (in
    both packages alike: the term's share is held to JAX's)."""
    _, got, _, want, off = cornell_grads
    assert np.abs(got["tri_p0"]).max() > 0
    d = got["tri_p0"] - off["tri_p0"]
    assert np.abs(d).max() > 1e-3 * np.abs(got["tri_p0"]).max()
    # the interior part is the same estimator, so the difference is the
    # boundary term, and JAX's minus the port's interior part is JAX's
    assert _rel_l2(d, want["tri_p0"] - off["tri_p0"]) <= 5e-2
    for k in ("albedo", "emission", "alpha", "light_le"):
        np.testing.assert_array_equal(got[k], off[k], err_msg=k)


@pytest.fixture
def compacting(monkeypatch):
    """A width bucket small enough that 24x24 compacts."""
    monkeypatch.setattr(wavefront, "_MIN_WIDTH", 64)


@pytest.mark.parametrize("which", ["cornell", "spheres"])
def test_wavefront_backward_carries_boundary_term(request, compacting,
                                                  which):
    sc = request.getfixturevalue("scene" if which == "cornell"
                                 else "spheres")
    cfg = RenderConfig(**CFG, boundary_grads=True)
    key = rng.PRNGKey(7)
    loss_wf, g_wf = wavefront_diff.loss_and_grads(sc, _zero(), key, cfg)
    loss_sc, g_sc = diff.value_and_grad(
        sc, _zero(), key,
        diff._diff_cfg(dataclasses.replace(cfg, wavefront=False), sc))
    assert float(loss_wf) == pytest.approx(float(loss_sc), rel=1e-5)
    assert np.abs(_np(g_sc["tri_p0"])).max() > 0
    for k in diff.PARAM_KEYS:
        np.testing.assert_allclose(_np(g_wf[k]), _np(g_sc[k]), rtol=2e-3,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("which", ["cornell", "spheres"])
def test_image_unchanged_by_boundary_grads(request, which):
    sc = request.getfixturevalue("scene" if which == "cornell"
                                 else "spheres")
    cfg = RenderConfig(mis=True, jitter=True, max_depth=3)
    a = render(sc, cfg, spp=1).buffer
    b = render(sc, dataclasses.replace(cfg, boundary_grads=True),
               spp=1).buffer
    assert bool(a.abs().sum() > 0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # and the image recorded for autograd, with the term in its graph
    params, _ = diff._split_scene(sc)
    leaves = [p.detach().requires_grad_(True) for p in diff._leaves(params)]
    live = diff._merge_scene(diff._rebuild(params, leaves), sc)
    dcfg = diff._diff_cfg(dataclasses.replace(cfg, boundary_grads=True), sc)
    sample = (sample_image if which == "cornell"
              else wavefront.sample_image_wavefront)
    key = rng.PRNGKey(3)
    with torch.no_grad():
        want = sample(sc, key, diff._diff_cfg(cfg, sc))
    got = sample(live, key, dcfg)
    assert got.requires_grad
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())


@pytest.fixture
def counted(monkeypatch):
    """Calls of the traversal entry points and the kernels' wrappers."""
    calls = dict(closest_hit=0, occluded=0, probes=0, mt=0, bvh=0)

    def wrap(mod, name, tag):
        orig = getattr(mod, name)

        def f(*a, **kw):
            calls[tag] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, f)

    wrap(intersect, "closest_hit", "closest_hit")
    wrap(common, "occluded", "occluded")
    wrap(boundary, "occluded", "probes")
    wrap(mt_kernel, "intersect", "mt")
    wrap(bvh_kernel, "traverse_packet", "bvh")
    return calls


@pytest.mark.parametrize("which", ["cornell-scan", "spheres-wavefront"])
def test_backward_traverses_nothing(request, counted, which):
    sc = request.getfixturevalue("scene" if which == "cornell-scan"
                                 else "spheres")
    cfg = RenderConfig(mis=True, jitter=True, max_depth=3,
                       boundary_grads=True, boundary_samples=2)
    sample = (sample_image if which == "cornell-scan"
              else wavefront.sample_image_wavefront)
    dcfg = diff._diff_cfg(cfg, sc)
    assert dcfg.remat and dcfg.boundary_grads
    params, _ = diff._split_scene(sc)
    leaves = [p.detach().requires_grad_(True) for p in diff._leaves(params)]
    loss = diff.render_loss(diff._rebuild(params, leaves), sc, _zero(),
                            rng.PRNGKey(6), dcfg, sample)
    fwd = dict(counted)
    bounces = fwd["closest_hit"]
    assert 0 < bounces <= cfg.max_depth + 2
    assert fwd["probes"] == 2 * cfg.boundary_samples * bounces
    assert fwd["mt"] > 0 and (fwd["bvh"] > 0) == (which != "cornell-scan")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert counted == fwd
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


def test_remat_off_matches_on_with_boundary(scene):
    key = rng.PRNGKey(7)
    cfg = RenderConfig(**CFG, boundary_grads=True)
    on = diff.param_grads(scene, _zero(), key, cfg)
    off = diff.param_grads(scene, _zero(), key,
                           dataclasses.replace(cfg, remat=False))
    for k in diff.PARAM_KEYS:
        np.testing.assert_array_equal(_np(on[k]), _np(off[k]), err_msg=k)


def test_train_steps_with_boundary(scene):
    """train_steps runs with the term on and equals sequential steps."""
    base = rng.PRNGKey(11)
    cfg = RenderConfig(**CFG, boundary_grads=True)
    sc_n, losses = diff.train_steps(scene, _zero(), base, cfg, 0.3, 2)
    sc_seq, seq = scene, []
    for i in range(2):
        sc_seq, li = diff.train_step(sc_seq, _zero(), rng.fold_in(base, i),
                                     cfg, lr=0.3)
        seq.append(float(li))
    np.testing.assert_allclose(losses.numpy(), seq, rtol=1e-5)
    np.testing.assert_array_equal(_np(sc_n.triangles.p0),
                                  _np(sc_seq.triangles.p0))
