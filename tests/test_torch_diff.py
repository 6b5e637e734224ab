"""The port's gradient path (diff.py, integrators/wavefront_diff.py) on
the in-repo cornell box (36 triangles, brute force, the scan integrator)
and the 5,156-triangle spheres scene (BVH, the wavefront integrator), at
24x24.  The JAX package's own gradient tests need the reference assets,
which are absent, so these use the scenes of tests/torch_scenes.py.

- `param_grads` against the JAX package's on the same scene and key,
  under test_diff.py's CFG (max_depth 2, no MIS, no jitter, no RR) and
  under mis + jitter at max_depth 3: the loss within rel 1e-4, each
  material and light array within rtol 1e-3 / atol 1e-3 * max|g|,
  `tri_p0` within a relative L2 error of 1e-2.  Measured (CPU, the
  port's torch against XLA): loss rel 0 and 1e-7; the largest gaps
  3.4e-4 and 7e-6 of max|g| (albedo), `tri_p0` relative L2 1.6e-4 and
  5.9e-4.  Tolerance, not equality: XLA's CPU math and torch's part
  by an ulp in rsqrt, acos, sin, cos and exp, and at an exact tie
  jnp.maximum splits a gradient in halves where torch.clamp passes all
  of it (where a gradient parts from JAX's, look there first).
- finite differences on the port alone, with test_diff.py's
  reparameterisations, steps and bars: emission and albedo scales rel
  0.05; the light and the floor translated along y, rel 0.02, without
  and (the light) with MIS.
- `train_steps(n)` equals n sequential `train_step` calls (rtol 1e-5);
  a train step descends, on both integrators; `train_step` sends the
  BVH scene to the wavefront backward.
- the wavefront backward against the scan backward on the spheres
  scene, compacting: loss rel 1e-5, gradients rtol 1e-3 / atol 1e-6;
  its widths and image equal the forward wavefront's bit for bit.
- the backward calls `closest_hit` / `occluded` (and the kernels'
  wrappers) zero times: the recompute replays the recorded hits and
  occlusion bits; remat on and off give the same gradients.
- geom_grads leaves the forward image bit-identical.
- a masked MIS pdf lane at the miss clamp gets a zero gradient, not NaN.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu import diff as jdiff
from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch import diff
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import intersect
from raytracingrenderer_tpu_torch.geometry.refit import refit
from raytracingrenderer_tpu_torch.integrators import (common, path,
                                                      wavefront,
                                                      wavefront_diff)
from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
from raytracingrenderer_tpu_torch.render import render, sample_image
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

RES = 24
# rr=False: Russian roulette's survival decisions make the common-random-
# numbers FD oracle invalid (indicator flips and 1/p)
CFG = dict(max_depth=2, mis=False, jitter=False, rr=False)
MIS = dict(max_depth=3, mis=True, jitter=True, rr=False)
SPHERES = dict(mis=True, jitter=True, max_depth=3)


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


@pytest.fixture
def compacting(monkeypatch):
    """A width bucket small enough that 24x24 compacts."""
    monkeypatch.setattr(wavefront, "_MIN_WIDTH", 64)


def _np(g):
    return (g.stacked() if isinstance(g, V3) else g).detach().numpy()


def _jnp(g):
    return np.asarray(g.stacked() if hasattr(g, "stacked") else g)


def _zero():
    return torch.zeros((RES, RES, 3))


def close_grads(got, want, what=""):
    """The card tests' GPU-against-CPU bars for gradients by key
    (tests/test_torch_cuda.py::_grads_close)."""
    for k in diff.PARAM_KEYS:
        a, b = got[k], want[k]
        assert np.isfinite(a).all(), (what, k)
        if k == "tri_p0":
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-2, (what, k, rel)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=1e-3 * np.abs(b).max(),
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("cfg", [CFG, MIS], ids=["cfg", "mis-jitter"])
def test_param_grads_match_jax(cornell_dir, scene, cfg):
    key = 2
    loss, got = diff.value_and_grad(
        scene, _zero(), rng.PRNGKey(key),
        diff._diff_cfg(RenderConfig(**cfg), scene))
    js = jload(cornell_dir)
    np.testing.assert_array_equal(_np(scene.triangles.p0),
                                  _jnp(js.triangles.p0))
    params, _ = jdiff._split_scene(js)
    jloss, want = jax.value_and_grad(jdiff.render_loss)(
        params, js, jnp.zeros((RES, RES, 3)), jax.random.PRNGKey(key),
        jdiff._diff_cfg(JConfig(**cfg), js))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    close_grads({k: _np(v) for k, v in got.items()},
                {k: _jnp(want[k]) for k in diff.PARAM_KEYS}, "vs JAX")
    # param_grads is value_and_grad's gradients
    again = diff.param_grads(scene, _zero(), rng.PRNGKey(key),
                             RenderConfig(**cfg))
    for k in diff.PARAM_KEYS:
        np.testing.assert_array_equal(_np(again[k]), _np(got[k]))


def test_param_grads_structure(scene):
    grads = diff.param_grads(scene, _zero(), rng.PRNGKey(2),
                             RenderConfig(**CFG))
    assert set(grads) == set(diff.PARAM_KEYS)
    for k in diff.PARAM_KEYS:
        assert np.isfinite(_np(grads[k])).all()
    assert isinstance(grads["tri_p0"], V3)
    assert grads["tri_p0"].x.shape == (scene.triangles.count,)
    # a black target pulls the light down; geometry gradients are live
    assert float(grads["light_le"].x.sum()) > 0
    assert float(np.abs(_np(grads["tri_p0"])).sum()) > 0


def _fd(f, x0, eps):
    with torch.no_grad():
        return (f(x0 + eps) - f(x0 - eps)).item() / (2 * eps)


def _grad(f, x0):
    x = torch.tensor(x0, requires_grad=True)
    g, = torch.autograd.grad(f(x), x)
    return g.item()


def test_emission_grad_matches_fd(scene):
    key = rng.PRNGKey(0)

    def f(s):
        sc = scene._replace(
            lights=scene.lights._replace(le=scene.lights.le * s),
            materials=scene.materials._replace(
                emission=scene.materials.emission * s))
        return sample_image(sc, key, RenderConfig(**CFG)).mean()

    g = _grad(f, 1.0)
    assert g == pytest.approx(_fd(f, 1.0, 1e-2), rel=0.05)
    assert g > 0   # a brighter light, a brighter image


def test_albedo_grad_matches_fd(scene):
    key = rng.PRNGKey(1)

    def f(s):
        sc = scene._replace(materials=scene.materials._replace(
            albedo=scene.materials.albedo * s))
        return sample_image(sc, key, RenderConfig(**CFG)).mean()

    g = _grad(f, 1.0)
    assert g == pytest.approx(_fd(f, 1.0, 1e-2), rel=0.05)
    assert g > 0


@pytest.mark.parametrize("surface,mis", [("light", False), ("floor", False),
                                         ("light", True)],
                         ids=["light", "floor", "light-mis"])
def test_geometry_grad_matches_fd(scene, surface, mis):
    """Vertex-position gradients through the straight-through hit
    reparameterisation: translate the area light (or the floor) along y;
    the gradient of an interior-crop loss matches central differences.
    Under MIS the light strategy's pdf (d^2 / cos) and the balance weight
    join the graph, which pins the guarded divisions' NaN-free
    backward."""
    cfg = RenderConfig(**dict(CFG, mis=mis), geom_grads=True)
    key = rng.PRNGKey(4)
    tris = scene.triangles
    em = scene.materials.is_emissive[tris.mat_id.long()]
    floor = ((tris.gn.y - 1).abs() < 1e-3) & (tris.p0.y < 0.1) & ~em
    mask = em if surface == "light" else floor
    assert bool(mask.any())

    def f(delta):
        p0 = V3(tris.p0.x, tris.p0.y + torch.where(mask, delta, 0.0),
                tris.p0.z)
        sc = scene._replace(triangles=tris._replace(p0=p0))
        return sample_image(sc, key, cfg)[4:20, 4:20].mean()

    g = _grad(f, 0.0)
    assert np.isfinite(g)
    assert g == pytest.approx(_fd(f, 0.0, 1e-3), rel=0.02)
    assert abs(g) > 1e-4   # the surface moved the image


def test_train_step_descends(scene):
    key = rng.PRNGKey(3)
    cfg = RenderConfig(**CFG)
    sc, loss0 = diff.train_step(scene, _zero(), key, cfg, lr=0.5)
    sc, loss1 = diff.train_step(sc, _zero(), key, cfg, lr=0.5)
    assert float(loss1) < float(loss0)
    # out of place: the step's scene holds new tensors
    assert sc.triangles.p0.x is not scene.triangles.p0.x
    assert not sc.materials.albedo.x.requires_grad


def test_train_steps_matches_sequential(scene):
    base = rng.PRNGKey(11)
    cfg = RenderConfig(**CFG)
    sc_n, losses = diff.train_steps(scene, _zero(), base, cfg, 0.3, 2)
    assert losses.shape == (2,)
    sc_seq, seq = scene, []
    for i in range(2):
        sc_seq, li = diff.train_step(sc_seq, _zero(), rng.fold_in(base, i),
                                     cfg, lr=0.3)
        seq.append(float(li))
    np.testing.assert_allclose(losses.numpy(), seq, rtol=1e-5)
    np.testing.assert_allclose(_np(sc_n.materials.albedo),
                               _np(sc_seq.materials.albedo), rtol=1e-5,
                               atol=1e-7)


def test_refuses_later_slices(scene):
    for change in (dict(integrator="adaptive"), dict(integrator="vpl")):
        with pytest.raises(NotImplementedError):
            diff.param_grads(scene, _zero(), rng.PRNGKey(0),
                             RenderConfig(**CFG, **change))


def test_wavefront_backward_matches_scan(spheres, compacting):
    cfg = RenderConfig(**SPHERES)
    key = rng.PRNGKey(9)
    loss_wf, g_wf = wavefront_diff.loss_and_grads(spheres, _zero(), key, cfg)
    loss_sc, g_sc = diff.value_and_grad(
        spheres, _zero(), key,
        diff._diff_cfg(dataclasses.replace(cfg, wavefront=False), spheres))
    assert float(loss_wf) == pytest.approx(float(loss_sc), rel=1e-5)
    for k in diff.PARAM_KEYS:
        a, b = _np(g_wf[k]), _np(g_sc[k])
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6, err_msg=k)
    assert float(np.abs(_np(g_wf["tri_p0"])).sum()) > 0


def test_wavefront_forward_unchanged(monkeypatch, spheres, compacting):
    """Recorded for autograd, the wavefront takes the forward's widths
    and gives its image bit for bit."""
    cfg = diff._diff_cfg(RenderConfig(**SPHERES), spheres)
    key = rng.PRNGKey(5)
    widths = []
    step = path.step

    def spy(scene, state, *args, **kw):
        widths.append(state["alive"].shape[0])
        return step(scene, state, *args, **kw)

    monkeypatch.setattr(wavefront.path_mod, "step", spy)
    with torch.no_grad():
        want = wavefront.sample_image_wavefront(spheres, key, cfg)
    fwd_widths, widths[:] = list(widths), []
    params, _ = diff._split_scene(spheres)
    leaves = [p.detach().requires_grad_(True) for p in diff._leaves(params)]
    got = wavefront.sample_image_wavefront(
        diff._merge_scene(diff._rebuild(params, leaves), spheres), key, cfg)
    assert got.requires_grad
    assert widths == fwd_widths and min(widths) < RES * RES
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())


def test_wavefront_train_step_descends(spheres, compacting):
    """As test_render.py's wavefront descent, at lr 0.1 with a refit
    between the steps: at lr 0.5 (the JAX test's, on another scene) the
    vertex step overshoots on this one and the loss rises."""
    cfg = RenderConfig(mis=True, jitter=True, max_depth=2)
    key = rng.PRNGKey(10)
    sc, l0 = wavefront_diff.train_step(spheres, _zero(), key, cfg, lr=0.1)
    sc, l1 = wavefront_diff.train_step(refit(sc), _zero(), key, cfg, lr=0.1)
    assert float(l1) < float(l0)


def test_train_step_autodispatch(monkeypatch, spheres):
    """diff.train_step sends the BVH scene to the wavefront backward (the
    render policy), and the step equals wavefront_diff.train_step's."""
    cfg = RenderConfig(mis=True, jitter=True, max_depth=2)
    key = rng.PRNGKey(12)
    seen = []
    orig = wavefront_diff.loss_and_grads

    def spy(*a, **kw):
        seen.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(wavefront_diff, "loss_and_grads", spy)
    sc_a, la = diff.train_step(spheres, _zero(), key, cfg, lr=0.5)
    assert seen
    sc_b, lb = wavefront_diff.train_step(spheres, _zero(), key, cfg, lr=0.5)
    assert float(la) == float(lb)
    np.testing.assert_array_equal(_np(sc_a.triangles.p0),
                                  _np(sc_b.triangles.p0))


@pytest.fixture
def counted(monkeypatch):
    """Calls of the traversal entry points and the kernels' wrappers."""
    calls = dict(closest_hit=0, occluded=0, mt=0, bvh=0)

    def wrap(mod, name, tag):
        orig = getattr(mod, name)

        def f(*a, **kw):
            calls[tag] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, f)

    wrap(intersect, "closest_hit", "closest_hit")
    wrap(common, "occluded", "occluded")
    wrap(mt_kernel, "intersect", "mt")
    wrap(bvh_kernel, "traverse_packet", "bvh")
    return calls


@pytest.mark.parametrize("which", ["cornell-scan", "spheres-wavefront"])
def test_backward_traverses_nothing(request, counted, which):
    sc = request.getfixturevalue("scene" if which == "cornell-scan"
                                 else "spheres")
    cfg = RenderConfig(**(MIS if which == "cornell-scan" else SPHERES))
    sample = (sample_image if which == "cornell-scan"
              else wavefront.sample_image_wavefront)
    dcfg = diff._diff_cfg(cfg, sc)
    assert dcfg.remat
    params, _ = diff._split_scene(sc)
    leaves = [p.detach().requires_grad_(True) for p in diff._leaves(params)]
    loss = diff.render_loss(diff._rebuild(params, leaves), sc, _zero(),
                            rng.PRNGKey(6), dcfg, sample)
    fwd = dict(counted)
    assert fwd["closest_hit"] == cfg.max_depth + 2 and fwd["occluded"] > 0
    assert fwd["mt"] > 0 and (fwd["bvh"] > 0) == (which != "cornell-scan")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert counted == fwd
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


def test_remat_off_matches_on(scene):
    key = rng.PRNGKey(7)
    on = diff.param_grads(scene, _zero(), key, RenderConfig(**MIS))
    off = diff.param_grads(scene, _zero(), key,
                           RenderConfig(**MIS, remat=False))
    for k in diff.PARAM_KEYS:
        np.testing.assert_array_equal(_np(on[k]), _np(off[k]), err_msg=k)


def test_masked_light_pdf_has_finite_gradient(scene):
    """A lane that hit no light, at the 1e12 miss clamp, grazing the
    light's plane (cos_l 1e-8): its MIS pdf is masked to 0, and the
    backward must give it a zero gradient, not 0 * inf = NaN (torch's
    division backward forms (a / b) / b; seen on the card at 1024x1024)."""
    from raytracingrenderer_tpu_torch.lights import lights
    gn = V3(torch.tensor([0.0, 0.0]), torch.tensor([-1.0, -1.0]),
            torch.tensor([0.0, 0.0]))
    far = V3(torch.tensor([1e12, 0.3], requires_grad=True),
             torch.tensor([1e4, 0.5], requires_grad=True),
             torch.tensor([0.0, 0.2], requires_grad=True))
    x = V3(*(torch.zeros(2) for _ in range(3)))
    light_id = torch.tensor([-1, 0], dtype=torch.int32)
    pdf = lights.hit_light_pdf_solid(scene, light_id, x, far, gn)
    assert float(pdf[0].detach()) == 0.0 and float(pdf[1].detach()) > 0.0
    grads = torch.autograd.grad(pdf.sum(), list(far))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(float(g[0]) == 0.0 for g in grads)


@pytest.mark.parametrize("which", ["cornell", "spheres"])
def test_geom_grads_leaves_image_unchanged(request, which):
    sc = request.getfixturevalue("scene" if which == "cornell"
                                 else "spheres")
    cfg = RenderConfig(**MIS)
    a = render(sc, cfg, spp=1).buffer
    b = render(sc, dataclasses.replace(cfg, geom_grads=True), spp=1).buffer
    assert bool(a.abs().sum() > 0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
