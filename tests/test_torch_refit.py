"""Geometry updates in the port: `geometry/refit.py` and the caches that a
step which moves vertices must not leave stale.

- `refit_bvh` equals the JAX package's on the same tree and moved
  triangles (lo and hi bit for bit), on the 5,156-triangle spheres scene;
  after a refit the stackless walk and the packet walk's plain version
  give brute force's hits, where the stale tree misses some
  (test_diff.py:215-246); refits alternate over two topologies
  (`_internal_levels`' cache); `refit(scene)` refreshes the light
  table's geometry, area and power from the triangles and the scene
  bounds from the new root box, and returns a new tree with an empty
  cache that keeps the wide and treelet fields.
- A light-translation optimisation on the cornell box at 24x24 recovers
  the light's position by SGD on its interior geometry gradient, with a
  refit after every step (test_diff.py:286-325, on an interior crop).
- The caches: the proxy pre-pass after a `tri_p0` replacement (the areas
  unchanged) tests the moved triangles, as brute force over the same
  128 largest triangles does; an in-place change of `p0.y` repacks the
  BVH kernel's tables (both leaf forms, the wide form) and the treelet
  constants; the Russian-roulette probability carries no gradient, as
  in the JAX package (its 1/p weight is part of the sampling).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.geometry.refit import refit_bvh as jrefit_bvh
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import intersect
from raytracingrenderer_tpu_torch.geometry.bvh import build
from raytracingrenderer_tpu_torch.geometry.refit import refit, refit_bvh
from raytracingrenderer_tpu_torch.integrators import path
from raytracingrenderer_tpu_torch.ops import bvh_kernel, treelet
from raytracingrenderer_tpu_torch.render import (pixel_grid, sample_image,
                                                 specialize_config)
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.camera import generate_rays
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from raytracingrenderer_tpu_torch.scene.types import Triangles
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

RES = 24
CFG = dict(max_depth=2, mis=False, jitter=False, rr=False)


@pytest.fixture(scope="module")
def spheres_dir(tmp_path_factory):
    return write_spheres(str(tmp_path_factory.mktemp("spheres")), RES, RES,
                         subdiv=2)


@pytest.fixture(scope="module")
def spheres(spheres_dir):
    return load_scene(spheres_dir, "cpu")


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return load_scene(write_cornell(str(tmp_path_factory.mktemp("cornell")),
                                    RES, RES), "cpu")


def _rays(n, seed):
    """Rays from inside the box, as tests/test_torch_cuda.py::_rays_n draws
    them."""
    g = np.random.default_rng(seed)
    o = (g.uniform(-1, 1, (n, 3)) * 0.5 + [0, 1, 0.5]).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (V3(*(torch.from_numpy(o[:, i].copy()) for i in range(3))),
            V3(*(torch.from_numpy(d[:, i].copy()) for i in range(3))))


def _moved(tris, light):
    """The light 0.4 lower, every other triangle shifted by a small
    per-triangle offset (areas unchanged)."""
    g = np.random.default_rng(3)
    off = torch.from_numpy(
        g.uniform(-0.02, 0.02, (tris.count, 3)).astype(np.float32))
    p0 = tris.p0
    return tris._replace(p0=V3(p0.x + off[:, 0],
                               p0.y + off[:, 1] - torch.where(light, 0.4, 0.0),
                               p0.z + off[:, 2]))


def _light(scene):
    return scene.materials.is_emissive[scene.triangles.mat_id.long()]


def test_refit_bvh_matches_jax(spheres_dir, spheres):
    js = jload(spheres_dir)
    tris2 = _moved(spheres.triangles, _light(spheres))
    jt = js.triangles
    jt2 = jt._replace(p0=JV3(*(jnp.asarray(c.numpy()) for c in tris2.p0)))
    np.testing.assert_array_equal(np.asarray(jt.e1.x),
                                  spheres.triangles.e1.x.numpy())
    want = jrefit_bvh(js.bvh, jt2)
    got = refit_bvh(spheres.bvh, tris2)
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
    assert not np.array_equal(got.lo.numpy(), spheres.bvh.lo.numpy())


def test_refit_traversal_matches_brute(spheres):
    tris2 = _moved(spheres.triangles, _light(spheres))
    bvh2 = refit_bvh(spheres.bvh, tris2)
    # the root box holds the moved geometry
    assert float(bvh2.lo[0, 1]) <= float(tris2.p0.y.min()) + 1e-5
    o, d = _rays(512, 0)
    want = intersect.closest_hit_brute(tris2, o, d)
    t_init = torch.full((512,), intersect.BIG_T)
    for name, hit in (
            ("stackless", intersect.closest_hit_bvh(bvh2, tris2, o, d)),
            ("packet", bvh_kernel.traverse_plain(bvh2, tris2, o, d,
                                                 t_init))):
        hit_t = torch.where(hit.tri >= 0, hit.t, intersect.BIG_T)
        assert torch.equal(hit.tri, want.tri), name
        np.testing.assert_allclose(np.minimum(hit_t.numpy(), 1e30),
                                   np.minimum(want.t.numpy(), 1e30),
                                   rtol=1e-4, err_msg=name)
    stale = intersect.closest_hit_bvh(spheres.bvh, tris2, o, d)
    assert not torch.equal(stale.tri, want.tri)


def test_refit_alternating_topologies():
    """Refits alternating over two topologies each give the bounds of a
    fresh build (the levels cache is keyed by content, not id())."""
    def soup(n, seed):
        r = np.random.default_rng(seed)
        p0 = r.uniform(-1, 1, (n, 3)).astype(np.float32)
        e = r.uniform(0.05, 0.2, (n, 2, 3)).astype(np.float32)
        return np.stack([p0, p0 + e[:, 0], p0 + e[:, 1]], axis=1)

    def tris_of(tp):
        def v3(a):
            return V3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))
        return Triangles(
            *(v3(a) for a in (tp[:, 0], tp[:, 1] - tp[:, 0],
                              tp[:, 2] - tp[:, 0])), *([None] * 10))

    for trial in range(3):
        for n, seed in ((97, 1), (251, 2)):
            tp = soup(n, seed)
            bvh, order = build(tp)
            tp = tp[order] + np.float32(0.1 * trial)
            ref, _ = build(tp)
            got = refit_bvh(bvh, tris_of(tp))
            np.testing.assert_allclose(got.lo[0].numpy(), ref.lo[0].numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(got.hi[0].numpy(), ref.hi[0].numpy(),
                                       atol=1e-5)


def test_refit_scene(spheres):
    tl = spheres._replace(bvh=treelet.attach_treelets(spheres.bvh))
    bvh_kernel.tables(tl.bvh, tl.triangles, True)
    assert tl.bvh.cache
    light = _light(tl)
    moved = tl._replace(triangles=_moved(tl.triangles, light))
    out = refit(moved)
    lt, tr = out.lights, out.triangles
    ti = lt.tri.long()
    for a, b in ((lt.p0, tr.p0), (lt.e1, tr.e1), (lt.e2, tr.e2),
                 (lt.gn, tr.gn)):
        np.testing.assert_array_equal(a.stacked().numpy(),
                                      b.gather(ti).stacked().numpy())
    np.testing.assert_allclose(lt.area.numpy(), tr.area[ti].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(lt.power.numpy(),
                               (lt.le.lum() * lt.area).numpy())
    # bounds from the new root box; the tree is new, its cache empty, its
    # wide and treelet fields kept
    lo0, hi0 = out.bvh.lo[0].numpy(), out.bvh.hi[0].numpy()
    np.testing.assert_allclose(out.bounds.centre.x.item(),
                               0.5 * (lo0[0] + hi0[0]))
    assert lo0[1] < spheres.bvh.lo[0, 1].item()
    assert out.bvh is not tl.bvh and not out.bvh.cache
    for f in ("right", "start", "count", "skip", "wsel", "wcode", "waxis",
              "tl_nodes", "tl_start", "tl_count", "tc_nodes"):
        assert getattr(out.bvh, f) is getattr(tl.bvh, f), f


def test_light_translation_optimizes_with_refit(cornell):
    """Translate the area light 0.15 below its place and recover it by
    SGD on its interior geometry gradient, refitting the light table
    after every step (cornell's 36 triangles take no BVH walk).  The
    loss reads the interior crop of the FD tests: this scene's light
    hangs just below the ceiling in view, and the pixels on its
    silhouette flip as it moves (a boundary term, which the interior
    gradient leaves out): over the whole image they jump the loss from
    3e-4 to 1.02 at one step of the same descent."""
    cfg = RenderConfig(**CFG, geom_grads=True)
    key = rng.PRNGKey(8)
    with torch.no_grad():
        target = sample_image(cornell, key, cfg)
    mask = _light(cornell)

    def shift(sc, dy):
        p0 = sc.triangles.p0
        return sc._replace(triangles=sc.triangles._replace(
            p0=V3(p0.x, p0.y + torch.where(mask, dy, 0.0), p0.z)))

    def loss_and_grad(sc):
        dy = torch.zeros((), requires_grad=True)
        img = sample_image(shift(sc, dy), key, cfg)
        loss = torch.mean((img[4:20, 4:20] - target[4:20, 4:20]) ** 2)
        g, = torch.autograd.grad(loss, dy)
        return loss.item(), g.item()

    off = -0.15
    cur = refit(shift(cornell, off))
    # the light table follows the move
    assert cur.lights.p0.y[0].item() == pytest.approx(
        cur.triangles.p0.gather(cur.lights.tri.long()).y[0].item())
    l0, g0 = loss_and_grad(cur)
    lr = 0.03 / max(abs(g0), 1e-12)        # the first step moves 0.03
    losses = [l0]
    for _ in range(8):
        _, g = loss_and_grad(cur)
        step = float(np.clip(-lr * g, -0.05, 0.05))
        off += step
        cur = refit(shift(cur, step))
        losses.append(loss_and_grad(cur)[0])
    assert abs(off) < 0.06, f"offset did not converge: {off}"
    assert losses[-1] < 0.3 * losses[0]


def test_prepass_sees_replaced_triangles(spheres):
    """A step replaces tri_p0 and keeps the areas: the any-hit pre-pass
    must test the moved triangles, as brute force over the same 128
    largest triangles does."""
    o, d = _rays(1024, 1)
    t_init = torch.full((1024,), intersect.BIG_T)
    intersect._proxy_prepass(spheres, o, d, t_init)       # fills the cache
    p0 = spheres.triangles.p0
    moved = spheres._replace(triangles=spheres.triangles._replace(
        p0=V3(p0.x + 0.05, p0.y - 0.3, p0.z + 0.1)))
    got = intersect._proxy_prepass(moved, o, d, t_init)
    tris = moved.triangles
    idx = torch.sort(tris.area, descending=True, stable=True).indices[:128]
    sub = Triangles(*(f.gather(idx) if isinstance(f, V3)
                                else f[idx] for f in tris))
    want = intersect.closest_hit_brute(sub, o, d)
    assert bool((want.tri >= 0).any())
    assert torch.equal(got.tri, torch.where(want.tri >= 0,
                                            idx[want.tri.long()].int(), -1))
    assert torch.equal(got.t, want.t)


@pytest.mark.parametrize("form", ["raw", "leaf16", "wide", "treelet"])
def test_inplace_vertex_change_repacks(spheres, form):
    """An in-place change of p0.y (not p0.x, which the tables were once
    keyed on) must repack the kernel's tables."""
    tris = spheres.triangles._replace(
        p0=V3(*(c.clone() for c in spheres.triangles.p0)))
    bvh = spheres.bvh
    if form == "treelet":
        bvh = treelet.attach_treelets(bvh)

    def packed():
        if form == "treelet":
            return (treelet.pack_constants(bvh, tris),)
        return bvh_kernel.tables(bvh, tris, form == "leaf16",
                                 wide=form == "wide")

    def fresh():
        if form == "treelet":
            return (treelet._pack_constants(bvh, tris),)
        if form == "wide":
            return bvh_kernel.pack_tables_wide(bvh, tris)
        return bvh_kernel.pack_tables(bvh, tris, leaf16=form == "leaf16")

    before = [t.clone() for t in packed()]
    assert all(a is b for a, b in zip(packed(), packed()))   # kept
    tris.p0.y.add_(0.25)
    after = packed()
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
    for a, b in zip(after, fresh()):
        assert torch.equal(a, b)


def test_rr_probability_carries_no_gradient(cornell):
    """out.throughput = throughput * weight / rr_p with rr_p =
    min(lum(throughput), rr_cap) detached: d out.x / d throughput.y is 0
    (the JAX package stops rr_p's gradient), d out.x / d throughput.x is
    not."""
    cfg = specialize_config(RenderConfig(rr=True, max_depth=4), cornell)
    cam = cornell.camera
    xs, ys = pixel_grid(cam.height, cam.width)
    o, d = generate_rays(cam, xs + 0.5, ys + 0.5)
    state = path.init_state(o, d)
    n = o.x.shape[0]
    thr = [torch.full((n,), 0.5, requires_grad=True) for _ in range(3)]
    state["throughput"] = V3(*thr)                 # lum 0.5 < rr_cap 0.9
    out = path.bounce_step(cornell, state, 0, rng.PRNGKey(1), cfg)
    assert bool(out["alive"].any())
    gx, gy = torch.autograd.grad(out["throughput"].x.sum(), thr[:2],
                                 allow_unused=True)
    assert gy is None or not bool(gy.any())
    assert bool(gx[out["alive"]].abs().min() > 0)
