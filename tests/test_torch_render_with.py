"""integrators/dispatch.render_with, the entry point of the AOV,
light-tracer and VPL integrators, against the JAX package's on the
in-repo cornell box (36 triangles, B1's plain version) at 32x32, 2 spp,
mis + jitter, max_depth 3 (vpl 2: 200 shadow batches a pass);
tests/test_torch_render_with_bvh.py holds the 5,156-triangle scene's.
Each image holds the render tests' bar: >= 99% of pixels within rtol
1e-3 / atol 1e-5 and means within 0.5% (a hit, a Russian-roulette
decision or an occlusion bit can flip on an ulp of XLA's CPU math
against torch's).  Also: a film resumes, `render` and the gradients
still refuse these integrators, `adaptive_render` refuses `mesh=` (the
adaptive integrator itself is tests/test_torch_adaptive.py's), and the
wrappers' CPU branch, which walks live lanes only, equals the plain
versions on every lane."""
import dataclasses

import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.imaging import film as jfilm
from raytracingrenderer_tpu.integrators.dispatch import render_with as jrw
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.integrators.adaptive import adaptive_render
from raytracingrenderer_tpu_torch.integrators.dispatch import render_with
from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
from raytracingrenderer_tpu_torch.render import render
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from raytracingrenderer_tpu_torch.scene.types import Triangles
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

RES = 32
CFG = dict(mis=True, jitter=True, max_depth=3)
VPL_CFG = dict(mis=True, jitter=True, max_depth=2)   # 200 slots a pass
INTEGRATORS = ("direct", "albedo", "normals", "lighttrace", "vpl")


def _np(x):
    return x.detach().numpy()


def agree(a, b):
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = write_cornell(str(tmp_path_factory.mktemp("cornell")), RES, RES)
    return load_scene(d, "cpu"), jload(d, build_bvh=False)


@pytest.fixture(scope="module")
def spheres(tmp_path_factory):
    d = write_spheres(str(tmp_path_factory.mktemp("spheres")), 16, 16,
                      subdiv=2)
    return load_scene(d, "cpu")


def render_pair(ts, js, integ, spp):
    cfg = VPL_CFG if integ == "vpl" else CFG
    got = film_mod.to_hdr(render_with(
        ts, RenderConfig(**cfg, integrator=integ), spp)).numpy()
    want = np.asarray(jfilm.to_hdr(jrw(
        js, JConfig(**cfg, integrator=integ), spp)))
    return got, want


@pytest.mark.parametrize("integ", INTEGRATORS)
def test_render_with_matches_jax_cornell(cornell, integ):
    ts, js = cornell
    got, want = render_pair(ts, js, integ, 2)
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all() and 0.02 < got.mean() < 1.0
    agree(got, want)


def test_render_with_film_and_on_sample(cornell):
    """A film resumes where it stopped (pass s keyed by spp_key(base, s))
    and on_sample sees every pass."""
    ts, _ = cornell
    cfg = RenderConfig(**CFG, integrator="lighttrace")
    whole = render_with(ts, cfg, 2)
    seen = []
    half = render_with(ts, cfg, 1, on_sample=lambda s, f: seen.append(s))
    both = render_with(ts, cfg, 1, film=half,
                       on_sample=lambda s, f: seen.append(s))
    assert seen == [0, 1] and float(both.spp) == 2.0
    np.testing.assert_allclose(_np(both.buffer), _np(whole.buffer),
                               rtol=1e-6, atol=1e-7)
    assert both.buffer.device == ts.device


@pytest.mark.parametrize("integ,err", [("adaptive", NotImplementedError),
                                       ("path", ValueError),
                                       ("bdpt", ValueError)])
def test_render_with_refuses(cornell, integ, err):
    """The adaptive integrator refuses a `mesh=` that is not a port Mesh
    (parallel/mesh.py; the working path is in test_torch_parallel.py);
    the path tracer is render()'s, and an unknown name raises as in the
    JAX package."""
    ts, _ = cornell
    with pytest.raises(err):
        if integ == "adaptive":
            adaptive_render(ts, RenderConfig(integrator=integ), 1,
                            mesh=object())
        else:
            render_with(ts, RenderConfig(integrator=integ), 1)


def test_render_refuses_dispatch_integrators(cornell):
    ts, _ = cornell
    for integ in INTEGRATORS:
        with pytest.raises(NotImplementedError, match="render_with"):
            render(ts, dataclasses.replace(RenderConfig(),
                                           integrator=integ), spp=1)


@pytest.mark.parametrize("kind", ["mt", "closest", "any", "wide"])
def test_live_lanes_equal_every_lane(spheres, kind):
    """The wrappers' CPU branch walks the live lanes only
    (intersect.on_live_lanes); every output equals the plain version's
    over every lane, dead ones (t_init <= 0) included."""
    rs = np.random.RandomState(8)
    n = 3000
    o = rs.uniform(-0.8, 0.8, (3, n)).astype(np.float32)
    o[1] += 1.0
    d = rs.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    t0 = rs.uniform(0.0, 3.0, n).astype(np.float32)
    t0[rs.rand(n) < 0.4] = -1.0
    t0[:40] = 0.0
    o, d = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
    t0 = torch.from_numpy(t0)
    tr = spheres.triangles
    if kind == "mt":
        idx = torch.arange(1000)
        sub = Triangles(*(f.gather(idx) if isinstance(f, V3) else f[idx]
                          for f in tr))
        full = mt_kernel.intersect_plain(sub, o, d, t0)
        fast = mt_kernel.intersect(sub, o, d, t0)
    else:
        args = dict(any_hit=kind == "any", wide=True if kind == "wide"
                    else None)
        full = bvh_kernel.traverse_plain(spheres.bvh, tr, o, d, t0, **args)
        fast = bvh_kernel.traverse_packet(spheres.bvh, tr, o, d, t0, **args)
    for a, b in zip(full, fast):
        assert torch.equal(a, b)
    assert int((full.tri >= 0).sum()) > 100
