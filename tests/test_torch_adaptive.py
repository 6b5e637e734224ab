"""integrators/adaptive.py against the JAX package's.

The tile statistics and the draws run on states made from numpy: a
64x96 film (6 whole tiles), a 50x80 one (6 tiles, the partial ones
padded) and a 1024x1024 one (1,024 tiles, a round's 786,432 draws at 8
spp).  The cumsum rule: XLA's float32 cumsum and torch's sum in other
orders and may differ by an ulp on many entries, so a draw whose u lies
that close to a tile boundary may land in the tile next to it.  Every
draw lands in the same tile in both packages except those with
|u - cdf[k]| <= 4 * 2^-24 at the boundary k between the two tiles, and
every draw that lands alike picks the same pixel.  The 1024x1024 case
counts such draws.

`_scatter_round` and `render_with(integrator="adaptive")` run at 32x32
(one tile, so every draw must be equal) on the in-repo cornell box (B1's
plain version) and the 5,156-triangle spheres scene (the BVH walk's
plain version and its pre-pass), held to the render tests' bar: >= 99%
of pixels within rtol 1e-3 / atol 1e-5, means within 0.5%; the counts
exactly.  Then the resume and on_sample contract of the JAX package's
TestAdaptiveContract, and a `mesh=` that is not a port Mesh refused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.imaging import film as jfilm
from raytracingrenderer_tpu.integrators import adaptive as jad
from raytracingrenderer_tpu.integrators.dispatch import render_with as jrw
from raytracingrenderer_tpu.render import render as jrender
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import TILE_SIZE, RenderConfig
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.integrators import adaptive as tad
from raytracingrenderer_tpu_torch.integrators.dispatch import render_with
from raytracingrenderer_tpu_torch.render import render
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from test_torch_render_with import agree
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

RES = 32
CFG = dict(mis=True, jitter=True, max_depth=3)
CUMSUM_ULPS = 4 * 2.0 ** -24


def _state(h, w, seed):
    """A state from numpy: up to 6 samples a pixel in the display
    counts, 0 to 5 in the variance population (so some pixels count as
    unexplored), sums of squares at or above the squared sums."""
    g = np.random.default_rng(seed)
    vc = g.integers(0, 6, (h, w)).astype(np.float32)
    mean = g.gamma(0.5, 0.4, (h, w)).astype(np.float32)
    lsum = (mean * vc).astype(np.float32)
    spread = g.gamma(1.0, 0.05, (h, w)).astype(np.float32)
    sum2 = (vc * (mean * mean + spread)).astype(np.float32)
    count = vc + g.integers(0, 2, (h, w)).astype(np.float32)
    sum1 = (g.random((h, w, 3)) * count[..., None]).astype(np.float32)
    arrays = (sum1, count, lsum, sum2, vc)
    return (jad.AdaptiveState(*map(jnp.asarray, arrays)),
            tad.AdaptiveState(*map(torch.from_numpy, arrays)))


def _key(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


@pytest.mark.parametrize("h,w", [(64, 96), (50, 80), (1024, 1024)])
def test_tile_variance_matches_jax(h, w):
    js, ts = _state(h, w, h + w)
    want = np.asarray(jad._tile_variance(js))
    got = tad._tile_variance(ts).numpy()
    assert got.shape == want.shape == (-(-h // TILE_SIZE),
                                       -(-w // TILE_SIZE))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("h,w,n_rays", [(64, 96, 5000), (50, 80, 4097),
                                        (1024, 1024, 786_432)])
def test_sample_pixels_cumsum_rule(h, w, n_rays):
    js, ts = _state(h, w, 7 * h + w)
    tw = -(-w // TILE_SIZE)
    moved = 0
    for seed in (0, 3):
        jk, tk = _key(seed)
        jx, jy = (np.asarray(a) for a in jad._sample_pixels(
            js, jk, n_rays, h, w))
        tx, ty = (a.numpy() for a in tad._sample_pixels(ts, tk, n_rays,
                                                        h, w))
        assert tx.shape == jx.shape == (n_rays,)
        assert (tx >= 0).all() and (tx < w).all()
        assert (ty >= 0).all() and (ty < h).all()
        jt = (jy // TILE_SIZE) * tw + jx // TILE_SIZE
        tt = (ty // TILE_SIZE) * tw + tx // TILE_SIZE
        same = jt == tt
        np.testing.assert_array_equal(tx[same], jx[same])
        np.testing.assert_array_equal(ty[same], jy[same])
        if same.all():
            continue
        # the draws that moved: each sits within the cumsum's rounding of
        # the boundary between its two tiles, which are neighbours
        var = jad._tile_variance(js) + 1e-8
        cdf = np.asarray(jnp.cumsum((var / var.sum()).reshape(-1)))
        u = np.asarray((jnp.arange(n_rays) + jax.random.uniform(
            jk, (n_rays,))) / n_rays)
        i = np.nonzero(~same)[0]
        assert (np.abs(jt[i] - tt[i]) == 1).all()
        k = np.minimum(jt[i], tt[i])
        assert (np.abs(u[i] - cdf[k]) <= CUMSUM_ULPS).all()
        moved += i.size
    print(f"{h}x{w}: {moved} of {2 * n_rays} draws in another tile")
    assert moved <= 2 * n_rays // 1000


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    d = write_cornell(str(tmp_path_factory.mktemp("cornell")), RES, RES)
    return load_scene(d, "cpu"), jload(d, build_bvh=False)


@pytest.fixture(scope="module")
def spheres(tmp_path_factory):
    d = write_spheres(str(tmp_path_factory.mktemp("spheres")), RES, RES,
                      subdiv=2)
    return load_scene(d, "cpu"), jload(d)


@pytest.fixture(params=["cornell", "spheres"])
def scenes(request):
    return request.getfixturevalue(request.param)


def test_scatter_round_matches_jax(scenes):
    """One round of 3 * 32 * 32 rays into a state from numpy: one tile,
    so every draw is equal and the counts match exactly."""
    ts, js = scenes
    jst, tst = _state(RES, RES, 11)
    jk, tk = _key(5)
    n = 3 * RES * RES
    want = jad._scatter_round(js, jst, jk, JConfig(**CFG), n, RES, RES)
    got = tad._scatter_round(ts, tst, tk, RenderConfig(**CFG), n, RES, RES)
    for name in ("count", "vcount"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    added = float((got.count - tst.count).sum())
    assert added == n
    # the radiance this round added, a pixel's mean, by the render bar
    for name in ("sum1", "lsum", "sum2"):
        d_t = (getattr(got, name) - getattr(tst, name)).numpy()
        d_j = np.asarray(getattr(want, name) - getattr(jst, name))
        per = np.maximum((got.count - tst.count).numpy(), 1.0)
        if d_t.ndim == 3:
            per = per[..., None]
        else:
            d_t, d_j = d_t[..., None], d_j[..., None]
        agree(d_t / per, d_j / per)


def test_render_with_adaptive_matches_jax(scenes):
    ts, js = scenes
    got = render_with(ts, RenderConfig(**CFG, integrator="adaptive"), 4)
    want = jrw(js, JConfig(**CFG, integrator="adaptive"), 4)
    assert float(got.spp) == pytest.approx(float(want.spp), rel=1e-6)
    img = film_mod.to_hdr(got).numpy()
    assert img.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and 0.02 < img.mean() < 1.0
    agree(img, np.asarray(jfilm.to_hdr(want)))


def test_adaptive_resume_and_on_sample(cornell):
    """TestAdaptiveContract::test_adaptive_resume_and_on_sample in the
    port, and against the JAX package: a film resumes as the prior, every
    init pass and round reports, the films agree."""
    ts, js = cornell
    cfg = dict(jitter=True, max_depth=2)
    seen, jseen = [], []
    f1 = render(ts, RenderConfig(**cfg), spp=2)
    f2 = tad.adaptive_render(ts, RenderConfig(**cfg, integrator="adaptive"),
                             total_spp=4, film=f1,
                             on_sample=lambda s, f: seen.append(s))
    assert float(f2.spp) > float(f1.spp)    # prior counts + new work
    assert len(seen) >= 2
    img = film_mod.to_hdr(f2).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    j1 = jrender(js, JConfig(**cfg), spp=2)
    j2 = jad.adaptive_render(js, JConfig(**cfg, integrator="adaptive"),
                             total_spp=4, film=j1,
                             on_sample=lambda s, f: jseen.append(s))
    assert seen == jseen == list(range(2, 12))
    assert float(f2.spp) == pytest.approx(float(j2.spp), rel=1e-6)
    agree(img, np.asarray(jfilm.to_hdr(j2)))


def test_adaptive_mesh_refused(cornell):
    """A mesh that is not a port Mesh (parallel/mesh.py) is refused; the
    working mesh= path is held in tests/test_torch_parallel.py."""
    ts, _ = cornell
    with pytest.raises(NotImplementedError, match="not a port Mesh"):
        tad.adaptive_render(ts, RenderConfig(integrator="adaptive"), 2,
                            mesh=object())
