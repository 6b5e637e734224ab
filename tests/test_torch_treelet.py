"""The port's treelet route (ops/treelet.py) against the JAX package's,
on the 5,156-triangle spheres scene (its BVH from both loaders) and on a
small triangle soup:

- `attach_treelets`' six arrays, `pack_constants` and `candidates`'
  slots and overflow flags equal JAX's exactly (the constants bit for
  bit: their cross products are rounded as XLA rounds them);
- `pair_test_plain` (the CUDA kernel's plain version) against the Pallas
  `_pair_test` in interpret mode on two tiles of real (ray, treelet)
  pairs: the same pairs hit, t within rtol 1e-5 / atol 1e-6 (XLA's CPU
  dot products accumulate with FMAs in their own order, so not bit for
  bit; a t near 0 moves by an ulp of its cancelling terms o . N - c0),
  columns equal on >= 99.9% of hit pairs, an untouched pair keeps
  t = INF and col = -1;
- `traverse_treelet`, closest-hit with the BIG_T seed (candidate
  overflow, so the binary-walk fallback) and with the ideal seed, and
  any-hit: the brute-force oracle's ids and bits exactly, and JAX's
  `traverse_treelet(interpret=True)`;
- `closest_hit` / `occluded` take the route ahead of the packet route
  (counted in `treelet_calls`), and a 32x32, 2 spp render of the spheres
  scene with treelets attached agrees with the JAX CPU render per pixel
  at the bar of tests/test_torch_render.py.

The CUDA kernel itself is checked against `pair_test_plain` by
tests/test_torch_cuda.py on the card; here a torch
model of its partition (the runs of equal treelet id that a block of
pairs walks, the window of tiles resident at a time, a pair tested
against its own run's tile only, the sums without negated features, the
columns folded four at a time with the first column kept among equal t)
is held to `pair_test_plain` bit for bit on synthetic pairs at the shapes
that could break it."""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.geometry.bvh import build as jbuild
from raytracingrenderer_tpu.imaging import film as jfilm
from raytracingrenderer_tpu.ops import treelet as jtl
from raytracingrenderer_tpu.render import render as jrender
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import bvh as tbvh
from raytracingrenderer_tpu_torch.geometry import intersect as tint
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.ops import bvh_kernel as tbk
from raytracingrenderer_tpu_torch.ops import mt_kernel
from raytracingrenderer_tpu_torch.ops import treelet as ttl
from raytracingrenderer_tpu_torch.render import render
from raytracingrenderer_tpu_torch.scene.loader import load_scene as tload
from raytracingrenderer_tpu_torch.scene.types import Triangles
from torch_scenes import PAIR_PATTERNS, pair_case, write_spheres

torch.set_num_threads(2)

N = 1037
TL_FIELDS = ("tl_nodes", "tl_start", "tl_count", "tc_nodes", "tc_start",
             "tc_count")
CUTS = {"default": {}, "small": dict(t_max=32, g_child=6)}
SPHERES = dict(mis=True, jitter=True, max_depth=3)


@pytest.fixture(scope="module")
def spheres_dir(tmp_path_factory):
    return write_spheres(str(tmp_path_factory.mktemp("spheres")), 32, 32, 2)


@pytest.fixture(scope="module")
def scenes(spheres_dir):
    return jload(spheres_dir), tload(spheres_dir, "cpu")


@pytest.fixture(scope="module")
def rays(scenes):
    """Rays from inside the box, 10% dead; half of them seeded with their
    brute-force closest t (the pruned case), half with BIG_T."""
    _, ts = scenes
    g = np.random.default_rng(29)
    o = (g.uniform(-1, 1, (N, 3)) * 0.5 + [0, 1, 0.5]).astype(np.float32)
    d = g.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = g.random(N) < 0.1
    ref = tint.closest_hit_brute(ts.triangles, _tv(o), _tv(d)).t.numpy()
    seed = np.where(g.random(N) < 0.5, np.minimum(ref, 1e30), tint.BIG_T)
    seed = np.where(dead, -1.0, seed).astype(np.float32)
    radius = np.where(seed > 0, seed * np.float32(1.0001) + np.float32(1e-5),
                      -1.0).astype(np.float32)
    return o, d, dead, radius


def _jv(a):
    return JV3.from_stacked(jnp.asarray(a))


def _tv(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_attach_treelets_match_jax(scenes, cut):
    js, ts = scenes
    jb = jtl.attach_treelets(js.bvh, **CUTS[cut])
    tb = ttl.attach_treelets(ts.bvh, **CUTS[cut])
    for f in TL_FIELDS:
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert got.dtype == want.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert ttl.has_treelets(tb) and not ttl.has_treelets(ts.bvh)
    assert int(tb.tl_count.sum()) == ts.triangles.count
    assert int(tb.tc_count.sum()) == tb.tl_nodes.shape[0]
    # the cut keeps the wide fields and starts a fresh cache
    assert torch.equal(tb.wsel, ts.bvh.wsel) and not tb.cache


def test_pack_constants_match_jax(scenes):
    js, ts = scenes
    jb, tb = jtl.attach_treelets(js.bvh), ttl.attach_treelets(ts.bvh)
    want = np.asarray(jtl.pack_constants(jb, js.triangles))
    got = ttl.pack_constants(tb, ts.triangles)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (tb.tl_nodes.shape[0] * 16, ttl.T_LEAF)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ttl.pack_constants(tb, ts.triangles) is got


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_candidates_match_jax(scenes, rays, cut):
    js, ts = scenes
    o, d, dead, radius = rays
    jb = jtl.attach_treelets(js.bvh, **CUTS[cut])
    tb = ttl.attach_treelets(ts.bvh, **CUTS[cut])
    js_, jo = jtl.candidates(jb, _jv(o), _jv(d), jnp.asarray(radius))
    ts_, to = ttl.candidates(tb, _tv(o), _tv(d), torch.from_numpy(radius))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert ts_.shape == (N, ttl.M_SLOTS)
    assert not (ts_.numpy()[dead] >= 0).any()
    assert (ts_ >= 0).any(dim=1).float().mean() > 0.5
    if cut == "small":
        assert 0.0 < to.float().mean() < 0.5


def test_pair_test_plain_matches_pallas_interpret(scenes, rays, monkeypatch):
    js, ts = scenes
    o, d, _, radius = rays
    jb = jtl.attach_treelets(js.bvh, t_max=32, g_child=6)
    tb = ttl.attach_treelets(ts.bvh, t_max=32, g_child=6)
    slots, _ = ttl.candidates(tb, _tv(o), _tv(d), torch.from_numpy(radius))
    tid = torch.where(slots >= 0, slots, ttl.SENTINEL).reshape(-1)
    tid_s, pidx = torch.sort(tid, stable=True)
    p = 2 * ttl.PAIR_TILE
    assert int((slots >= 0).sum()) > p
    tid_s = tid_s[:p].int().contiguous()
    # the last 16 pairs are sentinels: untouched
    tid_s[-16:] = ttl.SENTINEL
    feats = ttl._feats(_tv(o), _tv(d), torch.from_numpy(radius))[
        pidx[:p] // ttl.M_SLOTS].contiguous()
    consts = ttl.pack_constants(tb, ts.triangles)
    jt, jcol = jtl._pair_test(jnp.asarray(consts.numpy()),
                              jnp.asarray(feats.numpy()),
                              jnp.asarray(tid_s.numpy()),
                              tb.tl_nodes.shape[0], interpret=True)
    jt, jcol = np.asarray(jt), np.asarray(jcol)
    launches = ttl.launches
    pt, pcol = ttl.pair_test(consts, feats, tid_s)
    assert ttl.launches == launches and ttl._lib is None
    assert pt.dtype == torch.float32 and pcol.dtype == torch.int32
    pt, pcol = pt.numpy(), pcol.numpy()
    hit = jt < np.float32(ttl.INF)
    np.testing.assert_array_equal(pt < np.float32(ttl.INF), hit)
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-5, atol=1e-6)
    assert (pcol[hit] == jcol[hit]).mean() >= 0.999
    assert (pcol[~hit] == -1).all() and (jcol[~hit] == -1).all()
    assert (pt[~hit] == np.float32(ttl.INF)).all()
    # chunking changes nothing
    monkeypatch.setattr(ttl, "_PAIR_CHUNK", 1000)
    ct, ccol = ttl.pair_test_plain(consts, feats, tid_s)
    np.testing.assert_array_equal(ct.numpy(), pt)
    np.testing.assert_array_equal(ccol.numpy(), pcol)


@pytest.fixture(scope="module")
def soup():
    """600 small triangles in [-1, 1]^3 and 256 rays, through both
    packages' Python builders, cut small (t_max 8, g_child 2) so that
    some BIG_T seeds overflow the candidate caps."""
    g = np.random.default_rng(0)
    t = 600
    p0 = g.uniform(-1, 1, (t, 3)).astype(np.float32)
    e = g.uniform(-0.1, 0.1, (t, 2, 3)).astype(np.float32)
    tp = np.stack([p0, p0 + e[:, 0], p0 + e[:, 1]], axis=1)
    jb, order = jbuild(tp)
    tb, order_t = tbvh.build(tp)
    np.testing.assert_array_equal(order, order_t)
    tp = tp[order]
    jb = jtl.attach_treelets(jb, t_max=8, g_child=2)
    tb = ttl.attach_treelets(tbk.widen(tb), t_max=8, g_child=2)

    class JTris:
        count = t

    jt = JTris()
    jt.p0, jt.e1, jt.e2 = (JV3(*(jnp.asarray(a[:, i]) for i in range(3)))
                           for a in (tp[:, 0], tp[:, 1] - tp[:, 0],
                                     tp[:, 2] - tp[:, 0]))
    tt = Triangles(_tv(tp[:, 0]), _tv(tp[:, 1] - tp[:, 0]),
                   _tv(tp[:, 2] - tp[:, 0]), *([None] * 7),
                   area=torch.ones(t), mat_id=None, light_id=None)
    n = 256
    o = g.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jb, jt, tb, tt, o, d


@pytest.mark.parametrize("case", ["closest-big", "closest-ideal", "any"])
def test_traverse_treelet_matches_oracle_and_jax(soup, case):
    jb, jt, tb, tt, o, d = soup
    n = o.shape[0]
    ref = tint.closest_hit_brute(tt, _tv(o), _tv(d))
    if case == "any":
        mt = np.full(n, 2.5, np.float32)
        want = tint.any_hit_brute(tt, _tv(o), _tv(d), torch.from_numpy(mt))
        got = ttl.any_hit_treelet(tb, tt, _tv(o), _tv(d),
                                  torch.from_numpy(mt))
        assert torch.equal(got, want) and 0.0 < got.float().mean() < 1.0
        jocc = jtl.any_hit_treelet(jb, jt, _jv(o), _jv(d), jnp.asarray(mt),
                                   interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jocc))
        # an empty batch goes through every stage
        e = torch.zeros(0)
        h = ttl.traverse_treelet(tb, tt, V3(e, e, e), V3(e, e, e), e)
        assert h.t.shape == h.tri.shape == (0,)
        return
    seed = (np.full(n, tint.BIG_T, np.float32) if case == "closest-big"
            else np.minimum(ref.t.numpy(), 1e30))
    radius = np.where(seed > 0, seed * np.float32(1.0001)
                      + np.float32(1e-5), -1.0).astype(np.float32)
    over = ttl.candidates(tb, _tv(o), _tv(d), torch.from_numpy(radius))[1]
    if case == "closest-big":
        assert over.any()
    h = ttl.closest_hit_treelet(tb, tt, _tv(o), _tv(d),
                                torch.from_numpy(seed))
    assert torch.equal(h.tri, ref.tri) and (h.tri >= 0).float().mean() > 0.05
    np.testing.assert_allclose(np.minimum(h.t.numpy(), 1e30),
                               np.minimum(ref.t.numpy(), 1e30), rtol=1e-6)
    hit = h.tri >= 0
    for a, b in ((h.u, ref.u), (h.v, ref.v)):
        np.testing.assert_allclose(a[hit].numpy(), b[hit].numpy(),
                                   rtol=1e-5, atol=1e-6)
    # misses keep the seed
    np.testing.assert_array_equal(h.t.numpy()[~hit.numpy()],
                                  seed[~hit.numpy()])
    hj = jtl.traverse_treelet(jb, jt, _jv(o), _jv(d), jnp.asarray(seed),
                              interpret=True)
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(hj.t), rtol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True],
                         ids=["closest_hit", "occluded"])
def test_dispatch_takes_treelet_route(scenes, rays, any_hit, monkeypatch):
    """With treelets attached, `closest_hit` / `occluded` take the route
    (proxy pre-pass, pairs, fallback) ahead of the packet route, with
    and without `presorted`, and agree with the packet route."""
    _, ts = scenes
    o, d, dead, radius = rays
    tsc = ts._replace(bvh=ttl.attach_treelets(ts.bvh, t_max=32, g_child=6))
    max_t = torch.from_numpy(np.where(dead, -1.0, 1.5).astype(np.float32))
    active = torch.from_numpy(~dead)

    def call(scene, presorted):
        if any_hit:
            return tint.occluded(scene, _tv(o), _tv(d), max_t,
                                 presorted=presorted)
        return tint.closest_hit(scene, _tv(o), _tv(d), active,
                                presorted=presorted)

    want = call(ts, False)
    before = tint.treelet_calls
    seen = []
    real = ttl.traverse_treelet
    monkeypatch.setattr(ttl, "traverse_treelet",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    for presorted in (False, True):
        got = call(tsc, presorted)
        if any_hit:
            assert (got == want).float().mean() >= 0.999
            assert not got.numpy()[dead].any() and got.any()
        else:
            assert (got.tri == want.tri).float().mean() >= 0.999
            assert not (got.tri.numpy()[dead] >= 0).any()
            np.testing.assert_array_equal(
                got.t.numpy()[got.tri.numpy() < 0], np.float32(tint.BIG_T))
    assert tint.treelet_calls == before + 2 and len(seen) == 2
    assert tint.stackless_calls == 0


def test_treelet_render_matches_jax(spheres_dir, scenes):
    """The spheres scene at 32x32, 2 spp with treelets attached: every
    intersection takes the treelet route (plain versions here, no
    kernel launches), and the image agrees with the JAX CPU render."""
    _, ts = scenes
    tsc = ts._replace(bvh=ttl.attach_treelets(ts.bvh))
    before = (tint.treelet_calls, ttl.launches, dict(tbk.launches),
              mt_kernel.launches)
    got = film_mod.to_hdr(render(tsc, RenderConfig(**SPHERES),
                                 spp=2)).numpy()
    assert tint.treelet_calls > before[0]
    assert (ttl.launches, dict(tbk.launches), mt_kernel.launches) == \
        before[1:]
    want = np.asarray(jfilm.to_hdr(jrender(jload(spheres_dir),
                                           JConfig(**SPHERES), spp=2)))
    assert got.shape == want.shape == (32, 32, 3)
    assert np.isfinite(got).all() and 0.03 < got.mean() < 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean())


# --------------------------------------------------------------------------
# the CUDA kernel's partition, modelled in torch

SIGN = -0x80000000      # the sign bit of an int32 view of a float32


def _cu_const(name):
    """An integer constant of csrc/treelet_kernel.cu."""
    src = (pathlib.Path(ttl.__file__).resolve().parent.parent / "csrc"
           / "treelet_kernel.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _pair_model(consts, feats, tid):
    """pair_test_kernel's partition in torch -> (t, col).  A block is
    32 * kWarps consecutive pairs, one a thread.  A run starts at a pair
    of a treelet in [0, K) whose predecessor in the block has another id;
    a pair lies in the run that started last (-1: no pair).  The block
    takes its runs kWindow at a time: the window's tiles are brought in
    on one barrier, whose phase each window flips, and a pair of a run in
    the window is tested against that run's tile, and no other.  The sums
    take the features as they are (the kernel negates the sums, not the
    features), |det| is the sum's magnitude and det's sign reaches u, v
    and t as a flip of their sign bits; columns are folded four at a time
    in ascending order with a strict `<`."""
    k_all = consts.shape[0] // 16
    tab = consts.view(k_all, 16, ttl.T_LEAF)
    n = tid.shape[0]
    threads, window = 32 * _cu_const("kWarps"), _cu_const("kWindow")
    t_out = torch.full((n,), ttl.INF)
    col_out = torch.full((n,), -1, dtype=torch.int32)
    for base in range(0, n, threads):
        ids = tid[base:base + threads].long()
        k = torch.where((ids >= 0) & (ids < k_all), ids, -1)
        prev = torch.cat([ids[:1] + 1, ids[:-1]])     # the first always starts
        start = (k >= 0) & (prev != k)
        run = torch.where(k >= 0, torch.cumsum(start.int(), 0) - 1, -1)
        run_tid = k[start]
        assert (k[run >= 0] == run_tid[run[run >= 0]]).all()
        f = feats[base:base + threads]
        tmin = torch.full((ids.shape[0],), ttl.INF)
        col = torch.full((ids.shape[0],), -1, dtype=torch.int32)
        phase = 0
        for w0 in range(0, run_tid.shape[0], window):
            tiles = tab[run_tid[w0:w0 + window]]        # the bulk copies
            phase ^= 1
            assert phase != (w0 // window) & 1          # the wait passes
            sel = (run >= w0) & (run < w0 + window)
            r = tiles[run[sel] - w0].unbind(1)          # 16 x (m, 128)
            dx, dy, dz, ox, oy, oz, gx, gy, gz = (
                f[sel, i:i + 1] for i in range(9))
            radius = f[sel, 10:11]
            su = (gx * r[6] + gy * r[7] + gz * r[8]
                  + dx * r[12] + dy * r[13] + dz * r[14])
            sv = (gx * r[3] + gy * r[4] + gz * r[5]
                  + dx * r[9] + dy * r[10] + dz * r[11])
            sd = dx * r[0] + dy * r[1] + dz * r[2]
            st = ox * r[0] + oy * r[1] + oz * r[2] - r[15]
            # the sign of det = -sd folded in by flipping sign bits
            sd_sign = sd.view(torch.int32) & SIGN
            flip = sd_sign ^ SIGN
            ad = sd.abs()
            u = (su.view(torch.int32) ^ flip).view(torch.float32)
            v = (sv.view(torch.int32) ^ sd_sign).view(torch.float32)
            tt = (st.view(torch.int32) ^ flip).view(torch.float32)
            hit = ((ad >= tint.DET_EPS) & (u >= 0.0) & (v >= 0.0)
                   & (u + v <= ad) & (tt > 0.0) & (tt < radius * ad))
            cand = torch.where(hit, tt / torch.where(hit, ad, 1.0),
                               float("inf"))
            best, c_best = tmin[sel], col[sel]
            for c in range(0, ttl.T_LEAF, 4):
                g = cand[:, c:c + 4]
                for e in range(4):
                    better = g[:, e] < best
                    best = torch.where(better, g[:, e], best)
                    c_best = torch.where(better, c + e, c_best).int()
            tmin[sel], col[sel] = best, c_best
        t_out[base:base + threads] = tmin
        col_out[base:base + threads] = torch.where(tmin < ttl.INF, col, -1)
    return t_out, col_out


@pytest.mark.parametrize("pattern", PAIR_PATTERNS)
@pytest.mark.parametrize("p", [1, 3, 127, 128, 129, 511, 512, 513, 4099])
def test_pair_partition_model_equals_plain(p, pattern):
    """One treelet for all pairs, a new one every pair (more runs than the
    window holds), runs of 1 to 5, ids out of range at the tail and in the
    middle, equal t at several columns; P around the block's 128 pairs
    and far above: the model equals `pair_test_plain` bit for bit."""
    if pattern == "each" and p > 513:
        p = 1029                      # 1029 runs: enough windows, less time
    consts, feats, tid = (torch.from_numpy(a)
                          for a in pair_case(p, pattern))
    want_t, want_col = ttl.pair_test_plain(consts, feats, tid)
    got_t, got_col = _pair_model(consts, feats, tid)
    assert torch.equal(got_t, want_t) and torch.equal(got_col, want_col)
    valid = (tid >= 0) & (tid < consts.shape[0] // 16)
    assert (got_col[~valid] == -1).all()
    assert (got_t[~valid] == np.float32(ttl.INF)).all()
    if p >= 127:
        assert 0.3 < (got_t[valid] < ttl.INF).float().mean() <= 1.0
    if pattern == "equal_t" and p >= 127:
        # columns 9, 70, 71 repeat column 5's triangle: the first is kept
        assert (got_col == 5).any()
        assert not ((got_col == 9) | (got_col == 70) | (got_col == 71)).any()
    if pattern.startswith("sentinel"):
        assert (~valid).any()
