"""Card-only checks of the port, marked `cuda`: they skip where
torch.cuda.is_available() is false.  This file imports no JAX, so it
runs on a machine with a GPU and no JAX, with the repository's JAX
conftest switched off:

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_cuda.py

The MT kernel is held to its plain torch version bit for bit (t, tri, u,
v; closest-hit and any-hit) at the shapes the render gives it and at the
edges of its partition (1 to 2^20 + 77 rays around a block's 128; 1 to
4096 triangles around a tile's rows and the ring's refill; 10% dead
lanes, none of which may hit).  The binary BVH kernel is held to its
plain version bit for bit on the 5,156-triangle spheres scene
(closest-hit, any-hit over constant-form leaves and over raw ones) on
the batches its schedule could break: 100,003 rays with 10% dead lanes,
1 ray, 33 rays, 2^16 + 77 rays with half the lanes dead, and rays that
all miss the scene's box.
The 4-wide BVH kernel is held to its plain version bit for bit on the
same batches, and launched back to back on a side stream.  The
treelet pair-test kernel (the pairs of the treelet route on the same
rays; synthetic pairs at the edges of its partition: one treelet for
all, a new one every pair, runs of 1 to 5, ids out of range at the tail
and in the middle, equal t at several columns; launches back to back on
a side stream) is held to its plain version bit for bit.  Renders
on "cuda" (the cornell box, and the spheres scene through the BVH and the
wavefront integrator, by the packet route and by the treelet route) are
held against the same renders on "cpu" per pixel: >= 99% of pixels
within rtol 1e-3 / atol 1e-5, means within 0.5%.  Every kernel of the
matrix-unit probes (ops/visit.py) is held to its plain version: the
fp32 visits, the fp32 dot and the relayout bit for bit, the TF32 visit
and dot within visit.TF32_KERNEL_BOUND of the sum of the products'
magnitudes; the fp32 min visit also at the shapes its partition could
break (TT 32 to 512, 0 to 64 visits, 1 and 64 tiles, 128 and 4096 rays)
and launched back to back on a side stream; the lane visit at 0 to 64
visits, 1 and 64 tiles, 128 and 4096 rays, 1 and 8 blocks; the MT visit
(bit for bit) and the TF32 visit at TT 32 to 512, 0 to 64 visits, 1 and
64 tiles, 128 and 4096 rays; first8 (bit for bit) at TT 32 to 512, 0 to
160 visits, 1, 7, 64 and 128 tiles (up to 16 visits a warp, one a slot,
and its ring refilled), 128 and 4096 rays, 1 and 8 blocks, and launched back to back
on a side stream; both dots at TT 16, 48, 128 and 512 and R 128, 4096
and 65536, the TF32 dot also back to back on a side stream; a refused launch raises and
leaves no error behind; a launch with the tensors' device already
current, or on a side stream, stays correct; binary walks back to back
share one ray counter; a cornell pass hands B1 12 x pixels
rays (mt_kernel.rays).  The transpose kernel of the shading path's
row gathers (ops/gather.py) is held to the float64 sum within an ulp, to
its numpy model (tests/gather_model.py) bit for bit, and to its plain
version within the float32 sum-order bound, the same bits in two
launches, on 1 to 2048 rows, 1 to 3 columns, 0 to 2^18 + 77
indices (random, in runs, all one row, negative int32), its refusals
raise, and a cornell gradient through it at 128x128 is held to plain
indexing's within 1e-6; a gather of a table past the kernel's (a BVH
scene's tri_p0) counts its indices in gather.plain_grad_rows.  The relayout kernel is also held bit for bit at
one block of 32 rows, odd block counts and past one wave of its grid,
on values >= 2^25 and fractions.  B2 and B3 are also held bit for bit
on the 327,716-triangle tree (2^20 + 77 rays, a pass's launches), B4
on a treelet pass's launches there, and
the wavefront, the scan and the treelet route agree there.  Gradients
(with and without the boundary term, the sky's env_data) on the card
are held to the CPU's by `_grads_close`; a train step's gates (kernels
in the forward only, G1 launched, descent) on both integrators.  The
sky scene (envmap lighting) and every integrator of
`dispatch.render_with`, on the cornell box and the spheres scene, are
held to the CPU at 32x32 as the renders are, with every launch of their
passes, the adaptive one too (and its draws' tiles); so are the
denoiser, the probes' visit runs and the command line (cli.main on the
card: adaptive, a resume with -denoise, -keys).  parallel/ on the card:
render_sharded over NCCL with one rank; two gloo ranks sharing cuda:0
(tests/torch_dist.py) at 128x128, render_sharded on both scenes, the
overlapped and barriered gradients, a scene-sharded render,
adaptive_render(mesh=), light_trace_pass(mesh=) and train_step_overlap
held to one-process results, and traverse_sharded over the scene sharded
between them held to the replicated walk on the card and on the CPU;
render_elastic's command-line
workers on the card, one killed and resumed bit for bit."""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from raytracingrenderer_tpu_torch.config import MAX_VPL, RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import intersect
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.ops import (bvh_kernel, gather, mt_kernel,
                                             treelet, visit)
from raytracingrenderer_tpu_torch.ops.launch import launch
from raytracingrenderer_tpu_torch.probes import inputs, visit_args
from raytracingrenderer_tpu_torch.probes.bench_visit import visit_runs
from raytracingrenderer_tpu_torch.render import render
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from gather_model import transpose_model
from torch_scenes import (PAIR_PATTERNS, pair_case, write_cornell,
                          write_spheres)

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

N_RAYS = 100_003


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc "
                    "(torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_cornell(str(tmp_path_factory.mktemp("cornell")), 32, 32)


@pytest.fixture(scope="module")
def spheres_dir(tmp_path_factory):
    return write_spheres(str(tmp_path_factory.mktemp("spheres")), 32, 32,
                         subdiv=2)


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """The spheres scene at BVH scale (327,716 triangles, a tree of depth
    20) at 128x128, loaded on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return load_scene(write_spheres(str(tmp_path_factory.mktemp("big")),
                                    128, 128, subdiv=5), "cuda")


def _v3(a, dev):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev)
                for i in range(3)))


def _tris(n_tri, scene_dir, dev):
    tris = load_scene(scene_dir, dev).triangles
    if n_tri == tris.count:
        return tris
    g = np.random.default_rng(n_tri)
    p0 = (g.uniform(-1, 1, (n_tri, 3)) + [0, 1, 0]).astype(np.float32)
    e1, e2 = ((g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32)
              for _ in range(2))
    return tris._replace(p0=_v3(p0, dev), e1=_v3(e1, dev), e2=_v3(e2, dev),
                         area=torch.ones(n_tri, device=dev))


def _rays(dev, seed):
    g = np.random.default_rng(seed)
    o = (g.uniform(-1, 1, (N_RAYS, 3)) * 0.5 + [0, 1, 0.5]).astype(
        np.float32)
    d = g.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = g.random(N_RAYS) < 0.1
    t0 = np.where(dead, -1.0, 3.4e38).astype(np.float32)
    max_t = np.where(dead, -1.0, g.uniform(0.05, 2.5, N_RAYS)).astype(
        np.float32)
    return (_v3(o, dev), _v3(d, dev), torch.from_numpy(t0).to(dev),
            torch.from_numpy(max_t).to(dev), dead)


def _render(scene_dir, dev, treelets=False):
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4)
    scene = load_scene(scene_dir, dev)
    if treelets:
        scene = scene._replace(bvh=treelet.attach_treelets(scene.bvh))
    return film_mod.to_hdr(render(scene, cfg, spp=2)).cpu().numpy()


def _agree(a, b, frac=0.99):
    assert np.isfinite(a).all()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= frac, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


def _rays_n(dev, n, seed):
    """n rays from inside the box, a tenth of them dead -> (o, d, closest-
    hit radii, any-hit radii, the dead lanes)."""
    g = np.random.default_rng([seed, n])
    o = (g.uniform(-1, 1, (n, 3)) * 0.5 + [0, 1, 0.5]).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = g.random(n) < 0.1
    t0 = np.where(dead, -1.0, 3.4e38).astype(np.float32)
    max_t = np.where(dead, -1.0, g.uniform(0.05, 2.5, n)).astype(np.float32)
    return (_v3(o, dev), _v3(d, dev), torch.from_numpy(t0).to(dev),
            torch.from_numpy(max_t).to(dev), dead)


@pytest.mark.parametrize("n_tri", [1, 36, 128, 511, 512, 513, 4096])
@pytest.mark.parametrize("n", [1, 3, 127, 128, 129, 1000, 1 << 17,
                               (1 << 20) + 77])
def test_mt_kernel_matches_plain(cuda, scene_dir, n, n_tri):
    """Bit for bit (t, tri, u, v; closest-hit and any-hit), at widths
    around a block's 128 rays and triangle counts around a tile's rows
    and the ring's refill, with dead lanes."""
    tris = _tris(n_tri, scene_dir, cuda)
    ov, dv, tv, mv, dead = _rays_n(cuda, n, 13)
    before = mt_kernel.launches
    hk = mt_kernel.intersect(tris, ov, dv, tv)
    ak = mt_kernel.intersect(tris, ov, dv, mv)
    torch.cuda.synchronize()
    assert mt_kernel.launches == before + 2
    hp = mt_kernel.intersect_plain(tris, ov, dv, tv)
    ap = mt_kernel.intersect_plain(tris, ov, dv, mv)
    for got, want in ((hk, hp), (ak, ap)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (got.tri.cpu().numpy()[dead] == -1).all()
    assert torch.equal(mt_kernel.any_hit(tris, ov, dv, mv), ap.tri >= 0)
    if n >= 1000 and n_tri >= 36:
        assert (hk.tri >= 0).float().mean().item() > 0.3


def test_render_cuda_matches_cpu(cuda, scene_dir):
    assert load_scene(scene_dir, cuda).triangles.count == 36
    before = mt_kernel.launches
    a = _render(scene_dir, cuda)
    assert mt_kernel.launches - before == 2 * 6 * 2   # spp x bounces x 2
    _agree(a, _render(scene_dir, "cpu"))


def test_rays_counted_where_launched(cuda, scene_dir):
    """One cornell pass hands B1 every lane of the batch 12 times (6
    closest-hit and 6 shadow batches, dead lanes included): mt_kernel.rays
    rises by 12 x pixels; counting() sees 6 bounces of every lane."""
    from raytracingrenderer_tpu_torch.utils import profiling
    scene = load_scene(scene_dir, cuda)
    before = mt_kernel.rays
    with profiling.counting() as c:
        render(scene, RenderConfig(mis=True, jitter=True, max_depth=4),
               spp=1)
    assert mt_kernel.rays - before == 12 * 32 * 32
    assert c["lanes"] == 6 * 32 * 32 and 0 < c["live"] <= c["lanes"]


def _b2_batch(dev, case):
    """(o, d, t_closest, t_any, dead) of one batch of the binary walk's
    cases."""
    o, d, t0, max_t, dead = _rays(dev, 17)
    if case == "miss":
        # from outside the scene's box, pointing away from it
        g = np.random.default_rng(43)
        o = _v3((g.uniform(-1, 1, (N_RAYS, 3)) + [50, 50, 50]).astype(
            np.float32), dev)
        d = g.uniform(0.1, 1, (N_RAYS, 3)).astype(np.float32)
        d = _v3(d / np.linalg.norm(d, axis=1, keepdims=True), dev)
        return o, d, t0, max_t, dead
    n = {"full": N_RAYS, "one": 1, "33": 33, "half_dead": (1 << 16) + 77}[
        case]
    o, d = (V3(*(c[:n].contiguous() for c in v)) for v in (o, d))
    t0, max_t, dead = t0[:n].clone(), max_t[:n].clone(), dead[:n].copy()
    if case == "half_dead":
        dead = np.random.default_rng(47).random(n) < 0.5
        kill = torch.from_numpy(dead).to(dev)
        t0[kill] = -1.0
        max_t[kill] = -1.0
    return o, d, t0, max_t, dead


@pytest.mark.parametrize("case", ["full", "one", "33", "half_dead", "miss"])
@pytest.mark.parametrize("any_hit,leaf16", [(False, None), (True, None),
                                            (True, False)],
                         ids=["False", "True", "True-raw-leaves"])
def test_bvh_kernel_matches_plain(cuda, spheres_dir, any_hit, leaf16, case):
    scene = load_scene(spheres_dir, cuda)
    o, d, t0, max_t, dead = _b2_batch(cuda, case)
    t_init = max_t if any_hit else t0
    before = dict(bvh_kernel.launches)
    rays = dict(bvh_kernel.rays)
    hk = bvh_kernel.traverse_packet(scene.bvh, scene.triangles, o, d,
                                    t_init, any_hit=any_hit, leaf16=leaf16)
    torch.cuda.synchronize()
    key = "any_hit" if any_hit else "closest_hit"
    assert bvh_kernel.launches[key] == before[key] + 1
    assert bvh_kernel.rays[key] == rays[key] + o.x.shape[0]
    hp = bvh_kernel.traverse_plain(scene.bvh, scene.triangles, o, d,
                                   t_init, any_hit=any_hit, leaf16=leaf16)
    for k, p in zip(hk, hp):
        assert torch.equal(k, p)
    tk = hk.tri.cpu().numpy()
    assert not (tk[dead] >= 0).any()
    if case == "full":
        assert 0.1 < (tk >= 0).mean()
    if case == "miss":
        assert not (tk >= 0).any()
        assert torch.equal(hk.t, t_init)


def test_spheres_render_cuda_matches_cpu(cuda, spheres_dir):
    """The BVH leg on the card: both B2 variants and the B1 proxy
    pre-pass launch, the stackless walk never runs."""
    before = (dict(bvh_kernel.launches), mt_kernel.launches,
              intersect.stackless_calls)
    a = _render(spheres_dir, cuda)
    assert all(bvh_kernel.launches[k] > before[0][k]
               for k in ("closest_hit", "any_hit"))
    assert mt_kernel.launches > before[1]
    assert intersect.stackless_calls == before[2]
    _agree(a, _render(spheres_dir, "cpu"))


@pytest.mark.parametrize("wide", [False, True], ids=["B2", "B3"])
def test_bvh_scale_walks_match_plain(cuda, big, wide):
    """B2 (B3) on the 327,716-triangle tree bit for bit, no dead lane
    hitting: 2^20 + 77 rays, 10% dead, closest- and any-hit (B2 over both
    leaf forms); and the launches of both variants in a 128x128 pass
    (probes.capture_pass; B3 all but the primary one, as bench_b2)."""
    from raytracingrenderer_tpu_torch.probes import capture_pass
    bvh, tris = big.bvh, big.triangles
    assert tris.count == 327_716 and bvh.wsel is not None
    assert bvh_kernel.wide_ok(bvh) and bvh_kernel.usable(bvh)
    o, d, t0, max_t, _ = _rays_n(cuda, (1 << 20) + 77, 4)
    kept = []

    def keep(bvh, tris, o, d, t_init, any_hit=False, **kw):
        kept.append((any_hit, V3(*(c.clone() for c in o)),
                     V3(*(c.clone() for c in d)), t_init.clone()))

    capture_pass(big, [(bvh_kernel, "traverse_packet", keep)], mis=True,
                 jitter=True, max_depth=4)
    assert {a for a, *_ in kept} == {False, True}
    if wide:
        kept = [b for b in kept if b[0]] + [b for b in kept if not b[0]][1:]
    for i, (any_hit, o, d, t_init) in enumerate(
            [(False, o, d, t0), (True, o, d, max_t)] + kept):
        key = ("wide_" if wide else "") + ("any_hit" if any_hit
                                          else "closest_hit")
        for leaf16 in ((None, False) if any_hit and not wide else (None,)):
            before = bvh_kernel.launches[key]
            hk = bvh_kernel.traverse_packet(bvh, tris, o, d, t_init,
                                            any_hit=any_hit, leaf16=leaf16,
                                            wide=wide)
            torch.cuda.synchronize()
            assert bvh_kernel.launches[key] == before + 1
            hp = bvh_kernel.traverse_plain(bvh, tris, o, d, t_init,
                                           any_hit=any_hit, leaf16=leaf16,
                                           wide=wide)
            for k, p in zip(hk, hp):
                assert torch.equal(k, p), (i, key, leaf16)
            assert not bool((hk.tri[t_init < 0] >= 0).any())
            if i < 2:
                assert (hk.tri >= 0).float().mean().item() > 0.1


def test_bvh_scale_routes_agree(cuda, big, monkeypatch):
    """The 327,716-triangle scene at 128x128, 2 spp, by the wavefront,
    the scan and the treelet route (B4 too), each with B1 and both B2
    variants launched and no stackless walk, a plausible image, the scan's
    and the treelet route's held to the wavefront's by the render bar;
    every B4 launch of the treelet route bit for bit with pair_test_plain
    on its inputs."""
    from raytracingrenderer_tpu_torch.render import _use_wavefront
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4)
    assert _use_wavefront(big, cfg)
    routes = (("wavefront", big, cfg),
              ("scan", big, dataclasses.replace(cfg, wavefront=False)),
              ("treelet", big._replace(bvh=treelet.attach_treelets(big.bvh)),
               cfg))
    real, pairs = treelet.pair_test, []

    def pair_test(consts, feats, tid):
        got = real(consts, feats, tid)
        pairs.append(all(map(torch.equal, got, treelet.pair_test_plain(
            consts, feats, tid))))
        return got

    monkeypatch.setattr(treelet, "pair_test", pair_test)
    imgs = {}
    for route, sc, c in routes:
        before = (_launches(), treelet.launches, intersect.treelet_calls,
                  intersect.stackless_calls)
        img = film_mod.to_hdr(render(sc, c, spp=2)).cpu().numpy()
        assert min(_launches(before[0])) > 0, route
        assert intersect.stackless_calls == before[3]
        assert (treelet.launches > before[1]) == (route == "treelet")
        assert (intersect.treelet_calls > before[2]) == (route == "treelet")
        assert img.shape == (128, 128, 3) and 0.03 < img.mean() < 0.5
        imgs[route] = img
    assert pairs and all(pairs)
    _agree(imgs["scan"], imgs["wavefront"])
    _agree(imgs["treelet"], imgs["wavefront"])


@pytest.mark.parametrize("case", ["full", "one", "33", "half_dead", "miss"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_kernel_matches_plain(cuda, spheres_dir, any_hit, case):
    """The 4-wide walk on the binary walk's batches: bit for bit (t, tri,
    u, v), no dead lane hits, a miss keeps its seed."""
    scene = load_scene(spheres_dir, cuda)
    o, d, t0, max_t, dead = _b2_batch(cuda, case)
    t_init = max_t if any_hit else t0
    key = "wide_any_hit" if any_hit else "wide_closest_hit"
    before = bvh_kernel.launches[key]
    hk = bvh_kernel.traverse_packet(scene.bvh, scene.triangles, o, d,
                                    t_init, any_hit=any_hit, wide=True)
    torch.cuda.synchronize()
    assert bvh_kernel.launches[key] == before + 1
    hp = bvh_kernel.traverse_plain(scene.bvh, scene.triangles, o, d,
                                   t_init, any_hit=any_hit, wide=True)
    for k, p in zip(hk, hp):
        assert torch.equal(k, p)
    tk = hk.tri.cpu().numpy()
    assert not (tk[dead] >= 0).any()
    if case == "full":
        assert 0.1 < (tk >= 0).mean()
    if case == "miss":
        assert not (tk >= 0).any()
        assert torch.equal(hk.t, t_init)


def test_wide_kernel_back_to_back_on_a_side_stream(cuda, spheres_dir):
    """Launches of the 4-wide walk back to back on a stream that is not
    the default one, of different widths and variants, beside binary
    walks: the stream's one ray counter is zeroed by each launcher, so
    every result equals the plain version bit for bit."""
    scene = load_scene(spheres_dir, cuda)
    runs = []
    for case, any_hit, wide in (("full", False, True), ("33", True, True),
                                ("half_dead", False, False),
                                ("one", True, True), ("full", True, True),
                                ("miss", False, True)):
        o, d, t0, max_t, _ = _b2_batch(cuda, case)
        runs.append((o, d, max_t if any_hit else t0, any_hit, wide))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(2):
        with torch.cuda.stream(side):
            got = [bvh_kernel.traverse_packet(scene.bvh, scene.triangles, o,
                                              d, t, any_hit=a, wide=w)
                   for o, d, t, a, w in runs]
        side.synchronize()
        for (o, d, t, a, w), hk in zip(runs, got):
            hp = bvh_kernel.traverse_plain(scene.bvh, scene.triangles, o, d,
                                           t, any_hit=a, wide=w)
            for x, y in zip(hk, hp):
                assert torch.equal(x, y)


def test_pair_kernel_matches_plain(cuda, spheres_dir):
    scene = load_scene(spheres_dir, cuda)
    bvh = treelet.attach_treelets(scene.bvh)
    o, d, t0, _, _ = _rays(cuda, 23)
    slots, _ = treelet.candidates(bvh, o, d, torch.clamp(t0, max=1e30))
    tid, pidx = torch.sort(torch.where(slots >= 0, slots,
                                       treelet.SENTINEL).reshape(-1),
                           stable=True)
    n_pairs = int((slots >= 0).sum())
    tid = tid[:n_pairs].int().contiguous()
    feats = treelet._feats(o, d, torch.clamp(t0, max=1e30))[
        pidx[:n_pairs] // treelet.M_SLOTS].contiguous()
    consts = treelet.pack_constants(bvh, scene.triangles)
    before = (treelet.launches, treelet.pairs)
    tk, ck = treelet.pair_test(consts, feats, tid)
    torch.cuda.synchronize()
    assert (treelet.launches, treelet.pairs) == (before[0] + 1,
                                                 before[1] + n_pairs)
    tp, cp = treelet.pair_test_plain(consts, feats, tid)
    assert torch.equal(tk, tp) and torch.equal(ck, cp)
    assert 0.05 < (tk < treelet.INF).float().mean().item() < 0.95


@pytest.mark.parametrize("pattern", PAIR_PATTERNS)
@pytest.mark.parametrize("p", [1, 3, 511, 512, 513, 4099])
def test_pair_kernel_edges(cuda, p, pattern):
    """The pair kernel where its partition could break, on synthetic
    pairs: one treelet for all, a new one every pair (more runs a block
    than its window of tiles holds), runs of 1 to 5 (warps that straddle
    runs), ids out of range at the tail and in the middle, equal t at
    several columns (the first is kept): bit for bit."""
    consts, feats, tid = (torch.from_numpy(a).to(cuda)
                          for a in pair_case(p, pattern))
    before = (treelet.launches, treelet.pairs)
    tk, ck = treelet.pair_test(consts, feats, tid)
    torch.cuda.synchronize()
    assert (treelet.launches, treelet.pairs) == (before[0] + 1,
                                                 before[1] + p)
    tp, cp = treelet.pair_test_plain(consts, feats, tid)
    assert torch.equal(tk, tp) and torch.equal(ck, cp)
    valid = (tid >= 0) & (tid < consts.shape[0] // 16)
    assert (ck[~valid] == -1).all() and (tk[~valid] == treelet.INF).all()
    if pattern == "equal_t" and p >= 511:
        assert (ck == 5).any()
        assert not ((ck == 9) | (ck == 70) | (ck == 71)).any()


def test_pair_kernel_back_to_back_on_a_side_stream(cuda):
    """Launches back to back on a stream that is not the default one, of
    different sizes and run patterns: the window's barrier lives in
    shared memory and is set up anew by each launch."""
    runs = [tuple(torch.from_numpy(a).to(cuda) for a in pair_case(p, pat))
            for p, pat in ((4099, "runs"), (513, "each"), (3, "one"),
                           (4099, "sentinel_mid"), (512, "equal_t"))]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(3):
        with torch.cuda.stream(side):
            got = [treelet.pair_test(*r) for r in runs]
        side.synchronize()
        for r, (tk, ck) in zip(runs, got):
            tp, cp = treelet.pair_test_plain(*r)
            assert torch.equal(tk, tp) and torch.equal(ck, cp)


def test_treelet_render_cuda_matches_cpu(cuda, spheres_dir):
    """The treelet route on the card: B4, B1 (proxy pre-pass) and B2
    (the overflow fallback) launch, the CPU takes the route too, and the
    image matches the CPU's."""
    before = (treelet.launches, mt_kernel.launches,
              bvh_kernel.launches["closest_hit"], intersect.treelet_calls)
    a = _render(spheres_dir, cuda, treelets=True)
    after = (treelet.launches, mt_kernel.launches,
             bvh_kernel.launches["closest_hit"], intersect.treelet_calls)
    assert all(x > y for x, y in zip(after, before))
    b = _render(spheres_dir, "cpu", treelets=True)
    assert intersect.treelet_calls > after[3]
    _agree(a, b)


def _visit_inputs(dev, n_tiles, tt, blocks, seed):
    g = np.random.default_rng(seed)
    tab = g.normal(size=(n_tiles * 16, tt)).astype(np.float32)
    feats = g.normal(size=(blocks * 16, 4096)).astype(np.float32)
    return torch.from_numpy(tab).to(dev), torch.from_numpy(feats).to(dev)


@pytest.mark.parametrize("variant", visit.VARIANTS,
                         ids=[visit.variant_name(*v) for v in visit.VARIANTS])
def test_visit_kernel_matches_plain(cuda, variant):
    tile, reduce, layout, precision = variant
    kw = dict(n_visits=16, n_tiles=16, tile=tile, reduce=reduce,
              layout=layout, precision=precision)
    tab, feats = _visit_inputs(cuda, 16, 128, 2, 29)
    name = "visit/" + visit.variant_name(*variant)
    before = visit.launches[name]
    tk, ok = visit.visit(tab, feats, **kw)
    torch.cuda.synchronize()
    assert visit.launches[name] == before + 1
    tp, op = visit.visit_plain(tab, feats, **kw)
    assert tk.shape == tp.shape == (2, 8, 4096)
    assert torch.equal(ok, op)
    if precision == "highest":
        assert torch.equal(tk, tp)
    else:
        scale = visit.visit_tf32_scale(tab, feats, n_visits=16, n_tiles=16)
        assert ((tk - tp).abs() <= visit.TF32_KERNEL_BOUND * scale).all()
        assert not torch.equal(tk, visit.visit_plain(
            tab, feats, **dict(kw, precision="highest"))[0])
    assert (tk < 3e38).float().mean().item() > 0.5


EDGE_SHAPES = [(tile, tt, n_visits, n_tiles, r)
               for tile in ("dynamic", "static", "batched8")
               for tt in (32, 96, 128, 512)
               for n_visits in (0, 1, 2, 7, 64)
               for n_tiles in (1, 64)
               for r in (128, 4096)
               if tile != "batched8" or n_tiles >= 8]


@pytest.mark.parametrize("tile,tt,n_visits,n_tiles,r", EDGE_SHAPES)
def test_visit_min_kernel_edge_shapes(cuda, tile, tt, n_visits, n_tiles, r):
    """The fp32 min visit where its partition could break: a warp's slice
    of 4, 12, 16 or 64 columns; a ring never, partly or often refilled;
    one tile visited every time; one block of rays or many."""
    g = np.random.default_rng(tt + n_visits)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt)).astype(
        np.float32)).to(cuda)
    feats = torch.from_numpy(g.normal(size=(2 * 16, r)).astype(
        np.float32)).to(cuda)
    kw = dict(n_visits=n_visits, n_tiles=n_tiles, tile=tile)
    tk, ok = visit.visit(tab, feats, **kw)
    torch.cuda.synchronize()
    tp, op = visit.visit_plain(tab, feats, **kw)
    assert torch.equal(tk, tp) and torch.equal(ok, op)


LANE_SHAPES = [(n_visits, n_tiles, r, blocks)
               for n_visits in (0, 1, 2, 7, 64) for n_tiles in (1, 64)
               for r in (128, 4096) for blocks in (1, 8)]


@pytest.mark.parametrize("n_visits,n_tiles,r,blocks", LANE_SHAPES)
def test_visit_lane_kernel_edge_shapes(cuda, n_visits, n_tiles, r, blocks):
    """The lane visit where its partition could break: a ring never,
    partly or often refilled; one tile visited every time; one block of
    rays or many; one batch of rays or eight."""
    g = np.random.default_rng(n_visits + n_tiles)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, visit.LANE_TT))
                           .astype(np.float32)).to(cuda)
    feats = torch.from_numpy(g.normal(size=(blocks * 16, r)).astype(
        np.float32)).to(cuda)
    kw = dict(n_visits=n_visits, n_tiles=n_tiles, layout="lane")
    before = visit.launches["visit/dynamic-min-lane-highest"]
    tk, ok = visit.visit(tab, feats, **kw)
    torch.cuda.synchronize()
    assert visit.launches["visit/dynamic-min-lane-highest"] == before + 1
    tp, op = visit.visit_plain(tab, feats, **kw)
    assert torch.equal(tk, tp) and torch.equal(ok, op)


MT_TF32_SHAPES = [(tt, n_visits, n_tiles, r)
                  for tt in (32, 96, 128, 512)
                  for n_visits in (0, 1, 2, 7, 64)
                  for n_tiles in (1, 64)
                  for r in (128, 4096)]


@pytest.mark.parametrize("tt,n_visits,n_tiles,r", MT_TF32_SHAPES)
def test_visit_mt_and_tf32_kernels_edge_shapes(cuda, tt, n_visits, n_tiles,
                                               r):
    """The MT visit bit for bit, and the TF32 visit within
    visit.TF32_KERNEL_BOUND, where their partitions could break: a warp
    with no group of triangles or several, a ring never, partly or often
    refilled, one tile visited every time (the TF32 visit's packed copy of
    one tile), one block of rays or many."""
    g = np.random.default_rng(tt + n_visits + n_tiles)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt)).astype(
        np.float32)).to(cuda)
    feats = torch.from_numpy(g.normal(size=(2 * 16, r)).astype(
        np.float32)).to(cuda)
    kw = dict(n_visits=n_visits, n_tiles=n_tiles)
    tk, ok = visit.visit(tab, feats, reduce="mt", **kw)
    torch.cuda.synchronize()
    tp, op = visit.visit_plain(tab, feats, reduce="mt", **kw)
    assert torch.equal(tk, tp) and torch.equal(ok, op)
    tk, ok = visit.visit(tab, feats, precision="default", **kw)
    torch.cuda.synchronize()
    tp, op = visit.visit_plain(tab, feats, precision="default", **kw)
    assert torch.equal(ok, op)
    if n_visits == 0:
        assert (tk == visit.BIG).all() and torch.equal(tk, tp)
    else:
        scale = visit.visit_tf32_scale(tab, feats, **kw)
        assert ((tk - tp).abs() <= visit.TF32_KERNEL_BOUND * scale).all()


def test_visit_min_kernel_back_to_back_on_a_side_stream(cuda):
    """Launches of the fp32 min visit back to back on a stream that is
    not the default one, of different tile modes, sizes and visit counts:
    the ring's barriers live in shared memory and are set up anew by each
    launch, so none carries a phase over to the next."""
    runs = []
    for tile, tt, n_visits, n_tiles in (
            ("dynamic", 128, 64, 64), ("dynamic", 128, 7, 64),
            ("batched8", 128, 64, 64), ("dynamic", 512, 2, 8),
            ("static", 96, 5, 8), ("dynamic", 128, 1, 1),
            ("dynamic", 128, 64, 64), ("dynamic", 32, 0, 8)):
        tab, feats = _visit_inputs(cuda, n_tiles, tt, 2, 59 + n_visits)
        runs.append((tab, feats, dict(n_visits=n_visits, n_tiles=n_tiles,
                                      tile=tile)))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(3):
        with torch.cuda.stream(side):
            got = [visit.visit(tab, feats, **kw) for tab, feats, kw in runs]
        side.synchronize()
        for (tab, feats, kw), (tk, ok) in zip(runs, got):
            tp, op = visit.visit_plain(tab, feats, **kw)
            assert torch.equal(tk, tp) and torch.equal(ok, op)


_RAYS_BLOCKS = ((128, 1), (4096, 8), (4096, 1), (128, 8))
FIRST8_SHAPES = [(tt, n_visits, n_tiles) + _RAYS_BLOCKS[i % 4]
                 for i, (tt, n_visits, n_tiles) in enumerate(
                     (tt, n_visits, n_tiles) for tt in (32, 96, 128, 512)
                     for n_visits in (0, 1, 2, 7, 64)
                     for n_tiles in (1, 7, 64))] + [
    (tt, 160, 128, r, blocks) for tt in (32, 128)
    for r, blocks in ((128, 8), (4096, 1))]


@pytest.mark.parametrize("tt,n_visits,n_tiles,r,blocks", FIRST8_SHAPES)
def test_visit_first8_kernel_edge_shapes(cuda, tt, n_visits, n_tiles, r,
                                         blocks):
    """first8 bit for bit where its partition could break: a visit group
    with no visit or some; one tile, every visit on tile 0, 64 distinct
    tiles, up to 16 visits a warp (a slot each), or (160 visits of 128
    tiles) more visits than a warp's slots, its ring refilled; one block
    of rays or many."""
    g = np.random.default_rng(tt + n_visits + n_tiles)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt)).astype(
        np.float32)).to(cuda)
    feats = torch.from_numpy(g.normal(size=(blocks * 16, r)).astype(
        np.float32)).to(cuda)
    kw = dict(n_visits=n_visits, n_tiles=n_tiles, reduce="first8")
    before = visit.launches["visit/dynamic-first8-ray-highest"]
    tk, ok = visit.visit(tab, feats, **kw)
    torch.cuda.synchronize()
    assert visit.launches["visit/dynamic-first8-ray-highest"] == before + 1
    tp, op = visit.visit_plain(tab, feats, **kw)
    assert torch.equal(tk, tp) and torch.equal(ok, op)


def test_visit_first8_kernel_back_to_back_on_a_side_stream(cuda):
    """first8 launched back to back on a side stream, runs with and
    without refills of the ring mixed: each launch sets up its warps'
    barriers anew."""
    runs = []
    for tt, n_visits, n_tiles in ((128, 64, 64), (128, 160, 128),
                                  (32, 7, 7), (512, 2, 64), (96, 0, 1),
                                  (128, 64, 64)):
        tab, feats = _visit_inputs(cuda, n_tiles, tt, 2, 61 + n_visits)
        runs.append((tab, feats, dict(n_visits=n_visits, n_tiles=n_tiles,
                                      reduce="first8")))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(3):
        with torch.cuda.stream(side):
            got = [visit.visit(tab, feats, **kw) for tab, feats, kw in runs]
        side.synchronize()
        for (tab, feats, kw), (tk, ok) in zip(runs, got):
            tp, op = visit.visit_plain(tab, feats, **kw)
            assert torch.equal(tk, tp) and torch.equal(ok, op)


def test_dot_tf32_kernel_back_to_back_on_a_side_stream(cuda):
    """The TF32 dot launched back to back on a side stream at several
    sizes, each within the bound of its plain version."""
    g = np.random.default_rng(67)
    runs = [tuple(torch.from_numpy((g.normal(size=(16, n)) * 100).astype(
        np.float32)).to(cuda) for n in (tt, r))
        for tt, r in ((128, 4096), (16, 128), (512, 65536), (48, 4096),
                      (128, 4096))]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(3):
        with torch.cuda.stream(side):
            got = [visit.dot(a, b, "default") for a, b in runs]
        side.synchronize()
        for (a, b), k in zip(runs, got):
            assert ((k - visit.dot_plain(a, b, "default")).abs()
                    <= visit.TF32_KERNEL_BOUND * visit.tf32_scale(a, b)).all()


@pytest.mark.parametrize("r", [128, 4096, 65536])
@pytest.mark.parametrize("tt", [16, 48, 128, 512])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_dot_kernel_matches_plain(cuda, precision, tt, r):
    g = np.random.default_rng(31)
    a = torch.from_numpy((g.normal(size=(16, tt)) * 100).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy((g.normal(size=(16, r)) * 100).astype(
        np.float32)).to(cuda)
    before = visit.launches["dot/" + precision]
    k = visit.dot(a, b, precision)
    torch.cuda.synchronize()
    assert visit.launches["dot/" + precision] == before + 1
    p = visit.dot_plain(a, b, precision)
    if precision == "highest":
        assert torch.equal(k, p)
    else:
        assert ((k - p).abs() <= visit.TF32_KERNEL_BOUND
                * visit.tf32_scale(a, b)).all()


@pytest.mark.parametrize("blocks", [1, 3, 64, 65, 1057, 2130])
def test_relayout_kernel_is_exact(cuda, blocks):
    """Bit for bit with the plain loop at one block of 32 rows, odd
    counts, the probe's 64 and past one wave of the kernel's grid (the
    grid stride), on normal values, values >= 2^25 (where +1.0 rounds
    away) and fractions; and on zeros, where it is x + n_iter."""
    from raytracingrenderer_tpu_torch.probes.bench_visit import relayout_input
    x = relayout_input((blocks * 32, 128), cuda, 37 + blocks)
    zeros = torch.zeros_like(x)
    before = visit.launches["relayout"]
    for n_iter in (1, 65):
        assert torch.equal(visit.relayout_loop(x, n_iter),
                           visit.relayout_loop_plain(x, n_iter))
        assert torch.equal(visit.relayout_loop(zeros, n_iter),
                           zeros + n_iter)
    assert visit.launches["relayout"] == before + 4


def test_refused_launch_raises(cuda):
    """A launch the card refuses (a tile of TT = 4096 is 256 KB, more
    shared memory than a block can have, in the ring of the min visit as
    in the MT variant's one staged tile; an unknown variant id) raises,
    and the next launch is unaffected."""
    tab, feats = _visit_inputs(cuda, 8, 4096, 1, 41)
    t = torch.empty((1, 1, 4096), device=cuda)
    o = torch.empty_like(t)
    for variant_id in (visit.VARIANTS.index(
            ("batched8", "min", "ray", "highest")), visit.VARIANTS.index(
            ("dynamic", "min", "ray", "highest")), visit.VARIANTS.index(
            ("dynamic", "mt", "ray", "highest")), 99):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(visit._library()["visit_run"], cuda,
                   variant_id, tab.data_ptr(), feats.data_ptr(), t.data_ptr(),
                   o.data_ptr(), 1, 4096, 4096, 8, 8)
    for tile in ("batched8", "dynamic"):
        with pytest.raises(ValueError, match="shared memory"):
            visit.visit(tab, feats, n_visits=8, n_tiles=8, tile=tile)
    # what the first design refused and the ring takes: 8 tiles of TT = 512
    tab, feats = _visit_inputs(cuda, 8, 512, 1, 41)
    for tile in ("batched8", "dynamic"):
        tk, _ = visit.visit(tab, feats, n_visits=8, n_tiles=8, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(tk, visit.visit_plain(tab, feats, n_visits=8,
                                                 n_tiles=8, tile=tile)[0])


def test_launch_helper_current_device(cuda, spheres_dir):
    """The launch helper with the tensors' device already current (no
    device context is entered) and on a side stream (the handle is taken
    anew each call): the results stay bit for bit the plain versions',
    each call counts one launch."""
    g = np.random.default_rng(53)
    a = torch.from_numpy(g.normal(size=(16, 128)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(g.normal(size=(16, 4096)).astype(np.float32)).to(
        cuda)
    scene = load_scene(spheres_dir, cuda)
    o, d, t0, _, _ = _b2_batch(cuda, "full")
    want_dot = visit.dot_plain(a, b, "highest")
    want_hit = bvh_kernel.traverse_plain(scene.bvh, scene.triangles, o, d,
                                         t0)
    side = torch.cuda.Stream(a.device)
    side.wait_stream(torch.cuda.current_stream(a.device))
    for stream in (torch.cuda.current_stream(a.device), side):
        before = (visit.launches["dot/highest"],
                  bvh_kernel.launches["closest_hit"])
        with torch.cuda.device(a.device), torch.cuda.stream(stream):
            assert torch.cuda.current_device() == a.device.index
            k = visit.dot(a, b, "highest")
            hk = bvh_kernel.traverse_packet(scene.bvh, scene.triangles, o,
                                            d, t0)
        stream.synchronize()
        assert (visit.launches["dot/highest"],
                bvh_kernel.launches["closest_hit"]) == (before[0] + 1,
                                                        before[1] + 1)
        assert torch.equal(k, want_dot)
        for x, y in zip(hk, want_hit):
            assert torch.equal(x, y)


def test_bvh_launches_back_to_back(cuda, spheres_dir):
    """The binary walk's ray counter is kept per stream and zeroed by the
    launcher, not allocated a launch.  Launches back to back on one
    stream, of different widths and variants, each equal the plain
    version bit for bit, and one counter serves them all."""
    scene = load_scene(spheres_dir, cuda)
    runs = []
    for case, any_hit in (("full", False), ("33", True), ("half_dead", False),
                          ("one", True), ("full", True)):
        o, d, t0, max_t, _ = _b2_batch(cuda, case)
        runs.append((o, d, max_t if any_hit else t0, any_hit))
    bvh_kernel._counters.clear()
    got = [bvh_kernel.traverse_packet(scene.bvh, scene.triangles, o, d, t,
                                      any_hit=a) for o, d, t, a in runs]
    torch.cuda.synchronize()
    assert len(bvh_kernel._counters) == 1
    for (o, d, t, a), hk in zip(runs, got):
        hp = bvh_kernel.traverse_plain(scene.bvh, scene.triangles, o, d, t,
                                       any_hit=a)
        for x, y in zip(hk, hp):
            assert torch.equal(x, y)


@pytest.mark.parametrize("which,boundary", [
    ("cornell", False), ("cornell", True), ("spheres", False),
    ("spheres", True)])
def test_train_step_on_the_card(cuda, tmp_path, spheres_dir, which,
                                boundary):
    """One train_step (lr 0.01) on the card by the scan (the cornell box
    at 256x256) and the wavefront (the spheres scene at 32x32), with and
    without the boundary term: B1 (and both B2 variants) launch in the
    forward and never inside the backward (torch.autograd.grad, watched),
    whose recompute replays the recorded hits; G1 launched, for every
    gather on the cornell box; the loss and the gradients (the step's
    parameter change over lr) are finite and the vertices moved; the
    cornell loss on the step's key lower after it, the refitted spheres'
    gradients finite."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.geometry.refit import refit
    from raytracingrenderer_tpu_torch.render import _use_wavefront
    from raytracingrenderer_tpu_torch.sampling import rng
    scene = load_scene(write_cornell(str(tmp_path), 256, 256)
                       if which == "cornell" else spheres_dir, cuda)
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4,
                       boundary_grads=boundary)
    assert _use_wavefront(scene, cfg) == (which == "spheres")
    cam = scene.camera
    target = torch.zeros((cam.height, cam.width, 3), device=cuda)
    key = rng.PRNGKey(0)
    real, inside = torch.autograd.grad, []

    def grad(*args, **kwargs):
        before = _launches()
        out = real(*args, **kwargs)
        inside.append(_launches(before))
        return out

    before = (_launches(), gather.launches, gather.plain_grad_calls)
    torch.autograd.grad = grad
    try:
        new, loss = diff.train_step(scene, target, key, cfg, lr=0.01)
    finally:
        torch.autograd.grad = real
    torch.cuda.synchronize()
    got = _launches(before[0])
    if which == "cornell":
        # 6 bounces: closest hits, shadow rays (and 2 x 4 boundary probes)
        assert got == (6 * (10 if boundary else 2), 0, 0)
        assert gather.plain_grad_calls == before[2]
    else:
        assert min(got) > 0
    assert inside == [(0, 0, 0)]
    assert gather.launches > before[1]
    assert bool(torch.isfinite(loss))
    old, _ = diff._split_scene(scene)
    now, _ = diff._split_scene(new)
    for a, b in zip(diff._leaves(old), diff._leaves(now)):
        assert b.device.type == "cuda"
        assert bool(torch.isfinite((a - b) / 0.01).all())
    assert bool((now["tri_p0"].y != old["tri_p0"].y).any())
    if which == "cornell":
        with torch.no_grad():
            after = diff.render_loss(now, new, target, key,
                                     diff._diff_cfg(cfg, new))
        assert float(after) < float(loss)
    else:
        _, g = diff.loss_and_grads(refit(new), target, rng.PRNGKey(2), cfg)
        assert all(bool(torch.isfinite(x).all()) for x in diff._leaves(g))


@pytest.mark.parametrize("which,boundary", [
    ("cornell", False), ("spheres", False), ("spheres", True),
    ("sky", False)])
def test_grads_cuda_match_cpu(cuda, tmp_path, which, boundary):
    """diff.loss_and_grads at 64x64 on the card against "cpu" by
    `_grads_close`: cornell by the scan, spheres and sky (env_data among
    the keys) by the wavefront, spheres also with the boundary (cornell's
    is test_boundary_grads_cuda_match_cpu)."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.render import _use_wavefront
    from raytracingrenderer_tpu_torch.sampling import rng
    from torch_scenes import write_sky
    d = {"cornell": lambda: write_cornell(str(tmp_path), 64, 64),
         "spheres": lambda: write_spheres(str(tmp_path), 64, 64, subdiv=2),
         "sky": lambda: write_sky(str(tmp_path), 64, 64, subdiv=2,
                                  env_h=64, env_w=128)}[which]()
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4,
                       boundary_grads=boundary)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        sc = load_scene(d, dev)
        assert _use_wavefront(sc, cfg) == (which != "cornell")
        loss, g = diff.loss_and_grads(sc, torch.zeros((64, 64, 3),
                                                      device=dev),
                                      rng.PRNGKey(3), cfg)
        got[dev.type] = (loss.item(), _grads_np(g))
    assert which != "sky" or "env_data" in got["cpu"][1]
    _grads_close(got["cuda"], got["cpu"])


def test_render_sharded_nccl_world_one(cuda, spheres_dir, tmp_path):
    """render_sharded over NCCL, this process the one rank: sample_image
    bit for bit, B1 and both B2 variants launched."""
    import datetime
    import torch.distributed as dist
    from raytracingrenderer_tpu_torch.parallel.mesh import (make_mesh,
                                                            render_sharded)
    from raytracingrenderer_tpu_torch.render import sample_image
    from raytracingrenderer_tpu_torch.sampling import rng
    scene = load_scene(spheres_dir, cuda)
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60),
        device_id=torch.device("cuda", 0))
    try:
        before = _launches()
        img = render_sharded(scene, rng.spp_key(rng.PRNGKey(0), 0), cfg,
                             make_mesh())
        assert min(_launches(before)) > 0
    finally:
        dist.destroy_process_group()
    assert torch.equal(img, sample_image(scene, rng.spp_key(rng.PRNGKey(0),
                                                            0), cfg))


def test_adaptive_draws_cuda_match_cpu(cuda):
    """adaptive._sample_pixels on the card and the CPU, same state and
    key, 16 tiles: a draw in the same tile picks the same pixel; one in
    another tile is in the next, within 4 * 2^-24 of their CDF boundary
    (the card's cumsum sums in another order)."""
    from raytracingrenderer_tpu_torch.config import TILE_SIZE as ts
    from raytracingrenderer_tpu_torch.integrators import adaptive
    from raytracingrenderer_tpu_torch.sampling import rng
    g = torch.Generator().manual_seed(5)
    four = torch.full((128, 128), 4.0)
    st = adaptive.AdaptiveState(torch.rand((128, 128, 3), generator=g),
                                four, torch.rand((128, 128), generator=g),
                                torch.rand((128, 128), generator=g), four)
    var = adaptive._tile_variance(st) + 1e-8
    cdf = torch.cumsum((var / var.sum()).reshape(-1), 0)
    n = 12_288
    for seed in range(8):
        key = rng.PRNGKey(seed)
        cx, cy = adaptive._sample_pixels(st, key, n, 128, 128)
        gx, gy = (a.cpu() for a in adaptive._sample_pixels(
            adaptive.AdaptiveState(*(a.to(cuda) for a in st)), key, n, 128,
            128))
        gt, ct = (y // ts * (128 // ts) + x // ts
                  for x, y in ((gx, gy), (cx, cy)))
        same = gt == ct
        assert torch.equal(gx[same], cx[same])
        assert torch.equal(gy[same], cy[same])
        u = (torch.arange(n, dtype=torch.float32)
             + rng.raw_uniform(key, (n,))) / n
        i = torch.nonzero(~same).flatten()
        assert bool(((gt[i] - ct[i]).abs() == 1).all())
        k = torch.minimum(gt[i], ct[i])
        assert bool(((u[i] - cdf[k]).abs() <= 4 * 2.0 ** -24).all())


@pytest.mark.parametrize("name,cfg", visit_runs(),
                         ids=[n.replace(" ", "-") for n, _ in visit_runs()])
def test_probe_runs_match_plain(cuda, name, cfg):
    """Each distinct visit run of the probes at its size (up to 512 visits
    of 512 tiles, 8 x 4096 rays): fp32 bit for bit, TF32 in its bound."""
    tab, feats = inputs(cfg["n_tiles"], cfg["tt"], cfg["blocks"], cuda)
    kw = visit_args(cfg)
    tk, ok = visit.visit(tab, feats, **kw)
    tp, op = visit.visit_plain(tab, feats, **kw)
    assert torch.equal(ok, op)
    if cfg["precision"] == "highest":
        assert torch.equal(tk, tp)
    else:
        scale = visit.visit_tf32_scale(tab, feats, **{
            k: kw[k] for k in ("n_visits", "n_tiles", "tile", "layout")})
        assert ((tk - tp).abs() <= visit.TF32_KERNEL_BOUND * scale).all()


def test_probe_entry_points_launch_every_kernel(cuda):
    """probe_mxu, 2 and 3 launch every kernel of visit_kernel.cu."""
    from raytracingrenderer_tpu_torch.probes import (probe_mxu, probe_mxu2,
                                                     probe_mxu3)
    before = dict(visit.launches)
    for mod in (probe_mxu, probe_mxu2, probe_mxu3):
        mod.main()
    assert all(visit.launches[k] > n for k, n in before.items())


GATHER_SHAPES = [(1, 1), (8, 3), (36, 1), (36, 3), (700, 2),
                 (gather.ROWS_MAX, 3)]


def _gather_case(dev, rows, k, n, pattern, seed):
    """(columns requiring grad, index, upstream gradients) on the card:
    rows drawn at random, in runs of 64 (a frame's coherent hits), all
    one row, or negative int32 indices."""
    g = np.random.default_rng(seed)
    idx = {"random": g.integers(0, rows, n),
           "runs": np.repeat(g.integers(0, rows, n // 64 + 1), 64)[:n],
           "one_row": np.full(n, rows - 1),
           "negative": g.integers(-rows, 0, n)}[pattern]
    idx = torch.from_numpy(idx.astype(
        np.int32 if pattern == "negative" else np.int64)).to(dev)
    cols = [torch.from_numpy(g.standard_normal(rows).astype(np.float32))
            .to(dev).requires_grad_(True) for _ in range(k)]
    grads = [torch.from_numpy(g.standard_normal(n).astype(np.float32))
             .to(dev) for _ in range(k)]
    return cols, idx, grads


@pytest.mark.parametrize("pattern", ["random", "runs", "one_row",
                                     "negative"])
@pytest.mark.parametrize("n", [0, 1, 33, 2049, (1 << 18) + 77])
@pytest.mark.parametrize("rows,k", GATHER_SHAPES)
def test_gather_kernel_matches_plain(cuda, rows, k, n, pattern):
    """gather_cols on the card: the forward is plain indexing bit for
    bit; the backward (one launch of csrc/gather_kernel.cu for the k
    columns, counted with its indices) is within an ulp of the float64
    sum (2^-24 of the sum, plus 2^-32 of the sum of magnitudes: a bound
    on both float64 sums' own rounding up to 2^20 terms), the same bits
    in a second launch, and within the float32 sum-order bound
    (2 (m - 1) 2^-24 sum|terms| a row of m terms) of the plain version,
    whose index_add_ sums in no fixed order on the card, and equal bit
    for bit to its numpy model
    (tests/gather_model.py: its partition and sum order, in double,
    rounded once)."""
    cols, idx, grads = _gather_case(cuda, rows, k, n, pattern,
                                    rows * 7 + k + n)
    launches, reduced = gather.launches, gather.rows
    outs = gather.gather_cols(cols, idx)
    for o, c in zip(outs, cols):
        assert torch.equal(o, c.detach()[idx])
    got = torch.stack(torch.autograd.grad(outs, cols, grads))
    torch.cuda.synchronize()
    assert (gather.launches - launches, gather.rows - reduced) == (1, n)
    assert torch.equal(got, gather.transpose_cols(grads, idx, rows))
    flat = torch.where(idx < 0, idx + rows, idx).long()
    ref = torch.stack([torch.zeros(rows, dtype=torch.float64, device=cuda)
                       .index_add_(0, flat, g.double()) for g in grads])
    mag = torch.stack([torch.zeros(rows, dtype=torch.float64, device=cuda)
                       .index_add_(0, flat, g.abs().double())
                       for g in grads])
    err = (got.double() - ref).abs()
    assert bool((err <= 2.0 ** -24 * ref.abs() + 2.0 ** -32 * mag).all())
    m = torch.bincount(flat, minlength=rows).double()
    plain = gather.transpose_plain(grads, idx, rows)
    assert bool(((got.double() - plain.double()).abs()
                 <= 2 * (m - 1).clamp(min=0) * 2.0 ** -24 * mag).all())
    assert np.array_equal(got.cpu().numpy(), transpose_model(
        [g.cpu().numpy() for g in grads], idx.cpu().numpy(), rows))


def test_gather_kernel_refuses(cuda):
    """A non-float32 column, an int16 index, a table past the kernel's
    and an index out of range raise; a launch the card refuses (0
    columns, past the launcher's own checks) raises, naming it."""
    cols, idx, grads = _gather_case(cuda, 8, 3, 1000, "random", 1)
    with pytest.raises(TypeError):
        gather.transpose_cols([g.double() for g in grads], idx, 8)
    with pytest.raises(TypeError):
        gather.transpose_cols(grads, idx.short(), 8)
    with pytest.raises(ValueError):
        gather.transpose_cols(grads, idx, gather.TABLE_MAX)
    with pytest.raises(IndexError):
        gather.transpose_cols(grads, torch.full_like(idx, 8), 8)
    with pytest.raises(IndexError):
        gather.transpose_cols(grads, torch.full_like(idx, -9), 8)
    out = torch.empty((1, 8), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(gather._library()["gather_transpose"], cuda,
               (ctypes.c_void_p * 1)(grads[0].data_ptr()), 0,
               idx.data_ptr(), 8, 1000, 8, 0, out.data_ptr())
    assert torch.equal(gather.transpose_cols(grads, idx, 8),
                       gather.transpose_cols(grads, idx, 8))


@pytest.mark.parametrize("rows,taken", [(262_156, False), (36, True)])
def test_plain_grad_rows_counted(cuda, rows, taken):
    """A gradient-carrying gather of a tri_p0-sized table, over the
    kernel's TABLE_MAX, stays on plain indexing and adds its index count
    to gather.plain_grad_rows (and one to plain_grad_calls); one of a
    table the kernel takes adds nothing to either."""
    assert (rows * 3 <= gather.TABLE_MAX) == taken
    cols, idx, _ = _gather_case(cuda, rows, 3, (1 << 18) + 77, "random",
                                rows)
    calls, plain = gather.plain_grad_calls, gather.plain_grad_rows
    outs = gather.gather_cols(cols, idx)
    for o, c in zip(outs, cols):
        assert torch.equal(o, c.detach()[idx])
    n = 0 if taken else idx.numel()
    assert gather.plain_grad_rows - plain == n
    assert gather.plain_grad_calls - calls == (0 if taken else 1)


def test_param_grads_kernel_against_plain_indexing(cuda, tmp_path,
                                                   monkeypatch):
    """diff.param_grads on the cornell box at 128x128: every
    gradient-carrying gather through the kernel (30 launches, none left
    on plain indexing) against the same with the dispatch rule patched
    to plain indexing (index_put_ as the backward): each parameter within
    a relative L2 distance of 1e-6 (the two sum each row's terms in
    other orders; the kernel's is within an ulp of the exact sum)."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.sampling import rng
    scene = load_scene(write_cornell(str(tmp_path), 128, 128), cuda)
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4, seed=11)
    target = torch.full((128, 128, 3), 0.2, device=cuda)
    launches, plain = gather.launches, gather.plain_grad_calls
    got = diff.param_grads(scene, target, rng.PRNGKey(11), cfg)
    torch.cuda.synchronize()
    assert gather.launches - launches == 30
    assert gather.plain_grad_calls == plain
    monkeypatch.setattr(gather, "takes_kernel", lambda *args: False)
    ref = diff.param_grads(scene, target, rng.PRNGKey(11), cfg)
    assert gather.launches - launches == 30
    for name in diff.param_keys(got):
        a = torch.stack(list(got[name])) if isinstance(
            got[name], tuple) else got[name]
        b = torch.stack(list(ref[name])) if isinstance(
            ref[name], tuple) else ref[name]
        norm = float(b.double().norm())
        assert float((a.double() - b.double()).norm()) <= 1e-6 * norm, name


def test_boundary_grads_cuda_match_cpu(cuda, tmp_path):
    """A cornell gradient with the boundary term at 64x64 on the card
    (B1 for the hits, the shadow rays and the boundary probes) against
    the same on "cpu" (the plain versions), same key, by `_grads_close`'s
    bars; no kernel launches inside the backward."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.sampling import rng
    d = write_cornell(str(tmp_path), 64, 64)
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4,
                       boundary_grads=True)
    got = {}
    real, inside = torch.autograd.grad, []

    def grad(*args, **kwargs):
        before = mt_kernel.launches
        out = real(*args, **kwargs)
        inside.append(mt_kernel.launches - before)
        return out

    for dev in (cuda, torch.device("cpu")):
        scene = load_scene(d, dev)
        before = mt_kernel.launches
        torch.autograd.grad = grad
        try:
            loss, g = diff.value_and_grad(
                scene, torch.zeros((64, 64, 3), device=dev),
                rng.PRNGKey(3), diff._diff_cfg(cfg, scene))
        finally:
            torch.autograd.grad = real
        if dev.type == "cuda":
            # 6 bounces: closest hits, shadow rays, 2 x 4 probes each
            assert mt_kernel.launches - before == 6 * (2 + 8)
        got[dev.type] = (loss.item(), _grads_np(g))
    assert inside == [0, 0]
    assert np.abs(got["cpu"][1]["tri_p0"]).max() > 0
    _grads_close(got["cuda"], got["cpu"])


def _grads_np(g):
    return {k: (v.stacked() if hasattr(v, "stacked") else v).cpu().numpy()
            for k, v in g.items()}


def _grads_close(got, ref):
    """(loss, {key: gradient}) against a reference's: the loss within rel
    1e-4; every gradient finite; tri_p0 within a relative L2 error of
    1e-2; every other key within rtol 1e-3 / atol 1e-3 * max|g| (a key
    with no entries, light_le of a scene lit by its sky only, skipped)."""
    (lg, gg), (lc, gc) = got, ref
    assert lg == pytest.approx(lc, rel=1e-4)
    for k, b in gc.items():
        a = gg[k]
        assert np.isfinite(a).all(), k
        if b.size and k == "tri_p0":
            assert (np.linalg.norm(a - b)
                    / max(np.linalg.norm(b), 1e-30)) <= 1e-2
        elif b.size:
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=1e-3 * np.abs(b).max(),
                                       err_msg=k)


def test_sky_render_cuda_matches_cpu(cuda, tmp_path):
    """The envmap slice on the card: the 5,122-triangle sky scene (a
    64 x 128 map, no area light, its alias table from the native
    library) at 32x32 through the wavefront, B2 and B1's pre-pass
    launched, no stackless walk, against the same render on "cpu"."""
    from torch_scenes import write_sky
    d = write_sky(str(tmp_path), 32, 32, subdiv=2, env_h=64, env_w=128)
    from raytracingrenderer_tpu_torch.geometry import bvh_native
    before = (dict(bvh_kernel.launches), mt_kernel.launches,
              intersect.stackless_calls)
    a = _render(d, cuda)
    assert all(bvh_kernel.launches[k] > before[0][k]
               for k in ("closest_hit", "any_hit"))
    assert mt_kernel.launches > before[1]
    assert intersect.stackless_calls == before[2]
    env = load_scene(d, cuda).background.envmap.data
    assert env.device.type == "cuda" and tuple(env.shape) == (64, 128, 3)
    assert hasattr(bvh_native._load(), "alias_build")
    _agree(a, _render(d, "cpu"))


def _launches(before=(0, 0, 0)):
    """(B1, B2 closest-hit, B2 any-hit) launches since `before`."""
    return tuple(n - b for n, b in zip((
        mt_kernel.launches, bvh_kernel.launches["closest_hit"],
        bvh_kernel.launches["any_hit"]), before))


# (closest-hit, any-hit) traversal calls of a render_with pass by max_depth
_CALLS = {"direct": lambda m: (1, 1), "albedo": lambda m: (1, 0),
          "normals": lambda m: (1, 0),
          "lighttrace": lambda m: (m + 1, m + 2),
          "vpl": lambda m: (m + 2, MAX_VPL * (m + 2))}


@pytest.mark.parametrize("integ", ["direct", "albedo", "normals",
                                   "lighttrace", "vpl"])
@pytest.mark.parametrize("which", ["cornell", "spheres"])
def test_render_with_cuda_matches_cpu(cuda, scene_dir, spheres_dir, which,
                                      integ):
    """integrators.dispatch.render_with on the card (B1 on the cornell
    box; B2 and B1's pre-pass on the spheres scene) against "cpu" at
    32x32, 2 spp (vpl at max_depth 2), with the kernels launched.

    vpl on the spheres is held to 98% of pixels, not 99%: a VPL that lies
    near a receiver on the same sphere adds cos cos / d^2 up to 10^4
    (d^2 just above the reference's 1e-4 cutoff), so an ulp of the
    card's rsqrt or sqrt, or the cutoff itself, moves a whole VPL's
    contribution in a few pixels (98.73% within the bar at 32x32, 99.27%
    at 128x128, on the H100); the means stay within 0.5%.

    The card's launches are every traversal call of the passes: a call
    is one B1 launch on the cornell box; on the spheres a closest-hit
    call is one B2 launch and an any-hit call a B1 pre-pass and a B2
    launch (`_CALLS`)."""
    from raytracingrenderer_tpu_torch.integrators.dispatch import \
        render_with
    d = scene_dir if which == "cornell" else spheres_dir
    cfg = RenderConfig(mis=True, jitter=True, integrator=integ,
                       max_depth=2 if integ == "vpl" else 4)
    imgs = {}
    for dev in (cuda, torch.device("cpu")):
        before = _launches()
        film = render_with(load_scene(d, dev), cfg, 2)
        imgs[dev.type] = film_mod.to_hdr(film).cpu().numpy()
        if dev.type == "cuda":
            assert film.buffer.device.type == "cuda"
            closest, any_ = (2 * n for n in _CALLS[integ](cfg.max_depth))
            assert _launches(before) == (
                (closest + any_, 0, 0) if which == "cornell"
                else (any_, closest, any_))
    _agree(imgs["cuda"], imgs["cpu"],
           0.98 if (which, integ) == ("spheres", "vpl") else 0.99)


@pytest.mark.parametrize("which", ["cornell", "spheres"])
def test_adaptive_cuda_matches_cpu(cuda, scene_dir, spheres_dir, which):
    """render_with(integrator="adaptive") on the card (B1 on the cornell
    box; B2 and B1's pre-pass on the spheres scene) against "cpu" at
    32x32, 4 spp (2 init passes, 8 rounds of 256 rays): one tile, so
    every draw is the same on both devices.  The card launches each of
    its 10 traces' traversal calls (a scan pass: max_depth + 2
    closest-hit and as many any-hit calls) as render_with's do."""
    from raytracingrenderer_tpu_torch.integrators.dispatch import \
        render_with
    d = scene_dir if which == "cornell" else spheres_dir
    cfg = RenderConfig(mis=True, jitter=True, integrator="adaptive")
    imgs, seen = {}, []
    for dev in (cuda, torch.device("cpu")):
        before = _launches()
        film = render_with(load_scene(d, dev), cfg, 4,
                           on_sample=lambda s, f: seen.append(s))
        imgs[dev.type] = film_mod.to_hdr(film).cpu().numpy()
        if dev.type == "cuda":
            assert film.buffer.device.type == "cuda"
            n = 10 * (cfg.max_depth + 2)
            assert _launches(before) == ((2 * n, 0, 0) if which == "cornell"
                                         else (n, n, n))
    assert seen == list(range(10)) * 2
    _agree(imgs["cuda"], imgs["cpu"])


def test_denoise_cuda_matches_cpu(cuda):
    from raytracingrenderer_tpu_torch.imaging.denoise import denoise
    g = np.random.default_rng(4)
    img, alb, nrm = (torch.from_numpy(g.gamma(0.7, 0.5, (96, 128, 3))
                                      .astype(np.float32)) for _ in range(3))
    for guides in ({}, {"albedo": alb, "normal": nrm}):
        got = denoise(img.to(cuda), **{k: v.to(cuda)
                                       for k, v in guides.items()})
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(),
                                   denoise(img, **guides).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_cli_on_the_card(cuda, scene_dir, tmp_path, caplog):
    """cli.main on "cuda" (the default device) at 32x32: adaptive with
    -profile and -checkpoint, its 10 traces' 120 B1 launches, the film
    checkpointed and a resume with -denoise -profile adding its spp, each
    phase report logged (the resume's with its denoise); the image held
    to the same command on "cpu"."""
    import logging
    from raytracingrenderer_tpu_torch import cli
    caplog.set_level(logging.INFO, logger="rtr")
    from raytracingrenderer_tpu_torch.io.hdr import read_hdr
    imgs = {}
    for dev in ("cuda", "cpu"):
        out, ck = str(tmp_path / f"{dev}.hdr"), str(tmp_path / f"{dev}.npz")
        args = ["-scene", scene_dir, "-outputFilename", out, "-SPP", "4",
                "-integrator", "adaptive", "-checkpoint", ck, "-profile"]
        before = mt_kernel.launches
        assert cli.main(args + (["-device", "cpu"] if dev == "cpu"
                                else [])) == 0
        if dev == "cuda":
            assert mt_kernel.launches - before == 120
            assert "phase report" in caplog.text and "render:" in caplog.text
        with np.load(ck) as z:
            assert float(z["spp"]) == 4.0
            imgs[dev] = z["buffer"] / 4.0
        assert np.isfinite(read_hdr(out)).all()
    _agree(imgs["cuda"], imgs["cpu"])
    out = str(tmp_path / "dn.hdr")
    caplog.clear()
    assert cli.main(["-scene", scene_dir, "-outputFilename", out, "-SPP",
                     "4", "-checkpoint", str(tmp_path / "cuda.npz"),
                     "-denoise", "-profile"]) == 0
    assert "denoise:" in caplog.text
    with np.load(str(tmp_path / "cuda.npz")) as z:
        assert float(z["spp"]) == 8.0
    img = read_hdr(out)
    assert np.isfinite(img).all() and img.mean() > 0.01


def test_cli_keys_on_the_card(cuda, scene_dir, tmp_path, caplog):
    """cli.main's scripted interactive session on the card (-keys
    w,left,p,l,esc -profile, the cornell box at 32x32): exit 0, the .hdr
    and the key's .png written, a finite image with a plausible mean,
    three passes' 36 B1 launches, the phase report logged."""
    import logging
    import os
    from raytracingrenderer_tpu_torch import cli
    from raytracingrenderer_tpu_torch.io.hdr import read_hdr
    caplog.set_level(logging.INFO, logger="rtr")
    out = str(tmp_path / "keys.hdr")
    before = mt_kernel.launches
    assert cli.main(["-scene", scene_dir, "-outputFilename", out, "-keys",
                     "w,left,p,l,esc", "-profile"]) == 0
    assert mt_kernel.launches - before == 36
    assert os.path.exists(out[:-4] + ".png")
    img = read_hdr(out)
    assert np.isfinite(img).all() and 0.03 < img.mean() < 0.5
    assert "phase report" in caplog.text and "render:" in caplog.text


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """2 gloo ranks on cuda:0 (tests/torch_dist.py::job_card) at 128x128,
    with what they were given; None without a card."""
    if not torch.cuda.is_available():
        return None
    from torch_dist import run
    base = tmp_path_factory.mktemp("ranks")
    dirs = dict(cornell_dir=write_cornell(str(base / "c"), 128, 128),
                spheres_dir=write_spheres(str(base / "s"), 128, 128,
                                          subdiv=2))
    o, d, _, max_t, _ = _rays_n("cpu", (1 << 20) + 77, 18)
    return dict(dirs, o=o, d=d, max_t=max_t, ranks=run(
        "card", 2, base, device="cuda:0", o=tuple(o), d=tuple(d),
        max_t=max_t, **dirs))


def test_render_sharded_on_the_card(cuda, card_ranks):
    """render_sharded on 2 gloo ranks on one card at 128x128: the same
    image on both ranks, B1 and B2 launched, each held to sample_image on
    the CPU by the render bar."""
    from raytracingrenderer_tpu_torch.render import sample_image
    from raytracingrenderer_tpu_torch.sampling import rng
    r0, r1 = card_ranks["ranks"]
    for name in ("cornell", "spheres"):
        np.testing.assert_array_equal(r0[name], r1[name])
        sc = load_scene(card_ranks[f"{name}_dir"], "cpu")
        ref = sample_image(sc, rng.PRNGKey(3), RenderConfig(
            max_depth=4, mis=True, jitter=True)).numpy()
        _agree(r0[name], ref)
    for r in (r0, r1):
        assert r["cornell_launches"][0] > 0
        assert min(r["spheres_launches"]) > 0


def test_traverse_sharded_on_the_card(cuda, card_ranks):
    """traverse_sharded over 2 ranks' shards, 2^20 + 77 rays (a tenth
    dead for the occlusion bits): the ranks agree and no dead ray is
    occluded; against the replicated walk on the card, the triangles
    (mapped by geometry) and the occlusion bits agree on >= 99.999% of
    the rays, and against the replicated walk on the CPU (the plain
    version) on >= 99.9% of the first 20,000, with t bit for bit where
    the triangles agree."""
    r0, r1 = card_ranks["ranks"]
    for a, b in zip(r0["closest"], r1["closest"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r0["occluded"], r1["occluded"])
    assert r0["traverse_launches"][1] > 0
    assert r0["occluded_launches"][0] > 0 and r0["occluded_launches"][2] > 0
    occ_s = r0["occluded"].astype(bool)
    dead = card_ranks["max_t"].numpy() <= 0
    assert dead.any() and not occ_s[dead].any()
    t_s, tri_s = r0["closest"][:2]
    assert (tri_s >= 0).mean() > 0.5
    tr = load_scene(card_ranks["spheres_dir"], "cpu").triangles
    where = {row.tobytes(): i for i, row in enumerate(np.stack(
        [c.numpy() for f in (tr.p0, tr.e1, tr.e2) for c in f], -1))}
    geom = np.concatenate([r0["geometry"], r1["geometry"]])
    to_rep = np.asarray([where.get(row.tobytes(), -1) for row in geom])
    mapped = np.where(tri_s >= 0, to_rep[np.maximum(tri_s, 0)], -1)
    for dev, n, bar in ((cuda, len(tri_s), 0.99999), ("cpu", 20_000, 0.999)):
        rep = load_scene(card_ranks["spheres_dir"], dev)
        o, d = (V3(*(c[:n].to(dev) for c in card_ranks[k]))
                for k in ("o", "d"))
        h = intersect.closest_hit(rep, o, d)
        same = mapped[:n] == h.tri.cpu().numpy()
        assert same.mean() >= bar, dev
        np.testing.assert_array_equal(t_s[:n][same], h.t.cpu().numpy()[same])
        occ = intersect.occluded(rep, o, d, card_ranks["max_t"][:n].to(dev))
        assert (occ_s[:n] == occ.cpu().numpy()).mean() >= bar, dev


def test_overlap_grads_on_the_card(cuda, card_ranks):
    """param_grads_sharded on 2 ranks at 128x128, jitter off, overlapped
    (6 reductions) and barriered (1): equal on both ranks, held by
    `_grads_close` to one process (cornell on the CPU, spheres on the
    card)."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.sampling import rng
    r0, r1 = card_ranks["ranks"]
    cfg = RenderConfig(max_depth=4, mis=True, jitter=False)
    for name, dev in (("cornell", "cpu"), ("spheres", cuda)):
        sc = load_scene(card_ranks[f"{name}_dir"], dev)
        loss, g = diff.value_and_grad(sc, torch.zeros((128, 128, 3),
                                                      device=dev),
                                      rng.PRNGKey(3), diff._diff_cfg(cfg, sc))
        for step, reductions in (("overlap", 6), ("barriered", 1)):
            got = r0[f"{name}_{step}"]
            assert got[2] == r1[f"{name}_{step}"][2] == reductions
            for k, a in got[1].items():
                np.testing.assert_array_equal(a, r1[f"{name}_{step}"][1][k])
            _grads_close(got[:2], (loss.item(), _grads_np(g)))


def test_parallel_paths_on_the_card(cuda, card_ranks):
    """The ranks' other steps launch B1 (B2 on the spheres); the
    scene-sharded render meets the replicated one; adaptive_render(mesh=)
    the same film on both ranks, 120 B1 launches; light_trace_pass(mesh=)
    within rel 1e-4 of one process; train_step_overlap descends."""
    from raytracingrenderer_tpu_torch.integrators.lighttracer import (
        light_trace_pass)
    from raytracingrenderer_tpu_torch.sampling import rng
    r0, r1 = card_ranks["ranks"]
    for r in (r0, r1):
        for step in ("sharded_render", "spheres_overlap",
                     "spheres_barriered"):
            assert min(r[f"{step}_launches"]) > 0, step
        for step in ("cornell_overlap", "cornell_barriered", "lighttrace"):
            assert r[f"{step}_launches"][0] > 0, step
        assert r["adaptive_launches"] == (120, 0, 0)
    _agree(r0["sharded_render"], r0["spheres"])
    (film, spp), (film1, _) = r0["adaptive"], r1["adaptive"]
    np.testing.assert_array_equal(film, film1)
    assert np.isfinite(film).all() and 0.03 < film.mean() / spp < 0.5
    cornell = load_scene(card_ranks["cornell_dir"], cuda)
    lt = light_trace_pass(cornell, film_mod.new_film(128, 128, cuda),
                          rng.PRNGKey(7), RenderConfig(
                              max_depth=4, mis=True, jitter=True),
                          128 * 128).buffer.cpu().numpy()
    for r in (r0, r1):
        got = r["lighttrace"]
        assert abs(got.sum() - lt.sum()) <= 1e-4 * abs(lt.sum())
        assert np.isclose(got, lt, rtol=1e-3, atol=1e-5).all(-1).mean() \
            >= 0.99
    assert r0["train_losses"][1] < r0["train_losses"][0]


def test_render_elastic_on_the_card(cuda, tmp_path):
    """render_elastic's CLI workers on the card: worker 0 killed after
    its first checkpoint and resumed equals an uninterrupted worker bit
    for bit, and a worker on the CPU by the render bar."""
    from raytracingrenderer_tpu_torch.parallel.elastic import (
        _ckpt_spp, render_elastic)
    from raytracingrenderer_tpu_torch.utils.checkpoint import load_film
    scene = write_cornell(str(tmp_path / "c"), 128, 128)
    ck0 = str(tmp_path / "run" / "worker0.npz")
    state = {"killed": False}

    def injector(procs):
        p = procs.get(0)
        if not state["killed"] and p is not None and p.poll() is None \
                and 1 <= _ckpt_spp(ck0) < 4:
            p.kill()
            state["killed"] = True

    films = {}
    for name, dev, poll in (("run", "cuda", injector), ("oracle", "cuda",
                                                        None),
                            ("cpu", "cpu", None)):
        f = render_elastic(scene, str(tmp_path / name), n_workers=1,
                           spp_per_worker=4, extra_args=["-device", dev],
                           on_poll=poll, poll_s=0.05)
        assert float(f.spp) == 4.0
        films[name] = load_film(str(tmp_path / name / "worker0.npz"),
                                "cpu").buffer.numpy()
    assert state["killed"]
    np.testing.assert_array_equal(films["run"], films["oracle"])
    _agree(films["run"] / 4.0, films["cpu"] / 4.0)
