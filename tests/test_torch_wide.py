"""The port's 4-wide BVH walk against the JAX package's, on the
5,156-triangle spheres scene (its BVH from both loaders):

- `widen`'s wsel/wcode/waxis equal the JAX loader's exactly, through the
  port's loader and through `convert.scene_from_numpy`, and for a
  single-leaf root;
- `pack_tables_wide` equals JAX's bit for bit;
- `traverse_plain(wide=True)` (the CUDA kernel's plain version) against
  the Pallas `_kernel_wide` run by `traverse_packet(..., wide=True,
  interpret=True, ray_sub=8)`, 1,037 rays from inside the box with 10%
  dead lanes: t within rtol 1e-5 / atol 1e-6, closest-hit ids equal on
  >= 99.9% of rays, any-hit bits equal, no dead lane hit;
- the wide plain walk against the binary one: closest-hit t and ids
  equal, any-hit bits equal over raw leaves and on >= 99.9% of rays
  over the binary walk's constant-form leaves (edge-grazing rays may
  round apart);
- the binary walk stays the default for every tree the loader builds,
  and `BVH.to()` keeps every optional field;
- a model of the CUDA kernel's schedule (persistent warps of 32 lanes
  refilled from a counter below 16 live rays; each lane walks wide rows
  until it holds a leaf or is done, then the warp tests every held leaf)
  equals `_walk_wide` bit for bit (t, tri, u, v) and in its visits, on
  the spheres scene and on a small tree, with `max_iters` that lets every
  walk end and ones that cut walks short;
- the launchers' C signatures in csrc/bvh_kernel.cu match `SIGNATURES`
  (the 4-wide walk takes the ray counter).

The CUDA kernel itself is checked against `traverse_plain` by
tests/test_torch_cuda.py on the card."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.geometry.bvh import build as jbuild
from raytracingrenderer_tpu.ops import bvh_kernel as jbk
from raytracingrenderer_tpu.ops import treelet as jtl
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import bvh as tbvh
from raytracingrenderer_tpu_torch.geometry import intersect as tint
from raytracingrenderer_tpu_torch.ops import bvh_kernel as tbk
from raytracingrenderer_tpu_torch.scene.convert import scene_from_numpy
from raytracingrenderer_tpu_torch.scene.loader import load_scene as tload
from raytracingrenderer_tpu_torch.scene.types import (BVH, BVH_ARRAYS,
                                                     Triangles)
from torch_scenes import write_spheres

torch.set_num_threads(2)

N = 1037
WIDE = ("wsel", "wcode", "waxis")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = write_spheres(str(tmp_path_factory.mktemp("spheres")), 32, 32, 2)
    return jload(d), tload(d, "cpu")


@pytest.fixture(scope="module")
def rays():
    g = np.random.default_rng(23)
    o = (g.uniform(-1, 1, (N, 3)) * 0.5 + [0, 1, 0.5]).astype(np.float32)
    d = g.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = g.random(N) < 0.1
    t_closest = np.where(dead, -1.0, tint.BIG_T).astype(np.float32)
    t_any = np.where(dead, -1.0, g.uniform(0.05, 2.5, N)).astype(np.float32)
    return o, d, dead, t_closest, t_any


def _jv(a):
    return JV3.from_stacked(jnp.asarray(a))


def _tv(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _assert_wide_equal(tb, jb):
    for f in WIDE:
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert got.dtype == want.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("route", ["loader", "convert"])
def test_widen_matches_jax(scenes, route):
    js, ts = scenes
    if route == "convert":
        ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    _assert_wide_equal(ts.bvh, js.bvh)
    w = ts.bvh.wsel.shape[0]
    assert ts.bvh.wcode.shape == (w, 4) and ts.bvh.waxis.shape == (w,)
    assert (ts.bvh.n_nodes - 1) // 2 > w > ts.bvh.n_nodes // 8
    # widen() of the port's binary tree alone gives the same fields
    _assert_wide_equal(tbk.widen(dataclasses.replace(
        ts.bvh, wsel=None, wcode=None, waxis=None)), js.bvh)


def test_widen_single_leaf_root():
    """A tree that is one leaf gets the JAX package's one dummy row, and
    the wide walk over it finds what the binary walk finds."""
    g = np.random.default_rng(5)
    tp = g.uniform(-1, 1, (9, 3, 3)).astype(np.float32)
    jb, order = jbuild(tp, max_leaf=14)
    tb, order_t = tbvh.build(tp, max_leaf=14)
    assert int(tb.right[0]) < 0
    np.testing.assert_array_equal(order, order_t)
    _assert_wide_equal(tbk.widen(tb), jbk.widen(jb))
    tp = tp[order]
    tris = Triangles(_tv(tp[:, 0]), _tv(tp[:, 1] - tp[:, 0]),
                     _tv(tp[:, 2] - tp[:, 0]), *([None] * 7),
                     area=torch.ones(9), mat_id=None, light_id=None)
    o = np.zeros((64, 3), np.float32)
    d = g.standard_normal((64, 3)).astype(np.float32)
    t0 = torch.full((64,), tint.BIG_T)
    wide = tbk.traverse_plain(tbk.widen(tb), tris, _tv(o), _tv(d), t0,
                              wide=True)
    binary = tbk.traverse_plain(tb, tris, _tv(o), _tv(d), t0)
    assert torch.equal(wide.tri, binary.tri) and (wide.tri >= 0).any()


def test_pack_tables_wide_match_jax(scenes):
    js, ts = scenes
    jn, jl = jbk.pack_tables_wide(js.bvh, js.triangles)
    tn, tl = tbk.pack_tables_wide(ts.bvh, ts.triangles)
    for got, want in ((tn, jn), (tl, jl)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tn.shape == (ts.bvh.wsel.shape[0], 32)
    assert tl.shape == ((ts.bvh.n_nodes + 1) // 2, 128)
    # empty slots are the far point, not an inverted box
    empty = (ts.bvh.wsel < 0).numpy()
    assert empty.any()
    boxes = tn[:, :24].reshape(-1, 4, 6).numpy()
    assert (boxes[empty] == np.float32(3.0e38)).all()
    # built once per scene, beside the binary tables
    a = tbk.tables(ts.bvh, ts.triangles, False, wide=True)
    assert tbk.tables(ts.bvh, ts.triangles, True, wide=True) is a
    assert tbk.tables(ts.bvh, ts.triangles, False) is not a


@pytest.mark.parametrize("any_hit", [False, True],
                         ids=["closest-hit", "any-hit"])
def test_wide_plain_matches_pallas_interpret(scenes, rays, any_hit):
    js, ts = scenes
    o, d, dead, t_closest, t_any = rays
    t0 = t_any if any_hit else t_closest
    hj = jbk.traverse_packet(js.bvh, js.triangles, _jv(o), _jv(d),
                             jnp.asarray(t0), any_hit=any_hit, wide=True,
                             interpret=True, ray_sub=8)
    hp = tbk.traverse_plain(ts.bvh, ts.triangles, _tv(o), _tv(d),
                            torch.from_numpy(t0), any_hit=any_hit, wide=True)
    tri_j, tri_p = np.asarray(hj.tri), hp.tri.numpy()
    np.testing.assert_array_equal(tri_j >= 0, tri_p >= 0)
    assert not (tri_p[dead] >= 0).any()
    miss = tri_p < 0
    np.testing.assert_array_equal(hp.t.numpy()[miss], t0[miss])
    if any_hit:
        assert 0.2 < (tri_p >= 0).mean() < 0.9
        return
    assert (tri_j == tri_p).mean() >= 0.999
    np.testing.assert_allclose(hp.t.numpy(), np.asarray(hj.t), rtol=1e-5,
                               atol=1e-6)
    both = (tri_j == tri_p) & ~miss
    for a, b in ((hp.u, hj.u), (hp.v, hj.v)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=1e-4, atol=1e-5)
    assert (tri_p >= 0).mean() > 0.5


@pytest.mark.parametrize("any_hit", [False, True],
                         ids=["closest-hit", "any-hit"])
def test_wide_matches_binary(scenes, rays, any_hit):
    _, ts = scenes
    o, d, dead, t_closest, t_any = rays
    t0 = torch.from_numpy(t_any if any_hit else t_closest)
    args = (ts.bvh, ts.triangles, _tv(o), _tv(d), t0)
    hw = tbk.traverse_plain(*args, any_hit=any_hit, wide=True)
    if any_hit:
        raw = tbk.traverse_plain(*args, any_hit=True, leaf16=False)
        const = tbk.traverse_plain(*args, any_hit=True)
        assert torch.equal(hw.tri >= 0, raw.tri >= 0)
        assert ((hw.tri >= 0) == (const.tri >= 0)).float().mean() >= 0.999
        return
    hb = tbk.traverse_plain(*args)
    assert torch.equal(hw.tri, hb.tri)
    assert torch.equal(hw.t, hb.t)


def test_default_route_is_binary(scenes, rays, monkeypatch):
    """The loader attaches the wide fields, `wide_ok` holds, and the JAX
    package's rule (wide only for depth > 64 with wide_ok, which needs
    depth <= 42) still picks the binary walk: `usable` is unchanged for
    every depth."""
    _, ts = scenes
    o, d, _, t_closest, _ = rays
    bvh = ts.bvh
    assert bvh.wsel is not None and tbk.wide_ok(bvh) and tbk.usable(bvh)
    for depth in (1, 42, 43, 64, 65, 200):
        deep = dataclasses.replace(bvh, depth=depth)
        assert tbk._variant(deep, False, None, None)[0] is False
        assert tbk.usable(deep) == (depth <= tbk.MAX_STACK)
        assert tbk.wide_ok(deep) == (depth <= 42)
        bare = dataclasses.replace(deep, wsel=None, wcode=None, waxis=None)
        assert tbk.usable(bare) == tbk.usable(deep)
    assert tbk._variant(bvh, True, None, None) == (False, True)
    assert tbk._variant(bvh, True, None, True) == (True, False)

    def refuse(*args):
        raise AssertionError("the default route took the wide walk")

    monkeypatch.setattr(tbk, "_walk_wide", refuse)
    h = tbk.traverse_packet(bvh, ts.triangles, _tv(o), _tv(d),
                            torch.from_numpy(t_closest))
    assert (h.tri >= 0).any()


def test_wide_contracts(scenes, rays):
    """Every ray count works, CPU tensors launch nothing, a tree without
    wide fields (or too deep for the wide stack) is refused."""
    _, ts = scenes
    o, d, dead, t_closest, t_any = rays
    launches = dict(tbk.launches)
    full = tbk.traverse_plain(ts.bvh, ts.triangles, _tv(o), _tv(d),
                              torch.from_numpy(t_closest), wide=True)
    for n in (1, 129, N):
        h = tbk.traverse_packet(ts.bvh, ts.triangles, _tv(o[:n]),
                                _tv(d[:n]), torch.from_numpy(t_closest[:n]),
                                wide=True)
        np.testing.assert_array_equal(h.tri.numpy(), full.tri.numpy()[:n])
        assert h.t.shape == (n,) and h.tri.dtype == torch.int32
    assert tbk.launches == launches and tbk._lib is None
    assert set(launches) == {"closest_hit", "any_hit", "wide_closest_hit",
                             "wide_any_hit"}
    bare = dataclasses.replace(ts.bvh, wsel=None, wcode=None, waxis=None)
    for bvh in (bare, dataclasses.replace(ts.bvh, depth=43)):
        with pytest.raises(ValueError):
            tbk.traverse_packet(bvh, ts.triangles, _tv(o), _tv(d),
                                torch.from_numpy(t_closest), wide=True)


def test_bvh_to_keeps_every_field(scenes):
    """`to()` carries the binary tree, the wide fields and the treelet
    fields; every copy starts with an empty cache."""
    js, ts = scenes
    tl = jtl.attach_treelets(js.bvh)
    full = scene_from_numpy(jax.tree_util.tree_map(
        np.asarray, js._replace(bvh=tl)), "cpu").bvh
    for f in BVH_ARRAYS:
        assert getattr(full, f) is not None, f
        np.testing.assert_array_equal(getattr(full, f).numpy(),
                                      np.asarray(getattr(tl, f)), err_msg=f)
    tbk.tables(full, ts.triangles, False)
    assert full.cache
    moved = full.to("cpu")
    assert isinstance(moved, BVH) and not moved.cache
    for f in BVH_ARRAYS:
        assert torch.equal(getattr(moved, f), getattr(full, f)), f
    assert (moved.leaf_max, moved.depth) == (full.leaf_max, full.depth)
    for copy in (moved.replace_wide(np.zeros((1, 4)), np.zeros((1, 4)),
                                    np.zeros(1)),
                 moved.replace_treelets(*([np.zeros(1)] * 6))):
        assert not copy.cache and copy.wsel.dtype == torch.int32
        assert copy.tl_nodes is not None and copy.wsel is not None


WARP = 32
REFILL_BELOW = 16        # the kernel's kRefillBelow


class _Lane:
    """One lane's walk, as the kernel keeps it in registers."""

    def __init__(self):
        self.alive = self.have = self.leaf = False
        self.idx = self.code = self.it = 0
        self.tri = -1
        self.te = self.t = self.u = self.v = 0.0
        self.stack = []


def _wide_model(nodes, leaves, o, d, t0, init_code, iters, any_hit,
                warps=3):
    """bvh_traverse_wide_kernel's schedule in torch -> ((t, tri, u, v) as
    the kernel writes them, its visits, the walks that the cap ended).
    `warps` persistent warps take turns through the kernel's outer loop:
    a warp with fewer than 16 rays in flight hands its idle lanes the next
    rays of a counter, in lane order; its lanes walk wide rows one a step
    (pop where the entry is used up, end at an empty stack or at the cap,
    prune by the best hit, stop at a leaf, else slab-test the 4 children,
    take them far to near, push all live ones but the nearest) until each
    holds a leaf or is done; then the warp tests every held leaf at once.
    The arithmetic is the plain walk's (`_slab`, `_leaf9`): what this
    holds is the schedule."""
    n = t0.shape[0]
    ray = (o.x, o.y, o.z, d.x, d.y, d.z)
    inv = tbk._inv_dir(o, d)
    t_out = torch.full((n,), float("nan"))
    tri_out = torch.full((n,), -7, dtype=torch.int32)
    u_out, v_out = torch.zeros(n), torch.zeros(n)
    visits = {"internal": 0, "leaf": 0, "slots": 0}
    counter, capped = [0], [0]
    seeds = t0.tolist()

    def node_phase(lanes):
        walking = [ln for ln in lanes if ln.alive]
        while walking:
            visit = []
            for ln in walking:
                if not ln.have:
                    if not ln.stack:
                        ln.alive = False
                        continue
                    ln.code, ln.te = ln.stack.pop()
                    ln.have = True
                if ln.it >= iters:
                    ln.alive = False
                    capped[0] += 1
                    continue
                ln.it += 1
                if not ln.te < ln.t:
                    ln.have = False
                elif ln.code < 0:
                    ln.leaf = True
                else:
                    visit.append(ln)
            if visit:
                visits["internal"] += len(visit)
                idx = torch.tensor([ln.idx for ln in visit])
                rows = nodes[torch.tensor([ln.code for ln in visit])]
                t_b = torch.tensor([ln.t for ln in visit],
                                   dtype=torch.float32)
                inv_i = tuple(c[idx] for c in inv)
                tes = torch.stack([tbk._slab(rows, 6 * k, inv_i, t_b)
                                   for k in range(4)], dim=1)
                live = (tes < tbk.INF).tolist()
                tes, cds = tes.tolist(), rows[:, 24:28].long().tolist()
                d_pos = tbk._d_pos(V3(d.x[idx], d.y[idx], d.z[idx]),
                                   rows[:, 28].long()).tolist()
                for i, ln in enumerate(visit):
                    ln.have = False
                    for j in range(4):
                        k = 3 - j if d_pos[i] else j
                        if not live[i][k]:
                            continue
                        if ln.have and len(ln.stack) < tbk.MAX_STACK:
                            ln.stack.append((ln.code, ln.te))
                        ln.code, ln.te, ln.have = cds[i][k], tes[i][k], True
            walking = [ln for ln in walking if ln.alive and not ln.leaf]

    def leaf_phase(lanes):
        held = [ln for ln in lanes if ln.leaf]
        if not held:
            return
        idx = torch.tensor([ln.idx for ln in held])
        rows = leaves[torch.tensor([-ln.code - 1 for ln in held])]
        hit, j, t_h, u_h, v_h = tbk._leaf9(
            rows, tuple(c[idx] for c in ray),
            torch.tensor([ln.t for ln in held], dtype=torch.float32),
            any_hit)
        visits["leaf"] += len(held)
        visits["slots"] += tbk._slots_needed(rows[:, tbk.LANE_START + 1],
                                             hit, j, any_hit)
        base = rows[:, tbk.LANE_START].int()
        for i, ln in enumerate(held):
            ln.leaf = ln.have = False
            if bool(hit[i]):
                ln.tri = int(base[i] + j[i])
                if any_hit:
                    ln.t = -1.0
                    ln.alive = False      # occluded: done
                else:
                    ln.t, ln.u, ln.v = (float(t_h[i]), float(u_h[i]),
                                        float(v_h[i]))

    def outer(w):
        """One pass of the kernel's outer loop -> False once the warp is
        done."""
        lanes = w["lanes"]
        live = sum(ln.alive for ln in lanes)
        if not w["exhausted"] and live < REFILL_BELOW:
            idle = [ln for ln in lanes if not ln.alive]
            first = counter[0]
            counter[0] += len(idle)
            w["exhausted"] = first + len(idle) >= n
            for rank, ln in enumerate(idle):
                if first + rank < n:
                    ln.__init__()
                    ln.idx, ln.code, ln.t = first + rank, init_code, \
                        seeds[first + rank]
                    ln.have = ln.alive = True
        was_alive = [ln.alive for ln in lanes]
        if not any(was_alive):
            return False
        node_phase(lanes)
        leaf_phase(lanes)
        for ln, was in zip(lanes, was_alive):
            if was and not ln.alive:
                t_out[ln.idx], tri_out[ln.idx] = ln.t, ln.tri
                u_out[ln.idx], v_out[ln.idx] = ln.u, ln.v
        return True

    active = [{"lanes": [_Lane() for _ in range(WARP)], "exhausted": False}
              for _ in range(warps)]
    while active:
        active = [w for w in active if outer(w)]
    return (t_out, tri_out, u_out, v_out), visits, capped[0]


def _small_tree():
    """40 random triangles in leaves of at most 2: a tree deep enough that
    wide rows hold leaves and inner rows side by side."""
    g = np.random.default_rng(11)
    tp = (g.uniform(-1, 1, (40, 1, 3)) + g.uniform(-0.6, 0.6, (40, 3, 3))
          ).astype(np.float32)
    bvh, order = tbvh.build(tp, max_leaf=2)
    tp = tp[order]
    tris = Triangles(_tv(tp[:, 0]), _tv(tp[:, 1] - tp[:, 0]),
                     _tv(tp[:, 2] - tp[:, 0]), *([None] * 7),
                     area=torch.ones(40), mat_id=None, light_id=None)
    return tbk.widen(bvh), tris


@pytest.mark.parametrize("cap", ["full", "cut"])
@pytest.mark.parametrize("any_hit", [False, True],
                         ids=["closest-hit", "any-hit"])
@pytest.mark.parametrize("tree", ["spheres", "small"])
def test_wide_schedule_model_equals_plain(scenes, rays, tree, any_hit, cap):
    """The kernel's schedule (leaves after nodes, persistent warps) visits
    what the lockstep plain walk visits, ray by ray: equal t, tri, u, v and
    equal visit counts; with the cap cut to a few visits, some walks end
    early and still agree."""
    o, d, dead, t_closest, t_any = rays
    if tree == "spheres":
        bvh, tris = scenes[1].bvh, scenes[1].triangles
    else:
        bvh, tris = _small_tree()
        # from the small tree's box, so that most rays enter it
        o = (o - [0, 1, 0.5]) * 2.0
    t_init = torch.from_numpy(t_any if any_hit else t_closest)
    nodes, leaves = tbk.tables(bvh, tris, False, wide=True)
    n = t_init.shape[0]
    t0 = tbk._seed(t_init, n)
    iters = tbk.max_iters(bvh) if cap == "full" else 5
    args = (nodes, leaves, _tv(o.astype(np.float32)), _tv(d), t0,
            tbk._init_code(bvh), iters, any_hit)
    before = dict(tbk.plain_visits)
    want = tbk._walk_wide(*args)
    want_visits = {k: tbk.plain_visits[k] - before[k] for k in before}
    got, visits, capped = _wide_model(*args)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert visits == want_visits
    assert not (got[1].numpy()[dead] >= 0).any()
    assert (capped > 0) == (cap == "cut")
    if cap == "full":
        assert visits["leaf"] > n // 4 and (got[1] >= 0).float().mean() > 0.1


def _c_params(src, name):
    """The parameter types of the `extern "C"` function `name` in `src`,
    each as the ctypes type `launch` binds it with."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    params = [p.strip() for p in m.group(1).split(",")]
    return [tbk.PTR if ("*" in p or "cudaStream_t" in p) else tbk.I32
            for p in params]


def test_launcher_signatures_match_the_source():
    """SIGNATURES (then the stream) is what csrc/bvh_kernel.cu's launchers
    take: the 4-wide walk's ends with the ray counter, as the binary
    walk's does, and takes no leaf16."""
    src = open(os.path.join(os.path.dirname(tbk.__file__), os.pardir,
                            "csrc", "bvh_kernel.cu")).read()
    for name, sig in tbk.SIGNATURES.items():
        assert _c_params(src, name) == list(sig) + [tbk.PTR], name
    wide, binary = (tbk.SIGNATURES[k] for k in ("bvh_traverse_wide",
                                                "bvh_traverse"))
    assert wide == binary[:-2] + [tbk.PTR]
