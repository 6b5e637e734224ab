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
  and `BVH.to()` keeps every optional field.

The CUDA kernel itself is checked against `traverse_plain` by
tests/test_torch_cuda.py and chip_smoke.py on the card."""
import dataclasses

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
