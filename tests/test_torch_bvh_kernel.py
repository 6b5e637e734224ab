"""The port's BVH traversal against the JAX package's, on the
5,156-triangle spheres scene (its BVH from both loaders):

- `pack_tables` (raw and constant-form leaves), `pack_leaves` and
  `pack_leaves16` equal the JAX tables bit for bit;
- `traverse_plain` (the CUDA kernel's plain version) against the Pallas
  kernel run by `traverse_packet(..., interpret=True, ray_sub=8)`, 1,037
  rays from inside the box with 10% dead lanes: t within rtol 1e-5
  (atol 1e-6: XLA fuses the interpreted kernel's products into FMAs,
  which moves a constant-form t near 0 by a few ulp of its cancelling
  terms), triangle ids equal on >= 99.9% of closest-hit rays and
  any-hit bits (constant-form and raw leaves) on >= 99.9% of rays
  (exact expected); barycentrics within rtol 1e-4 and atol 1e-5 (raw)
  or 1e-4 (constant form, whose u and v cancel larger terms).  Any-hit triangle ids may differ: a walk records
  the first occluder it meets, and the port orders children per ray,
  the TPU kernel per block;
- dead lanes never hit and misses keep t_init;
- `_traverse_stackless` against JAX's (closest-hit ids and any-hit
  bits on >= 99.9% of rays; an any-hit walk keeps the nearest hit of
  the first occluding leaf, and triangles sharing an edge there tie up
  to XLA's FMA rounding), `_sort_key` bit for bit, and `_sorted_call`
  as a permutation round trip.

The CUDA kernel itself is checked against `traverse_plain` by
tests/test_torch_cuda.py and chip_smoke.py on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.geometry import intersect as jint
from raytracingrenderer_tpu.ops import bvh_kernel as jbk
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import intersect as tint
from raytracingrenderer_tpu_torch.ops import bvh_kernel as tbk
from raytracingrenderer_tpu_torch.scene.loader import load_scene as tload
from torch_scenes import write_spheres

torch.set_num_threads(2)

N = 1037   # not a multiple of the kernel's 128-thread block


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = write_spheres(str(tmp_path_factory.mktemp("spheres")), 32, 32, 2)
    return jload(d), tload(d, "cpu")


@pytest.fixture(scope="module")
def rays():
    g = np.random.default_rng(21)
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


@pytest.mark.parametrize("leaf16", [False, True])
def test_pack_tables_match_jax(scenes, leaf16):
    js, ts = scenes
    jn, jl = jbk.pack_tables(js.bvh, js.triangles, leaf16=leaf16)
    tn, tl = tbk.pack_tables(ts.bvh, ts.triangles, leaf16=leaf16)
    for got, want in ((tn, jn), (tl, jl)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tn.shape == (ts.bvh.n_nodes // 2, 16)
    rows = (ts.bvh.n_nodes + 1) // 2 * (2 if leaf16 else 1)
    assert tl.shape == (rows, 128)


def test_pack_leaves_match_jax(scenes):
    js, ts = scenes
    for tf, jf in ((tbk.pack_leaves, jbk.pack_leaves),
                   (tbk.pack_leaves16, jbk.pack_leaves16)):
        np.testing.assert_array_equal(tf(ts.bvh, ts.triangles).numpy(),
                                      np.asarray(jf(js.bvh, js.triangles)))
    # the tables are built once per scene and leaf form
    a = tbk.tables(ts.bvh, ts.triangles, True)
    assert tbk.tables(ts.bvh, ts.triangles, True) is a
    assert tbk.usable(ts.bvh) and ts.bvh.depth <= tbk.MAX_STACK


@pytest.mark.parametrize("any_hit,leaf16", [(False, False), (True, True),
                                            (True, False), (False, True)],
                         ids=["closest-raw", "any-const", "any-raw",
                              "closest-const"])
def test_plain_matches_pallas_interpret(scenes, rays, any_hit, leaf16):
    js, ts = scenes
    o, d, dead, t_closest, t_any = rays
    t0 = t_any if any_hit else t_closest
    hj = jbk.traverse_packet(js.bvh, js.triangles, _jv(o), _jv(d),
                             jnp.asarray(t0), any_hit=any_hit,
                             leaf16=leaf16, interpret=True, ray_sub=8)
    hp = tbk.traverse_plain(ts.bvh, ts.triangles, _tv(o), _tv(d),
                            torch.from_numpy(t0), any_hit=any_hit,
                            leaf16=leaf16)
    tri_j, tri_p = np.asarray(hj.tri), hp.tri.numpy()
    assert ((tri_j >= 0) == (tri_p >= 0)).mean() >= 0.999
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
    # constant-form barycentrics are differences of products of origin-
    # sized terms, so XLA's FMAs move them by up to ~1e-4 absolute
    atol = 1e-4 if leaf16 else 1e-5
    for a, b in ((hp.u, hj.u), (hp.v, hj.v)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=1e-4, atol=atol)
    assert (tri_p >= 0).mean() > 0.5


def test_contracts(scenes, rays):
    """Dead lanes never hit, misses keep t_init, every ray count works,
    CPU tensors launch nothing, and bad inputs raise."""
    _, ts = scenes
    o, d, dead, t_closest, _ = rays
    launches = dict(tbk.launches)
    for n in (1, 129, N):
        h = tbk.traverse_packet(ts.bvh, ts.triangles, _tv(o[:n]),
                                _tv(d[:n]), torch.from_numpy(t_closest[:n]))
        full = tbk.traverse_plain(ts.bvh, ts.triangles, _tv(o), _tv(d),
                                  torch.from_numpy(t_closest))
        np.testing.assert_array_equal(h.tri.numpy(), full.tri.numpy()[:n])
        assert h.t.shape == (n,) and h.tri.dtype == torch.int32
    assert tbk.launches == launches and tbk._lib is None
    h = tbk.closest_hit_packet(ts.bvh, ts.triangles, _tv(o), _tv(d))
    np.testing.assert_array_equal(h.t.numpy()[h.tri.numpy() < 0],
                                  np.float32(tint.BIG_T))
    occ = tbk.any_hit_packet(ts.bvh, ts.triangles, _tv(o), _tv(d),
                             torch.from_numpy(np.where(dead, -1.0, 0.5)
                                              .astype(np.float32)))
    assert not occ.numpy()[dead].any() and occ.any()
    tv = torch.from_numpy(t_closest)
    with pytest.raises(TypeError):
        tbk.traverse_packet(ts.bvh, ts.triangles, _tv(o), _tv(d),
                            tv.double())
    with pytest.raises(ValueError):
        tbk.traverse_packet(ts.bvh, ts.triangles, _tv(o), _tv(d), tv[:9])
    with pytest.raises(ValueError):
        strided = V3(torch.zeros(2 * N)[::2], *_tv(o)[1:])
        tbk.traverse_packet(ts.bvh, ts.triangles, strided, _tv(d), tv)


@pytest.mark.parametrize("any_hit", [False, True])
def test_stackless_matches_jax(scenes, rays, any_hit):
    js, ts = scenes
    o, d, dead, t_closest, t_any = rays
    t0 = t_any if any_hit else t_closest
    hj = jint._traverse_stackless(js.bvh, js.triangles, _jv(o), _jv(d),
                                  jnp.asarray(t0), any_hit, 14)
    hp = tint._traverse_stackless(ts.bvh, ts.triangles, _tv(o), _tv(d),
                                  torch.from_numpy(t0), any_hit, 14)
    tri_j, tri_p = np.asarray(hj.tri), hp.tri.numpy()
    assert ((tri_j >= 0) == (tri_p >= 0)).mean() >= 0.999
    assert not (tri_p[dead] >= 0).any()
    if not any_hit:
        assert (tri_j == tri_p).mean() >= 0.999
        np.testing.assert_allclose(hp.t.numpy(), np.asarray(hj.t),
                                   rtol=1e-5)
        # the oracle and the packet route find the same hits
        hk = tbk.traverse_plain(ts.bvh, ts.triangles, _tv(o), _tv(d),
                                torch.from_numpy(t0))
        assert (hk.tri == hp.tri).float().mean().item() >= 0.999
        live = ~dead
        hb = tint.closest_hit_bvh(ts.bvh, ts.triangles, _tv(o), _tv(d))
        np.testing.assert_array_equal(hb.tri.numpy()[live], tri_p[live])
    else:
        occ = tint.any_hit_bvh(ts.bvh, ts.triangles, _tv(o), _tv(d),
                               torch.from_numpy(t0))
        np.testing.assert_array_equal(occ.numpy(), tri_p >= 0)


def test_sort_key_matches_jax(scenes, rays):
    js, ts = scenes
    o, d, dead, _, _ = rays
    # origins spread past the scene bounds exercise the clip
    o = np.concatenate([o, o * 3.0 - 1.0])
    d = np.concatenate([d, -d])
    active = np.concatenate([~dead, dead])
    want = np.asarray(jint._sort_key(js, _jv(o), _jv(d),
                                     jnp.asarray(active)))
    got = tint._sort_key(ts, _tv(o), _tv(d), torch.from_numpy(active))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got.numpy()[~active] == 0x7FFFFFFF).all()
    assert len(np.unique(want)) > 100


def test_sorted_call_round_trip(scenes, rays):
    _, ts = scenes
    o, d, dead, t_closest, _ = rays
    seen = {}

    def fn(so, sd, st, ids):
        seen["ids"] = ids
        return tint.Hit(st, ids.int(), so.x, sd.x)

    ids = torch.arange(N)
    out = tint._sorted_call(ts, _tv(o), _tv(d), torch.from_numpy(~dead),
                            (torch.from_numpy(t_closest), ids), fn)
    np.testing.assert_array_equal(out.tri.numpy(), np.arange(N))
    np.testing.assert_array_equal(out.t.numpy(), t_closest)
    np.testing.assert_array_equal(out.u.numpy(), o[:, 0])
    np.testing.assert_array_equal(out.v.numpy(), d[:, 0])
    key = tint._sort_key(ts, _tv(o), _tv(d), torch.from_numpy(~dead))
    sorted_key = key[seen["ids"]]
    assert (sorted_key[1:] >= sorted_key[:-1]).all()
    assert not torch.equal(seen["ids"], ids)
    occ = tint._sorted_call(ts, _tv(o), _tv(d), torch.from_numpy(~dead),
                            (torch.from_numpy(t_closest),),
                            lambda so, sd, st: st > 0)
    np.testing.assert_array_equal(occ.numpy(), ~dead)
