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
- every leaf row carries a count between 1 and 14, the slots at and above
  it are zeros, and `_leaf9` / `_leaf16` never hit in them (what the
  CUDA kernel's count-bounded leaf loop rests on);
- `plain_visits` counts, beside the visits, the triangle tests the leaf
  visits need: filled slots, for an any-hit ray up to its first hit;
- `_traverse_stackless` against JAX's (closest-hit ids and any-hit
  bits on >= 99.9% of rays; an any-hit walk keeps the nearest hit of
  the first occluding leaf, and triangles sharing an edge there tie up
  to XLA's FMA rounding), `_sort_key` bit for bit, and `_sorted_call`
  as a permutation round trip.

The CUDA kernel itself is checked against `traverse_plain` by
tests/test_torch_cuda.py on the card."""
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


@pytest.mark.parametrize("any_hit", [False, True],
                         ids=["closest-hit", "any-hit"])
@pytest.mark.parametrize("leaf16", [False, True], ids=["raw", "const"])
def test_empty_leaf_slots_never_hit(scenes, rays, leaf16, any_hit):
    """What a leaf loop that stops at the row's count rests on: the count
    (raw lane 127, constant-form lane 121 of the odd row) is between 1
    and 14, every slot at or above it is all zeros, and the leaf tests
    report no hit in such a slot."""
    _, ts = scenes
    leaves = (tbk.pack_leaves16 if leaf16 else tbk.pack_leaves)(
        ts.bvh, ts.triangles)
    if leaf16:
        pairs = leaves.view(-1, 2, 128)
        count = pairs[:, 1, tbk.LANE16_START + 1]
        slots = torch.cat([pairs[:, 0].reshape(-1, 8, 16),
                           pairs[:, 1, :96].reshape(-1, 6, 16)], dim=1)
        assert (pairs[:, 1, 96:tbk.LANE16_START] == 0).all()
        assert (pairs[:, 1, tbk.LANE16_START + 2:] == 0).all()
    else:
        count = leaves[:, tbk.LANE_START + 1]
        slots = leaves[:, :tbk.SLOTS * 9].reshape(-1, tbk.SLOTS, 9)
    n_leaf = slots.shape[0]
    assert n_leaf == (ts.bvh.n_nodes + 1) // 2
    assert (count == count.round()).all()
    assert 1 <= count.min() and count.max() <= tbk.SLOTS
    assert count.min() < tbk.SLOTS          # the scene has partial leaves
    empty = torch.arange(tbk.SLOTS)[None, :] >= count[:, None]
    assert (slots[empty] == 0).all()
    assert (slots[~empty] != 0).any(dim=-1).all()

    # rays aimed at a filled slot of a random leaf row (so that many hit),
    # then the same rays against that row with every slot zeroed
    o, _, _, _, t_any = rays
    g = np.random.default_rng(61)
    pick = np.tile(np.arange(N), 8)
    row = torch.from_numpy(g.integers(0, n_leaf, 8 * N))
    aim = (torch.from_numpy(g.random(8 * N)) * count[row]).long()
    tri = tbk.pack_leaves(ts.bvh, ts.triangles)[
        :, :tbk.SLOTS * 9].reshape(-1, tbk.SLOTS, 9)[row, aim]
    target = tri[:, 0:3] + 0.3 * tri[:, 3:6] + 0.3 * tri[:, 6:9]
    d = target.numpy() - o[pick]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ov, dv = _tv(o[pick]), _tv(d)
    ray = (ov.x, ov.y, ov.z, dv.x, dv.y, dv.z)
    gx = (ov.y * dv.z - ov.z * dv.y, ov.z * dv.x - ov.x * dv.z,
          ov.x * dv.y - ov.y * dv.x)
    t_b = (torch.from_numpy(np.abs(t_any[pick]) + 1.0) if any_hit
           else torch.full((8 * N,), tbk.SEED_CLAMP))

    def test(rows):
        if leaf16:
            return tbk._leaf16(rows, ray, gx, t_b, any_hit)[:2]
        return tbk._leaf9(rows, ray, t_b, any_hit)[:2]

    rows = pairs[row] if leaf16 else leaves[row]
    hit, j = test(rows)
    assert 0.5 < hit.float().mean().item()
    assert (j[hit] < count[row][hit]).all()
    hit, _ = test(torch.zeros_like(rows))
    assert not hit.any()


@pytest.mark.parametrize("any_hit,leaf16,wide", [
    (False, False, False), (True, True, False), (True, False, False),
    (False, False, True)],
    ids=["closest-raw", "any-const", "any-raw", "wide-closest"])
def test_plain_visits_count_needed_slots(scenes, rays, any_hit, leaf16,
                                         wide):
    """`plain_visits["slots"]`, the triangle tests a walk needs: a visited
    leaf's filled slots, for an any-hit ray only up to its first hit.
    Between one and 14 a leaf visit, below 14 on a scene with partial
    leaves; nothing for dead rays."""
    count = torch.tensor([3.0, 5.0, 14.0])
    hit = torch.tensor([True, False, True])
    j = torch.tensor([0, 2, 13])
    assert tbk._slots_needed(count, hit, j, any_hit=False) == 22
    assert tbk._slots_needed(count, hit, j, any_hit=True) == 1 + 5 + 14

    _, ts = scenes
    o, d, dead, t_closest, t_any = rays
    t0 = torch.from_numpy(t_any if any_hit else t_closest)

    def visits(ov, dv, t_init):
        before = dict(tbk.plain_visits)
        tbk.traverse_plain(ts.bvh, ts.triangles, ov, dv, t_init,
                           any_hit=any_hit, leaf16=leaf16, wide=wide)
        return {k: tbk.plain_visits[k] - before[k] for k in before}

    v = visits(_tv(o), _tv(d), t0)
    assert v["internal"] >= (~dead).sum() and v["leaf"] > 0
    assert v["leaf"] <= v["slots"] < tbk.SLOTS * v["leaf"]
    assert visits(_tv(o[dead]), _tv(d[dead]), t0[dead]) == {
        "internal": 0, "leaf": 0, "slots": 0}
