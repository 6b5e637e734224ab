"""The port's brute-force intersector and MT kernel wrapper against the
JAX package: `intersect_plain` vs `closest_hit_brute` and vs the Pallas
kernel in interpret mode, any-hit vs `any_hit_brute`, on the in-repo
cornell box and on random triangles.

Tolerances are those of tests/test_ops.py: t within rtol/atol 1e-4 and
triangle ids agreeing on more than 99.9% of rays (ids may differ only
where two triangles tie on t).  The CUDA kernel itself is checked
against `intersect_plain` by tests/test_torch_cuda.py on the card; here a
torch model of its partition (padded rows, tiles, the warp vote that skips
the tail) is held to `intersect_plain` bit for bit, and the
wrapper's packed rows are shown to be made once a triangle set."""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.geometry import intersect as jint
from raytracingrenderer_tpu.ops.mt_kernel import intersect_pallas
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import intersect as tint
from raytracingrenderer_tpu_torch.ops import mt_kernel
from raytracingrenderer_tpu_torch.scene.convert import scene_from_numpy
from torch_scenes import write_cornell

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = write_cornell(str(tmp_path_factory.mktemp("cornell")), 32, 32)
    js = jload(d, build_bvh=False)
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                "cpu")


def _rays(n, seed, dead_frac=0.0):
    g = np.random.default_rng(seed)
    o = (g.uniform(-1, 1, (n, 3)) * 0.5 + [0, 1, 0.5]).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, tint.BIG_T, np.float32)
    t0[g.random(n) < dead_frac] = -1.0
    return o, d, t0


def _jv(a):
    return JV3.from_stacked(jnp.asarray(a))


def _tv(a, device="cpu"):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
                for i in range(3)))


def _random_tris(n_tri, seed):
    """Triangles of a random soup around the cornell box's frame, as
    numpy arrays in both packages' field names."""
    g = np.random.default_rng(seed)
    p0 = g.uniform(-1, 1, (n_tri, 3)).astype(np.float32) + [0, 1, 0]
    e1 = (g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32)
    e2 = (g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32)
    return p0.astype(np.float32), e1, e2


def _soup(n_tri, seed, scene):
    """(JAX Triangles, port Triangles) of a random soup, other fields
    taken from the cornell scene's first rows (unused by intersection)."""
    p0, e1, e2 = _random_tris(n_tri, seed)
    js = scene[0]
    jt = js.triangles._replace(p0=_jv(p0), e1=_jv(e1), e2=_jv(e2),
                               area=jnp.ones(n_tri, jnp.float32))
    tt = scene[1].triangles._replace(p0=_tv(p0), e1=_tv(e1), e2=_tv(e2),
                                     area=torch.ones(n_tri))
    return jt, tt


def _assert_hits_agree(h_ref, h_port):
    t_ref, t_port = np.asarray(h_ref.t), h_port.t.numpy()
    np.testing.assert_allclose(t_port, t_ref, rtol=1e-4, atol=1e-4)
    same = np.asarray(h_ref.tri) == h_port.tri.numpy()
    assert same.mean() > 0.999
    # barycentrics of hits (the JAX CPU path leaves them unspecified on
    # dead lanes)
    both = same & (h_port.tri.numpy() >= 0)
    np.testing.assert_allclose(h_port.u.numpy()[both],
                               np.asarray(h_ref.u)[both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_port.v.numpy()[both],
                               np.asarray(h_ref.v)[both], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n", [777, 2048])
def test_plain_matches_closest_hit_brute(scenes, n):
    js, ts = scenes
    o, d, t0 = _rays(n, seed=n)
    hb = jint.closest_hit_brute(js.triangles, _jv(o), _jv(d))
    hp = mt_kernel.intersect_plain(ts.triangles, _tv(o), _tv(d),
                                   torch.from_numpy(t0))
    _assert_hits_agree(hb, hp)
    assert (hp.tri.numpy() >= 0).mean() > 0.5   # most rays hit a wall


@pytest.mark.parametrize("n_tri", [36, 128])
def test_plain_matches_pallas_interpret(scenes, n_tri):
    if n_tri == 36:
        jt, tt = scenes[0].triangles, scenes[1].triangles
    else:
        jt, tt = _soup(n_tri, 3, scenes)
    o, d, t0 = _rays(777, seed=5, dead_frac=0.1)
    hk = intersect_pallas(jt, _jv(o), _jv(d), jnp.asarray(t0),
                          interpret=True)
    hp = mt_kernel.intersect_plain(tt, _tv(o), _tv(d), torch.from_numpy(t0))
    _assert_hits_agree(hk, hp)
    dead = t0 < 0
    assert dead.any()
    assert (hp.tri.numpy()[dead] == -1).all()
    np.testing.assert_array_equal(hp.t.numpy()[dead], t0[dead])
    assert (hp.u.numpy()[hp.tri.numpy() < 0] == 0).all()


def test_any_hit_matches_brute(scenes):
    js, ts = scenes
    o, d, _ = _rays(777, seed=7)
    max_t = np.random.default_rng(8).uniform(0.05, 2.5, 777).astype(
        np.float32)
    want = np.asarray(jint.any_hit_brute(js.triangles, _jv(o), _jv(d),
                                         jnp.asarray(max_t)))
    got = mt_kernel.any_hit(ts.triangles, _tv(o), _tv(d),
                            torch.from_numpy(max_t)).numpy()
    assert (got == want).mean() > 0.999
    assert 0.05 < got.mean() < 0.95


def test_scene_dispatch_contracts(scenes):
    """closest_hit: misses at BIG_T/-1, dead lanes never hit; occluded:
    negative radius is never occluded."""
    js, ts = scenes
    o, d, _ = _rays(777, seed=9)
    active = np.random.default_rng(10).random(777) > 0.1
    h = tint.closest_hit(ts, _tv(o), _tv(d), torch.from_numpy(active))
    ref = jint.closest_hit(js, _jv(o), _jv(d), jnp.asarray(active))
    _assert_hits_agree(ref, h)
    tri = h.tri.numpy()
    assert (tri[~active] == -1).all()
    assert (h.t.numpy()[tri < 0] == np.float32(tint.BIG_T)).all()
    assert h.tri.dtype == torch.int32 and h.t.dtype == torch.float32
    max_t = np.where(active, 10.0, -1.0).astype(np.float32)
    occ = tint.occluded(ts, _tv(o), _tv(d), torch.from_numpy(max_t))
    assert not occ.numpy()[~active].any()
    np.testing.assert_array_equal(occ.numpy(), tri >= 0)


def test_no_build_and_no_launch_on_cpu(scenes):
    """Importing the wrapper needs no nvcc; CPU tensors take the plain
    version, which is not a kernel launch."""
    ts = scenes[1]
    before = mt_kernel.launches
    o, d, t0 = _rays(100, seed=11)
    mt_kernel.intersect(ts.triangles, _tv(o), _tv(d), torch.from_numpy(t0))
    mt_kernel.closest_hit(ts.triangles, _tv(o), _tv(d))
    assert mt_kernel.launches == before == 0
    assert mt_kernel._lib is None


def test_wrapper_rejects_bad_inputs(scenes):
    tt = scenes[1].triangles
    o, d, t0 = _rays(64, seed=12)
    ov, dv, tv = _tv(o), _tv(d), torch.from_numpy(t0)
    with pytest.raises(TypeError):
        mt_kernel.intersect(tt, ov, dv, tv.double())
    with pytest.raises(ValueError):
        mt_kernel.intersect(tt, ov, dv, tv[:10])
    with pytest.raises(ValueError):
        strided = V3(torch.zeros(128)[::2], ov.y, ov.z)
        mt_kernel.intersect(tt, strided, dv, tv)
    with pytest.raises(ValueError):
        big = tt._replace(area=torch.ones(mt_kernel.MAX_SMEM_TRIS + 1),
                          p0=V3(*(torch.zeros(mt_kernel.MAX_SMEM_TRIS + 1)
                                  for _ in range(3))),
                          e1=V3(*(torch.zeros(mt_kernel.MAX_SMEM_TRIS + 1)
                                  for _ in range(3))),
                          e2=V3(*(torch.zeros(mt_kernel.MAX_SMEM_TRIS + 1)
                                  for _ in range(3))))
        mt_kernel.intersect(big, ov, dv, tv)


# --------------------------------------------------------------------------
# the CUDA kernel's partition, modelled in torch

CSRC = pathlib.Path(mt_kernel.__file__).resolve().parent.parent / "csrc"


def _cu_const(name):
    """An integer constant of csrc/mt_kernel.cu (`constexpr int name = v;`,
    v a literal or `1 << s`)."""
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / "mt_kernel.cu").read_text())
    return int(eval(m.group(1), {"__builtins__": {}}))


def _mt_model(tris, o, d, t_init):
    """mt_intersect_kernel's partition in torch -> (t, tri, u, v).  The
    wrapper's padded rows go through a ring of kStages slots of kTile
    rows (tile i in slot i % kStages, refilled with tile i + kStages once
    consumed).  A block is kThreads threads, one ray each, so a warp
    is 32 consecutive rays; threads past the end carry a radius of -1.
    Per triangle, in index order: u for every ray, then the tail (v, t)
    only for the warps where some ray has |det| >= eps, 0 <= u <= 1 and
    a positive radius; where the kernel skips it, v and t are NaN here,
    which no test passes."""
    tile_rows, stages = _cu_const("kTile"), _cu_const("kStages")
    rows = mt_kernel.pack_tris(tris)
    assert rows.shape[1] == _cu_const("kRowFloats") == mt_kernel.ROW
    assert (rows[:, 9:] == 0).all()
    n = o.x.shape[0]
    pad = -n % _cu_const("kThreads")

    def padded(a, fill):
        return torch.cat([a, torch.full((pad,), fill)])

    ox, oy, oz = (padded(c, 0.0) for c in o)
    dx, dy, dz = padded(d.x, 0.0), padded(d.y, 1.0), padded(d.z, 0.0)
    t_b = padded(t_init, -1.0)
    opened = t_b > 0.0
    tri_b = torch.full_like(t_b, -1, dtype=torch.int32)
    u_b, v_b = torch.zeros_like(t_b), torch.zeros_like(t_b)
    n_tiles = -(-rows.shape[0] // tile_rows)
    ring, held = [None] * stages, [None] * stages

    def load(i):
        ring[i % stages] = rows[i * tile_rows:(i + 1) * tile_rows]
        held[i % stages] = i

    for i in range(min(stages, n_tiles)):
        load(i)
    nan = torch.tensor(float("nan"))
    for i in range(n_tiles):
        assert held[i % stages] == i
        for k, r in enumerate(ring[i % stages]):
            p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = r[:9]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            ok = det.abs() >= tint.DET_EPS
            inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
            can = ok & opened & (u >= 0.0) & (u <= 1.0)
            voted = can.view(-1, 32).any(dim=1).repeat_interleave(32)
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = torch.where(voted, (dx * qvx + dy * qvy + dz * qvz) * inv,
                            nan)
            t = torch.where(voted, (e2x * qvx + e2y * qvy + e2z * qvz) * inv,
                            nan)
            hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
                   & (t < t_b))
            t_b = torch.where(hit, t, t_b)
            tri_b = torch.where(hit, i * tile_rows + k, tri_b).int()
            u_b = torch.where(hit, u, u_b)
            v_b = torch.where(hit, v, v_b)
        if i + stages < n_tiles:
            load(i + stages)
    return t_b[:n], tri_b[:n], u_b[:n], v_b[:n]


@pytest.mark.parametrize("n_tri", [1, 36, 128, 255, 256, 257, 513])
@pytest.mark.parametrize("n", [1, 3, 127, 128, 129, 1000])
def test_kernel_partition_model_equals_plain(scenes, n, n_tri):
    """Padded rows, tile boundaries, threads past the end and the vote
    that skips the tail: the model equals `intersect_plain` bit for bit,
    closest-hit and any-hit, dead lanes included."""
    tt = scenes[1].triangles if n_tri == 36 else _soup(n_tri, 21, scenes)[1]
    o, d, t0 = _rays(n, seed=n + n_tri, dead_frac=0.1)
    max_t = np.where(t0 < 0, -1.0, np.random.default_rng(n).uniform(
        0.05, 2.5, n)).astype(np.float32)
    ov, dv = _tv(o), _tv(d)
    for t_init in (torch.from_numpy(t0), torch.from_numpy(max_t)):
        want = mt_kernel.intersect_plain(tt, ov, dv, t_init)
        for g, w in zip(_mt_model(tt, ov, dv, t_init), want):
            assert torch.equal(g, w)


def test_pack_tris_packs_once_a_triangle_set(scenes):
    """The padded rows are kept with the tensors they were made from: the
    same `Triangles` gets the same rows back, a new one or one updated in
    place packs anew, and only the last few sets are kept."""
    tt = scenes[1].triangles
    rows = mt_kernel.pack_tris(tt)
    assert rows.shape == (tt.count, mt_kernel.ROW) and rows.is_contiguous()
    want = torch.stack([*tt.p0, *tt.e1, *tt.e2], dim=-1)
    assert torch.equal(rows[:, :9], want) and (rows[:, 9:] == 0).all()
    assert mt_kernel.pack_tris(tt) is rows
    assert mt_kernel.pack_tris(tt._replace(area=tt.area + 1)) is rows
    moved = tt._replace(e1=V3(tt.e1.x.clone(), tt.e1.y, tt.e1.z))
    assert mt_kernel.pack_tris(moved) is not rows
    assert mt_kernel.pack_tris(tt) is rows
    fresh = tt._replace(p0=V3(*(c.clone() for c in tt.p0)))
    first = mt_kernel.pack_tris(fresh)
    fresh.p0.x.add_(1.0)                       # an update in place
    again = mt_kernel.pack_tris(fresh)
    assert again is not first
    assert torch.equal(again[:, 0], fresh.p0.x)
    for i in range(mt_kernel._PACKED_SETS + 1):
        mt_kernel.pack_tris(_soup(4, 30 + i, scenes)[1])
    assert len(mt_kernel._packed) == mt_kernel._PACKED_SETS
    assert mt_kernel.pack_tris(tt) is not rows     # dropped, packed anew
