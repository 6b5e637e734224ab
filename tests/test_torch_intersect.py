"""The port's brute-force intersector and MT kernel wrapper against the
JAX package: `intersect_plain` vs `closest_hit_brute` and vs the Pallas
kernel in interpret mode, any-hit vs `any_hit_brute`, on the in-repo
cornell box and on random triangles.

Tolerances are those of tests/test_ops.py: t within rtol/atol 1e-4 and
triangle ids agreeing on more than 99.9% of rays (ids may differ only
where two triangles tie on t).  The CUDA kernel itself is checked
against `intersect_plain` by tests/test_torch_cuda.py on the card."""
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
    return js, scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


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
