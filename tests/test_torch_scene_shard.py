"""The port's scene-sharded intersection (raytracingrenderer_tpu_torch/
parallel/scene_shard.py and `load_scene(..., scene_shards=N)`) on gloo
ranks on the CPU (tests/torch_dist.py), against the JAX package's
(its 8-device CPU mesh), the brute-force oracle and the port's
replicated scene.

Held exactly: build_sharded's padded order, per-shard trees and geometry
against the JAX package's (the same native builds), the loaded shards'
geometry, shading rows (the JAX pack_attrs's first 19 columns) and light
ids against the JAX loader's, gather_attrs_sharded against a plain
gather, closest_hit_sharded against the brute force over the same
triangles, and the any-hit bits against the replicated walk and the
brute force.  traverse_sharded's closest hits: where its triangle is the
replicated walk's (mapped by geometry) t is equal bit for bit (the same
leaf test on the same triangle), and the triangles agree on >= 99% of
the rays (an exact tie, or a grazing box test whose boxes differ between
the trees, may pick another); against the JAX package's traverse_sharded
(a stackless walk with its own triangle test) and the brute force,
within rtol 1e-4 / atol 1e-4, as tests/test_parallel.py holds JAX's.  A
sharded render against the replicated one by the render tests' bar."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.core.vec import V3 as JV3
from raytracingrenderer_tpu.parallel import scene_shard as jss
from raytracingrenderer_tpu.parallel.mesh import make_mesh as jmake_mesh
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.geometry import intersect
from raytracingrenderer_tpu_torch.parallel import scene_shard as ss
from raytracingrenderer_tpu_torch.render import sample_image
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from torch_dist import run
from torch_scenes import icosphere, write_cornell, write_spheres

torch.set_num_threads(2)

N_RAYS = 1024


def agree(a, b):
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


def _rays(centre, radius, n, seed):
    r = np.random.default_rng(seed)
    o = (centre + r.normal(size=(n, 3)) * radius * 0.5).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _geom_keys(p0, e1, e2):
    """Per triangle, the bytes of its (p0, e1, e2): a triangle's identity
    across two orders."""
    g = np.stack([np.stack([c.numpy() for c in f], -1)
                  for f in (p0, e1, e2)], 1).reshape(-1, 9)
    return [row.tobytes() for row in g.astype(np.float32)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("shard")
    sdir = write_spheres(str(base / "s"), 24, 20, subdiv=2)
    cdir = write_cornell(str(base / "c"), 24, 20)
    rep = load_scene(sdir, "cpu")
    c = np.asarray([float(v) for v in rep.bounds.centre], np.float32)
    radius = float(rep.bounds.radius)
    o, d = _rays(c, radius, N_RAYS, 0)
    max_t = np.full(N_RAYS, radius * 0.5, np.float32)
    co, cd = _rays(np.asarray([0.0, 1.0, 0.0], np.float32), 1.0, 256, 1)
    args = dict(spheres_dir=sdir, o=tuple(_tv3(o)), d=tuple(_tv3(d)),
                max_t=torch.from_numpy(max_t), key=5, cornell_dir=cdir,
                co=tuple(_tv3(co)), cd=tuple(_tv3(cd)))
    ranks = run("scene_shard", 2, base, **args)
    return dict(ranks=ranks, rep=rep, o=o, d=d, max_t=max_t, co=co, cd=cd,
                sdir=sdir, cdir=cdir)


def _tp():
    """Two icospheres and a quad: 648 triangles."""
    v, f = icosphere(2)
    tp = [v[f] * 0.3 + off for off in ((0, 0, 0), (0.9, 0.1, 0.2))]
    quad = np.array([[[-1, -1, -1], [1, -1, -1], [1, 1, -1]],
                     [[-1, -1, -1], [1, 1, -1], [-1, 1, -1]]], float)
    return np.concatenate(tp + [quad]).astype(np.float32)


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_build_sharded_matches_jax(n_shards):
    """The padded order, each shard's tree (the JAX package's before its
    node padding) and each shard's geometry equal the JAX package's."""
    tp = _tp()
    sb, order = ss.build_sharded(tp, n_shards)
    jsb, jorder = jss.build_sharded(tp, n_shards)
    np.testing.assert_array_equal(order, jorder)
    assert (sb.n_shards, sb.shard_size, sb.leaf_max) == \
        (jsb.n_shards, jsb.shard_size, jsb.leaf_max)
    assert sorted(sb.shards) == list(range(n_shards))
    for i, sh in sb.shards.items():
        b = sh.bvh.n_nodes
        for name in ("lo", "hi", "right", "start", "count", "skip"):
            np.testing.assert_array_equal(
                getattr(sh.bvh, name).numpy(),
                np.asarray(getattr(jsb, name))[i][:b], err_msg=name)
        for name in ("p0", "e1", "e2"):
            np.testing.assert_array_equal(
                getattr(sh.triangles, name).stacked().numpy(),
                np.asarray(getattr(jsb, name).stacked())[i], err_msg=name)
        assert sh.bvh.wsel is not None and sh.bvh.depth > 0


def test_empty_shards(tmp_path):
    """More shards than triangles: the orders agree with the JAX
    package's, every empty shard is one never-hit leaf, and 4 ranks (one
    shard empty) give the brute force's hits."""
    r = np.random.default_rng(3)
    tp = r.uniform(-1, 1, (3, 3, 3)).astype(np.float32)
    sb, order = ss.build_sharded(tp, 8)
    _, jorder = jss.build_sharded(tp, 8)
    np.testing.assert_array_equal(order, jorder)
    assert (order < 0).sum() == 8 * sb.shard_size - 3
    for i in range(3, 8):
        t = sb.shards[i].bvh
        assert t.n_nodes == 1 and int(t.count[0]) == 0
        assert torch.isinf(t.lo).all() and int(t.right[0]) == -1
    o = r.uniform(-2, 2, (256, 3)).astype(np.float32)
    d = r.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ranks = run("empty_shards", 4, tmp_path, tp=tp, o=tuple(_tv3(o)),
                d=tuple(_tv3(d)))
    t_s, tri_s = ranks[0]["hit"][:2]
    order4 = ranks[0]["order"]
    tris = ss._geometry(tp)
    ref = intersect.closest_hit_brute(tris, _tv3(o), _tv3(d))
    np.testing.assert_allclose(t_s, ref.t.numpy(), rtol=1e-5, atol=1e-5)
    hit = tri_s >= 0
    assert hit.any() and np.array_equal(hit, ref.tri.numpy() >= 0)
    np.testing.assert_array_equal(order4[tri_s[hit]], ref.tri.numpy()[hit])
    for rk in ranks[1:]:
        for a, b in zip(rk["hit"], ranks[0]["hit"]):
            np.testing.assert_array_equal(a, b)


def test_loaded_shards_match_jax(setup):
    """Each rank holds its own shard alone; the shards' geometry and
    shading rows and the light table's ids equal the JAX loader's
    (scene_shards=2); the triangle table is a one-row stub."""
    ranks = setup["ranks"]
    jsc = jload(setup["sdir"], scene_shards=2)
    jsb = jsc.bvh
    for i, rk in enumerate(ranks):
        assert rk["held"] == [i] and rk["stub_rows"] == 1
        assert rk["shard_size"] == jsb.shard_size
        jgeom = np.stack([np.asarray(c)[i] for f in (jsb.p0, jsb.e1, jsb.e2)
                          for c in (f.x, f.y, f.z)], -1)
        np.testing.assert_array_equal(rk["geometry"], jgeom)
        jattrs = np.asarray(jsb.attrs)[i]
        mine = rk["attrs"]
        np.testing.assert_array_equal(mine[:, :18].view(np.float32),
                                      jattrs[:, :18])
        np.testing.assert_array_equal(mine[:, 18], jattrs[:, 18])
        np.testing.assert_array_equal(rk["lights_tri"],
                                      np.asarray(jsc.lights.tri))


def test_gather_attrs_sharded(setup):
    """Every rank's gathered rows equal a plain gather from the whole
    padded table (the shards' rows in rank order), bit for bit."""
    ranks = setup["ranks"]
    table = np.concatenate([rk["attrs"] for rk in ranks])
    ids = np.maximum(ranks[0]["closest"][1], 0)
    for rk in ranks:
        np.testing.assert_array_equal(rk["gathered"], table[ids])


def test_traverse_sharded(setup):
    """Closest hits against the replicated walk (t bit for bit where the
    triangle is the same), the JAX package's traverse_sharded and the
    brute force; any-hit bits against all three; the same on both
    ranks."""
    ranks, rep = setup["ranks"], setup["rep"]
    o, d, max_t = _tv3(setup["o"]), _tv3(setup["d"]), setup["max_t"]
    t_s, tri_s, u_s, v_s = ranks[0]["closest"]
    for rk in ranks[1:]:
        for a, b in zip(rk["closest"] + rk["any"], ranks[0]["closest"]
                        + ranks[0]["any"]):
            np.testing.assert_array_equal(a, b)
    # map the padded global ids onto the replicated scene's by geometry
    geom = np.concatenate([rk["geometry"] for rk in ranks])
    where = {k: i for i, k in enumerate(_geom_keys(
        rep.triangles.p0, rep.triangles.e1, rep.triangles.e2))}
    to_rep = np.asarray([where.get(g.astype(np.float32).tobytes(), -1)
                         for g in geom])
    h = intersect.closest_hit(rep, o, d)
    hit = tri_s >= 0
    assert hit.mean() > 0.5
    same = np.where(hit, to_rep[np.maximum(tri_s, 0)], -1) == h.tri.numpy()
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(t_s[same], h.t.numpy()[same])
    np.testing.assert_array_equal(u_s[same], h.u.numpy()[same])
    # the JAX package on 2 devices: the same padded ids
    jsc = jload(setup["sdir"], scene_shards=2)
    mesh = jmake_mesh(2)
    jsb = jss.place_sharded(jsc.bvh, mesh)
    jo = JV3.from_stacked(jnp.asarray(setup["o"]))
    jd = JV3.from_stacked(jnp.asarray(setup["d"]))
    jh = jss.traverse_sharded(jsb, jo, jd, jnp.full(N_RAYS, 3.4e38),
                              mesh=mesh)
    assert (np.asarray(jh.tri) == tri_s).mean() >= 0.99
    np.testing.assert_allclose(t_s, np.asarray(jh.t), rtol=1e-4, atol=1e-4)
    brute = intersect.closest_hit_brute(rep.triangles, o, d)
    np.testing.assert_allclose(t_s, brute.t.numpy(), rtol=1e-4, atol=1e-4)
    # any-hit: bits, and the sharded first hit lies within the segment
    occ = ranks[0]["occluded"].astype(bool)
    t_a, tri_a = ranks[0]["any"][:2]
    np.testing.assert_array_equal(tri_a >= 0, occ)
    assert ((t_a < max_t) | ~occ).all()
    np.testing.assert_array_equal(
        occ, intersect.occluded(rep, o, d, torch.from_numpy(max_t)).numpy())
    np.testing.assert_array_equal(
        occ, intersect.any_hit_brute(rep.triangles, o, d,
                                     torch.from_numpy(max_t)).numpy())
    jocc = jss.traverse_sharded(jsb, jo, jd, jnp.asarray(max_t),
                                any_hit=True, mesh=mesh).tri >= 0
    np.testing.assert_array_equal(occ, np.asarray(jocc))


def test_closest_hit_sharded(setup):
    """The brute-force variant: the cornell box padded and split over 2
    ranks, equal to the brute force over the same triangles (the lowest
    id wins a tie either way)."""
    cornell = load_scene(setup["cdir"], "cpu")
    ref = intersect.closest_hit_brute(cornell.triangles, _tv3(setup["co"]),
                                      _tv3(setup["cd"]))
    for rk in setup["ranks"]:
        t, tri, u, v = rk["brute"]
        np.testing.assert_array_equal(t, ref.t.numpy())
        np.testing.assert_array_equal(tri, ref.tri.numpy())
        np.testing.assert_array_equal(u, ref.u.numpy())
    assert (ref.tri.numpy() >= 0).mean() > 0.3


def test_sharded_render_and_refusals(setup):
    """A scene_shards=2 render (1 spp, every rank the whole image, the
    scan integrator) matches the replicated render; geom_grads is
    refused; a scene_shards load without its ranks names torchrun."""
    ranks, rep = setup["ranks"], setup["rep"]
    np.testing.assert_array_equal(ranks[0]["image"], ranks[1]["image"])
    img = sample_image(rep, rng.PRNGKey(5), RenderConfig(
        max_depth=2, mis=True, jitter=True)).numpy()
    agree(ranks[0]["image"], img)
    assert all(rk["refused"] for rk in ranks)
    with pytest.raises(ValueError, match="torchrun"):
        load_scene(setup["sdir"], "cpu", scene_shards=2)
