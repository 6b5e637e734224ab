"""The port's ray-sharded paths (raytracingrenderer_tpu_torch/parallel/mesh.py
and overlap.py, and the `mesh=` of integrators/adaptive.py and
lighttracer.py) on gloo ranks on the CPU, against the JAX package on its
8-device CPU mesh and against the port's own one-process paths.

The ranks are processes of tests/torch_dist.py (torch only): one spawn of
2 ranks and one of 4 run every check, on the in-repo cornell box at
32x32 and 32x30 (30 rows do not split evenly over 4 ranks: bands of 8,
8, 8 and 6) and the 5,156-triangle spheres scene at 24x20.

Tolerances: the rng's lane offsets and render_sharded bit for bit
(every pixel draws its numbers by its global index, and the gather is a
sum with zeros); render_sharded against the JAX package's, and
adaptive_render(mesh=) against the JAX package's on 2 devices, by the
render tests' bar (>= 99% of pixels within rtol 1e-3 / atol 1e-5, means
within 0.5%): the JAX side draws in XLA's float rounding, and an
adaptive draw near a tile boundary may move to the neighbouring tile
(the cumsum rule of tests/test_torch_adaptive.py).  The gradients: the
overlapped schedule against the barriered one, and 2 ranks against 4,
within rtol 1e-4 / atol 1e-6 (the float sums in another order, as
tests/test_parallel.py holds the JAX package); against diff.param_grads
with jitter off (render.sample_image keys its jitter by lane) within
rtol 2e-3 / atol 1e-6, as there.  diff.param_grads itself is held to the
JAX package's in tests/test_torch_diff.py.  The sharded light tracer
against the one-process pass within rtol 1e-5 / atol 1e-7 (the splats'
sums in another order), as tests/test_distributed.py holds JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.integrators.adaptive import (
    adaptive_render as jadaptive)
from raytracingrenderer_tpu.parallel import mesh as jmesh
from raytracingrenderer_tpu.parallel import overlap as joverlap
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.diff import param_grads
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.integrators.lighttracer import (
    light_trace_pass)
from raytracingrenderer_tpu_torch.parallel import mesh as tmesh
from raytracingrenderer_tpu_torch.render import sample_image
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from torch_dist import run
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

CFG = dict(max_depth=2, mis=True, jitter=True)


def agree(a, b):
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel")
    return dict(cornell_dir=write_cornell(str(base / "c32"), 32, 32),
                cornell30_dir=write_cornell(str(base / "c30"), 32, 30),
                spheres_dir=write_spheres(str(base / "s"), 24, 20,
                                          subdiv=2))


@pytest.fixture(scope="module")
def ranks(dirs, tmp_path_factory):
    """world -> the ranks' results of tests/torch_dist.py::job_parallel."""
    tmp = tmp_path_factory.mktemp("ranks")
    return {world: run("parallel", world, tmp, adaptive=world == 2, **dirs)
            for world in (2, 4)}


@pytest.fixture(scope="module")
def cornell(dirs):
    return load_scene(dirs["cornell_dir"], "cpu")


@pytest.mark.parametrize("offset,n", [(0, 7), (5, 1000), (999, 1),
                                      (4093, 3000)])
def test_rng_offset(offset, n):
    """A band of lanes draws what the whole draw gives those lanes, bit
    for bit, and what jax.random.uniform gives them."""
    key = rng.spp_key(rng.PRNGKey(11), 3)
    jkey = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    whole = rng.uniform(key, 2, rng.BSDF_U, (offset + n,))
    band = rng.uniform(key, 2, rng.BSDF_U, (n,), offset=offset)
    assert torch.equal(band, whole[offset:])
    ref = jax.random.uniform(jax.random.fold_in(jkey, 2 * 16 + rng.BSDF_U),
                             (offset + n,))
    np.testing.assert_array_equal(band.numpy(), np.asarray(ref)[offset:])
    raw = rng.raw_uniform(key, (n,), offset=offset)
    ref = jax.random.uniform(jkey, (offset + n,))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(ref)[offset:])
    with pytest.raises(ValueError, match="32-bit"):
        rng.uniform(key, 0, 0, (4,), offset=2**32 - 2)


def test_mesh_bands_and_one_rank():
    """Bands of ceil(n / size) cover every item once (the last shorter,
    or empty); without a process group the only mesh has one rank, whose
    collectives are identities; shard_rays takes a tree's bands."""
    for n in (0, 1, 7, 30, 32, 1025):
        for size in (1, 2, 3, 4):
            got = [tmesh.Mesh(None, r, size, torch.device("cpu")).band(n)
                   for r in range(size)]
            assert [i for lo, hi in got for i in range(lo, hi)] == \
                list(range(n))
            assert all(hi - lo <= -(-n // size) for lo, hi in got)
    one = tmesh.make_mesh(1)
    assert (one.rank, one.size, one.group) == (0, 1, None)
    assert tmesh.make_mesh().size == 1
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.make_mesh(2)
    t = torch.arange(5.0)
    assert one.all_reduce(t) is None and torch.equal(t, torch.arange(5.0))
    three = tmesh.Mesh(None, 2, 3, torch.device("cpu"))
    tree = {"a": torch.arange(7), "b": (torch.arange(7) * 2,)}
    part = tmesh.shard_rays(three, tree)
    assert part["a"].tolist() == [6] and part["b"][0].tolist() == [12]
    assert torch.equal(tmesh.replicate(one, tree)["a"], tree["a"])


def test_sample_image_rows(dirs):
    """render.sample_image's band of rows equals those rows of the whole
    image bit for bit (its pixels' jitter and paths keyed globally)."""
    sc = load_scene(dirs["cornell30_dir"], "cpu")
    cfg = RenderConfig(**CFG)
    whole = sample_image(sc, rng.PRNGKey(3), cfg)
    for r0, r1 in ((0, 8), (8, 16), (24, 30), (5, 6)):
        band = sample_image(sc, rng.PRNGKey(3), cfg, rows=(r0, r1))
        assert torch.equal(band, whole[r0:r1])


@pytest.mark.parametrize("world", [2, 4])
def test_render_sharded(ranks, dirs, cornell, world):
    """Every rank's gathered image equals sample_image bit for bit (also
    where 30 rows do not split evenly, and on the BVH scene), and the
    JAX package's render_sharded on as many devices by the render bar."""
    cfg = RenderConfig(**CFG)
    whole = sample_image(cornell, rng.PRNGKey(3), cfg).numpy()
    c30 = load_scene(dirs["cornell30_dir"], "cpu")
    whole30 = sample_image(c30, rng.PRNGKey(3), cfg).numpy()
    sp = load_scene(dirs["spheres_dir"], "cpu")
    whole_sp = sample_image(sp, rng.PRNGKey(4), cfg).numpy()
    for r in ranks[world]:
        np.testing.assert_array_equal(r["render"], whole)
        np.testing.assert_array_equal(r["render30"], whole30)
        np.testing.assert_array_equal(r["render_spheres"], whole_sp)
    jsc = jload(dirs["cornell_dir"], build_bvh=False)
    jimg = jmesh.render_sharded(jsc, jax.random.PRNGKey(3), JConfig(**CFG),
                                jmesh.make_mesh(world))
    agree(ranks[world][0]["render"], np.asarray(jimg))


def _grads_close(a, b, rtol, atol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_overlap_matches_barriered(ranks):
    """A reduction a bounce (4 at max_depth 2, the checkpointed bounce's
    recompute adding none) against one at the end: the same gradients
    and loss, real and finite, the same on every rank."""
    for world in (2, 4):
        for r in ranks[world]:
            assert r["red_ov"] == CFG["max_depth"] + 2 and r["red_ba"] == 1
            assert r["loss_ov"] == pytest.approx(r["loss_ba"], rel=1e-6)
            _grads_close(r["grads_ov"], r["grads_ba"], 1e-4, 1e-6)
            assert np.abs(r["grads_ov"]["albedo"]).sum() > 0
            assert all(np.isfinite(g).all() for g in r["grads_ov"].values())
        for r in ranks[world][1:]:
            _grads_close(r["grads_ov"], ranks[world][0]["grads_ov"], 0, 0)


def test_overlap_matches_param_grads(ranks, cornell):
    """With jitter off the sharded estimate is diff.param_grads's."""
    h, w = cornell.camera.height, cornell.camera.width
    ref = param_grads(cornell, torch.zeros((h, w, 3)), rng.PRNGKey(6),
                      RenderConfig(max_depth=2, mis=True, jitter=False))
    ref = {k: (v.stacked() if hasattr(v, "stacked") else v).numpy()
           for k, v in ref.items()}
    for world in (2, 4):
        _grads_close(ranks[world][0]["grads_nojit"], ref, 2e-3, 1e-6)


def test_overlap_matches_jax(ranks, dirs):
    """With jitter on (keyed by global pixel id, as train_step_overlap and
    phase 18 train), 2 ranks against the JAX package's
    param_grads_sharded on 2 devices: the loss and the gradients."""
    js = jload(dirs["cornell_dir"])
    want, loss = joverlap.param_grads_sharded(
        js, jnp.zeros((32, 32, 3)), jax.random.PRNGKey(5), JConfig(**CFG),
        jmesh.make_mesh(2))
    want = {k: np.asarray(v.stacked() if hasattr(v, "stacked") else v)
            for k, v in want.items()}
    for r in ranks[2]:
        assert r["loss_ov"] == pytest.approx(float(loss), rel=2e-3)
        _grads_close(r["grads_ov"], want, 2e-3, 1e-6)


def test_rank_count_invariant(ranks):
    """2 ranks against 4: the same gradients and images."""
    _grads_close(ranks[2][0]["grads_ov"], ranks[4][0]["grads_ov"], 1e-4,
                 1e-6)
    np.testing.assert_array_equal(ranks[2][0]["render"],
                                  ranks[4][0]["render"])


def test_train_step_overlap_descends(ranks):
    for world in (2, 4):
        l0, l1 = ranks[world][0]["losses"]
        assert l1 < l0
        assert all(r["losses"] == (l0, l1) for r in ranks[world])


def test_adaptive_mesh(ranks, dirs):
    """adaptive_render(mesh=) on 2 ranks: the same film on both, finite,
    and the JAX package's on 2 devices by the render bar."""
    (b0, s0), (b1, s1) = (r["adaptive"] for r in ranks[2])
    np.testing.assert_array_equal(b0, b1)
    assert s0 == s1 and np.isfinite(b0).all() and b0.mean() > 0
    jsc = jload(dirs["cornell_dir"], build_bvh=False)
    jf = jadaptive(jsc, JConfig(integrator="adaptive", seed=1, **CFG),
                   total_spp=4, mesh=jmesh.make_mesh(2))
    assert s0 == pytest.approx(float(jf.spp), rel=1e-6)
    agree(b0 / s0, np.asarray(jf.buffer) / float(jf.spp))


@pytest.mark.parametrize("world", [2, 4])
def test_light_trace_mesh(ranks, cornell, world):
    """The paths split over the ranks, the films summed: the one-process
    pass's film on every rank."""
    h, w = cornell.camera.height, cornell.camera.width
    plain = light_trace_pass(cornell, film_mod.new_film(h, w, "cpu"),
                             rng.PRNGKey(7), RenderConfig(
                                 max_depth=2, mis=False, jitter=False), 1024)
    for r in ranks[world]:
        np.testing.assert_allclose(r["light"], plain.buffer.numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert plain.buffer.sum() > 0
