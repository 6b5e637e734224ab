"""The port's BVH builders against the JAX package's: the Python
binned-SAH builder (the oracle) and the native builder's wrapper emit
exactly the JAX trees and triangle orders, on the 5,156-triangle spheres
scene and on a seeded random triangle soup; `compute_skip`,
`tree_depth`, `sah_cost` and `validate` agree.  Also the native
library's guard: the committed -march=native library is loaded only on a
CPU with the AVX-512 extensions it was compiled for."""
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.geometry import bvh as jbvh
from raytracingrenderer_tpu.geometry import bvh_native as jnative
from raytracingrenderer_tpu.scene.types import tree_depth as j_tree_depth
from raytracingrenderer_tpu_torch.geometry import bvh as tbvh
from raytracingrenderer_tpu_torch.geometry import bvh_native as tnative
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from raytracingrenderer_tpu_torch.scene.types import tree_depth
from torch_scenes import write_spheres

torch.set_num_threads(2)

FIELDS = ("lo", "hi", "right", "start", "count", "skip")


@pytest.fixture(scope="module")
def soups(tmp_path_factory):
    """(T, 3, 3) vertex positions: the spheres scene, a random soup."""
    d = write_spheres(str(tmp_path_factory.mktemp("spheres")), 32, 32, 2)
    t = load_scene(d, "cpu", build_bvh=False).triangles
    p0 = t.p0.stacked().numpy()
    scene = np.stack([p0, p0 + t.e1.stacked().numpy(),
                      p0 + t.e2.stacked().numpy()], axis=1)
    g = np.random.default_rng(7)
    c = g.uniform(-1.0, 1.0, (1500, 1, 3))
    soup = (c + g.standard_normal((1500, 3, 3)) * 0.05).astype(np.float32)
    return {"spheres": scene, "soup": soup}


def _assert_tree_equals(tree, order, jtree, jorder):
    for f in FIELDS:
        got, want = getattr(tree, f).numpy(), np.asarray(getattr(jtree, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tree.leaf_max, tree.depth) == (jtree.leaf_max, jtree.depth)
    np.testing.assert_array_equal(order, jorder)


@pytest.mark.parametrize("bins", [16, 64])
@pytest.mark.parametrize("all_axes", [False, True])
@pytest.mark.parametrize("which", ["spheres", "soup"])
def test_python_builder_matches_jax(soups, which, bins, all_axes):
    tp = soups[which]
    tree, order = tbvh.build(tp, 14, bins=bins, all_axes=all_axes)
    jtree, jorder = jbvh.build(tp, 14, bins=bins, all_axes=all_axes)
    _assert_tree_equals(tree, order, jtree, jorder)
    tbvh.validate(tree, tp[order])
    assert tree.leaf_max <= 14 and tree.n_nodes == 2 * (
        (tree.n_nodes + 1) // 2) - 1


@pytest.mark.parametrize("which", ["spheres", "soup"])
def test_native_builder_matches_jax(soups, which):
    tp = soups[which]
    tree, order = tnative.build(tp, max_leaf=14, bins=64, all_axes=True)
    jtree, jorder = jnative.build(tp, max_leaf=14, bins=64, all_axes=True)
    _assert_tree_equals(tree, order, jtree, jorder)
    tbvh.validate(tree, tp[order])
    assert sorted(order.tolist()) == list(range(len(tp)))


def test_tree_helpers_agree(soups):
    tp = soups["spheres"]
    tree, order = tnative.build(tp, max_leaf=14, bins=64, all_axes=True)
    jtree, _ = jnative.build(tp, max_leaf=14, bins=64, all_axes=True)
    right = tree.right.numpy()
    np.testing.assert_array_equal(tbvh.compute_skip(right),
                                  jbvh.compute_skip(right))
    assert tree_depth(right) == j_tree_depth(right) == tree.depth
    assert tbvh.sah_cost(tree) == jbvh.sah_cost(jtree)
    # the 64-bin all-axes tree is no worse than the 16-bin one
    cheap, _ = tbvh.build(tp, 14)
    assert tbvh.sah_cost(tree) <= tbvh.sah_cost(cheap)
    # validate: passes on the reordered triangles, fails on file order
    # and on a shrunken leaf box, as the JAX validate does
    tbvh.validate(tree, tp[order])
    with pytest.raises(AssertionError):
        tbvh.validate(tree, tp)
    with pytest.raises(AssertionError):
        jbvh.validate(jtree, tp)
    leaf = int(np.nonzero(right == -1)[0][0])
    tree.hi[leaf] = tree.lo[leaf]
    with pytest.raises(AssertionError):
        tbvh.validate(tree, tp[order])


def test_native_guard_picks_committed_library_on_avx512_host(
        monkeypatch, tmp_path, soups):
    flags = tnative.cpu_flags()
    assert tnative.committed_ok(flags) == tnative._COMMITTED_ISA.issubset(
        flags)
    assert not tnative.committed_ok(flags - {"avx512f"})
    assert not tnative.committed_ok(frozenset({"sse2", "avx2", "fma"}))
    if "avx512f" in flags:
        # an AVX-512 host loads the committed library, as the JAX
        # package does
        assert tnative.committed_ok(flags)
        assert tnative.library_path() == tnative.COMMITTED_LIB
    # a host without AVX-512 compiles the source instead, at first use
    monkeypatch.setattr(tnative, "cpu_flags", lambda: frozenset({"sse2"}))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "source", None)
    path = tnative.library_path()
    assert path.parent == tmp_path / "native" and path.is_file()
    assert tnative.library_path() == path      # reused, not rebuilt
    tree, order = tnative.build(soups["soup"], 14, 64, True)
    assert tnative.source == str(path)
    tbvh.validate(tree, soups["soup"][order])


def test_empty_input_raises():
    with pytest.raises(ValueError):
        tnative.build(np.zeros((0, 3, 3), np.float32))
