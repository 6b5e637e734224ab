"""The reference's tree (reference/tree.py) against its brute force, bit
for bit; the kind that installs it (train_tree; its run at test size is
test_rtbench_reference's, as every cell's) catches a renderer that
skips its refit or walks a stale table; its extras and its reader."""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import pytest
import torch

from rtbench import control_tree, harness, inputs, run
from rtbench.reference import tree
from rtbench.reference.pt.core.vec import V3
from rtbench.reference.pt.geometry import intersect
from rtbench.reference.pt.scene.loader import load_scene as ref_load
from rtbench.tests.conftest import run_small, small

TRAIN = "cornell-tetra.train-1024"


class Soup(NamedTuple):
    p0: V3
    e1: V3
    e2: V3

    @property
    def count(self) -> int:
        return self.p0.x.shape[0]


def v3(a: torch.Tensor) -> V3:
    return V3(*(a[:, i].contiguous() for i in range(3)))


def soup(n: int, seed: int) -> Soup:
    g = torch.Generator().manual_seed(seed)
    return Soup(v3(torch.rand(n, 3, generator=g)),
                v3(0.2 * torch.randn(n, 3, generator=g)),
                v3(0.2 * torch.randn(n, 3, generator=g)))


def rays(n: int, seed: int, lo=-0.5, hi=1.5):
    g = torch.Generator().manual_seed(seed)
    o = lo + (hi - lo) * torch.rand(n, 3, generator=g)
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    return v3(o), v3(d)


def seeds(n: int, seed: int) -> torch.Tensor:
    """t_init: a tenth of the lanes dead, a third bounded, the rest
    BIG_T."""
    g = torch.Generator().manual_seed(seed)
    r = torch.rand(n, generator=g)
    t = torch.where(r < 0.1, -1.0, intersect.BIG_T)
    return torch.where((r > 0.1) & (r < 0.4), 2.0 * torch.rand(
        n, generator=g), t)


def same(tris, o: V3, d: V3, t_init: torch.Tensor, topo=None):
    """The walk's closest hit equals brute_force's in t, tri, u, v bit
    for bit; its any-hit equals brute_force's occlusion bits."""
    topo = topo or tree.build(tree.centroids(tris), "cpu")
    ref = intersect.brute_force(tris, o, d, t_init)
    got = tree.walk(topo, tris, o, d, t_init, False)
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name
    anyh = tree.walk(topo, tris, o, d, t_init, True)
    assert torch.equal(anyh.tri >= 0, ref.tri >= 0)
    return int((ref.tri >= 0).sum())


@pytest.mark.parametrize("n_tri", [1, 7, 8, 9, 100, 2000])
def test_walk_equals_brute_force_on_soups(n_tri):
    o, d = rays(4000, n_tri)
    same(soup(n_tri, n_tri), o, d, seeds(4000, n_tri))


@pytest.fixture(scope="module")
def tetra3(tmp_path_factory):
    sdir = harness.writer("cornell_tetra").write(
        str(tmp_path_factory.mktemp("tetra3")), 16, 16, depth=3)
    return ref_load(sdir, "cpu").triangles


def test_walk_equals_brute_force_on_a_tetrahedron(tetra3):
    o, d = rays(20000, 5, lo=-1.0, hi=1.0)
    o = V3(o.x, o.y + 1.0, o.z)
    assert same(tetra3, o, d, seeds(20000, 5)) > 10000


@pytest.mark.parametrize("at", ["vertices", "edges"])
def test_walk_equals_brute_force_at_shared_edges(tetra3, at):
    """Rays aimed at the tetrahedra's vertices and at points of their
    edges, where two or more faces meet and hits tie in t."""
    tris = tetra3
    g = torch.Generator().manual_seed(7)
    k = tris.count - 12
    which = 12 + torch.randint(0, k, (6000,), generator=g)
    p0 = torch.stack([c[which] for c in tris.p0], 1)
    e1 = torch.stack([c[which] for c in tris.e1], 1)
    e2 = torch.stack([c[which] for c in tris.e2], 1)
    if at == "vertices":
        pick = torch.randint(0, 3, (6000, 1), generator=g)
        aim = p0 + (pick == 1) * e1 + (pick == 2) * e2
    else:
        s = torch.rand(6000, 1, generator=g)
        aim = torch.where(torch.rand(6000, 1, generator=g) < 0.5,
                          p0 + s * e1, p0 + s * e2)
    orig = torch.rand(6000, 3, generator=g) * torch.tensor(
        [2.0, 2.0, 2.0]) + torch.tensor([-1.0, 0.0, -1.0])
    d = aim - orig
    d = d / d.norm(dim=1, keepdim=True)
    t_init = torch.full((6000,), intersect.BIG_T)
    assert same(tris, v3(orig), v3(d), t_init) > 3000


def test_any_topology_gives_the_same_hits():
    """A tree built over other triangles of the same count walks these
    ones to the same answer (boxes are made from the current triangles
    at every call)."""
    tris = soup(500, 1)
    other = tree.build(tree.centroids(soup(500, 2)), "cpu")
    o, d = rays(3000, 3)
    same(tris, o, d, seeds(3000, 3), topo=other)


def test_installed_restores_walk_after_an_exception():
    was = intersect._walk
    with pytest.raises(RuntimeError):
        with tree.installed() as w:
            assert intersect._walk is w and w is not was
            raise RuntimeError("inside")
    assert intersect._walk is was


@pytest.mark.parametrize("fault", control_tree.FAULTS)
def test_train_tree_catches_geometry_faults(fault):
    """control_tree's planted faults come out not correct, and are
    undone."""
    from raytracingrenderer_tpu_torch.geometry import refit
    from raytracingrenderer_tpu_torch.scene import types
    was = (refit.refit, types.BVH.cached)
    undo = control_tree.planted(fault)
    try:
        assert (refit.refit, types.BVH.cached) != was
        out = run_small(TRAIN, seconds=0.3)
    finally:
        undo()
    assert (refit.refit, types.BVH.cached) == was
    assert not out["correct"], out["checks"]


def ctx_of(cell: str):
    man = harness.manifest()
    w = harness.cell(man, cell)
    conf = harness.config(man, w["config"])
    mix = dict(harness.mix(w["traffic"]), **small(cell))
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 5, seconds=0.1,
                              trace=1)
    return run.Run(torch, args, w, conf, mix, "cpu", time.perf_counter())


def test_train_extras():
    """One step's plain_grad_rows: none on the CPU, where no gather
    counts (the counter counts the card's)."""
    rec = harness.kind("train_tree").extras(ctx_of(TRAIN))
    assert rec == {"plain_grad_rows": 0}
    assert harness.metric_reader("plain_grad_rows_per_step").read(rec) == 0


def test_new_reader():
    read = harness.metric_reader("plain_grad_rows_per_step").read
    assert read({"units": 1, "load_s": 1.0}) is None
    assert read({"plain_grad_rows": 262144}) == 262144


def test_scene_cached_once_per_size(tmp_path, monkeypatch):
    """The configuration's scene is written once a frame size, as the
    box's."""
    monkeypatch.setattr(inputs, "SCENE_ROOT", tmp_path)
    conf = dict(harness.config(harness.manifest(), "cornell-tetra"))
    conf["scene"] = dict(conf["scene"], params={"depth": 2})
    a = inputs.scene_dir(conf, 8, 8)
    assert inputs.scene_dir(conf, 8, 8) == a
    assert ref_load(str(a), "cpu").triangles.count == 4 ** 3 + 12
