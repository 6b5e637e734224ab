"""The cornell-tetra configuration's scene (rtbench/scenes/cornell_tetra.py:
Haines' fractal tetrahedron in the Cornell Box room) through the port,
against the benchmark's plain reference with its tree
(rtbench/reference/tree.py), on the CPU.

At depth 4 (1,036 triangles, the wavefront forced by
RenderConfig(wavefront=True)) and depth 5 (4,108 triangles, over the
4,096 of render._use_wavefront's own rule), at 32x32 and 64x64: a
render's pixels against the reference's by the benchmark's render rule
(compare.pixels_off, its share under the cornell-box render cell's
px_off_pct limit), and
three train steps (diff.train_step then geometry.refit.refit, the train
cell's own kind) against the reference's with the same keys, by the
train cell's gaps.  The writer: 4^(depth+1) + 12 triangles, the same
bytes twice, every leaf's faces wound outward.
"""
from __future__ import annotations

import argparse
import filecmp
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.geometry import intersect as port_isect
from raytracingrenderer_tpu_torch.ops import bvh_kernel
from raytracingrenderer_tpu_torch.render import _use_wavefront, render
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from rtbench import harness, inputs, run
from rtbench.reference import compare, tree
from rtbench.reference.pt.scene.loader import load_scene as ref_load

WRITER = harness.writer("cornell_tetra")
RENDER_CELL = "cornell-box.render-2048"
TRAIN_CELL = "cornell-tetra.train-1024"
CFG = dict(mis=True, jitter=True, max_depth=4)
# (depth, RenderConfig.wavefront): forced below the rule's 4,096, the
# rule's own choice above it
ROUTES = [(4, True), (5, None)]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def written(tmp_path, depth: int, size: int) -> str:
    return WRITER.write(str(tmp_path / f"tetra{depth}-{size}"), size, size,
                        depth=depth)


@pytest.mark.parametrize("depth", [0, 1, 2, 4, 5])
def test_counts(tmp_path, depth):
    """4^(depth+1) tetrahedron faces and the room's 12 triangles, 7
    materials (an instance each), the light's 2 triangles; the port's
    loader and the reference's agree."""
    sdir = written(tmp_path, depth, 16)
    scene = load_scene(sdir, "cpu")
    ref = ref_load(sdir, "cpu")
    n = 4 ** (depth + 1) + 12
    assert scene.triangles.count == ref.triangles.count == n
    assert scene.materials.count == ref.materials.count == 7
    assert scene.num_lights == 2
    assert json.loads(Path(sdir, "scene.json").read_text())[
        "instances"][-1]["filename"] == "tetra.gem"


def test_writer_is_deterministic(tmp_path):
    a = written(tmp_path / "a", 3, 16)
    b = written(tmp_path / "b", 3, 16)
    names = sorted(p.name for p in Path(a).iterdir())
    assert names == sorted(p.name for p in Path(b).iterdir())
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names and not mismatch and not errors


def test_leaf_faces_wound_outward(tmp_path):
    """Every face's winding normal, cross(e1, e2), and its written normal
    point away from its own tetrahedron's centroid; the recursion's
    leaves are half-size copies about the parent's vertices."""
    tets = WRITER.leaves(3)
    assert tets.shape == (64, 4, 3)
    top = WRITER.tetrahedron()
    for i in range(4):
        kid = WRITER.leaves(1)[i]
        assert np.array_equal(kid, np.stack(
            [top[i]] + [0.5 * (top[i] + top[j]) for j in range(4)
                        if j != i]))
    pos, nrm = WRITER.faces(tets)
    centre = np.repeat(tets.mean(axis=1), 4, axis=0)
    out = pos.mean(axis=1) - centre
    cross = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    assert (np.einsum("ij,ij->i", cross, out) > 0.0).all()
    assert (np.einsum("ij,ij->i", nrm, out) > 0.0).all()
    # the loader keeps the winding's normal (no face flipped to agree
    # with its vertex normal)
    scene = load_scene(written(tmp_path, 3, 16), "cpu", build_bvh=False)
    tris = scene.triangles
    gn = torch.stack(list(tris.gn), 1)[12:]
    cr = torch.stack(list(tris.e1.cross(tris.e2)), 1)[12:]
    assert bool(((gn * cr).sum(1) > 0.0).all())


def test_tetrahedron_placement():
    v = WRITER.tetrahedron()
    edges = [np.linalg.norm(v[i] - v[j]) for i in range(4)
             for j in range(i + 1, 4)]
    assert np.allclose(edges, 1.2, rtol=1e-12)
    assert np.allclose(v[:3, 1], 0.002) and v[3, 1] > 0.9
    assert np.allclose(v[:3, [0, 2]].mean(axis=0), (0.0, -0.15))
    assert np.argmin(v[:3, 2]) == 0 and v[0, 0] == 0.0   # toward the back


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("depth,wavefront", ROUTES)
def test_render_matches_reference(tmp_path, depth, wavefront, size):
    """Two 1-spp passes of the port (the wavefront and the BVH walk)
    against the reference's with its tree, pixel by pixel by the render
    cell's rule."""
    sdir = written(tmp_path, depth, size)
    scene = load_scene(sdir, "cpu")
    cfg = RenderConfig(**CFG, seed=1234 + depth, wavefront=wavefront)
    assert _use_wavefront(scene, cfg)
    assert bvh_kernel.usable(scene.bvh)
    stackless = port_isect.stackless_calls
    film = render(scene, cfg, spp=2)
    ref_scene = compare.ref_scene(sdir, "cpu")
    rcfg = compare.ref_config(CFG, cfg.seed)
    with tree.installed():
        bands = compare.reference_bands(ref_scene, rcfg, cfg.seed, [0, 1],
                                        (0, size))
    got = film.buffer / film.spp
    ref = (bands[0] + bands[1]) / 2.0
    limit = run.limits(RENDER_CELL)["px_off_pct"]
    pct = 100.0 * compare.pixels_off(got, ref, film.buffer) / size ** 2
    assert pct <= limit, pct
    assert port_isect.stackless_calls == stackless


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("depth,wavefront", ROUTES)
def test_train_follows_reference(tmp_path, monkeypatch, depth, wavefront,
                                 size):
    """The train cell's own kind at test size: three steps of
    diff.train_step then refit, the keys of the cell, followed by the
    reference with its tree; loss, gradient and change gaps and the
    refitted tree's boxes within the cell's limits."""
    monkeypatch.setattr(inputs, "SCENE_ROOT", tmp_path)
    man = harness.manifest()
    cell = harness.cell(man, TRAIN_CELL)
    conf = {"scene": {"writer": "cornell_tetra",
                      "params": {"depth": depth}},
            "render_config": dict(CFG, wavefront=wavefront),
            "entry": {"name": f"tetra{depth}"}}
    mix = dict(harness.mix(cell["traffic"]), width=size, height=size)
    args = argparse.Namespace(workload=TRAIN_CELL, seed=2 ** 31 + depth,
                              seconds=0.1, trace=0)
    ctx = run.Run(torch, args, cell, conf, mix, "cpu", time.perf_counter())
    out = harness.kind(mix["kind"]).run(ctx)
    assert out["failed"] == 0
    lim = run.limits(TRAIN_CELL)
    for k, v in out["checks"].items():
        assert v <= lim[k], (k, v, lim[k])
