"""Multi-rank runs of the port's parallel/ paths for the CPU tests, torch
only (no JAX): the children of a test must not import JAX.

`run(job, world, tmp, **kwargs)` starts `world` processes of this file.
Each joins a gloo group on the CPU through a file store in `tmp` (no
ports, so concurrent test workers cannot collide) with a 60 s timeout on
every collective, runs JOBS[job](mesh, **kwargs) and writes what it
returns with torch.save into `tmp`; `run` returns the ranks' results in
rank order.  Every child is waited on with a deadline and killed after
it, so a hung collective fails its test instead of running the suite
into its time limit.

    python tests/torch_dist.py JOB RANK WORLD TMP    (what `run` starts)
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240.0


def run(job: str, world: int, tmp, timeout_s: float = SPAWN_TIMEOUT_S,
        env=None, device: str = "cpu", **kwargs):
    """`world` gloo ranks of JOBS[job] on `device` (every rank on that
    one: "cuda:0" puts them all on the first card)."""
    tmp = os.path.join(str(tmp), f"{job}-{world}")
    os.makedirs(tmp, exist_ok=True)
    torch.save((device, kwargs), os.path.join(tmp, "args.pt"))
    child_env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                     **(env or {}))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        child_env.pop(k, None)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         tmp], cwd=ROOT, env=child_env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        tails = []
        for r, rc in bad:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                tails.append(f"rank {r} rc {rc}:\n{f.read()[-3000:]}")
        raise AssertionError(f"{job} on {world} ranks failed (a timeout is "
                             f"rc -9):\n" + "\n".join(tails))
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# jobs: (mesh, **kwargs) -> dict of results

def job_parallel(mesh, cornell_dir, cornell30_dir, spheres_dir,
                 adaptive=False):
    """render_sharded, the overlapped step and its reductions,
    train_step_overlap, the sharded light tracer (and adaptive_render)."""
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.integrators.adaptive import (
        adaptive_render)
    from raytracingrenderer_tpu_torch.integrators.lighttracer import (
        light_trace_pass)
    from raytracingrenderer_tpu_torch.parallel import overlap
    from raytracingrenderer_tpu_torch.parallel.mesh import render_sharded
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    out = {}
    cfg = RenderConfig(max_depth=2, mis=True, jitter=True)
    sc = load_scene(cornell_dir, "cpu")
    sp = load_scene(spheres_dir, "cpu")
    out["render"] = _np(render_sharded(sc, rng.PRNGKey(3), cfg, mesh))
    out["render30"] = _np(render_sharded(load_scene(cornell30_dir, "cpu"),
                                         rng.PRNGKey(3), cfg, mesh))
    out["render_spheres"] = _np(render_sharded(sp, rng.PRNGKey(4), cfg,
                                               mesh))
    h, w = sc.camera.height, sc.camera.width
    target = torch.zeros((h, w, 3))

    def grads(key, c, ov):
        before = overlap.reductions
        g, loss = overlap.param_grads_sharded(sc, target, rng.PRNGKey(key),
                                              c, mesh, overlap=ov)
        return ({k: _np(v.stacked() if hasattr(v, "stacked") else v)
                 for k, v in g.items()}, float(loss),
                overlap.reductions - before)

    out["grads_ov"], out["loss_ov"], out["red_ov"] = grads(5, cfg, True)
    out["grads_ba"], out["loss_ba"], out["red_ba"] = grads(5, cfg, False)
    out["grads_nojit"], _, _ = grads(6, RenderConfig(
        max_depth=2, mis=True, jitter=False), True)
    s1, l0 = overlap.train_step_overlap(sc, target, rng.PRNGKey(8), cfg,
                                        mesh, lr=0.5)
    _, l1 = overlap.train_step_overlap(s1, target, rng.PRNGKey(8), cfg,
                                       mesh, lr=0.5)
    out["losses"] = (float(l0), float(l1))
    lt_cfg = RenderConfig(max_depth=2, mis=False, jitter=False)
    film = light_trace_pass(sc, film_mod.new_film(h, w, "cpu"),
                            rng.PRNGKey(7), lt_cfg, 1024, mesh=mesh)
    out["light"] = _np(film.buffer)
    if adaptive:
        f = adaptive_render(sc, RenderConfig(integrator="adaptive",
                                             max_depth=2, mis=True,
                                             jitter=True, seed=1),
                            total_spp=4, mesh=mesh)
        out["adaptive"] = (_np(f.buffer), float(f.spp))
    return out


def job_scene_shard(mesh, spheres_dir, o, d, max_t, key, cornell_dir,
                    co, cd):
    """A scene_shards load: its shards, traverse_sharded (closest and
    any-hit), occluded_sharded, gather_attrs_sharded, a render, the
    refusal of geom_grads; closest_hit_sharded on the cornell box."""
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.geometry.intersect import BIG_T
    from raytracingrenderer_tpu_torch.integrators.common import shading_data
    from raytracingrenderer_tpu_torch.parallel import scene_shard as ss
    from raytracingrenderer_tpu_torch.render import sample_image
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    out = {}
    sc = load_scene(spheres_dir, "cpu", scene_shards=mesh.size)
    sb = sc.bvh
    sh = sb.shards[mesh.rank]
    out["held"] = sorted(sb.shards)
    out["shard_size"] = sb.shard_size
    out["stub_rows"] = sc.triangles.count
    out["geometry"] = np.stack([_np(c) for f in (sh.triangles.p0,
                                                 sh.triangles.e1,
                                                 sh.triangles.e2)
                                for c in f], -1)
    out["attrs"] = _np(sh.attrs)
    out["lights_tri"] = _np(sc.lights.tri)
    o, d = V3(*o), V3(*d)
    n = o.x.shape[0]
    h = ss.traverse_sharded(sb, o, d, torch.full((n,), BIG_T))
    out["closest"] = [_np(a) for a in h]
    ha = ss.traverse_sharded(sb, o, d, max_t, any_hit=True)
    out["any"] = [_np(a) for a in ha]
    out["occluded"] = _np(ss.occluded_sharded(sb, o, d, max_t))
    ids = torch.clamp(h.tri, min=0)
    out["gathered"] = _np(ss.gather_attrs_sharded(sb, ids))
    try:
        shading_data(sc, h, o, d, geom_grads=True)
        out["refused"] = False
    except NotImplementedError:
        out["refused"] = True
    out["image"] = _np(sample_image(sc, rng.PRNGKey(key), RenderConfig(
        max_depth=2, mis=True, jitter=True)))
    cornell = load_scene(cornell_dir, "cpu")
    tris = ss.shard_triangles(mesh, ss.pad_triangles(cornell.triangles,
                                                     mesh.size))
    hb = ss.closest_hit_sharded(tris, V3(*co), V3(*cd), mesh)
    out["brute"] = [_np(a) for a in hb]
    return out


def job_empty_shards(mesh, tp, o, d):
    """More shards than triangles: the empty shards' never-hit trees."""
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.geometry.intersect import BIG_T
    from raytracingrenderer_tpu_torch.parallel import scene_shard as ss
    sb, order = ss.build_sharded(tp, mesh.size)
    sb = ss.place_sharded(sb, mesh, "cpu")
    n = o[0].shape[0]
    h = ss.traverse_sharded(sb, V3(*o), V3(*d), torch.full((n,), BIG_T))
    return {"order": order, "hit": [_np(a) for a in h]}


def job_host_chip(mesh):
    """host_chip_mesh on LOCAL_WORLD_SIZE ranks a host: its shape and a
    sum over each of its axes."""
    from raytracingrenderer_tpu_torch.parallel.distributed import (
        host_chip_mesh, pod_mesh)
    grid = host_chip_mesh()
    rank = torch.distributed.get_rank()
    local = torch.tensor([float(rank)])
    grid.local.all_reduce(local)
    cross = torch.tensor([float(rank)])
    grid.cross.all_reduce(cross)
    pod = torch.tensor([1.0])
    pod_mesh().all_reduce(pod)
    return {"shape": grid.shape, "host": grid.host,
            "local": (grid.local.rank, grid.local.size, float(local)),
            "cross": (grid.cross.rank, grid.cross.size, float(cross)),
            "pod": float(pod), "axes": grid.axis_names}


def job_cli(mesh, argv):
    """cli.main under the group (every rank runs it; rank 0 writes)."""
    from raytracingrenderer_tpu_torch import cli
    return {"rc": cli.main(list(argv))}


def job_card(mesh, cornell_dir, spheres_dir, o, d, max_t):
    """On the ranks' card: render_sharded on both scenes; the scene
    sharded over the ranks (its shards' geometry, traverse_sharded and a
    render); the overlapped and barriered gradients with jitter off on
    both scenes; adaptive_render(mesh=), light_trace_pass(mesh=) and two
    train_step_overlap steps on the cornell box; each step's launches
    (B1, B2 closest-hit, B2 any-hit) under "<step>_launches"."""
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.geometry.intersect import BIG_T
    from raytracingrenderer_tpu_torch.imaging.film import new_film
    from raytracingrenderer_tpu_torch.integrators.adaptive import (
        adaptive_render)
    from raytracingrenderer_tpu_torch.integrators.lighttracer import (
        light_trace_pass)
    from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
    from raytracingrenderer_tpu_torch.parallel import overlap
    from raytracingrenderer_tpu_torch.parallel import scene_shard as ss
    from raytracingrenderer_tpu_torch.parallel.mesh import render_sharded
    from raytracingrenderer_tpu_torch.render import sample_image
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    dev = mesh.device
    cfg = RenderConfig(max_depth=4, mis=True, jitter=True)
    nojit = RenderConfig(max_depth=4, mis=True, jitter=False)
    out = {}

    def counted(step, fn):
        before = (mt_kernel.launches, bvh_kernel.launches["closest_hit"],
                  bvh_kernel.launches["any_hit"])
        res = fn()
        out[f"{step}_launches"] = tuple(n - b for n, b in zip((
            mt_kernel.launches, bvh_kernel.launches["closest_hit"],
            bvh_kernel.launches["any_hit"]), before))
        return res

    scenes = {name: load_scene(sdir, dev) for name, sdir in (
        ("cornell", cornell_dir), ("spheres", spheres_dir))}
    for name, sc in scenes.items():
        out[name] = _np(counted(name, lambda: render_sharded(
            sc, rng.PRNGKey(3), cfg, mesh)))
    sc = load_scene(spheres_dir, dev, scene_shards=mesh.size)
    sh = sc.bvh.shards[mesh.rank]
    out["geometry"] = np.stack([_np(c) for f in (sh.triangles.p0,
                                                 sh.triangles.e1,
                                                 sh.triangles.e2)
                                for c in f], -1)
    o, d = V3(*(c.to(dev) for c in o)), V3(*(c.to(dev) for c in d))
    h = counted("traverse", lambda: ss.traverse_sharded(
        sc.bvh, o, d, torch.full((o.x.shape[0],), BIG_T, device=dev)))
    out["closest"] = [_np(a) for a in h]
    out["occluded"] = _np(counted("occluded", lambda: ss.occluded_sharded(
        sc.bvh, o, d, max_t.to(dev))))
    out["sharded_render"] = _np(counted("sharded_render", lambda: (
        sample_image(sc, rng.PRNGKey(3), cfg))))
    for name, sc in scenes.items():
        h, w = sc.camera.height, sc.camera.width
        for ov in (True, False):
            step = f"{name}_{'overlap' if ov else 'barriered'}"
            before = overlap.reductions
            g, loss = counted(step, lambda: overlap.param_grads_sharded(
                sc, torch.zeros((h, w, 3), device=dev), rng.PRNGKey(3),
                nojit, mesh, overlap=ov))
            out[step] = (float(loss), {
                k: _np(v.stacked() if hasattr(v, "stacked") else v)
                for k, v in g.items()}, overlap.reductions - before)
    cornell = scenes["cornell"]
    h, w = cornell.camera.height, cornell.camera.width
    film = counted("adaptive", lambda: adaptive_render(
        cornell, dataclasses.replace(cfg, integrator="adaptive"), 4,
        mesh=mesh))
    out["adaptive"] = (_np(film.buffer), float(film.spp))
    out["lighttrace"] = _np(counted("lighttrace", lambda: light_trace_pass(
        cornell, new_film(h, w, dev), rng.PRNGKey(7), cfg, h * w,
        mesh=mesh)).buffer)
    out["train_losses"] = []
    for _ in range(2):
        cornell, loss = overlap.train_step_overlap(
            cornell, torch.zeros((h, w, 3), device=dev), rng.PRNGKey(8),
            cfg, mesh, lr=0.5)
        out["train_losses"].append(float(loss))
    return out


JOBS = {"parallel": job_parallel, "card": job_card,
        "scene_shard": job_scene_shard,
        "empty_shards": job_empty_shards, "host_chip": job_host_chip,
        "cli": job_cli}


def _main(job: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    from raytracingrenderer_tpu_torch.parallel.distributed import (
        init_distributed)
    from raytracingrenderer_tpu_torch.parallel.mesh import make_mesh
    device, kwargs = torch.load(os.path.join(tmp, "args.pt"),
                                weights_only=False)
    init_distributed(f"file://{os.path.join(tmp, 'store')}", world, rank,
                     backend="gloo", device=device)
    out = JOBS[job](make_mesh(), **kwargs)
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
