"""The binary BVH walk (B2, csrc/bvh_kernel.cu), and with `--wide` the
4-wide one (B3), checked and timed on the card at the render's shapes,
alone or beside other commits':

    python -m raytracingrenderer_tpu_torch.probes.bench_b2 --scene DIR
        [--wide] [--parent DIR ...] [--rounds N] [--out FILE]

`--scene` is a scene directory the loader reads; the recorded runs use
the 327,716-triangle spheres scene at 1024 x 1024
(`tests/torch_scenes.py`: `write_spheres(DIR, subdiv=5)`).  Batches: 2^20
random live rays (closest-hit, any-hit over constant-form leaves, any-hit
over raw leaves) and every B2 launch of one sample pass of the render
(coherence-sorted, narrowing: the main path's shapes), closest-hit and
any-hit, the any-hit ones over both leaf forms.  `--wide` adds B3 on the
2^20 random rays and on the pass's bounce and shadow launches (every
launch but the primary closest-hit one, as
tests/test_torch_cuda.py::test_bvh_scale_walks_match_plain feeds it), and B2 on the same bounce launches ("pass bounce"; its shadow
launches are the "pass any" sets).  Each kernel must equal
`traverse_plain` bit for bit on every batch, or the script exits 1.
Times are CUDA events over back-to-back calls of `traverse_packet`, the
least of the rounds.  The card's name and power limit are printed with
the table.

`--parent DIR` (repeatable) names a checkout of another commit (for
instance `git archive <commit> | tar -x -C build/parent`), or a copy of
this tree with another revision of csrc/bvh_kernel.cu (a candidate
design): a process of its own, started there before and after this
tree's rounds, builds that tree's kernel, makes the same batches through
that tree's render and times that tree's `traverse_packet` on them (a
row named by the directory), so that the commits are timed in one call
on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from raytracingrenderer_tpu_torch.probes import card, require_cuda, timed_ms

N_RANDOM = 1 << 20
CFG = dict(mis=True, jitter=True, max_depth=4)


def random_rays(n: int, seed: int):
    """n live rays from inside the box -> (o, d, t_closest, t_any)."""
    from raytracingrenderer_tpu_torch.core.vec import V3
    g = np.random.default_rng(seed)
    o = (g.uniform(-1, 1, (n, 3)) * 0.5 + [0, 1, 0.5]).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = g.uniform(0.05, 2.5, n).astype(np.float32)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return (V3(*(cu(o[:, i]) for i in range(3))),
            V3(*(cu(d[:, i]) for i in range(3))),
            torch.full((n,), 3.4e38, device="cuda"), cu(max_t))


def render_batches(scene):
    """The inputs of every B2 launch of one sample pass of the render
    -> [(any_hit, o, d, t_init)]."""
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.ops import bvh_kernel
    from raytracingrenderer_tpu_torch.render import render
    real = bvh_kernel.traverse_packet
    kept = []

    def keep(bvh, tris, o, d, t_init, any_hit=False, leaf16=None, wide=None):
        if o.x.shape[0]:
            kept.append((any_hit, V3(*(c.clone() for c in o)),
                         V3(*(c.clone() for c in d)), t_init.clone()))
        return real(bvh, tris, o, d, t_init, any_hit, leaf16, wide)

    bvh_kernel.traverse_packet = keep
    try:
        render(scene, RenderConfig(**CFG), spp=1)
    finally:
        bvh_kernel.traverse_packet = real
    torch.cuda.synchronize()
    return kept


def scene_and_sets(scene_dir: str, wide: bool = False):
    """The scene on the card and the batch sets: name -> [(any_hit,
    leaf16, wide, o, d, t_init)]; a set's time is the sum over its
    batches.  With `wide`, B3's sets and B2 on the pass's bounce
    launches."""
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    scene = load_scene(scene_dir, device="cuda")
    o, d, t_closest, t_any = random_rays(N_RANDOM, seed=5)
    passes = render_batches(scene)
    sets = {
        "random closest": [(False, None, False, o, d, t_closest)],
        "random any const": [(True, True, False, o, d, t_any)],
        "random any raw": [(True, False, False, o, d, t_any)],
        "pass closest": [(False, None, False, *b[1:])
                         for b in passes if not b[0]],
        "pass any const": [(True, True, False, *b[1:])
                           for b in passes if b[0]],
        "pass any raw": [(True, False, False, *b[1:])
                         for b in passes if b[0]],
    }
    if wide:
        bounce = [b for b in passes if not b[0]][1:]
        sets.update({
            "pass bounce closest": [(False, None, False, *b[1:])
                                    for b in bounce],
            "wide random closest": [(False, None, True, o, d, t_closest)],
            "wide random any": [(True, None, True, o, d, t_any)],
            "wide pass closest": [(False, None, True, *b[1:])
                                  for b in bounce],
            "wide pass any": [(True, None, True, *b[1:])
                              for b in passes if b[0]],
        })
    return scene, sets


def time_tree(scene_dir: str, rounds: int, out: str = None,
              wide: bool = False) -> dict:
    """Check the importable tree's `traverse_packet` against its
    `traverse_plain` on every batch, bit for bit, then time it on the
    batch sets -> {set: ms}, the least of `rounds` rounds of 10 calls;
    written to `out` as JSON where given (what the process that
    `--parent` starts does).  Uses nothing of the tree beyond its loader,
    its render and the two walks' signature."""
    require_cuda()
    from raytracingrenderer_tpu_torch.ops import bvh_kernel
    scene, sets = scene_and_sets(scene_dir, wide)

    def walk(fn, batch):
        any_hit, leaf16, is_wide, bo, bd, bt = batch
        return fn(scene.bvh, scene.triangles, bo, bd, bt, any_hit=any_hit,
                  leaf16=leaf16, wide=is_wide)

    for s, batches in sets.items():
        for b in batches:
            got = walk(bvh_kernel.traverse_packet, b)
            want = walk(bvh_kernel.traverse_plain, b)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                sys.exit(f"the kernel differs from traverse_plain on '{s}' "
                         f"({int(b[-1].shape[0])} rays)")
    times = {s: float("inf") for s in sets}
    for _ in range(rounds):
        for s, batches in sets.items():
            ms, _ = timed_ms(lambda: [walk(bvh_kernel.traverse_packet, b)
                                      for b in batches], reps=10)
            times[s] = min(times[s], ms)
    if out:
        with open(out, "w") as f:
            json.dump(times, f)
    return times


def time_parent(tree: str, scene_dir: str, rounds: int,
                wide: bool = False) -> dict:
    """`time_tree` in a process started in `tree`, whose package it
    imports; this file is loaded there by path."""
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    code = ("import importlib.util, sys; "
            "spec = importlib.util.spec_from_file_location('bench_b2', "
            "sys.argv[1]); m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); m.time_tree(sys.argv[2], "
            "int(sys.argv[3]), sys.argv[4], sys.argv[5] == '1')")
    subprocess.run([sys.executable, "-c", code, os.path.abspath(__file__),
                    os.path.abspath(scene_dir), str(rounds), out,
                    str(int(wide))], cwd=tree, check=True)
    with open(out) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", required=True, help="the scene's directory")
    ap.add_argument("--out", default=None, help="write the table as JSON")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--wide", action="store_true",
                    help="also check and time the 4-wide walk (B3)")
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout of another commit to time beside "
                         "(repeatable)")
    args = ap.parse_args()
    require_cuda()
    name = card()
    runs = {p: [] for p in args.parent}
    for p in args.parent:     # the parents, this tree, the parents
        runs[p].append(time_parent(p, args.scene, args.rounds, args.wide))
    this = time_tree(args.scene, args.rounds, wide=args.wide)
    for p in reversed(args.parent):
        runs[p].append(time_parent(p, args.scene, args.rounds, args.wide))
    rows = {}
    for p, got in runs.items():
        print(f"{p}, before and after: {got}", flush=True)
        rows[os.path.basename(os.path.normpath(p))] = {
            s: min(g[s] for g in got) for s in got[0]}
    rows["this tree"] = this
    cols = list(this)
    width = max(9, *(len(k) for k in rows))
    print(f"ms, the least of {args.rounds} rounds of 10 calls, each equal to "
          f"traverse_plain bit for bit [{name}]")
    print(" " * width + "  " + "  ".join(f"{c:>19}" for c in cols)
          + f"  {'pass c+a const':>19}")
    for k, t in rows.items():
        print(f"{k:<{width}}  " + "  ".join(f"{t[c]:19.4f}" for c in cols)
              + f"  {t['pass closest'] + t['pass any const']:19.4f}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": name, "rounds": args.rounds, "ms": rows}, f,
                      indent=1)


if __name__ == "__main__":
    main()
