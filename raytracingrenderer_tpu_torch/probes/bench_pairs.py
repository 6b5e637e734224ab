"""The treelet pair test (B4, csrc/treelet_kernel.cu) and the brute-force
Moller-Trumbore kernel (B1, csrc/mt_kernel.cu) checked and timed on the
card at the render paths' shapes, alone or beside another tree's
revisions of the two sources:

    python -m raytracingrenderer_tpu_torch.probes.bench_pairs
        [--parent DIR ...] [--fma] [--rounds N] [--out FILE]

Runs.  B4: the inputs of every `pair_test` call of one 1024 x 1024 sample
pass of the treelet render of the 327,716-triangle spheres scene (the
pass's sum, and its first call alone: the primary closest-hit call at
full width).  B1: 2^20 random live rays against the cornell box's 36
triangles and against 128 and 4096 random ones (closest-hit); the inputs
of every `mt_kernel.intersect` call of one cornell sample pass (coherent
rays at full width) and of the any-hit proxy pre-pass of one wavefront
pass of the spheres render (128 triangles, narrowing widths).  The scenes
are written by tests/torch_scenes.py into a temporary directory.

Each tree's kernels must equal `pair_test_plain` (t, col) and
`intersect_plain` (t, tri, u, v) bit for bit on every run, or the script
exits 1.  Times are CUDA events over back-to-back launches into outputs
allocated once, the least of the rounds; the trees are timed in turns,
the order reversed every round.  The card's name and power limit are
printed with the table.

`--parent DIR` (repeatable) names a checkout of another commit, for
instance `git archive <commit> | tar -x -C build/parent`: its
`raytracingrenderer_tpu_torch/csrc/treelet_kernel.cu` and `mt_kernel.cu`
are built beside this tree's and launched with this tree's inputs (the
triangle rows in the width that source reads), so all are timed in one
call on one card.  A candidate design is a copy of a source under such a
tree.  `--fma` also builds this tree's two sources with FMA contraction
allowed (the shipped build forbids it), times them, and prints how many
pairs or rays then differ from the plain versions instead of failing.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from raytracingrenderer_tpu_torch.ops import build, mt_kernel, treelet
from raytracingrenderer_tpu_torch.ops.launch import I32, PTR, bind, launch
from raytracingrenderer_tpu_torch.probes import (card, capture_pass,
                                                 require_cuda, timed_ms)
from raytracingrenderer_tpu_torch.probes.bench_b2 import CFG, random_rays

ROOT = Path(__file__).resolve().parents[2]
CSRC = Path("raytracingrenderer_tpu_torch") / "csrc"
N_RANDOM = 1 << 20
FMA = "this tree, FMA allowed"
SIGNATURES = {
    "treelet_kernel": {"treelet_pair_test": [PTR] * 5 + [I32] * 2},
    "mt_kernel": {"mt_intersect": [PTR, I32] + [PTR] * 11 + [I32]},
}


def scene_writer():
    """tests/torch_scenes.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "torch_scenes", ROOT / "tests" / "torch_scenes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_tris(n_tri: int, seed: int):
    """A soup of n_tri triangles around the cornell box's frame."""
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.scene.types import Triangles
    g = np.random.default_rng(seed)

    def v3(a):
        return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).cuda()
                    for i in range(3)))

    p0 = v3((g.uniform(-1, 1, (n_tri, 3)) + [0, 1, 0]).astype(np.float32))
    e1 = v3((g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32))
    e2 = v3((g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32))
    z = torch.zeros(n_tri, device="cuda")
    zi = torch.zeros(n_tri, dtype=torch.int32, device="cuda")
    uv = torch.zeros((n_tri, 2), device="cuda")
    return Triangles(p0=p0, e1=e1, e2=e2, gn=e1, n0=e1, n1=e1, n2=e1,
                     uv0=uv, uv1=uv, uv2=uv, area=z + 1.0, mat_id=zi,
                     light_id=zi - 1)


def mt_calls(scene):
    """The inputs of every `mt_kernel.intersect` call of one sample pass
    -> [(tris, o, d, t_init)]."""
    from raytracingrenderer_tpu_torch.core.vec import V3
    kept = []

    def keep(tris, o, d, t_init):
        if o.x.shape[0]:
            kept.append((tris, V3(*(c.clone() for c in o)),
                         V3(*(c.clone() for c in d)), t_init.clone()))

    capture_pass(scene, [(mt_kernel, "intersect", keep)], **CFG)
    return kept


def pair_calls(scene):
    """The inputs of every `treelet.pair_test` call of one sample pass
    -> [(consts, feats, tid)]."""
    kept = []
    capture_pass(scene, [(treelet, "pair_test", lambda consts, feats, tid:
                          kept.append((consts, feats.clone(), tid.clone())))],
                 **CFG)
    return kept


def rows_of(tris, width: int) -> torch.Tensor:
    """(T, width) triangle rows [p0 e1 e2] (9 floats), zero-padded."""
    rows = torch.stack([tris.p0.x, tris.p0.y, tris.p0.z,
                        tris.e1.x, tris.e1.y, tris.e1.z,
                        tris.e2.x, tris.e2.y, tris.e2.z], dim=-1)
    pad = torch.zeros((rows.shape[0], width - 9), device=rows.device)
    return torch.cat([rows, pad], dim=1).contiguous()


class Tree:
    """A tree's two libraries and the width of the rows its B1 reads."""

    def __init__(self, label, root, flags=None):
        self.label = label
        self.fma = flags is not None
        self.lib = {}
        for name, sigs in SIGNATURES.items():
            src = None if root is None else Path(root).resolve() / CSRC / \
                f"{name}.cu"
            self.lib.update(bind(name, sigs, src, flags))
        text = ((ROOT if root is None else Path(root).resolve()) / CSRC /
                "mt_kernel.cu").read_text()
        m = re.search(r"kRowFloats\s*=\s*(\d+)", text)
        self.row_width = int(m.group(1)) if m else 9


class PairCase:
    """pair_test calls launched back to back into outputs allocated once."""

    def __init__(self, name, calls):
        self.name = name
        self.calls = calls
        self.outs = [(torch.empty(c[2].shape[0], device="cuda"),
                      torch.empty(c[2].shape[0], dtype=torch.int32,
                                  device="cuda")) for c in calls]
        self.want = [treelet.pair_test_plain(*c) for c in calls]
        self.size = sum(int(c[2].shape[0]) for c in calls)

    def run(self, tree):
        for (consts, feats, tid), (t, col) in zip(self.calls, self.outs):
            launch(tree.lib["treelet_pair_test"], consts.device,
                   consts.data_ptr(), feats.data_ptr(), tid.data_ptr(),
                   t.data_ptr(), col.data_ptr(), tid.shape[0],
                   consts.shape[0] // 16)

    def differing(self):
        return sum(int(((t != wt) | (col != wc)).sum())
                   for (t, col), (wt, wc) in zip(self.outs, self.want))


class MtCase:
    """mt_intersect launches back to back into outputs allocated once."""

    def __init__(self, name, calls):
        self.name = name
        self.calls = calls
        self.rows = {}
        self.outs = []
        for _, o, _, _ in calls:
            n = o.x.shape[0]
            self.outs.append(tuple(
                torch.empty(n, dtype=dt, device="cuda") for dt in
                (torch.float32, torch.int32, torch.float32, torch.float32)))
        self.want = [mt_kernel.intersect_plain(*c) for c in calls]
        self.size = sum(int(c[1].x.shape[0]) for c in calls)

    def run(self, tree):
        for (tris, o, d, t_init), outs in zip(self.calls, self.outs):
            key = (id(tris), tree.row_width)
            if key not in self.rows:
                self.rows[key] = rows_of(tris, tree.row_width)
            rows = self.rows[key]
            launch(tree.lib["mt_intersect"], rows.device, rows.data_ptr(),
                   rows.shape[0], o.x.data_ptr(), o.y.data_ptr(),
                   o.z.data_ptr(), d.x.data_ptr(), d.y.data_ptr(),
                   d.z.data_ptr(), t_init.data_ptr(),
                   *(x.data_ptr() for x in outs), o.x.shape[0])

    def differing(self):
        bad = 0
        for outs, want in zip(self.outs, self.want):
            ne = outs[0] != want.t
            for got, w in zip(outs[1:], (want.tri, want.u, want.v)):
                ne = ne | (got != w)
            bad += int(ne.sum())
        return bad


def cases():
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    scenes = scene_writer()
    tmp = tempfile.mkdtemp(prefix="bench_pairs_")
    cornell = load_scene(scenes.write_cornell(os.path.join(tmp, "cornell")),
                         device="cuda")
    spheres = load_scene(scenes.write_spheres(os.path.join(tmp, "spheres"),
                                              subdiv=5), device="cuda")
    tspheres = spheres._replace(bvh=treelet.attach_treelets(spheres.bvh))
    pairs = pair_calls(tspheres)
    o, d, t_closest, _ = random_rays(N_RANDOM, seed=1)
    out = [PairCase(f"B4 first call ({pairs[0][2].shape[0]} pairs)",
                    pairs[:1]),
           PairCase(f"B4 pass ({len(pairs)} calls)", pairs)]
    out[1].name += f", {out[1].size} pairs"
    for tris in (cornell.triangles, random_tris(128, 2),
                 random_tris(4096, 3)):
        out.append(MtCase(f"B1 2^20 random rays x {tris.count}",
                          [(tris, o, d, t_closest)]))
    for name, scene in (("cornell pass", cornell),
                        ("spheres pre-pass", spheres)):
        calls = mt_calls(scene)
        out.append(MtCase(
            f"B1 {name} ({len(calls)} launches x {calls[0][0].count}, widths "
            f"{calls[0][1].x.shape[0]}..{calls[-1][1].x.shape[0]})", calls))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout of another commit whose sources are "
                         "built and timed beside (repeatable)")
    ap.add_argument("--fma", action="store_true",
                    help="also time this tree's sources built with FMA "
                         "allowed, and count what then differs")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args()
    require_cuda()
    name = card()
    trees = [Tree("this tree", None)] + [Tree(p, p) for p in args.parent]
    if args.fma:
        trees.append(Tree(FMA, None, tuple(
            f for f in build.NVCC_FLAGS if f != "--fmad=false")))
    for key, (secs, out) in build.build_log.items():
        print(f"nvcc {key}: {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print(f"  {line.strip()}")
    all_cases = cases()
    differing = {}
    for tree in trees:
        for c in all_cases:
            for outs in c.outs:
                for x in outs:
                    x.fill_(-7)
            c.run(tree)
            torch.cuda.synchronize()
            bad = c.differing()
            if bad and not tree.fma:
                sys.exit(f"{tree.label}: {c.name}: {bad} of {c.size} differ "
                         f"from the plain version (bit for bit expected)")
            differing.setdefault(c.name, {})[tree.label] = bad
    print(f"every kernel of {[t.label for t in trees if not t.fma]} equals "
          f"its plain version bit for bit", flush=True)
    times = {c.name: {t.label: float("inf") for t in trees}
             for c in all_cases}
    for rnd in range(args.rounds):
        for c in all_cases:
            for tree in (trees[::-1] if rnd % 2 else trees):
                ms = timed_ms(lambda: c.run(tree), reps=10)[0]
                times[c.name][tree.label] = min(times[c.name][tree.label],
                                                ms)
    print(f"ms, the least of {args.rounds} rounds of 10 [{name}]")
    width = max(len(c.name) for c in all_cases)
    print(" " * width + "  " + "  ".join(f"{t.label[-24:]:>24}"
                                         for t in trees))
    for c in all_cases:
        print(f"{c.name:<{width}}  " + "  ".join(
            f"{times[c.name][t.label]:24.4f}" for t in trees), flush=True)
    if args.fma:
        print("built with FMA allowed, differing from the plain version: "
              + "; ".join(f"{c.name}: {differing[c.name][FMA]} of {c.size}"
                          for c in all_cases), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": name, "rounds": args.rounds, "ms": times,
                       "differing": differing}, f, indent=1)


if __name__ == "__main__":
    main()
