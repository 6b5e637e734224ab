"""The kernels of csrc/visit_kernel.cu checked and timed on the card at
the probes' sizes, alone or beside another tree's revision of the source:

    python -m raytracingrenderer_tpu_torch.probes.bench_visit
        [--parent DIR ...] [--rounds N] [--out FILE]

Runs: every distinct visit run of the three probes (the seven variants;
the fp32 min visit also at TT = 512 and at 512 visits), the dot in both
precisions and the relayout loop (on normal values, values >= 2^25 and
fractions, where n_iter roundings differ from one); beside them, the
same for every tree, one PyTorch call for the same function:
`torch.matmul` of the dot's operands with allow_tf32 off and on, and
`x + float(n_iter)` on the probe's relayout input (zeros, where it
equals the loop's output).  Each
tree's kernels must equal the plain versions (fp32 bit for bit, TF32 within visit.TF32_KERNEL_BOUND of
the sum of the products' magnitudes): where this tree's do not, the
script exits 1; a `--parent` whose do not is named and left out of the
timing.  The visits
are timed by CUDA events over 20 back-to-back launches into outputs
allocated once; the dot, the relayout and the empty launch of their grid
(`visit_floor`, where the tree has that launch) and the PyTorch calls
by their device time under torch.profiler over 50 launches, in
microseconds.  The table gives each run's median over the rounds and,
in brackets, its least (`--out` keeps both and every round's number,
`samples`): device times of identical code differ by up to 5% in a
round, so compare medians.  The trees are timed in turns, the order
reversed every round.  An empty launch is timed for the kinds that the
tree's `visit_floor` has (its ops/visit.py's FLOOR_KINDS).  The card's name and power limit are printed with the
table.

`--parent DIR` (repeatable) names a checkout of another commit, for
instance `git archive <commit> | tar -x -C build/parent`: its
`raytracingrenderer_tpu_torch/csrc/visit_kernel.cu` is built beside this
tree's and launched through this tree's wrappers' signatures, so both
are timed in one call on one card.  A source with `visit_tf32` runs the
TF32 visit through it (its packed copy of the tiles made inside the
timed call, into scratch allocated once); one without, through
`visit_run`.
"""
from __future__ import annotations

import argparse
import ast
import json
import math
import os
import statistics
import sys
from pathlib import Path

import torch

from raytracingrenderer_tpu_torch.ops import visit
from raytracingrenderer_tpu_torch.ops.launch import bind, launch
from raytracingrenderer_tpu_torch.probes import (
    R, card, device_ms, inputs, probe_mxu, probe_mxu2, probe_mxu3,
    require_cuda, timed_ms, visit_args)

SOURCE = Path("raytracingrenderer_tpu_torch") / "csrc" / "visit_kernel.cu"
RELAYOUT_ITERS = 65


def visit_runs():
    """The probes' distinct visit runs -> [(name, cfg)]."""
    runs, seen = [], set()
    for mod in (probe_mxu, probe_mxu2, probe_mxu3):
        for cfg in mod.CONFIGS:
            key = tuple(cfg[k] for k in (
                "tile", "reduce", "layout", "precision", "tt", "n_visits",
                "n_tiles", "blocks"))
            if key not in seen:
                seen.add(key)
                runs.append((f"visit/{visit.variant_name(*key[:4])} "
                             f"TT={cfg['tt']} V={cfg['n_visits']} "
                             f"tiles={cfg['n_tiles']}", cfg))
    return runs


def floor_kinds(tree):
    """The kinds of a tree's `visit_floor`, in the order of its
    ops/visit.py's FLOOR_KINDS (None: this tree's; () where the tree has
    no FLOOR_KINDS)."""
    if tree is None:
        return visit.FLOOR_KINDS
    path = Path(tree) / "raytracingrenderer_tpu_torch" / "ops" / "visit.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "FLOOR_KINDS" for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    return ()


def load(tree):
    """The launchers of a tree's revision of the source (None: this
    tree's), and under "floor_kinds" the kinds of its `visit_floor`; a
    revision that lacks `visit_floor` is bound without it, and has none."""
    src = None if tree is None else Path(tree).resolve() / SOURCE
    sigs = dict(visit.SIGNATURES)
    text = "" if src is None else src.read_text()
    for name in ("visit_floor", "visit_tf32"):
        if src is not None and f'extern "C" int {name}(' not in text:
            del sigs[name]
    lib = bind("visit_kernel", sigs, src)
    lib["floor_kinds"] = floor_kinds(tree) if "visit_floor" in lib else ()
    return lib


class Case:
    """One run: its inputs, its outputs allocated once, what the plain
    version gives, and how a tree's library launches it; `floor`, the kind
    of an empty launch, which runs only on a tree that has it."""

    def __init__(self, name, call, outs, check, by_events, floor=None):
        self.name, self.call, self.outs = name, call, outs
        self.check, self.by_events, self.floor = check, by_events, floor

    def runs_on(self, lib):
        return self.floor is None or self.floor in lib["floor_kinds"]

    def time(self, lib):
        """ms by CUDA events, or device microseconds by the profiler."""
        if self.by_events:
            return timed_ms(lambda: self.call(lib), reps=20)[0]
        ms = device_ms(lambda: self.call(lib))
        return float("nan") if ms is None else ms * 1e3


def visit_case(name, cfg, dev):
    tab, feats = inputs(cfg["n_tiles"], cfg["tt"], cfg["blocks"], dev)
    kw = visit_args(cfg)
    variant = (cfg["tile"], cfg["reduce"], cfg["layout"], cfg["precision"])
    rows = visit.ROWS if cfg["reduce"] == "first8" else 1
    blocks, r = cfg["blocks"], feats.shape[1]
    t = torch.empty((blocks, rows, r), device=dev)
    o = torch.empty((blocks, 1, r), device=dev)
    tp, op = visit.visit_plain(tab, feats, **kw)
    tp, op = tp[:, :rows].contiguous(), op[:, :1].contiguous()
    scale = None
    if cfg["precision"] == "default":
        scale = visit.visit_tf32_scale(
            tab, feats, n_visits=cfg["n_visits"], n_tiles=cfg["n_tiles"],
            tile=cfg["tile"], layout=cfg["layout"])[:, :1]

    n_packed = visit.tf32_packed_tiles(cfg["n_visits"], cfg["n_tiles"])
    packed = torch.empty((n_packed * visit.K,
                          visit._width(cfg["tt"], cfg["precision"])),
                         device=dev)

    def call(lib):
        if cfg["precision"] == "default" and "visit_tf32" in lib:
            launch(lib["visit_tf32"], dev, tab.data_ptr(), packed.data_ptr(),
                   feats.data_ptr(), t.data_ptr(), o.data_ptr(), blocks, r,
                   cfg["tt"], cfg["n_tiles"], cfg["n_visits"], n_packed)
        else:
            launch(lib["visit_run"], dev, visit.VARIANTS.index(variant),
                   tab.data_ptr(), feats.data_ptr(), t.data_ptr(),
                   o.data_ptr(), blocks, r, cfg["tt"], cfg["n_tiles"],
                   cfg["n_visits"])

    def check():
        if not torch.equal(o, op):
            return "the feature sums differ"
        if scale is None:
            return None if torch.equal(t, tp) else "t differs"
        ratio = ((t - tp).abs() / scale).max().item()
        return None if ratio <= visit.TF32_KERNEL_BOUND else \
            f"|dt| reaches {ratio:.3e} of sum |a b|"

    return Case(name + " [ms]", call, (t, o), check, True)


def dot_case(prec, dev):
    a, b = probe_mxu.precision_inputs(dev)
    out = torch.empty((a.shape[1], b.shape[1]), device=dev)
    want = visit.dot_plain(a, b, prec)
    scale = visit.tf32_scale(a, b) if prec == "default" else None

    def call(lib):
        launch(lib["visit_dot"], dev, int(prec == "default"), a.data_ptr(),
               b.data_ptr(), out.data_ptr(), a.shape[1], b.shape[1])

    def check():
        if scale is None:
            return None if torch.equal(out, want) else "the dot differs"
        ratio = ((out - want).abs() / scale).max().item()
        return None if ratio <= visit.TF32_KERNEL_BOUND else \
            f"|d| reaches {ratio:.3e} of sum |a b|"

    return Case(f"dot/{prec} [us on the device]", call, (out,), check, False)


def relayout_input(shape, dev, seed=0):
    """Normal values, every seventh times 2^25 (where +1.0 rounds away)
    and every fifth plus a quarter: an input on which the loop's n_iter
    roundings differ from one addition of n_iter."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    x.view(-1)[::7] *= 2.0 ** 25
    x.view(-1)[::5] += 0.25
    return x.to(dev)


def relayout_case(dev):
    """The relayout loop on `relayout_input`, held to the plain loop."""
    x = relayout_input((probe_mxu.RELAYOUT_BLOCKS * 32, 128), dev)
    want = visit.relayout_loop_plain(x, RELAYOUT_ITERS)
    out = torch.empty_like(x)

    def call(lib):
        launch(lib["visit_relayout"], dev, x.data_ptr(), out.data_ptr(),
               x.numel(), RELAYOUT_ITERS)

    def check():
        return None if torch.equal(out, want) else "not the plain loop"

    return Case(f"relayout n={RELAYOUT_ITERS} [us on the device]", call,
                (out,), check, False)


def library_cases(dev):
    """One PyTorch call for the function of the dot (in either precision)
    and of the relayout loop at the probe's sizes: the yardsticks, the
    same whatever the tree."""
    a, b = probe_mxu.precision_inputs(dev)
    x = torch.zeros((probe_mxu.RELAYOUT_BLOCKS * 32, 128), device=dev)

    def matmul(tf32):
        def call(lib):
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                torch.matmul(a.t(), b)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
        return Case(f"torch.matmul allow_tf32={tf32} [us on the device]",
                    call, (), lambda: None, False)

    add = Case(f"x + {RELAYOUT_ITERS}.0 [us on the device]",
               lambda lib: x + float(RELAYOUT_ITERS), (), lambda: None, False)
    return [matmul(False), matmul(True), add]


def floor_cases(dev):
    """The empty launches of the dots', the relayout's and first8's
    grids, each by its index in the tree's own FLOOR_KINDS."""
    a, b = probe_mxu.precision_inputs(dev)
    n = probe_mxu.RELAYOUT_BLOCKS * 32 * 128
    sizes = {"dot/highest": (a.shape[1], b.shape[1]),
             "dot/default": (a.shape[1], b.shape[1]), "relayout": (n, 0),
             "visit/dynamic-first8-ray-highest": (R, 8)}

    def case(kind):
        def call(lib):
            launch(lib["visit_floor"], dev, lib["floor_kinds"].index(kind),
                   *sizes[kind])
        return Case(f"floor of {kind} [us on the device]", call, (),
                    lambda: None, False, floor=kind)

    return [case(k) for k in visit.FLOOR_KINDS]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout of another commit whose source is "
                         "built and timed beside (repeatable)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args()
    dev = require_cuda()
    name = card()
    trees = {"this tree": None, **{p: p for p in args.parent}}
    libs = {k: load(v) for k, v in trees.items()}
    cases = ([visit_case(n, cfg, dev) for n, cfg in visit_runs()]
             + [dot_case("highest", dev), dot_case("default", dev),
                relayout_case(dev)] + floor_cases(dev) + library_cases(dev))
    for tree, lib in list(libs.items()):
        for c in cases:
            if not c.runs_on(lib):
                continue
            for x in c.outs:
                x.fill_(float("nan"))
            c.call(lib)
            torch.cuda.synchronize()
            fault = c.check()
            if fault and tree == "this tree":
                sys.exit(f"{tree}: {c.name}: {fault} against the plain "
                         f"version")
            if fault:
                print(f"{tree}: {c.name}: {fault} against the plain "
                      f"version; left out", flush=True)
                del libs[tree]
                break
    print(f"every kernel of {list(libs)} agrees with its plain version",
          flush=True)
    samples = {c.name: {t: [] for t in libs} for c in cases}
    for rnd in range(args.rounds):
        order = list(libs)[::-1] if rnd % 2 else list(libs)
        for c in cases:
            for tree in order:
                if not c.runs_on(libs[tree]):
                    continue
                ms = c.time(libs[tree])
                if not math.isnan(ms):
                    samples[c.name][tree].append(ms)
    nan = float("nan")
    medians = {c: {t: statistics.median(v) if v else nan
                   for t, v in per.items()} for c, per in samples.items()}
    least = {c: {t: min(v, default=nan) for t, v in per.items()}
             for c, per in samples.items()}
    print(f"the median [least] of {args.rounds} rounds [{name}]")
    width = max(len(c.name) for c in cases)
    print(" " * width + "  " + "  ".join(f"{t[-24:]:>24}" for t in libs))
    for c in cases:
        print(f"{c.name:<{width}}  " + "  ".join(
            f"{medians[c.name][t]:>13.4f} [{least[c.name][t]:.4f}]"
            for t in libs), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": name, "rounds": args.rounds,
                       "medians": medians, "least": least,
                       "samples": samples}, f, indent=1)


if __name__ == "__main__":
    main()
