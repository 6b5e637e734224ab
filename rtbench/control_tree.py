"""control.py's training readings for the cells whose reference walks
its tree (kind train_tree), and two faults planted in the renderer's
geometry update, which only such cells reach.

    python3 rtbench/control_tree.py --workload <cell> --seeds 11,12,13 \\
        [--variants lowp,half,altered,skipped_refit,stale_tables] \\
        [--seconds 5] [--device cuda] [--out FILE]

"lowp", "half" and "altered" are control.py's, computed with
`reference.tree.installed()`.  The two faults run the cell itself
(run.execute, a window of `--seconds`) with the renderer broken
underneath, and read its checks: "skipped_refit", geometry.refit.refit
returning the scene as it was; "stale_tables", BVH.cached serving the
first table built under a key for ever (the kernels' packed tables and
the proxy pre-pass's triangles never made again after tri_p0 moved).
Prints one JSON line a seed and variant; not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rtbench import control, harness  # noqa: E402

FAULTS = ("skipped_refit", "stale_tables")


def planted(fault: str):
    """Plant `fault` in the renderer; returns the function undoing it."""
    from raytracingrenderer_tpu_torch.geometry import refit as refit_mod
    from raytracingrenderer_tpu_torch.scene import types
    if fault == "skipped_refit":
        was, owner, name = refit_mod.refit, refit_mod, "refit"
        new = lambda scene: scene  # noqa: E731
    else:
        was, owner, name = types.BVH.cached, types.BVH, "cached"
        kept = {}

        def new(self, key, deps, build):
            if key not in kept:
                kept[key] = build()
            return kept[key]
    setattr(owner, name, new)
    return lambda: setattr(owner, name, was)


def fault_readings(cell: str, seed: int, fault: str, seconds: float,
                   device: str) -> dict:
    from rtbench import run
    undo = planted(fault)
    try:
        args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                                  trace=0)
        out = run.execute(args, device, time.perf_counter())
    finally:
        undo()
    return {k: c["value"] for k, c in out["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="lowp,half,altered")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="the window of a run with a planted fault")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from rtbench.reference import tree
    man = harness.manifest()
    cell = harness.cell(man, args.workload)
    conf = harness.config(man, cell["config"])
    mix = harness.mix(cell["traffic"])
    variants = args.variants.split(",")
    ref_variants = [v for v in variants if v not in FAULTS]
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = {}
        if ref_variants:
            with tree.installed():
                got = control.train_readings(conf, mix, seed, ref_variants,
                                             args.device)
        for v in variants:
            if v in FAULTS:
                got[v] = fault_readings(cell["name"], seed, v, args.seconds,
                                        args.device)
        line = {"workload": cell["name"], "seed": seed, "readings": got,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
