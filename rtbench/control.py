"""The readings a cell's limits are set from, beside the benchmark's own
runs: the control (the reference computed in bfloat16, put in the
renderer's place) and, for train cells, the planted faults, each
compared with the float32 reference at the cell's own size.

    python3 rtbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--variants lowp,half,altered] [--out FILE]

Render cells compare, for the band and passes a run of that seed would
check (out of `--passes` completed), the control's images with the
reference's; train cells the control's or a fault's first steps with the
reference's.  "half": the loss's mean over the first half of the rows;
"altered": albedo's gradient scaled by 1.1 where it is produced.  (A
state left unchanged reads 1 by the train numbers' measure and needs no
run.)  Prints one JSON line a seed and variant; not part of a benchmark
run.
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

from rtbench import harness, inputs  # noqa: E402


def render_readings(conf, mix, seed, variants, passes, device):
    from rtbench.reference import compare, precision
    sdir = inputs.scene_dir(conf, int(mix["width"]), int(mix["height"]))
    rows = int(mix["band_rows"])
    r0 = inputs.band(seed, int(mix["height"]), rows)
    checked = inputs.checked_passes(seed, passes, int(mix["check_passes"]))
    cfg = compare.ref_config(conf["render_config"], inputs.seed32(seed))
    ref = compare.reference_bands(compare.ref_scene(sdir, device), cfg,
                                  seed, checked, (r0, r0 + rows))
    if "lowp" not in variants:      # a render cell's faults are the tests'
        return {}
    scene = compare.ref_scene(sdir, device, lowp=True)
    ctl = compare.reference_bands(scene, cfg, seed, checked, (r0, r0 + rows),
                                  precision.round_bf16)
    off = sum(compare.pixels_off(a, b) for a, b in zip(ctl, ref))
    total = sum(b.shape[0] * b.shape[1] for b in ref)
    return {"lowp": {"px_off_pct": 100.0 * off / total}}


def train_readings(conf, mix, seed, variants, device):
    from rtbench.reference import compare
    sdir = inputs.scene_dir(conf, int(mix["width"]), int(mix["height"]))
    steps = int(mix["check_steps"])
    lr = float(mix["lr"])
    ref = compare.follow_training(sdir, conf["render_config"], mix, seed,
                                  steps, device)
    out = {}
    for v in variants:
        got = compare.follow_training(
            sdir, conf["render_config"], mix, seed, steps, device,
            lowp=(v == "lowp"), fault=None if v == "lowp" else v,
            target=None if v == "lowp" else ref["target"])
        out[v] = compare.train_numbers(got, ref, lr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="lowp,half,altered")
    ap.add_argument("--passes", type=int, default=100,
                    help="render cells: passes a run is taken to complete")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    man = harness.manifest()
    cell = harness.cell(man, args.workload)
    conf = harness.config(man, cell["config"])
    mix = harness.mix(cell["traffic"])
    variants = args.variants.split(",")
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if mix["kind"] == "render":
            got = render_readings(conf, mix, seed, variants, args.passes,
                                  args.device)
        else:
            got = train_readings(conf, mix, seed, variants, args.device)
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
