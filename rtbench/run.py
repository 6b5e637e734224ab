"""The benchmark of raytracingrenderer_tpu_torch on NVIDIA GPUs.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: one process sets the cell up, measures
for `--seconds`, checks what the window produced against the plain
reference (rtbench/reference/) and prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`, each number
compared beside its limit (also the last lines on standard error).

It exits non-zero, and prints no result, without a CUDA device or with
fewer than the cell asks for, and when a module of JAX or of the JAX
package is loaded once the window has closed.  Every build and cache of
the run stays inside the checkout (build/), or under HOME and TMPDIR.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rtbench import harness  # noqa: E402


class Run:
    """One run's arguments, inputs and device hooks, handed to the kind."""

    def __init__(self, torch, args, cell: dict, config: dict, mix: dict,
                 device: str, t_start: float):
        self.torch = torch
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.cell, self.config, self.mix = cell, config, mix
        self.device = device
        self.t_start = t_start
        self.cuda = device.startswith("cuda")

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def memory_peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def log(self, msg: str):
        """A progress line on standard error, with the run's seconds."""
        print(f"rtbench [{time.perf_counter() - self.t_start:8.2f} s] {msg}",
              file=sys.stderr, flush=True)

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def limits(cell_name: str) -> dict:
    with open(harness.BENCH / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def execute(args, device: str, t_start: float, mix_over: dict = None):
    """Set up, measure and check one run of the cell -> the result dict
    (without `device`).  The kind's functions run on `device`; tests pass
    "cpu" and smaller sizes in `mix_over`."""
    import torch
    man = harness.manifest()
    cell = harness.cell(man, args.workload)
    conf = harness.config(man, cell["config"])
    mix = dict(harness.mix(cell["traffic"]), **(mix_over or {}))
    ctx = Run(torch, args, cell, conf, mix, device, t_start)
    res = harness.kind(mix["kind"]).run(ctx)
    lim = limits(cell["name"])
    checks = {k: {"value": float(v), "limit": float(lim[k])}
              for k, v in res["checks"].items()}
    correct = (res["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    if ctx.trace:
        metrics = harness.read_per_layer(man, cell["name"], res["record"])
    else:
        units = {m["name"]: m["unit"]
                 for m in harness.cell_metrics(man, cell["name"], False)}
        values = dict(res["e2e"], setup_s=res["setup_s"])
        metrics = {k: {"value": float(values[k]), "unit": u}
                   for k, u in units.items()}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if ctx.trace:
        rec = res["record"]
        out["busy_s"], out["window_s"] = rec["busy_s"], rec["window_s"]
        out["breakdown"] = {"device_ops": rec["device_ops"],
                            "idle_gaps": rec["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch
    man = harness.manifest()
    chips = int(harness.cell(man, args.workload)["chips"])
    if not torch.cuda.is_available():
        print("rtbench: torch.cuda.is_available() is false; the benchmark "
              "measures the GPU and has no CPU fall-back", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = execute(args, "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"rtbench: modules of {bad} are loaded; the benchmark runs "
              f"the PyTorch port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": out.pop("memory_peak_bytes")}
    for k in ("busy_s", "window_s"):
        if k in out:
            device[k] = out.pop(k)
    checks = out.pop("checks")
    line = dict(out, device=device, checks=checks)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
