"""The benchmark's data-driven plumbing: BENCHMARK.json, and the files a
cell is made of, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix.  The
configuration's file is the entry's `file`; the mix is
`rtbench/mixes/<traffic>.json`, whose `kind` names the driver
`rtbench/kinds/<kind>.py`; each per-layer metric is read by
`rtbench/metrics/<name>.py`, or, where there is no such file, by the
reader of the name's first part (`metrics/idle_pct.py` reads
`idle_pct.render` and `idle_pct.train`); a configuration's scene writer is
`rtbench/scenes/<writer>.py`.  A new configuration, mix, kind or metric
is a new file and a new entry: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names that may not be loaded in a benchmark run: JAX
# and the JAX package the renderer was ported from (compared whole:
# raytracingrenderer_tpu_torch is the renderer under test)
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingrenderer_tpu")


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in man['workloads']]}")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, with its manifest entry under `entry`."""
    for c in man["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                out = json.load(f)
            out["entry"] = c
            return out
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(traffic: str, bench: Path = BENCH) -> dict:
    with open(bench / "mixes" / f"{traffic}.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in the file `path` (names may hold dots or dashes)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, bench: Path = BENCH):
    return load_module(bench / "kinds" / f"{name}.py", f"rtbench_kind_{name}")


def metric_reader(name: str, bench: Path = BENCH):
    """The reader of a per-layer metric: metrics/<name>.py, else the file
    of the name's part before its first dot (one reader for a quantity
    split by the end-to-end metric it moves)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        path = bench / "metrics" / f"{name.split('.', 1)[0]}.py"
    return load_module(path, "rtbench_metric_" + name.replace(".", "_"))


def writer(name: str, bench: Path = BENCH):
    return load_module(bench / "scenes" / f"{name}.py",
                       f"rtbench_scene_{name}")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(man: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if applies(m, cell_name)]


def read_per_layer(man: dict, cell_name: str, record: dict,
                   bench: Path = BENCH) -> Dict[str, dict]:
    """{name: {value, unit}} of every per-layer metric of the cell whose
    reader finds something in `record` (a reader returns None where it
    has nothing to read, and the metric is left out)."""
    out = {}
    for m in cell_metrics(man, cell_name, True):
        value = metric_reader(m["name"], bench).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The top-level names of loaded modules that are FORBIDDEN, each
    compared whole (`raytracingrenderer_tpu_torch` is not
    `raytracingrenderer_tpu`)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN))


def p90(values: List[float]) -> float:
    """The 90th percentile (statistics.quantiles, exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=10)[8]

