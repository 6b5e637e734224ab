"""The matrix-unit probes on the card: counterparts of
scripts/probe_mxu.py, scripts/probe_mxu2.py and scripts/probe_mxu3.py,
which timed the K = 16 contraction under B4's pair test on the TPU.
Each drives the kernels of csrc/visit_kernel.cu (through ops/visit.py)
with the scripts' inputs, sizes and sequence of runs, and prints the
scripts' lines with the card's name and power limit:

    python -m raytracingrenderer_tpu_torch.probes.probe_mxu
    python -m raytracingrenderer_tpu_torch.probes.probe_mxu2
    python -m raytracingrenderer_tpu_torch.probes.probe_mxu3

They run on "cuda" and exit non-zero without a card.  Times are CUDA
events over repeated launches after a warm-up; the TFLOP/s keep the
scripts' count, visits * 2 * 16 * TT * R.

Each module lists its visit runs in CONFIGS (dicts of `visit`'s
arguments, sizes included), which `bench_visit` and the card tests
(tests/test_torch_cuda.py) also read.

Beside them, each checking a kernel source and timing it beside another
commit's in one call: `bench_b2` (B2, B3), `bench_pairs` (B1, B4),
`bench_visit` (P1-P3) and `bench_gather_rng` (G1, R1); and
`trace_spans` (a pass and a training step by the program's spans).
"""
from __future__ import annotations

import subprocess
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

R = 4096            # rays per block, as the scripts' R
MT_EPI_OPS = 15     # FP32 operations of the visit's MT epilogue a triangle


def require_cuda() -> torch.device:
    """The card, or exit with status 1: the probes measure the card and
    have no CPU fall-back."""
    if not torch.cuda.is_available():
        print("the probes need an NVIDIA GPU: torch.cuda.is_available() is "
              "false", file=sys.stderr, flush=True)
        sys.exit(1)
    return torch.device("cuda")


def card() -> str:
    """nvidia-smi's "name, power.limit" of device 0."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def timed_ms(fn: Callable, reps: int = 20):
    """fn() once to warm up, then `reps` calls between two CUDA events
    -> (ms per call, the last result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def capture_pass(scene, wrapped, **cfg) -> None:
    """One 1-spp sample pass of `render(scene, RenderConfig(**cfg))` with
    wrappers' functions watched: `wrapped` is [(module, name, keep)], and
    `keep(*args, **kwargs)` sees each call of `module.name` made during
    the pass before the function itself runs (to copy the inputs the
    main path gives a kernel)."""
    from ..config import RenderConfig
    from ..render import render
    real = [(mod, name, getattr(mod, name)) for mod, name, _ in wrapped]

    def watch(fn, keep):
        def call(*args, **kwargs):
            keep(*args, **kwargs)
            return fn(*args, **kwargs)
        return call

    for (mod, name, fn), (_, _, keep) in zip(real, wrapped):
        setattr(mod, name, watch(fn, keep))
    try:
        render(scene, RenderConfig(**cfg), spp=1)
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def inputs(n_tiles: int, tt: int, blocks: int, device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scripts' table (seed 0, (n_tiles * 16, tt)) and features
    (seed 1, (blocks * 16, R)), standard normal f32."""
    tab = np.random.default_rng(0).normal(size=(n_tiles * 16, tt))
    feats = np.random.default_rng(1).normal(size=(blocks * 16, R))
    return (torch.from_numpy(tab.astype(np.float32)).to(device),
            torch.from_numpy(feats.astype(np.float32)).to(device))


def visit_args(cfg: Dict) -> Dict:
    """`visit`'s keyword arguments of a CONFIGS entry."""
    return {k: cfg[k] for k in ("n_visits", "n_tiles", "tile", "reduce",
                                "layout", "precision")}


def config(tt: int, n_visits: int, n_tiles: int, blocks: int = 8,
           tile: str = "dynamic", reduce: str = "min", layout: str = "ray",
           precision: str = "highest", **extra) -> Dict:
    return dict(tt=tt, n_visits=n_visits, n_tiles=n_tiles, blocks=blocks,
                tile=tile, reduce=reduce, layout=layout,
                precision=precision, **extra)


def flops(cfg: Dict) -> int:
    """The scripts' FLOP count of a run: visits * 2 * 16 * TT * R."""
    return cfg["blocks"] * cfg["n_visits"] * 2 * 16 * cfg["tt"] * R


def visit_work(cfg: Dict) -> Dict[str, int]:
    """What a visit run needs, from its shapes: `mac`, the contraction's
    operations (per ray and step a multiply and an add for each of the
    16 features of each column); `other`, one min a column, or the MT
    epilogue's MT_EPI_OPS a triangle; `bytes`, the distinct tiles
    visited, the features and the rows written, each once.  Built
    without FMA, a fp32 kernel issues mac + other FP32 instructions."""
    from ..ops import visit
    tt, blocks = cfg["tt"], cfg["blocks"]
    steps = visit.tile_steps(cfg["n_visits"], cfg["n_tiles"], cfg["tile"])
    width = len(steps[0]) * tt if steps else 0
    cols = visit.ROWS if cfg["reduce"] == "first8" else width
    ray_steps = blocks * R * len(steps)
    rows = visit.ROWS if cfg["reduce"] == "first8" else 1
    return dict(
        mac=ray_steps * 2 * 16 * cols,
        other=ray_steps * (width // 4 * MT_EPI_OPS if cfg["reduce"] == "mt"
                           else cols),
        bytes=(len({j for st in steps for j in st}) * 16 * tt
               + blocks * 16 * R + blocks * R * (rows + 1)) * 4)


def device_rows(prof, avgs=None):
    """[(name, self device microseconds, count)] of the profile's device
    rows: the kernels and copies themselves.  A host operator's row
    carries its kernels' time again as its own self device time, and a
    record_function range (a span of the program's, utils/profiling)
    has a device-side row spanning the kernels launched inside it, gaps
    and all: both are left out, so each kernel counts once.  `avgs` is
    the profile's key_averages() where the caller has it: each call
    walks every event again (tens of seconds for a training step's
    half)."""
    from torch.autograd import DeviceType
    if avgs is None:
        avgs = prof.key_averages()
    return [(e.key, getattr(e, "self_device_time_total", 0) or 0, e.count)
            for e in avgs if e.device_type != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn: Callable, iters: int = 50):
    """Device time per call of fn: over `iters` calls after a warm-up,
    each device row's mean time (the kernels themselves, each counted
    once) times its launches a call, or None where the profiler records
    no device time.  For calls whose back-to-back time is set by the
    host's launch path.  The profiler can lose records (seen for an empty
    kernel: a session with no device row, another with a fifth of the
    launches): a row's launches a call are its count over `iters`,
    rounded up, so lost records do not shorten the time; a session
    without device rows is taken again, twice at most."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(us, n) for _, us, n in device_rows(prof) if us and n]
        if rows:
            return sum(us / n * -(-n // iters) for us, n in rows) / 1e3
    return None

