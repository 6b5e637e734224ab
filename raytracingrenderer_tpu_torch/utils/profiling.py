"""Profiling: phase timers and torch.profiler traces.

Counterpart of raytracingrenderer_tpu/utils/profiling.py (RTBase times
frames with a QPC timer, GamesEngineeringBase.h:900-930): wall-clock
phase timers that synchronise the card, with a rays/s report, a Chrome
trace of a block under torch.profiler, and the CUDA caching allocator's
statistics.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from .log import get_logger

_log = get_logger("prof")


def wait_for(x) -> None:
    """Wait for the device work behind `x` (a tensor, or a tuple such as
    a Film): torch.cuda.synchronize on the device of each CUDA tensor."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (tuple, list)):
        for a in x:
            wait_for(a)


class Timer:
    """Accumulating phase timer; `sync` names the result a phase must
    wait for on the device before its time is taken."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            wait_for(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, rays: Optional[int] = None) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            line = f"{name}: {total:.3f}s over {n} calls"
            if rays:
                line += f" ({rays * n / total / 1e6:.1f} Mrays/s)"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (host, and the card when
    there is one) and write a Chrome trace, `logdir`/trace.json (open in
    chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof = profile(activities=acts)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        _log.info("profiler trace written to %s", path)


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats() of the current card; {} without one."""
    if not torch.cuda.is_available():
        return {}
    return torch.cuda.memory_stats()
