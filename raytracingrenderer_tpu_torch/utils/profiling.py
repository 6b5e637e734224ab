"""Profiling: phase timers, torch.profiler traces, the program's spans
and counts.

Counterpart of raytracingrenderer_tpu/utils/profiling.py (RTBase times
frames with a QPC timer, GamesEngineeringBase.h:900-930): wall-clock
phase timers that synchronise the card, with a rays/s report, a Chrome
trace of a block under torch.profiler, and the CUDA caching allocator's
statistics.

Spans: the renderer marks its layers with `span("rtr.<layer>")` (load.bvh,
pass, bounce, intersect, shade, nee, bsdf, rng, compact, boundary,
train_step, forward, backward, sgd, refit).  A span is a
torch.profiler.record_function range, so it lands on the profiler's
timeline beside the kernels (on the card, Kineto also draws it as a
device-side row over the kernels launched inside it); it has no clock
and writes nothing of its own.  Spans are recorded only inside a
`spans_on()` block while a profiler records: `trace` (the CLI's -trace)
switches them on, and a profiler that does not ask for them sees the
operators alone.  Elsewhere a span costs a flag test.

Counts: inside a `counting()` block the integrators add, a bounce, the
lanes its operators run over (`lanes`) and the lanes alive at its start
(`live`); outside one, `counts()` is None and the integrators do no
device work for it.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Optional

import torch

from .log import get_logger

_log = get_logger("prof")

SPAN_PREFIX = "rtr."
_spans = False          # inside a spans_on() block
_counts = None          # the open counting() block's sums, else None
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager marking one layer's work: a record_function
    range named `name` where spans are on and a profiler records, else
    a shared no-op context."""
    if _spans and torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def spanned(name: str):
    """Decorator: every call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def spans_on():
    """Record the program's spans under the profiler in the block (the
    profiler's own thread-local state reaches the autograd engine's
    threads; this switch is the process's, so it does too)."""
    global _spans
    was, _spans = _spans, True
    try:
        yield
    finally:
        _spans = was


def counts():
    """The open counting() block's running sums (device tensors allowed),
    or None outside one."""
    return _counts


@contextlib.contextmanager
def counting():
    """Count the bounces' lanes in the block: yields a dict whose
    `lanes` (the widths the bounces ran at, summed) and `live` (the lanes
    alive at each bounce's start, summed) are ints once the block exits,
    where the device sums are read once."""
    global _counts
    if _counts is not None:
        raise RuntimeError("counting() blocks do not nest")
    out = {}
    _counts = {"lanes": 0, "live": 0}
    try:
        yield out
    finally:
        sums, _counts = _counts, None
        out.update({k: int(v) for k, v in sums.items()})


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
    there is one), the program's spans on, and write a Chrome trace,
    `logdir`/trace.json (open in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof = profile(activities=acts)
    prof.start()
    try:
        with spans_on():
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
