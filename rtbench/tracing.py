"""Profiler walk: a block of passes or steps under torch.profiler, reduced
to what the per-layer readers need.

The arithmetic is chip_smoke.py's way of reading a profile: each device
event (a kernel, copy or set) counts once, host operators' rows are left
out of the device time, and a host operator's device time is that of the
kernels it and its children launched (FunctionEvent.device_time_total).
Busy time is the union of the device events' intervals; idle is the rest
of the block's wall time, which the host clock takes around the block
after a synchronise.  Each idle gap is put down to the outermost host
operator running at its midpoint, or "host" where none ran.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List

# kernels of the renderer's csrc/ (B1, B2 and B3, B4): the intersection
# layer's device time
ISECT_KERNELS = ("mt_intersect_kernel", "bvh_traverse_kernel",
                 "pair_test_kernel")


def capture(ctx, fn: Callable[[int], None], units: int):
    """fn(i) for i < units under the profiler (host and, on the card,
    device activity) -> (profile, wall s)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if ctx.cuda else [])
    ctx.sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            fn(i)
        ctx.sync()
        wall = time.perf_counter() - t0
    return prof, wall


def _is_device(e) -> bool:
    return str(e.device_type).split(".")[-1] != "CPU"


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events, wall_s: float, units: int) -> Dict:
    """The block's events (FunctionEvents or alike: name, device_type,
    time_range, cpu_parent, is_async, device_time_total) -> the record
    the metric readers take:

    units, window_s, busy_s, device_events, device_us (summed),
    isect_us, scatter_us, device_ops [[name, s]] and idle_gaps
    [[host op, s]] (the ten largest of each)."""
    dev, host = [], []
    for e in events:
        (dev if _is_device(e) else host).append(e)
    by_name: Dict[str, float] = {}
    spans = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    merged = _union(spans)
    busy_us = sum(b - a for a, b in merged)

    def outer(e, word):
        p = e.cpu_parent
        while p is not None:
            if word in p.name:
                return False
            p = p.cpu_parent
        return True
    scatter_us = sum(e.device_time_total for e in host
                     if not e.is_async and "index_put" in e.name
                     and outer(e, "index_put"))

    tops = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in host if e.cpu_parent is None and not e.is_async),
                  key=lambda r: r[0])
    starts = [t[0] for t in tops]
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        label = "host"
        # the latest-starting top-level op (of the last 64) running at mid
        for j in range(i, max(i - 64, -1), -1):
            if tops[j][1] >= mid:
                label = tops[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a)

    def top10(d):
        return [[k[:160], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(
        units=units, window_s=wall_s, busy_s=busy_us / 1e6,
        device_events=len(dev), device_us=sum(by_name.values()),
        isect_us=sum(us for k, us in by_name.items()
                     if any(m in k for m in ISECT_KERNELS)),
        scatter_us=scatter_us,
        device_ops=top10(by_name), idle_gaps=top10(gaps))
