"""Where a render pass and a training step spend their time, by the
program's spans (utils/profiling: rtr.load.bvh, rtr.pass, rtr.bounce,
rtr.intersect, rtr.shade, rtr.nee, rtr.bsdf, rtr.rng, rtr.compact,
rtr.boundary*, rtr.train_step, rtr.forward, rtr.backward, rtr.sgd,
rtr.refit).

    python -m raytracingrenderer_tpu_torch.probes.trace_spans
        [--size 2048] [--train-size 512] [--passes 2] [--rounds 3]
        [--seed 7] [--out FILE]

On the cornell box (tests/torch_scenes.py, RenderConfig(mis, jitter,
max_depth 4)) it profiles the render scene's load (the tree's build in
rtr.load.bvh), `passes` 1-spp passes at size x size and one
training step (diff.train_step, then refit) at train_size x train_size
with the spans on, and prints, a unit (pass or step), each span's calls,
host ms, self host ms, device ms and kernels, and the device's idle gaps
by the chain of spans they fall in (`walk`).  It counts one more pass
(profiling.counting: lanes and live lanes a bounce; the kernels' rays
and launches) and one more step (the gathers' transpose launches, the
indices they reduced, and the gradient-carrying gathers left on plain
indexing and their indices: the share of them the kernel took).  What
tracing costs: `rounds` rounds, each a profiled block with the spans
on, one with them off, an unprofiled pass or step, and a counted one,
timed by the host clock after a synchronise.  Needs a card.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib.util
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

from raytracingrenderer_tpu_torch.utils.profiling import SPAN_PREFIX

ROOT = Path(__file__).resolve().parents[2]
CFG = dict(mis=True, jitter=True, max_depth=4)


def _device(e) -> bool:
    return str(e.device_type).split(".")[-1] != "CPU"


def _is_span(e) -> bool:
    return e.name.startswith(SPAN_PREFIX)


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _nest(spans: list) -> Dict[int, object]:
    """{id(span): the innermost other span whose interval holds it, or
    None}, on any thread: the backward's recompute runs on the autograd
    engine's thread, inside the main thread's rtr.backward."""
    parent, stack = {}, []
    for s in sorted(spans, key=lambda e: (e.time_range.start,
                                          -e.time_range.end)):
        a, b = s.time_range.start, s.time_range.end
        while stack and not (stack[-1].time_range.start <= a
                             and b <= stack[-1].time_range.end):
            stack.pop()
        parent[id(s)] = stack[-1] if stack else None
        stack.append(s)
    return parent


def walk(events, wall_s: float, units: int) -> Dict:
    """A profiled block's events (FunctionEvents: id, name, device_type,
    time_range, cpu_parent, is_async, is_user_annotation) ->

    units, window_s, busy_s, device_events and device_us (the kernels,
    copies and sets; a span's device-side row, which spans the kernels
    launched inside it, gaps and all, is counted in `annotations` and
    left out), launched (the device events whose runtime call is in the
    trace), spans {name: {calls, host_ms, self_host_ms, device_ms,
    kernels, idle_ms}} a unit over each name's outermost instances (a
    span inside one of its own name, as rng.uniform's random_bits, is
    counted in it): self host ms is the duration less the child spans',
    device ms and kernels those whose runtime call lies inside the
    instance, on any thread (a FunctionEvent's own `kernels`, and so
    torch's device_time_total, miss the ctypes launches and count some
    kernels twice), idle ms the gaps with no device event whose midpoint
    it holds; and idle_gaps [[label, s]] (the ten largest), a gap's label
    the chain of spans holding its midpoint, by start, joined by "/",
    then " > " and the outermost operator running there that is not a
    span ("host" where none ran; the operator alone where no span
    holds it)."""
    dev, host, annotations = [], [], 0
    for e in events:
        if _device(e):
            if getattr(e, "is_user_annotation", False) or _is_span(e):
                annotations += 1
            else:
                dev.append(e)
        elif not e.is_async:
            host.append(e)
    merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    spans = [e for e in host if _is_span(e)]
    parent = _nest(spans)

    def ancestors(s):
        p = parent[id(s)]
        while p is not None:
            yield p
            p = parent[id(p)]
    outer = [s for s in spans
             if all(p.name != s.name for p in ancestors(s))]
    kept = _nest(outer)

    # each device event at the host time of the runtime call that
    # launched it (cudaLaunchKernel, cudaMemcpyAsync, ...: the same
    # correlation id), whoever made the call: the ctypes launches of the
    # csrc kernels have no operator around them
    called = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu")}
    launch = sorted((called[e.id], e.time_range.end - e.time_range.start)
                    for e in dev if e.id in called)
    at = [t for t, _ in launch]
    cum_us = [0.0]
    for _, us in launch:
        cum_us.append(cum_us[-1] + us)

    table: Dict[str, Dict[str, float]] = {}
    child_us: Dict[int, float] = {}
    for s in outer:
        p = kept[id(s)]
        if p is not None:
            child_us[id(p)] = child_us.get(id(p), 0.0) + (
                s.time_range.end - s.time_range.start)
    for s in outer:
        a, b = s.time_range.start, s.time_range.end
        i, j = bisect.bisect_left(at, a), bisect.bisect_right(at, b)
        row = table.setdefault(s.name, dict(calls=0, host_ms=0.0,
                                            self_host_ms=0.0, device_ms=0.0,
                                            kernels=0, idle_ms=0.0))
        row["calls"] += 1
        row["host_ms"] += (b - a) / 1e3
        row["self_host_ms"] += max(b - a - child_us.get(id(s), 0.0),
                                   0.0) / 1e3
        row["device_ms"] += (cum_us[j] - cum_us[i]) / 1e3
        row["kernels"] += j - i

    def top_op(e) -> bool:
        p = e.cpu_parent
        while p is not None:
            if not _is_span(p):
                return False
            p = p.cpu_parent
        return True
    tops = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in host if not _is_span(e) and top_op(e)),
                  key=lambda r: r[0])
    starts = [t[0] for t in tops]
    by_start = sorted(spans, key=lambda e: e.time_range.start)
    active, k = [], 0
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        while k < len(by_start) and by_start[k].time_range.start <= mid:
            active.append(by_start[k])
            k += 1
        active = [s for s in active if s.time_range.end >= mid]
        chain = []
        for s in active:          # by start
            if not chain or chain[-1] != s.name:
                chain.append(s.name)
        i = bisect.bisect_right(starts, mid) - 1
        op = "host"
        # the latest-starting top operator (of the last 64) running at mid
        for j in range(i, max(i - 64, -1), -1):
            if tops[j][1] >= mid:
                op = tops[j][2]
                break
        label = "/".join(chain) + " > " + op if chain else op
        gaps[label] = gaps.get(label, 0.0) + (b - a)
        for name in set(chain):
            if name in table:
                table[name]["idle_ms"] += (b - a) / 1e3
    for row in table.values():
        for key in row:
            row[key] /= units
    return dict(
        units=units, window_s=wall_s,
        busy_s=sum(b - a for a, b in merged) / 1e6,
        device_events=len(dev), launched=len(launch),
        device_us=sum(e.time_range.end - e.time_range.start for e in dev),
        annotations=annotations, spans=table,
        idle_gaps=[[k[:200], v / 1e6] for k, v in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])


def profiled(fn, units: int, spans: bool):
    """fn(i) for i < units under torch.profiler (host and card), with the
    program's spans on or off -> (events, wall s)."""
    from torch.profiler import ProfilerActivity, profile
    from raytracingrenderer_tpu_torch.utils.profiling import spans_on
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans_on() if spans else contextlib.nullcontext():
            t0 = time.perf_counter()
            for i in range(units):
                fn(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return prof.events(), wall


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def counters() -> Dict:
    from raytracingrenderer_tpu_torch.ops import bvh_kernel, gather, mt_kernel
    return dict(mt_rays=mt_kernel.rays, mt_launches=mt_kernel.launches,
                bvh_rays=sum(bvh_kernel.rays.values()),
                bvh_launches=sum(bvh_kernel.launches.values()),
                gather_launches=gather.launches, gather_rows=gather.rows,
                gather_plain_grad_calls=gather.plain_grad_calls,
                gather_plain_grad_rows=gather.plain_grad_rows)


def main() -> None:
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.geometry.refit import refit
    from raytracingrenderer_tpu_torch.imaging.film import new_film
    from raytracingrenderer_tpu_torch.probes import card, require_cuda
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    from raytracingrenderer_tpu_torch.utils.profiling import counting
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--train-size", type=int, default=512)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None, help="write the lines as JSON")
    args = ap.parse_args()
    dev = require_cuda()
    spec = importlib.util.spec_from_file_location(
        "torch_scenes", ROOT / "tests" / "torch_scenes.py")
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    lines = []

    def emit(**line):
        line = dict(card=card(), **line)
        lines.append(line)
        print(json.dumps(line), flush=True)

    cfg = RenderConfig(**CFG, seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        rdir = scenes.write_cornell(str(Path(tmp) / "r"), args.size,
                                    args.size)
        loaded = []
        ev, w_load = profiled(lambda i: loaded.append(load_scene(rdir, dev)),
                              1, True)
        emit(what="load", size=args.size, **walk(ev, w_load, 1))
        del ev
        scene = loaded[0]
        tscene = load_scene(scenes.write_cornell(
            str(Path(tmp) / "t"), args.train_size, args.train_size), dev)
    film = new_film(args.size, args.size, dev)

    def one_pass(_=0):
        render(scene, cfg, spp=1, film=film)
    one_pass()
    cost = {k: [] for k in ("traced_spans_s", "traced_s", "untraced_s",
                            "counted_s")}
    for r in range(args.rounds):
        ev, w_on = profiled(one_pass, args.passes, True)
        if r == 0:
            # torch's own sum under the span, beside `walk`'s device ms
            dtt = sum(e.device_time_total for e in ev
                      if e.name == "rtr.pass" and not _device(e))
            emit(what="render", size=args.size,
                 pass_device_time_total_ms=dtt / 1e3 / args.passes,
                 **walk(ev, w_on, args.passes))
        del ev
        _, w_off = profiled(one_pass, args.passes, False)
        cost["traced_spans_s"].append(w_on / args.passes)
        cost["traced_s"].append(w_off / args.passes)
        cost["untraced_s"].append(timed(one_pass))
        before = counters()
        with counting() as c:
            cost["counted_s"].append(timed(one_pass))
        if r == 0:
            after = counters()
            emit(what="render counted pass", size=args.size, **c,
                 live_pct=100.0 * c["live"] / c["lanes"],
                 **{k: after[k] - before[k] for k in after})
    emit(what="render cost, s a pass", **cost)

    target = torch.zeros((args.train_size, args.train_size, 3), device=dev)
    key0 = rng.PRNGKey(args.seed)
    step_no = [0]

    def one_step(_=0):
        nonlocal tscene
        tscene, loss = diff.train_step(tscene, target,
                                       rng.fold_in(key0, step_no[0]), cfg,
                                       0.01)
        tscene = refit(tscene)
        step_no[0] += 1
    one_step()
    before = counters()
    one_step()
    after = counters()
    c = {k: after[k] - before[k] for k in after}
    engaged = c["gather_launches"] + c["gather_plain_grad_calls"]
    emit(what="train counted step", size=args.train_size, **c,
         gather_engaged_pct=(100.0 * c["gather_launches"] / engaged
                             if engaged else None))
    cost = {k: [] for k in ("traced_spans_s", "traced_s", "untraced_s")}
    for r in range(args.rounds):
        ev, w_on = profiled(one_step, 1, True)
        if r == 0:
            emit(what="train", size=args.train_size, **walk(ev, w_on, 1))
        del ev
        _, w_off = profiled(one_step, 1, False)
        cost["traced_spans_s"].append(w_on)
        cost["traced_s"].append(w_off)
        cost["untraced_s"].append(timed(one_step))
    emit(what="train cost, s a step", **cost)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
