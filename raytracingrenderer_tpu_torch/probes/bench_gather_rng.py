"""G1 (csrc/gather_kernel.cu) and R1 (csrc/rng_kernel.cu) timed on the
card, alone or beside another tree's revision of the two sources:

    python -m raytracingrenderer_tpu_torch.probes.bench_gather_rng
        [--parent DIR ...] [--rounds N] [--out FILE]

G1 at the train cell's shapes (262,144 indices into 1, 8 and 36 rows,
in runs of 64 as a frame's hits come and at random rows); R1 at a
2048x2048 frame's draws (`uniform_ids` on int64 and int32 ids, in order
and permuted; `uniform` in the jitter's shape, and its lower half as a
band; `random_bits`).  Each run's device time (`probes.device_ms`: a
call back to back is the host's launch path, timed beside it by CUDA
events), its bound (bytes over 3.35 TB/s; for R1 also 72 int32
operations a lane over 64 a clock on 132 SMs at 1.98 GHz) and, for this
tree, the plain versions' device times (G1: `transpose_plain`, and
autograd's transposes of plain indexing, `index_put_`, and of
`index_select`, `index_add_`, a column each; R1: the torch ops).  Every
tree is checked first (G1 within an ulp of the float64 sum, R1 the torch
path's bits): this tree failing exits 1, a parent is left out.  The
trees are timed in turns; the table gives each run's median over the
rounds and, in brackets, its least.  `--parent DIR` names a checkout of
another commit (`git archive <commit> | tar -x -C build/parent`) whose
two sources are built and launched through this tree's wrappers.
Correctness is the card tests'."""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from raytracingrenderer_tpu_torch.ops import gather, rng_kernel
from raytracingrenderer_tpu_torch.ops.launch import bind
from raytracingrenderer_tpu_torch.probes import (card, device_ms,
                                                 require_cuda, timed_ms)
from raytracingrenderer_tpu_torch.sampling import rng

PEAK_BYTES = 3.35e12              # B/s of device memory
PEAK_INT32 = 64 * 132 * 1.98e9    # int32 operations a second
RNG_OPS = 72                      # int32 operations a lane of the hash
N, FRAME = 512 * 512, 2048


def load(tree):
    """{module: its launchers} built from a tree's sources (None: this
    tree's), bound with this tree's signatures."""
    return {mod: mod._library() if tree is None else bind(
        name, {k: f.argtypes[:-1] for k, f in mod._library().items()},
        Path(tree).resolve() / "raytracingrenderer_tpu_torch" / "csrc"
        / f"{name}.cu") for mod, name in ((gather, "gather_kernel"),
                                          (rng_kernel, "rng_kernel"))}


def sums(idx, xs, rows, f=lambda x: x):
    return torch.stack([torch.zeros(rows, dtype=torch.float64,
                                    device=idx.device).index_add_(
        0, idx, f(x).double()) for x in xs])


def gather_cases(dev):
    """[(name, the kernel's call, its check, bound ms, the plain calls)]."""
    cases = []
    for rows, k in ((36, 3), (36, 1), (8, 3), (1, 3)):
        for pattern in ("runs", "random"):
            g = torch.Generator(device=dev).manual_seed(rows * 131 + k)
            idx = (torch.randint(0, rows, (N // 64,), generator=g,
                                 device=dev).repeat_interleave(64)
                   if pattern == "runs" else
                   torch.randint(0, rows, (N,), generator=g, device=dev))
            xs = [torch.randn(N, generator=g, device=dev) for _ in range(k)]
            ref, mag = sums(idx, xs, rows), sums(idx, xs, rows, torch.abs)
            call = (lambda idx=idx, xs=xs, rows=rows:
                    gather._transpose(xs, idx, rows))
            nbytes = (N * (4 * k + 8) + 4 * rows * k
                      + 16 * rows * k * -(-N // gather.CHUNK))
            cases.append((
                f"G1 {rows}x{k} {pattern}", call,
                lambda call=call, ref=ref, mag=mag: bool((
                    (call().double() - ref).abs()
                    <= 2.0 ** -24 * ref.abs() + 2.0 ** -32 * mag).all()),
                nbytes / PEAK_BYTES * 1e3,
                {"plain": lambda idx=idx, xs=xs, rows=rows:
                    gather.transpose_plain(xs, idx, rows),
                 "index_put_": lambda idx=idx, xs=xs, rows=rows: [
                     torch.zeros(rows, device=dev).index_put_(
                         (idx,), x, accumulate=True) for x in xs],
                 "index_add_": lambda idx=idx, xs=xs, rows=rows: [
                     torch.zeros(rows, device=dev).index_add_(0, idx, x)
                     for x in xs]}))
    return cases


def torch_path(draw):
    rule, rng.takes_kernel = rng.takes_kernel, lambda device: False
    try:
        return draw()
    finally:
        rng.takes_kernel = rule


def rng_cases(dev):
    """[(name, the kernel's call, its check, bound ms, the plain calls)]."""
    key = rng.spp_key(rng.PRNGKey(2**31 - 1), 3)
    n, half = FRAME * FRAME, FRAME // 2
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(FRAME)
    perm = ids[torch.randperm(n, generator=g, device=dev)]
    draws = {f"uniform_ids {str(dt)[6:]} {order}": (
        lambda i=i.to(dt): rng.uniform_ids(key, 2, rng.BSDF_U, i), n,
        n * (4 + (8 if dt == torch.int64 else 4)))
        for dt in (torch.int64, torch.int32)
        for order, i in (("in order", ids), ("permuted", perm))}
    draws["uniform jitter"] = (lambda: rng.uniform(
        key, 0, rng.PIXEL_JITTER_X, (FRAME, FRAME), dev), n, n * 4)
    draws["uniform jitter band"] = (lambda: rng.uniform(
        key, 0, rng.PIXEL_JITTER_Y, (half, FRAME), dev, half * FRAME),
        half * FRAME, half * FRAME * 4)
    draws["random_bits"] = (lambda: rng.random_bits(key, (n,), dev), n,
                            n * 8)
    return [(f"R1 {name}", draw,
             lambda draw=draw, want=torch_path(draw): torch.equal(draw(),
                                                                 want),
             max(lanes * RNG_OPS / PEAK_INT32, nbytes / PEAK_BYTES) * 1e3,
             {"torch path": lambda draw=draw: torch_path(draw)})
            for name, (draw, lanes, nbytes) in draws.items()]


def using(lib, fn):
    """fn() with the modules' launchers swapped for a tree's."""
    saved = {mod: mod._lib for mod in lib}
    for mod, fns in lib.items():
        mod._lib = fns
    try:
        return fn()
    finally:
        for mod, fns in saved.items():
            mod._lib = fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout of another commit whose sources are "
                         "built and timed beside (repeatable)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args()
    dev = require_cuda()
    name = card()
    libs = {"this tree": load(None), **{p: load(p) for p in args.parent}}
    cases = gather_cases(dev) + rng_cases(dev)
    for tree, lib in list(libs.items()):
        bad = [c[0] for c in cases if not using(lib, c[2])]
        if bad and tree == "this tree":
            sys.exit(f"{tree}: {bad} disagree with the plain versions")
        if bad:
            print(f"{tree}: {bad} disagree with the plain versions; left "
                  f"out", flush=True)
            del libs[tree]
    got = {c[0]: {t: ([], []) for t in libs} for c in cases}
    for rnd in range(args.rounds):
        for c in cases:
            for tree in (list(libs)[::-1] if rnd % 2 else list(libs)):
                dev_ms, call_ms = got[c[0]][tree]
                ms = using(libs[tree], lambda: device_ms(c[1]))
                dev_ms += [] if ms is None else [ms]
                call_ms.append(using(libs[tree],
                                     lambda: timed_ms(c[1], 200)[0]))
    table = {}
    print(f"device ms: the median [least] of {args.rounds} rounds, a call "
          f"back to back, the bound; the plain versions [{name}]")
    for c in cases:
        row = table[c[0]] = dict(bound_ms=c[3], plain_device_ms={
            k: device_ms(f, 10) for k, f in c[4].items()}, **{
            t: dict(device_ms=statistics.median(d or [float("nan")]),
                    least_ms=min(d, default=float("nan")),
                    call_ms=statistics.median(cl), samples=d)
            for t, (d, cl) in got[c[0]].items()})
        print(f"{c[0]:<29}" + "".join(
            f" {t[-20:]}: {row[t]['device_ms']:.5f} "
            f"[{row[t]['least_ms']:.5f}] call {row[t]['call_ms']:.4f};"
            for t in libs) + f" bound {c[3]:.5f}; " + ", ".join(
            f"{k} {v:.4f}" for k, v in row["plain_device_ms"].items()
            if v is not None), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": name, "rounds": args.rounds, "table": table}, indent=1))


if __name__ == "__main__":
    main()
