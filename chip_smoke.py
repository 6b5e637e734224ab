#!/usr/bin/env python3
"""Smoke test of the PyTorch port (raytracingrenderer_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, launches its
kernels and renders.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero):
  1. card facts: nvidia-smi's name and power limit, torch's device name;
     the host CPU's model and whether it has avx512f;
  2. build every kernel of the render paths from csrc/ with nvcc
     (sm_90a), one nvcc per source, all started together, beside the
     native BVH builder's library (the committed one, or g++ of
     native/bvh_builder.cpp where the CPU lacks AVX-512);
  3. the MT kernel (B1) against its plain torch version on the card, bit
     for bit (max |dt| = 0, every id, u, v and any-hit bit equal, no dead
     lane hit), closest-hit and any-hit: 2^20 + 77 random rays with 10%
     dead lanes against the cornell box's 36 triangles and against 128
     and 4096 random ones; the inputs of every launch of one cornell
     sample pass (12 launches at 2^20 coherent rays) and of the any-hit
     proxy pre-pass of one spheres wavefront pass (6 launches over 128
     triangles, narrowing widths), kept by wrapping the wrapper for that
     pass and timed as a pass (`render_pass_ms`); kernel and plain times
     at 1,048,576 random rays beside the bound and the issue floor (the
     operations as FP32 instructions at half the peak rate: the kernel
     is built without FMA); the host's microseconds a call by stage;
  4. the BVH kernel (B2) against its plain torch version on the spheres
     scene (the cornell box plus 16 icospheres, 327,716 triangles),
     closest-hit and any-hit: (a) 2^20 + 77 rays from
     inside the box with 10% dead lanes (hit fraction above 0.1);
     (b) 2^20 live rays, which also time the kernel and the plain
     version; (c) the inputs of every B2 launch of one sample pass of the
     1024x1024 spheres render (coherence-sorted rays, any-hit seeds
     negated where the proxy pre-pass resolved them), kept by wrapping
     the wrapper for that pass, then timed as a pass (`render_pass_ms`:
     the sum over the pass's launches, the main path's shapes); all bit
     for bit (max |dt| = 0, every id, u, v and bit equal), any-hit over
     both leaf forms; the bound counts a triangle test a filled slot
     the plain walk needed (an any-hit ray's up to its first hit; the
     count of earlier runs, 14 a leaf visit, beside it); beside the bound
     the walk's traffic, node rows and tested slots, and its time at the
     device-memory rate (`traffic_ms`); the host's microseconds a call;
  5. main path 1, the in-repo cornell box (36 triangles, brute force):
     1024x1024, RenderConfig(mis=True, jitter=True, max_depth=4), 8 spp,
     loaded and rendered on "cuda"; the MT kernel must have launched; a
     finite image with a sane mean, written as .hdr;
  6. main path 2, the spheres scene (BVH, the wavefront integrator
     chosen automatically): the same render; both B2 variants and B1
     (the any-hit proxy pre-pass) must have launched and no walk may
     have taken the stackless fall-back; a finite image with a sane
     mean, written as .hdr; one more sample pass under torch.profiler
     (the device's busy time and idle share, B2's and B1's time in it).
     Then the same render through the scan
     integrator (wavefront=False), timed beside it: its image must agree
     with the wavefront's on >= 99% of pixels (rtol 1e-3 / atol 1e-5);
  7. GPU against CPU: the cornell box and the 5,156-triangle spheres
     scene at 128x128, 2 spp, on "cuda" (kernels) and on "cpu" (plain
     versions), same keys: >= 99% of pixels within rtol 1e-3 /
     atol 1e-5, image means within 0.5%;
  8. the 4-wide BVH kernel (B3, `traverse_packet(..., wide=True)`, over
     the 4-wide collapse the loader attaches; its time printed beside
     the load) against its plain version on the spheres scene,
     closest-hit and any-hit, bit for bit (max |dt| = 0, every id and
     bit equal, no dead lane hit): (a) its path, the coherence-sorted
     bounce and shadow rays of one 1024x1024 sample pass (kept in phase
     4), walked with the wide counts set to 0 just before, then timed
     over its 5 + 6 launches (`render_pass_ms`) beside B2 over the same
     launches and both leaf forms; (b) 2^20 + 77 random rays with 10%
     dead lanes; (c) 2^20 live random rays, which time B3, B2 and the
     plain wide walk, with the bound and the walk's traffic as phase 4's;
  9. the treelet pair-test kernel (B4) against its plain version, bit
     for bit (t and column), on the pairs of every `pair_test` call of
     one sample pass of the spheres render with `attach_treelets` applied
     (12 calls; the first is the primary closest-hit call, 2^20 rays);
     the first call and the pass (`render_pass_ms`) timed beside the
     bound and the issue floor, and the share of live rays that
     overflowed to B2 printed;
 10. main path 3, that render at 1024x1024, 8 spp through the treelet
     route: B4, B1 (the proxy pre-pass) and both B2 variants (the
     overflow fallback) must have launched and `treelet_calls` be
     positive; timed beside phase 6's packet-route render, whose image
     it must match as phase 6 holds its scan render;
 11. GPU against CPU for the treelet route: the 5,156-triangle scene at
     128x128, 2 spp, with treelets attached, held as in phase 7;
 12. main path 4, the matrix-unit probes (csrc/visit_kernel.cu): the
     entry points `python -m raytracingrenderer_tpu_torch.probes.probe_mxu`
     (and probe_mxu2, probe_mxu3) run in this process with the visit
     counts set to 0 just before, and every kernel must have launched;
     then each visit run of the probes at its full size against its
     plain version (fp32: bit for bit; TF32: within
     visit.TF32_KERNEL_BOUND of the sum of the products' magnitudes),
     both timed (and the kernels' device time, `device_ms`: a short
     run's calls are host-bound on a slow host), a fp32 run's time also
     beside `issue_ms`, the floor of
     a kernel built without FMA (its operations as FP32 instructions at
     half the peak rate); the fp32 min visit, in its three tile modes,
     bit for bit at 200 edge shapes (TT 32 to 512, 0 to 64 visits, 1 and
     64 tiles, 128 and 4096 rays), the lane visit at 40 (0 to 64 visits,
     1 and 64 tiles, 128 and 4096 rays, 1 and 8 blocks), the MT visit at
     80 (TT 32 to 512, 0 to 64 visits, 1 and 64 tiles, 128 and 4096 rays)
     and the TF32 visit within its bound at the same 80, first8 at 64 (TT
     32 to 512, 0 to 160 visits, 1 to 128 tiles: up to 16 visits a warp,
     one a slot, and its ring refilled; 128 and 4096 rays, 1 and 8
     blocks), with `floor_ms`, an empty launch of its grid; the TF32
     visit's line also carries `min_issue_ms`, its mins alone at the FP32
     issue rate beside the tensor cores' bound; the dot (P1b) in both
     precisions against its plain version and float64, timed beside
     torch.matmul with TF32 off and on (a yardstick the port never
     calls), a call and on the device, with the host's microseconds a
     call by stage; the relayout loop, which must equal x + n_iter
     exactly on the probe's zeros and the plain loop bit for bit on normal
     values, values >= 2^25 and fractions, timed beside `x + 65.0` (one
     PyTorch call, the loop's output on the probe's zeros though not on
     every input); for the dot
     and the relayout also `floor_ms`, the device time of an empty kernel of
     the same grid and block: what the card takes for any launch of that
     size;
 13. main path 5, training (diff.train_steps / train_step, zero target,
     lr 0.01, RenderConfig(mis=True, jitter=True, max_depth=4)): (a) the
     cornell box at 1024x1024, a warm-up train_steps(n=1), then
     train_steps(n=8) timed (fwdbwd_pps, and the forward render's
     pixel-paths/s over it): B1 must have launched, and no kernel inside
     any torch.autograd.grad call (the backward replays the recorded
     hits); finite losses and parameters, and the trained scene's loss on
     the first step's key below that step's loss; one more step profiled
     by halves (forward and backward wall and device time, the
     backward's device time by operator) with finite gradients; the peak
     memory of a step with remat on and off; (b) the spheres scene at
     1024x1024 through the wavefront backward: a warm-up train_step, one
     timed, B1 and both B2 variants launched and none in the backward,
     finite loss and parameters, then refit and the repacking of B2's
     tables and the pre-pass's triangles timed, and a step profiled by
     halves; (c) loss and gradients of one step on "cuda" and on "cpu",
     same key, for the cornell box at 128x128 (scan) and the
     5,156-triangle scene at 128x128 (wavefront): loss within rel 1e-4,
     each material and light array within rtol 1e-3 / atol 1e-3 *
     max|g|, tri_p0 within a relative L2 error of 1e-2;
 14. main path 6, training with the NEE visibility boundary term
     (boundary_grads=True, boundary_samples 4; integrators/boundary.py,
     whose probe rays are B1 and B2 launches): (a) the cornell box at
     512x512 (to keep the script within its time limit) as in 13 (a),
     train_steps(n=1) timed, with the peak memory
     of a step with remat on, and one step's forward under the profiler:
     its device time by operator and under the term's stages
     (the program's spans `rtr.boundary`, `rtr.boundary.probes` and
     `rtr.boundary.cells`; the backward is not profiled, to keep the
     script within its time limit); (b)
     the spheres scene as in 13 (b), its step on the refitted scene not
     profiled (to keep the script within its time limit); each prints
     its fwdbwd_pps beside phase 13's and its B1 / B2 launches (none
     inside a backward); (c) the
     gradient check of 13 (c) with the term on, at 64x64 (to keep the
     script within its time limit);
 15. main path 7, environment-map lighting: the spheres of the spheres
     scene above the cornell floor (no walls, no area light), lit only
     by a synthetic 1024 x 2048 sky with a sun
     (tests/torch_scenes.py::write_sky): loaded on "cuda" (the load and
     build_envmap's time, the alias table by the native library),
     rendered at 1024x1024, 8 spp through the wavefront (both B2
     variants and B1's pre-pass must have launched, a finite image with a
     sane mean), one pass profiled (idle share); then the 5,122-triangle
     sky scene (256 x 512 map) at 128x128 on "cuda" and "cpu": the image
     held as in phase 7 and the gradients as in 13 (c), env_data among
     them (rtol 1e-3 / atol 1e-3 * max|g|);
 16. main path 8, integrators.dispatch.render_with: direct, albedo,
     normals, lighttrace (1024^2 light paths a pass) and vpl (MAX_VPL x
     (max_depth + 2) shadow batches a pass; 2 spp) at 1024x1024, 8 spp, on the
     cornell box (B1) and the spheres scene (B2, B1's pre-pass), each
     with the counts set to 0 just before: every launch the passes make
     (a traversal call is one launch; on the spheres scene a shadow batch
     is a B1 pre-pass and a B2 any-hit launch), finite images with sane
     means, pixel-paths/s (light paths/s), one profiled pass of
     lighttrace and vpl on the spheres scene; then each integrator on
     the cornell box and the 5,156-triangle scene at 128x128, 2 spp, on
     "cuda" and "cpu" (vpl at max_depth 0), held as in phase 7;
 17. main path 9, the adaptive integrator and the command line:
     render_with(integrator="adaptive") at 1024x1024, 8 spp (2 uniform
     passes, then 8 rounds of 786,432 rays drawn from the tiles'
     variance) on the cornell box and the spheres scene after a 3-spp
     warm-up, every launch of its 10 traces asserted (a scan pass's),
     a finite image with a sane mean, pixel-paths/s, one round profiled;
     then `cli.main` in this process, counts reset before each run:
     adaptive 8 spp with -denoise -profile -checkpoint at 1024x1024 on
     the cornell box, the same again (it resumes to 16 spp), and -keys
     w,left,p,l,esc at 256x256, each with its exit code, its files, a
     finite image with a sane mean, its phase report and its B1
     launches; adaptive at 128x128, 4 spp, on "cuda" and "cpu" for the
     cornell box and the 5,156-triangle scene, held as in phase 7, with
     the card's draws that land in another tile than the CPU's from the
     same state counted (each must lie within 4 * 2^-24 of the boundary);
     the denoiser on the 1024x1024 adaptive image with its albedo and
     normal guides, cuda against cpu (max |diff| <= 1e-4 * max);
 18. main path 10, parallel/ (one rank a device, torch.distributed):
     (a) in this process, a process group of one rank over NCCL:
     mesh.render_sharded, 1 spp on the spheres scene at 1024x1024, equal
     to render.sample_image bit for bit, B1 and B2 launched; (b) RANKS
     gloo ranks, both on cuda:0 (NCCL takes one rank a card), processes
     of this script (`rank_main`), each with its counts set to 0 before
     every step and read after it: render_sharded 2 spp on the spheres
     scene (the assembled image against this process's by phase 7's bar,
     the differing pixels counted), load_scene(scene_shards=RANKS) and
     traverse_sharded on 2^20 + 77 rays with 10% dead lanes, closest-hit
     and any-hit, against the replicated walk here (ids, mapped by the
     triangles' geometry, agree on >= 99.999% of the live rays, t bit
     for bit there; the others counted as exact ties or not), a 1 spp
     scene-sharded render against the replicated scan render,
     param_grads_sharded (a reduction a bounce, and one at the end) on
     the cornell box at 256x256 and on the spheres scene at 1024x1024
     (tri_p0's 327,716 x 3 floats in every reduction, B2 launched) with
     jitter off against diff.param_grads here under phase 13's gradient
     gate, with the reductions counted,
     two train_step_overlap steps that must descend, adaptive_render
     (mesh=) 8 spp on the cornell box at 1024x1024 (the ranks' films bit
     for bit; 120 B1 launches a rank), light_trace_pass(mesh=) with 1024^2
     light paths against one process (film sums within rel 1e-4, >= 99%
     of pixels by phase 7's bar); the ranks' wall times, pixel-paths/s
     and all_reduce ms (a 1024x1024 film, the spheres' tri_p0); (c)
     parallel.elastic.render_elastic: two command-line workers on the
     card, the cornell box at 256x256, 4 spp each, worker 0 killed after
     its first checkpoint: its resumed film equals an uninterrupted
     worker's bit for bit.  Every phase prints the script's wall time as
     it starts.

Each kernel's line carries its bound: the least time the card could
take for the same work, the larger of its operations over the peak rate
for their type and its bytes (each input read once, each output written
once) over the memory rate, from this run's inputs (peaks: the H100 SXM
data sheet at 700 W).

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.  JAX is never imported.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
BIG_T = 3.4e38
N_TIMED = 1 << 20
N_CHECK = (1 << 20) + 77          # not a multiple of the 256-thread block
N_BVH_CHECK = (1 << 20) + 77      # B2: the render's primary width + a tail
BENCH_CFG = dict(mis=True, jitter=True, max_depth=4)
SPP = 8
TRAIN_STEPS = 8         # bench.py's training call: 8 SGD steps, lr 0.01
BOUNDARY_STEPS = 1      # main path 6's cornell train_steps (at 512x512)
TRAIN_LR = 0.01
PEAK_FP32 = 67e12       # FLOP/s, FP32 outside the tensor cores
PEAK_TF32 = 495e12      # FLOP/s, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12    # B/s of device memory
# FP32 operations (a compare, a select or a division counts one) of:
MT_PAIR_OPS = 53        # one (ray, triangle) test of B1 (mt_kernel.cu)
SLAB_OPS = 26           # one ray/box slab test (bvh_kernel._slab)
NODE_OPS = 2 * SLAB_OPS + 6       # a binary node visit: two boxes, order
WIDE_OPS = 4 * SLAB_OPS + 12      # a 4-wide node visit: four boxes, order
LEAF9_OPS = 57          # one raw-form triangle test (bvh_kernel._leaf9)
LEAF16_OPS = 49         # one constant-form any-hit test (bvh_kernel._leaf16)
LEAF_SLOTS = 14         # triangles a leaf row can hold; the kernels test
                        # only the filled ones (`plain_visits["slots"]`)
PAIR_EPI_OPS = 16       # B4 per (pair, column) after its contraction
PAIR_OPS = 33 + PAIR_EPI_OPS  # with the 33 of the contraction
MT_EPI_OPS = 15         # the visit epilogue per triangle (visit_kernel.cu)
RAY_BYTES = 44          # o, d, t_init in; t, tri, u, v out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def mark(phase: int) -> None:
    """The script's wall time as a phase starts."""
    log(f"-- phase {phase} at {time.perf_counter() - T_START:.1f} s")


def card_facts(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")
    return card


def host_facts():
    """The host CPU's model (vendor, family and model number where the
    model name is withheld) and whether it has AVX-512."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = info.get("model name", "unknown")
    if model == "unknown":
        model = (f"{info.get('vendor_id', '?')} family "
                 f"{info.get('cpu family', '?')} model "
                 f"{info.get('model', '?')}")
    from raytracingrenderer_tpu_torch.geometry import bvh_native
    log(f"host CPU: {model}, {os.cpu_count()} cores, avx512f: "
        f"{'avx512f' in bvh_native.cpu_flags()}")


def load_scene_writer():
    path = os.path.join(ROOT, "tests", "torch_scenes.py")
    if not os.path.isfile(path):
        fail("tests/torch_scenes.py is missing: run from a checkout")
    spec = importlib.util.spec_from_file_location("torch_scenes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_all():
    """nvcc for every kernel source and the native BVH builder's library,
    all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from raytracingrenderer_tpu_torch.geometry import bvh_native
    from raytracingrenderer_tpu_torch.ops import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        libs = [pool.submit(build.build, name)
                for name in ("mt_kernel", "bvh_kernel", "treelet_kernel",
                             "visit_kernel")]
        native = pool.submit(bvh_native.library_path)
        paths = [f.result() for f in libs] + [native.result()]
    log(f"build: {', '.join(os.path.relpath(p, ROOT) for p in paths)} "
        f"ready in {time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in build.build_log.items():
        log(f"nvcc {name}.cu: {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                log(f"  {line.strip()}")
    log(f"BVH builder: {os.path.relpath(paths[-1], ROOT)} "
        f"({'committed' if paths[-1] == bvh_native.COMMITTED_LIB else 'compiled here with g++'})")


def make_rays(torch, n, seed, dead_frac=0.1):
    import numpy as np
    g = np.random.default_rng(seed)
    o = (g.uniform(-1, 1, (n, 3)) * 0.5 + [0, 1, 0.5]).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = g.random(n) < dead_frac
    max_t = g.uniform(0.05, 2.5, n).astype(np.float32)
    t_closest = np.where(dead, -1.0, BIG_T).astype(np.float32)
    t_any = np.where(dead, -1.0, max_t).astype(np.float32)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    from raytracingrenderer_tpu_torch.core.vec import V3
    return (V3(*(cu(o[:, i]) for i in range(3))),
            V3(*(cu(d[:, i]) for i in range(3))),
            cu(t_closest), cu(t_any))


def random_tris(torch, n_tri, seed):
    import numpy as np
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.scene.types import Triangles
    g = np.random.default_rng(seed)

    def v3(a):
        return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).cuda()
                    for i in range(3)))

    p0 = v3((g.uniform(-1, 1, (n_tri, 3)) + [0, 1, 0]).astype(np.float32))
    e1 = v3((g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32))
    e2 = v3((g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32))
    z = torch.zeros(n_tri, device="cuda")
    zi = torch.zeros(n_tri, dtype=torch.int32, device="cuda")
    uv = torch.zeros((n_tri, 2), device="cuda")
    return Triangles(p0=p0, e1=e1, e2=e2, gn=e1, n0=e1, n1=e1, n2=e1,
                     uv0=uv, uv1=uv, uv2=uv, area=z + 1.0, mat_id=zi,
                     light_id=zi - 1)


def time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us_a_call(torch, fn, reps=500):
    """Host microseconds a call of fn: the host clock over `reps` calls
    that are enqueued and not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    dt = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return dt / reps / 1e3


def time_once(torch, fn):
    """One call of fn timed with CUDA events -> (its result, ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(ms, ops=0.0, nbytes=0.0, tf32_ops=0.0):
    """The least time the card could take for the work: the larger of the
    FP32 operations over PEAK_FP32 (beside the TF32 ones over PEAK_TF32,
    which run on the tensor cores at the same time) and the bytes over
    PEAK_BYTES -> the kernels line's bound keys, with the share of the
    bound that the measured `ms` reached."""
    t_ops = max(ops / PEAK_FP32, tf32_ops / PEAK_TF32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    b = max(t_ops, t_bytes)
    return dict(bound_ms=b,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_share=b / ms if ms else None)


def issue(ms, ops):
    """The issue floor of a fp32 kernel built without FMA: its operations
    as FP32 instructions, of which the card issues PEAK_FP32 / 2 a second
    -> the kernels line's `issue_ms` and the share of it that `ms`
    reached."""
    issue_ms = ops / (PEAK_FP32 / 2) * 1e3
    return dict(issue_ms=issue_ms, issue_share=issue_ms / ms if ms else None)


def compare(torch, what, t_init, k, p, any_hit, min_hit_frac=None,
            exact=False):
    """A kernel's output against its plain version's on one batch: log
    the numbers and fail past the bars (t within rtol/atol 1e-4, ids or
    bits agreeing on >= 99.9% of rays, no hit on a dead lane, one whose
    t_init < 0; with `exact`, max |dt| = 0 and every id, u, v or bit
    equal).
    For closest-hit k and p are Hits and the error is max |dt|; for
    any-hit they are the occluded bits and the error is max |k - p| over
    them (0 or 1).  Returns (max_abs_err, mismatches)."""
    n = t_init.shape[0]
    if any_hit:
        hits, mism = k, int((k != p).sum())
        err, t_ok = float(mism > 0), True
    else:
        hits, mism = k.tri >= 0, int((k.tri != p.tri).sum())
        err = (k.t - p.t).abs().max().item()
        t_ok = torch.allclose(k.t, p.t, rtol=1e-4, atol=1e-4)
        if exact:
            t_ok = t_ok and torch.equal(k.u, p.u) and torch.equal(k.v, p.v)
    dead_hits = int(hits[t_init < 0].sum())
    frac = hits.float().mean().item()
    log(f"{what}: {n} rays, max_abs_err {err:.3e} (t allclose 1e-4: "
        f"{t_ok}), {mism} {'bits' if any_hit else 'ids'} differ "
        f"({1 - mism / n:.6f} agree), dead-lane hits {dead_hits}, "
        f"hit fraction {frac:.3f}")
    if not (t_ok and mism <= (0 if exact else 0.001 * n) and dead_hits == 0
            and (err == 0 or not exact)
            and (min_hit_frac is None or frac > min_hit_frac)):
        fail(f"kernel disagrees with its plain version ({what})")
    return err, mism


def check_mt_kernel(torch, name, tris, timed: bool):
    """B1 vs plain on the card, bit for bit; returns (max_abs_err, ms,
    plain_ms, the bound and issue keys at the timed width)."""
    from raytracingrenderer_tpu_torch.ops import mt_kernel
    o, d, t_closest, t_any = make_rays(torch, N_CHECK, seed=0)
    what = f"mt_kernel {name}, {tris.count} triangles"
    err, _ = compare(torch, f"{what}, closest-hit", t_closest,
                     mt_kernel.intersect(tris, o, d, t_closest),
                     mt_kernel.intersect_plain(tris, o, d, t_closest),
                     any_hit=False, min_hit_frac=0.1, exact=True)
    plain_any = mt_kernel.intersect_plain(tris, o, d, t_any)
    compare(torch, f"{what}, any-hit radii, the hits", t_any,
            mt_kernel.intersect(tris, o, d, t_any), plain_any,
            any_hit=False, exact=True)
    compare(torch, f"{what}, any-hit", t_any,
            mt_kernel.any_hit(tris, o, d, t_any), plain_any.tri >= 0,
            any_hit=True, exact=True)
    ms = plain_ms = None
    b = {}
    if timed:
        o, d, t_closest, _ = make_rays(torch, N_TIMED, seed=1, dead_frac=0.0)
        ms = time_ms(torch, lambda: mt_kernel.intersect(
            tris, o, d, t_closest), 20)
        plain_ms = time_ms(torch, lambda: mt_kernel.intersect_plain(
            tris, o, d, t_closest), 3)
        ops = N_TIMED * tris.count * MT_PAIR_OPS
        b = dict(bound(ms, ops, N_TIMED * RAY_BYTES + tris.count * 36),
                 **issue(ms, ops))
        log(f"mt_kernel {name}: closest-hit at {N_TIMED} rays x "
            f"{tris.count} triangles: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}), share {b['bound_share']:.4f}; issue floor "
            f"without FMA {b['issue_ms']:.4f} ms, share "
            f"{b['issue_share']:.4f}")
    return err, ms, plain_ms, b


def check_mt_passes(torch, cornell, spheres):
    """B1 on what the renders give it: the inputs of every launch of one
    cornell sample pass and of the proxy pre-pass of one spheres
    wavefront pass, kept by wrapping `mt_kernel.intersect` for that
    pass; each launch bit for bit with `intersect_plain`, then the pass
    timed (the sum over its launches).  Returns per pass the numbers of
    the kernels line."""
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.ops import mt_kernel
    from raytracingrenderer_tpu_torch.probes import capture_pass
    out = {}
    for name, scene in (("cornell", cornell), ("spheres_prepass", spheres)):
        kept = []

        def keep(tris, o, d, t_init):
            if o.x.shape[0]:
                kept.append((tris, V3(*(c.clone() for c in o)),
                             V3(*(c.clone() for c in d)), t_init.clone()))

        capture_pass(scene, [(mt_kernel, "intersect", keep)], **BENCH_CFG)
        err = 0.0
        for i, (tris, o, d, t_init) in enumerate(kept):
            e, _ = compare(torch, f"mt_kernel {name} pass launch {i}, "
                           f"{tris.count} triangles", t_init,
                           mt_kernel.intersect(tris, o, d, t_init),
                           mt_kernel.intersect_plain(tris, o, d, t_init),
                           any_hit=False, exact=True)
            err = max(err, e)
        pass_ms = time_ms(torch, lambda: [mt_kernel.intersect(*b)
                                          for b in kept], 10)
        pairs = sum(b[0].count * b[3].shape[0] for b in kept)
        out[name] = dict(
            max_abs_err=err, render_pass_ms=pass_ms,
            render_pass_widths=[int(b[3].shape[0]) for b in kept],
            render_pass_triangles=kept[0][0].count,
            render_pass_issue_ms=issue(pass_ms,
                                       pairs * MT_PAIR_OPS)["issue_ms"])
        log(f"mt_kernel over the {len(kept)} launches of one 1024x1024 "
            f"{name} pass ({kept[0][0].count} triangles, widths "
            f"{out[name]['render_pass_widths']}): {pass_ms:.3f} ms, issue "
            f"floor {out[name]['render_pass_issue_ms']:.3f} ms")
    return out


def mt_host_split(torch, tris):
    """Host microseconds a call of `mt_kernel.intersect`, whole and by
    stage (the packed rows, kept from the first call; the checks; the
    four outputs; the launch): the host clock over 500 calls of 1024
    rays that are enqueued and not waited for."""
    from raytracingrenderer_tpu_torch.ops import mt_kernel
    from raytracingrenderer_tpu_torch.ops.launch import launch
    o, d, t_init, _ = make_rays(torch, 1024, seed=9, dead_frac=0.0)
    n, dev = 1024, t_init.device
    rows = mt_kernel.pack_tris(tris)
    arrays = (("o.x", o.x), ("o.y", o.y), ("o.z", o.z), ("d.x", d.x),
              ("d.y", d.y), ("d.z", d.z), ("t_init", t_init))
    outs = [torch.empty(n, dtype=dt, device=dev) for dt in
            (torch.float32, torch.int32, torch.float32, torch.float32)]
    fn = mt_kernel._library()["mt_intersect"]

    def per_call(f):
        return host_us_a_call(torch, f)

    us = dict(
        call=per_call(lambda: mt_kernel.intersect(tris, o, d, t_init)),
        pack=per_call(lambda: mt_kernel.pack_tris(tris)),
        checks=per_call(lambda: mt_kernel._check(rows, arrays, n)),
        empty=per_call(lambda: [
            torch.empty(n, dtype=x.dtype, device=dev) for x in outs]),
        launch=per_call(lambda: launch(
            fn, dev, rows.data_ptr(), rows.shape[0],
            *(a.data_ptr() for _, a in arrays),
            *(x.data_ptr() for x in outs), n)))
    log(f"mt_kernel: host us a call of intersect, whole and by stage (500 "
        f"calls of 1024 rays): { {k: round(v, 2) for k, v in us.items()} }")
    return us


def capture_b2_inputs(torch, scene):
    """One sample pass of the full-size render with B2's wrapper wrapped,
    keeping a copy of the inputs of every launch: the widths, ray order
    and seeds the main path gives the kernel (coherence-sorted rays;
    any-hit seeds negated where the proxy pre-pass resolved the ray).
    -> [(any_hit, o, d, t_init)]."""
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.ops import bvh_kernel
    from raytracingrenderer_tpu_torch.render import render
    real = bvh_kernel.traverse_packet
    kept = []

    def keep(bvh, tris, o, d, t_init, any_hit=False, leaf16=None,
             wide=None):
        if o.x.shape[0]:
            kept.append((any_hit, V3(*(c.clone() for c in o)),
                         V3(*(c.clone() for c in d)), t_init.clone()))
        return real(bvh, tris, o, d, t_init, any_hit, leaf16, wide)

    bvh_kernel.traverse_packet = keep
    try:
        render(scene, RenderConfig(**BENCH_CFG), spp=1)
    finally:
        bvh_kernel.traverse_packet = real
    torch.cuda.synchronize()
    return kept


def check_bvh_kernel(torch, scene):
    """B2 vs plain on the card at the spheres scene, bit for bit (max
    |dt| = 0, every id, u, v and bit equal, no dead lane hit), per
    variant: (a) a random batch with dead lanes, (b) a live random batch,
    which also times the kernel and the plain version, (c) every launch
    of one sample pass of the render, then timed as a pass (the sum over
    its launches: the main path's shapes).  Any-hit is also timed over
    raw leaves (`leaf16=False`; the default is the constant form).
    Beside the bound, the walk's traffic: node rows and tested slots,
    and the time it would take at the device-memory rate; and the host's
    microseconds a call of the wrapper.  Returns per variant
    the numbers of the kernels line."""
    from raytracingrenderer_tpu_torch.ops import bvh_kernel
    bvh, tris = scene.bvh, scene.triangles
    out = {v: dict(max_abs_err=0.0, mismatches=0, checked_rays=0,
                   checked_batches=0) for v in ("closest_hit", "any_hit")}

    def kernel(o, d, t_init, any_hit, leaf16=None):
        return bvh_kernel.traverse_packet(bvh, tris, o, d, t_init,
                                          any_hit=any_hit, leaf16=leaf16)

    def plain(o, d, t_init, any_hit, leaf16=None):
        return bvh_kernel.traverse_plain(bvh, tris, o, d, t_init,
                                         any_hit=any_hit, leaf16=leaf16)

    def check(what, t_init, any_hit, k, p, min_hit_frac=None):
        variant = "any_hit" if any_hit else "closest_hit"
        if any_hit:
            k, p = k.tri >= 0, p.tri >= 0
        err, mism = compare(torch, f"bvh_kernel {variant} {what}", t_init,
                            k, p, any_hit, min_hit_frac, exact=True)
        r = out[variant]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["mismatches"] += mism
        r["checked_rays"] += t_init.shape[0]
        r["checked_batches"] += 1

    # (a) random rays with dead lanes, a width that is no multiple
    o, d, t_closest, t_any = make_rays(torch, N_BVH_CHECK, seed=4)
    for t_init, any_hit in ((t_closest, False), (t_any, True)):
        check("random with dead lanes", t_init, any_hit,
              kernel(o, d, t_init, any_hit), plain(o, d, t_init, any_hit),
              0.1)
    check("random with dead lanes, raw leaves", t_any, True,
          kernel(o, d, t_any, True, False), plain(o, d, t_any, True, False),
          0.1)
    # (b) live random rays: kernel and plain timed at the same width
    o, d, t_closest, t_any = make_rays(torch, N_TIMED, seed=5,
                                       dead_frac=0.0)
    for t_init, any_hit in ((t_closest, False), (t_any, True)):
        variant = "any_hit" if any_hit else "closest_hit"
        ms = time_ms(torch, lambda: kernel(o, d, t_init, any_hit), 10)
        before = dict(bvh_kernel.plain_visits)
        p, plain_ms = time_once(torch, lambda: plain(o, d, t_init, any_hit))
        visits = {k: bvh_kernel.plain_visits[k] - before[k]
                  for k in before}
        check("random, live", t_init, any_hit, kernel(o, d, t_init, any_hit),
              p, 0.1)
        # the work the function needs: a node visit a node row, a triangle
        # test a filled slot (an any-hit ray's up to its first hit)
        leaf_ops = LEAF16_OPS if any_hit else LEAF9_OPS
        ops = visits["internal"] * NODE_OPS + visits["slots"] * leaf_ops
        # the count of earlier revisions, every leaf visit as 14 tests, kept
        # beside it so that the share reads against the earlier ones
        ops14 = (visits["internal"] * NODE_OPS
                 + visits["leaf"] * LEAF_SLOTS * leaf_ops)
        nodes, leaves = bvh_kernel.tables(bvh, tris, any_hit)
        table_bytes = sum(t.numel() * t.element_size()
                          for t in (nodes, leaves))
        nbytes = N_TIMED * RAY_BYTES + table_bytes
        # what the walk reads: a node row a node visit; a leaf visit the 16
        # bytes that hold the row's count, then 36 bytes (64 in the constant
        # form) a slot tested; and the rays
        slot_bytes = 64 if any_hit else 36
        traffic = (visits["internal"] * nodes.shape[1] * 4
                   + visits["leaf"] * 16 + visits["slots"] * slot_bytes
                   + N_TIMED * RAY_BYTES)
        b14 = bound(ms, ops14, nbytes)
        out[variant].update(ms=ms, plain_ms=plain_ms, rays=N_TIMED,
                            plain_rays=N_TIMED, node_visits=visits,
                            table_bytes=table_bytes, traffic_bytes=traffic,
                            traffic_ms=traffic / PEAK_BYTES * 1e3,
                            bound_ms_14_slots=b14["bound_ms"],
                            bound_share_14_slots=b14["bound_share"],
                            **bound(ms, ops, nbytes))
        log(f"bvh_kernel {variant}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms at {N_TIMED} rays ({tris.count} triangles); "
            f"visits {visits}, bound {out[variant]['bound_ms']:.4f} ms "
            f"({out[variant]['bound_by']}), share "
            f"{out[variant]['bound_share']:.4f} (counting 14 tests a leaf "
            f"visit, as earlier runs did: {b14['bound_ms']:.4f} ms, "
            f"{b14['bound_share']:.4f}); tables {table_bytes} B, traffic "
            f"(node rows and tested slots) {traffic} B, "
            f"{out[variant]['traffic_ms']:.4f} ms at the memory rate")
    raw_ms = time_ms(torch, lambda: kernel(o, d, t_any, True, False), 10)
    out["any_hit"]["ms_raw_leaves"] = raw_ms
    # the host's cost of a call of the wrapper (seeds, outputs, pointers,
    # the launch): a batch so narrow that the device never sets the pace
    so, sd, st, _ = make_rays(torch, 1024, seed=8, dead_frac=0.0)
    kernel(so, sd, st, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(500):
        kernel(so, sd, st, False)
    host_us = (time.perf_counter_ns() - t0) / 500 / 1e3
    torch.cuda.synchronize()
    out["closest_hit"]["host_us_call"] = host_us
    log(f"bvh_kernel: the host spends {host_us:.1f} us a call of "
        f"traverse_packet (500 calls of 1024 rays)")
    # (c) what the render gives the kernel
    t0 = time.perf_counter()
    batches = capture_b2_inputs(torch, scene)
    for i, (any_hit, o, d, t_init) in enumerate(batches):
        check(f"render launch {i}", t_init, any_hit,
              kernel(o, d, t_init, any_hit), plain(o, d, t_init, any_hit))
    if {b[0] for b in batches} != {False, True}:
        fail("one sample pass of the spheres render did not launch both "
             "bvh_kernel variants")
    log(f"bvh_kernel: {len(batches)} launches of one sample pass checked "
        f"in {time.perf_counter() - t0:.2f} s")

    def pass_ms(any_hit, leaf16=None):
        mine = [b for b in batches if b[0] == any_hit]
        return time_ms(torch, lambda: [kernel(o, d, t_init, any_hit, leaf16)
                                       for _, o, d, t_init in mine], 10)

    for any_hit, variant in ((False, "closest_hit"), (True, "any_hit")):
        out[variant]["render_pass_ms"] = pass_ms(any_hit)
        out[variant]["render_pass_widths"] = [
            int(b[3].shape[0]) for b in batches if b[0] == any_hit]
    for _, o, d, t_init in (b for b in batches if b[0]):
        check("render launch, raw leaves", t_init, True,
              kernel(o, d, t_init, True, False),
              plain(o, d, t_init, True, False))
    out["any_hit"]["render_pass_ms_raw_leaves"] = pass_ms(True, False)
    log(f"bvh_kernel over the launches of one 1024x1024 sample pass: "
        f"closest-hit {out['closest_hit']['render_pass_ms']:.3f} ms (widths "
        f"{out['closest_hit']['render_pass_widths']}), any-hit "
        f"{out['any_hit']['render_pass_ms']:.3f} ms (widths "
        f"{out['any_hit']['render_pass_widths']}); any-hit over raw leaves "
        f"{out['any_hit']['render_pass_ms_raw_leaves']:.3f} ms a pass, "
        f"{raw_ms:.3f} ms at {N_TIMED} random rays (constant form "
        f"{out['any_hit']['ms']:.3f} ms)")
    return out, batches


def check_wide_kernel(torch, scene, batches):
    """B3 (`traverse_packet(..., wide=True)`) against its plain version
    on the card at the spheres scene, bit for bit (max |dt| = 0, every id
    and bit equal, no dead lane hit), per variant: (a) the path: the
    coherence-sorted bounce rays (closest-hit) and shadow rays (any-hit)
    of one 1024x1024 sample pass, as scripts/probe_wide.py feeds the wide
    kernel, walked with the counts set to 0 just before, then timed over
    those launches beside B2 on the same batches (both leaf forms); (b)
    2^20 + 77 random rays with 10% dead lanes; (c) 2^20 live random rays,
    which also time B3, B2 and the plain wide walk, beside the bound and
    the walk's traffic.  Returns per variant the numbers of the kernels
    line."""
    from raytracingrenderer_tpu_torch.ops import bvh_kernel
    bvh, tris = scene.bvh, scene.triangles
    out = {v: dict(max_abs_err=0.0, mismatches=0, checked_rays=0,
                   checked_batches=0) for v in ("closest_hit", "any_hit")}

    def kernel(o, d, t_init, any_hit, wide=True):
        return bvh_kernel.traverse_packet(bvh, tris, o, d, t_init,
                                          any_hit=any_hit, wide=wide)

    def plain(o, d, t_init, any_hit):
        return bvh_kernel.traverse_plain(bvh, tris, o, d, t_init,
                                         any_hit=any_hit, wide=True)

    def check(what, t_init, any_hit, k, p, min_hit_frac=None):
        variant = "any_hit" if any_hit else "closest_hit"
        if any_hit:
            k, p = k.tri >= 0, p.tri >= 0
        err, mism = compare(torch, f"bvh_kernel wide {variant} {what}",
                            t_init, k, p, any_hit, min_hit_frac, exact=True)
        r = out[variant]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["mismatches"] += mism
        r["checked_rays"] += t_init.shape[0]
        r["checked_batches"] += 1

    # (a) the path: bounce rays (closest-hit launches after the primary
    # one) and shadow rays (any-hit launches) of one sample pass
    path = [b for i, b in enumerate(batches)
            if b[0] or any(not a for a, *_ in batches[:i])]
    for k in ("wide_closest_hit", "wide_any_hit"):
        bvh_kernel.launches[k] = 0
    t0 = time.perf_counter()
    hits = [kernel(o, d, t_init, any_hit) for any_hit, o, d, t_init in path]
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = {k: bvh_kernel.launches[k]
              for k in ("wide_closest_hit", "wide_any_hit")}
    log(f"bvh_kernel wide path: {len(path)} sorted bounce and shadow "
        f"batches of one 1024x1024 pass (widths "
        f"{[int(b[3].shape[0]) for b in path]}) in {path_s:.3f} s, "
        f"launches {counts}")
    if min(counts.values()) == 0:
        fail("the wide path did not launch both B3 variants")
    for i, ((any_hit, o, d, t_init), h) in enumerate(zip(path, hits)):
        check(f"pass batch {i}", t_init, any_hit, h,
              plain(o, d, t_init, any_hit))

    def pass_ms(any_hit, wide, leaf16=None):
        """CUDA events over the path's launches of a variant, back to back
        (B3, or B2 over either leaf form on the same batches)."""
        mine = [b for b in path if b[0] == any_hit]
        return time_ms(torch, lambda: [bvh_kernel.traverse_packet(
            bvh, tris, o, d, t_init, any_hit=any_hit, leaf16=leaf16,
            wide=wide) for _, o, d, t_init in mine], 10)

    for any_hit, variant in ((False, "closest_hit"), (True, "any_hit")):
        out[variant].update(
            render_pass_ms=pass_ms(any_hit, True),
            render_pass_widths=[int(b[3].shape[0]) for b in path
                                if b[0] == any_hit],
            b2_render_pass_ms=pass_ms(any_hit, False),
            b2_raw_leaves_render_pass_ms=pass_ms(any_hit, False, False))
        log(f"bvh_kernel wide {variant} over the pass's "
            f"{len(out[variant]['render_pass_widths'])} launches: B3 "
            f"{out[variant]['render_pass_ms']:.4f} ms, B2 "
            f"{out[variant]['b2_render_pass_ms']:.4f} ms (raw leaves "
            f"{out[variant]['b2_raw_leaves_render_pass_ms']:.4f} ms)")
    # (b) random rays with dead lanes, a width that is no multiple
    o, d, t_closest, t_any = make_rays(torch, N_BVH_CHECK, seed=6)
    for t_init, any_hit in ((t_closest, False), (t_any, True)):
        check("random with dead lanes", t_init, any_hit,
              kernel(o, d, t_init, any_hit), plain(o, d, t_init, any_hit),
              0.1)
    # (c) live random rays: B3, B2 and the plain wide walk timed
    o, d, t_closest, t_any = make_rays(torch, N_TIMED, seed=7,
                                       dead_frac=0.0)
    for t_init, any_hit in ((t_closest, False), (t_any, True)):
        variant = "any_hit" if any_hit else "closest_hit"
        ms = time_ms(torch, lambda: kernel(o, d, t_init, any_hit), 10)
        b2_ms = time_ms(torch, lambda: kernel(o, d, t_init, any_hit,
                                              wide=False), 10)
        # B2 over the raw leaves B3 reads (any-hit defaults to the
        # constant-form ones)
        b2_raw_ms = time_ms(torch, lambda: bvh_kernel.traverse_packet(
            bvh, tris, o, d, t_init, any_hit=any_hit, leaf16=False), 10)
        before = dict(bvh_kernel.plain_visits)
        p, plain_ms = time_once(torch, lambda: plain(o, d, t_init, any_hit))
        visits = {k: bvh_kernel.plain_visits[k] - before[k]
                  for k in before}
        check("random, live", t_init, any_hit, kernel(o, d, t_init, any_hit),
              p, 0.1)
        ops = visits["internal"] * WIDE_OPS + visits["slots"] * LEAF9_OPS
        ops14 = (visits["internal"] * WIDE_OPS
                 + visits["leaf"] * LEAF_SLOTS * LEAF9_OPS)
        nodes, leaves = bvh_kernel.tables(bvh, tris, False, wide=True)
        table_bytes = sum(t.numel() * t.element_size()
                          for t in (nodes, leaves))
        nbytes = N_TIMED * RAY_BYTES + table_bytes
        # what the walk reads, as B2's traffic: a wide row a node visit,
        # 16 bytes and 36 a tested slot a leaf visit, and the rays
        traffic = (visits["internal"] * nodes.shape[1] * 4
                   + visits["leaf"] * 16 + visits["slots"] * 36
                   + N_TIMED * RAY_BYTES)
        b14 = bound(ms, ops14, nbytes)
        out[variant].update(launches=counts["wide_" + variant], ms=ms,
                            plain_ms=plain_ms, b2_ms=b2_ms,
                            b2_raw_leaves_ms=b2_raw_ms, rays=N_TIMED,
                            node_visits=visits, table_bytes=table_bytes,
                            traffic_bytes=traffic,
                            traffic_ms=traffic / PEAK_BYTES * 1e3,
                            bound_ms_14_slots=b14["bound_ms"],
                            bound_share_14_slots=b14["bound_share"],
                            **bound(ms, ops, nbytes))
        log(f"bvh_kernel wide {variant}: B3 {ms:.3f} ms, B2 {b2_ms:.3f} ms "
            f"(raw leaves {b2_raw_ms:.3f} ms), plain wide {plain_ms:.3f} ms "
            f"at {N_TIMED} rays ({tris.count} triangles); visits {visits}, "
            f"bound {out[variant]['bound_ms']:.4f} ms "
            f"({out[variant]['bound_by']}), share "
            f"{out[variant]['bound_share']:.4f} (counting 14 tests a leaf "
            f"visit: {b14['bound_ms']:.4f} ms, {b14['bound_share']:.4f}); "
            f"tables {table_bytes} B, traffic {traffic} B, "
            f"{out[variant]['traffic_ms']:.4f} ms at the memory rate")
    return out


def capture_treelet_calls(torch, scene):
    """One sample pass of the treelet render with the pair test and the
    candidate stage watched -> (the pair-test inputs of every call,
    [(consts, feats, tid)]; the first call's overflow flags and live
    lanes: the primary closest-hit call at full width)."""
    from raytracingrenderer_tpu_torch.ops import treelet
    from raytracingrenderer_tpu_torch.probes import capture_pass
    pairs, first = [], {}
    real_cands = treelet.candidates

    def cands(bvh, o, d, t_seed):
        slots, over = real_cands(bvh, o, d, t_seed)
        first.setdefault("overflow", (over.clone(), t_seed > 0.0))
        return slots, over

    treelet.candidates = cands
    try:
        capture_pass(scene, [(treelet, "pair_test",
                              lambda consts, feats, tid: pairs.append(
                                  (consts, feats.clone(), tid.clone())))],
                     **BENCH_CFG)
    finally:
        treelet.candidates = real_cands
    return pairs, first["overflow"]


def check_pair_kernel(torch, scene):
    """B4 against `pair_test_plain` on the pairs of every `pair_test`
    call of one sample pass of the treelet route, bit for bit (t and
    col); the first call (the primary closest-hit call at full width)
    and the pass timed.  Returns the numbers of the kernels line."""
    from raytracingrenderer_tpu_torch.ops import treelet
    calls, (over, active) = capture_treelet_calls(torch, scene)
    n_rays = int(over.shape[0])
    share = over[active].float().mean().item()
    err, mism, plain_ms = 0.0, 0, None
    for i, (consts, feats, tid) in enumerate(calls):
        tk, ck = treelet.pair_test(consts, feats, tid)
        (tp, cp), ms_p = time_once(torch, lambda: treelet.pair_test_plain(
            consts, feats, tid))
        plain_ms = ms_p if plain_ms is None else plain_ms
        e = (tk - tp).abs().max().item() if tid.shape[0] else 0.0
        m = int((ck != cp).sum())
        log(f"treelet_pair_test call {i}: {tid.shape[0]} pairs "
            f"({consts.shape[0] // 16} treelets), "
            f"{(tp < treelet.INF).float().mean().item():.3f} of pairs hit, "
            f"max_abs_err {e:.3e}, {m} columns differ")
        if not (torch.equal(tk, tp) and torch.equal(ck, cp)):
            fail("the pair-test kernel disagrees with pair_test_plain")
        err, mism = max(err, e), mism + m
    log(f"treelet_pair_test: {len(calls)} calls of one pass equal the plain "
        f"version bit for bit; {share:.4%} of the first call's live rays "
        f"overflowed to B2")
    consts, feats, tid = calls[0]
    ms = time_ms(torch, lambda: treelet.pair_test(consts, feats, tid), 20)
    pass_ms = time_ms(torch, lambda: [treelet.pair_test(*c) for c in calls],
                      10)
    pairs = int(tid.shape[0])
    pass_pairs = sum(int(c[2].shape[0]) for c in calls)
    nbytes = (consts.numel() * 4 + pairs * (feats.shape[1] * 4 + 4 + 8))
    ops = pairs * treelet.T_LEAF * PAIR_OPS
    b = dict(bound(ms, ops, nbytes), **issue(ms, ops))
    pass_issue = issue(pass_ms, pass_pairs * treelet.T_LEAF * PAIR_OPS)
    # the same pairs with the four 16-deep contractions on the tensor
    # cores in TF32 (dense, 2 * 16 * 4 * T_LEAF a pair, as the TPU kernel
    # runs them) and the rest on the FP32 pipes
    b_tf32 = bound(ms, pairs * treelet.T_LEAF * PAIR_EPI_OPS, nbytes,
                   tf32_ops=pairs * 2 * 16 * 4 * treelet.T_LEAF)
    log(f"treelet_pair_test: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms at "
        f"{pairs} pairs; bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
        f"FP32), share {b['bound_share']:.4f}; issue floor without FMA "
        f"{b['issue_ms']:.4f} ms, share {b['issue_share']:.4f}; with TF32 "
        f"contractions {b_tf32['bound_ms']:.4f} ms ({b_tf32['bound_by']}); "
        f"over the pass's {len(calls)} calls ({pass_pairs} pairs) "
        f"{pass_ms:.3f} ms, issue floor {pass_issue['issue_ms']:.3f} ms")
    return dict(max_abs_err=err, mismatches=mism, ms=ms, plain_ms=plain_ms,
                pairs=pairs, rays=n_rays, overflow_share=share,
                library_ms=None, **b, tf32_bound_ms=b_tf32["bound_ms"],
                render_pass_ms=pass_ms,
                render_pass_pairs=[int(c[2].shape[0]) for c in calls],
                render_pass_issue_ms=pass_issue["issue_ms"])


def visit_bound(cfg, ms):
    """Bound keys of one visit run from its shapes (`probes.visit_work`:
    the contraction's 2 * 16 operations a column, one min a column or the
    epilogue's operations a triangle; the distinct tiles visited, the
    features, the rows written).  In TF32 the multiply-adds go to the
    tensor cores.  A fp32 run also gets `issue_ms`: built without FMA a
    multiply-add is two instructions, so its operations are as many FP32
    instructions, and the card issues PEAK_FP32 / 2 of them a second;
    `issue_share` is that floor over the measured time.  A TF32 run gets
    `min_issue_ms`, its mins alone (one a column) at that rate beside the
    tensor cores' `bound_ms`: which of the two limits the kernel stands
    against."""
    from raytracingrenderer_tpu_torch.probes import visit_work
    w = visit_work(cfg)
    if cfg["precision"] == "default":
        mins = issue(ms, w["other"])
        return dict(bound(ms, w["other"], w["bytes"], tf32_ops=w["mac"]),
                    min_issue_ms=mins["issue_ms"],
                    min_issue_share=mins["issue_share"])
    ops = w["mac"] + w["other"]
    return dict(bound(ms, ops, w["bytes"]), **issue(ms, ops))


def check_visit_edges(torch):
    """The fp32 min visit against its plain version, bit for bit, at the
    shapes its partition could break: TT 32, 96, 128 and 512 (a warp's
    slice of 4, 12, 16 and 64 columns), 0, 1, 2, 7 and 64 visits (a ring
    of three that is never, partly or often refilled), 1 and 64 tiles,
    128 and 4096 rays a block, in the three tile modes.  -> the number of
    shapes checked, by tile mode."""
    import numpy as np
    from raytracingrenderer_tpu_torch.ops import visit
    n = {}
    for tile in ("dynamic", "static", "batched8"):
        n[tile] = 0
        for tt in (32, 96, 128, 512):
            for n_tiles in (1, 64):
                if tile == "batched8" and n_tiles < 8:
                    continue
                g = np.random.default_rng(tt + n_tiles)
                tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt))
                                       .astype(np.float32)).cuda()
                for r in (128, 4096):
                    feats = torch.from_numpy(g.normal(size=(2 * 16, r))
                                             .astype(np.float32)).cuda()
                    for n_visits in (0, 1, 2, 7, 64):
                        kw = dict(n_visits=n_visits, n_tiles=n_tiles,
                                  tile=tile)
                        tk, ok = visit.visit(tab, feats, **kw)
                        tp, op = visit.visit_plain(tab, feats, **kw)
                        if not (torch.equal(tk, tp) and torch.equal(ok, op)):
                            fail(f"visit/{tile}-min-ray-highest TT={tt} "
                                 f"V={n_visits} tiles={n_tiles} R={r}: "
                                 f"differs from the plain version (bit for "
                                 f"bit expected)")
                        n[tile] += 1
    torch.cuda.synchronize()
    return n


def check_mt_tf32_edges(torch):
    """The MT visit against its plain version bit for bit, and the TF32
    visit within visit.TF32_KERNEL_BOUND, at the shapes their partitions
    could break: TT 32, 96, 128 and 512 (a lane with no group of 4
    triangles, one or four; 1 to 4 wgmma steps a visit), 0, 1, 2, 7 and
    64 visits (a ring never, partly or often refilled; the MT visit's
    exchange of the best t never used), 1 and 64 tiles, 128 and 4096
    rays.  -> the
    number of shapes checked, and the TF32 visit's largest |dt| over sum
    |a f|."""
    import numpy as np
    from raytracingrenderer_tpu_torch.ops import visit
    n, worst = 0, 0.0
    for tt in (32, 96, 128, 512):
        for n_tiles in (1, 64):
            g = np.random.default_rng(tt + n_tiles)
            tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt))
                                   .astype(np.float32)).cuda()
            for r in (128, 4096):
                feats = torch.from_numpy(g.normal(size=(2 * 16, r))
                                         .astype(np.float32)).cuda()
                for n_visits in (0, 1, 2, 7, 64):
                    kw = dict(n_visits=n_visits, n_tiles=n_tiles)
                    what = f"TT={tt} V={n_visits} tiles={n_tiles} R={r}"
                    tk, ok = visit.visit(tab, feats, reduce="mt", **kw)
                    tp, op = visit.visit_plain(tab, feats, reduce="mt", **kw)
                    if not (torch.equal(tk, tp) and torch.equal(ok, op)):
                        fail(f"visit/dynamic-mt-ray-highest {what}: differs "
                             f"from the plain version (bit for bit "
                             f"expected)")
                    tk, ok = visit.visit(tab, feats, precision="default",
                                         **kw)
                    tp, op = visit.visit_plain(tab, feats,
                                               precision="default", **kw)
                    scale = visit.visit_tf32_scale(tab, feats, **kw)
                    ratio = ((tk - tp).abs() / scale).max().item()
                    if not torch.equal(ok, op) or \
                            ratio > visit.TF32_KERNEL_BOUND:
                        fail(f"visit/dynamic-min-ray-default {what}: |dt| "
                             f"reaches {ratio:.3e} of sum |a f| (bound "
                             f"{visit.TF32_KERNEL_BOUND:.3e}), or the "
                             f"feature sums differ")
                    worst = max(worst, ratio)
                    n += 1
    torch.cuda.synchronize()
    return n, worst


def check_lane_edges(torch):
    """The lane visit against its plain version, bit for bit, at the
    shapes its partition could break: 0, 1, 2, 7 and 64 visits (a ring of
    three never, partly or often refilled), 1 and 64 tiles, 128 and 4096
    rays, 1 and 8 blocks.  -> the number of shapes checked."""
    import numpy as np
    from raytracingrenderer_tpu_torch.ops import visit
    n = 0
    for n_visits in (0, 1, 2, 7, 64):
        for n_tiles in (1, 64):
            g = np.random.default_rng(n_visits + n_tiles)
            tab = torch.from_numpy(g.normal(size=(n_tiles * 16,
                                                  visit.LANE_TT))
                                   .astype(np.float32)).cuda()
            for r in (128, 4096):
                for blocks in (1, 8):
                    feats = torch.from_numpy(g.normal(size=(
                        blocks * 16, r)).astype(np.float32)).cuda()
                    kw = dict(n_visits=n_visits, n_tiles=n_tiles,
                              layout="lane")
                    tk, ok = visit.visit(tab, feats, **kw)
                    tp, op = visit.visit_plain(tab, feats, **kw)
                    if not (torch.equal(tk, tp) and torch.equal(ok, op)):
                        fail(f"visit/dynamic-min-lane-highest V={n_visits} "
                             f"tiles={n_tiles} R={r} blocks={blocks}: "
                             f"differs from the plain version (bit for bit "
                             f"expected)")
                    n += 1
    torch.cuda.synchronize()
    return n


def check_first8_edges(torch):
    """first8 against its plain version, bit for bit, at the shapes its
    partition could break: TT 32, 96, 128 and 512, 0, 1, 2, 7 and 64
    visits (a visit group with none or some; at most 16 a warp, one a
    slot), 1, 7 and 64 tiles, 128 and 4096 rays, 1 and 8 blocks, and 160
    visits of 128 tiles (more visits than a warp's slots: its ring
    refilled).  -> the number of shapes checked."""
    import numpy as np
    from raytracingrenderer_tpu_torch.ops import visit
    rays_blocks = ((128, 1), (4096, 8), (4096, 1), (128, 8))
    shapes = [(tt, v, n) + rays_blocks[i % 4] for i, (tt, v, n) in
              enumerate((tt, v, n) for tt in (32, 96, 128, 512)
                        for v in (0, 1, 2, 7, 64) for n in (1, 7, 64))]
    shapes += [(tt, 160, 128, r, blocks) for tt in (32, 128)
               for r, blocks in ((128, 8), (4096, 1))]
    for tt, n_visits, n_tiles, r, blocks in shapes:
        g = np.random.default_rng(tt + n_visits + n_tiles)
        tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt))
                               .astype(np.float32)).cuda()
        feats = torch.from_numpy(g.normal(size=(blocks * 16, r))
                                 .astype(np.float32)).cuda()
        kw = dict(n_visits=n_visits, n_tiles=n_tiles, reduce="first8")
        tk, ok = visit.visit(tab, feats, **kw)
        tp, op = visit.visit_plain(tab, feats, **kw)
        if not (torch.equal(tk, tp) and torch.equal(ok, op)):
            fail(f"visit/dynamic-first8-ray-highest TT={tt} V={n_visits} "
                 f"tiles={n_tiles} R={r} blocks={blocks}: differs from "
                 f"the plain version (bit for bit expected)")
    torch.cuda.synchronize()
    return len(shapes)


def check_probes(torch, card):
    """Phase 12: the probes' entry points with the visit counts set to 0
    just before (main path 4), then every kernel of visit_kernel.cu
    against its plain version at the probes' sizes, timed.  Returns the
    kernels line's entries."""
    import numpy as np
    from raytracingrenderer_tpu_torch.ops import visit
    from raytracingrenderer_tpu_torch.probes import (device_ms, flops,
                                                     inputs, probe_mxu,
                                                     probe_mxu2, probe_mxu3,
                                                     visit_args)
    src = dict(route="cuda",
               source="raytracingrenderer_tpu_torch/csrc/visit_kernel.cu")
    mods = (probe_mxu, probe_mxu2, probe_mxu3)
    for k in visit.launches:
        visit.launches[k] = 0
    t0 = time.perf_counter()
    for mod in mods:
        log(f"-- {mod.__name__} (python -m {mod.__name__})")
        mod.main()
    counts = dict(visit.launches)
    log(f"probes: the three entry points ran in "
        f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    if min(counts.values()) == 0:
        fail("the probes did not launch every kernel of visit_kernel.cu")

    replaces = {
        ("dynamic", "min", "ray", "highest"):
            "scripts/probe_mxu2.py:58 (k_full; probe_mxu.py:51 visit_kernel "
            "at HIGHEST, probe_mxu3.py:29)",
        ("dynamic", "min", "ray", "default"):
            "scripts/probe_mxu.py:51 (visit_kernel at DEFAULT)",
        ("dynamic", "mt", "ray", "highest"):
            "scripts/probe_mxu.py:51 (visit_kernel, epilogue=True)",
        ("static", "min", "ray", "highest"): "scripts/probe_mxu2.py:75",
        ("dynamic", "first8", "ray", "highest"): "scripts/probe_mxu2.py:91",
        ("dynamic", "min", "lane", "highest"): "scripts/probe_mxu2.py:107",
        ("batched8", "min", "ray", "highest"): "scripts/probe_mxu2.py:126",
    }
    entries, seen = {}, set()
    for mod in mods:
        for cfg in mod.CONFIGS:
            variant = (cfg["tile"], cfg["reduce"], cfg["layout"],
                       cfg["precision"])
            key = (variant, cfg["tt"], cfg["n_visits"], cfg["n_tiles"],
                   cfg["blocks"])
            if key in seen:
                continue
            seen.add(key)
            kw = visit_args(cfg)
            tab, feats = inputs(cfg["n_tiles"], cfg["tt"], cfg["blocks"],
                                "cuda")
            tk, ok = visit.visit(tab, feats, **kw)
            (tp, op), plain_ms = time_once(
                torch, lambda: visit.visit_plain(tab, feats, **kw))
            err = (tk - tp).abs().max().item()
            what = (f"visit/{visit.variant_name(*variant)} TT={cfg['tt']} "
                    f"V={cfg['n_visits']} tiles={cfg['n_tiles']} "
                    f"blocks={cfg['blocks']}")
            if not torch.equal(ok, op):
                fail(f"{what}: the feature sums differ from the plain "
                     f"version's")
            if cfg["precision"] == "highest":
                ratio = None
                if not torch.equal(tk, tp):
                    fail(f"{what}: max |dt| {err:.3e} against the plain "
                         f"version (bit for bit expected)")
            else:
                scale = visit.visit_tf32_scale(
                    tab, feats, n_visits=cfg["n_visits"],
                    n_tiles=cfg["n_tiles"], tile=cfg["tile"],
                    layout=cfg["layout"])
                ratio = ((tk - tp).abs() / scale).max().item()
                if ratio > visit.TF32_KERNEL_BOUND:
                    fail(f"{what}: |dt| reaches {ratio:.3e} of sum |a b|, "
                         f"above the bound {visit.TF32_KERNEL_BOUND:.3e}")
            ms = time_ms(torch, lambda: visit.visit(tab, feats, **kw), 20)
            # the kernels' own time: a short run's calls are host-bound
            # when the host is slow
            dev_ms = device_ms(lambda: visit.visit(tab, feats, **kw))
            b = visit_bound(cfg, ms)
            log(f"{what}: kernel {ms:.4f} ms ({flops(cfg) / ms / 1e9:.2f} "
                f"TFLOP/s by the scripts' count; device {dev_ms} ms), "
                f"plain {plain_ms:.3f} ms, "
                f"max_abs_err {err:.3e}"
                + ("" if ratio is None else
                   f" ({ratio:.3e} of sum |a b|, bound "
                   f"{visit.TF32_KERNEL_BOUND:.3e})")
                + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}), share "
                f"{b['bound_share']:.4f}"
                + (f"; issue floor without FMA {b['issue_ms']:.4f} ms, share "
                   f"{b['issue_share']:.4f}" if "issue_ms" in b else "")
                + (f"; the mins' FP32 issue floor {b['min_issue_ms']:.4f} ms,"
                   f" share {b['min_issue_share']:.4f}"
                   if "min_issue_ms" in b else "")
                + f" [{card}]")
            size = dict(tt=cfg["tt"], n_visits=cfg["n_visits"],
                        r=feats.shape[1],
                        n_tiles=cfg["n_tiles"], blocks=cfg["blocks"], ms=ms,
                        plain_ms=plain_ms, max_abs_err=err,
                        tf32_err_ratio=ratio, device_ms=dev_ms, **b)
            name = "visit/" + visit.variant_name(*variant)
            if name not in entries:
                entries[name] = dict(
                    name=name, **src, replaces=replaces[variant],
                    launches=counts[name], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, library_ms=None, **b,
                    device_ms=dev_ms, sizes=[])
            e = entries[name]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["sizes"].append(size)
            del tab, feats, tk, ok, tp, op

    t0 = time.perf_counter()
    edges = check_visit_edges(torch)
    log(f"visit/*-min-ray-highest: edge shapes {edges} (TT 32..512, 0..64 "
        f"visits, 1 and 64 tiles, 128 and 4096 rays) equal the plain version "
        f"bit for bit, {time.perf_counter() - t0:.2f} s")
    for tile, n in edges.items():
        entries[f"visit/{tile}-min-ray-highest"]["edge_shapes_checked"] = n
    t0 = time.perf_counter()
    n = check_lane_edges(torch)
    log(f"visit/dynamic-min-lane-highest: {n} edge shapes (0..64 visits, 1 "
        f"and 64 tiles, 128 and 4096 rays, 1 and 8 blocks) equal the plain "
        f"version bit for bit, {time.perf_counter() - t0:.2f} s")
    entries["visit/dynamic-min-lane-highest"]["edge_shapes_checked"] = n
    t0 = time.perf_counter()
    n, worst = check_mt_tf32_edges(torch)
    log(f"visit/dynamic-mt-ray-highest: {n} edge shapes (TT 32..512, 0..64 "
        f"visits, 1 and 64 tiles, 128 and 4096 rays) equal the plain version "
        f"bit for bit; visit/dynamic-min-ray-default at the same shapes "
        f"within {worst:.3e} of sum |a f| (bound "
        f"{visit.TF32_KERNEL_BOUND:.3e}), {time.perf_counter() - t0:.2f} s")
    entries["visit/dynamic-mt-ray-highest"]["edge_shapes_checked"] = n
    entries["visit/dynamic-min-ray-default"].update(
        edge_shapes_checked=n, edge_tf32_err_ratio=worst)
    t0 = time.perf_counter()
    n = check_first8_edges(torch)
    f8 = entries["visit/dynamic-first8-ray-highest"]
    f8.update(edge_shapes_checked=n, floor_ms=device_ms(
        lambda: visit.floor_launch("visit/dynamic-first8-ray-highest",
                                   f8["sizes"][0]["r"],
                                   f8["sizes"][0]["blocks"])))
    log(f"visit/dynamic-first8-ray-highest: {n} edge shapes (TT 32..512, "
        f"0..160 visits, 1..128 tiles, 128 and 4096 rays, 1 and 8 blocks) "
        f"equal the plain version bit for bit, "
        f"{time.perf_counter() - t0:.2f} s; at the probe's shape "
        f"{f8['ms']:.4f} ms (device {f8['device_ms']} ms), issue floor "
        f"without FMA {f8['issue_ms']:.4f} "
        f"ms (share {f8['issue_share']:.4f}), an empty launch of its grid "
        f"{f8['floor_ms']} ms [{card}]")

    # the dot (P1b) in both precisions; torch.matmul as the yardstick
    a, b_in = probe_mxu.precision_inputs("cuda")
    ref = a.double().cpu().numpy().T @ b_in.double().cpu().numpy()
    tt, r = a.shape[1], b_in.shape[1]
    saved = torch.backends.cuda.matmul.allow_tf32
    for prec in ("highest", "default"):
        k = visit.dot(a, b_in, prec)
        p, plain_ms = time_once(torch, lambda: visit.dot_plain(a, b_in, prec))
        err = (k - p).abs().max().item()
        ratio = None
        if prec == "highest":
            if not torch.equal(k, p):
                fail(f"dot/highest: max |d| {err:.3e} against the plain "
                     f"version (bit for bit expected)")
        else:
            ratio = ((k - p).abs() / visit.tf32_scale(a, b_in)).max().item()
            if ratio > visit.TF32_KERNEL_BOUND:
                fail(f"dot/default: |d| reaches {ratio:.3e} of sum |a b|")
        rel = np.abs(k.cpu().numpy() - ref) / np.maximum(np.abs(ref), 1e-3)
        ms = time_ms(torch, lambda: visit.dot(a, b_in, prec), 200)
        dev_ms = device_ms(lambda: visit.dot(a, b_in, prec))
        floor_ms = device_ms(lambda: visit.floor_launch(f"dot/{prec}", tt, r))
        try:
            torch.backends.cuda.matmul.allow_tf32 = prec == "default"
            lib_ms = time_ms(torch, lambda: torch.matmul(a.t(), b_in), 200)
            lib_dev_ms = device_ms(lambda: torch.matmul(a.t(), b_in))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        host_us = dot_host_split(torch, a, b_in, prec)
        nbytes = (16 * tt + 16 * r + tt * r) * 4
        mac = 2 * 16 * tt * r
        bd = bound(ms, 0, nbytes, tf32_ops=mac) if prec == "default" \
            else bound(ms, mac, nbytes)
        log(f"dot/{prec}: kernel {ms:.4f} ms (device {dev_ms} ms; an empty "
            f"launch of its grid, the card's floor, {floor_ms} ms), plain "
            f"{plain_ms:.4f} ms, torch.matmul (allow_tf32="
            f"{prec == 'default'}) {lib_ms:.4f} ms (device {lib_dev_ms} ms);"
            f" max |kernel - plain| {err:.3e}; against float64 median "
            f"{np.median(rel):.2e}, max {rel.max():.2e}; bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}), share "
            f"{bd['bound_share']:.4f}; host us a call "
            f"{ {k: round(v, 2) for k, v in host_us.items()} } [{card}]")
        entries[f"dot/{prec}"] = dict(
            name=f"dot/{prec}", **src,
            replaces="scripts/probe_mxu.py:133 (inner k, call :139)",
            launches=counts[f"dot/{prec}"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, **bd,
            device_ms=dev_ms, library_device_ms=lib_dev_ms,
            floor_ms=floor_ms, host_us=host_us, tf32_err_ratio=ratio,
            rel_err_f64_median=float(np.median(rel)),
            rel_err_f64_max=float(rel.max()))

    # the relayout loop (P1c): x + n_iter exactly on the probe's zeros, and
    # the plain loop bit for bit on values where n_iter roundings differ
    # from one addition (normal, >= 2^25, fractions)
    from raytracingrenderer_tpu_torch.probes.bench_visit import relayout_input
    x = torch.zeros((probe_mxu.RELAYOUT_BLOCKS * 32, 128), device="cuda")
    xr = relayout_input(x.shape, "cuda", seed=5)
    per = {}
    floor_ms = device_ms(lambda: visit.floor_launch("relayout", x.numel()))
    for n_iter in (1, 65):
        k = visit.relayout_loop(x, n_iter)
        p, plain_ms = time_once(torch,
                                lambda: visit.relayout_loop_plain(x, n_iter))
        if not (torch.equal(k, x + n_iter) and torch.equal(k, p)):
            fail(f"relayout n_iter={n_iter}: not x + n_iter")
        if not torch.equal(visit.relayout_loop(xr, n_iter),
                           visit.relayout_loop_plain(xr, n_iter)):
            fail(f"relayout n_iter={n_iter}: not the plain loop on random "
                 f"input")
        ms = time_ms(torch, lambda: visit.relayout_loop(x, n_iter), 200)
        dev_ms = device_ms(lambda: visit.relayout_loop(x, n_iter))
        per[n_iter] = (ms, plain_ms,
                       bound(ms, n_iter * x.numel(), 2 * x.numel() * 4),
                       dev_ms)
        log(f"relayout n_iter={n_iter}: kernel {ms:.4f} ms (device "
            f"{dev_ms} ms; an empty launch of its grid {floor_ms} ms), plain "
            f"{plain_ms:.4f} ms, exact; bound {per[n_iter][2]['bound_ms']:.5f}"
            f" ms ({per[n_iter][2]['bound_by']}) [{card}]")
    ms, plain_ms, bd, dev_ms = per[65]
    # one elementwise pass over the same bytes: the loop's output on this
    # input (zeros), though not on every input (n additions of 1.0 round
    # where one of n may not)
    lib_ms = time_ms(torch, lambda: x + 65.0, 200)
    lib_dev_ms = device_ms(lambda: x + 65.0)
    if not torch.equal(x + 65.0, visit.relayout_loop(x, 65)):
        fail("relayout: x + 65.0 is not the loop's output on zeros")
    log(f"relayout n_iter=65: x + 65.0 (one PyTorch call, equal to the loop "
        f"on zeros) {lib_ms:.4f} ms (device {lib_dev_ms} ms) [{card}]")
    entries["relayout"] = dict(
        name="relayout", **src,
        replaces="scripts/probe_mxu.py:153 (inner k, call :168)",
        launches=counts["relayout"], max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev_ms,
        library_call="x + 65.0 (equals the loop on the probe's zeros, not "
                     "on every input)", **bd, device_ms=dev_ms,
        floor_ms=floor_ms, n_iter=65, ms_n_iter_1=per[1][0],
        plain_ms_n_iter_1=per[1][1],
        device_ms_n_iter_1=per[1][3])
    return list(entries.values())


def dot_host_split(torch, a, b_in, prec):
    """Host microseconds a call of `visit.dot`, whole and by stage (the
    checks, the output's allocation, the launch: pointers, stream handle
    and the ctypes call), beside one `torch.matmul` call's: the host
    clock over 500 calls that are enqueued and not waited for."""
    from raytracingrenderer_tpu_torch.ops import visit
    from raytracingrenderer_tpu_torch.ops.launch import launch
    dev, tt, r = a.device, a.shape[1], b_in.shape[1]
    out = torch.empty((tt, r), dtype=torch.float32, device=dev)
    fn = visit._library()["visit_dot"]

    def per_call_us(f):
        return host_us_a_call(torch, f)

    return dict(
        call=per_call_us(lambda: visit.dot(a, b_in, prec)),
        checks=per_call_us(lambda: visit._check_dot(a, b_in, prec)),
        empty=per_call_us(lambda: torch.empty((tt, r), dtype=torch.float32,
                                              device=dev)),
        launch=per_call_us(lambda: launch(
            fn, dev, int(prec == "default"), a.data_ptr(),
            b_in.data_ptr(), out.data_ptr(), tt, r)),
        matmul=per_call_us(lambda: torch.matmul(a.t(), b_in)))


def reset_counts():
    from raytracingrenderer_tpu_torch.geometry import intersect
    from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel, treelet
    mt_kernel.launches = 0
    treelet.launches = 0
    for k in bvh_kernel.launches:
        bvh_kernel.launches[k] = 0
    intersect.stackless_calls = 0
    intersect.treelet_calls = 0


def render_full(torch, scene, name, card, out_dir, **cfg_over):
    """The main path at full size: warm-up pass, counts to 0, SPP
    passes; returns the image (numpy) and its wall seconds."""
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.io.hdr import write_hdr
    from raytracingrenderer_tpu_torch.render import _use_wavefront, render
    cfg = RenderConfig(**BENCH_CFG, **cfg_over)
    cam = scene.camera
    render(scene, cfg, spp=1)                       # warm-up pass
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img = film_mod.to_hdr(film)
    if tuple(img.shape) != (cam.height, cam.width, 3):
        fail(f"{name}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        fail(f"{name}: non-finite pixels in the full-size render")
    mean = img.mean().item()
    pps = cam.width * cam.height * SPP / dt
    log(f"render {name} {cam.width}x{cam.height}, {SPP} spp, mis+jitter, "
        f"max_depth 4, {'wavefront' if _use_wavefront(scene, cfg) else 'scan'}"
        f": {dt:.3f} s, {pps:.6g} pixel-paths/s [{card}], image mean "
        f"{mean:.5f}")
    if not 0.03 < mean < 0.5:
        fail(f"{name}: implausible image mean {mean}")
    img = img.cpu().numpy()
    hdr_path = os.path.join(
        out_dir, f"{name}_{cam.width}x{cam.height}_{SPP}spp.hdr")
    write_hdr(hdr_path, img)
    log(f"wrote {hdr_path} ({os.path.getsize(hdr_path)} bytes)")
    return img, dt


def profile_pass(torch, scene, name, run=None,
                 what="one 1024x1024 sample pass"):
    """One sample pass of the full-size render (or of `run()`, another
    entry point's pass) under torch.profiler: the wall time, the device's
    busy time (each kernel's self time counted once) and idle share, and
    the time and launches of the port's own kernels in it -> the idle
    share (None where the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.probes import device_rows
    from raytracingrenderer_tpu_torch.render import render
    if run is None:
        cfg = RenderConfig(**BENCH_CFG)
        run = lambda: render(scene, cfg, spp=1)  # noqa: E731
    t_all = time.perf_counter()
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    rows = device_rows(prof, avgs)
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    if not busy_ms:
        log(f"profile {name}: the profiler recorded no device time")
        return None
    own = {}
    for tag, mark in (("B2 closest-hit", "bvh_traverse_kernel<false"),
                      ("B2 any-hit", "bvh_traverse_kernel<true"),
                      ("B1", "mt_intersect")):
        hit = [(us, n) for key, us, n in rows if mark in key.replace(
            "(bool)0", "false").replace("(bool)1", "true")]
        own[tag] = (sum(us for us, _ in hit) / 1e3, sum(n for _, n in hit))
    log(f"profile {name}, {what} under torch.profiler: "
        f"wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms (idle "
        f"{1 - busy_ms / wall_ms:.1%}); "
        + "; ".join(f"{k} {ms:.3f} ms in {n} launches ({ms / busy_ms:.1%} "
                    f"of device time)" for k, (ms, n) in own.items()))
    from torch.autograd import DeviceType
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0) or 0,
                   e.count) for e in avgs
                  if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    log(f"profile {name}, device time by operator: " + "; ".join(
        f"{key} {us / 1e3:.2f} ms x{n} ({us / 1e3 / busy_ms:.1%})"
        for key, us, n in ops[:6]) + f" (profiling took "
        f"{time.perf_counter() - t_all:.1f} s of wall time)")
    return 1 - busy_ms / wall_ms


def same_image(what, a, b):
    """>= 99% of pixels within rtol 1e-3 / atol 1e-5 and means within
    0.5%, or fail."""
    import numpy as np
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    log(f"{what}: {close:.4%} of pixels within rtol 1e-3/atol 1e-5, "
        f"means {a.mean():.6f} vs {b.mean():.6f} (rel {rel:.2e})")
    if close < 0.99 or rel > 0.005:
        fail(f"{what}: the images disagree")


def gpu_vs_cpu(name, scene_dir, treelets=False):
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.geometry import intersect
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.ops import treelet
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    imgs = {}
    for dev in ("cuda", "cpu"):
        scene = load_scene(scene_dir, device=dev)
        if treelets:
            scene = scene._replace(bvh=treelet.attach_treelets(scene.bvh))
        calls = intersect.treelet_calls
        f = render(scene, RenderConfig(**BENCH_CFG), spp=2)
        if treelets and intersect.treelet_calls == calls:
            fail(f"{name} on {dev} did not take the treelet route")
        imgs[dev] = film_mod.to_hdr(f).cpu().numpy()
    same_image(f"{name} 128x128 2 spp, cuda vs cpu", imgs["cuda"],
               imgs["cpu"])


class WatchBackward:
    """Counts of the kernels' launches made inside each torch.autograd.grad
    call (the backward of a training step), with that function wrapped
    for the block: [(B1 launches, {B2 variant: launches})] a call."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
        self.real = real = self.torch.autograd.grad

        def grad(*args, **kwargs):
            mt0, b0 = mt_kernel.launches, dict(bvh_kernel.launches)
            out = real(*args, **kwargs)
            self.calls.append((mt_kernel.launches - mt0,
                               {k: bvh_kernel.launches[k] - b0[k]
                                for k in b0}))
            return out

        self.torch.autograd.grad = grad
        return self

    def __exit__(self, *exc):
        self.torch.autograd.grad = self.real

    def launches(self) -> dict:
        """Launches summed over the calls: {"mt": B1, B2 variant: ...}."""
        out = {"mt": sum(mt for mt, _ in self.calls)}
        for _, b in self.calls:
            for k, n in b.items():
                out[k] = out.get(k, 0) + n
        return out


# the program's spans of the boundary term (utils/profiling): the whole
# term a bounce, its probe rays (`occluded`, B1 or B2) and its cell masks
BOUNDARY_SPANS = ("rtr.boundary", "rtr.boundary.probes",
                  "rtr.boundary.cells")


def finite_params(torch, scene) -> bool:
    from raytracingrenderer_tpu_torch import diff
    params, _ = diff._split_scene(scene)
    return all(bool(torch.isfinite(p).all()) for p in diff._leaves(params))


def profile_step(torch, card, name, scene, cfg, target, key,
                 halves=("forward", "backward")):
    """One training step with the halves in `halves` under torch.profiler
    (probes.profile_train_step): prints each half's wall time, and for a
    profiled half its device busy time and idle share, and the
    backward's device time by operator (the host rows' own kernels);
    with the boundary term on, also the forward's by operator and the
    device time under the boundary term's spans in each half; returns
    (gradients by key, the numbers)."""
    from raytracingrenderer_tpu_torch.probes import profile_train_step
    grads, prof = profile_train_step(scene, cfg, target, key,
                                     BOUNDARY_SPANS, halves)
    fwd_ms, bwd_ms = prof["fwd_ms"], prof["bwd_ms"]
    busy = prof["fwd_busy_ms"], prof["bwd_busy_ms"]

    def half_line(ms, b):
        return f"wall {ms:.1f} ms, " + (
            "not profiled" if b is None else
            f"device busy {b:.2f} ms (idle {1 - b / ms:.1%})")
    log(f"training {name}, one step under torch.profiler [{card}]: forward "
        f"{half_line(fwd_ms, busy[0])}; backward "
        f"{half_line(bwd_ms, busy[1])}; backward / forward wall "
        f"{bwd_ms / fwd_ms:.3f}")
    halves = (("forward", "fwd"), ("backward", "bwd"))
    for (half, tag), b in zip(halves, busy):
        ops = prof[f"{tag}_ops"]
        if b and (half == "backward" or cfg.boundary_grads):
            log(f"training {name}, {half} device time by operator: " +
                "; ".join(f"{k} {ms:.3f} ms x{n} ({ms / b:.1%})"
                          for k, ms, n in ops))
    if cfg.boundary_grads:
        log(f"training {name}, device time under the boundary term's ranges "
            f"(the backward's are its recompute): " + "; ".join(
                f"{half} {k} {ms:.3f} ms x{n} ({ms / b:.1%} of the half)"
                for (half, tag), b in zip(halves, busy)
                for k, (ms, n) in prof[f"{tag}_ranges"].items() if b))
    return grads, prof


def train_cornell(torch, card, cornell, fwd_pps, steps=TRAIN_STEPS,
                  remats=(True, False), name="cornell",
                  profiled=("forward", "backward"), **cfg_over):
    """Phase 13 (a) (and 14 (a) with the boundary term in `cfg_over`):
    the cornell box at 1024x1024, zero target, lr 0.01: a warm-up
    train_steps(n=1), then train_steps(n=steps) timed, with the kernels'
    launches counted and the backward watched; one step with the halves
    in `profiled` under the profiler, whose peak memory is the step's
    with remat on (the profiler allocates no device memory); the peak
    memory of a step with remat off where `remats` has it."""
    import dataclasses
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.ops import mt_kernel
    from raytracingrenderer_tpu_torch.sampling import rng
    cfg = RenderConfig(**BENCH_CFG, **cfg_over)
    cam = cornell.camera
    target = torch.zeros((cam.height, cam.width, 3), device=cornell.device)
    diff.train_steps(cornell, target, rng.PRNGKey(0), cfg, TRAIN_LR, 1)
    torch.cuda.synchronize()
    reset_counts()
    base = rng.PRNGKey(1)
    with WatchBackward(torch) as bwd:
        t0 = time.perf_counter()
        trained, losses = diff.train_steps(cornell, target, base, cfg,
                                           TRAIN_LR, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = mt_kernel.launches
    pps = cam.width * cam.height * steps / dt
    losses = losses.cpu().numpy()
    log(f"training {name} {cam.width}x{cam.height}, train_steps "
        f"n={steps}, lr {TRAIN_LR}, zero target, mis+jitter, max_depth "
        f"{cfg.max_depth}, boundary_grads {cfg.boundary_grads} (scan): "
        f"{dt:.3f} s, fwdbwd_pps {pps:.6g} [{card}]; forward "
        f"render {fwd_pps:.6g} pixel-paths/s, fwd_over_fwdbwd "
        f"{fwd_pps / pps:.3f}; B1 launches {launches} (backward calls "
        f"{len(bwd.calls)}, launches in them {bwd.calls}); losses "
        f"{losses.tolist()}")
    if launches == 0:
        fail(f"the {name} training steps never launched B1")
    if len(bwd.calls) != steps or any(bwd.launches().values()):
        fail(f"a {name} backward launched a kernel (or did not run)")
    if not (all(map(math.isfinite, losses)) and finite_params(torch,
                                                              trained)):
        fail(f"non-finite {name} losses or parameters")
    # descent, with common random numbers: the trained scene against the
    # first step's loss on that step's key (fresh keys' Monte Carlo noise
    # is larger than 8 steps' descent at this rate; 2 steps need not
    # descend on it, so phase 14 takes 1)
    with torch.no_grad():
        p1, _ = diff._split_scene(trained)
        after = diff.render_loss(p1, trained, target, rng.fold_in(base, 0),
                                 diff._diff_cfg(cfg, trained)).item()
    log(f"training {name}: loss on the first step's key {losses[0]:.7f} "
        f"before, {after:.7f} after the {steps} step(s) (rel "
        f"{after / losses[0] - 1:+.3e}); last step's loss below the "
        f"first's: {bool(losses[-1] < losses[0])}")
    if not after < losses[0]:
        fail(f"the {name} training steps did not lower the loss")
    def peak_of(step):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = step()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated(), held)
    mem = {}
    (grads, prof), mem[cfg.remat] = peak_of(lambda: profile_step(
        torch, card, name, trained, cfg, target, rng.fold_in(base, steps),
        profiled))
    if not all(bool(torch.isfinite(g).all())
               for g in diff._leaves(grads)):
        fail(f"non-finite {name} gradients")
    for remat in remats:
        if remat not in mem:
            _, mem[remat] = peak_of(lambda: diff.train_step(
                trained, target, rng.PRNGKey(2),
                dataclasses.replace(cfg, remat=remat), TRAIN_LR))
    log(f"training {name}, one step's peak memory (max_memory_allocated; "
        "held before the step): " + "; ".join(
            f"remat={r} {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB)"
            for r, (peak, held) in mem.items()) + f" [{card}]")
    return dict(fwdbwd_pps=pps, fwd_over_fwdbwd=fwd_pps / pps,
                b1_launches=launches, bwd_launches=bwd.launches(),
                losses=losses.tolist(),
                **{f"peak_bytes_{'remat' if r else 'no_remat'}": m[0]
                   for r, m in mem.items()}, **prof)


def train_spheres(torch, card, spheres, fwd_pps, name="spheres",
                  profiled=("forward", "backward"), **cfg_over):
    """Phase 13 (b) (and 14 (b) with the boundary term in `cfg_over`):
    the spheres scene at 1024x1024 through the wavefront backward: a
    warm-up train_step, then one timed, with the launches counted, the
    backward watched and the step's peak memory read; refit and the
    repacking of the tables timed; one step on the refitted scene, with
    the halves in `profiled` under the profiler, with finite
    gradients."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.geometry import intersect
    from raytracingrenderer_tpu_torch.geometry.refit import refit
    from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
    from raytracingrenderer_tpu_torch.render import _use_wavefront
    from raytracingrenderer_tpu_torch.sampling import rng
    cfg = RenderConfig(**BENCH_CFG, **cfg_over)
    if not _use_wavefront(spheres, cfg):
        fail("the spheres scene does not take the wavefront")
    cam = spheres.camera
    target = torch.zeros((cam.height, cam.width, 3), device=spheres.device)
    diff.train_step(spheres, target, rng.PRNGKey(0), cfg, TRAIN_LR)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with WatchBackward(torch) as bwd:
        t0 = time.perf_counter()
        stepped, loss = diff.train_step(spheres, target, rng.PRNGKey(1), cfg,
                                        TRAIN_LR)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(mt=mt_kernel.launches, **{
        k: bvh_kernel.launches[k] for k in ("closest_hit", "any_hit")})
    pps = cam.width * cam.height / dt
    log(f"training {name} {cam.width}x{cam.height}, one train_step through "
        f"the wavefront backward, lr {TRAIN_LR}, boundary_grads "
        f"{cfg.boundary_grads}: {dt:.3f} s, fwdbwd_pps "
        f"{pps:.6g} [{card}]; forward render {fwd_pps:.6g} pixel-paths/s, "
        f"fwd_over_fwdbwd {fwd_pps / pps:.3f}; loss {loss.item():.7f}; "
        f"launches {launches} "
        f"(backward calls {len(bwd.calls)}, launches in them {bwd.calls}); "
        f"stackless walks {intersect.stackless_calls}; the step's peak "
        f"memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before)")
    if min(launches.values()) == 0:
        fail(f"the {name} training step did not launch B1 and both B2 "
             "variants")
    if len(bwd.calls) != 1 or any(bwd.launches().values()):
        fail(f"the {name} backward launched a kernel (or did not run)")
    moved = sum((a != b) for a, b in zip(stepped.triangles.p0,
                                         spheres.triangles.p0)).gt(0)
    moved = int(moved.sum())
    if not (math.isfinite(loss.item()) and finite_params(torch, stepped)
            and moved):
        fail(f"non-finite {name} loss or parameters, or no vertex moved")
    t0 = time.perf_counter()
    fitted = refit(stepped)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for leaf16 in (False, True):
        bvh_kernel.tables(fitted.bvh, fitted.triangles, leaf16)
    intersect._proxy_tris(fitted)
    torch.cuda.synchronize()
    repack_s = time.perf_counter() - t0
    log(f"training {name}: refit (host numpy, {fitted.bvh.n_nodes} nodes) "
        f"{refit_s * 1e3:.1f} ms; repacking B2's tables (both leaf forms) "
        f"and the pre-pass's triangles {repack_s * 1e3:.1f} ms; {moved} of "
        f"{spheres.triangles.count} anchor vertices moved [{card}]")
    if profiled:
        grads, prof = profile_step(torch, card, name, fitted, cfg, target,
                                   rng.PRNGKey(2), profiled)
    else:
        _, grads = diff.loss_and_grads(fitted, target, rng.PRNGKey(2), cfg)
        prof = {}
    if not all(bool(torch.isfinite(g).all()) for g in diff._leaves(grads)):
        fail(f"non-finite {name} gradients")
    return dict(fwdbwd_pps=pps, fwd_over_fwdbwd=fwd_pps / pps,
                launches=launches, bwd_launches=bwd.launches(),
                peak_bytes=peak, refit_ms=refit_s * 1e3,
                repack_ms=repack_s * 1e3, **prof)


def grads_gpu_vs_cpu(torch, name, scene_dir, wave, **cfg_over):
    """Phase 13 (c) (and 14 (c) with the boundary term in `cfg_over`):
    loss and gradients of one step on "cuda" (kernels) and "cpu" (plain
    versions), same key: loss within rel 1e-4; each material and light
    array within rtol 1e-3 / atol 1e-3 * max|g|; tri_p0 within a relative
    L2 error of 1e-2."""
    import numpy as np
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.integrators import wavefront_diff
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    cfg = RenderConfig(**BENCH_CFG, **cfg_over)
    got, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sc = load_scene(scene_dir, device=dev)
        cam = sc.camera
        target = torch.zeros((cam.height, cam.width, 3), device=dev)
        key = rng.PRNGKey(3)
        if wave:
            loss, g = wavefront_diff.loss_and_grads(sc, target, key, cfg)
        else:
            loss, g = diff.value_and_grad(sc, target, key,
                                          diff._diff_cfg(cfg, sc))
        got[dev] = (loss.item(), grads_np(g))
        secs[dev] = time.perf_counter() - t0
    grads_gate(f"{name}, cuda vs cpu", got["cuda"], got["cpu"],
               f"; cuda {secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s")


def b12_counts():
    """(B1 launches, {B2 variant: launches}) since the last reset."""
    from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel
    return mt_kernel.launches, {k: bvh_kernel.launches[k]
                                for k in ("closest_hit", "any_hit")}


def sky_phase(torch, card, scenes, tmp, out_dir):
    """Phase 15, main path 7: the spheres above the cornell floor, lit
    only by a 1024 x 2048 sky (tests/torch_scenes.py::write_sky): load
    with the native alias table, a 1024x1024 8 spp render through the
    wavefront (B2 both variants and B1's pre-pass launched), one pass
    profiled; then the 5,122-triangle sky scene (a 256 x 512 map) at
    128x128 on "cuda" and "cpu", image and gradients (env_data among the
    parameters) held as phases 7 and 13 (c) hold theirs."""
    from raytracingrenderer_tpu_torch.geometry import bvh_native, intersect
    from raytracingrenderer_tpu_torch.io.hdr import read_hdr
    from raytracingrenderer_tpu_torch.lights import envmap
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    t0 = time.perf_counter()
    sky_dir = scenes.write_sky(os.path.join(tmp, "sky"), subdiv=5)
    t1 = time.perf_counter()
    sky = load_scene(sky_dir, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    env = sky.background.envmap
    if env is None or tuple(env.data.shape) != (1024, 2048, 3):
        fail("the sky scene did not load its 1024 x 2048 envmap")
    if not hasattr(bvh_native._load(), "alias_build"):
        fail("the native library lacks alias_build: the alias table would "
             "take the Python fallback")
    img = read_hdr(os.path.join(sky_dir, "sky.hdr"))
    t3 = time.perf_counter()
    envmap.build_envmap(img, "cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    log(f"sky scene: {sky.triangles.count} triangles, written in "
        f"{t1 - t0:.2f} s, loaded on cuda in {t2 - t1:.2f} s (sky.hdr read "
        f"{t3 - t2:.2f} s, build_envmap with the native alias table "
        f"{t4 - t3:.3f} s); mean_power {env.mean_power.item():.5f}")
    _, sky_s = render_full(torch, sky, "sky", card, out_dir)
    b1, b2 = b12_counts()
    log(f"sky launches: bvh_kernel {b2}, mt_kernel (proxy pre-pass) {b1}, "
        f"stackless walks {intersect.stackless_calls}")
    if min(b2.values()) == 0 or b1 == 0 or intersect.stackless_calls:
        fail("the sky render did not launch both B2 variants and B1's "
             "pre-pass, or took the stackless walk")
    idle = profile_pass(torch, sky, "sky")
    sky128 = scenes.write_sky(os.path.join(tmp, "sky128"), 128, 128,
                              subdiv=2, env_h=256, env_w=512)
    gpu_vs_cpu("sky-5122", sky128)
    grads_gpu_vs_cpu(torch, "sky-5122 128x128 (wavefront), env_data",
                     sky128, wave=True)
    cam = sky.camera
    return dict(pps=cam.width * cam.height * SPP / sky_s, s=sky_s,
                idle=idle, launches=dict(mt=b1, **b2))


DISPATCH = ("direct", "albedo", "normals", "lighttrace", "vpl")
GATE_VPL_DEPTH = 0      # the 128x128 vpl gate: 100 slots a pass, not 300
VPL_SPP = 2             # the 1024x1024 vpl renders: 300 shadow batches a pass


def dispatch_expected(integ, max_depth):
    """(closest-hit calls, any-hit calls) a render_with pass makes.  Each
    call is one B1 launch on a brute-force scene; on a BVH scene a
    closest-hit call is one B2 launch and an any-hit call a B1 pre-pass
    and a B2 launch."""
    from raytracingrenderer_tpu_torch.config import MAX_VPL
    return {"direct": (1, 1), "albedo": (1, 0), "normals": (1, 0),
            "lighttrace": (max_depth + 1, max_depth + 2),
            "vpl": (max_depth + 2, MAX_VPL * (max_depth + 2))}[integ]


def dispatch_phase(torch, card, scenes, tmp, out_dir, cornell, spheres,
                   spheres128):
    """Phase 16, main path 8: integrators.dispatch.render_with for each
    of direct, albedo, normals, lighttrace and vpl at 1024x1024, 8 spp
    (vpl 2 spp; lighttrace: 1024^2 light paths a pass) on the cornell box (B1) and
    the spheres scene (B2, B1's pre-pass), each after a warm-up pass and
    with the counts set to 0 just before: the kernels' launches as the
    passes make them, finite images with sane means, pixel-paths/s
    (light paths/s); one profiled pass of lighttrace and vpl on the
    spheres scene; then every integrator at 128x128, 2 spp, on "cuda" and "cpu"
    (vpl at max_depth 0), held as phase 7."""
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.integrators.dispatch import render_with
    from raytracingrenderer_tpu_torch.io.hdr import write_hdr
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    out = {}
    for sname, scene in (("cornell", cornell), ("spheres", spheres)):
        cam = scene.camera
        brute = scene.triangles.count <= 64
        for integ in DISPATCH:
            cfg = RenderConfig(**BENCH_CFG, integrator=integ)
            spp = VPL_SPP if integ == "vpl" else SPP
            render_with(scene, cfg, 1)                 # warm-up pass
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            film = render_with(scene, cfg, spp)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            b1, b2 = b12_counts()
            img = film_mod.to_hdr(film)
            if not bool(torch.isfinite(img).all()):
                fail(f"{integ} {sname}: non-finite pixels")
            mean = img.mean().item()
            closest, any_ = dispatch_expected(integ, cfg.max_depth)
            want = ({"mt": spp * (closest + any_)} if brute else
                    {"mt": spp * any_, "closest_hit": spp * closest,
                     "any_hit": spp * any_})
            got = {"mt": b1, **({} if brute else b2)}
            pps = cam.width * cam.height * spp / dt
            unit = "light paths/s" if integ == "lighttrace" else \
                "pixel-paths/s"
            log(f"render_with {integ} {sname} {cam.width}x{cam.height}, "
                f"{spp} spp: {dt:.3f} s, {pps:.6g} {unit} [{card}], image "
                f"mean {mean:.5f}, launches {got} (expected {want})")
            if got != want:
                fail(f"{integ} {sname}: launches {got}, expected {want}")
            if not 0.01 < mean < 1.0:
                fail(f"{integ} {sname}: implausible image mean {mean}")
            write_hdr(os.path.join(out_dir, f"{integ}_{sname}_{cam.width}x"
                                   f"{cam.height}_{spp}spp.hdr"),
                      img.cpu().numpy())
            idle = None
            # on the spheres only, to keep the script within its time
            # limit (walking a vpl pass's events takes 28-48 s)
            if integ in ("lighttrace", "vpl") and not brute:
                idle = profile_pass(torch, scene, f"{integ} {sname}",
                                    run=lambda: render_with(scene, cfg, 1))
            out[f"{integ}_{sname}"] = dict(pps=pps, s=dt, idle=idle, **got)
    cornell128 = scenes.write_cornell(os.path.join(tmp, "cornell128d"), 128,
                                      128)
    for sname, sdir in (("cornell", cornell128), ("spheres-5156",
                                                  spheres128)):
        scs = {dev: load_scene(sdir, device=dev) for dev in ("cuda", "cpu")}
        for integ in DISPATCH:
            cfg = RenderConfig(**dict(
                BENCH_CFG, max_depth=(GATE_VPL_DEPTH if integ == "vpl"
                                      else BENCH_CFG["max_depth"])),
                integrator=integ)
            imgs, secs = {}, {}
            for dev, sc in scs.items():
                t0 = time.perf_counter()
                imgs[dev] = film_mod.to_hdr(render_with(sc, cfg, 2)).cpu() \
                    .numpy()
                secs[dev] = time.perf_counter() - t0
            same_image(f"render_with {integ} {sname} 128x128 2 spp, cuda vs "
                       f"cpu (cuda {secs['cuda']:.1f} s, cpu "
                       f"{secs['cpu']:.1f} s)", imgs["cuda"], imgs["cpu"])
    return out


ADAPTIVE_SPP_WARM = 3     # the warm-up call: 2 init passes, 8 small rounds
ADAPTIVE_ROUNDS = 8       # adaptive_render's default rounds
CUMSUM_ULPS = 4 * 2.0 ** -24


class LogTap:
    """The messages of the `rtr` loggers (the CLI's) while the block runs."""

    def __enter__(self):
        import logging
        from raytracingrenderer_tpu_torch.utils.log import get_logger
        get_logger("cli")        # the rtr handler and level first
        self.lines = []
        tap = self

        class Handler(logging.Handler):
            def emit(self, record):
                tap.lines.append(record.getMessage())

        self.handler = Handler()
        logging.getLogger("rtr").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging
        logging.getLogger("rtr").removeHandler(self.handler)

    @property
    def text(self):
        return "\n".join(self.lines)


class DrawTap:
    """Every round's (state, key, px, py) of `adaptive._sample_pixels`,
    with that function wrapped for the block."""

    def __enter__(self):
        from raytracingrenderer_tpu_torch.integrators import adaptive
        self.mod, self.orig, self.calls = adaptive, adaptive._sample_pixels, []

        def spy(st, key, n_rays, h, w):
            px, py = self.orig(st, key, n_rays, h, w)
            self.calls.append((st, key, px, py))
            return px, py

        adaptive._sample_pixels = spy
        return self

    def __exit__(self, *exc):
        self.mod._sample_pixels = self.orig


def moved_draws(torch, calls, h, w):
    """The cumsum rule, the card's draws against the CPU's on the same
    state and key: (draws in another tile, draws) over `calls`; fails if a
    moved draw is not within CUMSUM_ULPS of the boundary between its two
    tiles, or a draw that stayed picks another pixel."""
    from raytracingrenderer_tpu_torch.config import TILE_SIZE as ts
    from raytracingrenderer_tpu_torch.integrators import adaptive
    from raytracingrenderer_tpu_torch.sampling import rng
    tw = -(-w // ts)
    moved = total = 0
    for st, key, px, py in calls:
        cst = adaptive.AdaptiveState(*(a.cpu() for a in st))
        n = px.shape[0]
        cx, cy = adaptive._sample_pixels(cst, key, n, h, w)
        gx, gy = px.cpu(), py.cpu()
        gt = (gy // ts) * tw + gx // ts
        ct = (cy // ts) * tw + cx // ts
        same = gt == ct
        if not (torch.equal(gx[same], cx[same])
                and torch.equal(gy[same], cy[same])):
            fail("adaptive: a draw in the same tile picked another pixel "
                 "on the card")
        i = torch.nonzero(~same).flatten()
        if i.numel():
            var = adaptive._tile_variance(cst) + 1e-8
            cdf = torch.cumsum((var / var.sum()).reshape(-1), 0)
            u = (torch.arange(n, dtype=torch.float32)
                 + rng.raw_uniform(key, (n,))) / n
            k = torch.minimum(gt[i], ct[i])
            if not (bool(((gt[i] - ct[i]).abs() == 1).all()) and bool(
                    ((u[i] - cdf[k]).abs() <= CUMSUM_ULPS).all())):
                fail("adaptive: a draw moved tiles away from a boundary")
        moved += int(i.numel())
        total += n
    return moved, total


def adaptive_phase(torch, card, scenes, tmp, out_dir, cornell, cornell_dir,
                   spheres, spheres128):
    """Phase 17, main path 9: the adaptive integrator and the command line.
    (1) render_with(integrator="adaptive") at 1024x1024, 8 spp (2 init
    passes and 8 rounds of 786,432 rays, 10 traces) on the cornell box
    and the spheres scene, after a 3-spp warm-up call, with the counts
    set to 0 just before: every launch asserted (a trace is a scan
    pass: 12 B1 launches on the cornell box; 6 B2 closest-hit, 6 B2
    any-hit and 6 B1 pre-pass launches on the spheres), a finite image
    with a sane mean, pixel-paths/s, one round profiled; (2) cli.main in
    this process, counts reset before each: adaptive, 8 spp, -denoise
    -profile -checkpoint at 1024x1024 on the cornell box, the same again
    (it resumes to 16 spp), and -keys w,left,p,l,esc at 256x256, each
    with its exit code, files, a finite image with a sane mean, the phase
    report, and its B1 launches; (3) adaptive at 128x128, 4 spp, on the
    cornell box and the 5,156-triangle scene on "cuda" and "cpu", held as
    phase 7, with the draws that landed in another tile counted (the
    cumsum rule), and the denoiser on a noisy 1024x1024 image with its
    guides, cuda against cpu (max |diff| <= 1e-4 * max|image|)."""
    from raytracingrenderer_tpu_torch import cli
    from raytracingrenderer_tpu_torch.config import INIT_SAMPLES, RenderConfig
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.imaging.denoise import denoise
    from raytracingrenderer_tpu_torch.integrators import adaptive, aov
    from raytracingrenderer_tpu_torch.integrators.dispatch import render_with
    from raytracingrenderer_tpu_torch.io.hdr import read_hdr, write_hdr
    from raytracingrenderer_tpu_torch.render import specialize_config
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    import numpy as np
    cfg = RenderConfig(**BENCH_CFG, integrator="adaptive")
    per_trace = 2 * (cfg.max_depth + 2)         # closest + any a bounce
    traces = INIT_SAMPLES + ADAPTIVE_ROUNDS
    out = {}
    films = {}
    # (1) the renders
    for sname, scene in (("cornell", cornell), ("spheres", spheres)):
        cam = scene.camera
        brute = scene.triangles.count <= 64
        render_with(scene, cfg, ADAPTIVE_SPP_WARM)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        film = render_with(scene, cfg, SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        b1, b2 = b12_counts()
        got = {"mt": b1, **({} if brute else b2)}
        half = traces * per_trace // 2
        want = ({"mt": traces * per_trace} if brute else
                {"mt": half, "closest_hit": half, "any_hit": half})
        img = film_mod.to_hdr(film)
        if not bool(torch.isfinite(img).all()):
            fail(f"adaptive {sname}: non-finite pixels")
        mean = img.mean().item()
        pps = cam.width * cam.height * SPP / dt
        log(f"adaptive {sname} {cam.width}x{cam.height}, {SPP} spp "
            f"(2 init passes, 8 rounds of "
            f"{(SPP - 2) * cam.width * cam.height // 8} rays): {dt:.3f} s, "
            f"{pps:.6g} pixel-paths/s [{card}], film spp "
            f"{float(film.spp):.4f}, image mean {mean:.5f}, launches {got} "
            f"(expected {want})")
        if got != want:
            fail(f"adaptive {sname}: launches {got}, expected {want}")
        if not 0.03 < mean < 0.5:
            fail(f"adaptive {sname}: implausible image mean {mean}")
        write_hdr(os.path.join(out_dir, f"adaptive_{sname}_{cam.width}x"
                               f"{cam.height}_{SPP}spp.hdr"),
                  img.cpu().numpy())
        h, w = cam.height, cam.width
        z = torch.zeros((h, w), device=scene.device)
        st = adaptive.AdaptiveState(film.buffer, torch.full_like(z, SPP), z,
                                    z, z)
        n_round = (SPP - 2) * h * w // 8
        idle = profile_pass(
            torch, scene, f"adaptive {sname}",
            run=lambda: adaptive._scatter_round(
                scene, st, rng.PRNGKey(99), specialize_config(cfg, scene),
                n_round, h, w), what=f"one round of {n_round} rays")
        out[sname] = dict(pps=pps, s=dt, idle=idle, **got)
        films[sname] = img
    # (2) the command line
    ck = os.path.join(out_dir, "cli_adaptive.npz")
    if os.path.exists(ck):
        os.remove(ck)
    runs = (("adaptive", ["-integrator", "adaptive", "-SPP", str(SPP),
                          "-denoise", "-profile", "-checkpoint", ck],
             traces * per_trace + 2, SPP),
            ("adaptive resumed", ["-integrator", "adaptive", "-SPP",
                                  str(SPP), "-denoise", "-profile",
                                  "-checkpoint", ck],
             traces * per_trace + 2, 2 * SPP),
            ("keys", ["-keys", "w,left,p,l,esc", "-width", "256",
                      "-height", "256", "-profile"], 3 * per_trace, None))
    for name, extra, want_b1, want_spp in runs:
        hdr = os.path.join(out_dir, f"cli_{name.split()[0]}.hdr")
        reset_counts()
        t0 = time.perf_counter()
        with LogTap() as tap:
            rc = cli.main(["-scene", cornell_dir, "-outputFilename", hdr,
                           "-maxDepth", str(cfg.max_depth)] + extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        b1 = b12_counts()[0]
        files = [hdr] + ([ck] if "-checkpoint" in extra else []) + (
            [hdr[:-4] + ".png"] if name == "keys" else [])
        missing = [f for f in files if not os.path.exists(f)]
        img = read_hdr(hdr) if not missing else None
        mean = float(img.mean()) if img is not None else float("nan")
        spp = None
        if "-checkpoint" in extra and not missing:
            with np.load(ck) as zf:
                spp = float(zf["spp"])
        report = tap.text.split("phase report:")[-1].split(
            "device memory")[0] if "phase report:" in tap.text else ""
        log(f"cli {name}: rc {rc}, {dt:.3f} s, files {files} "
            f"(missing {missing}), image {None if img is None else img.shape}"
            f" mean {mean:.5f}, checkpoint spp {spp}, B1 launches {b1} "
            f"(expected {want_b1}); phase report: "
            f"{report.strip().replace(chr(10), '; ')}")
        if rc != 0 or missing:
            fail(f"cli {name}: rc {rc}, missing {missing}")
        if not (np.isfinite(img).all() and 0.03 < mean < 0.5):
            fail(f"cli {name}: non-finite or implausible image (mean {mean})")
        if b1 != want_b1:
            fail(f"cli {name}: {b1} B1 launches, expected {want_b1}")
        if "render:" not in report or ("-denoise" in extra
                                       and "denoise:" not in report):
            fail(f"cli {name}: no phase report")
        if want_spp is not None and abs(spp - want_spp) > 1e-3:
            fail(f"cli {name}: checkpoint at {spp} spp, not {want_spp}")
        out[f"cli_{name.replace(' ', '_')}"] = dict(s=dt, mt=b1)
    # (3) cuda against cpu
    cornell128 = scenes.write_cornell(os.path.join(tmp, "cornell128a"), 128,
                                      128)
    for sname, sdir in (("cornell", cornell128),
                        ("spheres-5156", spheres128)):
        imgs, secs, taps = {}, {}, {}
        for dev in ("cuda", "cpu"):
            sc = load_scene(sdir, device=dev)
            t0 = time.perf_counter()
            with DrawTap() as taps[dev]:
                imgs[dev] = film_mod.to_hdr(render_with(sc, cfg, 4)).cpu() \
                    .numpy()
            secs[dev] = time.perf_counter() - t0
        moved, total = moved_draws(torch, taps["cuda"].calls, 128, 128)
        log(f"adaptive {sname} 128x128 4 spp: {moved} of {total} draws on "
            f"the card landed in another tile than the CPU's draws from the "
            f"same state (each within {CUMSUM_ULPS:.3g} of its boundary)")
        same_image(f"adaptive {sname} 128x128 4 spp, cuda vs cpu (cuda "
                   f"{secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s)",
                   imgs["cuda"], imgs["cpu"])
    img = films["cornell"]
    g_cfg = RenderConfig(jitter=False)
    alb = aov.albedo_image(cornell, rng.PRNGKey(0), g_cfg)
    nrm = aov.normals_image(cornell, rng.PRNGKey(0), g_cfg)
    denoise(img, albedo=alb, normal=nrm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dn = denoise(img, albedo=alb, normal=nrm)
    torch.cuda.synchronize()
    dn_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = denoise(img.cpu(), albedo=alb.cpu(), normal=nrm.cpu()).numpy()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(dn.cpu().numpy() - ref).max())
    tol = 1e-4 * max(float(np.abs(ref).max()), 1.0)
    log(f"denoise 1024x1024 with albedo and normal guides: cuda {dn_ms:.2f} "
        f"ms, cpu {cpu_ms:.1f} ms, max |cuda - cpu| {err:.3g} (tolerance "
        f"{tol:.3g}) [{card}]")
    if not err <= tol:
        fail("denoise: cuda and cpu disagree")
    out["denoise"] = dict(ms=dn_ms, cpu_ms=cpu_ms, max_abs_err=err)
    return out


def grads_gate(name, got, ref, note="") -> None:
    """Phase 13's gradient gate on (loss, {key: array}) pairs: loss
    within rel 1e-4; each material and light array within rtol 1e-3 /
    atol 1e-3 * max|g|; tri_p0 within a relative L2 error of 1e-2."""
    import numpy as np
    from raytracingrenderer_tpu_torch import diff
    (lg, gg), (lc, gc) = got, ref
    rel = abs(lg - lc) / max(abs(lc), 1e-30)
    ok = rel <= 1e-4
    parts = [f"loss {lg:.7f} vs {lc:.7f} (rel {rel:.2e}{note})"]
    for k in diff.param_keys(gc):
        a, b = gg[k], gc[k]
        if b.size == 0:       # light_le of a scene without area lights
            continue
        if not np.isfinite(a).all():
            ok = False
        if k == "tri_p0":
            err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            ok &= bool(err <= 1e-2)
            parts.append(f"{k} relative L2 {err:.2e}")
        else:
            m = float(np.abs(b).max())
            ok &= bool(np.allclose(a, b, rtol=1e-3, atol=1e-3 * m))
            parts.append(f"{k} max|dg| {float(np.abs(a - b).max()):.3e} "
                         f"(max|g| {m:.3e})")
    log(f"gradients {name}: " + "; ".join(parts))
    if not ok:
        fail(f"gradients {name}: they disagree")


def grads_np(g):
    return {k: (v.stacked() if hasattr(v, "stacked") else v).cpu().numpy()
            for k, v in g.items()}


RANKS = 2                 # phase 18's gloo ranks, both on cuda:0
RANK_TIMEOUT_S = 420      # their spawn's deadline
ELASTIC_SPP = 4


def collective_ms(torch, mesh, shape, reps=5):
    """Median ms of an all_reduce of a float32 tensor of `shape` on the
    card (gloo stages it through the host), after one warm-up."""
    x = torch.ones(shape, device="cuda")
    mesh.all_reduce(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        mesh.all_reduce(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def rank_main(rank: int, world: int, work: str) -> None:
    """Phase 18 (b) in one of RANKS processes: a gloo rank on cuda:0.
    Writes rank{rank}.json (times, counts, small results) and
    rank{rank}.pt (images, hits, films) into `work`; the parent holds
    them against its one-process results."""
    import torch
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.core.vec import V3
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.integrators.adaptive import (
        adaptive_render)
    from raytracingrenderer_tpu_torch.integrators.lighttracer import (
        light_trace_pass)
    from raytracingrenderer_tpu_torch.parallel import overlap
    from raytracingrenderer_tpu_torch.parallel.distributed import (
        init_distributed)
    from raytracingrenderer_tpu_torch.parallel.mesh import (
        make_mesh, render_sharded)
    from raytracingrenderer_tpu_torch.parallel.scene_shard import (
        traverse_sharded)
    from raytracingrenderer_tpu_torch.render import sample_image
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    init_distributed(f"file://{os.path.join(work, 'store')}", world, rank,
                     backend="gloo", device="cuda:0")
    mesh = make_mesh()
    cfg = RenderConfig(**BENCH_CFG)
    base = rng.PRNGKey(cfg.seed)
    info, arrays = {"rank": rank}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 1. render_sharded, 2 spp, on the spheres scene; the first pass
    # also loads the kernels and packs the tables, the second is timed
    spheres = load_scene(spec["spheres_dir"], device="cuda")
    cam = spheres.camera
    reset_counts()
    passes = [timed(lambda: render_sharded(spheres, rng.spp_key(base, s),
                                           cfg, mesh)) for s in range(2)]
    lo, hi = mesh.band(cam.height)
    info["render"] = dict(s=[t for _, t in passes], band_rows=(lo, hi),
                          pps=(hi - lo) * cam.width / passes[1][1],
                          launches=b12_counts())
    arrays["render"] = ((passes[0][0] + passes[1][0]) * 0.5).cpu()
    del passes
    # 2. the scene sharded over the ranks: traversal, then a render
    t0 = time.perf_counter()
    sharded = load_scene(spec["spheres_dir"], device="cuda",
                         scene_shards=world)
    info["sharded_load_s"] = time.perf_counter() - t0
    sb = sharded.bvh
    rays = torch.load(os.path.join(work, "rays.pt"))
    o, d = (V3(*(c.cuda() for c in rays[k])) for k in ("o", "d"))
    t_cl, t_any = rays["t_closest"].cuda(), rays["t_any"].cuda()
    traverse_sharded(sb, o, d, t_cl)                 # packs the tables
    reset_counts()
    hc, s_cl = timed(lambda: traverse_sharded(sb, o, d, t_cl))
    ha, s_any = timed(lambda: traverse_sharded(sb, o, d, t_any,
                                               any_hit=True))
    info["traverse"] = dict(closest_s=s_cl, any_s=s_any,
                            launches=b12_counts())
    sh = sb.shards[rank]
    arrays["geometry"] = torch.stack(
        [c for f in (sh.triangles.p0, sh.triangles.e1, sh.triangles.e2)
         for c in f], -1).cpu()
    arrays["closest"] = [a.cpu() for a in hc]
    arrays["any"] = [a.cpu() for a in ha]
    reset_counts()
    img, secs = timed(lambda: sample_image(sharded, rng.spp_key(base, 0),
                                           cfg))
    info["sharded_render"] = dict(s=secs, pps=cam.height * cam.width / secs,
                                  launches=b12_counts())
    arrays["sharded_render"] = img.cpu()
    del sharded, sb, sh, img, hc, ha
    # 3. the overlapped step on the cornell box, and the collectives
    c256 = load_scene(spec["cornell256_dir"], device="cuda")
    target = torch.zeros((256, 256, 3), device="cuda")
    nojit = RenderConfig(**dict(BENCH_CFG, jitter=False))
    # in turns, overlap then barriered twice: the second round is timed
    for ov in (True, False, True, False):
        before = overlap.reductions
        reset_counts()
        (g, loss), secs = timed(lambda: overlap.param_grads_sharded(
            c256, target, rng.PRNGKey(3), nojit, mesh, overlap=ov))
        name = "overlap" if ov else "barriered"
        info[name] = dict(s=secs, cold_s=info.get(name, {}).get("s"),
                          loss=float(loss),
                          reductions=overlap.reductions - before,
                          launches=b12_counts())
        arrays[name] = grads_np(g)
    losses, sc = [], c256
    for _ in range(2):
        sc, loss = overlap.train_step_overlap(sc, target, rng.PRNGKey(8),
                                              cfg, mesh, lr=0.5)
        losses.append(float(loss))
    info["train_losses"] = losses
    # the spheres scene's gradients: a reduction of a flat gradient led
    # by tri_p0 (327,716 x 3) a bounce, or one at the end; B2 and B1's
    # pre-pass in every forward
    s_target = torch.zeros((cam.height, cam.width, 3), device="cuda")
    for ov in (True, False):
        before = overlap.reductions
        reset_counts()
        (g, loss), secs = timed(lambda: overlap.param_grads_sharded(
            spheres, s_target, rng.PRNGKey(3), nojit, mesh, overlap=ov))
        name = "spheres_overlap" if ov else "spheres_barriered"
        arrays[name] = grads_np(g)
        info[name] = dict(s=secs, loss=float(loss),
                          reductions=overlap.reductions - before,
                          floats=sum(a.size for a in arrays[name].values()),
                          launches=b12_counts())
    del g, s_target
    info["collective_ms"] = {
        "film_1024x1024x3": collective_ms(torch, mesh, (1024, 1024, 3)),
        "tri_p0_327716x3": collective_ms(torch, mesh, (327_716, 3))}
    # 4. adaptive over the ranks, 8 spp on the cornell box at 1024x1024
    cornell = load_scene(spec["cornell_dir"], device="cuda")
    reset_counts()
    film, secs = timed(lambda: adaptive_render(
        cornell, RenderConfig(integrator="adaptive", **BENCH_CFG), 8,
        mesh=mesh))
    info["adaptive"] = dict(s=secs, launches=b12_counts(),
                            spp=float(film.spp))
    arrays["adaptive"] = film.buffer.cpu()
    # 5. the light tracer over the ranks, 1024^2 light paths
    reset_counts()
    film, secs = timed(lambda: light_trace_pass(
        cornell, film_mod.new_film(1024, 1024, "cuda"), rng.PRNGKey(7), cfg,
        1024 * 1024, mesh=mesh))
    info["lighttrace"] = dict(s=secs, launches=b12_counts())
    arrays["lighttrace"] = film.buffer.cpu()
    dist.destroy_process_group()
    torch.save(arrays, os.path.join(work, f"rank{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def spawn_ranks(work: str, world: int):
    """Start `world` rank processes of this script, wait for them up to
    RANK_TIMEOUT_S, kill any left, and fail unless every one exited 0."""
    logs = [open(os.path.join(work, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--work", work], cwd=ROOT,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                log(f.read()[-4000:])
            fail(f"phase 18 rank {r} exited {p.returncode} (-9: killed at "
                 f"the {RANK_TIMEOUT_S} s deadline)")


def geometry_index(geom, rep):
    """For each row of `geom` ((n, 9) p0 e1 e2), the replicated scene's
    triangle with those exact floats, or -1 (a padding slot)."""
    import numpy as np
    tr = rep.triangles
    mine = np.stack([c.cpu().numpy() for f in (tr.p0, tr.e1, tr.e2)
                     for c in f], -1)
    where = {row.tobytes(): i for i, row in enumerate(mine)}
    return np.asarray([where.get(row.tobytes(), -1)
                       for row in np.ascontiguousarray(geom)], np.int64)


def parallel_launches(par, variant):
    """Main path 10's launches of B1 (variant None) or of a B2 variant:
    (a)'s, and each rank's by step."""
    def pick(counts):
        mt, b2 = counts
        return mt if variant is None else b2[variant]
    return {"nccl_render_sharded": pick(par["nccl"]["launches"]),
            "ranks": [{step: pick(inf[step]["launches"]) for step in (
                "render", "traverse", "sharded_render", "overlap",
                "barriered", "spheres_overlap", "spheres_barriered",
                "adaptive", "lighttrace")}
                for inf in par["ranks"]]}


def parallel_phase(torch, card, scenes, tmp, cornell, spheres,
                   spheres_dir):
    """Phase 18, main path 10: parallel/.  (a) NCCL at world size 1 in
    this process; (b) RANKS gloo ranks on cuda:0 (rank_main), held here
    against one-process results; (c) render_elastic's CLI workers on the
    card with one killed and resumed."""
    import datetime
    import numpy as np
    import torch.distributed as dist
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.geometry import intersect
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.integrators.lighttracer import (
        light_trace_pass)
    from raytracingrenderer_tpu_torch.parallel.elastic import (
        _ckpt_spp, render_elastic)
    from raytracingrenderer_tpu_torch.parallel.mesh import (
        make_mesh, render_sharded)
    from raytracingrenderer_tpu_torch.render import sample_image
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    from raytracingrenderer_tpu_torch.utils.checkpoint import load_film
    cfg = RenderConfig(**BENCH_CFG)
    base = rng.PRNGKey(cfg.seed)
    out = {"card": card}
    t_phase = time.perf_counter()

    # (a) NCCL, world size 1: render_sharded is sample_image bit for bit
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60),
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh()
        reset_counts()
        t0 = time.perf_counter()
        img_a = render_sharded(spheres, rng.spp_key(base, 0), cfg, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = b12_counts()
        ref0 = sample_image(spheres, rng.spp_key(base, 0), cfg)
        if not torch.equal(img_a, ref0):
            fail("render_sharded over NCCL at world size 1 differs from "
                 "sample_image")
        if counts[0] == 0 or min(counts[1].values()) == 0:
            fail(f"render_sharded (NCCL) launched B1/B2 {counts}")
    finally:
        dist.destroy_process_group()
    log(f"(a) NCCL world size 1: render_sharded 1 spp on the spheres scene "
        f"1024x1024 equals sample_image bit for bit; {secs:.3f} s, "
        f"launches B1 {counts[0]}, B2 {counts[1]} [{card}]")
    out["nccl"] = dict(s=secs, launches=counts)

    # (b) RANKS gloo ranks on cuda:0
    work = os.path.join(tmp, "ranks")
    os.makedirs(work)
    c256_dir = scenes.write_cornell(os.path.join(tmp, "cornell256"), 256,
                                    256)
    cornell_dir = scenes.write_cornell(os.path.join(tmp, "cornell_p18"))
    o, d, t_cl, t_any = make_rays(torch, N_BVH_CHECK, 18)
    torch.save({"o": tuple(c.cpu() for c in o),
                "d": tuple(c.cpu() for c in d),
                "t_closest": t_cl.cpu(), "t_any": t_any.cpu()},
               os.path.join(work, "rays.pt"))
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"spheres_dir": spheres_dir, "cornell256_dir": c256_dir,
                   "cornell_dir": cornell_dir}, f)
    t0 = time.perf_counter()
    spawn_ranks(work, RANKS)
    spawn_s = time.perf_counter() - t0
    info = []
    arrays = []
    for r in range(RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            info.append(json.load(f))
        arrays.append(torch.load(os.path.join(work, f"rank{r}.pt"),
                                 weights_only=False))
    log(f"(b) {RANKS} gloo ranks on cuda:0 ran in {spawn_s:.1f} s (each "
        f"process's start, loads and checks)")
    cam_res = f"{spheres.camera.width}x{spheres.camera.height}"
    for r, inf in enumerate(info):
        log(f"rank {r}: render_sharded 2 spp, rows "
            f"{inf['render']['band_rows']}, passes {inf['render']['s'][0]:.3f} s (the first loads the "
            f"kernels and packs the tables) and {inf['render']['s'][1]:.3f} "
            f"s, {inf['render']['pps']:.6g} pixel-paths/s in the second, "
            f"launches {inf['render']['launches']}; sharded "
            f"load {inf['sharded_load_s']:.2f} s; traverse_sharded closest "
            f"{inf['traverse']['closest_s'] * 1e3:.1f} ms, any-hit "
            f"{inf['traverse']['any_s'] * 1e3:.1f} ms; sharded render 1 spp "
            f"{inf['sharded_render']['s']:.3f} s "
            f"({inf['sharded_render']['pps']:.6g} pixel-paths/s); 256x256 "
            f"gradients, overlap {inf['overlap']['s']:.3f} s, barriered "
            f"{inf['barriered']['s']:.3f} s (the first round "
            f"{inf['overlap']['cold_s']:.3f}, {inf['barriered']['cold_s']:.3f}"
            f" s); spheres {cam_res} gradients ("
            f"{inf['spheres_overlap']['floats']} floats a reduction), "
            f"overlap {inf['spheres_overlap']['s']:.3f} s, barriered "
            f"{inf['spheres_barriered']['s']:.3f} s, launches "
            f"{inf['spheres_overlap']['launches']}; adaptive 8 spp "
            f"{inf['adaptive']['s']:.3f} s; lighttrace "
            f"{inf['lighttrace']['s']:.3f} s; all_reduce ms (gloo, staged "
            f"through the host) {inf['collective_ms']} [{card}]")
        for step in ("render", "traverse", "sharded_render", "overlap",
                     "spheres_overlap", "spheres_barriered", "adaptive",
                     "lighttrace"):
            mt, b2 = inf[step]["launches"]
            if mt == 0 or (step in ("render", "traverse", "sharded_render",
                                    "spheres_overlap", "spheres_barriered")
                           and min(b2.values()) == 0):
                fail(f"rank {r} {step}: launches B1 {mt}, B2 {b2}")
        if inf["adaptive"]["launches"][0] != 120:
            fail(f"rank {r}: adaptive launched B1 "
                 f"{inf['adaptive']['launches'][0]} times, not 120")
    # 1. the ranks' 2-spp image against this process's
    ref1 = sample_image(spheres, rng.spp_key(base, 1), cfg)
    ref = ((ref0 + ref1) * 0.5).cpu().numpy()
    for r in range(RANKS):
        got = arrays[r]["render"].numpy()
        diff_px = int((got != ref).any(-1).sum())
        log(f"rank {r} render_sharded 2 spp vs one process: {diff_px} "
            f"pixels differ")
        same_image(f"rank {r} render_sharded 1024x1024 2 spp", got, ref)
    # 2. traverse_sharded against the replicated walk
    to_rep = geometry_index(np.concatenate(
        [a["geometry"].numpy() for a in arrays]), spheres)
    live = t_cl.cpu().numpy() > 0
    trav = {}
    for any_hit, t0_ in ((False, t_cl), (True, t_any)):
        with torch.no_grad():
            h = intersect._walk(spheres, o, d, t0_, any_hit, False)
        t_r, tri_r = h.t.cpu().numpy(), h.tri.cpu().numpy()
        t_s, tri_s = (a.numpy() for a in arrays[0]["any" if any_hit
                                                   else "closest"][:2])
        for a, b in zip(arrays[1]["any" if any_hit else "closest"],
                        arrays[0]["any" if any_hit else "closest"]):
            if not torch.equal(a, b):
                fail("the ranks' traverse_sharded results differ")
        mapped = np.where(tri_s >= 0, to_rep[np.maximum(tri_s, 0)], -1)
        name = "any-hit" if any_hit else "closest-hit"
        if any_hit:
            agree_bits = ((tri_s >= 0) == (tri_r >= 0))[live]
            share = agree_bits.mean()
            trav[name] = dict(bits_agree=float(share),
                              differ=int((~agree_bits).sum()))
            log(f"traverse_sharded {name}, 2^20+77 rays: occlusion bits "
                f"agree on {share:.6%} of {live.sum()} live rays "
                f"({int((~agree_bits).sum())} differ)")
        else:
            same = (mapped == tri_r)[live]
            t_eq = (t_s == t_r)[live]
            if not t_eq[same].all():
                fail("traverse_sharded: t differs where the triangle agrees")
            other = ~same
            ties = int((other & t_eq).sum())
            share = same.mean()
            trav[name] = dict(ids_agree=float(share), ties=ties,
                              other=int(other.sum()) - ties)
            log(f"traverse_sharded {name}, 2^20+77 rays (10% dead): ids "
                f"agree on {share:.6%} of {live.sum()} live rays, t bit for "
                f"bit there; {int(other.sum())} differ: {ties} exact ties, "
                f"{int(other.sum()) - ties} with another t (grazing box "
                f"tests)")
        if share < 0.99999:
            fail(f"traverse_sharded {name}: agreement {share:.6%} < "
                 f"99.999%")
    out["traverse"] = trav
    same_image("scene-sharded render 1024x1024 1 spp vs replicated scan",
               arrays[0]["sharded_render"].numpy(), ref0.cpu().numpy())
    # 3. the overlapped gradients against diff.param_grads
    c256 = load_scene(c256_dir, device="cuda")
    nojit = RenderConfig(**dict(BENCH_CFG, jitter=False))
    target = torch.zeros((256, 256, 3), device="cuda")
    loss, g = diff.value_and_grad(c256, target, rng.PRNGKey(3),
                                  diff._diff_cfg(nojit, c256))
    ref_g = (loss.item(), grads_np(g))
    for name, red in (("overlap", BENCH_CFG["max_depth"] + 2),
                      ("barriered", 1)):
        for r in range(RANKS):
            if info[r][name]["reductions"] != red:
                fail(f"rank {r} {name}: {info[r][name]['reductions']} "
                     f"reductions, not {red}")
        for k, v in arrays[1][name].items():
            if not np.array_equal(v, arrays[0][name][k]):
                fail(f"{name}: the ranks' gradients differ ({k})")
        grads_gate(f"cornell 256x256 {name} over {RANKS} ranks vs "
                   f"diff.param_grads", (info[0][name]["loss"],
                                         arrays[0][name]), ref_g,
                   f"; {red} reduction(s) a step")
    t0 = time.perf_counter()
    s_target = torch.zeros((spheres.camera.height, spheres.camera.width, 3),
                           device="cuda")
    loss, g = diff.value_and_grad(spheres, s_target, rng.PRNGKey(3),
                                  diff._diff_cfg(nojit, spheres))
    ref_g = (loss.item(), grads_np(g))
    log(f"spheres {cam_res} diff.param_grads in one process (the "
        f"wavefront backward): {time.perf_counter() - t0:.3f} s")
    del g, s_target
    for name, red in (("spheres_overlap", BENCH_CFG["max_depth"] + 2),
                      ("spheres_barriered", 1)):
        for r in range(RANKS):
            if info[r][name]["reductions"] != red:
                fail(f"rank {r} {name}: {info[r][name]['reductions']} "
                     f"reductions, not {red}")
        for k, v in arrays[1][name].items():
            if not np.array_equal(v, arrays[0][name][k]):
                fail(f"{name}: the ranks' gradients differ ({k})")
        grads_gate(f"spheres {cam_res} {name[8:]} over {RANKS} ranks vs "
                   f"diff.param_grads", (info[0][name]["loss"],
                                         arrays[0][name]), ref_g,
                   f"; {red} reduction(s) a step")
    l0, l1 = info[0]["train_losses"]
    log(f"train_step_overlap x2 (lr 0.5): loss {l0:.6f} -> {l1:.6f}")
    if not l1 < l0:
        fail("train_step_overlap did not descend")
    # 4. adaptive: the same film on every rank
    a0 = arrays[0]["adaptive"].numpy()
    if not all(np.array_equal(a["adaptive"].numpy(), a0) for a in arrays):
        fail("adaptive_render(mesh=): the ranks' films differ")
    mean = float(a0.mean() / info[0]["adaptive"]["spp"])
    log(f"adaptive_render(mesh=) 8 spp 1024x1024 cornell: the films of "
        f"both ranks equal bit for bit, image mean {mean:.5f}")
    if not (np.isfinite(a0).all() and 0.03 < mean < 0.5):
        fail(f"adaptive_render(mesh=): implausible film (mean {mean})")
    # 5. the light tracer against one process
    reset_counts()
    lt = light_trace_pass(cornell, film_mod.new_film(1024, 1024, "cuda"),
                          rng.PRNGKey(7), cfg, 1024 * 1024).buffer
    lt = lt.cpu().numpy()
    for r in range(RANKS):
        got = arrays[r]["lighttrace"].numpy()
        rel = abs(got.sum() - lt.sum()) / abs(lt.sum())
        close = np.isclose(got, lt, rtol=1e-3, atol=1e-5).all(-1).mean()
        log(f"rank {r} light_trace_pass(mesh=) vs one process: film sums "
            f"rel {rel:.2e}, {close:.4%} of pixels within rtol 1e-3/atol "
            f"1e-5")
        if rel > 1e-4 or close < 0.99:
            fail("light_trace_pass(mesh=) disagrees with one process")
    out["ranks"] = info

    # (c) render_elastic: CLI workers on the card, one killed and resumed
    c_dir = scenes.write_cornell(os.path.join(tmp, "cornell_elastic"), 256,
                                 256)
    el = os.path.join(tmp, "elastic")
    ck0 = os.path.join(el, "worker0.npz")
    state = {"killed": False}

    def injector(procs):
        p = procs.get(0)
        if not state["killed"] and p is not None and p.poll() is None \
                and 1 <= _ckpt_spp(ck0) < ELASTIC_SPP:
            p.kill()
            state["killed"] = True

    # the uninterrupted worker runs beside them, in a thread
    from concurrent.futures import ThreadPoolExecutor
    oracle = os.path.join(tmp, "elastic_oracle")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        plain = pool.submit(render_elastic, c_dir, oracle, n_workers=1,
                            spp_per_worker=ELASTIC_SPP, extra_args=[
                                "-maxDepth", "4", "-device", "cuda"])
        film = render_elastic(c_dir, el, n_workers=2,
                              spp_per_worker=ELASTIC_SPP, extra_args=[
                                  "-maxDepth", "4", "-device", "cuda"],
                              on_poll=injector, poll_s=0.05)
        plain.result()
    el_s = time.perf_counter() - t0
    if not state["killed"]:
        fail("render_elastic: the fault was never injected")
    w0 = load_film(ck0, "cpu").buffer.numpy()
    w0_ref = load_film(os.path.join(oracle, "worker0.npz"),
                       "cpu").buffer.numpy()
    if float(film.spp) != 2 * ELASTIC_SPP or not np.array_equal(w0, w0_ref):
        fail("render_elastic: the resumed worker's film differs from an "
             "uninterrupted one")
    log(f"(c) render_elastic 2 CLI workers x {ELASTIC_SPP} spp at 256x256 on "
        f"the card, worker 0 killed after its first checkpoint and resumed: "
        f"its film equals an uninterrupted worker's (run beside them) bit "
        f"for bit; {el_s:.1f} s wall")
    out["elastic_s"] = el_s
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18 took {out['phase_s']:.1f} s")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the rendered .hdr files (default: "
                         "a temporary directory)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase 18's rank processes
    ap.add_argument("--world", type=int, default=RANKS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.world, args.work)
        return

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "raytracingrenderer_tpu_torch")):
        fail("raytracingrenderer_tpu_torch/ is missing: run from a checkout")
    sys.path.insert(0, ROOT)
    scenes = load_scene_writer()

    import numpy as np
    from raytracingrenderer_tpu_torch.geometry import intersect
    from raytracingrenderer_tpu_torch.ops import bvh_kernel, mt_kernel, treelet
    from raytracingrenderer_tpu_torch.scene.loader import load_scene

    # -- 1. card and host facts --------------------------------------------
    mark(1)
    card = card_facts(torch)
    kind = torch.cuda.get_device_name(0)
    host_facts()

    # -- 2. build ----------------------------------------------------------
    mark(2)
    build_all()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    out_dir = args.out or tmp
    os.makedirs(out_dir, exist_ok=True)
    cornell_dir = scenes.write_cornell(os.path.join(tmp, "cornell"))
    cornell = load_scene(cornell_dir, device="cuda")
    if cornell.triangles.count != 36:
        fail(f"cornell box has {cornell.triangles.count} triangles, not 36")
    t0 = time.perf_counter()
    spheres_dir = scenes.write_spheres(os.path.join(tmp, "spheres"),
                                       subdiv=5)
    t1 = time.perf_counter()
    spheres = load_scene(spheres_dir, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bvh = spheres.bvh
    if spheres.triangles.count != 327_716 or bvh is None:
        fail(f"spheres scene: {spheres.triangles.count} triangles, BVH "
             f"{bvh is not None}")
    # the build alone, timed again on the loaded triangles
    from raytracingrenderer_tpu_torch.geometry import bvh_native
    from raytracingrenderer_tpu_torch.scene import loader
    tr = spheres.triangles
    p0 = tr.p0.stacked().cpu().numpy()
    tp = np.stack([p0, p0 + tr.e1.stacked().cpu().numpy(),
                   p0 + tr.e2.stacked().cpu().numpy()], axis=1)
    t3 = time.perf_counter()
    bvh_native.build(tp, max_leaf=loader.BVH_MAX_LEAF, bins=loader.BVH_BINS,
                     all_axes=True)
    build_s = time.perf_counter() - t3
    t3 = time.perf_counter()
    wide_rows = bvh_kernel.widen(bvh).wsel.shape[0]
    widen_s = time.perf_counter() - t3
    if bvh.wsel is None or not bvh_kernel.wide_ok(bvh):
        fail("the loader did not attach the 4-wide fields")
    n_leaf = (bvh.n_nodes + 1) // 2
    tab_bytes = {leaf16: sum(
        t.numel() * t.element_size()
        for t in bvh_kernel.tables(bvh, spheres.triangles, leaf16))
        for leaf16 in (False, True)}
    log(f"spheres scene: {spheres.triangles.count} triangles, written in "
        f"{t1 - t0:.2f} s, loaded with its BVH on cuda in {t2 - t1:.2f} s "
        f"(native BVH build alone {build_s:.2f} s, widen alone "
        f"{widen_s:.3f} s, {wide_rows} wide rows); BVH depth {bvh.depth}, "
        f"{bvh.n_nodes} nodes ({n_leaf - 1} internal, "
        f"{n_leaf} leaves), leaf_max {bvh.leaf_max}; packed tables "
        f"{tab_bytes[False]} B (raw leaves), {tab_bytes[True]} B "
        f"(constant-form leaves)")
    if not bvh_kernel.usable(bvh):
        fail(f"the spheres BVH (depth {bvh.depth}) does not fit the "
             f"kernel's stack")

    # -- 3. B1 against its plain version -----------------------------------
    mark(3)
    err_a, ms_a, plain_a, bound_a = check_mt_kernel(
        torch, "(a) cornell", cornell.triangles, timed=True)
    err_b, _, _, _ = check_mt_kernel(torch, "(b) random-128",
                                     random_tris(torch, 128, 2), timed=False)
    err_c, ms_c, plain_c, bound_c = check_mt_kernel(
        torch, "(c) random-4096", random_tris(torch, 4096, 3), timed=True)
    mt_pass = check_mt_passes(torch, cornell, spheres)
    mt_host_us = mt_host_split(torch, cornell.triangles)

    # -- 4. B2 against its plain version -----------------------------------
    mark(4)
    b2, b2_batches = check_bvh_kernel(torch, spheres)

    # -- 5. main path 1: cornell (brute force, B1) --------------------------
    mark(5)
    _, cornell_s = render_full(torch, cornell, "cornell", card, out_dir)
    cornell_pps = cornell.camera.width * cornell.camera.height * SPP / cornell_s
    mt_cornell = mt_kernel.launches
    log(f"cornell launches: mt_kernel {mt_cornell}, bvh_kernel "
        f"{bvh_kernel.launches}")
    if mt_cornell == 0:
        fail("the cornell render never launched mt_kernel")

    # -- 6. main path 2: spheres (BVH, wavefront, B2 + B1) ------------------
    mark(6)
    wave_img, wave_s = render_full(torch, spheres, "spheres", card, out_dir)
    spheres_pps = spheres.camera.width * spheres.camera.height * SPP / wave_s
    b2_launches = dict(bvh_kernel.launches)
    mt_spheres = mt_kernel.launches
    log(f"spheres launches: bvh_kernel {b2_launches}, mt_kernel (proxy "
        f"pre-pass) {mt_spheres}, stackless walks "
        f"{intersect.stackless_calls}")
    if min(b2_launches["closest_hit"], b2_launches["any_hit"]) == 0:
        fail("the spheres render did not launch both bvh_kernel variants")
    if mt_spheres == 0:
        fail("the spheres render never launched the proxy pre-pass")
    if intersect.stackless_calls:
        fail("the spheres render took the stackless walk")
    profile_pass(torch, spheres, "spheres")
    # the same render through the scan integrator, timed beside it
    scan_img, scan_s = render_full(torch, spheres, "spheres-scan", card,
                                   out_dir, wavefront=False)
    log(f"spheres 8 spp: wavefront {wave_s:.3f} s, scan {scan_s:.3f} s "
        f"(wavefront / scan {wave_s / scan_s:.3f}) [{card}]")
    same_image("spheres 1024x1024 8 spp, wavefront vs scan", wave_img,
               scan_img)

    # -- 7. GPU (kernels) against CPU (plain versions) -----------------------
    mark(7)
    gpu_vs_cpu("cornell", scenes.write_cornell(
        os.path.join(tmp, "cornell128"), 128, 128))
    spheres128 = scenes.write_spheres(os.path.join(tmp, "spheres128"), 128,
                                      128, subdiv=2)
    gpu_vs_cpu("spheres-5156", spheres128)

    # -- 8. B3 against its plain version -----------------------------------
    mark(8)
    b3 = check_wide_kernel(torch, spheres, b2_batches)
    del b2_batches

    # -- 9. B4 against its plain version -----------------------------------
    mark(9)
    t0 = time.perf_counter()
    tspheres = spheres._replace(bvh=treelet.attach_treelets(spheres.bvh))
    log(f"attach_treelets: {tspheres.bvh.tl_nodes.shape[0]} treelets in "
        f"{tspheres.bvh.tc_nodes.shape[0]} groups, "
        f"{time.perf_counter() - t0:.2f} s")
    b4 = check_pair_kernel(torch, tspheres)

    # -- 10. main path 3: spheres through the treelet route (B4, B1, B2) ----
    mark(10)
    tl_img, tl_s = render_full(torch, tspheres, "spheres-treelet", card,
                               out_dir)
    tl_launches = dict(pair_test=treelet.launches, mt=mt_kernel.launches,
                       **{k: bvh_kernel.launches[k]
                          for k in ("closest_hit", "any_hit")})
    log(f"spheres-treelet launches: {tl_launches}, treelet calls "
        f"{intersect.treelet_calls}, stackless walks "
        f"{intersect.stackless_calls}")
    if min(tl_launches.values()) == 0 or intersect.treelet_calls == 0:
        fail("the treelet render did not launch B4, B1 and both B2 "
             "variants (the fallback) through the treelet route")
    log(f"spheres 8 spp: treelet route {tl_s:.3f} s, packet route (wavefront)"
        f" {wave_s:.3f} s (treelet / packet {tl_s / wave_s:.3f}) [{card}]")
    same_image("spheres 1024x1024 8 spp, treelet vs packet route", tl_img,
               wave_img)

    # -- 11. GPU against CPU for the treelet route ---------------------------
    mark(11)
    gpu_vs_cpu("spheres-5156 treelet", spheres128, treelets=True)

    # -- 12. main path 4: the matrix-unit probes (visit_kernel.cu) ----------
    mark(12)
    probes = check_probes(torch, card)

    # -- 13. main path 5: training (diff.train_steps / train_step) ----------
    mark(13)
    tr_a = train_cornell(torch, card, cornell, cornell_pps)
    tr_b = train_spheres(torch, card, spheres, spheres_pps)
    grads_gpu_vs_cpu(torch, "cornell 128x128 (scan)", scenes.write_cornell(
        os.path.join(tmp, "cornell128g"), 128, 128), wave=False)
    grads_gpu_vs_cpu(torch, "spheres-5156 128x128 (wavefront)", spheres128,
                     wave=True)

    # -- 14. main path 6: training with the boundary term --------------------
    mark(14)
    bnd = dict(boundary_grads=True)
    # the cornell step at 512x512, to keep the script within its time limit
    cornell512 = load_scene(scenes.write_cornell(
        os.path.join(tmp, "cornell512"), 512, 512), device="cuda")
    tr_c = train_cornell(torch, card, cornell512, cornell_pps,
                         steps=BOUNDARY_STEPS, remats=(True,),
                         name="cornell-boundary", profiled=("forward",),
                         **bnd)
    tr_d = train_spheres(torch, card, spheres, spheres_pps,
                         name="spheres-boundary", profiled=(), **bnd)
    for name, res, with_b, without in (
            ("cornell", "512x512", tr_c, tr_a),
            ("spheres", "1024x1024", tr_d, tr_b)):
        log(f"training {name} {res}: fwdbwd_pps with the boundary term "
            f"{with_b['fwdbwd_pps']:.6g}, without (phase 13, 1024x1024) "
            f"{without['fwdbwd_pps']:.6g} (with / without "
            f"{with_b['fwdbwd_pps'] / without['fwdbwd_pps']:.3f}) [{card}]")
    # at 64x64, to keep the script within its time limit
    grads_gpu_vs_cpu(torch, "cornell 64x64 (scan), boundary_grads",
                     scenes.write_cornell(os.path.join(tmp, "cornell64b"),
                                          64, 64), wave=False, **bnd)
    grads_gpu_vs_cpu(torch, "spheres-5156 64x64 (wavefront), "
                     "boundary_grads", scenes.write_spheres(
                         os.path.join(tmp, "spheres64b"), 64, 64, subdiv=2),
                     wave=True, **bnd)

    # -- 15. main path 7: the sky (envmap lighting, B2 + B1) ----------------
    mark(15)
    sky = sky_phase(torch, card, scenes, tmp, out_dir)

    # -- 16. main path 8: dispatch.render_with (AOVs, lighttrace, vpl) -----
    mark(16)
    disp = dispatch_phase(torch, card, scenes, tmp, out_dir, cornell,
                          spheres, spheres128)

    # -- 17. main path 9: the adaptive integrator and the command line ------
    mark(17)
    adapt = adaptive_phase(torch, card, scenes, tmp, out_dir, cornell,
                           cornell_dir, spheres, spheres128)

    # -- 18. main path 10: parallel/ (ranks, scene shards, elastic) --------
    mark(18)
    par = parallel_phase(torch, card, scenes, tmp, cornell, spheres,
                         spheres_dir)
    log("new paths " + json.dumps({"card": card, "sky": sky,
                                   "render_with": disp,
                                   "adaptive": adapt, "parallel": par}))
    log(f"-- every phase done at {time.perf_counter() - T_START:.1f} s")

    def brief(tr):
        return {k: v for k, v in tr.items() if not k.endswith("_ops")}
    log("training " + json.dumps({
        "card": card, "cornell": brief(tr_a), "spheres": brief(tr_b),
        "cornell_boundary": brief(tr_c), "spheres_boundary": brief(tr_d)}))
    bvh_src = dict(route="cuda",
                   source="raytracingrenderer_tpu_torch/csrc/bvh_kernel.cu",
                   replaces="raytracingrenderer_tpu/ops/bvh_kernel.py:65")
    log(json.dumps({"kernels": [{
        "name": "mt_intersect",
        "route": "cuda",
        "source": "raytracingrenderer_tpu_torch/csrc/mt_kernel.cu",
        "replaces": "raytracingrenderer_tpu/ops/mt_kernel.py:41",
        "launches": mt_cornell,
        "launches_spheres_prepass": mt_spheres,
        "max_abs_err": max(err_a, err_b, err_c,
                           *(p["max_abs_err"] for p in mt_pass.values())),
        "ms": ms_a,
        "plain_ms": plain_a,
        "library_ms": None,
        **bound_a,
        "render_pass_ms": mt_pass["cornell"]["render_pass_ms"],
        "render_pass_issue_ms": mt_pass["cornell"]["render_pass_issue_ms"],
        "render_pass_widths": mt_pass["cornell"]["render_pass_widths"],
        "spheres_prepass": mt_pass["spheres_prepass"],
        "host_us": mt_host_us,
        "ms_4096_tris": ms_c,
        "plain_ms_4096_tris": plain_c,
        "bound_ms_4096_tris": bound_c["bound_ms"],
        "bound_share_4096_tris": bound_c["bound_share"],
        "issue_ms_4096_tris": bound_c["issue_ms"],
        "issue_share_4096_tris": bound_c["issue_share"],
        "launches_treelet_path": tl_launches["mt"],
        "launches_training_cornell": tr_a["b1_launches"],
        "launches_training_spheres_prepass": tr_b["launches"]["mt"],
        "launches_training_backward": (tr_a["bwd_launches"]["mt"]
                                       + tr_b["bwd_launches"]["mt"]),
        "launches_training_boundary_cornell": tr_c["b1_launches"],
        "launches_training_boundary_spheres_prepass":
            tr_d["launches"]["mt"],
        "launches_training_boundary_backward": (
            tr_c["bwd_launches"]["mt"] + tr_d["bwd_launches"]["mt"]),
        "launches_sky_prepass": sky["launches"]["mt"],
        "launches_render_with": {k: v["mt"] for k, v in disp.items()},
        "launches_adaptive": {k: v["mt"] for k, v in adapt.items()
                              if "mt" in v},
        "launches_parallel": parallel_launches(par, None),
    }] + [dict(name=f"bvh_traverse/{v}", **bvh_src,
               launches=b2_launches[v],
               launches_treelet_path=tl_launches[v],
               launches_training_spheres=tr_b["launches"][v],
               launches_training_backward=(
                   tr_a["bwd_launches"].get(v, 0)
                   + tr_b["bwd_launches"].get(v, 0)),
               launches_training_boundary_spheres=tr_d["launches"][v],
               launches_training_boundary_backward=(
                   tr_c["bwd_launches"].get(v, 0)
                   + tr_d["bwd_launches"].get(v, 0)),
               launches_sky=sky["launches"][v],
               launches_render_with={k: c[v] for k, c in disp.items()
                                     if v in c},
               launches_adaptive=adapt["spheres"][v],
               launches_parallel=parallel_launches(par, v),
               library_ms=None,
               **b2[v])
          for v in ("closest_hit", "any_hit")]
        + [dict(name=f"bvh_traverse_wide/{v}", **dict(
            bvh_src, replaces="raytracingrenderer_tpu/ops/bvh_kernel.py:498"),
            library_ms=None, **b3[v]) for v in ("closest_hit", "any_hit")]
        + [dict(name="treelet_pair_test", route="cuda",
                source="raytracingrenderer_tpu_torch/csrc/treelet_kernel.cu",
                replaces="raytracingrenderer_tpu/ops/treelet.py:269",
                launches=tl_launches["pair_test"], **b4)]
        + probes}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAIL: exception above", flush=True)
        sys.exit(1)
