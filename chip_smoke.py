#!/usr/bin/env python3
"""Smoke test of the PyTorch port (raytracingrenderer_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, launches its
kernels and renders.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero):
  1. card facts: nvidia-smi's name and power limit, torch's device name;
  2. build every kernel of the render path from csrc/ with nvcc (sm_90a);
  3. each kernel against its plain torch version on the card, at the
     shapes the render gives it, closest-hit and any-hit, with 10% dead
     lanes: t within rtol/atol 1e-4, triangle ids and any-hit bits
     agreeing on >= 99.9% of rays, no dead lane hit; kernel and plain
     times at 1,048,576 rays;
  4. the main path at full size: the in-repo cornell box (36 triangles)
     at 1024x1024, RenderConfig(mis=True, jitter=True, max_depth=4),
     8 spp, loaded and rendered on "cuda"; every kernel of the path must
     have launched; a finite image with a sane mean, written as .hdr;
  5. the same scene at 128x128, 2 spp, on "cuda" (kernels) and on "cpu"
     (plain versions), same keys: >= 99% of pixels within rtol 1e-3 /
     atol 1e-5, image means within 0.5%.

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.  JAX is never imported.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
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
BENCH_CFG = dict(mis=True, jitter=True, max_depth=4)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def load_scene_writer():
    path = os.path.join(ROOT, "tests", "torch_scenes.py")
    if not os.path.isfile(path):
        fail("tests/torch_scenes.py is missing: run from a checkout")
    spec = importlib.util.spec_from_file_location("torch_scenes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
            cu(t_closest), cu(t_any), cu(dead))


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


def check_mt_kernel(torch, name, tris, timed: bool):
    """Kernel vs plain on the card; returns (max_abs_err, ms, plain_ms)."""
    from raytracingrenderer_tpu_torch.ops import mt_kernel
    o, d, t_closest, t_any, dead = make_rays(torch, N_CHECK, seed=0)
    hk = mt_kernel.intersect(tris, o, d, t_closest)
    hp = mt_kernel.intersect_plain(tris, o, d, t_closest)
    ak = mt_kernel.any_hit(tris, o, d, t_any)
    ap = mt_kernel.intersect_plain(tris, o, d, t_any).tri >= 0
    torch.cuda.synchronize()
    err = (hk.t - hp.t).abs().max().item()
    t_ok = torch.allclose(hk.t, hp.t, rtol=1e-4, atol=1e-4)
    tri_agree = (hk.tri == hp.tri).float().mean().item()
    any_agree = (ak == ap).float().mean().item()
    dead_hits = int((hk.tri[dead] >= 0).sum().item()
                    + ak[dead].sum().item())
    hit_frac = (hk.tri >= 0).float().mean().item()
    log(f"mt_kernel {name}: {N_CHECK} rays, {tris.count} triangles: "
        f"max|dt| {err:.3e} (allclose 1e-4: {t_ok}), tri agreement "
        f"{tri_agree:.6f}, any-hit agreement {any_agree:.6f}, dead-lane "
        f"hits {dead_hits}, hit fraction {hit_frac:.3f}")
    if not (t_ok and tri_agree >= 0.999 and any_agree >= 0.999
            and dead_hits == 0 and hit_frac > 0.1):
        fail(f"mt_kernel disagrees with its plain version ({name})")
    ms = plain_ms = None
    if timed:
        o, d, t_closest, _, _ = make_rays(torch, N_TIMED, seed=1,
                                          dead_frac=0.0)
        ms = time_ms(torch, lambda: mt_kernel.intersect(
            tris, o, d, t_closest), 20)
        plain_ms = time_ms(torch, lambda: mt_kernel.intersect_plain(
            tris, o, d, t_closest), 3)
        log(f"mt_kernel {name}: closest-hit at {N_TIMED} rays x "
            f"{tris.count} triangles: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms")
    return err, ms, plain_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the rendered .hdr (default: a "
                         "temporary directory)")
    args = ap.parse_args()

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
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.io.hdr import write_hdr
    from raytracingrenderer_tpu_torch.ops import build, mt_kernel
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.scene.loader import load_scene

    # -- 1. card facts ---------------------------------------------------
    card = card_facts(torch)
    kind = torch.cuda.get_device_name(0)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build("mt_kernel")
    log(f"build: {os.path.relpath(lib, ROOT)} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in build.build_log.items():
        log(f"nvcc {name}.cu: {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {line.strip()}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    out_dir = args.out or tmp
    os.makedirs(out_dir, exist_ok=True)
    scene_dir = scenes.write_cornell(os.path.join(tmp, "cornell"))
    scene = load_scene(scene_dir, device="cuda")
    if scene.triangles.count != 36:
        fail(f"cornell box has {scene.triangles.count} triangles, not 36")

    # -- 3. kernel vs plain on the card ----------------------------------
    err_a, ms_a, plain_a = check_mt_kernel(torch, "(a) cornell",
                                           scene.triangles, timed=True)
    err_b, _, _ = check_mt_kernel(torch, "(b) random-128",
                                  random_tris(torch, 128, 2), timed=False)
    err_c, ms_c, plain_c = check_mt_kernel(
        torch, "(c) random-4096", random_tris(torch, 4096, 3), timed=True)

    # -- 4. the main path at full size -----------------------------------
    cfg = RenderConfig(**BENCH_CFG)
    spp = 8
    cam = scene.camera
    render(scene, cfg, spp=1)                       # warm-up pass
    torch.cuda.synchronize()
    mt_kernel.launches = 0
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=spp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mt_kernel.launches
    img = film_mod.to_hdr(film)
    if tuple(img.shape) != (cam.height, cam.width, 3):
        fail(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        fail("non-finite pixels in the 1024x1024 render")
    mean = img.mean().item()
    pps = cam.width * cam.height * spp / dt
    log(f"render cornell {cam.width}x{cam.height}, {spp} spp, "
        f"mis+jitter, max_depth 4: {dt:.3f} s, {pps:.6g} pixel-paths/s "
        f"[{card}], image mean {mean:.5f}, mt_kernel launches {launches}")
    if launches == 0:
        fail("the render never launched mt_kernel")
    if not 0.03 < mean < 0.5:
        fail(f"implausible image mean {mean}")
    hdr_path = os.path.join(
        out_dir, f"cornell_{cam.width}x{cam.height}_{spp}spp.hdr")
    write_hdr(hdr_path, img.cpu().numpy())
    log(f"wrote {hdr_path} ({os.path.getsize(hdr_path)} bytes)")

    # -- 5. GPU (kernel) vs CPU (plain) ----------------------------------
    small_dir = scenes.write_cornell(os.path.join(tmp, "cornell128"),
                                     128, 128)
    imgs = {}
    for dev in ("cuda", "cpu"):
        f = render(load_scene(small_dir, device=dev), cfg, spp=2)
        imgs[dev] = film_mod.to_hdr(f).cpu().numpy()
    a, b = imgs["cuda"], imgs["cpu"]
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    log(f"cornell 128x128 2 spp, cuda vs cpu: {close:.4%} of pixels within "
        f"rtol 1e-3/atol 1e-5, means {a.mean():.6f} vs {b.mean():.6f} "
        f"(rel {rel:.2e})")
    if close < 0.99 or rel > 0.005:
        fail("GPU render disagrees with the CPU render")

    log(json.dumps({"kernels": [{
        "name": "mt_intersect",
        "route": "cuda",
        "source": "raytracingrenderer_tpu_torch/csrc/mt_kernel.cu",
        "replaces": "raytracingrenderer_tpu/ops/mt_kernel.py:41",
        "launches": launches,
        "max_abs_err": max(err_a, err_b, err_c),
        "ms": ms_a,
        "plain_ms": plain_a,
        "ms_4096_tris": ms_c,
        "plain_ms_4096_tris": plain_c,
    }]}))
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
