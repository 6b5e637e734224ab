"""Kind `render`: a progressive final frame, one sample pass after another.

Set-up loads the scene (timed alone as `load_s`) and warms up the one
shape the window uses with one pass on a throw-away film.  The window
calls the renderer's entry point
    render(scene, cfg, spp=1, film=film, on_sample=...)
pass after pass (pass s keyed spp_key(PRNGKey(cfg.seed), s), as the
renderer keys a progressive render) until `seconds` have passed.  A
pass's clock starts at the call and stops in on_sample after a
synchronise: one frame of the progressive display.  on_sample also keeps
the film's band of rows for the check (a copy of band_rows rows, queued
before the synchronise).

End-to-end: render_pps, pixels x passes over the window's wall;
pass_p90_ms, the 90th percentile of every pass's time.
"""
from __future__ import annotations

import gc
import time


def run(ctx) -> dict:
    import torch
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.imaging.film import new_film
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    from rtbench import harness, inputs, tracing
    from rtbench.reference import compare

    mix, conf = ctx.mix, ctx.config
    w, h = int(mix["width"]), int(mix["height"])
    sdir = inputs.scene_dir(conf, w, h)
    t0 = time.perf_counter()
    scene = load_scene(str(sdir), ctx.device)
    ctx.sync()
    load_s = time.perf_counter() - t0
    cfg = RenderConfig(**conf["render_config"], seed=inputs.seed32(ctx.seed))
    render(scene, cfg, spp=1)                       # warm-up pass
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s (load_scene {load_s:.3f} s)")

    rows = int(mix["band_rows"])
    r0 = inputs.band(ctx.seed, h, rows)
    bands, stamp = [], [0.0]

    def on_sample(s, film):
        bands.append(film.buffer[r0:r0 + rows].clone())
        ctx.sync()
        stamp[0] = time.perf_counter()

    film = new_film(h, w, scene.device)
    times = []
    t_win = time.perf_counter()
    while True:
        t_a = time.perf_counter()
        film = render(scene, cfg, spp=1, film=film, on_sample=on_sample)
        times.append(stamp[0] - t_a)
        if stamp[0] - t_win >= ctx.seconds:
            break
    wall = stamp[0] - t_win
    passes = len(times)
    ctx.log(f"window {wall:.3f} s, {passes} passes")
    out = dict(setup_s=setup_s, attempted=passes,
               e2e={"render_pps": w * h * passes / wall,
                    "pass_p90_ms": harness.p90(times) * 1e3},
               memory_peak_bytes=ctx.memory_peak(),
               record={"load_s": load_s, "wall_s": wall, "pass_s": times})
    if ctx.trace:
        n = int(mix["trace_passes"])
        extra = new_film(h, w, scene.device)
        prof, twall = tracing.capture(
            ctx, lambda i: render(scene, cfg, spp=1, film=extra), n)
        out["record"].update(tracing.summarize(prof.events(), twall, n))
        del prof, extra
        ctx.log(f"traced {n} passes in {twall:.3f} s")
    film_spp = float(film.spp)
    bands = [b.cpu() for b in bands]
    failed = sum(int(not torch.isfinite(b).all()) for b in bands)
    del scene, film
    gc.collect()
    ctx.free()
    out["failed"] = failed
    ctx.log("check: the reference's passes")
    out["checks"] = compare.check_render(
        sdir, conf["render_config"], ctx.seed, r0, bands, film_spp, passes,
        int(mix["check_passes"]), ctx.device)
    ctx.log(f"check done: {out['checks']}")
    return out
