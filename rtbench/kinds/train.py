"""Kind `train`: inverse rendering, a scene fitted to a target image by SGD.

Set-up loads the scene (`load_s`), makes the target (the scene with its
albedo and light Le scaled by factors drawn from the seed, rendered at
target_spp), then runs the first setup_steps steps through the window's
own call: they warm up every shape, and the check follows them.  A step
is the renderer's
    scene, loss = diff.train_step(scene, target, key, cfg, lr)
    scene = geometry.refit.refit(scene)
(step k keyed rng.fold_in(PRNGKey(cfg.seed), k), one sample a pixel,
remat at its default); the window runs steps until `seconds` have
passed, each ended by a synchronise, the refit timed between two.

End-to-end: train_pps, pixels x whole steps over those steps' wall;
train_peak_gib, torch.cuda.max_memory_allocated over the window's steps.
"""
from __future__ import annotations

import gc
import statistics
import time


def run(ctx) -> dict:
    import torch
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.geometry.refit import refit
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    from rtbench import inputs, tracing
    from rtbench.reference import compare

    mix, conf = ctx.mix, ctx.config
    w, h = int(mix["width"]), int(mix["height"])
    lr = float(mix["lr"])
    sdir = inputs.scene_dir(conf, w, h)
    t0 = time.perf_counter()
    scene = load_scene(str(sdir), ctx.device)
    ctx.sync()
    load_s = time.perf_counter() - t0

    fa, fl = inputs.perturbation(ctx.seed, scene.materials.count,
                                 scene.num_lights, mix["perturb"])
    tcfg = RenderConfig(**conf["render_config"],
                        seed=inputs.target_seed(ctx.seed))
    tfilm = render(compare.perturbed(scene, fa, fl), tcfg,
                   spp=int(mix["target_spp"]))
    target = tfilm.buffer / tfilm.spp
    del tfilm

    cfg = RenderConfig(**conf["render_config"], seed=inputs.seed32(ctx.seed))
    key0 = rng.PRNGKey(cfg.seed)
    refit_s = []

    def step(k):
        nonlocal scene
        scene, loss = diff.train_step(scene, target, rng.fold_in(key0, k),
                                      cfg, lr)
        ctx.sync()
        t_r = time.perf_counter()
        scene = refit(scene)
        ctx.sync()
        refit_s.append(time.perf_counter() - t_r)
        return loss

    # the check follows the first check_steps of the set-up steps
    first = {"losses": [], "p0": compare.host_leaves(scene)}
    n_setup, n_check = int(mix["setup_steps"]), int(mix["check_steps"])
    for k in range(n_setup):
        loss = float(step(k))
        if k < n_check:
            first["losses"].append(loss)
        if k == 0:
            first["p1"] = compare.host_leaves(scene)
        if k == n_check - 1:
            first["pn"] = compare.host_leaves(scene)
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = ctx.memory_peak()
    ctx.log(f"set-up {setup_s:.3f} s (load_scene {load_s:.3f} s)")

    ctx.reset_peak()
    refit_s.clear()
    losses = []
    k = n_setup
    t_win = time.perf_counter()
    while True:
        losses.append(step(k))
        k += 1
        t_end = time.perf_counter()
        if t_end - t_win >= ctx.seconds:
            break
    wall = t_end - t_win
    steps = len(losses)
    ctx.log(f"window {wall:.3f} s, {steps} steps")
    peak = ctx.memory_peak()
    out = dict(setup_s=setup_s, attempted=steps,
               failed=int((~torch.isfinite(torch.stack(losses))).sum()),
               e2e={"train_pps": w * h * steps / wall,
                    "train_peak_gib": peak / 2 ** 30},
               memory_peak_bytes=max(peak, setup_peak),
               record={"load_s": load_s, "wall_s": wall,
                       "refit_ms": statistics.median(refit_s) * 1e3})
    if ctx.trace:
        n = int(mix["trace_steps"])
        prof, twall = tracing.capture(ctx, lambda i: step(k + i), n)
        out["record"].update(tracing.summarize(prof.events(), twall, n))
        del prof
        ctx.log(f"traced {n} steps in {twall:.3f} s")
    out["bounds_out"] = compare.bounds_out(scene.bvh, scene.triangles)
    del scene, target
    gc.collect()
    ctx.free()
    ctx.log("check: the reference's steps")
    ref = compare.follow_training(sdir, conf["render_config"], mix,
                                  ctx.seed, n_check, ctx.device, log=ctx.log)
    for row in compare.leaf_table(first, ref, lr):
        ctx.log("leaf %s grad %r %r change %r %r" % row)
    ctx.log(f"losses {first['losses']} reference {ref['losses']}")
    out["checks"] = dict(compare.train_numbers(first, ref, lr),
                         bounds_out=float(out.pop("bounds_out")))
    ctx.log(f"check done: {out['checks']}")
    return out
