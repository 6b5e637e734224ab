"""Command-line renderer.

Counterpart of raytracingrenderer_tpu/cli.py, with the same flags:
RTBase's (-scene, -outputFilename, -SPP; Main.cpp:19-66) and the knobs
RTBase bakes in as constants (Renderer.h:18-24) or commented-out lines
(the integrator switch, Renderer.h:876-885).  Headless: renders,
reports progress, writes HDR (and an optional PNG preview) and
checkpoints the film.  One flag more than the JAX package's: -device,
the card by default ("cpu" runs the kernels' plain versions; "cuda"
without a card raises); and -profile reports the interactive session's
phases too.

Under torchrun every rank runs this (parallel/distributed.py joins them;
one process needs no group), and only rank 0 logs and writes files.
-sceneShards N shards the scene's triangles and BVH over N ranks
(parallel/scene_shard.py): every rank renders the whole image, each
walking its own shard.

    python -m raytracingrenderer_tpu_torch.cli -scene <dir> -SPP 8 \\
        -outputFilename out.hdr [-device cpu]
    torchrun --nproc_per_node N -m raytracingrenderer_tpu_torch.cli \\
        -scene <dir> -sceneShards N -SPP 8 -outputFilename out.hdr
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracingrenderer_tpu_torch",
                                description=__doc__)
    p.add_argument("-scene", default="MaterialsScene",
                   help="scene directory containing scene.json")
    p.add_argument("-outputFilename", default="GI.hdr")
    p.add_argument("-SPP", type=int, default=8192)
    p.add_argument("-integrator", default="path",
                   choices=["path", "direct", "albedo", "normals",
                            "lighttrace", "vpl", "adaptive"])
    p.add_argument("-maxDepth", type=int, default=4)
    p.add_argument("-noMIS", action="store_true",
                   help="reference-parity NEE without MIS")
    p.add_argument("-noJitter", action="store_true",
                   help="pixel centres only, like the reference")
    p.add_argument("-preview", type=int, default=0, metavar="N",
                   help="write <output>.png preview every N spp")
    p.add_argument("-checkpoint", default="",
                   help="film checkpoint path (resume if it exists)")
    p.add_argument("-checkpointEvery", type=int, default=0)
    p.add_argument("-timeBudget", type=float, default=0.0,
                   help="stop after this many seconds (reference stops at "
                        "10 s, Main.cpp:132-137); 0 = no budget")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-width", type=int, default=0,
                   help="override scene.json resolution")
    p.add_argument("-height", type=int, default=0)
    p.add_argument("-denoise", action="store_true",
                   help="edge-aware denoise of the final image")
    p.add_argument("-sceneShards", type=int, default=0,
                   help="shard the BVH + triangle geometry over this "
                        "many ranks (torchrun --nproc_per_node N); 0 = "
                        "replicate")
    p.add_argument("-interactive", action="store_true",
                   help="fly-camera loop on stdin (reference Main.cpp "
                        "main loop: keys move + clear film, p/l save)")
    p.add_argument("-keys", default="",
                   help="scripted interactive session: comma-separated "
                        "keys applied between render ticks")
    p.add_argument("-profile", action="store_true",
                   help="phase timing report (load/render/denoise/write) "
                        "+ device memory stats at exit")
    p.add_argument("-trace", default="", metavar="DIR",
                   help="capture a torch.profiler trace of the render to "
                        "DIR/trace.json (chrome://tracing, Perfetto)")
    p.add_argument("-device", default="cuda",
                   help="torch device to load and render on (default: "
                        "the card; 'cpu' for the plain versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # every rank of a torchrun launch joins here (a no-op for one
    # process); a group made here is taken down on the way out
    from .parallel.distributed import init_distributed
    owned = init_distributed(device=args.device)
    try:
        return _main(args)
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args) -> int:

    import contextlib
    import dataclasses
    import logging

    from .config import RenderConfig
    from .imaging import film as film_mod
    from .io.hdr import write_hdr
    from .io.png import write_png
    from .render import render
    from .scene.loader import load_scene
    from .utils.checkpoint import load_film, save_film
    from .utils.log import get_logger
    from .utils.profiling import Timer, wait_for

    import torch.distributed as dist
    log = get_logger("cli")
    # rank 0 alone logs and writes files; the others render in silence
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    if not main_rank:
        logging.getLogger("rtr").setLevel(logging.WARNING)
    prof = Timer() if args.profile else None
    t0 = time.time()
    device = args.device
    if device == "cuda" and dist.is_initialized():
        from .parallel.distributed import rank_device
        device = rank_device()
    scene = load_scene(args.scene, device=device,
                       scene_shards=args.sceneShards)
    if prof is not None:
        prof.totals["load"] = time.time() - t0
        prof.counts["load"] = 1
    if args.width or args.height:
        c = scene.camera
        scene = scene._replace(camera=dataclasses.replace(
            c, width=args.width or c.width, height=args.height or c.height))
    log.info("scene %s: %d tris, %d materials, %d lights (%.1fs)",
             args.scene, scene.triangles.count, scene.materials.count,
             scene.num_lights, time.time() - t0)

    cfg = RenderConfig(spp=args.SPP, max_depth=args.maxDepth,
                       mis=not args.noMIS, jitter=not args.noJitter,
                       integrator=args.integrator, seed=args.seed)

    def phase(name):
        return prof.phase(name) if prof is not None \
            else contextlib.nullcontext()

    def report(img, spp):
        """-profile's phase report and the card's memory statistics."""
        if prof is None:
            return
        from .utils.profiling import device_memory_stats
        h, w = img.shape[:2]
        log.info("phase report:\n%s", prof.report(rays=h * w * spp))
        mem = device_memory_stats()
        if mem:
            log.info("device memory: %s",
                     {k: v for k, v in mem.items() if "bytes" in k})

    if args.interactive or args.keys:
        if dist.is_initialized():
            raise ValueError("-interactive and -keys drive one process; "
                             "run them without torchrun")
        from .interactive import run_scripted, run_stdin
        out_base = args.outputFilename.rsplit(".", 1)[0]
        with phase("render"):
            if args.keys:
                s = run_scripted(scene, args.scene, cfg, args.keys,
                                 output=out_base)
            else:
                s = run_stdin(scene, args.scene, cfg, output=out_base)
            img = film_mod.to_hdr(s.film).cpu().numpy()
        with phase("write"):
            write_hdr(args.outputFilename, img)
        log.info("wrote %s (%d spp, mean %.4f)", args.outputFilename,
                 s.spp, float(img.mean()))
        report(img, s.spp)
        return 0

    film = None
    if args.checkpoint:
        film = load_film(args.checkpoint, device=scene.device)
        if film is not None:
            log.info("resumed checkpoint at %d spp", int(film.spp))

    state = {"t_start": time.time(), "t_last": time.time(), "stop": False}

    def on_sample(s, f):
        wait_for(f.buffer)  # honest per-frame timing
        state["film"] = f  # survives a time-budget interrupt
        now = time.time()
        dt = now - state["t_last"]
        state["t_last"] = now
        h, w = f.buffer.shape[:2]
        log.info("spp %d  %.3fs/frame  %.2f Mpaths/s  total %.1fs",
                 s + 1, dt, h * w / max(dt, 1e-9) / 1e6,
                 now - state["t_start"])
        if main_rank and args.preview and (s + 1) % args.preview == 0:
            write_png(args.outputFilename + ".png",
                      film_mod.tonemap(f).cpu().numpy())
        if main_rank and args.checkpoint and args.checkpointEvery and \
                (s + 1) % args.checkpointEvery == 0:
            save_film(args.checkpoint, f)
        if args.timeBudget and _agree(now - state["t_start"]
                                      > args.timeBudget, f.buffer.device):
            state["stop"] = True
            raise StopIteration

    from .utils.profiling import trace
    trace_ctx = trace(args.trace) if args.trace else contextlib.nullcontext()
    try:
        with trace_ctx, phase("render"):
            if args.integrator == "path":
                film = render(scene, cfg, spp=args.SPP, film=film,
                              on_sample=on_sample)
            else:
                from .integrators.dispatch import render_with
                film = render_with(scene, cfg, spp=args.SPP, film=film,
                                   on_sample=on_sample)
    except StopIteration:
        log.info("time budget reached")
        film = state.get("film", film)
    if film is None:
        log.error("no samples rendered before the budget expired")
        return 1

    img = film_mod.to_hdr(film)
    if args.denoise:
        # auxiliary-guided filtering, as OIDN's: albedo and normal AOVs,
        # one pixel-centre sample each (RTBase passes the beauty alone,
        # Renderer.h:752-793)
        from .imaging.denoise import denoise as dn
        from .integrators import aov
        from .sampling import rng
        with phase("denoise"):
            aov_cfg = RenderConfig(jitter=False, seed=cfg.seed)
            guide_key = rng.PRNGKey(cfg.seed)
            alb = aov.albedo_image(scene, guide_key, aov_cfg)
            nrm = aov.normals_image(scene, guide_key, aov_cfg)
            img = dn(img, albedo=alb, normal=nrm)
            wait_for(img)
    img = img.detach().cpu().numpy()
    if main_rank:
        with phase("write"):
            write_hdr(args.outputFilename, img)
        log.info("wrote %s (%d spp, mean %.4f)", args.outputFilename,
                 int(film.spp), float(img.mean()))
        if args.checkpoint:
            save_film(args.checkpoint, film)
    report(img, int(film.spp))
    return 0


def _agree(flag: bool, device) -> bool:
    """Rank 0's `flag` on every rank (the time budget: ranks that walk a
    sharded scene together must stop at the same sample)."""
    import torch
    import torch.distributed as dist
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


if __name__ == "__main__":
    sys.exit(main())
