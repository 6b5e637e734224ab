"""Kind `train_tree`: kind `train` on a scene too large for every ray
against every triangle, checked by the reference with its tree.

The run is kind `train`'s own (set-up, the window of diff.train_step then
geometry.refit.refit, the traced step and the check), inside
`reference.tree.installed()`, which gives the reference a tree walk
equal to its brute force bit for bit.  With --trace 1, after that run
has returned, the scene is loaded again and one more step is taken
against a target rendered from the unperturbed scene: the growth of
`ops.gather.plain_grad_rows` over it (the indices whose
gradient-carrying gather stayed on plain indexing, so on autograd's
`index_put_`) goes to the record as `plain_grad_rows`.  What the
renderer lacks is left out of the record.
"""
from __future__ import annotations

import gc


def extras(ctx) -> dict:
    """The rows whose transpose stayed on plain indexing in one step."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.geometry.refit import refit
    from raytracingrenderer_tpu_torch.ops import gather
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.sampling import rng
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    from rtbench import inputs

    mix, conf = ctx.mix, ctx.config
    w, h = int(mix["width"]), int(mix["height"])
    scene = load_scene(str(inputs.scene_dir(conf, w, h)), ctx.device)
    cfg = RenderConfig(**conf["render_config"], seed=inputs.seed32(ctx.seed))
    film = render(scene, cfg, spp=1)
    target = film.buffer / film.spp
    out = {}
    before = getattr(gather, "plain_grad_rows", None)
    scene, _ = diff.train_step(scene, target, rng.PRNGKey(cfg.seed), cfg,
                               float(mix["lr"]))
    scene = refit(scene)
    ctx.sync()
    after = getattr(gather, "plain_grad_rows", None)
    if before is not None and after is not None:
        out["plain_grad_rows"] = after - before
    del scene, target, film
    gc.collect()
    ctx.free()
    return out


def run(ctx) -> dict:
    from rtbench import harness
    from rtbench.reference import tree
    with tree.installed():
        out = harness.kind("train").run(ctx)
    if ctx.trace:
        out["record"].update(extras(ctx))
        ctx.log(f"extras: plain_grad_rows "
                f"{out['record'].get('plain_grad_rows')}")
    return out
