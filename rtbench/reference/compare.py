"""What decides `correct`: the renderer's outputs against the plain
reference (pt/), number by number, each beside its limit.

Render cells.  The renderer's film is kept, for one band of rows, after
every pass of the window; a pass's image there is the difference of two
kept bands (Fast2Sum: exact up to half an ulp of the sum).  The
reference renders the same band of a few passes drawn from the seed
with the same keys, and the numbers are
  px_off_pct  the share of those pixels, in %, where a channel differs
              by more than 1e-3 of the reference's value + 1e-5 + one
              ulp of the film's sum there;
  spp_gap     |film spp - passes run| (exact).

Train cells.  The renderer's first check_steps steps (of set-up,
through the window's own call) are followed by the reference from the
same scene files and perturbation, its target rendered by itself, and
the numbers are
  loss_gap    the largest |loss - reference loss| / |reference loss|
              over those steps;
  grad_gap    by the worst parameter leaf, the gap of the first step's
              gradient norms, each gradient worked out from the state
              after one step, (p0 - p1) / lr;
  change_gap  by the worst leaf, the gap of the norms of pn - p0, the
              change over those steps;
  bounds_out  nodes of the renderer's refitted tree, at the window's
              end, whose box does not hold its triangles or children
              (exact).
A leaf's gap is |norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient norm is under a thousandth of the median leaf's (a
diffuse material's roughness, whose gradient is zero) are left out of
grad_gap and change_gap.
"""
from __future__ import annotations

import statistics
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import inputs
from . import precision
from .pt import diff as ref_diff
from .pt.config import RenderConfig
from .pt.render import sample_image
from .pt.sampling import rng
from .pt.scene.loader import load_scene

LEAF_NAMES = ("albedo.x", "albedo.y", "albedo.z", "emission.x",
              "emission.y", "emission.z", "alpha", "light_le.x",
              "light_le.y", "light_le.z", "tri_p0.x", "tri_p0.y",
              "tri_p0.z")


def leaves(scene) -> List[torch.Tensor]:
    """A scene's parameters in LEAF_NAMES order (the renderer's scene or
    the reference's: the two share the table layout)."""
    m = scene.materials
    return [*m.albedo, *m.emission, m.alpha, *scene.lights.le,
            *scene.triangles.p0]


def host_leaves(scene) -> List[torch.Tensor]:
    return [p.detach().to("cpu", torch.float64, copy=True)
            for p in leaves(scene)]


def ref_scene(scene_dir, device, lowp: bool = False):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = load_scene(str(scene_dir), device)
    if lowp:
        scene = precision.lower_scene(scene)
    return scene


def ref_config(render_config: dict, seed: int) -> RenderConfig:
    return RenderConfig(**render_config, seed=seed)


# ---- render cells -----------------------------------------------------

def ulp(x: torch.Tensor) -> torch.Tensor:
    a = torch.abs(x)
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def pixels_off(img: torch.Tensor, ref: torch.Tensor,
               acc: Optional[torch.Tensor] = None) -> int:
    """Pixels of `img` with a channel off `ref` by more than
    1e-3 |ref| + 1e-5 (+ one ulp of `acc`, the sum `img` was read
    from)."""
    tol = 1e-3 * torch.abs(ref) + 1e-5
    if acc is not None:
        tol = tol + ulp(acc)
    bad = ~(torch.abs(img - ref) <= tol)          # NaN counts as off
    return int(bad.any(dim=-1).sum())


def reference_bands(scene, cfg: RenderConfig, seed: int, passes: List[int],
                    rows: tuple, post=None) -> List[torch.Tensor]:
    base = rng.PRNGKey(inputs.seed32(seed))
    with torch.no_grad():
        return [sample_image(scene, rng.spp_key(base, s), cfg, rows, post)
                for s in passes]


def check_render(scene_dir, render_config: dict, seed: int, r0: int,
                 bands: List[torch.Tensor], film_spp: float, passes: int,
                 k: int, device) -> Dict[str, float]:
    """The render cell's numbers: `bands` are the film's rows r0.. after
    each pass (on any device), `film_spp` the film's count."""
    rows = (r0, r0 + bands[0].shape[0])
    checked = inputs.checked_passes(seed, passes, k)
    scene = ref_scene(scene_dir, device)
    cfg = ref_config(render_config, inputs.seed32(seed))
    refs = reference_bands(scene, cfg, seed, checked, rows)
    off = total = 0
    for s, ref in zip(checked, refs):
        after = bands[s].to(device)
        before = (bands[s - 1].to(device) if s > 0
                  else torch.zeros_like(after))
        off += pixels_off(after - before, ref, after)
        total += ref.shape[0] * ref.shape[1]
    return {"px_off_pct": 100.0 * off / total,
            "spp_gap": abs(float(film_spp) - passes)}


# ---- train cells ------------------------------------------------------

def perturbed(scene, fa: np.ndarray, fl: np.ndarray):
    """The scene with albedo and light Le scaled by the factors."""
    def scale(v3, f):
        t = torch.from_numpy(f).to(v3.x.device)
        return type(v3)(*(c * t[:, i] for i, c in enumerate(v3)))
    m = scene.materials._replace(albedo=scale(scene.materials.albedo, fa))
    return scene._replace(materials=m, lights=scene.lights._replace(
        le=scale(scene.lights.le, fl)))


def refit(scene):
    """The reference's refresh after tri_p0 moved: the light table's
    emitter geometry (as the loader derives it); it walks no tree."""
    with torch.no_grad():
        lt, tr = scene.lights, scene.triangles
        ti = lt.tri.long()
        e1, e2 = tr.e1.gather(ti), tr.e2.gather(ti)
        cr = e1.cross(e2)
        area = 0.5 * torch.sqrt(cr.dot(cr))
        scene = scene._replace(lights=lt._replace(
            p0=tr.p0.gather(ti), e1=e1, e2=e2, gn=tr.gn.gather(ti),
            area=area, power=lt.le.lum() * area))
    return scene


def render_target(scene, render_config: dict, mix: dict, seed: int,
                  sample) -> torch.Tensor:
    """The training target: the scene with albedo and Le perturbed (the
    factors drawn from the seed), target_spp passes averaged."""
    fa, fl = inputs.perturbation(seed, scene.materials.count,
                                 scene.num_lights, mix["perturb"])
    tcfg = ref_config(render_config, inputs.target_seed(seed))
    tscene = perturbed(scene, fa, fl)
    base = rng.PRNGKey(tcfg.seed)
    with torch.no_grad():
        acc = None
        for s in range(mix["target_spp"]):
            img = sample(tscene, rng.spp_key(base, s), tcfg)
            acc = img if acc is None else acc + img
    return acc / float(mix["target_spp"])


def follow_training(scene_dir, render_config: dict, mix: dict, seed: int,
                    steps: int, device, lowp: bool = False,
                    fault: Optional[str] = None, log=None,
                    target: Optional[torch.Tensor] = None) -> dict:
    """The reference's own target (or `target`, one it rendered before)
    and first `steps` SGD steps -> {losses, p0, p1, pn (leaves on the
    host), target}.  `lowp` computes in
    bfloat16 (the control); `fault` plants "half" (the loss's mean over
    the first half of the rows only) or "altered" (albedo's gradient
    scaled by 1.1) in the reference put in the renderer's place.  `log`
    takes a progress line."""
    log = log or (lambda msg: None)
    scene = ref_scene(scene_dir, device, lowp)
    log("reference: scene loaded")
    post = precision.round_bf16 if lowp else None
    sample = partial(sample_image, post=post)
    if target is None:
        target = render_target(scene, render_config, mix, seed, sample)
        log("reference: target rendered")
    cfg = ref_config(render_config, inputs.seed32(seed))
    key0 = rng.PRNGKey(inputs.seed32(seed))
    lr = float(mix["lr"])
    out = {"losses": [], "p0": host_leaves(scene), "target": target}
    h2 = target.shape[0] // 2
    for k in range(steps):
        key = rng.fold_in(key0, k)
        dcfg = ref_diff._diff_cfg(cfg, scene)
        if fault == "half":
            loss, grads = ref_diff.value_and_grad(
                scene, target[:h2], key, dcfg,
                sample=lambda sc, kk, cc: sample(sc, kk, cc)[:h2])
        else:
            loss, grads = ref_diff.value_and_grad(scene, target, key, dcfg,
                                                  sample=sample)
        if fault == "altered":
            grads = dict(grads, albedo=type(grads["albedo"])(
                *(1.1 * c for c in grads["albedo"])))
        scene = refit(ref_diff._sgd(scene, grads, lr))
        out["losses"].append(float(loss))
        log(f"reference: step {k}")
        if k == 0:
            out["p1"] = host_leaves(scene)
    out["pn"] = host_leaves(scene)
    return out


def _norms(a: List[torch.Tensor], b: List[torch.Tensor],
           scale: float = 1.0) -> List[float]:
    return [float(torch.linalg.vector_norm(x - y)) * scale
            for x, y in zip(a, b)]


def leaf_table(prog: dict, ref: dict, lr: float) -> List[tuple]:
    """(leaf, gradient norm: renderer, reference; change norm: renderer,
    reference) by leaf, for the log."""
    return list(zip(LEAF_NAMES, _norms(prog["p0"], prog["p1"], 1.0 / lr),
                    _norms(ref["p0"], ref["p1"], 1.0 / lr),
                    _norms(prog["pn"], prog["p0"]),
                    _norms(ref["pn"], ref["p0"])))


def train_numbers(prog: dict, ref: dict, lr: float) -> Dict[str, float]:
    """loss_gap, grad_gap and change_gap of the renderer's first steps
    (`prog`: losses, p0, p1, pn as follow_training gives) against the
    reference's."""
    n = min(len(prog["losses"]), len(ref["losses"]))
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"][:n], ref["losses"][:n]))
    g_ref = _norms(ref["p0"], ref["p1"], 1.0 / lr)
    g_prog = _norms(prog["p0"], prog["p1"], 1.0 / lr)
    c_ref = _norms(ref["pn"], ref["p0"])
    c_prog = _norms(prog["pn"], prog["p0"])
    g_med = statistics.median(g_ref)
    c_med = statistics.median(c_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= 1e-3 * g_med]

    def worst(p, r, med):
        return max(abs(p[i] - r[i]) / max(r[i], med) for i in keep)
    return {"loss_gap": loss_gap,
            "grad_gap": worst(g_prog, g_ref, g_med),
            "change_gap": worst(c_prog, c_ref, c_med)}


def bounds_out(bvh, tris) -> int:
    """Nodes of a refitted binary tree (the renderer's BVH layout: DFS
    order, left child i + 1, `right` -1 at a leaf, a leaf's triangles
    [start, start + count)) whose box misses part of a triangle or of a
    child's box."""
    def np_(t):
        return t.detach().cpu().numpy()
    lo, hi = np_(bvh.lo), np_(bvh.hi)
    right, start, count = np_(bvh.right), np_(bvh.start), np_(bvh.count)
    p0 = np.stack([np_(c) for c in tris.p0], -1)
    p1 = p0 + np.stack([np_(c) for c in tris.e1], -1)
    p2 = p0 + np.stack([np_(c) for c in tris.e2], -1)
    tlo = np.minimum(np.minimum(p0, p1), p2)
    thi = np.maximum(np.maximum(p0, p1), p2)
    bad = np.zeros(len(right), bool)
    leaf = np.nonzero(right < 0)[0]
    for k in range(int(count[leaf].max(initial=0))):
        has = k < count[leaf]
        t = np.minimum(start[leaf] + k, len(tlo) - 1)
        miss = ((tlo[t] < lo[leaf]) | (thi[t] > hi[leaf])).any(-1)
        bad[leaf] |= has & miss
    inner = np.nonzero(right >= 0)[0]
    for c in (inner + 1, right[inner]):
        bad[inner] |= ((lo[c] < lo[inner]) | (hi[c] > hi[inner])).any(-1)
    return int(bad.sum())
