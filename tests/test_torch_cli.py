"""The port's command line (`python -m raytracingrenderer_tpu_torch.cli`)
against the JAX package's, run in this process with `-device cpu` on
the in-repo cornell box at 32x32, 2 spp, max_depth 3.

For `path` and `adaptive` (at 4 spp, so that its rounds run): the
`-checkpoint` films by the render tests'
bar (>= 99% of pixels within rtol 1e-3 / atol 1e-5, means within 0.5%),
the written .hdr files on >= 99% of pixels within one RGBE mantissa
step (an ulp can flip the 8-bit mantissa, so the render bar does not
apply to the file), and the same after a resume that adds 2 spp.
`-denoise` is held piecewise: the port's guides (albedo and normals at
the pixel centres) to JAX's by the render bar (a centre ray on an edge
between two walls may hit either), the port's denoised file to JAX's
`denoise` of the port's own image and guides within one RGBE step, and
the two packages' denoised means within 0.5% (one guide pixel that
differs spreads over the a-trous filter's 31-pixel reach, so the files
are not compared pixel by pixel).  Also `-profile`'s phase report,
`-timeBudget`, `-keys`, `-preview`, `-trace`, the resolution override,
and `-sceneShards` refused in one process."""
import logging
import os

import jax
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu import cli as jcli
from raytracingrenderer_tpu.config import RenderConfig as JConfig
from raytracingrenderer_tpu.imaging.denoise import denoise as jdenoise
from raytracingrenderer_tpu.integrators import aov as jaov
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch import cli
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.integrators import aov
from raytracingrenderer_tpu_torch.io.hdr import read_hdr
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from test_torch_app import within_rgbe_step
from test_torch_render_with import agree
from torch_scenes import write_cornell

torch.set_num_threads(2)

RES = 32


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_cornell(str(tmp_path_factory.mktemp("cornell")), RES, RES)


def _args(scene_dir, out, *extra):
    return ["-scene", scene_dir, "-outputFilename", out, "-SPP", "2",
            "-maxDepth", "3", *extra]


def run_both(scene_dir, tmp_path, *extra):
    """cli.main in both packages; -> {"port": base, "jax": base} of the
    output files (base.hdr, base.npz as the checkpoint)."""
    bases = {}
    for who, main, dev in (("port", cli.main, ["-device", "cpu"]),
                           ("jax", jcli.main, [])):
        base = str(tmp_path / who)
        rc = main(_args(scene_dir, base + ".hdr", "-checkpoint",
                        base + ".npz", *extra, *dev))
        assert rc == 0, who
        bases[who] = base
    return bases


def _film(path):
    with np.load(path) as z:
        return z["buffer"], float(z["spp"])


def hold(bases, spp):
    (pb, ps), (jb, js) = (_film(bases[w] + ".npz") for w in ("port", "jax"))
    assert ps == pytest.approx(js, rel=1e-6) and ps == pytest.approx(
        spp, rel=1e-6)
    assert pb.shape == jb.shape == (RES, RES, 3)
    assert np.isfinite(pb).all() and 0.02 < (pb / ps).mean() < 1.0
    agree(pb / ps, jb / js)
    a, b = (read_hdr(bases[w] + ".hdr") for w in ("port", "jax"))
    within_rgbe_step(a, b)


@pytest.mark.parametrize("integ,spp,resumed", [("path", "2", 4.0),
                                                ("adaptive", "4", 8.0)])
def test_cli_matches_jax_and_resumes(scene_dir, tmp_path, integ, spp,
                                     resumed):
    """adaptive at 4 spp, so that its rounds run (at 2 spp the budget is
    its 2 init passes alone); resumed: the prior's 4 + 2 init passes + 2
    spp of rounds."""
    args = ("-integrator", integ, "-SPP", spp)
    bases = run_both(scene_dir, tmp_path, *args)
    hold(bases, float(spp))
    # the same command again resumes from the checkpoint
    bases = run_both(scene_dir, tmp_path, *args)
    hold(bases, resumed)


def test_cli_denoise_and_profile(scene_dir, tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="rtr"):
        bases = run_both(scene_dir, tmp_path, "-integrator", "adaptive",
                         "-SPP", "4", "-denoise", "-profile")
    report = caplog.text.split("phase report:")
    assert len(report) == 3             # one from each package
    for name in ("render:", "denoise:", "write:", "load:"):
        assert name in report[1], name
    # the guides, each package's own
    ts, js = load_scene(scene_dir, "cpu"), jload(scene_dir, build_bvh=False)
    guides = {}
    for name in ("albedo_image", "normals_image"):
        g = getattr(aov, name)(ts, rng.PRNGKey(0), RenderConfig(jitter=False))
        agree(g.numpy(), np.asarray(getattr(jaov, name)(
            js, jax.random.PRNGKey(0), JConfig(jitter=False))))
        guides[name] = g.numpy()
    # the port's file against JAX's denoise of the port's inputs
    buf, spp = _film(bases["port"] + ".npz")
    want = np.asarray(jdenoise(buf / spp, albedo=guides["albedo_image"],
                               normal=guides["normals_image"]))
    got = read_hdr(bases["port"] + ".hdr")
    within_rgbe_step(got, want)
    other = read_hdr(bases["jax"] + ".hdr")
    assert abs(got.mean() - other.mean()) <= 0.005 * other.mean()
    # denoising moved the image
    assert np.abs(got - buf / spp).mean() > 1e-3


def test_cli_time_budget(scene_dir, tmp_path, caplog):
    """A budget already spent at the first pass: one spp, written."""
    with caplog.at_level(logging.INFO, logger="rtr"):
        bases = run_both(scene_dir, tmp_path, "-timeBudget", "1e-9")
    assert caplog.text.count("time budget reached") == 2
    hold(bases, 1.0)


def test_cli_keys(scene_dir, tmp_path):
    """-keys: the scripted session's film written as the output, its
    p / l saves beside it."""
    for who, main, dev in (("port", cli.main, ["-device", "cpu"]),
                           ("jax", jcli.main, [])):
        out = str(tmp_path / f"{who}.hdr")
        assert main(_args(scene_dir, out, "-keys", "w,left,p,l,esc",
                          *dev)) == 0
        assert os.path.exists(out) and os.path.exists(
            str(tmp_path / f"{who}.png"))
    a, b = (read_hdr(str(tmp_path / f"{w}.hdr")) for w in ("port", "jax"))
    assert np.isfinite(a).all() and a.mean() > 0.01
    within_rgbe_step(a, b)


def test_cli_preview_trace_and_resolution(scene_dir, tmp_path):
    out = str(tmp_path / "o.hdr")
    trace_dir = str(tmp_path / "trace")
    assert cli.main(_args(scene_dir, out, "-device", "cpu", "-preview", "1",
                          "-trace", trace_dir, "-width", "24", "-height",
                          "16", "-integrator", "albedo")) == 0
    img = read_hdr(out)
    assert img.shape == (16, 24, 3) and np.isfinite(img).all()
    assert os.path.getsize(out + ".png") > 0
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0


def test_cli_refuses(scene_dir, tmp_path):
    out = str(tmp_path / "o.hdr")
    # -sceneShards needs its ranks (tests/test_torch_elastic.py runs it)
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(_args(scene_dir, out, "-device", "cpu", "-sceneShards",
                       "2"))
    if not torch.cuda.is_available():
        # the card by default, with no quiet fall-back to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(_args(scene_dir, out))
    assert not os.path.exists(out)
    parser = cli.build_parser()
    jparser = jcli.build_parser()
    mine = {a.dest: (a.default, a.choices) for a in parser._actions}
    theirs = {a.dest: (a.default, a.choices) for a in jparser._actions}
    assert mine.pop("device") == ("cuda", None)
    # the same flags, defaults and choices; the default scene is RTBase's
    # MaterialsScene, named relative to the working directory
    assert mine.pop("scene")[0] == os.path.basename(theirs.pop("scene")[0])
    assert mine == theirs
