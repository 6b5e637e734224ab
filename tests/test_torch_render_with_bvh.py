"""integrators/dispatch.render_with against the JAX package's on the
5,156-triangle spheres scene (the cornell box and 16 icospheres; the BVH
walk's plain version and its any-hit pre-pass) at 32x32, 2 spp, mis +
jitter, max_depth 3 (vpl 2: 200 shadow batches a pass), each image held
to the render tests' bar: >= 99% of pixels within rtol 1e-3 / atol 1e-5
and means within 0.5%.

The VPL image sits nearest that bar: its VPL table equals JAX's within
1e-5 relative, but its geometry term cos cos / d^2 magnifies an ulp of a
receiver's or a VPL's position (XLA fuses o + d t into an FMA, torch
does not) wherever a VPL lies near the receiver on the same sphere, and
each pixel sums 200 slots.  At 1 spp it fell under the bar, so this
file renders 2 spp."""
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from test_torch_render_with import INTEGRATORS, RES, agree, render_pair
from torch_scenes import write_spheres

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def spheres(tmp_path_factory):
    d = write_spheres(str(tmp_path_factory.mktemp("spheres")), RES, RES,
                      subdiv=2)
    return load_scene(d, "cpu"), jload(d)


@pytest.mark.parametrize("integ", INTEGRATORS)
def test_render_with_matches_jax_spheres(spheres, integ):
    ts, js = spheres
    got, want = render_pair(ts, js, integ, 2)
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all() and 0.02 < got.mean() < 1.0
    agree(got, want)
