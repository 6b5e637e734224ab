"""The port's scene loading against the JAX package on the in-repo cornell
box: every array of the port's `load_scene` equals the JAX
`load_scene(build_bvh=False)` exactly (both run the same numpy), the
`scene_from_numpy` conversion is exact too, and `generate_rays` agrees
within rtol 1e-6 (atol 1e-7)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.scene import camera as jcam
from raytracingrenderer_tpu.scene.loader import load_scene as jload
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.scene import camera as tcam
from raytracingrenderer_tpu_torch.scene import types as tt
from raytracingrenderer_tpu_torch.scene.convert import scene_from_numpy
from raytracingrenderer_tpu_torch.scene.loader import load_scene as tload
from torch_scenes import write_cornell, write_gem

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_cornell(str(tmp_path_factory.mktemp("cornell")))


@pytest.fixture(scope="module")
def jscene(scene_dir):
    return jload(scene_dir, build_bvh=False)


def _leaves(x, prefix=""):
    """(name, numpy array) for every tensor/array field, recursively."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [(prefix, x.cpu().numpy())]
    if hasattr(x, "_fields"):
        out = []
        for f in x._fields:
            out += _leaves(getattr(x, f), f"{prefix}.{f}")
        return out
    return [(prefix, np.asarray(x))]


def _assert_scene_equals(ts, js):
    jt = jax.tree_util.tree_map(np.asarray, js)
    for part in ("triangles", "materials", "textures", "lights", "bounds"):
        got = dict(_leaves(getattr(ts, part)))
        want = dict(_leaves(getattr(jt, part)))
        assert got.keys() == want.keys(), part
        for k in want:
            assert got[k].dtype == want[k].dtype, (part, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=part + k)
    for f in ("p", "p_inv", "cam_to_world", "world_to_cam", "a_film"):
        np.testing.assert_array_equal(getattr(ts.camera, f).numpy(),
                                      np.asarray(getattr(jt.camera, f)))
    for a, b in zip(ts.camera.origin, jt.camera.origin):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (ts.camera.width, ts.camera.height) == (jt.camera.width,
                                                   jt.camera.height)
    assert ts.background.kind == jt.background.kind
    for a, b in zip(ts.background.colour, jt.background.colour):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(ts.edge_mult.numpy(), jt.edge_mult)
    assert ts.bvh is None


@pytest.mark.parametrize("build_bvh", [True, False])
def test_load_scene_matches_jax(scene_dir, jscene, build_bvh):
    ts = tload(scene_dir, "cpu", build_bvh=build_bvh)
    _assert_scene_equals(ts, jscene)
    assert ts.triangles.count == 36 and ts.num_lights == 2
    assert ts.device == torch.device("cpu")


def test_scene_from_numpy_is_exact(jscene):
    ts = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene))
    _assert_scene_equals(ts, jscene)


def test_cornell_facts(scene_dir):
    """The facts tests/test_scene.py::TestCornell pins for the reference
    cornell-box, on the in-repo box."""
    ts = tload(scene_dir, "cpu")
    assert ts.materials.count == 8 and ts.camera.width == 1024
    assert (ts.materials.mtype.numpy() == tt.MAT_DIFFUSE).all()
    alb = ts.materials.albedo.stacked().numpy()
    assert np.isclose(alb, [0.7215686, 0.7098039, 0.6784314],
                      atol=1e-3).all(axis=1).any()
    assert np.isclose(alb, [0.63, 0.065, 0.05], atol=0.01).all(axis=1).any()
    np.testing.assert_allclose(ts.lights.le.stacked().numpy(),
                               [[17, 12, 4]] * 2)
    assert ts.lights.area.sum().item() == pytest.approx(0.1786, abs=1e-3)
    t = ts.triangles
    assert (t.gn.dot(t.n0).numpy() >= 0).all()
    o, d = tcam.generate_rays(ts.camera, torch.tensor([512.0]),
                              torch.tensor([512.0]))
    assert o.z.item() == pytest.approx(6.8) and d.z.item() < -0.99


def test_generate_rays(scene_dir, jscene):
    ts = tload(scene_dir, "cpu")
    g = np.random.default_rng(0)
    px = g.uniform(0, 1024, 4099).astype(np.float32)
    py = g.uniform(0, 1024, 4099).astype(np.float32)
    jo, jd = jcam.generate_rays(jscene.camera, jnp.asarray(px),
                                jnp.asarray(py))
    to, td = tcam.generate_rays(ts.camera, torch.from_numpy(px),
                                torch.from_numpy(py))
    for a, b in zip(list(to) + list(td), list(jo) + list(jd)):
        assert a.is_contiguous() and a.shape == (4099,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    x, y, ok = tcam.project_onto_camera(ts.camera, to + td * 3.0)
    assert ok.all()
    np.testing.assert_allclose(x.numpy(), px, atol=0.1)
    np.testing.assert_allclose(y.numpy(), py, atol=0.1)


def test_refuses_later_slices(tmp_path, scene_dir):
    """More than 64 triangles needs the BVH slice; envmaps are not
    ported.  Both raise NotImplementedError instead of degrading."""
    big = str(tmp_path / "big")
    write_cornell(big, 32, 32)
    quads = []
    for i in range(20):   # 40 more triangles: 76 in all
        z = -0.9 + 0.05 * i
        c = np.array([[-0.5, 0.5, z], [0.5, 0.5, z], [0.5, 1.5, z],
                      [-0.5, 1.5, z]])
        quads.append((c[[0, 1, 2, 0, 2, 3]], np.array([0.0, 0.0, 1.0])))
    write_gem(os.path.join(big, "panels.gem"), quads)
    with open(os.path.join(big, "scene.json")) as f:
        desc = json.load(f)
    desc["instances"].append({"filename": "panels.gem", "bsdf": "diffuse",
                              "reflectance": "white.png"})
    with open(os.path.join(big, "scene.json"), "w") as f:
        json.dump(desc, f)
    with pytest.raises(NotImplementedError, match="BVH"):
        tload(big, "cpu")
    ts = tload(big, "cpu", build_bvh=False)
    assert ts.triangles.count == 76
    _assert_scene_equals(ts, jload(big, build_bvh=False))

    desc["envmap"] = "sky.hdr"
    with open(os.path.join(big, "scene.json"), "w") as f:
        json.dump(desc, f)
    with pytest.raises(NotImplementedError, match="environment"):
        tload(big, "cpu", build_bvh=False)


def test_vec_helpers():
    a = V3.of(1.0, 2.0, 3.0)
    b = V3.of(-1.0, 0.5, 2.0)
    assert a.dot(b).item() == pytest.approx(6.0)
    c = a.cross(b)
    assert c.dot(a).item() == pytest.approx(0.0, abs=1e-6)
    n = a.normalize()
    assert n.length().item() == pytest.approx(1.0, rel=1e-6)
    w = a.where(torch.tensor(False), 0.0)
    assert w.x.item() == 0.0
