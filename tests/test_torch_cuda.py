"""Card-only checks of the port, marked `cuda`: they skip where
torch.cuda.is_available() is false.  This file imports no JAX, so it
runs on a machine with a GPU and no JAX, with the repository's JAX
conftest switched off:

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_cuda.py

The MT kernel is held against its plain torch version at the shapes the
render gives it (36, 128 and 4096 triangles; a ray count that is not a
multiple of the 256-thread block; 10% dead lanes): t within rtol/atol
1e-4, triangle ids agreeing on >= 99.9% of rays, no dead lane hit.  The
render on "cuda" is held against the render on "cpu" per pixel: >= 99%
of pixels within rtol 1e-3 / atol 1e-5, means within 0.5%."""
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.core.vec import V3
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.ops import mt_kernel
from raytracingrenderer_tpu_torch.render import render
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from torch_scenes import write_cornell

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

N_RAYS = 100_003


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc "
                    "(torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_cornell(str(tmp_path_factory.mktemp("cornell")), 32, 32)


def _v3(a, dev):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev)
                for i in range(3)))


def _tris(n_tri, scene_dir, dev):
    tris = load_scene(scene_dir, dev).triangles
    if n_tri == tris.count:
        return tris
    g = np.random.default_rng(n_tri)
    p0 = (g.uniform(-1, 1, (n_tri, 3)) + [0, 1, 0]).astype(np.float32)
    e1, e2 = ((g.standard_normal((n_tri, 3)) * 0.3).astype(np.float32)
              for _ in range(2))
    return tris._replace(p0=_v3(p0, dev), e1=_v3(e1, dev), e2=_v3(e2, dev),
                         area=torch.ones(n_tri, device=dev))


@pytest.mark.parametrize("n_tri", [36, 128, 4096])
def test_mt_kernel_matches_plain(cuda, scene_dir, n_tri):
    tris = _tris(n_tri, scene_dir, cuda)
    g = np.random.default_rng(13)
    o = (g.uniform(-1, 1, (N_RAYS, 3)) * 0.5 + [0, 1, 0.5]).astype(
        np.float32)
    d = g.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = g.random(N_RAYS) < 0.1
    t0 = np.where(dead, -1.0, 3.4e38).astype(np.float32)
    max_t = np.where(dead, -1.0, g.uniform(0.05, 2.5, N_RAYS)).astype(
        np.float32)
    ov, dv = _v3(o, cuda), _v3(d, cuda)
    tv, mv = torch.from_numpy(t0).to(cuda), torch.from_numpy(max_t).to(cuda)
    before = mt_kernel.launches
    hk = mt_kernel.intersect(tris, ov, dv, tv)
    ak = mt_kernel.any_hit(tris, ov, dv, mv)
    torch.cuda.synchronize()
    assert mt_kernel.launches == before + 2
    hp = mt_kernel.intersect_plain(tris, ov, dv, tv)
    ap = mt_kernel.intersect_plain(tris, ov, dv, mv).tri >= 0
    np.testing.assert_allclose(hk.t.cpu().numpy(), hp.t.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert (hk.tri == hp.tri).float().mean().item() >= 0.999
    assert (ak == ap).float().mean().item() >= 0.999
    assert (hk.tri.cpu().numpy()[dead] == -1).all()
    assert not ak.cpu().numpy()[dead].any()
    assert (hk.tri >= 0).float().mean().item() > 0.3


def test_render_cuda_matches_cpu(cuda, scene_dir):
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4)
    before = mt_kernel.launches
    a = film_mod.to_hdr(render(load_scene(scene_dir, cuda), cfg,
                               spp=2)).cpu().numpy()
    assert mt_kernel.launches - before == 2 * 6 * 2   # spp x bounces x 2
    b = film_mod.to_hdr(render(load_scene(scene_dir, "cpu"), cfg,
                               spp=2)).numpy()
    assert np.isfinite(a).all()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())
