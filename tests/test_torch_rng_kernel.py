"""The RNG's kernel (csrc/rng_kernel.cu, ops/rng_kernel.py) and its
dispatch in sampling/rng.py.  This file imports no JAX: its card tests
run on a machine with a GPU and no JAX, with the repository's JAX
conftest switched off:

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_rng_kernel.py

On the CPU (tier-1):
- every draw on CPU tensors takes the torch path: the kernel's launcher
  is never called and its counters do not move, and the result is
  `threefry2x32`'s (which tests/test_torch_rng.py holds to jax.random);
- CPU draws add nothing to `rng.plain_lanes_cuda`;
- the dispatch rule, the wrapper's refusal of CPU tensors, and rng.py's
  of counters past 32 bits;
- a numpy model of the kernel's arithmetic (uint32 words, the key
  schedule written out round by round as the CUDA source has it) against
  `threefry2x32` bit for bit.

On the card (marked `cuda`), the kernel against the torch path bit for
bit: `uniform_ids` on int32 and int64 ids (permuted; 0, 1, 777 and
2^20 + 3 lanes; several keys, bounces and decisions; high and negative
words), `random_bits`, `uniform` and `raw_uniform` at offset 0, odd
offsets and a band ending at 2^32, `randint` on the bounds of the CPU
tests; `rng.plain_lanes_cuda` counting every lane that the torch path
(the dispatch rule patched) draws on the card; and a whole 128x128
cornell pass and the gradients of one training step, equal with the
kernel and with the torch path forced (a patch of the dispatch rule),
every draw of the first through the kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch

from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.ops import rng_kernel
from raytracingrenderer_tpu_torch.sampling import rng
from torch_scenes import write_cornell

torch.set_num_threads(2)

CPU = torch.device("cpu")
KEYS = [(0, 0), (0, 7), (0x9E3779B9, 0x7F4A7C15), (0xFFFFFFFF, 1),
        (123456789, 0xFFFFFFFF)]
RANDINT_BOUNDS = [(0, 32), (0, 7), (0, 1000), (5, 37), (-3, 4), (0, 1),
                  (4, 4), (9, 2), (0, 2**31 - 1), (-2**31, 2**31 - 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc "
                    "(torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _ids(n, dtype, seed):
    """n ids, permuted: a frame's pixel ids, with high and negative
    words among them."""
    g = np.random.default_rng([seed, n])
    ids = g.permutation(np.arange(n, dtype=np.int64))
    if n > 8:
        ids[: n // 8] = g.integers(-2**31, 2**31, n // 8)
        if dtype == torch.int64:
            ids[n // 8: n // 4] = g.integers(-2**62, 2**62, n // 4 - n // 8)
    return torch.from_numpy(ids).to(dtype)


# The kernel's arithmetic, as csrc/rng_kernel.cu writes it out.

def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _four_rounds(x0, x1, rots):
    for r in rots:
        x0 = x0 + x1
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def _model(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    a, b = (13, 15, 26, 6), (17, 29, 16, 24)
    with np.errstate(over="ignore"):
        x0, x1 = x0 + k0, x1 + k1
        x0, x1 = _four_rounds(x0, x1, a)
        x0, x1 = x0 + k1, x1 + k2 + np.uint32(1)
        x0, x1 = _four_rounds(x0, x1, b)
        x0, x1 = x0 + k2, x1 + k0 + np.uint32(2)
        x0, x1 = _four_rounds(x0, x1, a)
        x0, x1 = x0 + k0, x1 + k1 + np.uint32(3)
        x0, x1 = _four_rounds(x0, x1, b)
        x0, x1 = x0 + k1, x1 + k2 + np.uint32(4)
        x0, x1 = _four_rounds(x0, x1, a)
        x0, x1 = x0 + k2, x1 + k0 + np.uint32(5)
    return x0, x1


@pytest.mark.parametrize("key", KEYS)
def test_kernel_model_matches_threefry(key):
    """The model of the kernel's rounds and key schedule against the
    torch ops, on counters covering both words' full range."""
    g = np.random.default_rng(key[1])
    x = g.integers(0, 2**32, (2, 4099), dtype=np.uint64).astype(np.uint32)
    x[:, :3] = [[0, 0xFFFFFFFF, 1], [0xFFFFFFFF, 0, 1]]
    m0, m1 = _model(key, x[0], x[1])
    t0, t1 = rng.threefry2x32(key, torch.from_numpy(x[0].astype(np.int64)),
                              torch.from_numpy(x[1].astype(np.int64)))
    np.testing.assert_array_equal(m0, t0.numpy().astype(np.uint32))
    np.testing.assert_array_equal(m1, t1.numpy().astype(np.uint32))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_model_uniform_ids_output(dtype):
    """The kernel's uniform_ids output, (y0 >> 8) * 2^-24 in float32, from
    the model's words on the ids' low 32 bits, equals rng.uniform_ids on
    the CPU bit for bit."""
    key, bounce, decision = rng.spp_key(rng.PRNGKey(5), 3), 2, rng.BSDF_U
    ids = _ids(777, dtype, 1)
    y0, _ = _model(key, ids.numpy().astype(np.int64).astype(np.uint32),
                   np.uint32(bounce * 16 + decision))
    want = (y0 >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    got = rng.uniform_ids(key, bounce, decision, ids).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("offset", [0, 1, 2**32 - 777])
def test_model_random_bits_output(offset):
    """The kernel's random_bits words (0, offset + i) and their unit
    floats from the model equal rng.random_bits and rng.raw_uniform on
    the CPU bit for bit."""
    key = KEYS[2]
    ctr = (np.arange(777, dtype=np.uint64) + offset).astype(np.uint32)
    y0, y1 = _model(key, np.zeros(777, np.uint32), ctr)
    w = y0 ^ y1
    f = ((w >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    np.testing.assert_array_equal(
        rng.random_bits(key, (777,), offset=offset).numpy(),
        w.astype(np.int64))
    np.testing.assert_array_equal(
        rng.raw_uniform(key, (777,), offset=offset).numpy().view(np.uint32),
        f.view(np.uint32))


# The dispatch on the CPU.

def _draws(device):
    """Every public draw of rng.py on `device` -> {name: (result,
    lanes drawn)}."""
    key = rng.spp_key(rng.PRNGKey(9), 4)
    ids = _ids(333, torch.int64, 2).to(device)
    return {
        "uniform_ids": (rng.uniform_ids(key, 1, rng.RR, ids), 333),
        "uniform_ids_int32": (rng.uniform_ids(key, 1, rng.RR,
                                              ids.to(torch.int32)), 333),
        "random_bits": (rng.random_bits(key, (7, 9), device, 5), 63),
        "uniform": (rng.uniform(key, 0, rng.PIXEL_JITTER_X, (50,), device,
                                17), 50),
        "raw_uniform": (rng.raw_uniform(key, (40,), device), 40),
        "randint": (rng.randint(key, (30,), 0, 7, device), 60),
    }


def test_cpu_draws_take_the_torch_path(monkeypatch):
    """On CPU tensors no draw reaches the kernel's launcher, its counters
    stay, and each draw is the torch ops' own."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's launcher was called on the CPU")

    monkeypatch.setattr(rng_kernel, "launch", refuse)
    before = (rng_kernel.launches, rng_kernel.lanes, rng.plain_lanes_cuda)
    got = _draws(CPU)
    assert (rng_kernel.launches, rng_kernel.lanes,
            rng.plain_lanes_cuda) == before
    key = rng.spp_key(rng.PRNGKey(9), 4)
    ids = _ids(333, torch.int64, 2)
    y0, _ = rng.threefry2x32(key, ids, 1 * 16 + rng.RR)
    want = (y0 >> 8).to(torch.float32) * 2.0 ** -24
    assert torch.equal(got["uniform_ids"][0], want)
    assert torch.equal(got["uniform_ids_int32"][0], want)
    y0, y1 = rng.threefry2x32(key, 0, torch.arange(5, 68))
    assert torch.equal(got["random_bits"][0], (y0 ^ y1).reshape(7, 9))
    assert got["uniform"][0].dtype == torch.float32
    assert got["randint"][0].dtype == torch.int32


def test_plain_lanes_cuda_counts_only_cuda_draws(monkeypatch):
    """CPU draws add nothing to `rng.plain_lanes_cuda`, with the dispatch
    rule as it is and with it patched to refuse the kernel everywhere
    (the torch path either way); the card's side is
    `test_plain_lanes_cuda_counts_card_draws`."""
    before = rng.plain_lanes_cuda
    got = _draws(CPU)
    assert rng.plain_lanes_cuda == before
    _forced_torch_path(monkeypatch)
    again = _draws(CPU)
    assert rng.plain_lanes_cuda == before
    for name in got:
        assert torch.equal(again[name][0], got[name][0]), name


@pytest.mark.parametrize("device,want", [("cuda", True), ("cuda:1", True),
                                         ("cpu", False), ("meta", False)])
def test_dispatch_rule(device, want):
    assert rng.takes_kernel(torch.device(device)) is want


def test_wrapper_refuses():
    """The launcher's wrapper takes card tensors only; rng.py refuses
    counters past 32 bits before any launch, on either device."""
    with pytest.raises(ValueError, match="no rng kernel"):
        rng_kernel.uniform_ids((0, 1), 3, torch.arange(4))
    with pytest.raises(ValueError, match="no rng kernel"):
        rng_kernel.random_bits((0, 1), 4, 0, CPU, False)
    for device in (CPU, torch.device("cuda")):
        with pytest.raises(ValueError, match="32-bit counter"):
            rng.random_bits((0, 1), (8,), device, offset=2**32 - 7)
        with pytest.raises(ValueError, match="32-bit counter"):
            rng.uniform((0, 1), 0, rng.PIXEL_JITTER_X, (8,), device,
                        offset=-1)


# On the card.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [0, 1, 777, (1 << 20) + 3])
def test_uniform_ids_kernel_matches_torch(cuda, n, dtype):
    ids = _ids(n, dtype, 3)
    dev_ids = ids.to(cuda)
    for key in KEYS[:3] + [rng.spp_key(rng.PRNGKey(2**31 - 1), 6)]:
        for bounce, decision in ((0, rng.PIXEL_JITTER_X), (1, rng.RR),
                                 (4, rng.BSDF_LOBE), (5, 15)):
            launches, lanes = rng_kernel.launches, rng_kernel.lanes
            got = rng.uniform_ids(key, bounce, decision, dev_ids)
            assert (rng_kernel.launches - launches,
                    rng_kernel.lanes - lanes) == (int(n > 0), n)
            want = rng.uniform_ids(key, bounce, decision, ids)
            assert got.dtype == torch.float32 and got.shape == ids.shape
            assert torch.equal(got.cpu(), want)
    strided = dev_ids.repeat_interleave(2)[::2]
    assert torch.equal(rng.uniform_ids(KEYS[2], 3, 7, strided).cpu(),
                       rng.uniform_ids(KEYS[2], 3, 7, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("offset,n", [(0, 0), (0, 1), (0, 777), (1, 777),
                                      (12345, (1 << 20) + 3),
                                      (2**32 - 777, 777), (2**32 - 1, 1)])
def test_random_bits_kernel_matches_torch(cuda, offset, n):
    plain = rng.plain_lanes_cuda
    for key in KEYS:
        for shape in ((n,), (1, n)):
            got = _one_launch(lambda: rng.random_bits(key, shape, cuda,
                                                      offset), n)
            want = rng.random_bits(key, shape, CPU, offset)
            assert got.dtype == torch.int64 and got.shape == want.shape
            assert torch.equal(got.cpu(), want)
        for bounce, decision in ((0, rng.PIXEL_JITTER_Y), (3, rng.BSDF_V)):
            got = _one_launch(lambda: rng.uniform(key, bounce, decision,
                                                  (n,), cuda, offset), n)
            want = rng.uniform(key, bounce, decision, (n,), CPU, offset)
            assert got.dtype == torch.float32
            assert torch.equal(got.cpu(), want)
        assert torch.equal(_one_launch(lambda: rng.raw_uniform(
            key, (n,), cuda, offset), n).cpu(),
            rng.raw_uniform(key, (n,), CPU, offset))
    assert rng.plain_lanes_cuda == plain


def _one_launch(draw, n, launches=1):
    """draw(), asserting it made `launches` kernel launches over n lanes
    each (none for n = 0)."""
    before = (rng_kernel.launches, rng_kernel.lanes)
    out = draw()
    assert (rng_kernel.launches - before[0], rng_kernel.lanes - before[1]
            ) == ((launches, launches * n) if n else (0, 0))
    return out


@pytest.mark.cuda
def test_plain_lanes_cuda_counts_card_draws(cuda, monkeypatch):
    """With the dispatch rule patched to refuse the kernel, every lane of
    every draw on the card is counted in `rng.plain_lanes_cuda` and the
    kernel's counters stay; the draws are the kernel's bits."""
    got = _draws(cuda)
    _forced_torch_path(monkeypatch)
    before = (rng_kernel.launches, rng_kernel.lanes, rng.plain_lanes_cuda)
    again = _draws(cuda)
    assert (rng_kernel.launches, rng_kernel.lanes) == before[:2]
    assert (rng.plain_lanes_cuda - before[2]
            == sum(n for _, n in got.values()))
    for name in got:
        assert torch.equal(again[name][0], got[name][0]), name


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", RANDINT_BOUNDS)
def test_randint_kernel_matches_torch(cuda, lo, hi):
    for key in KEYS:
        for shape in ((1,), (1001,), (64, 3)):
            got = _one_launch(lambda: rng.randint(key, shape, lo, hi, cuda),
                              int(np.prod(shape)), launches=2)
            assert got.dtype == torch.int32
            assert torch.equal(got.cpu(), rng.randint(key, shape, lo, hi))


def _forced_torch_path(monkeypatch):
    monkeypatch.setattr(rng, "takes_kernel", lambda device: False)


def _cornell(cuda, tmp_path):
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    return load_scene(write_cornell(str(tmp_path), 128, 128), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("wavefront", [False, True])
def test_cornell_pass_same_with_the_torch_path(cuda, tmp_path, monkeypatch,
                                              wavefront):
    """A 1-spp 128x128 cornell pass (the scan, and the wavefront forced):
    the film with every draw through the kernel (none left on the torch
    path) equals, bit for bit, the film with the torch path forced, which
    draws the same lanes."""
    from raytracingrenderer_tpu_torch.imaging.film import new_film
    from raytracingrenderer_tpu_torch.render import render
    scene = _cornell(cuda, tmp_path)
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4, seed=5,
                       wavefront=wavefront)
    runs = []
    for forced in (False, True):
        if forced:
            _forced_torch_path(monkeypatch)
        before = (rng_kernel.launches, rng_kernel.lanes, rng.plain_lanes_cuda)
        film = render(scene, cfg, spp=1, film=new_film(128, 128, cuda))
        torch.cuda.synchronize()
        runs.append((film, rng_kernel.launches - before[0],
                     rng_kernel.lanes - before[1],
                     rng.plain_lanes_cuda - before[2]))
    (a, launches, lanes, plain), (b, f_launches, f_lanes, f_plain) = runs
    assert launches > 0 and plain == 0
    assert f_launches == f_lanes == 0 and f_plain == lanes
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("wavefront", [False, True])
def test_train_step_grads_same_with_the_torch_path(cuda, tmp_path,
                                                  monkeypatch, wavefront):
    """The loss and gradients of one 128x128 cornell training step
    (diff.loss_and_grads: the forward, the checkpointed recompute and the
    backward; the scan, and the wavefront forced) with every draw through
    the kernel equal, bit for bit, those with the torch path forced."""
    from raytracingrenderer_tpu_torch import diff
    scene = _cornell(cuda, tmp_path)
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4, seed=11,
                       wavefront=wavefront)
    target = torch.full((128, 128, 3), 0.2, device=cuda)
    plain, launches = rng.plain_lanes_cuda, rng_kernel.launches
    got = diff.loss_and_grads(scene, target, rng.PRNGKey(11), cfg)
    assert rng.plain_lanes_cuda == plain and rng_kernel.launches > launches
    _forced_torch_path(monkeypatch)
    launches = rng_kernel.launches
    ref = diff.loss_and_grads(scene, target, rng.PRNGKey(11), cfg)
    assert rng_kernel.launches == launches and rng.plain_lanes_cuda > plain
    assert torch.equal(got[0], ref[0])
    for name in diff.param_keys(got[1]):
        a, b = got[1][name], ref[1][name]
        for x, y in (zip(a, b) if isinstance(a, tuple) else ((a, b),)):
            assert torch.equal(x, y), name


PATHS = (["scan", "wavefront", "treelet", "sky", "train-scan",
          "train-scan-boundary", "train-wavefront",
          "train-wavefront-boundary"]
         + [f"{integ}-{which}" for integ in ("direct", "albedo", "normals",
                                              "lighttrace", "vpl", "adaptive")
            for which in ("cornell", "spheres")])


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_every_path_draws_through_the_kernel(cuda, tmp_path, path):
    """A 32x32 pass or train step of every path (routes, sky, integrators,
    training with and without the boundary term) launches the RNG kernel
    and draws no lane on the card by the torch path."""
    from raytracingrenderer_tpu_torch import diff
    from raytracingrenderer_tpu_torch.integrators.dispatch import render_with
    from raytracingrenderer_tpu_torch.ops import treelet
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    from torch_scenes import write_sky, write_spheres
    d = str(tmp_path)
    cornell = path in ("scan", "train-scan", "train-scan-boundary") \
        or path.endswith("-cornell")
    d = (write_cornell(d, 32, 32) if cornell else
         write_sky(d, 32, 32, subdiv=2, env_h=64, env_w=128)
         if path == "sky" else write_spheres(d, 32, 32, subdiv=2))
    scene = load_scene(d, cuda)
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4,
                       boundary_grads=path.endswith("-boundary"))
    before = (rng_kernel.launches, rng.plain_lanes_cuda)
    if path.startswith("train"):
        diff.train_step(scene, torch.zeros((32, 32, 3), device=cuda),
                        rng.PRNGKey(0), cfg, lr=0.01)
    elif path in ("scan", "wavefront", "treelet", "sky"):
        if path == "treelet":
            scene = scene._replace(bvh=treelet.attach_treelets(scene.bvh))
        render(scene, cfg, spp=1)
    else:
        integ = path.split("-")[0]
        render_with(scene, dataclasses.replace(
            cfg, integrator=integ, max_depth=2 if integ == "vpl" else 4),
            3 if integ == "adaptive" else 1)
    torch.cuda.synchronize()
    assert rng_kernel.launches > before[0]
    assert rng.plain_lanes_cuda == before[1]
