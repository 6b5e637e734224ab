"""The matrix-unit probes (ops/visit.py, probes/) against the JAX probe
kernels of scripts/probe_mxu.py, probe_mxu2.py and probe_mxu3.py, run
through `pl.pallas_call(..., interpret=True)` with the scripts' specs
(the scripts are loaded as they are; their inline kernels, closures in
probe_mxu.py, are restated here with their lines cited).

Inputs come from numpy seeds; R = 4096 as in the scripts, whose kernels
broadcast to it.  Tolerances:
  - fp32 ("highest") visits and feature sums: rtol 1e-5 / atol 1e-5.
    The port sums K left to right without FMAs; XLA's CPU dot has its
    own order and FMAs, a few ulp of values of order 10.
  - the fp32 dot (inputs x 100): per output 32 u * sum_k |a_k b_k|
    (u = 2^-24), twice the error bound of either side's 16-term sum.
  - relayout: exact.
  - TF32 ("default"): XLA on the CPU ignores DEFAULT, so JAX is no
    reference; the plain version is held to float64 within the TF32
    bound, (2^-10 + 2^-19) * sum_k |a_k b_k| per output (two operands
    rounded by at most 2^-11 each, then a 16-term fp32 sum).
The MT epilogue of probe_mxu.py cannot run in JAX (its shape fault is
asserted); the port's epilogue is held to a numpy oracle of what it
intends.

The fp32 min visit's kernel (csrc/visit_kernel.cu::visit_min_kernel)
cannot run here; a torch model of its partition (4 rays a thread, a
tile's columns split over 8 warps whose mins meet at the end, the steps
through a ring of slots with its barriers' parities) is held to
`visit_plain` with no tolerance, bit for bit: the argument for the
kernel's parity, run.  So is a model of the lane visit's kernel
(visit_lane_kernel: lane l of a warp on columns 4l .. 4l + 3 of every
tile, a running min of each of the warp's 16 rays in every lane across
the visits, one butterfly of 5 steps after the last, the tiles through
the ring).  So is one of the MT visit's (visit_mt_kernel: 2 rays a
thread, the 8 lanes of a ray on groups of 4 triangles, the tb-free terms
of the test first, the lanes' bests met in a butterfly after every
visit, the ring), at 80 shapes; with one-hot features a planted hit that
a best private to a lane would take and the plain version rejects shows
the exchange is needed.  So is one of first8's (visit_first8_kernel:
4 warps on every fourth visit each, a warp's visits' 8 columns through a
ring of slots of its own with its barriers' parities; the warps' mins met
at the end) at 64 shapes, and two faults planted in its bookkeeping make
it fail.  The TF32 dot keeps its
accumulation (two mma.sync k8 steps, as the TF32 visit's model has it).
The relayout kernel's mapping (a thread's float4s g, g + T, ...,
two at a time over a grid of one wave at most; the n % 4 tail on thread
0) is modelled too and must take every float once, at one block of 32
rows, odd block counts, and sizes past one wave; and the kernel's
loop is held to `relayout_loop_plain` on values >= 2^24 and fractions.
A model of the TF32 visit's accumulation (two k8
steps, each 8 exact products and the accumulator aligned, truncated and
rounded once) stays within TF32_KERNEL_BOUND of `visit_plain`.
`_smem_bytes` is held to `visit`'s refusal, and the probes' operation
count to the numbers written by hand."""
import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracingrenderer_tpu_torch.ops import visit
from raytracingrenderer_tpu_torch.probes import bench_visit

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 4096
HI = jax.lax.Precision.HIGHEST
U = 2.0 ** -24


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P1, P2, P3 = (_script(n) for n in ("probe_mxu", "probe_mxu2", "probe_mxu3"))


def _inputs(n_tiles, tt, blocks):
    tab = np.random.default_rng(0).normal(size=(n_tiles * 16, tt))
    feats = np.random.default_rng(1).normal(size=(blocks * 16, R))
    return tab.astype(np.float32), feats.astype(np.float32)


def _specs():
    """The scripts' block specs: the table whole in VMEM, (16, R)
    feature blocks, (8, R) output blocks."""
    fblk = pl.BlockSpec((16, R), lambda i: (i, 0), memory_space=pltpu.VMEM)
    oblk = pl.BlockSpec((8, R), lambda i: (i, 0), memory_space=pltpu.VMEM)
    return [pl.BlockSpec(memory_space=pltpu.VMEM), fblk], oblk


def _jax_p1(tab, feats, blocks, n_visits, n_tiles, epilogue=False):
    """probe_mxu.bench_matmul's pallas_call (:106-116), interpreted."""
    in_specs, oblk = _specs()
    fn = pl.pallas_call(
        functools.partial(P1.visit_kernel, n_visits=n_visits,
                          n_tiles=n_tiles, epilogue=epilogue, precision=HI),
        grid=(blocks,), in_specs=in_specs, out_specs=(oblk, oblk),
        out_shape=(jax.ShapeDtypeStruct((blocks * 8, R), jnp.float32),) * 2,
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True)
    return tuple(np.asarray(x) for x in fn(tab, feats))


def _jax_k(kernel, tab, feats, blocks, n_visits, n_tiles):
    """probe_mxu2.run's / probe_mxu3.run's pallas_call (:40-49 / :52-61),
    interpreted."""
    in_specs, oblk = _specs()
    fn = pl.pallas_call(
        functools.partial(kernel, n_visits=n_visits, n_tiles=n_tiles,
                          tt=tab.shape[1]),
        grid=(blocks,), in_specs=in_specs, out_specs=oblk,
        out_shape=jax.ShapeDtypeStruct((blocks * 8, R), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True)
    return np.asarray(fn(tab, feats))


def _port(tab, feats, **kw):
    t, o = visit.visit(torch.from_numpy(tab), torch.from_numpy(feats), **kw)
    return t.reshape(-1, R).numpy(), o.reshape(-1, R).numpy()


# (case, JAX kernel or "p1", port options, tt, blocks, n_visits, n_tiles)
VISIT_CASES = [
    ("p1a", "p1", {}, 128, 2, 16, 16),
    ("p2_full", P2.k_full, {}, 128, 1, 16, 8),
    ("p2_full_tt512", P2.k_full, {}, 512, 1, 8, 8),
    ("p2_static", P2.k_static_tile, dict(tile="static"), 128, 1, 16, 8),
    ("p2_no_reduce", P2.k_no_reduce, dict(reduce="first8"), 128, 2, 8, 8),
    ("p2_rays_major", P2.k_rays_major, dict(layout="lane"), 128, 1, 16, 8),
    ("p2_batched8", P2.k_batched8, dict(tile="batched8"), 128, 1, 16, 16),
    ("p3_full", P3.k_full, {}, 128, 2, 16, 16),
]


@pytest.mark.parametrize("case", VISIT_CASES, ids=[c[0] for c in VISIT_CASES])
def test_visit_matches_jax(case):
    _, kernel, opts, tt, blocks, n_visits, n_tiles = case
    tab, feats = _inputs(n_tiles, tt, blocks)
    before = dict(visit.launches)
    t, _ = _port(tab, feats, n_visits=n_visits, n_tiles=n_tiles, **opts)
    assert visit.launches == before          # the CPU runs the plain version
    if kernel == "p1":
        ref, _ = _jax_p1(tab, feats, blocks, n_visits, n_tiles)
    else:
        ref = _jax_k(kernel, tab, feats, blocks, n_visits, n_tiles)
    assert t.shape == ref.shape == (blocks * 8, R)
    assert (t < 3e38).all()
    np.testing.assert_allclose(t, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blocks", [1, 2])
def test_feature_sum_matches_jax(blocks):
    """visit_kernel's second output, the sum of the 16 features."""
    tab, feats = _inputs(8, 128, blocks)
    _, o = _port(tab, feats, n_visits=4, n_tiles=8)
    _, ref = _jax_p1(tab, feats, blocks, 4, 8)
    np.testing.assert_allclose(o, ref, rtol=1e-5, atol=1e-5)


def _jax_dot(a, b, prec):
    """probe_mxu.precision_check's kernel (:133-136) and call (:139-144)."""
    def k(a_ref, b_ref, o_ref, *, prec):
        o_ref[...] = jax.lax.dot_general(
            a_ref[...], b_ref[...], (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=prec)

    return np.asarray(pl.pallas_call(
        functools.partial(k, prec=prec),
        out_shape=jax.ShapeDtypeStruct((a.shape[1], R), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))


def _precision_inputs():
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(16, 128)) * 100).astype(np.float32)
    b = (rng.normal(size=(16, R)) * 100).astype(np.float32)
    return a, b


def test_dot_highest_matches_jax():
    a, b = _precision_inputs()
    got = visit.dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = _jax_dot(a, b, HI)
    scale = np.abs(a.astype(np.float64)).T @ np.abs(b.astype(np.float64))
    assert got.shape == (128, R)
    assert (np.abs(got - ref) <= 32 * U * scale).all()


@pytest.mark.parametrize("n_iter", [1, 65])
def test_relayout_matches_jax(n_iter):
    """probe_mxu.bench_relayout's kernel (:153-161) and call (:165-172),
    on 4 blocks of random values: exact."""
    def k(x_ref, o_ref, *, n_iter):
        x = x_ref[...]

        def body(i, acc):
            wide = acc.reshape(1, 32 * 128)
            wide = wide + 1.0
            return wide.reshape(32, 128)

        o_ref[...] = jax.lax.fori_loop(0, n_iter, body, x)

    blocks = 4
    x = np.random.default_rng(3).normal(size=(blocks * 32, 128)).astype(
        np.float32)
    blk = pl.BlockSpec((32, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)
    ref = np.asarray(pl.pallas_call(
        functools.partial(k, n_iter=n_iter), grid=(blocks,),
        in_specs=[blk], out_specs=blk,
        out_shape=jax.ShapeDtypeStruct((blocks * 32, 128), jnp.float32),
        interpret=True)(x))
    got = visit.relayout_loop(torch.from_numpy(x), n_iter).numpy()
    np.testing.assert_array_equal(got, ref)
    zeros = torch.zeros((blocks * 32, 128))
    assert torch.equal(visit.relayout_loop(zeros, n_iter), zeros + n_iter)


TF32_BOUND = 2.0 ** -10 + 2.0 ** -19


@pytest.mark.parametrize("what", ["dot", "visit"])
def test_tf32_plain_within_bound_of_float64(what):
    """precision="default" against float64: within the TF32 bound, and
    coarser than "highest" (the operands were rounded)."""
    if what == "dot":
        a, b = _precision_inputs()
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        lo, hi = (visit.dot_plain(ta, tb, p).numpy()
                  for p in ("default", "highest"))
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        exact = a64.T @ b64
        scale = np.abs(a64).T @ np.abs(b64)
    else:
        n_tiles, n_visits = 8, 8
        tab, feats = _inputs(n_tiles, 128, 1)
        kw = dict(n_visits=n_visits, n_tiles=n_tiles)
        lo = _port(tab, feats, precision="default", **kw)[0][0]
        hi = _port(tab, feats, **kw)[0][0]
        t64, f64 = tab.astype(np.float64), feats.astype(np.float64)
        prods = [t64[(i * 7 % n_tiles) * 16:][:16].T @ f64
                 for i in range(n_visits)]
        exact = np.min([p.min(axis=0) for p in prods], axis=0)
        scale = np.max([(np.abs(t64[(i * 7 % n_tiles) * 16:][:16]).T
                         @ np.abs(f64)).max(axis=0)
                        for i in range(n_visits)], axis=0)
    err_lo, err_hi = np.abs(lo - exact), np.abs(hi - exact)
    assert (err_lo <= TF32_BOUND * scale).all()
    assert err_lo.max() > 10 * err_hi.max()


def test_tf32_round_is_nearest_ties_away():
    half_ulp = 2.0 ** -11          # half of TF32's ulp at 1
    x = torch.tensor([1.0 + half_ulp, -(1.0 + half_ulp),
                      1.0 + half_ulp - 2.0 ** -23, 1.5, -0.0,
                      float("inf")], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 * half_ulp, -(1.0 + 2 * half_ulp), 1.0,
                         1.5, -0.0, float("inf")])
    got = visit.tf32_round(x)
    assert torch.equal(got, want)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=1000)
                         .astype(np.float32))
    r = visit.tf32_round(g)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert ((r - g).abs() <= 2.0 ** -11 * g.abs()).all()


def test_jax_epilogue_raises_at_trace():
    """probe_mxu.py:76-78 compares `st` (TT/4, R) with `t_b * ad`, t_b
    the (8, R) accumulator: the shapes do not broadcast."""
    tab, feats = _inputs(8, 128, 1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        _jax_p1(tab, feats, 1, 4, 8, epilogue=True)


def _mt_oracle(tab, feats, n_visits, n_tiles):
    """numpy float32 statement of the epilogue's intent: per ray a best
    t; each visit tests the tile's 32 triangles ([det|tdet|udet|vdet]
    quarters of its 128 columns, each a left-to-right sum of 16
    products) against the best as it stood before the visit, and keeps
    the least hit t."""
    blocks = feats.shape[0] // 16
    out = np.empty((blocks, R), np.float32)
    for b in range(blocks):
        f = feats[b * 16:(b + 1) * 16]
        best = np.full(R, np.float32(3e38), np.float32)
        for i in range(n_visits):
            tile = tab[((i * 7) % n_tiles) * 16:][:16]
            cols = tile[0][:, None] * f[0][None, :]
            for k in range(1, 16):
                cols = cols + tile[k][:, None] * f[k][None, :]
            det, tdet, udet, vdet = cols[0:32], cols[32:64], cols[64:96], \
                cols[96:128]
            sgn = np.where(det < 0, np.float32(-1), np.float32(1))
            ad, st, su, sv = det * sgn, tdet * sgn, udet * sgn, vdet * sgn
            with np.errstate(over="ignore", divide="ignore",
                             invalid="ignore"):
                hit = ((ad >= np.float32(1e-12)) & (su >= 0) & (sv >= 0)
                       & (su + sv <= ad) & (st > 0) & (st < best * ad))
                cand = np.where(hit, st / np.where(hit, ad, np.float32(1)),
                                np.float32(3e38))
            best = np.minimum(best, cand.min(axis=0))
        out[b] = best
    return out


def test_mt_epilogue_matches_oracle():
    n_tiles, n_visits, blocks = 8, 8, 2
    tab, feats = _inputs(n_tiles, 128, blocks)
    t, _ = _port(tab, feats, n_visits=n_visits, n_tiles=n_tiles,
                 reduce="mt")
    want = _mt_oracle(tab, feats, n_visits, n_tiles)
    np.testing.assert_array_equal(t.reshape(blocks, 8, R)[:, 3], want)
    assert (want < 3e38).mean() > 0.5


def test_visit_refuses_what_no_kernel_runs():
    tab, feats = (torch.from_numpy(a) for a in _inputs(8, 128, 1))
    with pytest.raises(ValueError, match="no visit kernel"):
        visit.visit(tab, feats, n_visits=4, n_tiles=8, reduce="first8",
                    precision="default")
    with pytest.raises(ValueError, match="lane"):
        visit.visit(torch.zeros(8 * 16, 256), feats, n_visits=4, n_tiles=8,
                    layout="lane")
    with pytest.raises(ValueError, match="multiple"):
        visit.visit(tab, feats[:, :100].contiguous(), n_visits=4, n_tiles=8)
    with pytest.raises(TypeError):
        visit.dot(tab[:16].double(), feats[:16])


class _Barrier:
    """An mbarrier as the kernel uses it: a phase that flips when it
    completes; a wait with `parity` passes once the phase differs."""

    def __init__(self):
        self.phase = 0

    def complete(self):
        self.phase ^= 1

    def passes(self, parity):
        return self.phase != parity


def _min_model(tab, feats, n_visits, n_tiles, tile):
    """visit_min_kernel's partition in torch -> t (blocks, R): the ring
    (visit i in slot i % stages with parity (i // stages) & 1, a slot
    refilled with the tile of visit i + stages once its empty barrier
    completed; a batched step as 8 visits of its 8 tiles), warp w on
    columns [w TT/8, (w+1) TT/8) in groups of 4, thread (lane) on rays
    4 lane .. 4 lane + 3 of a block of 128, the warps' mins folded after
    the last visit."""
    blocks, r = feats.shape[0] // 16, feats.shape[1]
    tt = tab.shape[1]
    stages = visit.ring_stages(tt, tile)
    visits = [t for step in visit.tile_steps(n_visits, n_tiles, tile)
              for t in step]
    loads = min(len(visits), 1) if tile == "static" else len(visits)
    cols = tt // visit.MIN_WARPS
    assert cols % 4 == 0 and 1 <= stages <= visit.MAX_STAGES
    # (blocks, 16, R / 128, lane, ray of the lane), flattened back at the end
    f = feats.view(blocks, 16, r // visit.SPAN, 32, visit.MIN_RAYS)
    f = f.reshape(blocks, 16, r)
    ring, held = [None] * stages, [None] * stages
    full = [_Barrier() for _ in range(stages)]
    empty = [_Barrier() for _ in range(stages)]

    def load(j):
        ring[j % stages] = tab[visits[j] * 16:(visits[j] + 1) * 16]
        held[j % stages] = j
        full[j % stages].complete()

    for j in range(min(stages, loads)):
        load(j)
    m = torch.full((blocks, visit.MIN_WARPS, r), visit.BIG)
    for i in range(len(visits)):
        s = 0 if tile == "static" else i % stages
        parity = (i // stages) & 1
        if tile != "static" or i == 0:
            assert full[s].passes(parity)
        assert held[s] == (0 if tile == "static" else i)
        for c in range(0, cols, 4):
            idx = [w * cols + c + e for w in range(visit.MIN_WARPS)
                   for e in range(4)]
            sums = visit._contract(ring[s][:, idx], f).view(
                blocks, visit.MIN_WARPS, 4, r)
            m = torch.minimum(m, torch.minimum(
                torch.minimum(sums[:, :, 0], sums[:, :, 1]),
                torch.minimum(sums[:, :, 2], sums[:, :, 3])))
        if tile != "static":
            empty[s].complete()
            if i + stages < loads:
                assert empty[s].passes(parity)
                load(i + stages)
    t = m[:, 0]
    for w in range(1, visit.MIN_WARPS):
        t = torch.minimum(t, m[:, w])
    return t


MODEL_CASES = [(tile, tt, n_visits, n_tiles, r)
               for tile in ("dynamic", "static", "batched8")
               for tt in (32, 96, 128, 512)
               for n_visits in (0, 1, 2, 7, 64)
               for n_tiles in (1, 64)
               for r in (128, 4096)
               if tile != "batched8" or n_tiles >= 8]


@pytest.mark.parametrize("tile,tt,n_visits,n_tiles,r", MODEL_CASES)
def test_min_partition_model_equals_plain(tile, tt, n_visits, n_tiles, r):
    g = np.random.default_rng(tt + n_visits)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt)).astype(
        np.float32))
    feats = torch.from_numpy(g.normal(size=(2 * 16, r)).astype(np.float32))
    want, _ = visit.visit_plain(tab, feats, n_visits=n_visits,
                                n_tiles=n_tiles, tile=tile)
    got = _min_model(tab, feats, n_visits, n_tiles, tile)
    assert torch.equal(got, want[:, 0])
    if n_visits >= (8 if tile == "batched8" else 1):
        assert (got < 3e38).all()
    else:
        assert (got == visit.BIG).all()


def test_min_model_ring_refuses_a_wrong_parity():
    """The model's barriers are not decoration: a consumer that waits
    with the slot's previous parity is caught."""
    b = _Barrier()
    assert not b.passes(0) and b.passes(1)
    b.complete()
    assert b.passes(0) and not b.passes(1)


def _ring(tab, visits, stages):
    """The ring of `stages` slots as both kernels run it -> (wait(i): the
    tile of visit i, after its slot's full barrier passes with parity
    (i // stages) & 1; leave(i): the slot of visit i given back, refilled
    with the tile of visit i + stages once its empty barrier passed)."""
    ring, held = [None] * stages, [None] * stages
    full = [_Barrier() for _ in range(stages)]
    empty = [_Barrier() for _ in range(stages)]

    def load(j):
        ring[j % stages] = tab[visits[j] * 16:(visits[j] + 1) * 16]
        held[j % stages] = j
        full[j % stages].complete()

    for j in range(min(stages, len(visits))):
        load(j)

    def wait(i):
        s, parity = i % stages, (i // stages) & 1
        assert full[s].passes(parity) and held[s] == i
        return ring[s]

    def leave(i):
        s, parity = i % stages, (i // stages) & 1
        empty[s].complete()
        if i + stages < len(visits):
            assert empty[s].passes(parity)
            load(i + stages)

    return wait, leave


def _lane_model(tab, feats, n_visits, n_tiles):
    """visit_lane_kernel's partition in torch -> t (blocks, R): per block
    of LANE_SPAN rays, warp w on rays LANE_RAYS w .. LANE_RAYS (w + 1) - 1;
    lane l takes columns 4l .. 4l + 3 of each tile (a float4 of each row)
    and keeps, for each ray of its warp, the running min of its own
    columns over the visits; a warp leaves a slot once its columns are
    read; after the last visit a butterfly (min with the lane l ^ 16, ^ 8,
    ^ 4, ^ 2, ^ 1) and lane j writes ray j of its warp."""
    blocks, r = feats.shape[0] // 16, feats.shape[1]
    tt = tab.shape[1]
    stages = visit.ring_stages(tt, "dynamic", "lane")
    visits = [t for step in visit.tile_steps(n_visits, n_tiles, "dynamic")
              for t in step]
    wait, leave = _ring(tab, visits, stages)
    f = feats.view(blocks, 16, r)
    acc = torch.full((blocks, 32, r), visit.BIG)     # (block, lane, ray)
    for i in range(len(visits)):
        cols = wait(i).clone()          # every lane's columns, in registers
        leave(i)
        sums = visit._contract(cols, f).view(blocks, 32, 4, r)
        acc = torch.minimum(acc, torch.minimum(
            torch.minimum(sums[:, :, 0], sums[:, :, 1]),
            torch.minimum(sums[:, :, 2], sums[:, :, 3])))
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = torch.minimum(acc, acc[:, lane ^ off])
    assert r % visit.LANE_SPAN == 0 and visit.LANE_RAYS <= 32
    ray = torch.arange(r)
    return acc[:, ray % visit.LANE_RAYS, ray]


LANE_CASES = [(n_visits, n_tiles, r, blocks)
              for n_visits in (0, 1, 2, 7, 64) for n_tiles in (1, 64)
              for r in (128, 4096) for blocks in (1, 8)]


@pytest.mark.parametrize("n_visits,n_tiles,r,blocks", LANE_CASES)
def test_lane_partition_model_equals_plain(n_visits, n_tiles, r, blocks):
    g = np.random.default_rng(n_visits + n_tiles)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, visit.LANE_TT))
                           .astype(np.float32))
    feats = torch.from_numpy(g.normal(size=(blocks * 16, r)).astype(
        np.float32))
    kw = dict(n_visits=n_visits, n_tiles=n_tiles, layout="lane")
    want, _ = visit.visit_plain(tab, feats, **kw)
    got = _lane_model(tab, feats, n_visits, n_tiles)
    assert torch.equal(got, want[:, 0])
    assert (got < 3e38).all() if n_visits else (got == visit.BIG).all()


def test_lane_model_ring_holds_each_visit_in_its_slot():
    """Three slots over seven visits: visit i waits in slot i % 3 with
    parity (i // 3) & 1; a wait on a slot that was not yet refilled is
    caught."""
    tab = torch.arange(8 * 16, dtype=torch.float32)[:, None].expand(
        -1, 128).contiguous()
    visits = visit.tile_steps(7, 8, "dynamic")
    wait, leave = _ring(tab, [s[0] for s in visits], 3)
    for i in range(7):
        assert int(wait(i)[0, 0]) == 16 * visits[i][0]
        leave(i)
    wait, leave = _ring(tab, [s[0] for s in visits], 3)
    for i in range(3):
        wait(i)
    with pytest.raises(AssertionError):
        wait(3)


def _mt_model(tab, feats, n_visits, n_tiles, exchange=True):
    """visit_mt_kernel's partition in torch -> t (blocks, R): a warp on
    MT_WARP_RAYS rays (lane l on rays MT_RAYS (l % 4) .. + MT_RAYS - 1 of
    its warp's, which the float2 of the last write keeps in order); the
    MT_LANES lanes of a ray (l // 4) on the groups of 4 triangles l // 4,
    l // 4 + MT_LANES, ...; each group's sums quarter by quarter, the
    terms of the test that need no best t first (st where > 0, ad where
    the others hold, NaN elsewhere), then `st < tb * ad` against the best
    before the visit; the tiles through the ring, a slot left after the
    visit's groups; after each visit a butterfly (lane ^ 4, ^ 8, ^ 16)
    gives a ray's lanes the min of their bests.  `exchange=False` keeps a
    best private to each lane instead, folded after the last visit: what
    the kernel must not do."""
    blocks, r = feats.shape[0] // 16, feats.shape[1]
    tt = tab.shape[1]
    q, lanes = tt // 4, visit.MT_LANES
    stages = visit.ring_stages(tt, "dynamic", reduce="mt")
    assert r % visit.MT_SPAN == 0 and 32 // lanes * visit.MT_RAYS \
        == visit.MT_WARP_RAYS
    visits = [s[0] for s in visit.tile_steps(n_visits, n_tiles, "dynamic")]
    wait, leave = _ring(tab, visits, stages)
    f = feats.view(blocks, 16, r)
    lane_of = torch.arange(q) // 4 % lanes       # a triangle's lane of a ray
    other = torch.arange(lanes)
    nan = torch.tensor(float("nan"))
    best = torch.full((blocks, lanes, r), visit.BIG)
    for i in range(len(visits)):
        tile = wait(i)
        det, tdet, udet, vdet = (visit._contract(tile[:, h * q:(h + 1) * q],
                                                 f) for h in range(4))
        leave(i)
        sgn = torch.where(det < 0.0, -1.0, 1.0)
        ad, su, sv, st = det * sgn, udet * sgn, vdet * sgn, tdet * sgn
        ok = ((ad >= visit.DET_EPS) & (su >= 0.0) & (sv >= 0.0)
              & (su + sv <= ad))
        ad, st = torch.where(ok, ad, nan), torch.where(st > 0.0, st, nan)
        m = best.clone()
        for lane in range(lanes):
            mine = lane_of == lane
            if mine.any():
                tb = best[:, lane, None]
                hit = st[:, mine] < tb * ad[:, mine]
                cand = torch.where(hit, st[:, mine] / torch.where(
                    hit, ad[:, mine], 1.0), visit.BIG)
                m[:, lane] = torch.minimum(best[:, lane], cand.amin(1))
        if exchange:
            for off in (1, 2, 4):                # lane ^ 4, ^ 8, ^ 16
                m = torch.minimum(m, m[:, other ^ off])
            assert (m == m[:, :1]).all()
        best = m
    return best[:, 0] if exchange else best.amin(1)


MT_CASES = [(tt, n_visits, n_tiles, r)
            for tt in (32, 96, 128, 512)
            for n_visits in (0, 1, 2, 7, 64)
            for n_tiles in (1, 64)
            for r in (128, 4096)]


@pytest.mark.parametrize("tt,n_visits,n_tiles,r", MT_CASES)
def test_mt_partition_model_equals_plain(tt, n_visits, n_tiles, r):
    """The MT visit's partition, bit for bit, where it could break: a
    lane with no group (TT 32, 96), one (128) or four (512); a ring never,
    partly or often refilled; one tile visited every time."""
    g = np.random.default_rng(tt + n_visits + n_tiles)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt)).astype(
        np.float32))
    feats = torch.from_numpy(g.normal(size=(2 * 16, r)).astype(np.float32))
    want, _ = visit.visit_plain(tab, feats, n_visits=n_visits,
                                n_tiles=n_tiles, reduce="mt")
    got = _mt_model(tab, feats, n_visits, n_tiles)
    assert torch.equal(got, want[:, 0])
    assert (got < visit.BIG).any() if n_visits else (got == visit.BIG).all()


def _planted_hit():
    """(tb, ad, st) in float32 with st == fl(tb * ad), so that `st < tb *
    ad` rejects it, and fl(st / ad) < tb: the hit a warp-private best
    would take.  The first of a numpy search."""
    g = np.random.default_rng(5)
    while True:
        tb, ad = g.uniform(0.5, 4.0, size=2).astype(np.float32)
        st = np.float32(tb * ad)
        if np.float32(st / ad) < tb:
            return tb, ad, st


@pytest.mark.parametrize("tt,tri", [(128, 4), (512, 36)])
def test_mt_exchange_planted_case(tt, tri):
    """One-hot features make the contraction return row 0 of the tile.
    Visit 0 (tile 0) gives every ray a hit at tb on triangle 0, its first
    lane's; visit 1 (tile 1) offers triangle `tri`, another lane's (in
    the second round of groups at TT 512), with st == fl(tb * ad) and
    fl(st / ad) one ulp below tb.  The plain version rejects it; the model
    with the exchange does too, and a best private to each lane (BIG in
    that lane after visit 0) takes it."""
    tb, ad, st = _planted_hit()
    q = tt // 4
    tab = np.zeros((2 * 16, tt), np.float32)
    tab[0, [0, q]] = 1.0, tb                   # det, tdet of triangle 0
    tab[16, [tri, q + tri]] = ad, st           # of triangle tri, in tile 1
    feats = np.zeros((16, 4096), np.float32)
    feats[0] = 1.0
    tab, feats = torch.from_numpy(tab), torch.from_numpy(feats)
    assert tri // 4 % visit.MT_LANES != 0
    want, _ = visit.visit_plain(tab, feats, n_visits=2, n_tiles=2,
                                reduce="mt")
    assert (want[:, 0] == torch.tensor(tb)).all()
    got = _mt_model(tab, feats, 2, 2)
    assert torch.equal(got, want[:, 0])
    private = _mt_model(tab, feats, 2, 2, exchange=False)
    assert (private == torch.tensor(np.float32(st / ad))).all()
    assert (private < want[:, 0]).all()


def _first8_model(tab, feats, n_visits, n_tiles, fault=None):
    """visit_first8_kernel's partition in torch -> (t (blocks, 8, R), the
    slots refilled): warp w takes visits w, w + F8_WARPS, ... and brings
    their columns (only the first 8 of a tile: 16 rows x 32 bytes) through
    a ring of F8_SLOTS slots of its own, each on a barrier that one load
    completes: visit j in slot j % F8_SLOTS with parity (j // F8_SLOTS) &
    1, the slot refilled by the warp with visit j + F8_SLOTS once read.
    Each warp keeps its own running mins; they meet after the last visit.
    `fault` plants a mistake in the bookkeeping: "no_refill" leaves a read
    slot as it is, "parity_kept" waits with parity 0 after every wrap."""
    blocks, r = feats.shape[0] // 16, feats.shape[1]
    assert r % visit.F8_SPAN == 0
    f = feats.view(blocks, 16, r)
    tiles = [s[0] for s in visit.tile_steps(n_visits, n_tiles, "dynamic")]
    n_slots = visit.F8_SLOTS
    t = torch.full((blocks, visit.ROWS, r), visit.BIG)
    refills = 0
    for w in range(visit.F8_WARPS):
        mine = tiles[w::visit.F8_WARPS]
        slot, held = [None] * n_slots, [None] * n_slots
        full = [_Barrier() for _ in range(n_slots)]

        def load(j, s):
            slot[s] = tab[mine[j] * 16:(mine[j] + 1) * 16, :visit.ROWS]
            held[s] = j
            full[s].complete()

        for j in range(min(n_slots, len(mine))):
            load(j, j)
        m = torch.full((blocks, visit.ROWS, r), visit.BIG)
        s, parity = 0, 0
        for j in range(len(mine)):
            assert full[s].passes(parity)
            assert held[s] == j
            m = torch.minimum(m, visit._contract(slot[s], f))
            if j + n_slots < len(mine) and fault != "no_refill":
                load(j + n_slots, s)
                refills += 1
            s += 1
            if s == n_slots:
                s = 0
                if fault != "parity_kept":
                    parity ^= 1
        t = torch.minimum(t, m)
    return t, refills


_RAYS_BLOCKS = ((128, 1), (4096, 8), (4096, 1), (128, 8))
FIRST8_CASES = [(tt, n_visits, n_tiles) + _RAYS_BLOCKS[i % 4]
                for i, (tt, n_visits, n_tiles) in enumerate(
                    (tt, n_visits, n_tiles) for tt in (32, 96, 128, 512)
                    for n_visits in (0, 1, 2, 7, 64)
                    for n_tiles in (1, 7, 64))] + [
    (tt, 160, 128, r, blocks) for tt in (32, 128)
    for r, blocks in ((128, 8), (4096, 1))]


@pytest.mark.parametrize("tt,n_visits,n_tiles,r,blocks", FIRST8_CASES)
def test_first8_partition_model_equals_plain(tt, n_visits, n_tiles, r,
                                             blocks):
    """first8's partition, bit for bit (its 8 rows), where it
    could break: a warp with no visit (0 to 2 visits) or some; one
    tile, 7 (every visit on tile 0) or 64 distinct tiles; up to 16 visits
    a warp, each in a slot of its own; and, at 160 visits of 128 tiles,
    more visits than a warp's slots (the ring refilled)."""
    g = np.random.default_rng(tt + n_visits + n_tiles)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt)).astype(
        np.float32))
    feats = torch.from_numpy(g.normal(size=(blocks * 16, r)).astype(
        np.float32))
    kw = dict(n_visits=n_visits, n_tiles=n_tiles, reduce="first8")
    want, _ = visit.visit_plain(tab, feats, **kw)
    got, refills = _first8_model(tab, feats, n_visits, n_tiles)
    assert torch.equal(got, want)
    assert (refills > 0) == (n_visits > visit.F8_WARPS * visit.F8_SLOTS)
    assert (got < visit.BIG).all() if n_visits else \
        (got == visit.BIG).all()


# csrc/visit_kernel.cu's kRelayoutThreads, kRelayoutVecs,
# kRelayoutBlocksPerSm and kSms
RL_THREADS, RL_VECS, RL_WAVE = 256, 2, 4 * 132


def _relayout_model(x, n_iter, step=RL_VECS):
    """relayout_kernel over the flat floats of x: thread g of the grid's
    T threads loads the float4s g, g + T, ... RL_VECS at a time (the loop
    advancing `step` strides), adds 1.0 n_iter times to each float, and
    stores them; thread 0 also takes the n % 4 floats past the last
    float4.  Asserts that no float is written twice; unwritten floats
    stay NaN."""
    flat = x.reshape(-1)
    n = flat.numel()
    n4 = n // 4
    blocks = min(max(-(-n4 // (RL_THREADS * RL_VECS)), 1), RL_WAVE)
    t = blocks * RL_THREADS
    idx = []
    for g in range(t):
        for i0 in range(g, n4, step * t):
            idx += [i0 + j * t for j in range(RL_VECS) if i0 + j * t < n4]
    idx = torch.tensor(idx, dtype=torch.int64)
    assert idx.unique().numel() == idx.numel(), "a float4 written twice"
    out = torch.full((n,), float("nan"))
    cols = (idx[:, None] * 4 + torch.arange(4)).reshape(-1)
    v = flat[cols]
    tail = torch.arange(n4 * 4, n)
    w = flat[tail]
    for _ in range(n_iter):
        v = v + 1.0
        w = w + 1.0
    out[cols] = v
    out[tail] = w
    return out.reshape(x.shape), blocks


def _relayout_input(rows, seed):
    return bench_visit.relayout_input((rows, 128), "cpu", seed)


@pytest.mark.parametrize("blocks", [1, 3, 64, 65, 1057, 2113 + 17])
@pytest.mark.parametrize("n_iter", [1, 65])
def test_relayout_partition_model_equals_plain(blocks, n_iter):
    """The kernel's mapping takes each float once, bit for bit with the
    plain loop: one block of 32 rows (2 of the kernel's blocks, the second
    half idle), odd counts, the probe's 64, and past one wave (528 blocks
    of 512 float4s, so the grid stride loops)."""
    x = _relayout_input(blocks * 32, blocks + n_iter)
    got, grid = _relayout_model(x, n_iter)
    want = visit.relayout_loop_plain(x, n_iter)
    assert torch.equal(got, want)
    assert grid == min(-(-blocks * 1024 // 512), RL_WAVE)
    if blocks >= 1057:
        assert grid == RL_WAVE


def test_relayout_model_fails_a_short_stride():
    """A loop that advanced one stride a step, not RL_VECS, would load
    float4s twice past one wave: the model refuses it, where it passes as
    the kernel keeps it."""
    x = _relayout_input(1057 * 32, 1)
    _relayout_model(x, 1)
    with pytest.raises(AssertionError):
        _relayout_model(x, 1, step=1)


def test_relayout_tail_and_rounding():
    """The n % 4 floats past the last float4 (a size the wrapper never
    passes, which the C interface takes) and the loop's rounding: 2^24
    stays 2^24 under +1.0 (round to even) however often, where one
    addition of n_iter moves it; a fraction gains n_iter roundings."""
    x = torch.tensor([2.0 ** 24, 0.1, -3.5, 2.0 ** 25 + 2.0, 7.0, 1e-8])
    got, _ = _relayout_model(x, 65)
    want = x.clone()
    for _ in range(65):
        want = want + 1.0
    assert torch.equal(got, want)
    assert got[0] == 2.0 ** 24 and (x + 65.0)[0] != 2.0 ** 24
    p = visit.relayout_loop_plain(_relayout_input(32, 2), 65)
    assert not torch.equal(p, _relayout_input(32, 2) + 65.0)


@pytest.mark.parametrize("fault", ["no_refill", "parity_kept"])
def test_first8_model_refuses_a_wrong_parity(fault):
    """The model's bookkeeping is not decoration: in the ring case (160
    visits of 128 tiles, 40 a warp) a read slot left unrefilled, or a wait
    with the parity not flipped after a wrap, fails its assertion, where
    the model as the kernel keeps it equals the plain version."""
    g = np.random.default_rng(160)
    tab = torch.from_numpy(g.normal(size=(128 * 16, 32)).astype(np.float32))
    feats = torch.from_numpy(g.normal(size=(16, 128)).astype(np.float32))
    want, _ = visit.visit_plain(tab, feats, n_visits=160, n_tiles=128,
                                reduce="first8")
    got, refills = _first8_model(tab, feats, 160, 128)
    assert torch.equal(got, want) and refills == 4 * (40 - visit.F8_SLOTS)
    with pytest.raises(AssertionError):
        _first8_model(tab, feats, 160, 128, fault=fault)


def _tf32_step(terms):
    """One k8 step of the tensor cores as TF32_KERNEL_BOUND models it:
    terms (exact products and the accumulator, float64, stacked on dim 0)
    aligned to the largest with the bits below fp32's 24 truncated, summed
    exactly and rounded once to fp32."""
    big = terms.abs().amax(0)
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), e - 24)
    return (torch.trunc(terms / ulp) * ulp).sum(0).float()


def _tf32_model(tab, feats, n_visits, n_tiles):
    """visit_tf32_kernel's arithmetic in torch -> t (blocks, R): both
    operands rounded to TF32, their products exact, K = 16 as two k8
    steps (the first without an accumulator, wgmma's scale-d = 0; the
    second on the first's fp32 result), then the running min."""
    blocks, r = feats.shape[0] // 16, feats.shape[1]
    a = visit.tf32_round(tab).double()
    f = visit.tf32_round(feats).double().view(blocks, 16, r)
    t = torch.full((blocks, r), visit.BIG)
    for (j,) in visit.tile_steps(n_visits, n_tiles, "dynamic"):
        prods = a[j * 16:(j + 1) * 16][None, :, :, None] * f[:, :, None, :]
        d = _tf32_step(prods[:, :8].transpose(0, 1))
        d = _tf32_step(torch.cat([d.double()[None],
                                  prods[:, 8:].transpose(0, 1)]))
        t = torch.minimum(t, d.amin(1))
    return t


@pytest.mark.parametrize("tt,n_visits,n_tiles,r",
                         [(32, 1, 1, 128), (128, 7, 64, 128),
                          (96, 2, 64, 256), (128, 16, 16, 128)])
def test_tf32_model_within_kernel_bound(tt, n_visits, n_tiles, r):
    """The TF32 visit's accumulation order, modelled, stays within
    TF32_KERNEL_BOUND of `visit_plain` (a left-to-right fp32 sum of the
    same products), in units of the largest sum |a f| a ray's min took;
    the two orders do differ."""
    g = np.random.default_rng(tt + n_visits)
    tab = torch.from_numpy(g.normal(size=(n_tiles * 16, tt)).astype(
        np.float32))
    feats = torch.from_numpy(g.normal(size=(2 * 16, r)).astype(np.float32))
    kw = dict(n_visits=n_visits, n_tiles=n_tiles, precision="default")
    want, _ = visit.visit_plain(tab, feats, **kw)
    got = _tf32_model(tab, feats, n_visits, n_tiles)
    scale = visit.visit_tf32_scale(tab, feats, n_visits=n_visits,
                                   n_tiles=n_tiles)[:, 0]
    ratio = (got - want[:, 0]).abs() / scale
    assert ratio.max() <= visit.TF32_KERNEL_BOUND
    assert ratio.max() > 0


@pytest.mark.parametrize("variant", visit.VARIANTS,
                         ids=[visit.variant_name(*v) for v in visit.VARIANTS])
def test_smem_bytes_follow_the_refusal(variant, monkeypatch):
    """`visit` on a CUDA tensor raises on shared memory exactly where
    `_smem_bytes` passes SMEM_MAX; below it, it goes on to the launch
    (here stopped at the library, which a CPU machine cannot build).
    A ring's slots fill RING_BUDGET beside the kernel's other shared
    memory, between the least it needs and the most it takes; the TF32
    visit's slots hold tiles padded to whole wgmma steps.  first8's warps
    hold F8_SLOTS slots of a tile's 8 columns each, whatever TT: its
    shared memory does not grow with the tile, and the card never refuses
    it."""
    tile, reduce, layout, precision = variant
    for tt in (32, 96, 128, 512, 1024, 1728, 1760, 2048, 3552, 3616, 3648,
               4096):
        if layout == "lane" and tt != visit.LANE_TT:
            continue
        need = visit._smem_bytes(tt, variant)
        step = 16 * visit._width(tt, precision) * 4
        if reduce == "first8":
            assert need == visit.F8_SMEM <= visit.SMEM_MAX
            assert visit.ring_stages(tt, tile, layout, reduce, precision) \
                == visit.F8_SLOTS
            assert need == visit.F8_WARPS * (visit.F8_SLOTS * (
                16 * 8 * 4 + 8) + visit.ROWS * visit.F8_SPAN * 4)
        else:
            fixed, least, most = visit._ring_kernel(layout, reduce,
                                                    precision)
            stages = visit.ring_stages(tt, tile, layout, reduce,
                                       precision)
            assert need == stages * step + fixed
            if tile == "static":
                assert stages == 1
            else:
                assert least <= stages <= most
                assert stages == least or need <= visit.RING_BUDGET
                assert stages == most \
                    or (stages + 1) * step + fixed > visit.RING_BUDGET
        tab = torch.zeros((8 * 16, tt), device="meta")
        feats = torch.zeros((16, 128), device="meta")

        class Stop(Exception):
            pass

        def stop():
            raise Stop

        monkeypatch.setattr(visit, "_library", stop)
        monkeypatch.setattr(visit, "_cuda", lambda dev, what: None)
        monkeypatch.setattr(visit, "_aligned", lambda **kw: None)
        with pytest.raises(ValueError if need > visit.SMEM_MAX else Stop,
                           match="shared memory"
                           if need > visit.SMEM_MAX else None):
            visit.visit(tab, feats, n_visits=8, n_tiles=8, tile=tile,
                        reduce=reduce, layout=layout, precision=precision)
    # the probes' sizes: three slots (the TF32 visit eight), two blocks an
    # SM
    assert visit.ring_stages(128, "dynamic") == 3
    assert visit.ring_stages(512, "dynamic") == 3
    assert visit.ring_stages(128, "batched8") == 3
    assert visit.ring_stages(1024, "dynamic") == 1
    assert visit.ring_stages(128, "dynamic", "lane") == 3
    assert visit.ring_stages(128, "dynamic", reduce="mt") == 3
    assert visit.ring_stages(1024, "dynamic", reduce="mt") == 1
    assert visit.ring_stages(128, "dynamic", precision="default") == 8
    assert visit.ring_stages(512, "dynamic", precision="default") == 3
    assert [visit._width(tt, "default") for tt in (32, 128, 160, 512)] \
        == [128, 128, 256, 512]
    for v, tt in ((0, 128), (0, 512), (6, 128), (5, 128), (2, 128),
                  (2, 512), (1, 128), (1, 512), (4, 128), (4, 4096)):
        assert 2 * (visit._smem_bytes(tt, visit.VARIANTS[v]) + 1024) \
            <= 228 * 1024


def test_aligned_refuses_an_odd_view():
    x = torch.zeros(16 * 128 + 1)[1:].view(16, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        visit._aligned(a=x)
    visit._aligned(a=torch.zeros(16, 128))


def test_visit_work_counts():
    """The operation count behind `issue_ms`: at the probes' main size,
    per ray and visit 2 x 16 x 128 multiplies and adds and 128 mins."""
    from raytracingrenderer_tpu_torch.probes import config, visit_work
    w = visit_work(config(128, 64, 512))
    assert w["mac"] + w["other"] == 8 * 4096 * 64 * 4224
    assert w["bytes"] == (64 * 16 * 128 + 8 * 16 * 4096 + 8 * 4096 * 2) * 4
    b8 = visit_work(config(128, 64, 64, tile="batched8"))
    assert b8["mac"] == w["mac"] and b8["other"] == w["other"]
    f8 = visit_work(config(128, 64, 64, reduce="first8"))
    assert f8["mac"] == w["mac"] // 16 and f8["other"] == w["other"] // 16
    mt = visit_work(config(128, 64, 512, reduce="mt"))
    assert mt["other"] == 8 * 4096 * 64 * 32 * 15
    assert visit_work(config(128, 0, 64))["mac"] == 0


@pytest.mark.parametrize("probe", ["probe_mxu", "probe_mxu2", "probe_mxu3"])
def test_probe_exits_nonzero_without_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run")
    out = subprocess.run(
        [sys.executable, "-m", f"raytracingrenderer_tpu_torch.probes.{probe}"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "cuda.is_available" in out.stderr
    assert "TFLOP/s" not in out.stdout


def test_bench_visit_times_the_floors_each_tree_has(tmp_path):
    """bench_visit launches an empty kernel only for the kinds in a
    tree's own FLOOR_KINDS, by their index there: an older tree without
    first8's kind is not asked for it, and no launch error is swallowed."""
    from raytracingrenderer_tpu_torch.probes import bench_visit
    assert bench_visit.floor_kinds(None) == visit.FLOOR_KINDS
    ops = tmp_path / "raytracingrenderer_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "visit.py").write_text(
        'X = 1\nFLOOR_KINDS = ("dot/highest", "dot/default", "relayout")\n')
    older = bench_visit.floor_kinds(tmp_path)
    assert older == visit.FLOOR_KINDS[:3]
    floors = bench_visit.floor_cases(torch.device("cpu"))
    assert [c.floor for c in floors] == list(visit.FLOOR_KINDS)
    assert [c.runs_on({"floor_kinds": older}) for c in floors] == [
        True, True, True, False]
    assert not any(c.runs_on({"floor_kinds": ()}) for c in floors)
    (ops / "visit.py").write_text("X = 1\n")
    assert bench_visit.floor_kinds(tmp_path) == ()
