"""ops/gather.py on the CPU: the transpose of the shading path's row
gathers, its dispatch rule and its autograd Function.

- `transpose_plain` (the kernel's plain version, which the CPU takes)
  against autograd of plain indexing, for tables of 1, 8 and 36 rows
  with k = 1 and 3: random rows, every index on one row, indices at the
  last row, negative indices, an empty index.
- `gather_cols`'s Function, driven on the CPU where its backward takes
  the plain version: forward equal to plain indexing bit for bit, the
  backward equal to `transpose_plain`, columns that need no gradient
  left without one.
- the dispatch rule `takes_kernel` with a device argument, so it runs
  without a card, and `small_table`, which picks G1 or G2 by the
  table's size; `gather_cols` on the CPU is plain indexing.
- `transpose_cols` refuses what the kernels do not take, and takes a
  table past G1's.
- a numpy model of G1's partition and sum order (tests/gather_model.py,
  which the card's tests hold the kernel to bit for bit) within an ulp
  of the exact sum (G2's model: tests/test_torch_gather_sorted.py).
- `diff.param_grads` on the cornell box with every gradient-carrying
  gather through the Function (the rule widened to the CPU for the test)
  against plain indexing, through the checkpointed bounces.
- the compacting wavefront's backward on a BVH scene with the rule so
  widened: no index_put_ (the tables' gathers through the Function, the
  compaction's permutations through `wavefront._Permute`), the same
  gradients as with the permutations on plain indexing.

Tolerance of a backward: the two sides sum the same float32 terms in
other orders, and a float32 sum of m terms in any order lies within
(m - 1) * 2^-24 * sum|terms| of the exact sum (the error bound of
recursive summation), so two of them lie within twice that of each
other; each row is held to that with its own m and sum|terms|.
"""
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu_torch import diff
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.ops import gather
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from gather_model import transpose_model
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)

N = 1000
KINDS = ("random", "one_row", "last_row", "negative", "empty")


def _case(rows, k, kind, seed=0):
    """(columns, index, upstream gradients) of a gather of k columns."""
    g = np.random.default_rng(seed)
    idx = {"random": g.integers(0, rows, N),
           "one_row": np.full(N, rows // 2),
           "last_row": np.full(N, rows - 1),
           "negative": g.integers(-rows, rows, N),
           "empty": np.zeros(0, dtype=np.int64)}[kind]
    cols = [torch.from_numpy(g.standard_normal(rows).astype(np.float32))
            for _ in range(k)]
    grads = [torch.from_numpy(g.standard_normal(idx.size).astype(np.float32))
             for _ in range(k)]
    return cols, torch.from_numpy(idx.astype(np.int64)), grads


def _sum_order_bound(grads, idx, rows):
    """(k, rows): twice (m - 1) * 2^-24 * sum|terms| a row."""
    flat = torch.where(idx < 0, idx + rows, idx)
    m = torch.bincount(flat, minlength=rows).double()
    mag = torch.stack([torch.zeros(rows, dtype=torch.float64)
                       .index_add_(0, flat, g.abs().double())
                       for g in grads])
    return 2 * (m - 1).clamp(min=0) * 2.0 ** -24 * mag


def _exact(grads, idx, rows):
    flat = torch.where(idx < 0, idx + rows, idx)
    return torch.stack([torch.zeros(rows, dtype=torch.float64)
                        .index_add_(0, flat, g.double()) for g in grads])


def _autograd_plain(cols, idx, grads):
    leaves = [c.clone().requires_grad_(True) for c in cols]
    got = torch.autograd.grad([c[idx] for c in leaves], leaves, grads,
                              allow_unused=True)
    return torch.stack([torch.zeros_like(c) if a is None else a
                        for a, c in zip(got, cols)])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("rows", [1, 8, 36])
def test_transpose_plain_matches_autograd_of_indexing(rows, k, kind):
    cols, idx, grads = _case(rows, k, kind)
    plain = gather.transpose_plain(grads, idx, rows)
    auto = _autograd_plain(cols, idx, grads)
    assert plain.shape == (k, rows) and plain.dtype == torch.float32
    tol = _sum_order_bound(grads, idx, rows)
    assert bool(((plain.double() - auto.double()).abs() <= tol).all())
    assert bool(((plain.double() - _exact(grads, idx, rows)).abs()
                 <= tol / 2).all())
    if kind == "empty":
        assert bool((plain == 0).all())
    if kind in ("one_row", "last_row"):
        hot = int(idx[0])
        assert bool((plain[:, :hot] == 0).all())
        assert bool((plain[:, hot + 1:] == 0).all())


@pytest.mark.parametrize("kind", KINDS + ("runs", "tail_dead"))
@pytest.mark.parametrize("n", [1, 31, 33, 2049, 9000])
@pytest.mark.parametrize("rows,k", [(1, 1), (8, 3), (36, 3), (300, 2)])
def test_kernel_model_is_within_an_ulp_of_the_sum(rows, k, n, kind):
    """The kernel's partition and sum order (tests/gather_model.py: runs
    of a row summed by a tree of shuffles, their heads in lane order,
    warps, blocks) lose nothing but the final rounding: within 2^-24 of
    the float64 sum plus 2^-32 of the sum of magnitudes (a bound on both
    float64 sums' own rounding up to 2^20 terms).  `runs`: rows in runs
    of 5 to 70 lanes, across batches; `tail_dead`: indices out of range
    in the middle, which the kernel skips."""
    g = np.random.default_rng(rows * 13 + n)
    if kind == "runs":
        idx = np.repeat(g.integers(0, rows, n), g.integers(5, 71, n))[:n]
    elif kind == "tail_dead":
        idx = g.integers(0, rows, n)
        idx[n // 3: n // 2] = rows + 3
    else:
        _, idx_t, _ = _case(rows, k, kind, seed=n)
        idx = idx_t.numpy()[:n]
    grads = [g.standard_normal(idx.size).astype(np.float32)
             for _ in range(k)]
    got = transpose_model(grads, idx, rows)
    keep = (idx >= -rows) & (idx < rows)
    flat = torch.from_numpy(np.where(idx < 0, idx + rows, idx)[keep])
    ref = torch.stack([torch.zeros(rows, dtype=torch.float64).index_add_(
        0, flat, torch.from_numpy(gr[keep]).double()) for gr in grads])
    mag = torch.stack([torch.zeros(rows, dtype=torch.float64).index_add_(
        0, flat, torch.from_numpy(np.abs(gr[keep])).double())
        for gr in grads])
    err = (torch.from_numpy(got).double() - ref).abs()
    assert got.dtype == np.float32 and got.shape == (k, rows)
    assert bool((err <= 2.0 ** -24 * ref.abs() + 2.0 ** -32 * mag).all())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("rows", [1, 8, 36])
def test_function_forward_is_indexing_backward_is_plain(rows, k):
    cols, idx, grads = _case(rows, k, "random", seed=rows + k)
    leaves = [c.clone().requires_grad_(True) for c in cols]
    outs = gather._GatherCols.apply(idx, *leaves)
    for o, c in zip(outs, cols):
        assert torch.equal(o, c[idx])
    got = torch.stack(torch.autograd.grad(outs, leaves, grads))
    assert torch.equal(got, gather.transpose_plain(grads, idx, rows))


def test_function_leaves_columns_without_grad_alone():
    cols, idx, grads = _case(8, 3, "random", seed=5)
    a = cols[0].clone().requires_grad_(True)
    outs = gather._GatherCols.apply(idx, a, cols[1], cols[2])
    assert outs[0].requires_grad
    assert not outs[1].requires_grad and not outs[2].requires_grad
    got, = torch.autograd.grad(outs[0], a, grads[0])
    assert torch.equal(got, gather.transpose_plain(grads[:1], idx, 8)[0])


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device,grad,req,rows,k,want", [
    (CPU, True, True, 36, 3, False),                    # CPU: plain
    (CUDA, False, True, 36, 3, False),                  # grad mode off
    (CUDA, True, False, 36, 3, False),                  # no column needs it
    (CUDA, True, True, gather.ROWS_MAX + 1, 3, True),   # large table: G2
    (CUDA, True, True, 262_156, 3, True),               # a BVH's tri_p0
    (CUDA, True, True, 36, 3, True),                    # card, grad, small
    (CUDA, True, True, gather.ROWS_MAX, 3, True),
    (CUDA, True, True, 8, gather.KMAX + 1, False),      # too many columns
])
def test_dispatch_rule(device, grad, req, rows, k, want):
    assert gather.takes_kernel(device, rows, k, grad, req) is want


@pytest.mark.parametrize("rows,k,small", [
    (gather.ROWS_MAX, 3, True), (gather.ROWS_MAX + 1, 3, False),
    (gather.TABLE_MAX, 1, True), (gather.TABLE_MAX + 1, 1, False),
    (3072, 2, True), (3073, 2, False), (1, 3, True), (262_156, 3, False)])
def test_table_size_picks_the_kernel(rows, k, small):
    """G1 takes tables of up to TABLE_MAX entries (rows x k), G2 the
    rest."""
    assert gather.small_table(rows, k) is small


def test_gather_cols_on_the_cpu_is_plain_indexing():
    cols, idx, _ = _case(36, 3, "random", seed=9)
    leaves = [c.clone().requires_grad_(True) for c in cols]
    before = (gather.launches, gather.plain_grad_calls)
    outs = gather.gather_cols(leaves, idx)
    assert all(type(o.grad_fn).__name__ == "IndexBackward0" for o in outs)
    assert all(torch.equal(o, c[idx]) for o, c in zip(outs, cols))
    with torch.no_grad():
        assert all(o.grad_fn is None
                   for o in gather.gather_cols(leaves, idx))
    assert (gather.launches, gather.plain_grad_calls) == before


def test_transpose_cols_refuses():
    _, idx, grads = _case(8, 3, "random", seed=3)
    with pytest.raises(IndexError):
        gather.transpose_cols(grads, torch.full_like(idx, 8), 8)
    with pytest.raises(IndexError):
        gather.transpose_cols(grads, torch.full_like(idx, -9), 8)
    with pytest.raises(TypeError):
        gather.transpose_cols([g.double() for g in grads], idx, 8)
    with pytest.raises(TypeError):
        gather.transpose_cols(grads, idx.float(), 8)
    with pytest.raises(ValueError):
        gather.transpose_cols([g[1:] for g in grads], idx, 8)
    with pytest.raises(ValueError):
        gather.transpose_cols(grads * 3, idx, 8)
    with pytest.raises(ValueError):
        gather.transpose_cols(grads, idx, gather.INDEX_MAX + 1)
    assert torch.equal(gather.transpose_cols(grads, idx, 8),
                       gather.transpose_plain(grads, idx, 8))
    assert torch.equal(gather.transpose_cols(grads, idx,
                                             gather.ROWS_MAX + 1),
                       gather.transpose_plain(grads, idx,
                                              gather.ROWS_MAX + 1))


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return load_scene(write_cornell(str(tmp_path_factory.mktemp("c")), 16,
                                    16), "cpu")


@pytest.mark.parametrize("remat", [True, False])
def test_param_grads_through_the_function(cornell, monkeypatch, remat):
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4, seed=3,
                       remat=remat)
    target = torch.full((16, 16, 3), 0.2)
    key = rng.PRNGKey(3)
    plain = diff.param_grads(cornell, target, key, cfg)
    calls = []
    real = gather._transpose

    def spy(grads, idx, n_rows):
        calls.append((len(grads), n_rows))
        return real(grads, idx, n_rows)
    monkeypatch.setattr(gather, "_transpose", spy)
    monkeypatch.setattr(gather, "takes_kernel",
                        lambda dev, n, k, grad, req: grad and req)
    got = diff.param_grads(cornell, target, key, cfg)
    # 6 bounces: tri_p0 twice (the hit's and the light's), albedo,
    # emission and light_le once each a bounce
    assert sorted(set(calls)) == [(3, 2), (3, 8), (3, 36)]
    assert len(calls) == 30
    for name in diff.param_keys(got):
        a = torch.stack(list(got[name])) if isinstance(
            got[name], tuple) else got[name]
        b = torch.stack(list(plain[name])) if isinstance(
            plain[name], tuple) else plain[name]
        norm = float(b.double().norm())
        assert float((a.double() - b.double()).norm()) <= 1e-6 * norm, name


def test_wavefront_backward_calls_no_index_put(monkeypatch, tmp_path):
    """The compacting wavefront's backward on the 5,156-triangle spheres
    scene, the gather rule widened to the CPU as on the card, calls no
    index_put_ (autograd's transpose of indexing): the tables' gathers,
    tri_p0's past G1's table among them, take the Function, and the
    compaction's permutations `wavefront._Permute`, whose transpose
    gathers by the inverse permutation.  The gradients equal, bit for
    bit, those with the permutations on plain indexing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from raytracingrenderer_tpu_torch.integrators import wavefront
    from raytracingrenderer_tpu_torch.render import _use_wavefront
    scene = load_scene(write_spheres(str(tmp_path), 24, 24, subdiv=2),
                       "cpu")
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4, seed=5)
    assert _use_wavefront(scene, cfg)
    target = torch.full((24, 24, 3), 0.2)
    monkeypatch.setattr(gather, "takes_kernel",
                        lambda dev, n, k, grad, req: grad and req)
    ops, real_grad = [], torch.autograd.grad

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    def grad(*args, **kwargs):
        with Ops():
            return real_grad(*args, **kwargs)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    _, got = diff.loss_and_grads(scene, target, rng.PRNGKey(5), cfg)
    assert ops and not [op for op in ops if "index_put" in op]
    monkeypatch.setattr(wavefront, "_permute", lambda state, perm:
                        wavefront._map(state, lambda a: a[perm]))
    ops.clear()
    _, plain = diff.loss_and_grads(scene, target, rng.PRNGKey(5), cfg)
    assert [op for op in ops if "index_put" in op]
    for name in diff.param_keys(got):
        a, b = got[name], plain[name]
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), name
