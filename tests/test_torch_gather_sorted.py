"""G2's numpy model (tests/gather_model.py `transpose_sorted_model`, which
the card's tests hold csrc/gather_kernel.cu's sorted transpose to bit for
bit) on the CPU, on tables past G1's TABLE_MAX: 6,145, 65,537 and 262,156
rows, 1 to 3 columns, 1 to 2^19 + 77 indices, drawn at random, in runs,
with 12 hot rows holding 60% of them (a frame's walls), all on one row,
every row once, negative, a third out of range (skipped), and none.

- Within an ulp of the exact sum: 2^-24 of the float64 sum plus 2^-32 of
  the sum of magnitudes (a bound on both float64 sums' own rounding up
  to 2^20 terms); the model sums in double and rounds once.
- Within the float32 sum-order bound of `transpose_plain` (the CPU's
  path and the oracle): a float32 sum of m terms in any order lies
  within (m - 1) 2^-24 sum|terms| of the exact sum, so two lie within
  twice that of each other, row by row.
- A row no index holds is 0; rows held by more than SHORT_MAX blocks
  (the hot path) are among the cases ("hot", "one_row", and 6,145 rows
  at 2^19 + 77 random indices, where every row is hot).
"""
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu_torch.ops import gather
from gather_model import (SHORT_MAX, SORTED_CASES, SORTED_ROWS,
                          sorted_case, transpose_sorted_model)

torch.set_num_threads(2)


@pytest.mark.parametrize("n,kind", SORTED_CASES)
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("rows", SORTED_ROWS)
def test_sorted_model_within_an_ulp_and_of_plain(rows, k, n, kind):
    assert not gather.small_table(rows, k)
    idx, grads = sorted_case(rows, k, n, kind, seed=0)
    got = transpose_sorted_model(grads, idx, rows)
    assert got.dtype == np.float32 and got.shape == (k, rows)
    keep = (idx >= -rows) & (idx < rows)
    flat = np.where(idx < 0, idx + rows, idx)[keep]
    ref = np.stack([np.bincount(flat, weights=g[keep].astype(np.float64),
                                minlength=rows) for g in grads])
    mag = np.stack([np.bincount(flat, weights=np.abs(g[keep]).astype(
        np.float64), minlength=rows) for g in grads])
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= 2.0 ** -24 * np.abs(ref) + 2.0 ** -32 * mag).all()
    m = np.bincount(flat, minlength=rows)
    assert (got[:, m == 0] == 0).all()
    plain = gather.transpose_plain(
        [torch.from_numpy(g[keep]) for g in grads],
        torch.from_numpy(flat), rows).numpy()
    bound = 2 * np.maximum(m - 1, 0) * 2.0 ** -24 * mag
    assert (np.abs(got.astype(np.float64) - plain) <= bound).all()


def test_sorted_cases_reach_the_hot_path():
    """The cases hold rows past SHORT_MAX blocks (the hot kernel's) and
    rows under it (the one-thread sums'), in one call."""
    idx, _ = sorted_case(262156, 3, (1 << 19) + 77, "hot", seed=0)
    blocks = np.unique(np.stack([np.arange(idx.size) // gather.CHUNK,
                                 idx]), axis=1)
    held = np.bincount(blocks[1], minlength=262156)
    assert (held > SHORT_MAX).sum() == 12
    assert ((held > 0) & (held <= SHORT_MAX)).sum() > 100_000


def test_sorted_model_sums_each_row_in_block_order():
    """A row held by three blocks sums their sums in block order: 2^53,
    then 1 (lost to rounding), then -2^53 gives 0, where the exact sum
    and the order (2^53, -2^53, 1) give 1."""
    c = gather.CHUNK
    idx = np.full(3 * c, 7)
    g = np.zeros(3 * c, dtype=np.float32)
    g[0], g[c], g[2 * c] = 2.0 ** 53, 1.0, -(2.0 ** 53)
    assert transpose_sorted_model([g], idx, 6145)[0, 7] == 0.0
    g[c], g[2 * c] = g[2 * c], g[c]
    assert transpose_sorted_model([g], idx, 6145)[0, 7] == 1.0
