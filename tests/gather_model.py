"""A numpy model of csrc/gather_kernel.cu's partition and sum order (numpy
only: the CPU tests and the card's tests both import it).

The kernel sums in double, in an order fixed by the shapes; IEEE double
adds round alike on the host and on the card, and the conversions from
and to float32 are exact or rounded to nearest on both, so the model
gives the kernel's bits.  What it mirrors: blocks of CHUNK indices; in a
block, KWARPS warps each taking every KWARPS-th batch of 32 in order; in
a batch, the runs of one row summed by a tree of shuffles (a lane adds
the value `off` lanes down where that lane is still in its run, for off
= 1, 2, 4, 8, 16, all lanes at once), then the heads of one row's runs
added in lane order to the warp's table; the warps' tables in warp
order; then for each entry, lane l of a warp summing blocks l, l + 32,
... in order, and a shuffle-down tree whose lane 0 is rounded to
float32.
"""
import numpy as np

CHUNK = 512      # ops/gather.py CHUNK, the kernel's kChunk
KWARPS = 4        # the kernel's kWarps


def _shfl_down(s, off):
    """What each lane reads from `off` lanes down (its own value past
    the warp's end); the lanes are s's last axis."""
    out = s.copy()
    out[..., :32 - off] = s[..., off:]
    return out


def transpose_model(grads, idx, rows: int) -> np.ndarray:
    """(k, rows) float32: the kernel's result for k float32 columns of
    upstream gradients and an index (numpy arrays)."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    vals = np.stack([np.asarray(g, dtype=np.float32).reshape(-1)
                     for g in grads]).astype(np.float64)
    k, n = vals.shape
    row = np.where(idx < 0, idx + rows, idx)
    row = np.where((row >= 0) & (row < rows), row, -1)
    blocks = -(-n // CHUNK)
    partials = np.zeros((rows * k, blocks))
    lanes = np.arange(32)
    for b in range(blocks):
        start, end = b * CHUNK, min(n, (b + 1) * CHUNK)
        tables = np.zeros((KWARPS, rows, k))
        for w in range(KWARPS):
            for base in range(start + 32 * w, end, 32 * KWARPS):
                i = base + lanes
                live = i < end
                r = np.where(live, row[np.minimum(i, n - 1)], -1)
                s = np.where(live, vals[:, np.minimum(i, n - 1)], 0.0)
                head = np.ones(32, dtype=bool)
                head[1:] = r[1:] != r[:-1]
                heads = np.flatnonzero(head)
                nxt = np.searchsorted(heads, lanes, side="right")
                last = np.where(nxt < heads.size,
                                heads[np.minimum(nxt, heads.size - 1)] - 1,
                                31)
                for off in (1, 2, 4, 8, 16):
                    s = np.where(lanes + off <= last, s + _shfl_down(s, off),
                                 s)
                for rr in np.unique(r[head]):
                    if rr < 0:
                        continue
                    t = np.zeros(k)
                    for lane in heads[r[heads] == rr]:
                        t = t + s[:, lane]
                    tables[w, rr] += t
        p = np.zeros(rows * k)
        for w in range(KWARPS):
            p = p + tables[w].reshape(-1)
        partials[:, b] = p
    acc = np.zeros((rows * k, 32))      # a warp an entry
    for lane in range(32):
        for blk in range(lane, blocks, 32):
            acc[:, lane] = acc[:, lane] + partials[:, blk]
    for off in (16, 8, 4, 2, 1):
        acc = acc + _shfl_down(acc, off)
    return acc[:, 0].astype(np.float32).reshape(rows, k).T.copy()
