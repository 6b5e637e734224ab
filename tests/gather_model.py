"""Numpy models of csrc/gather_kernel.cu's two transposes, their
partitions and sum orders (numpy only: the CPU tests and the card's tests
both import it).

The kernels sum in double, in an order fixed by the shapes and the index
positions; IEEE double adds round alike on the host and on the card, and
the conversions from and to float32 are exact or rounded to nearest on
both, so the models give the kernels' bits.

`transpose_model` (G1, tables of up to TABLE_MAX entries) mirrors: blocks
of CHUNK indices; in a block, KWARPS warps each taking every KWARPS-th
batch of 32 in order; in a batch, the runs of one row summed by a tree of
shuffles (a lane adds the value `off` lanes down where that lane is still
in its run, for off = 1, 2, 4, 8, 16, all lanes at once), then the heads
of one row's runs added in lane order to the warp's table; the warps'
tables in warp order; then for each entry, lane l of a warp summing
blocks l, l + 32, ... in order, and a shuffle-down tree whose lane 0 is
rounded to float32.

`transpose_sorted_model` (G2, larger tables) mirrors: the same blocks and
batches, but a warp takes 4 consecutive batches and the block one table
of the rows it holds, to which the warps add their batches' row sums
(the run trees, the heads in lane order) in turn, so the batches in
position order; then each row's block sums in block order: one after
the other for a row held by at most SHORT_MAX blocks, and for a hot row
in windows of WINDOW blocks, each window's 256 threads summing 16
consecutive blocks each, a shuffle-down tree a warp, the 8 warps' sums
in warp order, the windows one after the other.
"""
import numpy as np

CHUNK = 512      # ops/gather.py CHUNK, the kernel's kChunk
KWARPS = 4        # the kernel's kWarps
SHORT_MAX = 32    # kShortMax: blocks a row that one thread sums
WINDOW = 4096     # kWindow: blocks a hot row's window
HOT_THREADS = 256  # kHotThreads: threads of a hot row's block


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


def _run_sums(row, vals):
    """The batches of 32 indices (the last padded with row -1): each
    lane's run-tree sum (k, batches, 32) and the head lanes (batches,
    32) whose sums stand for their runs."""
    k, n = vals.shape
    nb = -(-n // 32)
    r = np.full(nb * 32, -1, dtype=np.int64)
    r[:n] = row
    r = r.reshape(nb, 32)
    s = np.zeros((k, nb * 32))
    s[:, :n] = vals
    s = s.reshape(k, nb, 32)
    lanes = np.arange(32)
    head = np.ones((nb, 32), dtype=bool)
    head[:, 1:] = r[:, 1:] != r[:, :-1]
    # the first head at or after each lane; a lane's run ends before the
    # first head after it
    first = np.minimum.accumulate(np.where(head, lanes, 32)[:, ::-1],
                                  axis=1)[:, ::-1]
    last = np.concatenate([first[:, 1:], np.full((nb, 1), 32)], 1) - 1
    for off in (1, 2, 4, 8, 16):
        s = np.where(lanes + off <= last, s + _shfl_down(s, off), s)
    return r, s, head


def _hot_sums(hot, erow, eblock, p, rows, n_blocks, chunk=128):
    """The hot rows' sums (len(hot), k) from the entries (row, block,
    sum (k,)): a row's windows of WINDOW blocks, 16 consecutive blocks a
    thread, a shuffle-down tree a warp, the warps in order, the windows
    in order; `chunk` hot rows at a time."""
    k = p.shape[1]
    per = WINDOW // HOT_THREADS
    out = np.zeros((hot.size, k))
    at = np.full(rows, -1)
    for c0 in range(0, hot.size, chunk):
        rs = hot[c0:c0 + chunk]
        at[rs] = np.arange(rs.size)
        sel = np.flatnonzero(at[erow] >= 0)
        at[rs] = -1
        er = np.searchsorted(rs, erow[sel])
        eb, ev = eblock[sel], p[sel]
        total = np.zeros((rs.size, k))
        for w0 in range(0, n_blocks, WINDOW):
            win = (eb >= w0) & (eb < w0 + WINDOW)
            dense = np.zeros((rs.size, WINDOW, k))
            have = np.zeros((rs.size, WINDOW), dtype=bool)
            dense[er[win], eb[win] - w0] = ev[win]
            have[er[win], eb[win] - w0] = True
            dense = dense.reshape(rs.size, HOT_THREADS, per, k)
            have = have.reshape(rs.size, HOT_THREADS, per)
            a = np.zeros((rs.size, HOT_THREADS, k))
            for q in range(per):
                a = np.where(have[:, :, q, None], a + dense[:, :, q], a)
            a = a.reshape(rs.size, HOT_THREADS // 32, 32, k)
            a = a.transpose(0, 1, 3, 2)
            for off in (16, 8, 4, 2, 1):
                a = a + _shfl_down(a, off)
            ws = np.zeros((rs.size, k))
            for w in range(HOT_THREADS // 32):
                ws = ws + a[:, w, :, 0]
            total = total + ws
        out[c0:c0 + rs.size] = total
    return out


def transpose_sorted_model(grads, idx, rows: int) -> np.ndarray:
    """(k, rows) float32: G2's result for k float32 columns of upstream
    gradients and an index (numpy arrays)."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    vals = np.stack([np.asarray(g, dtype=np.float32).reshape(-1)
                     for g in grads]).astype(np.float64)
    k, n = vals.shape
    out = np.zeros((k, rows), dtype=np.float32)
    if n == 0 or rows == 0:
        return out
    row = np.where(idx < 0, idx + rows, idx)
    row = np.where((row >= 0) & (row < rows), row, -1)
    r, s, head = _run_sums(row, vals)
    # the heads of one row in a batch, summed in lane order
    hb, hl = np.nonzero(head & (r >= 0))
    hrow = r[hb, hl]
    gkey, gid = np.unique(hb * (rows + 1) + hrow, return_inverse=True)
    t = np.zeros((gkey.size, k))
    np.add.at(t, gid.reshape(-1), s[:, hb, hl].T)
    # a block's table: its batches' row sums in position order
    gbatch, grow = gkey // (rows + 1), gkey % (rows + 1)
    ekey, eid = np.unique((gbatch // (CHUNK // 32)) * (rows + 1) + grow,
                          return_inverse=True)
    p = np.zeros((ekey.size, k))
    np.add.at(p, eid.reshape(-1), t)
    eblock, erow = ekey // (rows + 1), ekey % (rows + 1)
    # each row's blocks in block order
    m = np.bincount(erow, minlength=rows)
    short = m[erow] <= SHORT_MAX
    acc = np.zeros((rows, k))
    np.add.at(acc, erow[short], p[short])
    hot = np.flatnonzero(m > SHORT_MAX)
    acc[hot] = _hot_sums(hot, erow, eblock, p, rows, -(-n // CHUNK))
    out[:] = acc.T.astype(np.float32)
    return out


SORTED_ROWS = (6145, 65537, 262156)      # past G1's TABLE_MAX at k = 1
SORTED_NS = (1, 33, 2049, (1 << 19) + 77)
SORTED_KINDS = ("random", "runs", "hot", "one_row", "distinct",
                "negative", "dead")
# (n, kind): every kind at every n, and an empty index once
SORTED_CASES = [(n, kind) for n in SORTED_NS for kind in SORTED_KINDS] + [
    (0, "empty")]


def sorted_case(rows: int, k: int, n: int, kind: str, seed: int):
    """(index int64, k float32 gradient columns) of a gather into a table
    past G1's: rows drawn at random; in runs of 5 to 70; "hot", 12 rows
    holding 60% of the indices in runs of 32 to 256 (a frame's walls),
    the rest uniform over the table; all one row; every row once before
    any twice; negative indices; a third out of range in the middle
    (skipped); none."""
    g = np.random.default_rng([seed, rows, k, n])
    if kind == "random":
        idx = g.integers(0, rows, n)
    elif kind == "runs":
        idx = np.repeat(g.integers(0, rows, n), g.integers(5, 71, n))[:n]
    elif kind == "hot":
        walls = g.choice(rows, 12, replace=False)
        n_hot = int(0.6 * n)
        lens = g.integers(32, 257, n_hot // 32 + 1)
        hot = np.repeat(g.choice(walls, lens.size), lens)[:n_hot]
        runs = np.split(hot, np.cumsum(lens)[:-1])
        tail = g.integers(0, rows, n - hot.size)
        cut = np.sort(g.integers(0, tail.size + 1, len(runs)))
        parts = np.split(tail, cut)
        idx = np.concatenate([x for pair in zip(parts, runs) for x in pair]
                             + [parts[-1]])
    elif kind == "one_row":
        idx = np.full(n, rows // 2)
    elif kind == "distinct":
        idx = np.resize(g.permutation(rows), n)
    elif kind == "negative":
        idx = g.integers(-rows, rows, n)
    elif kind == "dead":
        idx = g.integers(0, rows, n)
        idx[n // 3: n // 2] = rows + 3
    else:
        idx = np.zeros(0, dtype=np.int64)
    grads = [g.standard_normal(idx.size).astype(np.float32)
             for _ in range(k)]
    return idx.astype(np.int64), grads
