"""Row gathers whose transpose is a hand-written kernel.

Counterpart of raytracingrenderer_tpu/ops/gather.py, whose `gather_cols`
routes small tables on the TPU through a one-hot matmul so that the
transpose is another matmul instead of a scatter-add (larger tables stay
indexing there, whose transpose is XLA's scatter-add).  Here the forward
stays plain indexing (the same values, bit for bit) and only the
transpose changes: PyTorch's backward of plain indexing is
`index_put_(accumulate=True)`, a column at a time, which on the card
sorts the indices and walks each run of equal ones serially, about 14 ms
for 262,144 indices into a table of 36 rows and 28 ms for a frame's
three columns into 262,156 rows.  `gather_cols` is a
`torch.autograd.Function` whose backward launches csrc/gather_kernel.cu
once for all k columns of the call, by the table's size:

- G1, tables of up to TABLE_MAX entries (rows x k): each block sums a
  fixed range of indices per (row, column) in shared memory, a second
  kernel sums the blocks' partial tables (rows x k x blocks doubles).
- G2, larger tables (a BVH scene's triangles): each block sums the rows
  it holds, each row's block sums go to a segment of their own, and each
  row sums its segment in block order (scratch: `sorted_scratch`, linear
  in the index count).

Both sum in double in an order fixed by the index positions and round
once, so the gradients are the same bits from run to run.

When a kernel is used (`takes_kernel`): the table is on the card, grad
mode is on, some column requires grad, and there are at most KMAX
columns.  Otherwise `gather_cols` is plain indexing, so a render (no
graph recorded) runs exactly as before.

`transpose_cols` launches a kernel for CUDA tensors and raises if it
cannot; for CPU tensors it calls `transpose_plain`, the plain torch
version.  `launches` counts G1's launches and `rows` the indices they
reduced, `sorted_launches` and `sorted_rows` G2's; `plain_grad_calls`
counts the gradient-carrying gathers on the card that took plain
indexing (only a gather of more than KMAX columns, since G2 takes every
table G1 does not) and `plain_grad_rows` their indices.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .launch import I32, PTR, bind, launch

KMAX = 3                 # columns a call (a V3's): the kernels' registers
TABLE_MAX = 6144         # rows x k that G1 takes: four warps' tables
ROWS_MAX = TABLE_MAX // 3
CHUNK = 512             # indices a block of either kernel reduces
SHORT_MAX = 32           # G2: blocks a row that one thread sums (kShortMax)
INDEX_MAX = 2**31 - 1    # G2: indices a call (int32 positions)

launches = 0             # G1's launches since import (or the last reset)
rows = 0                 # the indices those launches reduced
sorted_launches = 0      # G2's launches
sorted_rows = 0          # the indices those launches reduced
plain_grad_calls = 0     # gradient-carrying gathers on the card, plain
plain_grad_rows = 0      # the indices of those gathers
_lib = None


def takes_kernel(device: torch.device, n_rows: int, k: int, grad: bool,
                 requires_grad: bool) -> bool:
    """The dispatch rule: a transpose kernel serves a gather of k columns
    of `n_rows` rows on `device` where grad mode is on (`grad`) and some
    column requires grad; G1 where the table fits it (`small_table`), G2
    otherwise."""
    return (device.type == "cuda" and grad and requires_grad
            and 0 < k <= KMAX)


def small_table(n_rows: int, k: int) -> bool:
    """Whether G1 takes the table (rows x k within TABLE_MAX)."""
    return n_rows * k <= TABLE_MAX


def sorted_scratch(n: int, n_rows: int, k: int) -> Tuple[int, int]:
    """G2's scratch for n indices into n_rows rows x k columns: (int32
    words, doubles).  The ints: a count and a cursor a row, two counters,
    the hot rows' list (rows held by more than SHORT_MAX blocks: fewer
    than n / (SHORT_MAX + 1)) and a block number an entry; the doubles: k
    sums an entry.  An entry is a (block, row) pair, at most one an
    index: 4 + 8 k bytes an index and 8 bytes a row at most."""
    hot_cap = min(n_rows, n // (SHORT_MAX + 1) + 1)
    return 2 * n_rows + 2 + hot_cap + n, k * n


class _GatherCols(torch.autograd.Function):
    """Plain indexing forward; the transpose kernel backward.  Saves the
    index and the row count, as plain indexing's backward does."""

    @staticmethod
    def forward(ctx, idx, *cols):
        ctx.save_for_backward(idx)
        ctx.n_rows = cols[0].shape[0]
        out = tuple(c[idx] for c in cols)
        ctx.mark_non_differentiable(*(
            o for o, need in zip(out, ctx.needs_input_grad[1:]) if not need))
        return out

    @staticmethod
    def backward(ctx, *grads):
        idx, = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        sums = iter(_transpose([g for g, n in zip(grads, need) if n], idx,
                               ctx.n_rows))
        return (None, *(next(sums) if n else None for n in need))


def gather_cols(cols: Sequence[torch.Tensor], idx: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Rows `idx` of k same-length 1-D columns of one table: `c[idx]` for
    each, with the transpose kernel as their backward where
    `takes_kernel` says so."""
    global plain_grad_calls, plain_grad_rows
    c0 = cols[0]
    if torch.is_grad_enabled() and c0.dim() == 1:
        req = any(c.requires_grad for c in cols)
        if takes_kernel(c0.device, c0.shape[0], len(cols), True, req):
            return _GatherCols.apply(idx, *cols)
        if req and c0.device.type == "cuda":
            plain_grad_calls += 1
            plain_grad_rows += idx.numel()
    return tuple(c[idx] for c in cols)


def transpose_plain(grads: Sequence[torch.Tensor], idx: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """(k, n_rows): column c's row r is the sum of grads[c] where idx is
    r (negative indices count from the end, as indexing's do)."""
    flat = idx.reshape(-1).long()
    flat = torch.where(flat < 0, flat + n_rows, flat)
    out = torch.zeros((len(grads), n_rows), dtype=torch.float32,
                      device=idx.device)
    for c, g in enumerate(grads):
        out[c].index_add_(0, flat, g.reshape(-1).to(torch.float32))
    return out


def _library():
    """csrc/gather_kernel.cu's launchers, bound once."""
    global _lib
    if _lib is None:
        args = [PTR, I32, PTR, I32, ctypes.c_longlong, I32, PTR, PTR, PTR]
        _lib = bind("gather_kernel", {"gather_transpose": args[:-1],
                                      "gather_transpose_sorted": args})
    return _lib


def _check(grads, idx: torch.Tensor, n_rows: int) -> None:
    if not 0 < len(grads) <= KMAX:
        raise ValueError(f"1 to {KMAX} columns, got {len(grads)}")
    if not 0 <= n_rows <= INDEX_MAX or idx.numel() > INDEX_MAX:
        raise ValueError(f"{idx.numel()} indices into {n_rows} rows: at "
                         f"most {INDEX_MAX} of each")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"the index must be int32 or int64, got {idx.dtype}")
    if not idx.is_contiguous():
        raise ValueError("the index must be contiguous")
    for c, g in enumerate(grads):
        if g.dtype != torch.float32:
            raise TypeError(f"column {c} must be float32, got {g.dtype}")
        if g.shape != idx.shape:
            raise ValueError(f"column {c} has shape {tuple(g.shape)}, the "
                             f"index {tuple(idx.shape)}")
        if g.device != idx.device:
            raise ValueError(f"column {c} is on {g.device}, the index on "
                             f"{idx.device}")


def _transpose(grads, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """transpose_cols without the index's range check: the backward's
    index went through the forward's indexing, which checked it."""
    global launches, rows, sorted_launches, sorted_rows
    idx = idx.contiguous()
    grads = [g.contiguous() for g in grads]
    _check(grads, idx, n_rows)
    dev = idx.device
    if dev.type == "cpu":
        return transpose_plain(grads, idx, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"no transpose kernel for device {dev}")
    n = idx.numel()
    k = len(grads)
    out = torch.empty((k, n_rows), dtype=torch.float32, device=dev)
    cols = (ctypes.c_void_p * k)(*(g.data_ptr() for g in grads))
    if small_table(n_rows, k):
        blocks = (n + CHUNK - 1) // CHUNK
        partials = torch.empty(n_rows * k * blocks, dtype=torch.float64,
                               device=dev)
        launch(_library()["gather_transpose"], dev, cols, k,
               idx.data_ptr(), idx.element_size(), n, n_rows,
               partials.data_ptr(), out.data_ptr())
        launches += 1
        rows += n
        return out
    n_ints, n_doubles = sorted_scratch(n, n_rows, k)
    ints = torch.empty(n_ints, dtype=torch.int32, device=dev)
    sums = torch.empty(n_doubles, dtype=torch.float64, device=dev)
    launch(_library()["gather_transpose_sorted"], dev, cols, k,
           idx.data_ptr(), idx.element_size(), n, n_rows, ints.data_ptr(),
           sums.data_ptr(), out.data_ptr())
    sorted_launches += 1
    sorted_rows += n
    return out


def transpose_cols(grads: Sequence[torch.Tensor], idx: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """(k, n_rows) sums of each column of `grads` by row `idx`: the
    transpose of gathering k columns of an `n_rows`-row table.  CUDA
    tensors launch G1 or G2 by the table's size; CPU tensors take
    `transpose_plain`.  An index outside [-n_rows, n_rows) raises (read
    back from the card, so this waits for it; the backward skips the
    read)."""
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < -n_rows or hi >= n_rows:
            raise IndexError(f"index {lo if lo < -n_rows else hi} is out of "
                             f"range for {n_rows} rows")
    return _transpose(grads, idx, n_rows)
