"""Row gathers of small tables whose transpose is a hand-written kernel.

Counterpart of raytracingrenderer_tpu/ops/gather.py, whose `gather_cols`
routes small tables on the TPU through a one-hot matmul so that the
transpose is another matmul instead of a scatter-add.  Here the forward
stays plain indexing (the same values, bit for bit) and only the
transpose changes: PyTorch's backward of plain indexing is
`index_put_(accumulate=True)`, which on the card sorts the indices and
walks each run of equal ones serially, about 14 ms for 262,144 indices
into a table of 36 rows.  `gather_cols` is a `torch.autograd.Function`
whose backward launches csrc/gather_kernel.cu once for all k columns of
the call: each block sums a fixed range of indices per (row, column) in
shared memory, a second kernel sums the blocks' partial tables, both in
a fixed order, so the gradients are the same bits from run to run.

When the kernel is used (`takes_kernel`): the table is on the card, grad
mode is on, some column requires grad, and rows x k fits the kernel's
shared-memory tables (TABLE_MAX entries, ROWS_MAX rows at k = 3, and at
most KMAX columns).  Otherwise `gather_cols` is plain indexing, so a
render (no graph recorded) and large tables (a BVH scene's triangles)
run exactly as before.

`transpose_cols` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it calls `transpose_plain`, the plain torch
version.  `launches` counts kernel launches, `rows` the indices they
reduced, and `plain_grad_calls` the gradient-carrying gathers on the card
that took plain indexing because the table was too large for the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .launch import I32, PTR, bind, launch

KMAX = 3                 # columns a call (a V3's): the kernel's registers
TABLE_MAX = 6144         # rows x k: four warps' tables of doubles
ROWS_MAX = TABLE_MAX // 3
CHUNK = 512             # indices a block of the first pass reduces

launches = 0             # kernel launches since import (or the last reset)
rows = 0                 # the indices those launches reduced
plain_grad_calls = 0     # gradient-carrying gathers on the card, plain
_lib = None


def takes_kernel(device: torch.device, n_rows: int, k: int, grad: bool,
                 requires_grad: bool) -> bool:
    """The dispatch rule: the transpose kernel serves a gather of k
    columns of `n_rows` rows on `device` where grad mode is on (`grad`),
    some column requires grad and the table fits the kernel."""
    return (device.type == "cuda" and grad and requires_grad
            and 0 < k <= KMAX and n_rows * k <= TABLE_MAX)


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
    global plain_grad_calls
    c0 = cols[0]
    if torch.is_grad_enabled() and c0.dim() == 1:
        req = any(c.requires_grad for c in cols)
        if takes_kernel(c0.device, c0.shape[0], len(cols), True, req):
            return _GatherCols.apply(idx, *cols)
        if req and c0.device.type == "cuda":
            plain_grad_calls += 1
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
    """csrc/gather_kernel.cu's launcher, bound once."""
    global _lib
    if _lib is None:
        _lib = bind("gather_kernel",
                    {"gather_transpose": [PTR, I32, PTR, I32,
                                          ctypes.c_longlong, I32, PTR,
                                          PTR]})
    return _lib


def _check(grads, idx: torch.Tensor, n_rows: int) -> None:
    if not 0 < len(grads) <= KMAX:
        raise ValueError(f"1 to {KMAX} columns, got {len(grads)}")
    if n_rows * len(grads) > TABLE_MAX:
        raise ValueError(f"{n_rows} rows x {len(grads)} columns exceed the "
                         f"kernel's table of {TABLE_MAX} entries")
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
    global launches, rows
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
    blocks = (n + CHUNK - 1) // CHUNK
    out = torch.empty((k, n_rows), dtype=torch.float32, device=dev)
    partials = torch.empty(n_rows * k * blocks, dtype=torch.float64,
                           device=dev)
    cols = (ctypes.c_void_p * k)(*(g.data_ptr() for g in grads))
    launch(_library()["gather_transpose"], dev, cols, k, idx.data_ptr(),
           idx.element_size(), n, n_rows, partials.data_ptr(),
           out.data_ptr())
    launches += 1
    rows += n
    return out


def transpose_cols(grads: Sequence[torch.Tensor], idx: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """(k, n_rows) sums of each column of `grads` by row `idx`: the
    transpose of gathering k columns of an `n_rows`-row table.  CUDA
    tensors launch the kernel; CPU tensors take `transpose_plain`.  An
    index outside [-n_rows, n_rows) raises (read back from the card, so
    this waits for it; the backward skips the read)."""
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < -n_rows or hi >= n_rows:
            raise IndexError(f"index {lo if lo < -n_rows else hi} is out of "
                             f"range for {n_rows} rows")
    return _transpose(grads, idx, n_rows)
