"""Row lookups of a parameter table whose gradient adds in a fixed order on
both devices: `lookup_rows(ids, w)` is `w[ids]` (as F.embedding), with a
backward chosen by the device and the table's size.

The gathers torch offers each have a backward that is deterministic only
in part:
- `W[ids]` backs into an accumulating `index_put_`: on the CPU its adds run
  in an order the threads choose; on CUDA it sorts the ids and adds each
  id's rows in one sequential pass (deterministic, but a row taken
  thousands of times makes it a long serial walk: 0.25-1 ms a table);
- F.embedding backs into `embedding_dense_backward`: sequential on the
  CPU; on CUDA, past 3,072 ids into a table of a few rows (SRL's 2-row
  predicate mark under 4,800 ids, the recommendation net's gender, age
  and occupation tables), two runs of one step differ in the last bits.
  Over tables of 1,000 rows and more it repeats bit for bit.
So the backward takes `embedding_dense_backward` on the CPU and for large
tables on CUDA, and for a table of at most ONE_HOT_ROWS rows on CUDA the
product of the ids' one-hot rows with the output gradient (cuBLAS sums in
a fixed order).  The k-step dispatch's bit-for-bit equality with k = 1
rests on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# on CUDA, tables of at most this many rows take the one-hot product, while
# the one-hot matrix (ids x rows) stays within ONE_HOT_ELEMENTS
ONE_HOT_ROWS = 512
ONE_HOT_ELEMENTS = 1 << 25


class _LookupRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]
        return F.embedding(ids, w)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        rows = ctx.rows
        if grad.is_cuda and rows <= ONE_HOT_ROWS \
                and ids.numel() * rows <= ONE_HOT_ELEMENTS:
            width = grad.shape[-1]
            onehot = (ids.reshape(-1, 1) == torch.arange(
                rows, device=ids.device)).to(grad.dtype)
            return None, onehot.t() @ grad.reshape(-1, width)
        return None, torch.ops.aten.embedding_dense_backward(
            grad, ids, rows, -1, False)


def lookup_rows(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w[ids]: [...] int64 ids into the [V, D] table -> [..., D]."""
    if not torch.is_grad_enabled() or not w.requires_grad:
        return F.embedding(ids, w)
    return _LookupRows.apply(ids, w)
