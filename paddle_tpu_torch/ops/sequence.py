"""Variable-length sequence ops on padded [B, T, D] tensors plus a [B]
lengths vector — the counterparts of paddle_tpu/ops/sequence.py
(`seq_pool_max`, `seq_pool_avg`, `seq_pool_first`, `seq_pool_last`, each a
masked dense reduction over the time axis, `seq_reverse`, which reversed
recurrent groups need, and `context_projection`, the mixed layer's sliding
window).  The nested (sub-sequence) forms and the other sequence ops of
that module are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.table import lookup_rows


def length_mask(lengths: torch.Tensor, max_len: int,
                dtype=torch.bool) -> torch.Tensor:
    """[B] lengths -> [B, T] validity mask."""
    t = torch.arange(max_len, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def seq_pool_max(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Max over the valid timesteps: [B, T, D], [B] -> [B, D]; padded steps
    count as the dtype's lowest value (a length-0 row gives that value)."""
    mask = length_mask(lengths, x.shape[1])[..., None]
    return x.masked_fill(~mask, torch.finfo(x.dtype).min).amax(dim=1)


def seq_pool_avg(x: torch.Tensor, lengths: torch.Tensor,
                 strategy: str = "average") -> torch.Tensor:
    """Mean ('average'), sum ('sum') or sum / sqrt(n) ('squarerootn') over
    the valid timesteps, n = max(length, 1)."""
    if strategy not in ("average", "sum", "squarerootn"):
        raise ValueError(f"average_strategy {strategy!r}: expected average, "
                         f"sum or squarerootn")
    mask = length_mask(lengths, x.shape[1], x.dtype)[..., None]
    total = torch.sum(x * mask, dim=1)
    if strategy == "sum":
        return total
    n = lengths.to(x.dtype).clamp(min=1.0)[:, None]
    return total / (torch.sqrt(n) if strategy == "squarerootn" else n)


def seq_pool_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The last valid timestep (step 0 of a length-0 row)."""
    idx = (lengths.long() - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def seq_pool_first(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The first timestep."""
    return x[:, 0]


def seq_reverse(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix, the padding left in place:
    [B, T, ...] -> [B, T, ...]."""
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = lengths.long()[:, None] - 1 - t
    idx = torch.where(src >= 0, src, t.expand(B, T))
    idx = idx.reshape(B, T, *([1] * (x.dim() - 2))).expand(x.shape)
    return torch.gather(x, 1, idx)


def context_projection(x: torch.Tensor, lengths: torch.Tensor,
                       context_start: int, context_length: int,
                       padding: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The sliding window of each position, concatenated: [B, T, D] ->
    [B, T, context_length * D], zero past each row's length.  Window
    position j reads step t + context_start + j; a step before 0 or at or
    past the row's length reads zeros, or with `padding` ([up + down, D],
    the trainable padding) row up + (src) for a step before the start and
    row up + (src - length) for one past the end, where up =
    max(0, -context_start).  Decided by each row's length, not the padded
    T.  The padding rows are gathered with ops/table.py lookup_rows, whose
    backward adds in a fixed order."""
    B, T, D = x.shape
    mask = length_mask(lengths, T, x.dtype)[..., None]
    xm = x * mask
    t = torch.arange(T, device=x.device)[None, :]
    lens = lengths.long()[:, None]
    up = max(0, -context_start)
    cols = []
    for j in range(context_length):
        offset = context_start + j
        shifted = torch.roll(xm, shifts=-offset, dims=1)
        src = t + offset
        valid = ((src >= 0) & (src < lens))[..., None]
        if padding is not None and offset != 0:
            last = padding.shape[0] - 1
            if offset < 0:
                row, use = (up + src).clamp(0, last), src < 0
            else:
                over = src - lens
                row, use = (up + over).clamp(0, last), over >= 0
            fill = torch.where(use[..., None],
                               lookup_rows(row.expand(B, T), padding), 0.0)
            col = torch.where(valid, shifted, fill)
        else:
            col = torch.where(valid, shifted, 0.0)
        cols.append(col)
    return torch.cat(cols, dim=-1) * mask
