"""Variable-length sequence ops on padded [B, T, D] tensors plus a [B]
lengths vector — the counterparts of paddle_tpu/ops/sequence.py
(`seq_pool_max`, `seq_pool_avg`, `seq_pool_first`, `seq_pool_last`, each a
masked dense reduction over the time axis, `seq_reverse`, which reversed
recurrent groups need, `context_projection`, the mixed layer's sliding
window, `expand_to_sequence`, `seq_concat`, `seq_reshape` and
`sub_sequence`).

Nested sequences are [B, S, T, ...] tensors with `lengths` [B] (the number
of sub-sequences of each row) and `sub_lengths` [B, S] (the tokens of each
sub-sequence): `nested_mask`, the `nested_pool_*` reductions over every
valid token and the `nested_pool_*_per_sub` reductions over each
sub-sequence.  Every gather here reads each source element for at most one
valid output position (a padded position reads with a zero gradient), so
the backward's adds do not depend on their order.
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
    mask = length_mask(lengths, x.shape[1], x.dtype)[..., None]
    total = torch.sum(x * mask, dim=1)
    return _pool_scale(total, lengths.to(x.dtype).clamp(min=1.0)[:, None],
                       strategy)


def _pool_scale(total: torch.Tensor, n: torch.Tensor,
                strategy: str) -> torch.Tensor:
    """A pooled sum as the average_strategy wants it: itself ('sum'),
    over n ('average') or over sqrt(n) ('squarerootn')."""
    if strategy not in ("average", "sum", "squarerootn"):
        raise ValueError(f"average_strategy {strategy!r}: expected average, "
                         f"sum or squarerootn")
    if strategy == "sum":
        return total
    return total / (torch.sqrt(n) if strategy == "squarerootn" else n)


def seq_pool_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The last valid timestep (step 0 of a length-0 row)."""
    idx = (lengths.long() - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def seq_pool_first(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The first timestep."""
    return x[:, 0]


def nested_mask(lengths: torch.Tensor, sub_lengths: torch.Tensor, T: int,
                dtype=torch.bool) -> torch.Tensor:
    """[B, S, T] validity of a nested sequence: (b, s, t) is valid iff
    s < lengths[b] and t < sub_lengths[b, s]."""
    S = sub_lengths.shape[1]
    dev = sub_lengths.device
    s_valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    t_valid = (torch.arange(T, device=dev)[None, None, :]
               < sub_lengths[:, :, None])
    return (s_valid[:, :, None] & t_valid).to(dtype)


def nested_pool_max(x: torch.Tensor, lengths: torch.Tensor,
                    sub_lengths: torch.Tensor) -> torch.Tensor:
    """Max over every valid token: [B, S, T, D] -> [B, D] (a row without
    one gives the dtype's lowest value).  Tied maxima share the gradient
    evenly, as `jnp.max`'s."""
    mask = nested_mask(lengths, sub_lengths, x.shape[2])[..., None]
    return x.masked_fill(~mask, torch.finfo(x.dtype).min).amax(dim=(1, 2))


def nested_pool_avg(x: torch.Tensor, lengths: torch.Tensor,
                    sub_lengths: torch.Tensor,
                    strategy: str = "average") -> torch.Tensor:
    """Mean / sum / sum over sqrt(n) of every valid token: [B, S, T, D] ->
    [B, D], n = max(valid tokens, 1)."""
    mask = nested_mask(lengths, sub_lengths, x.shape[2], x.dtype)[..., None]
    total = torch.sum(x * mask, dim=(1, 2))
    n = torch.sum(mask, dim=(1, 2)).clamp(min=1.0)
    return _pool_scale(total, n, strategy)


def _flat_token(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row b's token idx[b] of the [B, S*T] flattening of [B, S, T, ...]."""
    B, S, T = x.shape[:3]
    flat = x.reshape((B, S * T) + tuple(x.shape[3:]))
    return flat[torch.arange(B, device=x.device), idx]


def nested_pool_last(x: torch.Tensor, lengths: torch.Tensor,
                     sub_lengths: torch.Tensor) -> torch.Tensor:
    """The last valid token of each row: [B, S, T, D] -> [B, D], empty
    sub-sequences skipped (flat position S*T - 1 for a row without one,
    as the JAX op's argmax of an all-false mask)."""
    B, S, T = x.shape[:3]
    mask = nested_mask(lengths, sub_lengths, T).reshape(B, S * T)
    idx = (S * T - 1) - torch.argmax(mask.flip(1).to(torch.uint8), dim=1)
    return _flat_token(x, idx)


def nested_pool_first(x: torch.Tensor, lengths: torch.Tensor,
                      sub_lengths: torch.Tensor) -> torch.Tensor:
    """The first valid token of each row: [B, S, T, D] -> [B, D], empty
    sub-sequences skipped (position 0 for a row without one)."""
    B, S, T = x.shape[:3]
    mask = nested_mask(lengths, sub_lengths, T).reshape(B, S * T)
    return _flat_token(x, torch.argmax(mask.to(torch.uint8), dim=1))


def _sub_valid(lengths: torch.Tensor,
               sub_lengths: torch.Tensor) -> torch.Tensor:
    """[B, S] validity of each sub-sequence: s < lengths[b] and the
    sub-sequence is not empty."""
    S = sub_lengths.shape[1]
    s = torch.arange(S, device=sub_lengths.device)[None, :]
    return (s < lengths[:, None]) & (sub_lengths > 0)


def nested_pool_max_per_sub(x: torch.Tensor, lengths: torch.Tensor,
                            sub_lengths: torch.Tensor) -> torch.Tensor:
    """The max of each sub-sequence: [B, S, T, D] -> [B, S, D] (the
    reference's AggregateLevel.EACH_SEQUENCE pooling); 0 for an empty or
    padded sub-sequence."""
    T = x.shape[2]
    t_valid = (torch.arange(T, device=x.device)[None, None, :]
               < sub_lengths[:, :, None])[..., None]
    out = x.masked_fill(~t_valid, torch.finfo(x.dtype).min).amax(dim=2)
    return torch.where(_sub_valid(lengths, sub_lengths)[..., None], out, 0.0)


def nested_pool_avg_per_sub(x: torch.Tensor, lengths: torch.Tensor,
                            sub_lengths: torch.Tensor,
                            strategy: str = "average") -> torch.Tensor:
    """Mean / sum / sum over sqrt(n) of each sub-sequence: [B, S, T, D] ->
    [B, S, D], n = max(sub_length, 1); 0 for an empty or padded one."""
    T = x.shape[2]
    t_valid = (torch.arange(T, device=x.device)[None, None, :]
               < sub_lengths[:, :, None]).to(x.dtype)[..., None]
    total = torch.sum(x * t_valid, dim=2)
    n = sub_lengths.clamp(min=1).to(x.dtype)[..., None]
    out = _pool_scale(total, n, strategy)
    return torch.where(_sub_valid(lengths, sub_lengths)[..., None], out, 0.0)


def nested_pool_edge_per_sub(x: torch.Tensor, lengths: torch.Tensor,
                             sub_lengths: torch.Tensor,
                             first: bool) -> torch.Tensor:
    """The first or last token of each sub-sequence: [B, S, T, D] ->
    [B, S, D]; 0 for an empty or padded one."""
    if first:
        out = x[:, :, 0]
    else:
        B, S = sub_lengths.shape
        dev = x.device
        idx = (sub_lengths.long() - 1).clamp(min=0)
        out = x[torch.arange(B, device=dev)[:, None],
                torch.arange(S, device=dev)[None, :], idx]
    return torch.where(_sub_valid(lengths, sub_lengths)[..., None], out, 0.0)


def expand_to_sequence(x: torch.Tensor, lengths: torch.Tensor,
                       max_len: int) -> torch.Tensor:
    """Each row's vector repeated over the steps of a sequence: [B, D] ->
    [B, T, D], zero past each row's length."""
    mask = length_mask(lengths, max_len, x.dtype)[..., None]
    return x[:, None, :].expand(x.shape[0], max_len, x.shape[1]) * mask


def seq_concat(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
               lb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two sequence batches joined along time: [B, Ta, D] and [B, Tb, D] ->
    [B, Ta + Tb, D], b's valid steps right after a's, lengths la + lb."""
    B, Ta, D = a.shape
    Tb = b.shape[1]
    T = Ta + Tb
    padded_a = torch.nn.functional.pad(a, (0, 0, 0, Tb)) \
        * length_mask(la, T, a.dtype)[..., None]
    t = torch.arange(T, device=a.device)[None, :]
    src = t - la.long()[:, None]
    valid = (src >= 0) & (src < lb.long()[:, None])
    idx = torch.where(valid, src, 0)
    gathered = torch.gather(torch.nn.functional.pad(b, (0, 0, 0, Ta)), 1,
                            idx[..., None].expand(B, T, D))
    return padded_a + torch.where(valid[..., None], gathered, 0.0), la + lb


def seq_reshape(x: torch.Tensor, lengths: torch.Tensor,
                new_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's token stream at another feature width: [B, T, D] ->
    [B, T*D // new_dim, new_dim], lengths * D // new_dim."""
    B, T, D = x.shape
    if (T * D) % new_dim:
        raise ValueError(f"seq_reshape: T*D = {T * D} is not a multiple of "
                         f"{new_dim}")
    return (x.reshape(B, T * D // new_dim, new_dim),
            lengths * D // new_dim)


def sub_sequence(x: torch.Tensor, offsets: torch.Tensor,
                 sizes: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's slice [offset, offset + size) along time, at the front of
    a [B, T, ...] output, zero after it; the size clamped to
    max(0, min(size, length - offset)) (the reference stops on a slice
    out of range; the JAX op clamps, and so does this one)."""
    B, T = x.shape[0], x.shape[1]
    offsets, sizes = offsets.long(), sizes.long()
    bound = lengths.long() if lengths is not None \
        else torch.full_like(offsets, T)
    sizes = torch.minimum(sizes, bound - offsets).clamp(0, T)
    t = torch.arange(T, device=x.device)[None, :]
    valid = t < sizes[:, None]
    idx = torch.where(valid, (offsets[:, None] + t).clamp(max=T - 1), 0)
    tail = (1,) * (x.dim() - 2)
    out = torch.gather(x, 1, idx.reshape(B, T, *tail).expand(x.shape))
    return (torch.where(valid.reshape(B, T, *tail), out, 0.0),
            sizes.to(torch.int32))


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
