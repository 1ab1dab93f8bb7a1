"""Mixture-of-experts FFN on one device — the counterpart of
paddle_tpu/parallel/moe.py's `moe_routing` and `moe_ffn`.

Switch/GShard-style capacity routing as dense einsums: tokens go top-k to
E experts with a per-expert capacity C; routing builds a one-hot dispatch
[B, E, C] and a probability-weighted combine tensor, the stacked expert
FFNs run batched over E, and the combine scatters their outputs back to
token order.  Tokens over capacity are dropped (combine weight zero).  The
reference's expert sharding (`expert_partition_specs`, the all-to-all over
a mesh) is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows of `idx` over n classes; an index outside [0, n)
    gives a zero row (jax.nn.one_hot's rule)."""
    return (idx.long()[:, None] == torch.arange(n, device=idx.device)[None]
            ).to(torch.float32)


def moe_routing(gate_logits: torch.Tensor, top_k: int, capacity: int,
                valid: Optional[torch.Tensor] = None):
    """(dispatch [B, E, C] one-hot, combine [B, E, C] probability-weighted,
    aux_loss scalar) from router logits [B, E].  Capacity is shared over the
    k rounds; padding tokens (`valid` False) are never routed; a round with
    no probability mass left dispatches nothing.  aux_loss is Shazeer et
    al.'s load-balancing loss over the valid tokens' first choices."""
    B, E = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    vmask = torch.ones(B, device=dev) if valid is None else valid.float()
    dispatch = torch.zeros((B, E, capacity), device=dev)
    combine = torch.zeros((B, E, capacity), device=dev)
    remaining = probs
    fill = torch.zeros(E, dtype=torch.int64, device=dev)
    total_gate = torch.zeros(B, device=dev)
    picks = []
    for _ in range(top_k):
        onehot = _one_hot(torch.argmax(remaining, dim=-1), E)
        onehot = onehot * vmask[:, None]
        onehot = onehot * (torch.sum(remaining, -1, keepdim=True) > 0)
        picks.append(onehot)
        gate = torch.sum(probs * onehot, dim=-1)
        pos = (torch.cumsum(onehot, dim=0) - 1.0) + fill[None, :].float()
        pos_tok = torch.sum(pos * onehot, dim=-1)
        keep = pos_tok < capacity
        slot = _one_hot(pos_tok.to(torch.int32), capacity)
        d = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        total_gate = total_gate + gate * keep
        fill = fill + torch.sum(onehot * keep[:, None], dim=0).long()
        remaining = remaining * (1.0 - onehot)
    if top_k > 1:
        combine = combine / torch.clamp(total_gate, min=1e-9)[:, None, None]
    n_valid = torch.clamp(torch.sum(vmask), min=1.0)
    frac_tokens = torch.sum(picks[0], dim=0) / n_valid
    mean_prob = torch.sum(probs * vmask[:, None], dim=0) / n_valid
    aux_loss = E * torch.sum(frac_tokens * mean_prob)
    return dispatch, combine, aux_loss


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w1: torch.Tensor,
            b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            top_k: int = 2, capacity_factor: float = 1.25,
            valid: Optional[torch.Tensor] = None):
    """The MoE FFN block on tokens x [B, D] with the router [D, E] and the
    stacked experts w1 [E, D, H], b1 [E, H], w2 [E, H, D_out], b2 [E, D_out]
    (relu between) -> (y [B, D_out], aux_loss)."""
    B = x.shape[0]
    E = w1.shape[0]
    capacity = max(1, int(top_k * B * capacity_factor / E))
    logits = x.float() @ w_router.float()
    dispatch, combine, aux = moe_routing(logits, top_k, capacity,
                                         valid=valid)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    expert_in = torch.einsum("bd,bec->ecd", x, dispatch)
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w1)
                   + b1[:, None, :])
    expert_out = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    return torch.einsum("ecd,bec->bd", expert_out, combine), aux
