"""CTC loss by the alpha recursion over the extended label sequence — the
counterpart of paddle_tpu/ops/ctc.py (ref: CTCLayer.cpp,
LinearChainCTC.cpp): batched and masked over time in log space, a step per
time index, with autograd giving the gradient the reference derives by the
beta recursion.  Takes padded [B, T, C] probabilities (the softmax output)
and the reference's -1e30 stand-in for log 0, so an impossible labelling
costs ~1e30 as on the JAX side.  Plain torch ops: deterministic on the
card, where F.ctc_loss's backward is not.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def ctc_loss(probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0, norm_by_times: bool = False) -> torch.Tensor:
    """Per-sequence -log p(labels | probs): probs [B, T, C], labels [B, L]
    padded, the lengths [B] -> [B]."""
    logp = torch.log(torch.clamp(probs, min=1e-10))
    B, T, C = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logp.device
    labels = labels.long()
    label_lengths = label_lengths.long()
    # blank, l1, blank, l2, ..., blank
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    s_idx = torch.arange(S, device=dev)[None, :]
    ext_valid = s_idx < (2 * label_lengths + 1)[:, None]
    # a step from s-2 to s where ext[s] is a label unlike ext[s-2]
    ext_prev2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                      device=dev), ext[:, :-2]], dim=1)
    can_skip = (s_idx % 2 == 1) & (ext != ext_prev2)
    neg = torch.full((B, 2), _NEG, dtype=logp.dtype, device=dev)

    def emit(t):
        return torch.gather(logp[:, t], 1, ext)

    e0 = emit(0)
    alpha = torch.full((B, S), _NEG, dtype=logp.dtype, device=dev)
    alpha[:, 0] = e0[:, 0]
    alpha[:, 1] = torch.where(label_lengths > 0, e0[:, 1], neg[:, 0])
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, alpha[:, :-2]], dim=1)
        prev2 = torch.where(can_skip, prev2, neg[:, :1])
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = torch.where(ext_valid, merged + emit(t), neg[:, :1])
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    s_last = 2 * label_lengths
    a_blank = torch.gather(alpha, 1, s_last[:, None])[:, 0]
    a_lbl = torch.gather(alpha, 1,
                         torch.clamp(s_last - 1, min=0)[:, None])[:, 0]
    a_lbl = torch.where(label_lengths > 0, a_lbl, neg[:, 0])
    cost = -torch.logaddexp(a_blank, a_lbl)
    if norm_by_times:
        cost = cost / torch.clamp(input_lengths.to(cost.dtype), min=1.0)
    return cost
