"""Linear-chain CRF: the negative log-likelihood and Viterbi decoding — the
counterpart of paddle_tpu/ops/crf.py.

The parameter w is [C + 2, C]: w[0] the start potentials, w[1] the end
potentials, w[2:] the transitions (trans[i, j] scores the previous tag i
followed by the tag j).  x is [B, T, C] emission scores on the padded time
axis, `lengths` [B] each row's valid prefix.  The recursions are loops
over T on [B, C] / [B, C, C] tensors; the likelihood is differentiated by
autograd, as the reference's by autodiff.

The gold path's score picks its emissions, start, end and transition
scores through one-hot products rather than index gathers: the values are
the same (a product with a one-hot row adds exact zeros), and the backward
is a product too, which adds in a fixed order (an indexed gather's
backward accumulates colliding rows in an order the threads choose).
"""

from __future__ import annotations

import torch


def _split(w: torch.Tensor):
    return w[0], w[1], w[2:]


def _valid(t: int, lengths: torch.Tensor) -> torch.Tensor:
    return (t < lengths.long())[:, None]


def crf_log_z(x: torch.Tensor, lengths: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """The log partition by the alpha recursion (a logsumexp over the
    previous tag), frozen past each row's length: [B]."""
    a, b, trans = _split(w)
    alpha = a[None, :] + x[:, 0]
    for t in range(1, x.shape[1]):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + x[:, t]
        alpha = torch.where(_valid(t, lengths), new, alpha)
    return torch.logsumexp(alpha + b[None, :], dim=-1)


def crf_path_score(x: torch.Tensor, labels: torch.Tensor,
                   lengths: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gold path's score: its emissions and transitions over the valid
    steps, its start and its end potential: [B].  Labels at padded
    positions do not reach the score."""
    a, b, trans = _split(w)
    B, T, C = x.shape
    mask = (torch.arange(T, device=x.device)[None, :]
            < lengths.long()[:, None]).to(x.dtype)
    tags = torch.arange(C, device=x.device)
    onehot = (labels.long()[..., None] == tags).to(x.dtype)   # [B, T, C]
    score = torch.sum(torch.sum(x * onehot, dim=-1) * mask, dim=1)
    score = score + onehot[:, 0] @ a
    last = (lengths.long() - 1).clamp(min=0)
    score = score + onehot[torch.arange(B, device=x.device), last] @ b
    pair = torch.sum((onehot[:, :-1] @ trans) * onehot[:, 1:], dim=-1)
    return score + torch.sum(pair * mask[:, 1:], dim=1)


def crf_nll(x: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """Each sequence's negative log-likelihood: [B]."""
    return crf_log_z(x, lengths, w) - crf_path_score(x, labels, lengths, w)


@torch.no_grad()
def crf_decode(x: torch.Tensor, lengths: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """The Viterbi path: [B, T] int64 tags.  Ties go to the first maximal
    tag (torch.argmax, as jnp.argmax); past a row's length the
    back-pointers point to themselves, so the path repeats the row's last
    tag there, and a row of length 1 takes no transition."""
    a, b, trans = _split(w)
    B, T, C = x.shape
    alpha = a[None, :] + x[:, 0]
    self_ptr = torch.arange(C, device=x.device)[None, :]
    pointers = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None]               # [B, C, C]
        best = torch.argmax(scores, dim=1)
        new = torch.amax(scores, dim=1) + x[:, t]
        valid = _valid(t, lengths)
        alpha = torch.where(valid, new, alpha)
        pointers.append(torch.where(valid, best, self_ptr))
    tag = torch.argmax(alpha + b[None, :], dim=-1)
    path = [tag]
    for bp in reversed(pointers):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1)
