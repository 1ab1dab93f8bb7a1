"""Sampled output costs: NCE and the hierarchical sigmoid — the
counterparts of paddle_tpu/ops/sampling.py (ref: NCELayer.cpp,
MultinomialSampler.cpp, MatrixBitCode.cpp).  NCE's negatives are drawn by
`categorical` from the port's threefry (utils/prng.py), the same ids the
JAX package draws for the same key; the bit-code path walk is vectorized
over the class id's bits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.utils import prng

_EPS = 1e-10


def nce_cost(rng: torch.Tensor, feats: list[torch.Tensor],
             labels: torch.Tensor, ws: list[torch.Tensor],
             b: Optional[torch.Tensor], num_classes: int, num_neg: int,
             dist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary-logistic NCE cost [B] with `num_neg` negatives per row drawn
    from `dist` (uniform when None), logits summed over the feature inputs
    ([B, D_i] each, class matrices [C, D_i]), each corrected by
    log(num_neg * Pn(class))."""
    B = feats[0].shape[0]
    dev = feats[0].device
    if dist is None:
        logdist = torch.zeros(num_classes, device=dev)
        p_noise = torch.full((num_classes,), 1.0 / num_classes, device=dev)
    else:
        logdist = torch.log(torch.clamp(dist, min=_EPS))
        p_noise = dist
    neg = prng.categorical(rng, logdist, shape=(B, num_neg))
    if b is not None:
        b = b.reshape(-1)
    labels = labels.long()

    def logit(ids):                       # [B, K] -> [B, K]
        z = None
        for feat, w in zip(feats, ws):
            zi = torch.einsum("bkd,bd->bk", w[ids], feat)
            z = zi if z is None else z + zi
        return z if b is None else z + b[ids]

    pos_z = logit(labels[:, None])
    neg_z = logit(neg)
    pos_corr = torch.log(num_neg * torch.clamp(p_noise[labels[:, None]],
                                               min=_EPS))
    neg_corr = torch.log(num_neg * torch.clamp(p_noise[neg], min=_EPS))
    pos_cost = F.softplus(-(pos_z - pos_corr))[:, 0]
    neg_cost = torch.sum(F.softplus(neg_z - neg_corr), dim=1)
    return pos_cost + neg_cost


def _bit_codes(labels: torch.Tensor, num_bits: int):
    """The complete-binary-tree code of each class id (the reference's
    SimpleCode: code = c + 1, the node at depth j code >> (j + 1) - 1, its
    bit (code >> j) & 1) -> (nodes, bits) [B, num_bits], bit -1 past the
    root."""
    code = labels.long() + 1
    j = torch.arange(num_bits, device=labels.device)
    nodes = (code[:, None] >> (j + 1)[None, :]) - 1
    bits = (code[:, None] >> j[None, :]) & 1
    valid = nodes >= 0
    return torch.clamp(nodes, min=0), torch.where(valid, bits,
                                                  torch.full_like(bits, -1))


def hsigmoid_cost(feats: list[torch.Tensor], labels: torch.Tensor,
                  ws: list[torch.Tensor], b: Optional[torch.Tensor],
                  num_classes: int) -> torch.Tensor:
    """The sum over the code's bits of the binary logistic cost [B]; the
    inner-node weights [num_classes - 1, D_i], the bias [1, C - 1]."""
    num_bits = max(1, (num_classes - 1).bit_length())
    nodes, bits = _bit_codes(labels, num_bits)
    z = None
    for feat, w in zip(feats, ws):
        zi = torch.einsum("bnd,bd->bn", w[nodes], feat)
        z = zi if z is None else z + zi
    if b is not None:
        z = z + b.reshape(-1)[nodes]
    t = torch.clamp(bits, min=0).to(z.dtype)
    cost_bits = F.softplus(z) - t * z
    return torch.sum(torch.where(bits >= 0, cost_bits,
                                 torch.zeros_like(cost_bits)), dim=1)
