"""Cost layers — the counterpart of paddle_tpu/graph/layers_cost.py.

Each cost layer records its per-sample [B] cost vector (times `coeff`, and
times the optional weight input) in ctx.costs; GraphExecutor.loss sums the
batch means into the scalar that autograd differentiates.  Every cost type
of the JAX module is here: multi-class cross-entropy (plain and
self-normalized), soft-binary and multi-binary-label cross-entropy, the
square error, the pairwise rank cost, the two-class huber cost, the sum
cost and the LambdaRank surrogate.  The validation layers
(`auc-validation`, `pnpair-validation`) are queued in ROADMAP.md with
their evaluators; `crf` is in layers_seq.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.parameter.argument import Argument

_EPS = 1e-10


def _record(ctx: ForwardContext, cfg: LayerConfig,
            cost: torch.Tensor) -> Argument:
    """Register the per-sample cost; the optional weight input is the 3rd
    input (its value, or its ids)."""
    if len(cfg.inputs) > 2:
        w = ctx.get_input(cfg, 2)
        cost = cost * (w.value.reshape(cost.shape) if w.value is not None
                       else w.ids)
    ctx.costs[cfg.name] = cfg.coeff * cost
    return Argument(value=cost[:, None])


@register_layer("multi-class-cross-entropy")
def multi_class_cross_entropy(ctx: ForwardContext,
                              cfg: LayerConfig) -> Argument:
    """-log p[label] of an input that is already a probability distribution
    (the previous layer's softmax): gather, then log(max(p, 1e-10)), summed
    over the valid steps of a sequence."""
    out, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    probs = out.value
    picked_p = torch.gather(probs, -1, lbl.ids.long()[..., None])[..., 0]
    picked = torch.log(torch.clamp(picked_p, min=_EPS))
    if out.is_sequence:
        cost = -torch.sum(picked * out.mask(probs.dtype), dim=-1)
    else:
        cost = -picked
    return _record(ctx, cfg, cost)


@register_layer("multi_class_cross_entropy_with_selfnorm")
def selfnorm_cross_entropy(ctx: ForwardContext,
                           cfg: LayerConfig) -> Argument:
    """Cross-entropy of the input renormalized by its sum Z, plus
    alpha * log(Z)^2."""
    out, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    probs = out.value
    z = torch.sum(probs, dim=-1)
    probs_n = probs / torch.clamp(z[..., None], min=_EPS)
    picked = torch.gather(torch.log(torch.clamp(probs_n, min=_EPS)), -1,
                          lbl.ids.long()[..., None])[..., 0]
    cost = -picked + cfg.softmax_selfnorm_alpha * torch.square(
        torch.log(torch.clamp(z, min=_EPS)))
    return _record(ctx, cfg, cost)


def _binary_cross_entropy(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """-sum t log(p) + (1 - t) log(1 - p) over the last dim, p clipped to
    [1e-10, 1 - 1e-10], t the label's dense value."""
    out, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    p = torch.clamp(out.value, _EPS, 1.0 - _EPS)
    t = lbl.value
    cost = -torch.sum(t * torch.log(p) + (1.0 - t) * torch.log1p(-p), dim=-1)
    return _record(ctx, cfg, cost)


register_layer("soft_binary_class_cross_entropy",
               "multi_binary_label_cross_entropy")(_binary_cross_entropy)


@register_layer("square_error")
def square_error(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """0.5 * ||out - label||^2, summed over the valid steps of a
    sequence."""
    out, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    d = out.value - lbl.value
    sq = torch.sum(torch.square(d), dim=-1)
    if out.is_sequence:
        cost = 0.5 * torch.sum(sq * out.mask(d.dtype), dim=-1)
    else:
        cost = 0.5 * sq
    return _record(ctx, cfg, cost)


@register_layer("rank-cost")
def rank_cost(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Pairwise ranking: -t o + log(1 + exp(o)), o = s_a - s_b; the third
    input is the label t (its value, or its ids), not a weight."""
    a, b = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    lbl = ctx.get_input(cfg, 2)
    o = (a.value - b.value)[..., 0]
    t = lbl.value[..., 0] if lbl.value is not None else lbl.ids.to(o.dtype)
    cost = -t * o + F.softplus(o)
    ctx.costs[cfg.name] = cfg.coeff * cost
    return Argument(value=cost[:, None])


@register_layer("huber_classification", "huber")
def huber_two_class(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Two-class huber cost of a scalar score, labels {0, 1} taken as
    y in {-1, 1}: -4a for a = y s < -1, (1 - a)^2 below 1, else 0."""
    out, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    score = out.value[..., 0]
    y = 2.0 * lbl.ids.to(score.dtype) - 1.0
    a = y * score
    cost = torch.where(a < -1.0, -4.0 * a, torch.where(
        a < 1.0, torch.square(1.0 - a), torch.zeros_like(a)))
    return _record(ctx, cfg, cost)


@register_layer("sum_cost")
def sum_cost(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The input's values summed (over the valid steps of a sequence)."""
    out = ctx.get_input(cfg, 0)
    row = torch.sum(out.value, dim=-1)
    if out.is_sequence:
        cost = torch.sum(row * out.mask(out.value.dtype), dim=-1)
    else:
        cost = row
    ctx.costs[cfg.name] = cfg.coeff * cost
    return Argument(value=cost[:, None])


@register_layer("lambda_cost")
def lambda_cost(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The LambdaRank surrogate over each list (a sequence of scalar
    scores): for each valid pair (i, j) with relevance r_i > r_j, the
    logistic loss softplus(s_j - s_i) weighted by |r_i - r_j|."""
    out, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    s = out.value[..., 0]
    r = lbl.value[..., 0]
    mask = out.mask(s.dtype)
    pair_valid = mask[:, :, None] * mask[:, None, :]
    sdiff = s[:, :, None] - s[:, None, :]
    rdiff = r[:, :, None] - r[:, None, :]
    better = (rdiff > 0).to(s.dtype)
    pair_cost = F.softplus(-sdiff) * better * torch.abs(rdiff) * pair_valid
    return _record(ctx, cfg, torch.sum(pair_cost, dim=(1, 2)))
