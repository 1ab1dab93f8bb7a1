"""Cost layers — the counterpart of paddle_tpu/graph/layers_cost.py.

Each cost layer records its per-sample [B] cost vector (times `coeff`, and
times the optional weight input) in ctx.costs; GraphExecutor.loss sums the
batch means into the scalar that autograd differentiates.  The slice ports
`multi-class-cross-entropy`, the classification cost of the transformer
LM; the other cost layers are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

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
