"""The mixture-of-experts layer — the counterpart of
paddle_tpu/graph/layers_moe.py.  Its five parameters (router, w1, b1, w2,
b2) ride five LayerInputs that all name the one data input; the
load-balancing aux loss goes into ctx.costs like a cost layer's, scaled by
attrs['aux_weight'], in training only."""

from __future__ import annotations

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.parallel.moe import moe_ffn
from paddle_tpu_torch.parameter.argument import Argument


@register_layer("moe")
def moe_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Routes each row (each valid token of a sequence; padding is never
    routed) through `moe_ffn`."""
    x = ctx.get_input(cfg, 0)
    w_router, w1, b1, w2, b2 = (ctx.param_of(cfg, i) for i in range(5))
    top_k = int(cfg.attrs.get("top_k", 2))
    cap = float(cfg.attrs.get("capacity_factor", 1.25))
    aux_w = float(cfg.attrs.get("aux_weight", 0.01))
    v = x.value
    seq_shape, valid = None, None
    if v.dim() == 3:
        seq_shape = v.shape[:2]
        v = v.reshape(-1, v.shape[-1])
        mask = x.mask()
        if mask is not None:
            valid = mask.reshape(-1)
    y, aux = moe_ffn(v, w_router, w1, b1, w2, b2, top_k=top_k,
                     capacity_factor=cap, valid=valid)
    if seq_shape is not None:
        y = y.reshape(tuple(seq_shape) + (y.shape[-1],))
    if aux_w > 0 and ctx.is_training:
        # per sample, so the executor's mean leaves aux_w * aux
        ctx.costs[f"{cfg.name}.aux"] = (aux_w * aux).expand(
            x.data.shape[0])
    return finish_layer(ctx, cfg, y, like=x)
