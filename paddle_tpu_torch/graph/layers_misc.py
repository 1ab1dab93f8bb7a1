"""layer_norm and cos — the counterparts of paddle_tpu/graph/layers_misc.py's
layer_norm_layer and cos_sim_layer; the rest of that module is queued in
ROADMAP.md."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.utils.dtypes import promote_compute


@register_layer("layer_norm")
def layer_norm_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Last-dim layer normalization with learned [1, D] scale and bias.
    Statistics in float32 (float64 input, the gradient check's float64
    pass on the CPU, in float64) with the population variance and
    rsqrt(var + 1e-6) — not F.layer_norm's default 1e-5 — and the result
    cast back to the input dtype.

    The statistics come from F.layer_norm's kernel, a block per row on the
    card: a row's result does not depend on how many rows the call holds.
    The generic mean / var reductions pick their thread layout by the
    number of rows, and their sums' order with it, so the serving engine's
    decode step ([S, 1]) and mixed step ([1, T]) normalized the same row
    to bfloat16 results 1 ulp apart now and then, and a served token
    could follow the schedule."""
    x = ctx.get_input(cfg, 0)
    v32 = promote_compute(x.value)
    normed = F.layer_norm(v32, v32.shape[-1:], eps=1e-6)
    scale = ctx.param_of(cfg, 0)
    if scale is not None:
        normed = normed * scale.to(v32.dtype).reshape(-1)
    b = ctx.bias_of(cfg)
    if b is not None:
        normed = normed + b.to(v32.dtype).reshape(-1)
    return finish_layer(ctx, cfg, normed.to(x.value.dtype), like=x)


@register_layer("cos")
def cos_sim_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Cosine similarity of two inputs along the last dim, times the
    layer's `cos_scale` (1 by default); the norms' product is held at
    least 1e-8."""
    a, b = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    scale = cfg.attrs.get("cos_scale", 1.0)
    num = torch.sum(a.value * b.value, dim=-1)
    den = torch.sqrt(torch.sum(torch.square(a.value), dim=-1)
                     * torch.sum(torch.square(b.value), dim=-1))
    out = scale * num / torch.clamp(den, min=1e-8)
    return finish_layer(ctx, cfg, out[..., None], like=a)
