"""The elementwise and combination layer zoo — the counterpart of
paddle_tpu/graph/layers_misc.py, layer for layer: scaling,
slope_intercept, interpolation, power, convex_comb / linear_comb, cos,
cos_vm, out_prod, tensor, multiplex, trans, resize, featmap_expand, prelu,
conv_shift, print, selective_fc and layer_norm (the reference's
{Scaling,SlopeIntercept,Interpolation,Power,ConvexCombination,CosSim,
CosSimVecMat,OuterProd,Tensor,Multiplex,Trans,Resize,FeatureMapExpand,
ParameterRelu,ConvShift,Print,SelectiveFullyConnected}Layer.cpp)."""

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


@register_layer("scaling")
def scaling_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Row-wise scale: out[i] = w[i] * x[i]; input 0 the weights [B, 1],
    input 1 x."""
    w, x = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    return finish_layer(ctx, cfg, x.value * w.value, like=x)


@register_layer("slope_intercept")
def slope_intercept_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """out = slope * x + intercept."""
    x = ctx.get_input(cfg, 0)
    slope = cfg.attrs.get("slope", 1.0)
    intercept = cfg.attrs.get("intercept", 0.0)
    return finish_layer(ctx, cfg, slope * x.value + intercept, like=x)


@register_layer("interpolation")
def interpolation_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """out = w * x1 + (1 - w) * x2 with a [B, 1] weight per row."""
    w, a, b = (ctx.get_input(cfg, i) for i in range(3))
    out = w.value * a.value + (1.0 - w.value) * b.value
    return finish_layer(ctx, cfg, out, like=a)


@register_layer("power")
def power_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """out = x ** w with a [B, 1] exponent per row."""
    w, x = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    return finish_layer(ctx, cfg, torch.pow(x.value, w.value), like=x)


@register_layer("convex_comb", "linear_comb")
def linear_comb_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Per sample, the weights row [M] times the [M, D] matrix of input 1's
    row: [B, M] and [B, M * D] -> [B, D]."""
    w, x = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    B, M = w.value.shape
    xv = x.value.reshape(B, M, cfg.size)
    return finish_layer(ctx, cfg, torch.einsum("bm,bmd->bd", w.value, xv))


@register_layer("cos_vm")
def cos_sim_vecmat_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The cosine of a vector with each row of a per-sample matrix, times
    `cos_scale`: [B, D] and [B, M * D] -> [B, M]."""
    v, m = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    scale = cfg.attrs.get("cos_scale", 1.0)
    B, D = v.value.shape
    mv = m.value.reshape(B, cfg.size, D)
    num = torch.einsum("bmd,bd->bm", mv, v.value)
    den = torch.sqrt(torch.sum(torch.square(mv), dim=-1)
                     * torch.sum(torch.square(v.value), dim=-1,
                                 keepdim=True))
    return finish_layer(ctx, cfg, scale * num / torch.clamp(den, min=1e-8))


@register_layer("out_prod")
def outer_prod_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The flattened outer product of two vectors per row."""
    a, b = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    out = torch.einsum("bi,bj->bij", a.value, b.value)
    return finish_layer(ctx, cfg, out.reshape(out.shape[0], -1))


@register_layer("tensor")
def tensor_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Bilinear product out_k = x1 W_k x2^T, the parameter [D1, K * D2]."""
    a, b = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    w3 = ctx.param_of(cfg, 0).reshape(a.value.shape[-1], cfg.size,
                                      b.value.shape[-1])
    out = torch.einsum("bi,ikj,bj->bk", a.value, w3, b.value)
    bb = ctx.bias_of(cfg)
    if bb is not None:
        out = out + bb
    return finish_layer(ctx, cfg, out)


@register_layer("multiplex")
def multiplex_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Row b of input 1 + ids[b] of input 0 (the selector's ids)."""
    sel = ctx.get_input(cfg, 0)
    stacked = torch.stack([ctx.get_input(cfg, i).value
                           for i in range(1, len(cfg.inputs))], dim=1)
    idx = sel.ids.long()[:, None, None].expand(-1, 1, stacked.shape[-1])
    return finish_layer(ctx, cfg, torch.gather(stacked, 1, idx)[:, 0])


@register_layer("trans")
def trans_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The (batch x dim) matrix transposed."""
    return finish_layer(ctx, cfg, ctx.get_input(cfg, 0).value.T)


@register_layer("resize")
def resize_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The batch's values read as rows of `size`."""
    return finish_layer(ctx, cfg,
                        ctx.get_input(cfg, 0).value.reshape(-1, cfg.size))


@register_layer("featmap_expand")
def featmap_expand_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The features tiled `num_filters` times."""
    x = ctx.get_input(cfg, 0)
    out = x.value[:, None, :].repeat_interleave(cfg.num_filters, dim=1)
    return finish_layer(ctx, cfg, out.reshape(x.value.shape[0], -1), like=x)


@register_layer("prelu")
def parameter_relu_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Parametric ReLU, each slope shared by D / w.numel() consecutive
    dims."""
    x = ctx.get_input(cfg, 0)
    w = ctx.param_of(cfg, 0)
    slopes = w.reshape(-1).repeat_interleave(x.value.shape[-1] // w.numel())
    out = torch.where(x.value > 0, x.value, x.value * slopes)
    return finish_layer(ctx, cfg, out, like=x)


@register_layer("conv_shift")
def conv_shift_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Circular correlation of each row of a with the odd-length kernel b:
    out[i] = sum_j b[j] * a[(i + j - M // 2) mod D]."""
    a, b = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    M = b.value.shape[-1]
    out = torch.zeros_like(a.value)
    for j in range(M):
        out = out + b.value[:, j:j + 1] * torch.roll(a.value, M // 2 - j,
                                                     dims=-1)
    return finish_layer(ctx, cfg, out, like=a)


@register_layer("print")
def print_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Prints its input (a host read) and passes it on."""
    x = ctx.get_input(cfg, 0)
    print(f"print layer {cfg.name}: {x.data}")
    return x


@register_layer("selective_fc")
def selective_fc_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """A full fc over every class; with a selection input (the last), the
    unselected logits are -1e9 before a softmax (so they get ~zero
    probability), else multiplied by the selection."""
    inputs = ctx.get_inputs(cfg)
    has_sel = cfg.attrs.get("has_selected_colums", False)
    feats = inputs[:-1] if has_sel else inputs
    acc = None
    for i, arg in enumerate(feats):
        w = ctx.param_of(cfg, i)
        y = arg.value @ (w.T if w.shape[0] == cfg.size else w)
        acc = y if acc is None else acc + y
    b = ctx.bias_of(cfg)
    if b is not None:
        acc = acc + b
    if has_sel:
        sel = inputs[-1].value
        acc = torch.where(sel > 0, acc, torch.full_like(acc, -1e9)) \
            if cfg.active_type == "softmax" else acc * sel
    return finish_layer(ctx, cfg, acc, like=feats[0])
