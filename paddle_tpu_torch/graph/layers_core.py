"""Core layers: data, fc, mixed (table, full-matrix and identity
projections), addto, concat — the counterparts of
paddle_tpu/graph/layers_core.py."""

from __future__ import annotations

import torch

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.parameter.argument import Argument


@register_layer("data")
def data_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Input placeholder — the feed supplies its value."""
    raise AssertionError("data layers are fed, not computed")


@register_layer("fc")
def fc_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Fully connected: sum_i x_i @ W_i + b, then the activation."""
    inputs = ctx.get_inputs(cfg)
    acc = None
    for i, arg in enumerate(inputs):
        y = torch.matmul(arg.value, ctx.param_of(cfg, i))
        acc = y if acc is None else acc + y
    b = ctx.bias_of(cfg)
    if b is not None:
        acc = acc + b
    return finish_layer(ctx, cfg, acc, like=inputs[0])


@register_layer("mixed")
def mixed_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Sum of per-input projections plus bias.  Ported projections:
    `table` (embedding lookup), `fc` / `full_matrix` (x @ W) and
    `identity`; the others and the mixed operators are queued in
    ROADMAP.md."""
    if cfg.operators:
        raise NotImplementedError(
            f"layer {cfg.name!r}: mixed-layer operators are not ported yet "
            f"(ROADMAP.md)")
    inputs = ctx.get_inputs(cfg)
    acc = None
    like = inputs[0] if inputs else None
    for i, (inp, arg) in enumerate(zip(cfg.inputs, inputs)):
        if inp.proj is None:
            continue
        if inp.proj.type == "table":
            y = ctx.param_of(cfg, i)[arg.ids]
        elif inp.proj.type in ("fc", "full_matrix"):
            y = torch.matmul(arg.value, ctx.param_of(cfg, i))
        elif inp.proj.type == "identity":
            y = arg.data
        else:
            raise NotImplementedError(
                f"layer {cfg.name!r}: projection {inp.proj.type!r} is not "
                f"ported yet (ROADMAP.md)")
        if arg.is_sequence and (like is None or not like.is_sequence):
            like = arg
        acc = y if acc is None else acc + y
    b = ctx.bias_of(cfg)
    if b is not None:
        acc = acc + b
    lengths = like.lengths if (like is not None and acc.dim() >= 3) else None
    return finish_layer(ctx, cfg, acc, like=like, lengths=lengths)


@register_layer("addto")
def addto_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Elementwise sum of all inputs + bias."""
    inputs = ctx.get_inputs(cfg)
    acc = inputs[0].value
    for arg in inputs[1:]:
        acc = acc + arg.value
    b = ctx.bias_of(cfg)
    if b is not None:
        acc = acc + b
    return finish_layer(ctx, cfg, acc, like=inputs[0])


@register_layer("concat")
def concat_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Feature-dim concatenation of the inputs."""
    inputs = ctx.get_inputs(cfg)
    acc = torch.cat([a.value for a in inputs], dim=-1)
    return finish_layer(ctx, cfg, acc, like=inputs[0])
