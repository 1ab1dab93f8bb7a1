"""Core layers: data, fc, mixed (table, full-matrix, identity and conv
projections, the conv and dot-mul operators), addto, concat — the
counterparts of paddle_tpu/graph/layers_core.py."""

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


def _apply_operator(op, inputs: list[Argument]) -> torch.Tensor:
    a, b = (inputs[i] for i in op.input_indices[:2])
    if op.type == "dot_mul":
        return op.dotmul_scale * a.value * b.value
    if op.type == "conv":
        from paddle_tpu_torch.graph.layers_conv import conv_operator_forward
        return conv_operator_forward(op, a, b)
    raise NotImplementedError(f"operator type {op.type!r} is not ported yet "
                              f"(ROADMAP.md)")


@register_layer("mixed")
def mixed_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Sum of per-input projections and operators plus bias.  Ported
    projections: `table` (embedding lookup), `fc` / `full_matrix`
    (x @ W), `identity` and `conv`; operators: `dot_mul` and `conv` (a
    filter per sample from a layer output).  The other projections are
    queued in ROADMAP.md."""
    inputs = ctx.get_inputs(cfg)
    acc = None
    like = inputs[0] if inputs else None
    for i, (inp, arg) in enumerate(zip(cfg.inputs, inputs)):
        if inp.proj is None:
            continue
        if inp.proj.type == "table":
            # F.embedding, not W[ids]: the gather's backward as an index_put
            # accumulates in a thread-dependent order on the CPU, and two
            # runs of one step would differ in the table's gradient
            y = torch.nn.functional.embedding(arg.ids, ctx.param_of(cfg, i))
        elif inp.proj.type in ("fc", "full_matrix"):
            y = torch.matmul(arg.value, ctx.param_of(cfg, i))
        elif inp.proj.type == "identity":
            y = arg.data
        elif inp.proj.type == "conv":
            from paddle_tpu_torch.graph.layers_conv import \
                conv_projection_forward
            y = conv_projection_forward(inp.proj, arg, ctx.param_of(cfg, i))
        else:
            raise NotImplementedError(
                f"layer {cfg.name!r}: projection {inp.proj.type!r} is not "
                f"ported yet (ROADMAP.md)")
        if arg.is_sequence and (like is None or not like.is_sequence):
            like = arg
        acc = y if acc is None else acc + y
    for op in cfg.operators:
        y = _apply_operator(op, inputs)
        acc = y if acc is None else acc + y
    b = ctx.bias_of(cfg)
    if b is not None:
        acc = acc + b
    lengths = like.lengths if (like is not None and acc.dim() >= 3) else None
    return finish_layer(ctx, cfg, acc, like=like, lengths=lengths)


@register_layer("addto")
def addto_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Elementwise sum of all inputs + bias.  Images of one shape (ResNet's
    shortcut sums) are summed as images, the bias's flat C-major row viewed
    as [C, H, W], and the output stays an image: the same values as the
    flat sum, without a round trip through the rows.  A layer with dropout
    (dropout_layer) works on the rows, where the JAX package draws its
    keep-mask."""
    raw = [ctx.get_raw_input(cfg, i) for i in range(len(cfg.inputs))]
    image = cfg.drop_rate <= 0.0 and all(
        a.image and a.value.shape == raw[0].value.shape for a in raw)
    inputs = raw if image else [a.flatten_image() for a in raw]
    acc = inputs[0].value
    for arg in inputs[1:]:
        acc = acc + arg.value
    b = ctx.bias_of(cfg)
    if b is not None:
        acc = acc + (b.reshape((1,) + tuple(acc.shape[1:])) if image else b)
    return finish_layer(ctx, cfg, acc, like=inputs[0], image=image)


@register_layer("concat")
def concat_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Feature-dim concatenation of the inputs."""
    inputs = ctx.get_inputs(cfg)
    acc = torch.cat([a.value for a in inputs], dim=-1)
    return finish_layer(ctx, cfg, acc, like=inputs[0])
