"""Core layers: data, fc, mixed (the table, full-matrix, transposed
full-matrix, identity, dot-mul, scaling, context and conv projections, the
conv and dot-mul operators), addto, concat — the counterparts of
paddle_tpu/graph/layers_core.py.

An input of sparse rows (`Argument.sparse_dim`: [..., K] column ids and
their values) multiplies a weight by gathering the K touched rows and
summing them weighted by the values (`_input_matmul`).  A parameter marked
`sparse_update` stays a dense tensor with a dense gradient, as in the JAX
package's single-device trainer.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.ops import sequence as seqops
from paddle_tpu_torch.ops.table import lookup_rows
from paddle_tpu_torch.parameter.argument import Argument


@register_layer("data")
def data_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Input placeholder — the feed supplies its value."""
    raise AssertionError("data layers are fed, not computed")


def _input_matmul(arg: Argument, w: torch.Tensor) -> torch.Tensor:
    """x @ W, where x may be sparse rows: the K touched rows of W gathered
    (ops/table.py lookup_rows, whose backward adds in a fixed order;
    padding slots carry id 0 with value 0) and summed weighted by the
    values."""
    if arg.sparse_dim:
        rows = lookup_rows(arg.ids, w)                    # [..., K, Dout]
        return torch.sum(rows * arg.sparse_vals[..., None].to(rows.dtype),
                         dim=-2)
    return torch.matmul(arg.value, w)


@register_layer("fc")
def fc_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Fully connected: sum_i x_i @ W_i + b, then the activation."""
    inputs = ctx.get_inputs(cfg)
    acc = None
    for i, arg in enumerate(inputs):
        y = _input_matmul(arg, ctx.param_of(cfg, i))
        acc = y if acc is None else acc + y
    b = ctx.bias_of(cfg)
    if b is not None:
        acc = acc + b
    return finish_layer(ctx, cfg, acc, like=inputs[0])


def _apply_projection(cfg: LayerConfig, proj, arg: Argument,
                      w: Optional[torch.Tensor]) -> torch.Tensor:
    t = proj.type
    if t in ("fc", "full_matrix"):
        return _input_matmul(arg, w)
    if t == "table":
        if arg.sparse_dim:
            raise ValueError(
                f"layer {cfg.name!r}: a table projection takes token ids, "
                f"not sparse rows (their padding slots would embed id 0); "
                f"a sparse slot wants a full_matrix projection")
        # lookup_rows: a backward that adds in a fixed order on the CPU
        # and on the card (ops/table.py), so two runs of one step give the
        # table's gradient bit for bit
        return lookup_rows(arg.ids, w)
    if arg.sparse_dim:
        raise ValueError(
            f"layer {cfg.name!r}: a {t} projection of sparse rows would read "
            f"their column ids as values; use a full_matrix projection or "
            f"Argument.to_dense()")
    if t == "trans_full_matrix":
        return torch.matmul(arg.value, w.t())
    if t == "identity":
        return arg.data
    if t == "dot_mul":
        return arg.value * w
    if t == "scaling":
        return arg.value * w.reshape(())
    if t == "context":
        return seqops.context_projection(
            arg.value, arg.lengths, proj.context_start, proj.context_length,
            w if proj.trainable_padding else None)
    if t == "conv":
        from paddle_tpu_torch.graph.layers_conv import \
            conv_projection_forward
        return conv_projection_forward(proj, arg, w)
    raise NotImplementedError(f"layer {cfg.name!r}: projection type {t!r}")


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
    """Sum of per-input projections and operators plus bias.  Projections:
    `table` (embedding lookup), `fc` / `full_matrix` (x @ W, x dense or
    sparse rows), `trans_full_matrix` (x @ W^T), `identity`, `dot_mul`
    (x * w elementwise), `scaling` (x times one learned scalar),
    `context` (the sliding window over time, ops/sequence.py) and `conv`;
    operators: `dot_mul` and `conv` (a filter per sample from a layer
    output)."""
    inputs = ctx.get_inputs(cfg)
    acc = None
    like = inputs[0] if inputs else None
    for i, (inp, arg) in enumerate(zip(cfg.inputs, inputs)):
        if inp.proj is None:
            continue
        y = _apply_projection(cfg, inp.proj, arg, ctx.param_of(cfg, i))
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
