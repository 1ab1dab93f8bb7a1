"""Shared helpers for layer implementations."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.ops.activations import activation
from paddle_tpu_torch.parameter.argument import Argument


def apply_dropout(ctx: ForwardContext, cfg: LayerConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """Classic (non-inverted) dropout, as the JAX package's: multiply by a
    Bernoulli(1 - drop_rate) keep-mask at train time and by (1 - drop_rate)
    at test time.  The mask is `ctx.dropout_masks[cfg.name]` when the
    caller supplied one, else a draw from the context's generator."""
    p = cfg.drop_rate
    if p <= 0.0:
        return x
    if not ctx.is_training:
        return x * (1.0 - p)
    keep = ctx.dropout_masks.get(cfg.name)
    if keep is None:
        keep = torch.rand(x.shape, generator=ctx.next_rng(),
                          device=x.device) < (1.0 - p)
    elif keep.shape != x.shape:
        raise ValueError(f"layer {cfg.name!r}: dropout mask "
                         f"{tuple(keep.shape)} for an output "
                         f"{tuple(x.shape)}")
    return x * keep.to(device=x.device, dtype=x.dtype)


def finish_layer(ctx: ForwardContext, cfg: LayerConfig, value: torch.Tensor,
                 like: Optional[Argument] = None,
                 lengths: Optional[torch.Tensor] = None,
                 image: bool = False) -> Argument:
    """Apply the activation and dropout and package the output Argument,
    inheriting sequence lengths and sub-sequence lengths from `like`.
    `image` marks a [B, C, H, W] output, which stays an image for the next
    image layer; a whole-row activation (softmax) works on the flat rows,
    so its output is rows."""
    if image and cfg.active_type in ("softmax", "sequence_softmax"):
        value = value.reshape(value.shape[0], -1)
        image = False
    if lengths is None and like is not None and value.dim() >= 3 \
            and not image:
        lengths = like.lengths
    mask = None
    if cfg.active_type == "sequence_softmax" and lengths is not None:
        mask = (torch.arange(value.shape[1], device=value.device)[None, :]
                < lengths[:, None])
    out = apply_dropout(ctx, cfg, activation(cfg.active_type, value, mask))
    return Argument(value=out, lengths=lengths, image=image,
                    sub_lengths=like.sub_lengths if like is not None
                    else None)
