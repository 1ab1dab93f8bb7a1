"""Shared helpers for layer implementations."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.ops.activations import activation
from paddle_tpu_torch.parameter.argument import Argument


def finish_layer(ctx: ForwardContext, cfg: LayerConfig, value: torch.Tensor,
                 like: Optional[Argument] = None,
                 lengths: Optional[torch.Tensor] = None) -> Argument:
    """Apply the activation and package the output Argument, inheriting
    sequence lengths from `like`.  Dropout at test time scales by
    (1 - drop_rate), as the JAX package's classic dropout does; its
    training-time Bernoulli mask needs the JAX random stream, not ported
    yet (ROADMAP.md), so a TRAIN forward of such a layer raises."""
    if lengths is None and like is not None and value.dim() >= 3:
        lengths = like.lengths
    out = activation(cfg.active_type, value)
    if cfg.drop_rate > 0.0:
        if ctx.is_training:
            raise NotImplementedError(
                f"layer {cfg.name!r}: training-time dropout needs the JAX "
                f"random stream, not ported yet (ROADMAP.md)")
        out = out * (1.0 - cfg.drop_rate)
    return Argument(value=out, lengths=lengths)
