"""Sequence and recurrent layers — the counterparts of
paddle_tpu/graph/layers_seq.py for `lstmemory` and the pooling layers over
time (`max`, `average`, `seqlastins`) on the padded [B, T, D] + lengths
representation.  Nested (sub-sequence) inputs, the truncated-BPTT carry-over
of the final state into the next batch (--prev_batch_state), and the other
layers of that module are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.ops import rnn as rnnops
from paddle_tpu_torch.ops import sequence as seqops
from paddle_tpu_torch.parameter.argument import Argument


def _sequence_input(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = ctx.get_input(cfg, 0)
    if not x.is_sequence:
        raise ValueError(f"layer {cfg.name!r} ({cfg.type}) needs a sequence "
                         f"input; {cfg.inputs[0].input_layer_name!r} carries "
                         f"no lengths")
    if cfg.trans_type == "seq":
        raise NotImplementedError(
            f"layer {cfg.name!r}: per-sub-sequence pooling (agg_level='seq') "
            f"needs nested sequences, not ported yet (ROADMAP.md)")
    return x


@register_layer("max")
def max_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = _sequence_input(ctx, cfg)
    return finish_layer(ctx, cfg, seqops.seq_pool_max(x.value, x.lengths))


@register_layer("average")
def average_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = _sequence_input(ctx, cfg)
    return finish_layer(ctx, cfg, seqops.seq_pool_avg(
        x.value, x.lengths, cfg.average_strategy))


@register_layer("seqlastins")
def seq_last_ins_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = _sequence_input(ctx, cfg)
    pool = seqops.seq_pool_first if cfg.select_first else seqops.seq_pool_last
    return finish_layer(ctx, cfg, pool(x.value, x.lengths))


@register_layer("lstmemory")
def lstmemory_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """LSTM over a pre-projected [B, T, 4D] input (the input projection is
    the layer below; recurrent weight [D, 4D] on the input edge; bias [4D],
    or [7D] with peepholes).  The cell applies the activations, so the
    output is finished without one (dropout still applies)."""
    x = _sequence_input(ctx, cfg)
    if f"{cfg.name}:h" in ctx.state_in or f"{cfg.name}:c" in ctx.state_in:
        raise NotImplementedError(
            f"layer {cfg.name!r}: booting from the previous batch's final "
            f"state (--prev_batch_state) is not ported yet (ROADMAP.md)")
    hs, _, _ = rnnops.lstm_scan(
        x.value, x.lengths, ctx.param_of(cfg, 0), ctx.bias_of(cfg),
        active_type=cfg.active_type or "tanh",
        gate_active_type=cfg.attrs.get("active_gate_type", "sigmoid"),
        state_active_type=cfg.attrs.get("active_state_type", "tanh"),
        reverse=cfg.reversed)
    out_cfg = dataclasses.replace(cfg, active_type="")
    return finish_layer(ctx, out_cfg, hs, like=x, lengths=x.lengths)
