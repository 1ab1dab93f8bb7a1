"""Sequence and recurrent layers — the counterparts of
paddle_tpu/graph/layers_seq.py for `lstmemory`, `gated_recurrent`,
`gru_step`, `recurrent` (the vanilla RNN), the pooling layers over time
(`max`, `average`, `seqlastins`), `maxid`, and the linear-chain CRF's
`crf` (a cost) and `crf_decoding`, on the padded [B, T, D] + lengths
representation.  Nested (sub-sequence) inputs, the truncated-BPTT
carry-over of the final state into the next batch (--prev_batch_state),
and the other layers of that module are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
import torch

from paddle_tpu_torch.ops import crf as crfops
from paddle_tpu_torch.ops import rnn as rnnops
from paddle_tpu_torch.ops import sequence as seqops
from paddle_tpu_torch.ops.activations import activation_registry
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
    _refuse_prev_state(ctx, cfg, ("h", "c"))
    hs, _, _ = rnnops.lstm_scan(
        x.value, x.lengths, ctx.param_of(cfg, 0), ctx.bias_of(cfg),
        active_type=cfg.active_type or "tanh",
        gate_active_type=cfg.attrs.get("active_gate_type", "sigmoid"),
        state_active_type=cfg.attrs.get("active_state_type", "tanh"),
        reverse=cfg.reversed)
    out_cfg = dataclasses.replace(cfg, active_type="")
    return finish_layer(ctx, out_cfg, hs, like=x, lengths=x.lengths)


@register_layer("gated_recurrent")
def gated_recurrent_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """GRU over a pre-projected [B, T, 3D] input; one recurrent parameter
    [D, 3D] split into the gate part [D, 2D] and the candidate part [D, D]
    (column slices: the kernels read them in place, and their gradients
    land in the one parameter).  Finished without an activation, as
    lstmemory."""
    x = _sequence_input(ctx, cfg)
    _refuse_prev_state(ctx, cfg, ("h",))
    w = ctx.param_of(cfg, 0)
    D = cfg.size
    hs, _ = rnnops.gru_scan(
        x.value, x.lengths, w[:, :2 * D], w[:, 2 * D:], ctx.bias_of(cfg),
        active_type=cfg.active_type or "tanh",
        gate_active_type=cfg.attrs.get("active_gate_type", "sigmoid"),
        reverse=cfg.reversed)
    out_cfg = dataclasses.replace(cfg, active_type="")
    return finish_layer(ctx, out_cfg, hs, like=x, lengths=x.lengths)


@register_layer("gru_step")
def gru_step_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """One GRU step on a [B, 3D] pre-projected input and the [B, D]
    previous hidden, with its own recurrent weight [D, 3D] — plain tensor
    ops, as on the JAX side, which has no kernel for it."""
    x3 = ctx.get_input(cfg, 0).value
    h_prev = ctx.get_input(cfg, 1).value
    w = ctx.param_of(cfg, 0)
    b = ctx.bias_of(cfg)
    D = cfg.size
    act = activation_registry[cfg.active_type or "tanh"]
    gate = activation_registry[cfg.attrs.get("active_gate_type", "sigmoid")]
    if b is not None:
        x3 = x3 + b.reshape(-1)
    zg = x3[:, :2 * D] + h_prev @ w[:, :2 * D]
    u = gate(zg[:, :D])
    r = gate(zg[:, D:])
    c = act(x3[:, 2 * D:] + (r * h_prev) @ w[:, 2 * D:])
    return Argument(value=u * h_prev + (1.0 - u) * c)


@register_layer("recurrent")
def recurrent_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The vanilla RNN h_t = act(x_t + h_{t-1} W) over a [B, T, D] input
    (ops/rnn.py simple_rnn_scan), finished without an activation, as
    lstmemory."""
    x = _sequence_input(ctx, cfg)
    _refuse_prev_state(ctx, cfg, ("h",))
    hs, _ = rnnops.simple_rnn_scan(
        x.value, x.lengths, ctx.param_of(cfg, 0), ctx.bias_of(cfg),
        active_type=cfg.active_type or "tanh", reverse=cfg.reversed)
    out_cfg = dataclasses.replace(cfg, active_type="")
    return finish_layer(ctx, out_cfg, hs, like=x, lengths=x.lengths)


@register_layer("maxid")
def maxid_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The argmax id of each row (the first maximal one), or with
    beam_size k > 1 the top k values and their ids."""
    x = ctx.get_input(cfg, 0)
    k = max(cfg.beam_size, 1)
    if k == 1:
        return Argument(ids=torch.argmax(x.value, dim=-1),
                        lengths=x.lengths)
    vals, ids = torch.topk(x.value, k, dim=-1)
    return Argument(value=vals, ids=ids, lengths=x.lengths)


@register_layer("crf")
def crf_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Each sequence's linear-chain CRF negative log-likelihood of the
    label ids, a cost recorded times `coeff` (times the third input, a
    per-sequence weight, when there is one)."""
    x, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    cost = crfops.crf_nll(x.value, lbl.ids, x.lengths, ctx.param_of(cfg, 0))
    if len(cfg.inputs) > 2:
        cost = cost * ctx.get_input(cfg, 2).data.reshape(cost.shape)
    ctx.costs[cfg.name] = cfg.coeff * cost
    return Argument(value=cost[:, None])


@register_layer("crf_decoding")
def crf_decoding_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The Viterbi path as ids; with a label input, the per-step 0/1
    indicators of a decoded tag differing from the label instead (0 past
    each row's length), as the reference layer hands them on."""
    x = ctx.get_input(cfg, 0)
    path = crfops.crf_decode(x.value, x.lengths, ctx.param_of(cfg, 0))
    if len(cfg.inputs) > 1:
        lbl = ctx.get_input(cfg, 1)
        err = (path != lbl.ids).long() * x.mask(torch.long)
        return Argument(ids=err, lengths=x.lengths)
    return Argument(ids=path, lengths=x.lengths)


def _refuse_prev_state(ctx: ForwardContext, cfg: LayerConfig,
                       names: tuple[str, ...]) -> None:
    if any(f"{cfg.name}:{n}" in ctx.state_in for n in names):
        raise NotImplementedError(
            f"layer {cfg.name!r}: booting from the previous batch's final "
            f"state (--prev_batch_state) is not ported yet (ROADMAP.md)")
