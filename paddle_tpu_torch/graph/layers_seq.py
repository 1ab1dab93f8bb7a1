"""Sequence and recurrent layers — the counterparts of
paddle_tpu/graph/layers_seq.py for `lstmemory`, `gated_recurrent`,
`gru_step`, `lstm_step`, `recurrent` (the vanilla RNN), the pooling layers
over time (`max`, `average`, `seqlastins`, on flat and nested inputs),
`expand`, `subseq`, `seqconcat`, `seqreshape`, `maxid`, `sampling_id`,
`eos_id`, the 2-D `mdlstmemory`, the linear-chain CRF's `crf` (a cost) and
`crf_decoding`, and the costs `ctc`, `nce` and `hsigmoid`, on the padded
[B, T, D] + lengths representation (nested: [B, S, T, D] + lengths +
sub_lengths).

Under --prev_batch_state a forward recurrent layer (`lstmemory`,
`gated_recurrent`, `recurrent`) boots from the previous batch's final
state, which it finds in the layer state (`ctx.state_in`, keys
`<layer>:h` and `<layer>:c`) and hands on in `ctx.state_out`: the
reference's truncated-BPTT continuation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.ops import crf as crfops
from paddle_tpu_torch.ops import ctc as ctcops
from paddle_tpu_torch.ops import mdlstm as mdlstmops
from paddle_tpu_torch.ops import sampling as samplingops
from paddle_tpu_torch.ops import rnn as rnnops
from paddle_tpu_torch.ops import sequence as seqops
from paddle_tpu_torch.ops.activations import activation_registry
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.utils import prng
from paddle_tpu_torch.utils.flags import FLAGS


def _sequence_input(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = ctx.get_input(cfg, 0)
    if not x.is_sequence:
        raise ValueError(f"layer {cfg.name!r} ({cfg.type}) needs a sequence "
                         f"input; {cfg.inputs[0].input_layer_name!r} carries "
                         f"no lengths")
    return x


def _prev_state(ctx: ForwardContext, cfg: LayerConfig, B: int,
                names: tuple[str, ...]) -> list[Optional[torch.Tensor]]:
    """The initial states of a recurrent layer under --prev_batch_state:
    one per name, the previous batch's final state detached (BPTT stops
    at the batch edge), or None (zeros) without the flag, for a reversed
    layer, without a carried state or when the batch size changed."""
    if not FLAGS.prev_batch_state or cfg.reversed:
        return [None] * len(names)
    out = []
    for n in names:
        s = ctx.state_in.get(f"{cfg.name}:{n}")
        out.append(s.detach() if s is not None and s.shape[0] == B
                   else None)
    return out


def _save_state(ctx: ForwardContext, cfg: LayerConfig,
                **states: torch.Tensor) -> None:
    """A forward recurrent layer's final states, for the next batch."""
    if not FLAGS.prev_batch_state or cfg.reversed:
        return
    for n, v in states.items():
        ctx.state_out[f"{cfg.name}:{n}"] = v.detach()


def _per_sub(cfg: LayerConfig, x: Argument) -> bool:
    """Whether a nested [B, S, T, D] input pools per sub-sequence (into a
    [B, S, D] sequence, agg_level='seq', carried in trans_type) instead of
    over all its valid tokens (into [B, D], the default)."""
    if cfg.trans_type != "seq":
        return False
    if x.sub_lengths is None:
        raise ValueError(
            f"layer {cfg.name!r}: agg_level=AggregateLevel.EACH_SEQUENCE "
            f"needs a NESTED (sub-sequence) input; this input is a plain "
            f"sequence — drop agg_level or feed sub_lengths")
    return True


@register_layer("max")
def max_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = _sequence_input(ctx, cfg)
    if _per_sub(cfg, x):
        return finish_layer(ctx, cfg, seqops.nested_pool_max_per_sub(
            x.value, x.lengths, x.sub_lengths), lengths=x.lengths)
    if x.sub_lengths is not None:
        out = seqops.nested_pool_max(x.value, x.lengths, x.sub_lengths)
    else:
        out = seqops.seq_pool_max(x.value, x.lengths)
    return finish_layer(ctx, cfg, out)


@register_layer("average")
def average_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = _sequence_input(ctx, cfg)
    if _per_sub(cfg, x):
        return finish_layer(ctx, cfg, seqops.nested_pool_avg_per_sub(
            x.value, x.lengths, x.sub_lengths, cfg.average_strategy),
            lengths=x.lengths)
    if x.sub_lengths is not None:
        out = seqops.nested_pool_avg(x.value, x.lengths, x.sub_lengths,
                                     cfg.average_strategy)
    else:
        out = seqops.seq_pool_avg(x.value, x.lengths, cfg.average_strategy)
    return finish_layer(ctx, cfg, out)


@register_layer("seqlastins")
def seq_last_ins_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = _sequence_input(ctx, cfg)
    if _per_sub(cfg, x):
        return finish_layer(ctx, cfg, seqops.nested_pool_edge_per_sub(
            x.value, x.lengths, x.sub_lengths, bool(cfg.select_first)),
            lengths=x.lengths)
    if x.sub_lengths is not None:
        pool = (seqops.nested_pool_first if cfg.select_first
                else seqops.nested_pool_last)
        out = pool(x.value, x.lengths, x.sub_lengths)
    else:
        pool = (seqops.seq_pool_first if cfg.select_first
                else seqops.seq_pool_last)
        out = pool(x.value, x.lengths)
    return finish_layer(ctx, cfg, out)


def _plus_bias(ctx: ForwardContext, cfg: LayerConfig,
               out: torch.Tensor) -> torch.Tensor:
    b = ctx.bias_of(cfg)
    return out if b is None else out + b


@register_layer("expand")
def expand_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Each row's vector (input 0) repeated over the steps of input 1's
    sequence, plus the bias."""
    x, like = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    out = seqops.expand_to_sequence(x.value, like.lengths, like.max_len)
    return finish_layer(ctx, cfg, _plus_bias(ctx, cfg, out), like=like,
                        lengths=like.lengths)


@register_layer("subseq")
def sub_sequence_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Each row's slice of input 0 at the offset and of the size that the
    id inputs 1 and 2 give, plus the bias."""
    x = ctx.get_input(cfg, 0)
    off, sz = ctx.get_input(cfg, 1), ctx.get_input(cfg, 2)
    out, lengths = seqops.sub_sequence(x.value, off.ids.reshape(-1),
                                       sz.ids.reshape(-1), lengths=x.lengths)
    return finish_layer(ctx, cfg, _plus_bias(ctx, cfg, out), lengths=lengths)


@register_layer("seqconcat")
def seq_concat_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    a, b = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    out, lengths = seqops.seq_concat(a.value, a.lengths, b.value, b.lengths)
    return finish_layer(ctx, cfg, out, lengths=lengths)


@register_layer("seqreshape")
def seq_reshape_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    x = ctx.get_input(cfg, 0)
    out, lengths = seqops.seq_reshape(x.value, x.lengths, cfg.size)
    return finish_layer(ctx, cfg, out, lengths=lengths)


@register_layer("lstmemory")
def lstmemory_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """LSTM over a pre-projected [B, T, 4D] input (the input projection is
    the layer below; recurrent weight [D, 4D] on the input edge; bias [4D],
    or [7D] with peepholes).  The cell applies the activations, so the
    output is finished without one (dropout still applies)."""
    x = _sequence_input(ctx, cfg)
    h0, c0 = _prev_state(ctx, cfg, x.value.shape[0], ("h", "c"))
    hs, last_h, last_c = rnnops.lstm_scan(
        x.value, x.lengths, ctx.param_of(cfg, 0), ctx.bias_of(cfg),
        h0=h0, c0=c0, active_type=cfg.active_type or "tanh",
        gate_active_type=cfg.attrs.get("active_gate_type", "sigmoid"),
        state_active_type=cfg.attrs.get("active_state_type", "tanh"),
        reverse=cfg.reversed)
    _save_state(ctx, cfg, h=last_h, c=last_c)
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
    (h0,) = _prev_state(ctx, cfg, x.value.shape[0], ("h",))
    w = ctx.param_of(cfg, 0)
    D = cfg.size
    hs, last_h = rnnops.gru_scan(
        x.value, x.lengths, w[:, :2 * D], w[:, 2 * D:], ctx.bias_of(cfg),
        h0=h0, active_type=cfg.active_type or "tanh",
        gate_active_type=cfg.attrs.get("active_gate_type", "sigmoid"),
        reverse=cfg.reversed)
    _save_state(ctx, cfg, h=last_h)
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


@register_layer("lstm_step")
def lstm_step_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """One LSTM step on a [B, 4D] pre-projected input (the recurrent term
    included) and the [B, D] previous cell, plain tensor ops as on the JAX
    side.  A 7D bias adds its first 4D to the input and holds the
    peepholes (i, f, o) in the rest.  The new cell is published under
    attrs['state_name'], where the group's cell memory reads it."""
    x4 = ctx.get_input(cfg, 0).value
    c_prev = ctx.get_input(cfg, 1).value
    b = ctx.bias_of(cfg)
    D = cfg.size
    act = activation_registry[cfg.active_type or "tanh"]
    gate = activation_registry[cfg.attrs.get("active_gate_type", "sigmoid")]
    state_act = activation_registry[cfg.attrs.get("active_state_type",
                                                  "tanh")]
    peep_i = peep_f = peep_o = None
    if b is not None:
        b = b.reshape(-1)
        if b.shape[0] == 7 * D:
            x4 = x4 + b[:4 * D]
            peep_i, peep_f, peep_o = (b[4 * D:5 * D], b[5 * D:6 * D],
                                      b[6 * D:])
        else:
            x4 = x4 + b
    a = act(x4[:, :D])
    zi, zf, zo = x4[:, D:2 * D], x4[:, 2 * D:3 * D], x4[:, 3 * D:]
    if peep_i is not None:
        zi = zi + c_prev * peep_i
        zf = zf + c_prev * peep_f
    c_new = a * gate(zi) + gate(zf) * c_prev
    if peep_o is not None:
        zo = zo + c_new * peep_o
    ctx.outputs[cfg.attrs["state_name"]] = Argument(value=c_new)
    return Argument(value=gate(zo) * state_act(c_new))


@register_layer("recurrent")
def recurrent_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The vanilla RNN h_t = act(x_t + h_{t-1} W) over a [B, T, D] input
    (ops/rnn.py simple_rnn_scan), finished without an activation, as
    lstmemory."""
    x = _sequence_input(ctx, cfg)
    (h0,) = _prev_state(ctx, cfg, x.value.shape[0], ("h",))
    hs, last_h = rnnops.simple_rnn_scan(
        x.value, x.lengths, ctx.param_of(cfg, 0), ctx.bias_of(cfg), h0=h0,
        active_type=cfg.active_type or "tanh", reverse=cfg.reversed)
    _save_state(ctx, cfg, h=last_h)
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


@register_layer("mdlstmemory")
def mdlstm_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The 2-D multi-dimensional LSTM over a static [height, width] grid of
    a pre-projected [B, H*W, 5D] input (ops/mdlstm.py), the walk's
    direction per dimension from attrs['directions'], finished without an
    activation."""
    x = ctx.get_input(cfg, 0)
    b = ctx.bias_of(cfg)
    if b is None:
        raise ValueError(f"mdlstmemory {cfg.name!r} needs its bias / "
                         f"peephole parameter")
    directions = tuple(cfg.attrs.get("directions", (True, True)))
    if len(directions) != 2:
        raise ValueError(f"mdlstmemory {cfg.name!r}: 2-D grids only, got "
                         f"directions {directions}")
    out = mdlstmops.mdlstm_2d(
        x.value, ctx.param_of(cfg, 0), b, height=cfg.attrs["height"],
        width=cfg.attrs["width"], directions=directions, lengths=x.lengths,
        active_type=cfg.active_type or "tanh",
        gate_active_type=cfg.attrs.get("active_gate_type", "sigmoid"),
        state_active_type=cfg.attrs.get("active_state_type", "tanh"))
    out_cfg = dataclasses.replace(cfg, active_type="")
    return finish_layer(ctx, out_cfg, out, like=x, lengths=x.lengths)


@register_layer("sampling_id")
def sampling_id_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """An id drawn from each row's distribution: categorical(next_rng(),
    log(max(p, 1e-10))), the JAX layer's draw."""
    x = ctx.get_input(cfg, 0)
    logits = torch.log(torch.clamp(x.value, min=1e-10))
    return Argument(ids=prng.categorical(ctx.next_rng(), logits, axis=-1),
                    lengths=x.lengths)


@register_layer("eos_id")
def eos_id_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """1 where the input id is attrs['eos_id'], else 0."""
    x = ctx.get_input(cfg, 0)
    return Argument(ids=(x.ids == cfg.attrs.get("eos_id", 0)).long(),
                    lengths=x.lengths)


@register_layer("ctc")
def ctc_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The CTC cost of the label ids under the [B, T, C] probabilities
    (ops/ctc.py), recorded times `coeff`."""
    x, lbl = ctx.get_input(cfg, 0), ctx.get_input(cfg, 1)
    cost = ctcops.ctc_loss(x.value, x.lengths, lbl.ids, lbl.lengths,
                           blank=cfg.blank, norm_by_times=cfg.norm_by_times)
    ctx.costs[cfg.name] = cfg.coeff * cost
    return Argument(value=cost[:, None])


@register_layer("nce")
def nce_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The noise-contrastive estimation cost (ops/sampling.py): the feature
    inputs (those with parameters), then the label, then an optional
    per-row weight; `num_neg_samples` negatives per row drawn from
    `neg_sampling_dist` (uniform when unset) with the next key."""
    inputs = ctx.get_inputs(cfg)
    n_feat = sum(1 for li in cfg.inputs if li.input_parameter_name)
    dist = None
    if cfg.neg_sampling_dist:
        dist = torch.tensor(cfg.neg_sampling_dist, dtype=torch.float32,
                            device=inputs[0].value.device)
    cost = samplingops.nce_cost(
        ctx.next_rng(), [inputs[i].value for i in range(n_feat)],
        inputs[n_feat].ids, [ctx.param_of(cfg, i) for i in range(n_feat)],
        ctx.bias_of(cfg), num_classes=cfg.num_classes,
        num_neg=cfg.num_neg_samples, dist=dist)
    if len(inputs) > n_feat + 1:
        cost = cost * inputs[n_feat + 1].data.reshape(cost.shape)
    ctx.costs[cfg.name] = cfg.coeff * cost
    return Argument(value=cost[:, None])


@register_layer("hsigmoid")
def hsigmoid_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """The hierarchical sigmoid cost over a complete binary tree
    (ops/sampling.py); the label is the last input."""
    inputs = ctx.get_inputs(cfg)
    feats = inputs[:-1]
    cost = samplingops.hsigmoid_cost(
        [f.value for f in feats], inputs[-1].ids,
        [ctx.param_of(cfg, i) for i in range(len(feats))],
        ctx.bias_of(cfg), cfg.num_classes)
    ctx.costs[cfg.name] = cfg.coeff * cost
    return Argument(value=cost[:, None])
