"""Composite network builders
(ref: trainer_config_helpers/networks.py: simple_img_conv_pool:145,
small_vgg:418, vgg_16_network:448, simple_lstm:531, lstmemory_group:726,
simple_gru:937, bidirectional_lstm:1166, simple_attention:1257,
inputs/outputs:1376-1394)."""

from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch.dsl.activations import (
    BaseActivation, LinearActivation, ReluActivation, SequenceSoftmaxActivation,
    SigmoidActivation, SoftmaxActivation, TanhActivation,
)
from paddle_tpu_torch.dsl.attrs import ExtraLayerAttribute, ParameterAttribute
from paddle_tpu_torch.dsl.base import LayerOutput, current_context
from paddle_tpu_torch.dsl.layers import (
    StaticInput, batch_norm_layer, concat_layer, context_projection,
    dropout_layer, expand_layer, fc_layer, first_seq, full_matrix_projection,
    gru_step_layer, grumemory, identity_projection, img_cmrnorm_layer,
    img_conv_layer, img_pool_layer, last_seq, lstm_step_layer, lstmemory,
    memory, mixed_layer, pooling_layer, recurrent_group, tensor_layer,
)
from paddle_tpu_torch.dsl.poolings import MaxPooling

__all__ = [
    "simple_img_conv_pool", "img_conv_group", "small_vgg", "vgg_16_network",
    "simple_lstm", "sequence_conv_pool", "lstmemory_group", "simple_gru", "gru_group",
    "bidirectional_lstm", "simple_attention", "inputs", "outputs",
    "lstmemory_unit", "gru_unit", "simple_gru2", "bidirectional_gru",
    "img_conv_bn_pool", "text_conv_pool",
]


def simple_img_conv_pool(input: LayerOutput, filter_size: int, num_filters: int,
                         pool_size: int, name: Optional[str] = None,
                         pool_type=None, act=None, groups: int = 1,
                         conv_stride: int = 1, conv_padding: int = 0,
                         bias_attr=None, num_channel: Optional[int] = None,
                         param_attr=None, shared_bias: bool = True,
                         conv_layer_attr=None, pool_stride: int = 1,
                         pool_padding: int = 0, pool_layer_attr=None) -> LayerOutput:
    """(ref: networks.py simple_img_conv_pool:145)."""
    conv = img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channel, act=act, groups=groups, stride=conv_stride,
        padding=conv_padding, bias_attr=bias_attr, param_attr=param_attr,
        shared_biases=shared_bias, layer_attr=conv_layer_attr,
        name=f"{name}_conv" if name else None)
    return img_pool_layer(
        input=conv, pool_size=pool_size, pool_type=pool_type, stride=pool_stride,
        padding=pool_padding, layer_attr=pool_layer_attr,
        name=f"{name}_pool" if name else None)


def img_conv_group(input: LayerOutput, conv_num_filter: Sequence[int],
                   pool_size: int, num_channels: Optional[int] = None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride: int = 2, pool_type=None) -> LayerOutput:
    """Stack of convs followed by one pool (ref: networks.py img_conv_group)."""
    n = len(conv_num_filter)

    def as_list(v):
        return v if isinstance(v, (list, tuple)) else [v] * n

    paddings = as_list(conv_padding)
    fsizes = as_list(conv_filter_size)
    acts = conv_act if isinstance(conv_act, (list, tuple)) else [conv_act] * n
    bns = as_list(conv_with_batchnorm)
    drops = as_list(conv_batchnorm_drop_rate)

    tmp = input
    channels = num_channels
    for i in range(n):
        act = acts[i] or ReluActivation()
        tmp = img_conv_layer(
            input=tmp, filter_size=fsizes[i], num_filters=conv_num_filter[i],
            num_channels=channels, padding=paddings[i],
            act=LinearActivation() if bns[i] else act)
        channels = None
        if bns[i]:
            tmp = batch_norm_layer(
                input=tmp, act=act,
                layer_attr=ExtraLayerAttribute(drop_rate=drops[i]))
    return img_pool_layer(input=tmp, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type or MaxPooling())


def small_vgg(input_image: LayerOutput, num_channels: int, num_classes: int) -> LayerOutput:
    """The CIFAR VGG of the demos (ref: networks.py small_vgg:418 — four
    conv groups [64x2, 128x2, 256x3, 512x3] + 2 fc)."""
    def group(ipt, num_filter, times, channels=None):
        return img_conv_group(
            input=ipt, conv_num_filter=[num_filter] * times, pool_size=2,
            num_channels=channels, conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=0.0, pool_stride=2)

    tmp = group(input_image, 64, 2, num_channels)
    tmp = group(tmp, 128, 2)
    tmp = group(tmp, 256, 3)
    tmp = group(tmp, 512, 3)
    tmp = img_pool_layer(input=tmp, pool_size=8, stride=8)
    tmp = dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = fc_layer(input=tmp, size=512, act=LinearActivation())
    tmp = batch_norm_layer(input=tmp, act=ReluActivation(),
                           layer_attr=ExtraLayerAttribute(drop_rate=0.5))
    return fc_layer(input=tmp, size=num_classes, act=SoftmaxActivation())


def vgg_16_network(input_image: LayerOutput, num_channels: int,
                   num_classes: int = 1000) -> LayerOutput:
    """Full VGG-16 (ref: networks.py vgg_16_network:448)."""
    def group(ipt, num_filter, times, channels=None):
        return img_conv_group(
            input=ipt, conv_num_filter=[num_filter] * times, pool_size=2,
            num_channels=channels, pool_stride=2)

    tmp = group(input_image, 64, 2, num_channels)
    tmp = group(tmp, 128, 2)
    tmp = group(tmp, 256, 3)
    tmp = group(tmp, 512, 3)
    tmp = group(tmp, 512, 3)
    tmp = fc_layer(input=tmp, size=4096, act=ReluActivation(),
                   layer_attr=ExtraLayerAttribute(drop_rate=0.5))
    tmp = fc_layer(input=tmp, size=4096, act=ReluActivation(),
                   layer_attr=ExtraLayerAttribute(drop_rate=0.5))
    return fc_layer(input=tmp, size=num_classes, act=SoftmaxActivation())


def sequence_conv_pool(input: LayerOutput, context_len: int, hidden_size: int,
                       name: Optional[str] = None,
                       context_start: Optional[int] = None, pool_type=None,
                       context_proj_param_attr=None, fc_param_attr=None,
                       fc_bias_attr=None, fc_act=None,
                       pool_bias_attr=None) -> LayerOutput:
    """Text conv pooling: context projection -> fc -> pooling
    (ref: networks.py sequence_conv_pool:41)."""
    with mixed_layer(name=f"{name}_conv_proj" if name else None,
                     size=input.size * context_len,
                     act=LinearActivation(), bias_attr=False) as m:
        m += context_projection(input, context_len=context_len,
                                context_start=context_start,
                                padding_attr=context_proj_param_attr or False)
    fc = fc_layer(input=m, size=hidden_size, act=fc_act,
                  param_attr=fc_param_attr, bias_attr=fc_bias_attr)
    return pooling_layer(input=fc, pooling_type=pool_type or MaxPooling(),
                         name=name, bias_attr=pool_bias_attr or False)


def simple_lstm(input: LayerOutput, size: int, name: Optional[str] = None,
                reverse: bool = False, mat_param_attr=None, bias_param_attr=None,
                inner_param_attr=None, act=None, gate_act=None, state_act=None,
                mixed_layer_attr=None, lstm_cell_attr=None) -> LayerOutput:
    """fc(4*size) + lstmemory (ref: networks.py simple_lstm:531)."""
    fc_name = f"{name}_transform" if name else None
    with mixed_layer(name=fc_name, size=size * 4, act=LinearActivation(),
                     bias_attr=False, layer_attr=mixed_layer_attr) as m:
        m += full_matrix_projection(input, size=size * 4, param_attr=mat_param_attr)
    return lstmemory(input=m, name=name, reverse=reverse, bias_attr=bias_param_attr,
                     param_attr=inner_param_attr, act=act, gate_act=gate_act,
                     state_act=state_act, layer_attr=lstm_cell_attr)


def lstmemory_group(input: LayerOutput, size: Optional[int] = None,
                    name: Optional[str] = None, reverse: bool = False,
                    param_attr=None, act=None, gate_act=None, state_act=None,
                    mixed_bias_attr=None, lstm_bias_attr=None,
                    mixed_layer_attr=None, lstm_layer_attr=None) -> LayerOutput:
    """LSTM built as an explicit recurrent_group (ref: networks.py
    lstmemory_group:726) — same math as lstmemory, but the step is visible so
    other layers can hook per-step values."""
    from paddle_tpu_torch.dsl.layers import lstm_step_layer
    size = size or input.size // 4
    name = name or current_context().unique_name("lstm_group")

    def step(ipt):
        out_mem = memory(name=f"{name}_out", size=size)
        state_mem = memory(name=f"{name}_state", size=size)
        with mixed_layer(name=f"{name}_input_recurrent", size=size * 4,
                         act=LinearActivation(), bias_attr=mixed_bias_attr,
                         layer_attr=mixed_layer_attr) as m:
            m += full_matrix_projection(ipt, size=size * 4)
            m += full_matrix_projection(out_mem, size=size * 4, param_attr=param_attr)
        lstm = lstm_step_layer(
            input=m, state=state_mem, size=size, bias_attr=lstm_bias_attr,
            act=act, gate_act=gate_act, state_act=state_act, name=f"{name}_out",
            state_name=f"{name}_state", layer_attr=lstm_layer_attr)
        return lstm

    return recurrent_group(step=step, input=input, reverse=reverse,
                           name=f"{name}_recurrent_group")


def simple_gru(input: LayerOutput, size: int, name: Optional[str] = None,
               reverse: bool = False, mixed_param_attr=None, mixed_bias_attr=False,
               gru_param_attr=None, gru_bias_attr=None, act=None, gate_act=None,
               mixed_layer_attr=None, gru_layer_attr=None) -> LayerOutput:
    """fc(3*size) + grumemory (ref: networks.py simple_gru:937)."""
    with mixed_layer(name=f"{name}_transform" if name else None, size=size * 3,
                     act=LinearActivation(), bias_attr=mixed_bias_attr,
                     layer_attr=mixed_layer_attr) as m:
        m += full_matrix_projection(input, size=size * 3, param_attr=mixed_param_attr)
    return grumemory(input=m, name=name, reverse=reverse, bias_attr=gru_bias_attr,
                     param_attr=gru_param_attr, act=act, gate_act=gate_act,
                     layer_attr=gru_layer_attr)


def gru_group(input: LayerOutput, size: Optional[int] = None,
              name: Optional[str] = None, reverse: bool = False,
              gru_bias_attr=None, act=None, gate_act=None,
              gru_layer_attr=None) -> LayerOutput:
    """GRU as an explicit recurrent_group (ref: networks.py gru_group)."""
    size = size or input.size // 3
    name = name or current_context().unique_name("gru_group")

    def step(ipt):
        out_mem = memory(name=f"{name}_out", size=size)
        return gru_step_layer(input=ipt, output_mem=out_mem, size=size,
                              bias_attr=gru_bias_attr, act=act, gate_act=gate_act,
                              name=f"{name}_out", layer_attr=gru_layer_attr)

    return recurrent_group(step=step, input=input, reverse=reverse,
                           name=f"{name}_recurrent_group")


def bidirectional_lstm(input: LayerOutput, size: int, name: Optional[str] = None,
                       return_seq: bool = False, fwd_mat_param_attr=None,
                       bwd_mat_param_attr=None, **kwargs) -> LayerOutput:
    """(ref: networks.py bidirectional_lstm:1166)."""
    name = name or current_context().unique_name("bidirectional_lstm")
    fwd = simple_lstm(input=input, size=size, name=f"{name}_fwd", reverse=False,
                      mat_param_attr=fwd_mat_param_attr)
    bwd = simple_lstm(input=input, size=size, name=f"{name}_bwd", reverse=True,
                      mat_param_attr=bwd_mat_param_attr)
    if return_seq:
        return concat_layer(input=[fwd, bwd], name=name)
    fwd_end = last_seq(input=fwd, name=f"{name}_fwd_end")
    # reverse-scan outputs are position-aligned, so the backward summary
    # (full-sequence state) sits at position 0 (ref: networks.py:1156 first_seq)
    bwd_end = first_seq(input=bwd, name=f"{name}_bwd_end")
    return concat_layer(input=[fwd_end, bwd_end], name=name)


def simple_attention(encoded_sequence: LayerOutput,
                     encoded_proj: LayerOutput,
                     decoder_state: LayerOutput,
                     transform_param_attr=None,
                     softmax_param_attr=None,
                     name: Optional[str] = None,
                     fused: bool = True) -> LayerOutput:
    """Bahdanau-style additive attention (ref: networks.py simple_attention:1257).

    Must be called inside a recurrent_group step; encoded_sequence/encoded_proj
    are StaticInput aliases holding [B, T, D] sequences; decoder_state is a
    per-step [B, D] memory.  Returns the context vector [B, D].

    fused=True (default) emits ONE additive_attention_step layer — same
    math and the same two parameters (identical names, shapes and creation
    order, so seeded init and checkpoints match the composite) but executed
    as a single fused pass (a fused kernel on the device; graph/layers_attn.py).
    fused=False builds the reference's 5-layer composite.
    """
    from paddle_tpu_torch.config.schema import LayerConfig, LayerInput
    from paddle_tpu_torch.dsl.layers import _make_param, addto_layer, scaling_layer
    from paddle_tpu_torch.dsl.poolings import SumPooling
    name = name or current_context().unique_name("attention")
    if fused:
        w_name = _make_param(f"{name}_transform", 0,
                             [decoder_state.size, encoded_proj.size],
                             transform_param_attr)
        v_name = _make_param(f"{name}_scores", 0, [encoded_proj.size, 1],
                             softmax_param_attr)
        cfg = LayerConfig(name=name, type="additive_attention_step",
                          size=encoded_sequence.size)
        cfg.inputs.append(LayerInput(input_layer_name=decoder_state.name,
                                     input_parameter_name=w_name))
        cfg.inputs.append(LayerInput(input_layer_name=encoded_proj.name,
                                     input_parameter_name=v_name))
        cfg.inputs.append(LayerInput(input_layer_name=encoded_sequence.name))
        current_context().add_layer(cfg)
        return LayerOutput(name, "additive_attention_step",
                           encoded_sequence.size,
                           parents=[decoder_state, encoded_proj,
                                    encoded_sequence])
    with mixed_layer(name=f"{name}_transform", size=encoded_proj.size,
                     act=LinearActivation(), bias_attr=False) as proj_state:
        proj_state += full_matrix_projection(decoder_state, size=encoded_proj.size,
                                             param_attr=transform_param_attr)
    expanded = expand_layer(input=proj_state, expand_as=encoded_proj,
                            name=f"{name}_expand")
    combined = addto_layer(input=[expanded, encoded_proj], act=TanhActivation(),
                           name=f"{name}_combine")
    with mixed_layer(name=f"{name}_scores", size=1,
                     act=SequenceSoftmaxActivation(), bias_attr=False) as scores:
        scores += full_matrix_projection(combined, size=1,
                                         param_attr=softmax_param_attr)
    scaled = scaling_layer(weight=scores, input=encoded_sequence,
                           name=f"{name}_scale")
    return pooling_layer(input=scaled, pooling_type=SumPooling(),
                         name=f"{name}_pool")


def inputs(*layers) -> None:
    """Declare input order (ref: networks.py inputs:1376)."""
    ctx = current_context()
    ctx.model.input_layer_names = [l.name for l in layers]


def outputs(*layers) -> None:
    """Declare output layers (ref: networks.py outputs:1394)."""
    ctx = current_context()
    for l in layers:
        if l.name not in ctx.model.output_layer_names:
            ctx.model.output_layer_names.append(l.name)


def lstmemory_unit(input: LayerOutput, name: Optional[str] = None,
                   size: Optional[int] = None, param_attr=None, act=None,
                   gate_act=None, state_act=None, mixed_bias_attr=None,
                   lstm_bias_attr=None, mixed_layer_attr=None,
                   lstm_layer_attr=None,
                   get_output_layer_attr=None) -> LayerOutput:
    """One LSTM time step for use INSIDE a user recurrent_group (ref:
    networks.py lstmemory_unit:616) — not itself recurrent; typical use
    is attention decoders that need the per-step state visible.

    The reference contract: `input` is ALREADY projected to 4*size (the
    input-to-hidden matmuls are hoisted out of the unit for speed —
    ref networks.py:749-754), so it enters via identity_projection and
    only the recurrent out_mem projection holds parameters.  The cell
    state is published under `{name}_state` (the reference exposes it
    with a get_output_layer of that name; our lstm_step_layer publishes
    the state there directly, so get_output_layer_attr has nothing left
    to configure)."""
    if size is None:
        assert input.size % 4 == 0, (
            "lstmemory_unit expects its input pre-projected to 4*size "
            "(ref contract); add a mixed/fc projection before it")
        size = input.size // 4
    name = name or current_context().unique_name("lstmemory_unit")
    out_mem = memory(name=name, size=size)
    state_mem = memory(name=f"{name}_state", size=size)
    with mixed_layer(name=f"{name}_input_recurrent", size=size * 4,
                     act=LinearActivation(), bias_attr=mixed_bias_attr,
                     layer_attr=mixed_layer_attr) as m:
        m += identity_projection(input)
        m += full_matrix_projection(out_mem, size=size * 4,
                                    param_attr=param_attr)
    return lstm_step_layer(
        input=m, state=state_mem, size=size, bias_attr=lstm_bias_attr,
        act=act, gate_act=gate_act, state_act=state_act, name=name,
        state_name=f"{name}_state", layer_attr=lstm_layer_attr)


def gru_unit(input: LayerOutput, size: Optional[int] = None,
             name: Optional[str] = None, gru_bias_attr=None, act=None,
             gate_act=None, gru_layer_attr=None) -> LayerOutput:
    """One GRU time step for use INSIDE a user recurrent_group (ref:
    networks.py gru_unit:821)."""
    if size is None:
        assert input.size % 3 == 0
        size = input.size // 3
    name = name or current_context().unique_name("gru_unit")
    out_mem = memory(name=name, size=size)
    return gru_step_layer(input=input, output_mem=out_mem, size=size,
                          bias_attr=gru_bias_attr, act=act,
                          gate_act=gate_act, name=name,
                          layer_attr=gru_layer_attr)


def simple_gru2(input: LayerOutput, size: int, name: Optional[str] = None,
                reverse: bool = False, mixed_param_attr=None,
                mixed_bias_attr=None, gru_param_attr=None,
                gru_bias_attr=None, act=None, gate_act=None,
                mixed_layer_attr=None, gru_cell_attr=None) -> LayerOutput:
    """simple_gru via the fused grumemory cell (ref: networks.py
    simple_gru2:1019 — 'faster than simple_gru', which builds an explicit
    step group; here both run the same fused recurrence)."""
    name = name or current_context().unique_name("simple_gru2")
    proj = fc_layer(input=input, size=size * 3, act=LinearActivation(),
                    bias_attr=mixed_bias_attr, param_attr=mixed_param_attr,
                    name=f"{name}_transform", layer_attr=mixed_layer_attr)
    return grumemory(input=proj, name=name, reverse=reverse,
                     bias_attr=gru_bias_attr, param_attr=gru_param_attr,
                     act=act, gate_act=gate_act, layer_attr=gru_cell_attr)


def bidirectional_gru(input: LayerOutput, size: int,
                      name: Optional[str] = None, return_seq: bool = False,
                      last_seq_attr=None, first_seq_attr=None,
                      concat_attr=None, concat_act=None,
                      **kwargs) -> LayerOutput:
    """Forward + backward simple_gru2, concatenated (ref: networks.py
    bidirectional_gru:1081): the full sequences when return_seq, else the
    two end-of-scan summaries (position-aligned reverse scan puts the
    backward summary at position 0).  Per-direction knobs use the
    reference's fwd_/bwd_ kwarg prefixes; anything else unknown errors
    rather than silently vanishing."""
    name = name or current_context().unique_name("bidirectional_gru")
    fwd_kw = {k[len("fwd_"):]: v for k, v in kwargs.items()
              if k.startswith("fwd_")}
    bwd_kw = {k[len("bwd_"):]: v for k, v in kwargs.items()
              if k.startswith("bwd_")}
    unknown = [k for k in kwargs
               if not (k.startswith("fwd_") or k.startswith("bwd_"))]
    if unknown:
        raise TypeError(
            f"bidirectional_gru got unexpected kwargs {unknown}; "
            f"per-direction options take fwd_/bwd_ prefixes")
    fwd = simple_gru2(input=input, size=size, name=f"{name}_fwd",
                      reverse=False, **fwd_kw)
    bwd = simple_gru2(input=input, size=size, name=f"{name}_bwd",
                      reverse=True, **bwd_kw)
    if return_seq:
        return concat_layer(input=[fwd, bwd], name=name, act=concat_act,
                            layer_attr=concat_attr)
    fwd_end = last_seq(input=fwd, name=f"{name}_fwd_end",
                       layer_attr=last_seq_attr)
    bwd_end = first_seq(input=bwd, name=f"{name}_bwd_end",
                        layer_attr=first_seq_attr)
    return concat_layer(input=[fwd_end, bwd_end], name=name, act=concat_act,
                        layer_attr=concat_attr)


def img_conv_bn_pool(input: LayerOutput, filter_size: int, num_filters: int,
                     pool_size: int, name: Optional[str] = None,
                     pool_type=None, act=None, groups: int = 1,
                     conv_stride: int = 1, conv_padding: int = 0,
                     conv_bias_attr=None, num_channel: Optional[int] = None,
                     conv_param_attr=None, shared_bias: bool = True,
                     conv_layer_attr=None, bn_param_attr=None,
                     bn_bias_attr=None, bn_layer_attr=None,
                     pool_stride: int = 1, pool_padding: int = 0,
                     pool_layer_attr=None) -> LayerOutput:
    """conv -> batch_norm -> pool composite (ref: networks.py
    img_conv_bn_pool:232) — the linear-activation conv feeds BN, which
    carries the nonlinearity."""
    name = name or current_context().unique_name("img_conv_bn_pool")
    conv = img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channel, act=LinearActivation(), groups=groups,
        stride=conv_stride, padding=conv_padding, bias_attr=conv_bias_attr,
        param_attr=conv_param_attr, shared_biases=shared_bias,
        name=f"{name}_conv", layer_attr=conv_layer_attr)
    bn = batch_norm_layer(input=conv, act=act, name=f"{name}_bn",
                          bias_attr=bn_bias_attr, param_attr=bn_param_attr,
                          layer_attr=bn_layer_attr)
    return img_pool_layer(input=bn, pool_size=pool_size, name=f"{name}_pool",
                          pool_type=pool_type, stride=pool_stride,
                          padding=pool_padding, layer_attr=pool_layer_attr)


# ref: networks.py:137 — text_conv_pool IS sequence_conv_pool by another name
text_conv_pool = sequence_conv_pool
