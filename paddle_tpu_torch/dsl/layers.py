"""Layer constructors — the user-facing model DSL (the port's copy of
paddle_tpu/dsl/layers.py).

The equivalent of the reference's layer DSL
(ref: python/paddle/trainer_config_helpers/layers.py, 4,610 LoC: fc_layer:832,
lstmemory:993, grumemory:1100, recurrent_group:2786, beam_search:3087,
memory:2444, mixed_layer:703, img_conv_layer, cost layers, ...).  Each
constructor appends LayerConfig/ParameterConfig records to the active
ConfigContext and returns a LayerOutput handle; size inference follows the
reference's rules so stock configs produce the same graph shapes.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Union

from paddle_tpu_torch.config.schema import (
    ConvConfig,
    EvaluatorConfig,
    GeneratorConfig,
    LayerConfig,
    LayerInput,
    MemoryConfig,
    NormConfig,
    OperatorConfig,
    ParameterConfig,
    PoolConfig,
    ProjectionConfig,
    SubModelConfig,
)
from paddle_tpu_torch.dsl.activations import BaseActivation, LinearActivation, SigmoidActivation, TanhActivation, act_name
from paddle_tpu_torch.dsl.attrs import ExtraLayerAttribute, ParameterAttribute
from paddle_tpu_torch.dsl.base import LayerOutput, current_context
from paddle_tpu_torch.utils.geometry import conv_output_size
from paddle_tpu_torch.dsl.poolings import AvgPooling, BasePoolingType, FirstPooling, LastPooling, MaxPooling

__all__ = [
    "data_layer", "fc_layer", "embedding_layer", "mixed_layer", "addto_layer",
    "concat_layer", "dropout_layer", "full_matrix_projection",
    "trans_full_matrix_projection", "identity_projection", "table_projection",
    "dotmul_projection", "scaling_projection", "context_projection",
    "conv_projection", "dotmul_operator", "conv_operator", "default_device",
    "pooling_layer", "last_seq", "first_seq", "expand_layer", "seq_concat_layer",
    "seq_reshape_layer", "repeat_layer",
    "lstmemory", "grumemory", "recurrent_layer", "lstm_step_layer", "gru_step_layer",
    "mdlstm_layer", "sub_seq_layer",
    "img_conv_layer", "img_pool_layer", "img_cmrnorm_layer", "batch_norm_layer",
    "bilinear_interp_layer", "block_expand_layer", "maxout_layer", "spp_layer",
    "conv_shift_layer", "multi_head_attention_layer", "moe_layer",
    "layer_norm_layer",
    "maxid_layer", "sampling_id_layer", "eos_layer",
    "cos_sim", "cos_sim_vecmat", "trans_layer", "resize_layer",
    "slope_intercept_layer", "scaling_layer", "interpolation_layer",
    "power_layer", "linear_comb_layer", "convex_comb_layer", "outer_prod_layer",
    "tensor_layer", "multiplex_layer", "selective_fc_layer", "print_layer",
    "classification_cost", "regression_cost", "cross_entropy",
    "cross_entropy_with_selfnorm", "soft_binary_class_cross_entropy",
    "multi_binary_label_cross_entropy", "rank_cost", "lambda_cost",
    "huber_cost", "sum_cost", "auc_validation", "pnpair_validation",
    "crf_layer", "crf_decoding_layer", "ctc_layer", "nce_layer", "hsigmoid",
    "recurrent_group", "memory", "StaticInput", "SubsequenceInput",
    "GeneratedInput", "BaseGeneratedInput", "beam_search", "sub_network",
    "get_output_layer",
    "LayerOutput",
    "AggregateLevel", "ExpandLevel", "LayerType", "out_prod_layer",
    "sum_to_one_norm_layer",
]


# ---------------------------------------------------------------------------
# parameter helpers
# ---------------------------------------------------------------------------

def _make_param(
    layer_name: str,
    idx: Union[int, str],
    dims: list[int],
    attr: Optional[ParameterAttribute],
    *,
    is_bias: bool = False,
    sparse_size: int = 0,
) -> str:
    """Create (or reuse) a ParameterConfig; returns its name.  Naming follows
    the reference: _<layer>.w<i> / _<layer>.wbias (ref: config_parser.py
    Layer.create_input_parameter / create_bias_parameter)."""
    ctx = current_context()
    if attr is not None and attr.name:
        if ctx.has_parameter(attr.name):
            return attr.name  # shared parameter
        name = attr.name
    else:
        name = f"_{layer_name}.wbias" if is_bias else f"_{layer_name}.w{idx}"
    size = 1
    for d in dims:
        size *= d
    cfg = ParameterConfig(name=name, size=size, dims=list(dims))
    if is_bias:
        cfg.initial_strategy = "zero"
        cfg.initial_smart = False
    else:
        cfg.initial_smart = True  # std = 1/sqrt(fan_in) default (ref rule)
    if attr is not None:
        attr.apply(cfg)
    ctx.add_parameter(cfg)
    return name


def _bias_name(layer_name: str, bias_attr, dims: list[int]) -> str:
    """bias_attr semantics follow the reference: False = no bias, True/None =
    default bias, ParameterAttribute = custom."""
    if bias_attr is False:
        return ""
    attr = bias_attr if isinstance(bias_attr, ParameterAttribute) else None
    return _make_param(layer_name, "bias", dims, attr, is_bias=True)


def _layer_attr_fields(cfg: LayerConfig, layer_attr: Optional[ExtraLayerAttribute]) -> None:
    if layer_attr is not None:
        if layer_attr.drop_rate is not None:
            cfg.drop_rate = layer_attr.drop_rate
        if layer_attr.device is not None:
            cfg.device = layer_attr.device


def _name(name: Optional[str], prefix: str) -> str:
    return name if name else current_context().unique_name(prefix)


# ---------------------------------------------------------------------------
# data & fc
# ---------------------------------------------------------------------------

def data_layer(name: str, size: int, height: int = 0, width: int = 0) -> LayerOutput:
    """(ref: layers.py data_layer; DataLayer.cpp).  With height/width set,
    the output carries image geometry for downstream conv size inference."""
    ctx = current_context()
    cfg = LayerConfig(name=name, type="data", size=size)
    out = LayerOutput(name, "data", size)
    if height and width:
        cfg.attrs["height"] = height
        cfg.attrs["width"] = width
        out.img_size = width
        out.img_size_y = height
        out.num_filters = size // (height * width)
    ctx.add_layer(cfg)
    ctx.model.input_layer_names.append(name)
    return out


def fc_layer(
    input: Union[LayerOutput, Sequence[LayerOutput]],
    size: int,
    act: Optional[BaseActivation] = None,
    name: Optional[str] = None,
    param_attr: Optional[Union[ParameterAttribute, list]] = None,
    bias_attr=None,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """(ref: layers.py fc_layer:832; FullyConnectedLayer.cpp)."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    name = _name(name, "fc_layer")
    if act is None:
        act = TanhActivation()
    attrs = param_attr if isinstance(param_attr, list) else [param_attr] * len(inputs)
    cfg = LayerConfig(name=name, type="fc", size=size, active_type=act_name(act))
    for i, (inp, pa) in enumerate(zip(inputs, attrs)):
        pname = _make_param(name, i, [inp.size, size], pa)
        cfg.inputs.append(LayerInput(input_layer_name=inp.name, input_parameter_name=pname))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "fc", size, parents=inputs, activation=act,
                       seq_level=inputs[0].seq_level)


def embedding_layer(
    input: LayerOutput, size: int,
    name: Optional[str] = None,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """Table lookup over integer ids (ref: layers.py embedding_layer —
    implemented as mixed + table_projection, same as the reference)."""
    with mixed_layer(size=size, name=name, act=LinearActivation(),
                     bias_attr=False, layer_attr=layer_attr) as m:
        m += table_projection(input=input, size=size, param_attr=param_attr)
    return m


# ---------------------------------------------------------------------------
# mixed layer + projections/operators
# ---------------------------------------------------------------------------

class _Projection:
    """A pending projection: (source LayerOutput, ProjectionConfig, param spec)."""

    def __init__(self, source: LayerOutput, proj: ProjectionConfig,
                 param_dims: Optional[list[int]], param_attr, size: int):
        self.source = source
        self.proj = proj
        self.param_dims = param_dims
        self.param_attr = param_attr
        self.size = size


class _Operator:
    def __init__(self, sources: list[LayerOutput], op: OperatorConfig, size: int):
        self.sources = sources
        self.op = op
        self.size = size


class MixedLayer(LayerOutput):
    """Context-manager / += DSL for mixed layers (ref: layers.py mixed_layer:703)."""

    def __init__(self, size: int, name: str, act, bias_attr, layer_attr):
        super().__init__(name, "mixed", size)
        self._act = act
        self._bias_attr = bias_attr
        self._layer_attr = layer_attr
        self._projs: list[_Projection] = []
        self._ops: list[_Operator] = []
        self._finalized = False

    def __iadd__(self, other):
        assert not self._finalized, "mixed_layer already finalized"
        if isinstance(other, _Projection):
            self._projs.append(other)
        elif isinstance(other, _Operator):
            self._ops.append(other)
        else:
            raise TypeError(f"cannot add {type(other)} to mixed_layer")
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self._finalize()
        return False

    def _finalize(self):
        if self._finalized:
            return
        self._finalized = True
        if not self.size:
            # infer from first projection/operator
            self.size = self._projs[0].size if self._projs else self._ops[0].size
        cfg = LayerConfig(name=self.name, type="mixed", size=self.size,
                          active_type=act_name(self._act))
        seq_level = 0
        for i, p in enumerate(self._projs):
            if not p.proj.output_size:
                p.proj.output_size = self.size
            if p.param_dims is None:
                # projection declared without an explicit size (the
                # reference allows e.g. full_matrix_projection(input=x)
                # inside mixed_layer(size=N)): dims resolve against the
                # mixed layer's size at finalize time
                if p.proj.type in ("fc", "full_matrix", "table"):
                    p.param_dims = [p.proj.input_size, self.size]
                elif p.proj.type == "trans_full_matrix":
                    p.param_dims = [self.size, p.proj.input_size]
            pname = ""
            if p.param_dims is not None:
                pname = _make_param(self.name, i, p.param_dims, p.param_attr)
            cfg.inputs.append(LayerInput(
                input_layer_name=p.source.name, input_parameter_name=pname, proj=p.proj))
            self.parents.append(p.source)
            seq_level = max(seq_level, p.source.seq_level)
        n_proj = len(self._projs)
        for op in self._ops:
            op.op.input_indices = list(range(len(cfg.inputs), len(cfg.inputs) + len(op.sources)))
            op.op.input_sizes = [s.size for s in op.sources]
            if not op.op.output_size:
                op.op.output_size = self.size
            for s in op.sources:
                cfg.inputs.append(LayerInput(input_layer_name=s.name))
                self.parents.append(s)
            cfg.operators.append(op.op)
        cfg.bias_parameter_name = _bias_name(self.name, self._bias_attr, [1, self.size])
        _layer_attr_fields(cfg, self._layer_attr)
        self.seq_level = seq_level
        current_context().add_layer(cfg)


def mixed_layer(
    size: int = 0,
    input: Optional[Sequence] = None,
    name: Optional[str] = None,
    act: Optional[BaseActivation] = None,
    bias_attr=False,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> MixedLayer:
    """(ref: layers.py mixed_layer:703)."""
    name = _name(name, "mixed")
    if act is None:
        act = LinearActivation()
    m = MixedLayer(size=size, name=name, act=act, bias_attr=bias_attr,
                   layer_attr=layer_attr)
    if input is not None:
        for p in input if isinstance(input, (list, tuple)) else [input]:
            m += p
        m._finalize()
    return m


def full_matrix_projection(input: LayerOutput, size: int = 0,
                           param_attr: Optional[ParameterAttribute] = None) -> _Projection:
    """(ref: layers.py full_matrix_projection:308; FullMatrixProjection.cpp)."""
    proj = ProjectionConfig(type="fc", input_size=input.size, output_size=size)
    return _Projection(input, proj, [input.size, size] if size else None, param_attr, size)


def trans_full_matrix_projection(input: LayerOutput, size: int = 0,
                                 param_attr: Optional[ParameterAttribute] = None) -> _Projection:
    """(ref: TransposedFullMatrixProjection.cpp)."""
    proj = ProjectionConfig(type="trans_full_matrix", input_size=input.size, output_size=size)
    return _Projection(input, proj, [size, input.size] if size else None, param_attr, size)


def identity_projection(input: LayerOutput, offset: int = 0) -> _Projection:
    """(ref: IdentityProjection.cpp). Offset slicing unsupported-yet."""
    assert offset == 0, "identity_projection offset not yet supported"
    proj = ProjectionConfig(type="identity", input_size=input.size, output_size=input.size)
    return _Projection(input, proj, None, None, input.size)


def table_projection(input: LayerOutput, size: int = 0,
                     param_attr: Optional[ParameterAttribute] = None) -> _Projection:
    """(ref: TableProjection.cpp) — embedding rows; input must be ids."""
    proj = ProjectionConfig(type="table", input_size=input.size, output_size=size)
    return _Projection(input, proj, [input.size, size] if size else None, param_attr, size)


def dotmul_projection(input: LayerOutput,
                      param_attr: Optional[ParameterAttribute] = None) -> _Projection:
    """(ref: DotMulProjection.cpp): out = x .* w."""
    proj = ProjectionConfig(type="dot_mul", input_size=input.size, output_size=input.size)
    return _Projection(input, proj, [1, input.size], param_attr, input.size)


def scaling_projection(input: LayerOutput,
                       param_attr: Optional[ParameterAttribute] = None) -> _Projection:
    """(ref: ScalingProjection.cpp): out = w[0] * x, one learned scalar."""
    proj = ProjectionConfig(type="scaling", input_size=input.size, output_size=input.size)
    return _Projection(input, proj, [1, 1], param_attr, input.size)


def default_device(device: int = 0) -> None:
    """No-op: the reference pins layers to GPUs (ref: config_parser.py
    default_device); here placement is mesh sharding, set via
    ParameterAttribute.partition_spec / Trainer(mesh=...)."""
    return None


def context_projection(
    input: LayerOutput, context_len: int, context_start: Optional[int] = None,
    padding_attr=False,
) -> _Projection:
    """Sliding window concat over time (ref: layers.py context_projection:574;
    ContextProjection.cpp)."""
    start = context_start if context_start is not None else -(context_len // 2)
    trainable = isinstance(padding_attr, ParameterAttribute)
    proj = ProjectionConfig(
        type="context", input_size=input.size,
        output_size=input.size * context_len,
        context_start=start, context_length=context_len,
        trainable_padding=trainable)
    total_pad = max(0, -start) + max(0, start + context_len - 1)
    dims = [total_pad, input.size] if trainable else None
    return _Projection(input, proj, dims, padding_attr if trainable else None,
                       input.size * context_len)


def conv_projection(
    input: LayerOutput, filter_size: int, num_filters: int,
    num_channels: Optional[int] = None, stride: int = 1, padding: int = 0,
    groups: int = 1, param_attr: Optional[ParameterAttribute] = None,
) -> _Projection:
    """(ref: ConvProjection.cpp)."""
    channels = num_channels if num_channels else input.num_filters
    img = input.img_size if input.img_size else int(math.sqrt(input.size // channels))
    out_x = conv_output_size(img, filter_size, stride, padding)
    conv = ConvConfig(filter_size=filter_size, channels=channels, stride=stride,
                      padding=padding, groups=groups, img_size=img, img_size_y=img,
                      output_x=out_x, output_y=out_x)
    out_size = num_filters * out_x * out_x
    proj = ProjectionConfig(type="conv", input_size=input.size, output_size=out_size,
                            conv=conv, num_filters=num_filters)
    dims = [num_filters, channels // groups * filter_size * filter_size]
    p = _Projection(input, proj, dims, param_attr, out_size)
    return p


def dotmul_operator(a: LayerOutput, b: LayerOutput, scale: float = 1.0) -> _Operator:
    """(ref: DotMulOperator.cpp): out += scale * a .* b."""
    op = OperatorConfig(type="dot_mul", dotmul_scale=scale, output_size=a.size)
    return _Operator([a, b], op, a.size)


def conv_operator(
    img: LayerOutput, filter: LayerOutput, filter_size: int, num_filters: int,
    num_channels: Optional[int] = None, stride: int = 1, padding: int = 0,
) -> _Operator:
    """Per-sample-filter convolution (ref: layers.py conv_operator:3317)."""
    channels = num_channels if num_channels else img.num_filters
    imgsz = img.img_size if img.img_size else int(math.sqrt(img.size // channels))
    out_x = conv_output_size(imgsz, filter_size, stride, padding)
    conv = ConvConfig(filter_size=filter_size, channels=channels, stride=stride,
                      padding=padding, img_size=imgsz, img_size_y=imgsz,
                      output_x=out_x, output_y=out_x)
    out_size = num_filters * out_x * out_x
    op = OperatorConfig(type="conv", conv=conv, num_filters=num_filters,
                        output_size=out_size)
    return _Operator([img, filter], op, out_size)


# ---------------------------------------------------------------------------
# simple combination layers
# ---------------------------------------------------------------------------

def _simple_layer(type_: str, inputs: list[LayerOutput], size: int, *,
                  name: Optional[str] = None, act=None, bias_attr=False,
                  layer_attr=None, cfg_extra: Optional[dict] = None,
                  params: Optional[list] = None,
                  prefix: Optional[str] = None) -> LayerOutput:
    name = _name(name, prefix or type_)
    cfg = LayerConfig(name=name, type=type_, size=size, active_type=act_name(act))
    for i, inp in enumerate(inputs):
        li = LayerInput(input_layer_name=inp.name)
        if params and params[i] is not None:
            li.input_parameter_name = _make_param(name, i, params[i][0], params[i][1])
        cfg.inputs.append(li)
    if bias_attr is not False:
        cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size])
    if cfg_extra:
        for k, v in cfg_extra.items():
            if hasattr(cfg, k) and k != "attrs":
                setattr(cfg, k, v)
            else:
                cfg.attrs[k] = v
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    seq_level = max((i.seq_level for i in inputs), default=0)
    return LayerOutput(name, type_, size, parents=inputs, seq_level=seq_level)


def addto_layer(input: Sequence[LayerOutput], act=None, name=None,
                bias_attr=False, layer_attr=None) -> LayerOutput:
    """(ref: AddtoLayer.cpp)."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    out = _simple_layer("addto", inputs, inputs[0].size, name=name, act=act,
                        bias_attr=bias_attr, layer_attr=layer_attr)
    # elementwise add preserves image geometry (residual shortcuts feed
    # pooling/conv downstream — ref: AddtoLayer keeps the input's frame size)
    out.num_filters = inputs[0].num_filters
    out.img_size = inputs[0].img_size
    out.img_size_y = inputs[0].img_size_y
    return out


def concat_layer(input: Sequence[LayerOutput], act=None, name=None,
                 layer_attr=None) -> LayerOutput:
    """(ref: ConcatenateLayer.cpp)."""
    inputs = list(input)
    size = sum(i.size for i in inputs)
    return _simple_layer("concat", inputs, size, name=name, act=act,
                         layer_attr=layer_attr)


def dropout_layer(input: LayerOutput, dropout_rate: float, name=None) -> LayerOutput:
    """(ref: networks.py dropout_layer:1359 — addto with dropout attr)."""
    return addto_layer(input=[input], name=name,
                       layer_attr=ExtraLayerAttribute(drop_rate=dropout_rate))


# ---------------------------------------------------------------------------
# sequence layers
# ---------------------------------------------------------------------------

def pooling_layer(input: LayerOutput, pooling_type: Optional[BasePoolingType] = None,
                  name=None, bias_attr=False, agg_level: str = "to_no_sequence",
                  layer_attr=None) -> LayerOutput:
    """Sequence pooling (ref: layers.py pooling_layer; SequencePoolLayer.cpp).

    agg_level only matters for NESTED (sub-sequence) inputs:
    AggregateLevel.EACH_TIMESTEP ('non-seq', the reference's default —
    this function's own default behaves the same) pools over ALL
    timesteps ignoring sub boundaries; AggregateLevel.EACH_SEQUENCE
    ('seq') pools each sub-sequence to one vector, giving a sequence
    output."""
    pt = pooling_type or MaxPooling()
    extra: dict[str, Any] = {}
    type_ = pt.name
    if isinstance(pt, (AvgPooling,)) or getattr(pt, "strategy", None):
        extra["average_strategy"] = getattr(pt, "strategy", "average")
    if getattr(pt, "select_first", False):
        extra["select_first"] = True
    if agg_level in ("non-seq", "seq"):      # the AggregateLevel constants
        extra["trans_type"] = agg_level      # the schema field for levels
    out = _simple_layer(type_, [input], input.size, name=name, bias_attr=bias_attr,
                        layer_attr=layer_attr, cfg_extra=extra, prefix="pool")
    out.seq_level = 0 if agg_level == "non-seq" \
        else max(input.seq_level - 1, 0)
    return out


def last_seq(input: LayerOutput, name=None, agg_level: str = "to_no_sequence",
             layer_attr=None) -> LayerOutput:
    """(ref: layers.py last_seq; SequenceLastInstanceLayer.cpp).
    agg_level as in pooling_layer (nested inputs only)."""
    extra = ({"trans_type": agg_level}
             if agg_level in ("non-seq", "seq") else None)
    out = _simple_layer("seqlastins", [input], input.size, name=name,
                        layer_attr=layer_attr, cfg_extra=extra,
                        prefix="seqlastins")
    out.seq_level = 0 if agg_level == "non-seq" \
        else max(input.seq_level - 1, 0)
    return out


def first_seq(input: LayerOutput, name=None, agg_level: str = "to_no_sequence",
              layer_attr=None) -> LayerOutput:
    """(ref: layers.py first_seq).  agg_level as in pooling_layer."""
    extra: dict[str, Any] = {"select_first": True}
    if agg_level in ("non-seq", "seq"):
        extra["trans_type"] = agg_level
    out = _simple_layer("seqlastins", [input], input.size, name=name,
                        layer_attr=layer_attr, cfg_extra=extra,
                        prefix="seqfirstins")
    out.seq_level = 0 if agg_level == "non-seq" \
        else max(input.seq_level - 1, 0)
    return out


def expand_layer(input: LayerOutput, expand_as: LayerOutput, name=None,
                 bias_attr=False, expand_level: str = "from_no_sequence",
                 layer_attr=None) -> LayerOutput:
    """(ref: ExpandLayer.cpp)."""
    out = _simple_layer("expand", [input, expand_as], input.size, name=name,
                        bias_attr=bias_attr, layer_attr=layer_attr, prefix="expand")
    out.seq_level = expand_as.seq_level
    return out


def repeat_layer(input: LayerOutput, num_repeats: int, name=None) -> LayerOutput:
    """Tile features (ref: FeatureMapExpandLayer.cpp)."""
    return _simple_layer("featmap_expand", [input], input.size * num_repeats,
                         name=name, cfg_extra={"num_filters": num_repeats},
                         prefix="repeat")


def seq_concat_layer(a: LayerOutput, b: LayerOutput, name=None,
                     layer_attr=None) -> LayerOutput:
    """(ref: SequenceConcatLayer.cpp)."""
    assert a.size == b.size
    return _simple_layer("seqconcat", [a, b], a.size, name=name,
                         layer_attr=layer_attr, prefix="seqconcat")


def seq_reshape_layer(input: LayerOutput, reshape_size: int, name=None,
                      act=None, layer_attr=None, bias_attr=False) -> LayerOutput:
    """(ref: SequenceReshapeLayer.cpp)."""
    return _simple_layer("seqreshape", [input], reshape_size, name=name, act=act,
                         bias_attr=bias_attr, layer_attr=layer_attr,
                         prefix="seqreshape")


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------

def lstmemory(
    input: LayerOutput,
    name: Optional[str] = None,
    reverse: bool = False,
    act: Optional[BaseActivation] = None,
    gate_act: Optional[BaseActivation] = None,
    state_act: Optional[BaseActivation] = None,
    bias_attr=None,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """LSTM over a pre-projected 4x input (ref: layers.py lstmemory:993;
    LstmLayer.cpp).  input.size must be 4*hidden; bias is [7*hidden] with
    peepholes, matching the reference."""
    assert input.size % 4 == 0, "lstmemory input must be 4 * hidden_size"
    size = input.size // 4
    name = _name(name, "lstmemory")
    cfg = LayerConfig(name=name, type="lstmemory", size=size,
                      active_type=act_name(act or TanhActivation()),
                      reversed=reverse)
    cfg.attrs["active_gate_type"] = act_name(gate_act or SigmoidActivation())
    cfg.attrs["active_state_type"] = act_name(state_act or TanhActivation())
    pname = _make_param(name, 0, [size, size * 4], param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=input.name, input_parameter_name=pname))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size * 7])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "lstmemory", size, parents=[input],
                       seq_level=input.seq_level)


def grumemory(
    input: LayerOutput,
    name: Optional[str] = None,
    reverse: bool = False,
    act: Optional[BaseActivation] = None,
    gate_act: Optional[BaseActivation] = None,
    bias_attr=None,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """GRU over a pre-projected 3x input (ref: layers.py grumemory:1100;
    GatedRecurrentLayer.cpp)."""
    assert input.size % 3 == 0, "grumemory input must be 3 * hidden_size"
    size = input.size // 3
    name = _name(name, "gru")
    cfg = LayerConfig(name=name, type="gated_recurrent", size=size,
                      active_type=act_name(act or TanhActivation()),
                      reversed=reverse)
    cfg.attrs["active_gate_type"] = act_name(gate_act or SigmoidActivation())
    pname = _make_param(name, 0, [size, size * 3], param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=input.name, input_parameter_name=pname))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size * 3])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "gated_recurrent", size, parents=[input],
                       seq_level=input.seq_level)


def mdlstm_layer(
    input: LayerOutput,
    height: int,
    width: int,
    name: Optional[str] = None,
    directions=(True, True),
    act: Optional[BaseActivation] = None,
    gate_act: Optional[BaseActivation] = None,
    state_act: Optional[BaseActivation] = None,
    bias_attr=None,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """2-D MDLSTM over a pre-projected 5x input grid (ref: MDLstmLayer.cpp:
    weight [D, 5D], bias [(5+4)D] incl. peepholes)."""
    assert input.size % 5 == 0, "mdlstm_layer input must be 5 * hidden_size"
    size = input.size // 5
    name = _name(name, "mdlstm")
    cfg = LayerConfig(name=name, type="mdlstmemory", size=size,
                      active_type=act_name(act or TanhActivation()))
    cfg.attrs["active_gate_type"] = act_name(gate_act or SigmoidActivation())
    cfg.attrs["active_state_type"] = act_name(state_act or TanhActivation())
    cfg.attrs["height"] = height
    cfg.attrs["width"] = width
    cfg.attrs["directions"] = tuple(bool(d) for d in directions)
    pname = _make_param(name, 0, [size, size * 5], param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=input.name, input_parameter_name=pname))
    if bias_attr is False:
        raise ValueError("mdlstm_layer requires a bias parameter — it carries "
                         "the peephole weights (ref: MDLstmLayer.cpp init "
                         "LOG(FATAL) without bias)")
    cfg.bias_parameter_name = _bias_name(name, bias_attr if bias_attr is not None else True,
                                         [1, size * 9])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "mdlstmemory", size, parents=[input],
                       seq_level=input.seq_level)


def sub_seq_layer(input: LayerOutput, offsets: LayerOutput, sizes: LayerOutput,
                  name=None, bias_attr=False, layer_attr=None) -> LayerOutput:
    """Per-sequence slice by offset/size inputs (ref: SubSequenceLayer.cpp)."""
    return _simple_layer("subseq", [input, offsets, sizes], input.size,
                         name=name, bias_attr=bias_attr, layer_attr=layer_attr,
                         prefix="subseq")


def lstm_step_layer(input: LayerOutput, state: LayerOutput, size: int,
                    bias_attr=None, act=None, gate_act=None, state_act=None,
                    name=None, state_name: Optional[str] = None,
                    layer_attr=None) -> LayerOutput:
    """One LSTM step for use inside recurrent_group (ref: LstmStepLayer.cpp):
    input is [B,4*size] pre-projected (incl. recurrent term), state is the
    previous cell memory.  Publishes the new cell state under `state_name` so
    a memory() can link to it."""
    name = _name(name, "lstm_step")
    cfg = LayerConfig(name=name, type="lstm_step", size=size,
                      active_type=act_name(act or TanhActivation()))
    cfg.attrs["active_gate_type"] = act_name(gate_act or SigmoidActivation())
    cfg.attrs["active_state_type"] = act_name(state_act or TanhActivation())
    cfg.attrs["state_name"] = state_name or f"{name}_state"
    cfg.inputs.append(LayerInput(input_layer_name=input.name))
    cfg.inputs.append(LayerInput(input_layer_name=state.name))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size * 7])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "lstm_step", size, parents=[input, state])


def gru_step_layer(input: LayerOutput, output_mem: LayerOutput, size: Optional[int] = None,
                   bias_attr=None, act=None, gate_act=None, name=None,
                   param_attr=None, layer_attr=None) -> LayerOutput:
    """One GRU step for use inside recurrent_group (ref: GruStepLayer.cpp):
    input is [B,3*size] pre-projected; output_mem the previous hidden; owns the
    recurrent weight [size, 3*size]."""
    size = size or input.size // 3
    name = _name(name, "gru_step")
    cfg = LayerConfig(name=name, type="gru_step", size=size,
                      active_type=act_name(act or TanhActivation()))
    cfg.attrs["active_gate_type"] = act_name(gate_act or SigmoidActivation())
    pname = _make_param(name, 0, [size, size * 3], param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=input.name, input_parameter_name=pname))
    cfg.inputs.append(LayerInput(input_layer_name=output_mem.name))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size * 3])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "gru_step", size, parents=[input, output_mem])


def recurrent_layer(input: LayerOutput, name=None, reverse: bool = False,
                    act=None, bias_attr=None, param_attr=None,
                    layer_attr=None) -> LayerOutput:
    """Vanilla RNN (ref: RecurrentLayer.cpp)."""
    size = input.size
    name = _name(name, "recurrent")
    cfg = LayerConfig(name=name, type="recurrent", size=size,
                      active_type=act_name(act or TanhActivation()), reversed=reverse)
    pname = _make_param(name, 0, [size, size], param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=input.name, input_parameter_name=pname))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "recurrent", size, parents=[input],
                       seq_level=input.seq_level)


# ---------------------------------------------------------------------------
# image layers
# ---------------------------------------------------------------------------

def img_conv_layer(
    input: LayerOutput,
    filter_size: int,
    num_filters: int,
    name: Optional[str] = None,
    num_channels: Optional[int] = None,
    act: Optional[BaseActivation] = None,
    groups: int = 1,
    stride: int = 1,
    padding: int = 0,
    bias_attr=None,
    param_attr: Optional[ParameterAttribute] = None,
    shared_biases: bool = True,
    layer_attr: Optional[ExtraLayerAttribute] = None,
    trans: bool = False,
) -> LayerOutput:
    """(ref: layers.py img_conv_layer; ExpandConvLayer.cpp)."""
    name = _name(name, "conv")
    if num_channels is None:
        num_channels = input.num_filters if input.num_filters else 1
    img = input.img_size if input.img_size else int(math.sqrt(input.size // num_channels))
    if not trans:
        out_x = conv_output_size(img, filter_size, stride, padding)
    else:
        # transposed conv output size: inverse of conv_output_size
        out_x = (img - 1) * stride - 2 * padding + filter_size
    conv = ConvConfig(filter_size=filter_size, channels=num_channels, stride=stride,
                      padding=padding, groups=groups, img_size=img, img_size_y=img,
                      output_x=out_x, output_y=out_x)
    size = num_filters * out_x * out_x
    cfg = LayerConfig(name=name, type="exconvt" if trans else "exconv", size=size,
                      active_type=act_name(act or TanhActivation()),
                      num_filters=num_filters, conv=conv, shared_biases=shared_biases)
    if param_attr is None:
        # reference conv init: std = sqrt(1 / (fan_in)) with fan_in = C/g*f*f
        param_attr = ParameterAttribute(
            initial_std=math.sqrt(1.0 / (num_channels // groups * filter_size * filter_size)))
    wdims = [num_filters, num_channels // groups * filter_size * filter_size]
    pname = _make_param(name, 0, wdims, param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=input.name, input_parameter_name=pname))
    bias_dims = [1, num_filters] if shared_biases else [1, size]
    cfg.bias_parameter_name = _bias_name(name, bias_attr, bias_dims)
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, cfg.type, size, parents=[input],
                       num_filters=num_filters, img_size=out_x, img_size_y=out_x,
                       seq_level=input.seq_level)


def img_pool_layer(
    input: LayerOutput,
    pool_size: int,
    name: Optional[str] = None,
    num_channels: Optional[int] = None,
    pool_type: Optional[BasePoolingType] = None,
    stride: int = 1,
    padding: int = 0,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """(ref: layers.py img_pool_layer; PoolLayer.cpp)."""
    name = _name(name, "pool")
    if num_channels is None:
        num_channels = input.num_filters
    img = input.img_size if input.img_size else int(math.sqrt(input.size // num_channels))
    ptype = "max-projection" if (pool_type is None or isinstance(pool_type, MaxPooling)) \
        else "avg-projection"
    out_x = conv_output_size(img, pool_size, stride, padding, caffe_mode=False)
    pool = PoolConfig(pool_type=ptype, channels=num_channels, size_x=pool_size,
                      stride=stride, padding=padding, img_size=img, img_size_y=img,
                      output_x=out_x, output_y=out_x)
    size = num_channels * out_x * out_x
    cfg = LayerConfig(name=name, type="pool", size=size, pool=pool)
    cfg.inputs.append(LayerInput(input_layer_name=input.name))
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "pool", size, parents=[input],
                       num_filters=num_channels, img_size=out_x, img_size_y=out_x,
                       seq_level=input.seq_level)


def img_cmrnorm_layer(input: LayerOutput, size: int = 5, scale: float = 0.0128,
                      power: float = 0.75, name=None, num_channels=None,
                      layer_attr=None) -> LayerOutput:
    """Cross-map response norm (ref: layers.py img_cmrnorm_layer;
    NormProjectionLayer.cpp)."""
    name = _name(name, "norm")
    if num_channels is None:
        num_channels = input.num_filters
    img = input.img_size if input.img_size else int(math.sqrt(input.size // num_channels))
    norm = NormConfig(norm_type="cmrnorm-projection", channels=num_channels,
                      size=size, scale=scale / size, pow=power, img_size=img,
                      img_size_y=img, output_x=img, output_y=img)
    cfg = LayerConfig(name=name, type="norm", size=input.size, norm=norm)
    cfg.inputs.append(LayerInput(input_layer_name=input.name))
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "norm", input.size, parents=[input],
                       num_filters=num_channels, img_size=img, img_size_y=img)


def batch_norm_layer(input: LayerOutput, act=None, name=None, num_channels=None,
                     bias_attr=None, param_attr=None, layer_attr=None,
                     use_global_stats=None,
                     moving_average_fraction: float = 0.9) -> LayerOutput:
    """(ref: layers.py batch_norm_layer; BatchNormalizationLayer.cpp).
    Moving mean/var are executor state, not parameters — the reference's
    static mean/var parameter pair collapses into the state dict."""
    name = _name(name, "batch_norm")
    img = 0
    if num_channels is None:
        num_channels = input.num_filters if input.num_filters else input.size
    if input.num_filters:
        img = input.img_size
    cfg = LayerConfig(name=name, type="batch_norm", size=input.size,
                      active_type=act_name(act or LinearActivation()),
                      use_global_stats=use_global_stats,
                      moving_average_fraction=moving_average_fraction)
    if img:
        cfg.conv = ConvConfig(channels=num_channels, img_size=img, img_size_y=img)
    if param_attr is None:
        param_attr = ParameterAttribute(initial_mean=1.0, initial_std=0.0)
        # scale starts at 1 (ref: BatchNormBaseLayer init)
    pa = ParameterConfig(name=f"_{name}.w0", size=num_channels, dims=[1, num_channels],
                         initial_strategy="zero", initial_mean=1.0, initial_std=0.0)
    pa.initial_strategy = "normal"
    if isinstance(param_attr, ParameterAttribute):
        param_attr.apply(pa)
    pa.initial_mean = 1.0 if pa.initial_mean == 0.0 else pa.initial_mean
    pa.initial_std = 0.0
    current_context().add_parameter(pa)
    cfg.inputs.append(LayerInput(input_layer_name=input.name,
                                 input_parameter_name=pa.name))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, num_channels])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "batch_norm", input.size, parents=[input],
                       num_filters=input.num_filters, img_size=input.img_size,
                       img_size_y=input.img_size_y, seq_level=input.seq_level)


def bilinear_interp_layer(input: LayerOutput, out_size_x: int, out_size_y: int,
                          name=None, layer_attr=None) -> LayerOutput:
    """(ref: BilinearInterpLayer.cpp)."""
    C = input.num_filters
    size = C * out_size_x * out_size_y
    out = _simple_layer("bilinear_interp", [input], size, name=name,
                        layer_attr=layer_attr,
                        cfg_extra={"channels": C, "img_size_x": input.img_size,
                                   "img_size_y": input.img_size_y or input.img_size,
                                   "out_size_x": out_size_x, "out_size_y": out_size_y})
    out.num_filters = C
    out.img_size = out_size_x
    out.img_size_y = out_size_y
    return out


def block_expand_layer(input: LayerOutput, block_x: int, block_y: int,
                       stride_x: int = 1, stride_y: int = 1,
                       padding_x: int = 0, padding_y: int = 0,
                       num_channels: Optional[int] = None, name=None,
                       layer_attr=None) -> LayerOutput:
    """im2col to sequence (ref: BlockExpandLayer.cpp)."""
    C = num_channels if num_channels else input.num_filters
    size = C * block_x * block_y
    out = _simple_layer(
        "blockexpand", [input], size, name=name, layer_attr=layer_attr,
        cfg_extra={"channels": C, "img_size_x": input.img_size,
                   "img_size_y": input.img_size_y or input.img_size,
                   "block_x": block_x, "block_y": block_y,
                   "stride_x": stride_x, "stride_y": stride_y,
                   "padding_x": padding_x, "padding_y": padding_y})
    out.seq_level = 1
    return out


def maxout_layer(input: LayerOutput, groups: int, num_channels=None, name=None,
                 layer_attr=None) -> LayerOutput:
    """(ref: MaxOutLayer.cpp)."""
    C = num_channels if num_channels else input.num_filters
    size = input.size // groups
    out = _simple_layer("maxout", [input], size, name=name, layer_attr=layer_attr,
                        cfg_extra={"groups": groups, "channels": C})
    out.num_filters = C // groups
    out.img_size = input.img_size
    out.img_size_y = input.img_size_y
    return out


def spp_layer(input: LayerOutput, pyramid_height: int, num_channels=None,
              pool_type=None, name=None, layer_attr=None) -> LayerOutput:
    """(ref: SpatialPyramidPoolLayer.cpp)."""
    C = num_channels if num_channels else input.num_filters
    img = input.img_size
    total = sum((2 ** l) * (2 ** l) for l in range(pyramid_height))
    ptype = "max-projection" if (pool_type is None or isinstance(pool_type, MaxPooling)) \
        else "avg-projection"
    name = _name(name, "spp")
    pool = PoolConfig(pool_type=ptype, channels=C, img_size=img, img_size_y=img)
    cfg = LayerConfig(name=name, type="spp", size=C * total, pool=pool)
    cfg.attrs["pyramid_height"] = pyramid_height
    cfg.inputs.append(LayerInput(input_layer_name=input.name))
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "spp", C * total, parents=[input])


def conv_shift_layer(a: LayerOutput, b: LayerOutput, name=None) -> LayerOutput:
    """Circular 1-D convolution of each row of a by kernel b
    (ref: ConvShiftLayer.cpp)."""
    return _simple_layer("conv_shift", [a, b], a.size, name=name,
                         prefix="conv_shift")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def multi_head_attention_layer(
    query: LayerOutput,
    key: Optional[LayerOutput] = None,
    value: Optional[LayerOutput] = None,
    *,
    size: int,
    num_heads: int,
    causal: bool = False,
    block_k: Optional[int] = None,
    block_k_min: Optional[int] = None,
    attn_impl: Optional[str] = None,
    num_kv_heads: Optional[int] = None,
    window: Optional[int] = None,
    use_rope: bool = False,
    rope_theta: float = 10000.0,
    name: Optional[str] = None,
    param_attr: Optional[Union[ParameterAttribute, list]] = None,
    bias_attr=False,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """Multi-head scaled-dot-product attention over padded sequences — NEW
    capability (the reference's closest analog is the additive-attention
    composite simple_attention, ref: networks.py:1257).  Self-attention when
    key/value are omitted.  Picks dense/flash/blockwise/ring
    automatically (graph/layers_attn.py; attn_impl forces one of
    dense/flash/blockwise/ring/ulysses — 'ulysses' is the all-to-all
    context-parallel layout, needing a `seq` mesh axis and
    num_heads % seq_axis == 0); with a `seq`
    mesh axis the sequence is context-parallel via ring attention
    (parallel/context.py).

    param_attr: one attribute applied to all four projections (q/k/v/out), or
    a list of four.  A single NAMED attribute would tie all projections to
    one parameter, which is never what you want — pass a list instead."""
    key = key if key is not None else query
    value = value if value is not None else key
    assert size % num_heads == 0, "size must divide evenly into heads"
    if num_kv_heads is not None:
        assert num_kv_heads >= 1 and num_heads % num_kv_heads == 0, \
            f"num_kv_heads must be >= 1 and divide num_heads " \
            f"(got {num_kv_heads} for {num_heads} heads)"
    assert window is None or window >= 1, \
        f"window must be >= 1 (got {window}); window=0 would mask every key"
    assert not use_rope or (size // num_heads) % 2 == 0, \
        f"use_rope needs an even head dim (got size {size} / {num_heads} " \
        f"heads = {size // num_heads})"
    assert not use_rope or key is query, \
        "use_rope requires self-attention: rotating decoder queries and " \
        "unrelated encoder keys by their own arange positions imposes a " \
        "spurious relative-position bias in cross-attention"
    if isinstance(param_attr, ParameterAttribute):
        assert not param_attr.name, \
            "a single named param_attr would share ONE matrix across the " \
            "q/k/v/out projections; pass a list of 4 ParameterAttributes"
        attrs = [param_attr] * 4
    else:
        attrs = list(param_attr) if param_attr else [None] * 4
        assert len(attrs) == 4, "param_attr list must have 4 entries (q,k,v,out)"
    name = _name(name, "mha_layer")
    cfg = LayerConfig(name=name, type="multi_head_attention", size=size,
                      active_type="")
    cfg.attrs["num_heads"] = num_heads
    cfg.attrs["causal"] = causal
    if block_k is not None:          # key-block size (blockwise/flash paths)
        cfg.attrs["block_k"] = block_k
    if block_k_min is not None:      # min key length to leave the dense path
        cfg.attrs["block_k_min"] = block_k_min
    if attn_impl is not None:  # dense/flash/blockwise/ring/ulysses
        cfg.attrs["attn_impl"] = attn_impl
    if num_kv_heads is not None:     # grouped-query attention
        cfg.attrs["num_kv_heads"] = num_kv_heads
    if window is not None:           # sliding-window attention
        cfg.attrs["window"] = window
    if use_rope:                     # rotary position embeddings
        cfg.attrs["use_rope"] = True
        cfg.attrs["rope_theta"] = rope_theta
    kv_dim = size if num_kv_heads is None \
        else (size // num_heads) * num_kv_heads
    for i, (inp, dim_in, dim_out) in enumerate(
            [(query, query.size, size), (key, key.size, kv_dim),
             (value, value.size, kv_dim), (query, size, size)]):
        pname = _make_param(name, i, [dim_in, dim_out], attrs[i])
        cfg.inputs.append(LayerInput(input_layer_name=inp.name,
                                     input_parameter_name=pname))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "multi_head_attention", size,
                       parents=[query, key, value],
                       seq_level=query.seq_level)


def layer_norm_layer(
    input: LayerOutput,
    name: Optional[str] = None,
    param_attr: Optional[ParameterAttribute] = None,
    bias_attr=True,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """Last-dim layer normalization with learned scale/bias (beyond the
    reference's zoo — required by the transformer-era blocks; see
    graph/layers_misc.py layer_norm)."""
    name = _name(name, "layer_norm")
    cfg = LayerConfig(name=name, type="layer_norm", size=input.size,
                      active_type="")
    pa = param_attr or ParameterAttribute(initial_mean=1.0, initial_std=0.0)
    pname = _make_param(name, 0, [1, input.size], pa)
    cfg.inputs.append(LayerInput(input_layer_name=input.name,
                                 input_parameter_name=pname))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, input.size])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "layer_norm", input.size, parents=[input],
                       seq_level=input.seq_level)


def moe_layer(
    input: LayerOutput,
    *,
    num_experts: int,
    expert_hidden: int,
    size: Optional[int] = None,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    aux_weight: float = 0.01,
    name: Optional[str] = None,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    """Mixture-of-experts FFN block — NEW capability (parallel/moe.py):
    top-k routed experts with capacity, load-balancing aux loss, expert
    weights sharded over the `model` mesh axis (expert parallelism).
    size defaults to the input width (residual-friendly)."""
    import math as _math
    size = size if size is not None else input.size
    name = _name(name, "moe_layer")
    D, E, H = input.size, num_experts, expert_hidden
    cfg = LayerConfig(name=name, type="moe", size=size, active_type="")
    cfg.attrs["top_k"] = top_k
    cfg.attrs["capacity_factor"] = capacity_factor
    cfg.attrs["aux_weight"] = aux_weight
    espec = ["model", None, None]
    specs = [
        ([D, E], ParameterAttribute(initial_std=1.0 / _math.sqrt(D))),
        ([E, D, H], ParameterAttribute(initial_std=1.0 / _math.sqrt(D),
                                       partition_spec=espec)),
        ([E, H], ParameterAttribute(initial_std=0.0, initial_mean=0.0,
                                    partition_spec=espec[:2])),
        ([E, H, size], ParameterAttribute(initial_std=1.0 / _math.sqrt(H),
                                          partition_spec=espec)),
        ([E, size], ParameterAttribute(initial_std=0.0, initial_mean=0.0,
                                       partition_spec=espec[:2])),
    ]
    for i, (dims, attr) in enumerate(specs):
        pname = _make_param(name, i, dims, attr)
        cfg.inputs.append(LayerInput(input_layer_name=input.name,
                                     input_parameter_name=pname))
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "moe", size, parents=[input],
                       seq_level=input.seq_level)


# ---------------------------------------------------------------------------
# id/decision layers
# ---------------------------------------------------------------------------

def maxid_layer(input: LayerOutput, name=None, beam_size: int = 0,
                layer_attr=None) -> LayerOutput:
    """(ref: MaxIdLayer.cpp)."""
    return _simple_layer("maxid", [input], input.size, name=name,
                         layer_attr=layer_attr, cfg_extra={"beam_size": beam_size},
                         prefix="maxid")


def sampling_id_layer(input: LayerOutput, name=None, layer_attr=None) -> LayerOutput:
    """(ref: SamplingIdLayer.cpp)."""
    return _simple_layer("sampling_id", [input], input.size, name=name,
                         layer_attr=layer_attr, prefix="sampling_id")


def eos_layer(input: LayerOutput, eos_id: int, name=None, layer_attr=None) -> LayerOutput:
    """(ref: EosIdCheckLayer.cpp)."""
    return _simple_layer("eos_id", [input], 1, name=name, layer_attr=layer_attr,
                         cfg_extra={"eos_id": eos_id}, prefix="eos")


# ---------------------------------------------------------------------------
# elementwise / comparison layers
# ---------------------------------------------------------------------------

def cos_sim(a: LayerOutput, b: LayerOutput, scale: float = 1.0, name=None,
            layer_attr=None) -> LayerOutput:
    """(ref: CosSimLayer.cpp)."""
    return _simple_layer("cos", [a, b], 1, name=name, layer_attr=layer_attr,
                         cfg_extra={"cos_scale": scale}, prefix="cos_sim")


def cos_sim_vecmat(v: LayerOutput, m: LayerOutput, size: int, scale: float = 1.0,
                   name=None) -> LayerOutput:
    """(ref: CosSimVecMatLayer.cpp)."""
    return _simple_layer("cos_vm", [v, m], size, name=name,
                         cfg_extra={"cos_scale": scale}, prefix="cos_vm")


def trans_layer(input: LayerOutput, name=None) -> LayerOutput:
    """(ref: TransLayer.cpp)."""
    return _simple_layer("trans", [input], input.size, name=name, prefix="trans")


def resize_layer(input: LayerOutput, size: int, name=None) -> LayerOutput:
    """(ref: ResizeLayer.cpp)."""
    return _simple_layer("resize", [input], size, name=name, prefix="resize")


def slope_intercept_layer(input: LayerOutput, slope: float = 1.0,
                          intercept: float = 0.0, name=None) -> LayerOutput:
    """(ref: SlopeInterceptLayer.cpp)."""
    return _simple_layer("slope_intercept", [input], input.size, name=name,
                         cfg_extra={"slope": slope, "intercept": intercept},
                         prefix="slope_intercept")


def scaling_layer(weight: LayerOutput, input: LayerOutput, name=None) -> LayerOutput:
    """(ref: ScalingLayer.cpp): input0 = [B,1] weights, input1 = values."""
    return _simple_layer("scaling", [weight, input], input.size, name=name,
                         prefix="scaling")


def interpolation_layer(weight: LayerOutput, a: LayerOutput, b: LayerOutput,
                        name=None) -> LayerOutput:
    """(ref: InterpolationLayer.cpp)."""
    return _simple_layer("interpolation", [weight, a, b], a.size, name=name,
                         prefix="interpolation")


def power_layer(weight: LayerOutput, input: LayerOutput, name=None) -> LayerOutput:
    """(ref: PowerLayer.cpp)."""
    return _simple_layer("power", [weight, input], input.size, name=name,
                         prefix="power")


def linear_comb_layer(weights: LayerOutput, vectors: LayerOutput, size: int,
                      name=None) -> LayerOutput:
    """(ref: ConvexCombinationLayer.cpp)."""
    return _simple_layer("convex_comb", [weights, vectors], size, name=name,
                         prefix="linear_comb")


convex_comb_layer = linear_comb_layer


def outer_prod_layer(a: LayerOutput, b: LayerOutput, name=None) -> LayerOutput:
    """(ref: OuterProdLayer.cpp)."""
    return _simple_layer("out_prod", [a, b], a.size * b.size, name=name,
                         prefix="out_prod")


def tensor_layer(a: LayerOutput, b: LayerOutput, size: int, act=None, name=None,
                 param_attr=None, bias_attr=None, layer_attr=None) -> LayerOutput:
    """(ref: TensorLayer.cpp)."""
    name = _name(name, "tensor")
    cfg = LayerConfig(name=name, type="tensor", size=size,
                      active_type=act_name(act or LinearActivation()))
    pname = _make_param(name, 0, [a.size, size * b.size], param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=a.name, input_parameter_name=pname))
    cfg.inputs.append(LayerInput(input_layer_name=b.name))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "tensor", size, parents=[a, b])


def multiplex_layer(index: LayerOutput, inputs: Sequence[LayerOutput],
                    name=None) -> LayerOutput:
    """(ref: MultiplexLayer.cpp)."""
    ins = [index] + list(inputs)
    return _simple_layer("multiplex", ins, inputs[0].size, name=name,
                         prefix="multiplex")


def selective_fc_layer(input, select: Optional[LayerOutput], size: int, act=None,
                       name=None, param_attr=None, bias_attr=None,
                       layer_attr=None) -> LayerOutput:
    """(ref: SelectiveFullyConnectedLayer.cpp)."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    name = _name(name, "selective_fc")
    cfg = LayerConfig(name=name, type="selective_fc", size=size,
                      active_type=act_name(act or TanhActivation()))
    attrs = param_attr if isinstance(param_attr, list) else [param_attr] * len(inputs)
    for i, (inp, pa) in enumerate(zip(inputs, attrs)):
        pname = _make_param(name, i, [inp.size, size], pa)
        cfg.inputs.append(LayerInput(input_layer_name=inp.name, input_parameter_name=pname))
    if select is not None:
        cfg.inputs.append(LayerInput(input_layer_name=select.name))
        cfg.attrs["has_selected_colums"] = True
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, size])
    _layer_attr_fields(cfg, layer_attr)
    current_context().add_layer(cfg)
    return LayerOutput(name, "selective_fc", size, parents=inputs)


def print_layer(input: LayerOutput, name=None) -> LayerOutput:
    """(ref: PrintLayer.cpp)."""
    return _simple_layer("print", [input], input.size, name=name, prefix="print")


# ---------------------------------------------------------------------------
# cost layers
# ---------------------------------------------------------------------------

def _cost_layer(type_: str, inputs: list[LayerOutput], name, coeff: float = 1.0,
                cfg_extra: Optional[dict] = None, prefix: str = "cost",
                params: Optional[list] = None, size: int = 1) -> LayerOutput:
    name = _name(name, prefix)
    cfg = LayerConfig(name=name, type=type_, size=size, coeff=coeff)
    for i, inp in enumerate(inputs):
        li = LayerInput(input_layer_name=inp.name)
        if params and params[i] is not None:
            li.input_parameter_name = _make_param(name, i, params[i][0], params[i][1])
        cfg.inputs.append(li)
    if cfg_extra:
        for k, v in cfg_extra.items():
            if hasattr(cfg, k) and k != "attrs":
                setattr(cfg, k, v)
            else:
                cfg.attrs[k] = v
    current_context().add_layer(cfg)
    current_context().model.output_layer_names.append(name)
    return LayerOutput(name, type_, size, parents=inputs)


def classification_cost(input: LayerOutput, label: LayerOutput, weight=None,
                        name=None, evaluator=None, coeff: float = 1.0) -> LayerOutput:
    """Softmax classification cost + classification_error evaluator
    (ref: layers.py classification_cost — attaches default evaluators)."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    out = _cost_layer("multi-class-cross-entropy", inputs, name, coeff,
                      prefix="classification_cost")
    current_context().add_evaluator(EvaluatorConfig(
        name=f"{out.name}.classification_error", type="classification_error",
        input_layer_names=[input.name, label.name]))
    return out


def regression_cost(input: LayerOutput, label: LayerOutput, weight=None,
                    name=None, coeff: float = 1.0) -> LayerOutput:
    """(ref: layers.py regression_cost — sum of squares)."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    return _cost_layer("square_error", inputs, name, coeff, prefix="regression_cost")


def cross_entropy(input: LayerOutput, label: LayerOutput, name=None,
                  coeff: float = 1.0) -> LayerOutput:
    """(ref: layers.py cross_entropy)."""
    return _cost_layer("multi-class-cross-entropy", [input, label], name, coeff)


def cross_entropy_with_selfnorm(input: LayerOutput, label: LayerOutput, name=None,
                                coeff: float = 1.0,
                                softmax_selfnorm_alpha: float = 0.1) -> LayerOutput:
    """(ref: layers.py cross_entropy_with_selfnorm)."""
    return _cost_layer("multi_class_cross_entropy_with_selfnorm", [input, label],
                       name, coeff,
                       cfg_extra={"softmax_selfnorm_alpha": softmax_selfnorm_alpha})


def soft_binary_class_cross_entropy(input: LayerOutput, label: LayerOutput,
                                    name=None, coeff: float = 1.0) -> LayerOutput:
    return _cost_layer("soft_binary_class_cross_entropy", [input, label], name, coeff)


def multi_binary_label_cross_entropy(input: LayerOutput, label: LayerOutput,
                                     name=None, coeff: float = 1.0) -> LayerOutput:
    return _cost_layer("multi_binary_label_cross_entropy", [input, label], name, coeff)


def rank_cost(left: LayerOutput, right: LayerOutput, label: LayerOutput,
              weight=None, name=None, coeff: float = 1.0) -> LayerOutput:
    """(ref: RankingCost)."""
    inputs = [left, right, label] + ([weight] if weight is not None else [])
    return _cost_layer("rank-cost", inputs, name, coeff)


def lambda_cost(input: LayerOutput, score: LayerOutput, name=None,
                NDCG_num: int = 5, max_sort_size: int = -1,
                coeff: float = 1.0) -> LayerOutput:
    """(ref: LambdaCost)."""
    return _cost_layer("lambda_cost", [input, score], name, coeff,
                       cfg_extra={"NDCG_num": NDCG_num, "max_sort_size": max_sort_size})


def huber_cost(input: LayerOutput, label: LayerOutput, name=None,
               coeff: float = 1.0) -> LayerOutput:
    """(ref: HuberTwoClass)."""
    return _cost_layer("huber_classification", [input, label], name, coeff)


def sum_cost(input: LayerOutput, name=None, coeff: float = 1.0) -> LayerOutput:
    """Sum the input as a cost (ref: SumCostLayer)."""
    return _cost_layer("sum_cost", [input], name, coeff)


def auc_validation(input: LayerOutput, label: LayerOutput, weight=None,
                   name=None) -> LayerOutput:
    """In-graph AUC during training (ref: AucValidation —
    config_parser.py:1961, ValidationLayer.cpp): pass-through layer whose
    (score, label[, weight]) inputs feed a last-column-auc evaluator."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    return _cost_layer("auc-validation", inputs, name, prefix="auc_validation",
                       size=input.size)


def pnpair_validation(input: LayerOutput, label: LayerOutput,
                      info: LayerOutput, weight=None, name=None) -> LayerOutput:
    """In-graph positive-negative pair rate (ref: PnpairValidation —
    config_parser.py:1962, ValidationLayer.cpp): (score, label, query-info
    [, weight]) feed a pnpair evaluator grouping by info id."""
    inputs = [input, label, info] + ([weight] if weight is not None else [])
    return _cost_layer("pnpair-validation", inputs, name,
                       prefix="pnpair_validation", size=input.size)


def crf_layer(input: LayerOutput, label: LayerOutput, size: Optional[int] = None,
              weight=None, param_attr=None, name=None,
              coeff: float = 1.0) -> LayerOutput:
    """(ref: layers.py crf_layer; CRFLayer.cpp; parameter [(C+2), C])."""
    size = size or input.size
    inputs = [input, label] + ([weight] if weight is not None else [])
    params = [([size + 2, size], param_attr)] + [None] * (len(inputs) - 1)
    out = _cost_layer("crf", inputs, name, coeff, prefix="crf",
                      cfg_extra={"num_classes": size}, params=params)
    out.size = size
    return out


def crf_decoding_layer(input: LayerOutput, size: Optional[int] = None,
                       label: Optional[LayerOutput] = None, param_attr=None,
                       name=None) -> LayerOutput:
    """(ref: CRFDecodingLayer.cpp)."""
    size = size or input.size
    inputs = [input] + ([label] if label is not None else [])
    name = _name(name, "crf_decoding")
    cfg = LayerConfig(name=name, type="crf_decoding", size=size, num_classes=size)
    pname = _make_param(name, 0, [size + 2, size], param_attr)
    cfg.inputs.append(LayerInput(input_layer_name=input.name, input_parameter_name=pname))
    if label is not None:
        cfg.inputs.append(LayerInput(input_layer_name=label.name))
    current_context().add_layer(cfg)
    return LayerOutput(name, "crf_decoding", size, parents=inputs, seq_level=input.seq_level)


def ctc_layer(input: LayerOutput, label: LayerOutput, size: Optional[int] = None,
              name=None, norm_by_times: bool = False, blank: Optional[int] = None,
              coeff: float = 1.0) -> LayerOutput:
    """(ref: layers.py ctc_layer; CTCLayer.cpp — blank defaults to size-1)."""
    size = size or input.size
    return _cost_layer("ctc", [input, label], name, coeff, prefix="ctc",
                       cfg_extra={"blank": blank if blank is not None else size - 1,
                                  "norm_by_times": norm_by_times})


def nce_layer(input, label: LayerOutput, num_classes: int,
              num_neg_samples: int = 10, neg_distribution: Optional[list] = None,
              weight=None, name=None, param_attr=None, bias_attr=None,
              coeff: float = 1.0) -> LayerOutput:
    """(ref: layers.py nce_layer; NCELayer.cpp)."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    name = _name(name, "nce")
    cfg = LayerConfig(name=name, type="nce", size=1, coeff=coeff,
                      num_classes=num_classes, num_neg_samples=num_neg_samples)
    if neg_distribution is not None:
        cfg.neg_sampling_dist = list(neg_distribution)
    attrs = param_attr if isinstance(param_attr, list) else [param_attr] * len(inputs)
    for i, (inp, pa) in enumerate(zip(inputs, attrs)):
        pname = _make_param(name, i, [num_classes, inp.size], pa)
        cfg.inputs.append(LayerInput(input_layer_name=inp.name, input_parameter_name=pname))
    cfg.inputs.append(LayerInput(input_layer_name=label.name))
    if weight is not None:
        cfg.inputs.append(LayerInput(input_layer_name=weight.name))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, num_classes])
    current_context().add_layer(cfg)
    current_context().model.output_layer_names.append(name)
    return LayerOutput(name, "nce", 1, parents=inputs)


def hsigmoid(input, label: LayerOutput, num_classes: int, name=None,
             param_attr=None, bias_attr=None, coeff: float = 1.0) -> LayerOutput:
    """(ref: layers.py hsigmoid; HierarchicalSigmoidLayer.cpp)."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    name = _name(name, "hsigmoid")
    cfg = LayerConfig(name=name, type="hsigmoid", size=1, coeff=coeff,
                      num_classes=num_classes)
    attrs = param_attr if isinstance(param_attr, list) else [param_attr] * len(inputs)
    for i, (inp, pa) in enumerate(zip(inputs, attrs)):
        pname = _make_param(name, i, [num_classes - 1, inp.size], pa)
        cfg.inputs.append(LayerInput(input_layer_name=inp.name, input_parameter_name=pname))
    cfg.inputs.append(LayerInput(input_layer_name=label.name))
    cfg.bias_parameter_name = _bias_name(name, bias_attr, [1, num_classes - 1])
    current_context().add_layer(cfg)
    current_context().model.output_layer_names.append(name)
    return LayerOutput(name, "hsigmoid", 1, parents=inputs)


# ---------------------------------------------------------------------------
# recurrent groups & generation
# ---------------------------------------------------------------------------

class StaticInput:
    """Non-sequence input broadcast to every step of a recurrent group
    (ref: layers.py StaticInput)."""

    def __init__(self, input: LayerOutput, is_seq: bool = False, size: Optional[int] = None):
        self.input = input
        self.is_seq = is_seq
        self.size = size or input.size


class SubsequenceInput:
    """Marks a recurrent_group in-link as a nested (level-2) sequence: the
    group steps over SUB-SEQUENCES, feeding each step a full [B, T, ...]
    sequence — the hierarchical-RNN form (ref: layers.py SubsequenceInput;
    RecurrentGradientMachine.cpp:626-699)."""

    def __init__(self, input: LayerOutput):
        self.input = input


class BaseGeneratedInput:
    """Base of generation feedback inputs (ref: layers.py
    BaseGeneratedInput:2939) — user code subclasses it to customize the
    feedback path of beam search."""


class GeneratedInput(BaseGeneratedInput):
    """Feedback input for generation: embedding of the previously generated
    token (ref: layers.py GeneratedInput)."""

    def __init__(self, size: int, embedding_name: str, embedding_size: int):
        self.size = size                  # vocabulary size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


def memory(name: Optional[str], size: int, is_seq: bool = False,
           boot_layer: Optional[LayerOutput] = None, boot_bias=None,
           boot_bias_active_type=None,
           boot_with_const_id: Optional[int] = None) -> LayerOutput:
    """Read `name`'s output from the previous timestep
    (ref: layers.py memory:2444; config_parser.py Memory).

    Must be called inside a recurrent_group step function.  Creates an agent
    layer fed by the scan carry; registers a MemoryConfig on the group.
    """
    ctx = current_context()
    recurrent = [g for g in ctx.group_stack if g.is_recurrent_layer_group]
    assert recurrent, ("memory() must be used inside recurrent_group "
                       "(a sub_network scope is not a recurrent group)")
    sm = recurrent[-1]
    agent_name = ctx.unique_name(f"memory_{name or 'anon'}")
    cfg = LayerConfig(name=agent_name, type="agent", size=size)
    ctx.add_layer(cfg)
    mem = MemoryConfig(
        link_name=name or "", layer_name=agent_name, size=size,
        boot_layer_name=boot_layer.name if boot_layer is not None else "",
        boot_with_const_id=boot_with_const_id, is_sequence=is_seq)
    sm.memories.append(mem)
    return LayerOutput(agent_name, "agent", size)


def recurrent_group(step, input, reverse: bool = False,
                    name: Optional[str] = None):
    """Run `step` over every timestep of the input sequence(s)
    (ref: layers.py recurrent_group:2786; RecurrentGradientMachine).

    `input`: LayerOutput (sequence in-link), StaticInput, or a list of them.
    Returns the step function's output as a sequence LayerOutput (or a list).
    """
    ctx = current_context()
    name = _name(name, "recurrent_group")
    inputs = input if isinstance(input, (list, tuple)) else [input]

    sm = SubModelConfig(name=name, is_recurrent_layer_group=True, reversed=reverse)
    recurrent_ancestors = [g for g in ctx.group_stack
                           if g.is_recurrent_layer_group]
    if recurrent_ancestors:
        # nested group: executed inside the enclosing group's scan step
        # (a non-recurrent sub_network scope is bookkeeping, not execution)
        sm.parent = recurrent_ancestors[-1].name
    ctx.model.sub_models.append(sm)
    ctx.group_stack.append(sm)
    try:
        step_args = []
        gen_inputs = []
        for inp in inputs:
            if isinstance(inp, SubsequenceInput):
                # nested in-link: each step receives one whole subsequence
                src = inp.input
                alias = ctx.unique_name(f"inlink_{src.name}")
                ctx.add_layer(LayerConfig(name=alias, type="scatter_agent",
                                          size=src.size))
                sm.in_links.append(src.name)
                sm.in_link_layers.append(alias)
                step_args.append(LayerOutput(alias, "scatter_agent", src.size,
                                             seq_level=1))
            elif isinstance(inp, LayerOutput):
                # sequence in-link -> in-group alias (per-step slice)
                alias = ctx.unique_name(f"inlink_{inp.name}")
                ctx.add_layer(LayerConfig(name=alias, type="scatter_agent", size=inp.size))
                sm.in_links.append(inp.name)
                sm.in_link_layers.append(alias)
                step_args.append(LayerOutput(alias, "scatter_agent", inp.size,
                                             seq_level=max(inp.seq_level - 1, 0)))
            elif isinstance(inp, StaticInput):
                alias = ctx.unique_name(f"static_{inp.input.name}")
                ctx.add_layer(LayerConfig(name=alias, type="agent", size=inp.size))
                sm.static_links.append(inp.input.name)
                sm.static_link_layers.append(alias)
                step_args.append(LayerOutput(alias, "agent", inp.size,
                                             seq_level=1 if inp.is_seq else 0))
            elif isinstance(inp, GeneratedInput):
                gen_inputs.append(inp)
                # previous-token id memory + embedding lookup
                id_mem = memory(name=None, size=inp.size, boot_with_const_id=0)
                sm.memories[-1].link_name = "__generated_id__"  # patched by beam_search
                emb = embedding_layer(
                    input=LayerOutput(id_mem.name, "agent", inp.size),
                    size=inp.embedding_size,
                    param_attr=ParameterAttribute(name=inp.embedding_name),
                    name=ctx.unique_name("gen_emb"))
                sm.generator = GeneratorConfig(id_memory_layer_name=id_mem.name)
                step_args.append(emb)
            else:
                raise TypeError(f"bad recurrent_group input: {type(inp)}")

        outs = step(*step_args)
        out_list = outs if isinstance(outs, (list, tuple)) else [outs]
        for o in out_list:
            sm.output_layer_names.append(o.name)
    finally:
        ctx.group_stack.pop()

    results = [LayerOutput(o.name, o.layer_type, o.size, seq_level=1)
               for o in out_list]
    return results if isinstance(outs, (list, tuple)) else results[0]


class sub_network:
    """Scope layers into a named sub-network — the MultiNetwork / multi_nn
    analog (ref: gserver/gradientmachines/MultiNetwork.h:25-62).

    The reference runs each sub-network's forward/backward separately and
    sums the costs; here all sub-networks are one graph that one executor
    runs, so this scope is structural
    metadata: it groups layers in the config for tooling
    (dump_config/show_model) and marks the model type multi_nn.  Use one
    `with sub_network("task_a"): ...` block per task; costs from every
    block train jointly.
    """

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        ctx = current_context()
        sm = SubModelConfig(name=self.name, is_recurrent_layer_group=False)
        ctx.model.sub_models.append(sm)
        ctx.group_stack.append(sm)
        ctx.model.type = "multi_nn"
        self.sm = sm
        return self

    def __exit__(self, *exc):
        current_context().group_stack.pop()
        return False


def beam_search(step, input, bos_id: int, eos_id: int, beam_size: int,
                max_length: int = 100, name: Optional[str] = None,
                num_results_per_sample: Optional[int] = None) -> LayerOutput:
    """Sequence generation by beam search over a recurrent group
    (ref: layers.py beam_search:3087; RecurrentGradientMachine::beamSearch).

    `step` receives the group's per-step inputs (including the GeneratedInput
    embedding) and must return the next-token probability layer.
    """
    ctx = current_context()
    name = _name(name, "beam_search")

    prob_holder: list[LayerOutput] = []

    def wrapped_step(*args):
        out = step(*args)
        prob_holder.append(out)
        return out

    out = recurrent_group(step=wrapped_step, input=input, name=name)
    sm = ctx.model.sub_models[-1]
    assert sm.name == name
    gen = sm.generator or GeneratorConfig()
    gen.beam_size = beam_size
    gen.eos_id = eos_id
    gen.bos_id = bos_id
    gen.max_num_frames = max_length
    gen.num_results_per_sample = num_results_per_sample or beam_size
    gen.prob_layer_name = prob_holder[0].name
    # the generated-id memory feeds back the chosen token
    for mem in sm.memories:
        if mem.link_name == "__generated_id__":
            mem.link_name = gen.prob_layer_name   # executor reads argmax of probs
            mem.boot_with_const_id = bos_id
    sm.generator = gen
    ctx.model.type = "recurrent_nn"
    return out


def get_output_layer(input: LayerOutput, arg_name: str = "", name=None) -> LayerOutput:
    """(ref: GetOutputLayer.cpp)."""
    return _simple_layer("get_output", [input], input.size, name=name,
                         prefix="get_output")


# ---------------------------------------------------------------------------
# reference compat surface: level constants, type-name registry, bases
# ---------------------------------------------------------------------------

class AggregateLevel:
    """Pooling aggregation level constants (ref: layers.py
    AggregateLevel:204) — EACH_TIMESTEP pools a sequence to one vector,
    EACH_SEQUENCE pools a nested sequence to one vector per sub-sequence."""
    EACH_TIMESTEP = "non-seq"
    EACH_SEQUENCE = "seq"


class ExpandLevel:
    """Expansion level constants (ref: layers.py ExpandLevel:1292)."""
    FROM_TIMESTEP = AggregateLevel.EACH_TIMESTEP
    FROM_SEQUENCE = AggregateLevel.EACH_SEQUENCE


# every layer type the JAX package's graph registry implements
# (paddle_tpu/graph/registry.py layer_registry), frozen: a config parses
# here whatever the port's executor has ported so far, and a type the
# executor lacks raises when GraphExecutor builds the graph
LAYER_TYPES = (
    "additive_attention_step", "addto", "agent", "auc-validation", "average",
    "batch_norm", "bilinear_interp", "blockexpand", "concat", "concat2",
    "conv_shift", "convex_comb", "cos", "cos_vm", "crf", "crf_decoding",
    "ctc", "cudnn_batch_norm", "cudnn_conv", "cudnn_pool", "data",
    "data_norm", "eos_id", "exconv", "exconvt", "expand", "fc",
    "featmap_expand", "gated_recurrent", "gather_agent", "get_output",
    "gru_step", "hsigmoid", "huber", "huber_classification", "interpolation",
    "lambda_cost", "layer_norm", "linear_comb", "lstm_step", "lstmemory",
    "max", "maxid", "maxout", "mdlstmemory", "mixed", "moe",
    "multi-class-cross-entropy", "multi_binary_label_cross_entropy",
    "multi_class_cross_entropy_with_selfnorm", "multi_head_attention",
    "multiplex", "nce", "norm", "out_prod", "pnpair-validation", "pool",
    "power", "prelu", "print", "rank-cost", "recurrent", "resize",
    "sampling_id", "scaling", "scatter_agent", "selective_fc", "seqconcat",
    "seqlastins", "seqreshape", "sequence_agent", "sequence_gather_agent",
    "sequence_scatter_agent", "slope_intercept",
    "soft_binary_class_cross_entropy", "spp", "square_error", "subseq",
    "sum_cost", "sum_to_one_norm", "tensor", "trans",
)


class LayerType:
    """Registered layer type-name constants (ref: layers.py LayerType:112).
    The layer types a config may name are LAYER_TYPES; this mirror exists
    for configs that reference LayerType.X symbolically."""
    DATA = "data"
    FC_LAYER = "fc"
    MIXED_LAYER = "mixed"
    LSTMEMORY = "lstmemory"
    GRUMEMORY = "gated_recurrent"
    POOL_LAYER = "pool"
    BATCH_NORM_LAYER = "batch_norm"
    CONV_LAYER = "exconv"
    CONCAT_LAYER = "concat"
    ADDTO_LAYER = "addto"
    EMBEDDING_LAYER = "embedding"
    COST = "multi-class-cross-entropy"

    @classmethod
    def is_layer_type(cls, type_name: str) -> bool:
        """True for any of this class's constants (the reference's
        semantics) or any registered graph layer type."""
        consts = {v for k, v in vars(cls).items()
                  if k.isupper() and isinstance(v, str)}
        return type_name in consts or type_name in LAYER_TYPES


def out_prod_layer(input1: LayerOutput, input2: LayerOutput, name=None,
                   layer_attr=None) -> LayerOutput:
    """Flattened outer product of two vectors (ref: layers.py
    out_prod_layer; OuterProdLayer.cpp)."""
    return _simple_layer("out_prod", [input1, input2],
                         input1.size * input2.size, name=name,
                         layer_attr=layer_attr, prefix="out_prod")


def sum_to_one_norm_layer(input: LayerOutput, name=None,
                          layer_attr=None) -> LayerOutput:
    """Row-normalize to sum 1 (ref: layers.py sum_to_one_norm_layer;
    SumToOneNormLayer.cpp)."""
    return _simple_layer("sum_to_one_norm", [input], input.size, name=name,
                         layer_attr=layer_attr, prefix="sum_to_one_norm")
