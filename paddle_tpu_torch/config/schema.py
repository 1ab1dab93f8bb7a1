"""Model / trainer configuration schema — the port's own copy.

The same typed dataclasses, field names, defaults and JSON form as the
JAX package's schema (paddle_tpu/config/schema.py), so a config dumped
there with `to_json()` loads here with `from_json()` unchanged and the two
`to_dict()` forms compare equal.  The port keeps a copy instead of
importing it: the machine that runs the port has no JAX, and the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        out = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None or v == f.default:
                continue
            out[f.name] = _to_dict(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_dict(v) for k, v in obj.items()}
    return obj


_SCHEMA_TYPES: dict[str, type] = {}


def _schema(cls):
    _SCHEMA_TYPES[cls.__name__] = cls
    return cls


def _from_dict(data: Any) -> Any:
    if isinstance(data, dict) and "__type__" in data:
        cls = _SCHEMA_TYPES[data["__type__"]]
        kwargs = {k: _from_dict(v) for k, v in data.items() if k != "__type__"}
        return cls(**kwargs)
    if isinstance(data, list):
        return [_from_dict(v) for v in data]
    if isinstance(data, dict):
        return {k: _from_dict(v) for k, v in data.items()}
    return data


class _Serializable:
    def to_dict(self) -> dict:
        return _to_dict(self)

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, data: dict) -> "Any":
        obj = _from_dict(data)
        if not isinstance(obj, cls):
            raise TypeError(f"expected {cls.__name__}, got {type(obj).__name__}")
        return obj

    @classmethod
    def from_json(cls, text: str) -> "Any":
        return cls.from_dict(json.loads(text))


# -- parameters --------------------------------------------------------------

@_schema
@dataclass
class ParameterConfig(_Serializable):
    """Trainable parameter description."""

    name: str = ""
    size: int = 0
    dims: list[int] = field(default_factory=list)
    learning_rate: float = 1.0
    momentum: Optional[float] = None
    initial_mean: float = 0.0
    initial_std: float = 0.01
    # 'normal' | 'uniform' | 'zero'; initial_smart scales std by 1/sqrt(fan_in)
    initial_strategy: str = "normal"
    initial_smart: bool = False
    decay_rate: Optional[float] = None
    decay_rate_l1: Optional[float] = None
    is_static: bool = False
    is_shared: bool = False
    sparse_update: bool = False
    gradient_clipping_threshold: Optional[float] = None
    partition_spec: Optional[list] = None
    dtype: str = "float32"
    update_hooks: list = field(default_factory=list)


# -- projections & operators inside mixed layers -----------------------------

@_schema
@dataclass
class ConvConfig(_Serializable):
    filter_size: int = 3
    filter_size_y: int = 0
    channels: int = 1
    stride: int = 1
    stride_y: int = 0
    padding: int = 0
    padding_y: int = 0
    groups: int = 1
    img_size: int = 0
    img_size_y: int = 0
    output_x: int = 0
    output_y: int = 0
    caffe_mode: bool = True


@_schema
@dataclass
class PoolConfig(_Serializable):
    pool_type: str = "max-projection"
    channels: int = 1
    size_x: int = 2
    size_y: int = 0
    stride: int = 2
    stride_y: int = 0
    padding: int = 0
    padding_y: int = 0
    img_size: int = 0
    img_size_y: int = 0
    output_x: int = 0
    output_y: int = 0


@_schema
@dataclass
class NormConfig(_Serializable):
    norm_type: str = "cmrnorm-projection"
    channels: int = 1
    size: int = 5
    scale: float = 0.0019531
    pow: float = 0.75
    img_size: int = 0
    img_size_y: int = 0
    output_x: int = 0
    output_y: int = 0


@_schema
@dataclass
class ProjectionConfig(_Serializable):
    """A parameterized map inside a mixed layer (identity, dot_mul,
    full_matrix, table, context, trans_full_matrix, conv)."""

    type: str = "fc"
    name: str = ""
    input_size: int = 0
    output_size: int = 0
    context_start: int = 0
    context_length: int = 0
    trainable_padding: bool = False
    conv: Optional[ConvConfig] = None
    num_filters: int = 0


@_schema
@dataclass
class OperatorConfig(_Serializable):
    """A parameter-free multi-input op inside a mixed layer."""

    type: str = "dot_mul"
    input_indices: list[int] = field(default_factory=list)
    input_sizes: list[int] = field(default_factory=list)
    output_size: int = 0
    dotmul_scale: float = 1.0
    conv: Optional[ConvConfig] = None
    num_filters: int = 0


# -- layers ------------------------------------------------------------------

@_schema
@dataclass
class LayerInput(_Serializable):
    """One input edge of a layer."""

    input_layer_name: str = ""
    input_parameter_name: str = ""
    proj: Optional[ProjectionConfig] = None


@_schema
@dataclass
class LayerConfig(_Serializable):
    """One node of the model graph; type-specific settings live in the
    typed sub-configs or the open `attrs` dict."""

    name: str = ""
    type: str = ""
    size: int = 0
    active_type: str = ""               # activation name ('' = identity)
    inputs: list[LayerInput] = field(default_factory=list)
    bias_parameter_name: str = ""       # '' = no bias
    operators: list[OperatorConfig] = field(default_factory=list)
    drop_rate: float = 0.0
    conv: Optional[ConvConfig] = None
    pool: Optional[PoolConfig] = None
    norm: Optional[NormConfig] = None
    num_filters: int = 0
    shared_biases: bool = False
    use_global_stats: Optional[bool] = None
    moving_average_fraction: float = 0.9
    coeff: float = 1.0
    num_classes: int = 0
    softmax_selfnorm_alpha: float = 0.1
    neg_sampling_dist: Optional[list] = None
    num_neg_samples: int = 10
    trans_type: str = "non-seq"
    seq_pool_type: str = ""
    average_strategy: str = "average"
    select_first: bool = False
    stride: int = -1
    reversed: bool = False
    beam_size: int = 0
    blank: int = 0
    norm_by_times: bool = False
    add_size: int = 0
    delimited: bool = True
    device: int = -1
    attrs: dict = field(default_factory=dict)


# -- recurrent groups / generation -------------------------------------------

@_schema
@dataclass
class MemoryConfig(_Serializable):
    link_name: str = ""
    layer_name: str = ""
    boot_layer_name: str = ""
    boot_bias: bool = False
    boot_bias_active_type: str = ""
    boot_with_const_id: Optional[int] = None
    size: int = 0
    is_sequence: bool = False


@_schema
@dataclass
class GeneratorConfig(_Serializable):
    max_num_frames: int = 100
    beam_size: int = 1
    eos_layer_name: str = ""
    eos_id: int = 0
    bos_id: int = 0
    num_results_per_sample: int = 1
    log_prob: bool = True
    prob_layer_name: str = ""
    id_memory_layer_name: str = ""


@_schema
@dataclass
class SubModelConfig(_Serializable):
    """A recurrent layer group (graph/builder.py runs the flat ones;
    groups nested in a group are not ported)."""

    name: str = ""
    layer_names: list[str] = field(default_factory=list)
    input_layer_names: list[str] = field(default_factory=list)
    output_layer_names: list[str] = field(default_factory=list)
    memories: list[MemoryConfig] = field(default_factory=list)
    in_links: list[str] = field(default_factory=list)
    in_link_layers: list[str] = field(default_factory=list)
    static_links: list[str] = field(default_factory=list)
    static_link_layers: list[str] = field(default_factory=list)
    out_links: list[str] = field(default_factory=list)
    is_recurrent_layer_group: bool = False
    reversed: bool = False
    generator: Optional[GeneratorConfig] = None
    parent: str = ""


@_schema
@dataclass
class EvaluatorConfig(_Serializable):
    name: str = ""
    type: str = "classification_error"
    input_layer_names: list[str] = field(default_factory=list)
    num_chunk_types: int = 0
    chunk_scheme: str = ""
    classification_threshold: float = 0.5
    positive_label: int = -1
    excluded_chunk_types: list[int] = field(default_factory=list)
    result_file: str = ""
    dict_file: str = ""
    delimited: bool = True


# -- the model ---------------------------------------------------------------

@_schema
@dataclass
class ModelConfig(_Serializable):
    """The whole graph."""

    type: str = "nn"
    layers: list[LayerConfig] = field(default_factory=list)
    parameters: list[ParameterConfig] = field(default_factory=list)
    input_layer_names: list[str] = field(default_factory=list)
    output_layer_names: list[str] = field(default_factory=list)
    evaluators: list[EvaluatorConfig] = field(default_factory=list)
    sub_models: list[SubModelConfig] = field(default_factory=list)

    def layer(self, name: str) -> LayerConfig:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(f"no layer named {name!r}")

    def parameter(self, name: str) -> ParameterConfig:
        for p in self.parameters:
            if p.name == name:
                return p
        raise KeyError(f"no parameter named {name!r}")


# -- optimization / trainer / data configs -----------------------------------

@_schema
@dataclass
class OptimizationConfig(_Serializable):
    """Optimizer settings (optim/updater.py reads them; serving reads only
    `compute_dtype`)."""

    batch_size: int = 1
    algorithm: str = "sgd"
    learning_method: str = "momentum"
    learning_rate: float = 1.0
    learning_rate_decay_a: float = 0.0
    learning_rate_decay_b: float = 0.0
    learning_rate_schedule: str = "constant"
    learning_rate_args: str = ""
    momentum: float = 0.0
    ada_epsilon: float = 1e-6
    ada_rho: float = 0.95
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    l1_weight: float = 0.0
    l2_weight: float = 0.0
    gradient_clipping_threshold: float = 0.0
    average_window: float = 0.0
    max_average_window: int = 0
    do_average_in_cpu: bool = False
    delta_add_rate: float = 1.0
    num_batches_per_send_parameter: int = 1
    num_batches_per_get_parameter: int = 1
    shrink_parameter_value: float = 0.0
    dtype: str = "float32"
    compute_dtype: str = ""             # '' = param dtype; 'bfloat16'
    pipeline_micro_batches: int = 0
    pipeline_schedule: str = "gpipe"
    pipeline_virtual_stages: int = 1
    shard_optimizer_state: bool = False
    zero_stage: int = 0


@_schema
@dataclass
class DataConfig(_Serializable):
    type: str = "py2"
    files: str = ""
    load_data_module: str = ""
    load_data_object: str = ""
    load_data_args: str = ""
    async_load_data: bool = True
    constant_slots: list[float] = field(default_factory=list)
    sub_configs: list["DataConfig"] = field(default_factory=list)
    data_ratios: list[int] = field(default_factory=list)


@_schema
@dataclass
class TrainerConfig(_Serializable):
    """Top-level config."""

    model_config: Optional[ModelConfig] = None
    opt_config: Optional[OptimizationConfig] = None
    data_config: Optional[DataConfig] = None
    test_data_config: Optional[DataConfig] = None
    save_dir: str = "./output"
