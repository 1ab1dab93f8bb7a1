"""DSL assembly context and LayerOutput value objects.

Plays the role of the reference's config_parser global state
(ref: python/paddle/trainer/config_parser.py: g_config / g_layer_map /
g_parameter_map and the @config_layer classes' size inference) — but as an
explicit context object, no exec-global mutation required.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Optional

from paddle_tpu_torch.config.schema import (
    DataConfig,
    EvaluatorConfig,
    LayerConfig,
    ModelConfig,
    OptimizationConfig,
    ParameterConfig,
    SubModelConfig,
    TrainerConfig,
)


class ConfigContext:
    """Collects layers/parameters/evaluators while a config runs."""

    def __init__(self) -> None:
        self.model = ModelConfig()
        self.opt = OptimizationConfig()
        self.data: Optional[DataConfig] = None
        self.test_data: Optional[DataConfig] = None
        self._names: set[str] = set()
        self._param_names: set[str] = set()
        self._counters: dict[str, int] = {}
        # recurrent-group nesting state
        self.group_stack: list[SubModelConfig] = []
        self.input_types: dict[str, Any] = {}

    # -- naming -----------------------------------------------------------
    def unique_name(self, prefix: str) -> str:
        n = self._counters.get(prefix, 0)
        self._counters[prefix] = n + 1
        name = f"__{prefix}_{n}__"
        while name in self._names:
            n += 1
            self._counters[prefix] = n + 1
            name = f"__{prefix}_{n}__"
        return name

    # -- registration -----------------------------------------------------
    def add_layer(self, cfg: LayerConfig) -> LayerConfig:
        if cfg.name in self._names:
            raise ValueError(f"duplicate layer name {cfg.name!r}")
        self._names.add(cfg.name)
        self.model.layers.append(cfg)
        if self.group_stack:
            self.group_stack[-1].layer_names.append(cfg.name)
        return cfg

    def add_parameter(self, cfg: ParameterConfig) -> ParameterConfig:
        if cfg.name in self._param_names:
            raise ValueError(f"duplicate parameter name {cfg.name!r}")
        self._param_names.add(cfg.name)
        self.model.parameters.append(cfg)
        return cfg

    def has_parameter(self, name: str) -> bool:
        return name in self._param_names

    def add_evaluator(self, cfg: EvaluatorConfig) -> EvaluatorConfig:
        self.model.evaluators.append(cfg)
        return cfg

    def to_trainer_config(self) -> TrainerConfig:
        return TrainerConfig(
            model_config=self.model, opt_config=self.opt,
            data_config=self.data, test_data_config=self.test_data)


_current: list[ConfigContext] = []


def current_context() -> ConfigContext:
    if not _current:
        _current.append(ConfigContext())  # implicit context for ad-hoc use
    return _current[-1]


@contextlib.contextmanager
def config_context():
    ctx = ConfigContext()
    _current.append(ctx)
    try:
        yield ctx
    finally:
        _current.pop()


def reset_context() -> ConfigContext:
    """Drop any implicit context and start fresh (used by parse_config)."""
    _current.clear()
    ctx = ConfigContext()
    _current.append(ctx)
    return ctx


@dataclass
class LayerOutput:
    """Handle returned by every layer constructor
    (ref: trainer_config_helpers/layers.py LayerOutput)."""

    name: str
    layer_type: str
    size: int = 0
    parents: list["LayerOutput"] = field(default_factory=list)
    activation: Any = None
    # image geometry riding along for conv size inference
    num_filters: int = 0
    img_size: int = 0
    img_size_y: int = 0
    # sequence nesting level: 0 = sample, 1 = sequence, 2 = nested sequence
    seq_level: int = 0

    def __repr__(self) -> str:
        return f"LayerOutput({self.name!r}, {self.layer_type!r}, size={self.size})"
