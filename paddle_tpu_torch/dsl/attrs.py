"""Parameter / layer attribute descriptors
(ref: trainer_config_helpers/attrs.py ParameterAttribute:58, ExtraLayerAttribute)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.config.schema import ParameterConfig

__all__ = ["ParameterAttribute", "ExtraLayerAttribute", "ParamAttr", "ExtraAttr"]


class ParameterAttribute:
    """User-specified parameter settings, merged into ParameterConfig."""

    def __init__(
        self,
        name: Optional[str] = None,
        is_static: bool = False,
        initial_std: Optional[float] = None,
        initial_mean: Optional[float] = None,
        initial_max: Optional[float] = None,
        initial_min: Optional[float] = None,
        l1_rate: Optional[float] = None,
        l2_rate: Optional[float] = None,
        learning_rate: Optional[float] = None,
        momentum: Optional[float] = None,
        sparse_update: bool = False,
        gradient_clipping_threshold: Optional[float] = None,
        partition_spec: Optional[list] = None,
        update_hooks: Optional[list] = None,
    ):
        self.name = name
        self.is_static = is_static
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.initial_max = initial_max
        self.initial_min = initial_min
        self.l1_rate = l1_rate
        self.l2_rate = l2_rate
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.sparse_update = sparse_update
        self.gradient_clipping_threshold = gradient_clipping_threshold
        self.partition_spec = partition_spec
        self.update_hooks = update_hooks

    def apply(self, cfg: ParameterConfig) -> ParameterConfig:
        if self.name:
            cfg.name = self.name
        cfg.is_static = self.is_static
        if self.initial_min is not None or self.initial_max is not None:
            lo = self.initial_min if self.initial_min is not None else 0.0
            hi = self.initial_max if self.initial_max is not None else 1.0
            cfg.initial_strategy = "uniform"
            cfg.initial_mean = (lo + hi) / 2.0
            cfg.initial_std = (hi - lo) / 2.0
            cfg.initial_smart = False
        if self.initial_std is not None:
            cfg.initial_std = self.initial_std
            cfg.initial_smart = False
        if self.initial_mean is not None:
            cfg.initial_mean = self.initial_mean
        if self.l1_rate is not None:
            cfg.decay_rate_l1 = self.l1_rate
        if self.l2_rate is not None:
            cfg.decay_rate = self.l2_rate
        if self.learning_rate is not None:
            cfg.learning_rate = self.learning_rate
        if self.momentum is not None:
            cfg.momentum = self.momentum
        if self.sparse_update:
            cfg.sparse_update = True
        if self.gradient_clipping_threshold is not None:
            cfg.gradient_clipping_threshold = self.gradient_clipping_threshold
        if self.partition_spec is not None:
            cfg.partition_spec = list(self.partition_spec)
        if self.update_hooks is not None:
            cfg.update_hooks = [dict(h) for h in self.update_hooks]
        return cfg


class ExtraLayerAttribute:
    """Extra layer settings: dropout etc. (ref: attrs.py ExtraLayerAttribute)."""

    def __init__(self, error_clipping_threshold: Optional[float] = None,
                 drop_rate: Optional[float] = None, device: Optional[int] = None):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device


ParamAttr = ParameterAttribute
ExtraAttr = ExtraLayerAttribute
