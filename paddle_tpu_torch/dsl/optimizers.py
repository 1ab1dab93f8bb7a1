"""Optimizer DSL: settings() + optimizer descriptors
(ref: trainer_config_helpers/optimizers.py: settings:358, Momentum/Adam/...)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.dsl.base import current_context

__all__ = [
    "settings", "MomentumOptimizer", "AdamOptimizer", "AdamaxOptimizer",
    "AdaGradOptimizer", "DecayedAdaGradOptimizer", "AdaDeltaOptimizer",
    "RMSPropOptimizer", "L2Regularization", "L1Regularization",
    "GradientClippingThreshold", "ModelAverage",
    "Optimizer", "BaseRegularization", "BaseSGDOptimizer",
]


class Optimizer:
    """Root of the settings-applying hierarchy (ref: optimizers.py
    Optimizer:28) — exists so user isinstance checks from reference-era
    configs keep working."""

    def apply(self, opt) -> None:   # pragma: no cover - abstract
        raise NotImplementedError


class BaseSGDOptimizer(Optimizer):
    learning_method = "momentum"

    def apply(self, opt) -> None:
        opt.learning_method = self.learning_method


class MomentumOptimizer(BaseSGDOptimizer):
    learning_method = "momentum"

    def __init__(self, momentum: float = 0.0, sparse: bool = False):
        self.momentum = momentum
        self.sparse = sparse

    def apply(self, opt) -> None:
        opt.learning_method = "sparse_momentum" if self.sparse else "momentum"
        opt.momentum = self.momentum


class AdamOptimizer(BaseSGDOptimizer):
    learning_method = "adam"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def apply(self, opt) -> None:
        opt.learning_method = "adam"
        opt.adam_beta1 = self.beta1
        opt.adam_beta2 = self.beta2
        opt.adam_epsilon = self.epsilon


class AdamaxOptimizer(BaseSGDOptimizer):
    learning_method = "adamax"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999):
        self.beta1, self.beta2 = beta1, beta2

    def apply(self, opt) -> None:
        opt.learning_method = "adamax"
        opt.adam_beta1 = self.beta1
        opt.adam_beta2 = self.beta2


class AdaGradOptimizer(BaseSGDOptimizer):
    learning_method = "adagrad"

    def __init__(self, epsilon: float = 1e-6):
        self.epsilon = epsilon

    def apply(self, opt) -> None:
        opt.learning_method = "adagrad"
        opt.ada_epsilon = self.epsilon


class DecayedAdaGradOptimizer(BaseSGDOptimizer):
    learning_method = "decayed_adagrad"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def apply(self, opt) -> None:
        opt.learning_method = "decayed_adagrad"
        opt.ada_rho = self.rho
        opt.ada_epsilon = self.epsilon


class AdaDeltaOptimizer(BaseSGDOptimizer):
    learning_method = "adadelta"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def apply(self, opt) -> None:
        opt.learning_method = "adadelta"
        opt.ada_rho = self.rho
        opt.ada_epsilon = self.epsilon


class RMSPropOptimizer(BaseSGDOptimizer):
    learning_method = "rmsprop"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def apply(self, opt) -> None:
        opt.learning_method = "rmsprop"
        opt.ada_rho = self.rho
        opt.ada_epsilon = self.epsilon


class BaseRegularization(Optimizer):
    """(ref: optimizers.py BaseRegularization:294)."""


class L2Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate

    def apply(self, opt) -> None:
        opt.l2_weight = self.rate


class L1Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate

    def apply(self, opt) -> None:
        opt.l1_weight = self.rate


class GradientClippingThreshold(Optimizer):
    def __init__(self, threshold: float):
        self.threshold = threshold

    def apply(self, opt) -> None:
        opt.gradient_clipping_threshold = self.threshold


class ModelAverage(Optimizer):
    def __init__(self, average_window: float, max_average_window: Optional[int] = None,
                 do_average_in_cpu: bool = False):
        self.average_window = average_window
        self.max_average_window = max_average_window
        self.do_average_in_cpu = do_average_in_cpu

    def apply(self, opt) -> None:
        opt.average_window = self.average_window
        if self.max_average_window:
            opt.max_average_window = self.max_average_window
        opt.do_average_in_cpu = self.do_average_in_cpu


def settings(
    batch_size: int,
    learning_rate: float = 1e-3,
    learning_method=None,
    regularization=None,
    learning_rate_decay_a: float = 0.0,
    learning_rate_decay_b: float = 0.0,
    learning_rate_schedule: str = "poly",
    learning_rate_args: str = "",
    model_average=None,
    gradient_clipping_threshold=None,
    dtype: str = "float32",
    compute_dtype: str = "",
    **kwargs,
) -> None:
    """Set global optimization settings (ref: optimizers.py settings:358)."""
    opt = current_context().opt
    opt.batch_size = batch_size
    opt.learning_rate = learning_rate
    opt.learning_rate_decay_a = learning_rate_decay_a
    opt.learning_rate_decay_b = learning_rate_decay_b
    opt.learning_rate_schedule = learning_rate_schedule
    opt.learning_rate_args = learning_rate_args
    opt.dtype = dtype
    opt.compute_dtype = compute_dtype
    if learning_method is not None:
        learning_method.apply(opt)
    regs = regularization if isinstance(regularization, (list, tuple)) else (
        [regularization] if regularization is not None else [])
    for r in regs:
        r.apply(opt)
    if model_average is not None:
        model_average.apply(opt)
    if gradient_clipping_threshold is not None:
        if isinstance(gradient_clipping_threshold, GradientClippingThreshold):
            gradient_clipping_threshold.apply(opt)
        else:
            opt.gradient_clipping_threshold = float(gradient_clipping_threshold)
    for k, v in kwargs.items():
        if hasattr(opt, k):
            setattr(opt, k, v)
