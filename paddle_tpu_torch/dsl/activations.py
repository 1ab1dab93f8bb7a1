"""Activation descriptors (ref: trainer_config_helpers/activations.py)."""

from __future__ import annotations

__all__ = [
    "BaseActivation", "LinearActivation", "IdentityActivation", "TanhActivation",
    "SigmoidActivation", "SoftmaxActivation", "SequenceSoftmaxActivation",
    "ReluActivation", "BReluActivation", "SoftReluActivation", "STanhActivation",
    "AbsActivation", "SquareActivation", "ExpActivation", "LogActivation",
    "GeluActivation",
]


# every activation name of the JAX package's registry
# (paddle_tpu/ops/activations.py activation_registry), frozen: what a
# config may name, whatever the port's executor has ported so far
ACTIVATION_TYPES = (
    "", "abs", "brelu", "exponential", "gelu", "identity", "linear", "log",
    "relu", "sequence_softmax", "sigmoid", "softmax", "softrelu", "square",
    "stanh", "tanh",
)


class BaseActivation:
    name: str = ""

    def __repr__(self) -> str:
        return type(self).__name__


class LinearActivation(BaseActivation):
    name = ""


IdentityActivation = LinearActivation


class TanhActivation(BaseActivation):
    name = "tanh"


class SigmoidActivation(BaseActivation):
    name = "sigmoid"


class SoftmaxActivation(BaseActivation):
    name = "softmax"


class SequenceSoftmaxActivation(BaseActivation):
    name = "sequence_softmax"


class ReluActivation(BaseActivation):
    name = "relu"


class BReluActivation(BaseActivation):
    name = "brelu"


class SoftReluActivation(BaseActivation):
    name = "softrelu"


class STanhActivation(BaseActivation):
    name = "stanh"


class AbsActivation(BaseActivation):
    name = "abs"


class SquareActivation(BaseActivation):
    name = "square"


class ExpActivation(BaseActivation):
    name = "exponential"


class LogActivation(BaseActivation):
    name = "log"


class GeluActivation(BaseActivation):
    """tanh-approximated GELU (beyond the reference's zoo)."""
    name = "gelu"


def act_name(act) -> str:
    if act is None:
        return ""
    if isinstance(act, str):
        return act
    return act.name
