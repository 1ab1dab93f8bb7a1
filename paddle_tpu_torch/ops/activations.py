"""Activation registry (a subset).

Counterparts of paddle_tpu/ops/activations.py for the activations the
ported models use: identity, sigmoid, tanh, relu, tanh-approximated GELU,
and softmax (in float32, cast back to the input dtype).  The rest of the
zoo is queued in ROADMAP.md.

`ACT_GRAD_FROM_OUTPUT` holds, for the activations the fused recurrent
kernels take, the derivative written in terms of the activation's output
y = f(x) — the form the backward kernels use, since they recompute y and
never keep x (paddle_tpu/ops/pallas_rnn.py `_ACTS`).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

activation_registry: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}


def _register(*names: str):
    def deco(fn):
        for n in names:
            activation_registry[n] = fn
        return fn
    return deco


@_register("", "linear", "identity")
def identity(x: torch.Tensor) -> torch.Tensor:
    return x


@_register("sigmoid")
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


@_register("tanh")
def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


@_register("relu")
def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


@_register("gelu")
def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU — jax.nn.gelu(approximate=True), not
    PyTorch's exact-erf default."""
    return F.gelu(x, approximate="tanh")


@_register("softmax")
def softmax(x: torch.Tensor) -> torch.Tensor:
    """Last-dim softmax in float32, returned in the input's dtype (under
    bfloat16 the probabilities are bfloat16, as on the JAX side)."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


ACT_GRAD_FROM_OUTPUT: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sigmoid": lambda y: y * (1.0 - y),
    "tanh": lambda y: 1.0 - y * y,
    "relu": lambda y: (y > 0).to(y.dtype),
    "linear": torch.ones_like,
    "": torch.ones_like,
}


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    try:
        fn = activation_registry[name]
    except KeyError:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (ROADMAP.md); ported: "
            f"{sorted(activation_registry)}") from None
    return fn(x)
