"""Activation registry — the counterpart of paddle_tpu/ops/activations.py:
identity, sigmoid, softmax (in at least float32, cast back to the input
dtype),
sequence_softmax (over each sequence's valid steps), relu, brelu, tanh,
stanh, softrelu, abs, square, tanh-approximated GELU, exponential and log,
with the reference's constants and clips.

`ACT_GRAD_FROM_OUTPUT` holds, for the activations the fused recurrent
kernels take, the derivative written in terms of the activation's output
y = f(x) — the form the backward kernels use, since they recompute y and
never keep x (paddle_tpu/ops/pallas_rnn.py `_ACTS`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.utils.dtypes import promote_compute

activation_registry: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}


def _register(*names: str):
    def deco(fn):
        for n in names:
            activation_registry[n] = fn
        return fn
    return deco


@_register("", "linear", "identity")
def identity(x: torch.Tensor, **_) -> torch.Tensor:
    return x


@_register("sigmoid")
def sigmoid(x: torch.Tensor, **_) -> torch.Tensor:
    return torch.sigmoid(x)


@_register("tanh")
def tanh(x: torch.Tensor, **_) -> torch.Tensor:
    return torch.tanh(x)


@_register("relu")
def relu(x: torch.Tensor, **_) -> torch.Tensor:
    return torch.relu(x)


@_register("brelu")
def brelu(x: torch.Tensor, **_) -> torch.Tensor:
    """Bounded relu: clipped to [0, 24]."""
    return torch.clamp(x, 0.0, 24.0)


@_register("stanh")
def stanh(x: torch.Tensor, **_) -> torch.Tensor:
    """Scaled tanh, 1.7159 * tanh(2/3 x)."""
    return 1.7159 * torch.tanh(x * (2.0 / 3.0))


@_register("softrelu")
def softrelu(x: torch.Tensor, **_) -> torch.Tensor:
    """log(1 + exp(x)) of the input clipped to [-40, 40]."""
    return torch.log1p(torch.exp(torch.clamp(x, -40.0, 40.0)))


@_register("abs")
def abs_(x: torch.Tensor, **_) -> torch.Tensor:
    return torch.abs(x)


@_register("square")
def square(x: torch.Tensor, **_) -> torch.Tensor:
    return torch.square(x)


@_register("exponential")
def exponential(x: torch.Tensor, **_) -> torch.Tensor:
    return torch.exp(x)


@_register("log")
def log(x: torch.Tensor, **_) -> torch.Tensor:
    """The natural log, in at least float32 (the result stays there)."""
    return torch.log(promote_compute(x))


@_register("gelu")
def gelu(x: torch.Tensor, **_) -> torch.Tensor:
    """tanh-approximated GELU — jax.nn.gelu(approximate=True), not
    PyTorch's exact-erf default."""
    return F.gelu(x, approximate="tanh")


@_register("softmax")
def softmax(x: torch.Tensor, **_) -> torch.Tensor:
    """Last-dim softmax in at least float32, returned in the input's dtype
    (under bfloat16 the probabilities are bfloat16, as on the JAX side)."""
    return torch.softmax(promote_compute(x), dim=-1).to(x.dtype)


@_register("sequence_softmax")
def sequence_softmax(x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     **_) -> torch.Tensor:
    """Softmax over the time axis of a [B, T] (or [B, T, 1]) sequence of
    scalars, in at least float32: the steps outside `mask` ([B, T] bool)
    take no share and come out 0."""
    in_dtype = x.dtype
    v = promote_compute(x)
    squeeze = v.dim() == 3 and v.shape[-1] == 1
    if squeeze:
        v = v[..., 0]
    if mask is not None:
        v = v.masked_fill(~mask, float("-inf"))
    out = torch.softmax(v, dim=-1)
    if mask is not None:
        out = out.masked_fill(~mask, 0.0)
    if squeeze:
        out = out[..., None]
    return out.to(in_dtype)


ACT_GRAD_FROM_OUTPUT: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sigmoid": lambda y: y * (1.0 - y),
    "tanh": lambda y: 1.0 - y * y,
    "relu": lambda y: (y > 0).to(y.dtype),
    "linear": torch.ones_like,
    "": torch.ones_like,
}


def activation(name: str, x: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Activation `name` of x; `mask` ([B, T] bool) is the valid steps of
    a sequence, which sequence_softmax reads."""
    try:
        fn = activation_registry[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: "
                         f"{sorted(activation_registry)}") from None
    return fn(x, mask=mask)
