"""First-order update rules — the port's copy of
paddle_tpu/optim/optimizers.py.

Each rule is a pair (init_slots(p, opt) -> dict, update(p, g, slots, lr,
opt, t, **kw) -> (new p, new slots)) over one parameter tensor, applied per
parameter by the ParameterUpdater.  The rules are the JAX package's (and so
the reference's): momentum (alias sgd, sparse_momentum), adagrad,
decayed_adagrad, adadelta, rmsprop, adam, adamax.  They return new tensors
and leave their inputs untouched (the updater writes the results into the
parameter and slot storage); `lr` is a float or a 0-d tensor, `t` the
1-based update count, an int or the updater's `StepCount`.
"""

from __future__ import annotations

from typing import Callable

import torch

from paddle_tpu_torch.config.schema import OptimizationConfig

# name -> (init_slots, update)
optimizer_registry: dict[str, tuple[Callable, Callable]] = {}


def _register(*names: str):
    def deco(pair):
        for n in names:
            optimizer_registry[n] = pair
        return pair
    return deco


def _momentum_init(p: torch.Tensor, opt: OptimizationConfig) -> dict:
    return {"momentum": torch.zeros_like(p)}


def _momentum_update(p, g, slots, lr, opt, t, mom_override=None):
    """v <- momentum * v - lr * g ; p <- p + v."""
    mom = opt.momentum if mom_override is None else mom_override
    v = mom * slots["momentum"] - lr * g
    return p + v, {"momentum": v}


_register("momentum", "sgd", "sparse_momentum")(
    (_momentum_init, _momentum_update))


def _adagrad_init(p, opt):
    return {"accum": torch.zeros_like(p)}


def _adagrad_update(p, g, slots, lr, opt, t, **_):
    accum = slots["accum"] + torch.square(g)
    upd = g / (torch.sqrt(accum) + opt.ada_epsilon)
    return p - lr * upd, {"accum": accum}


_register("adagrad")((_adagrad_init, _adagrad_update))


def _decayed_adagrad_init(p, opt):
    return {"accum": torch.zeros_like(p)}


def _decayed_adagrad_update(p, g, slots, lr, opt, t, **_):
    accum = opt.ada_rho * slots["accum"] + (1.0 - opt.ada_rho) * torch.square(g)
    upd = g / torch.sqrt(accum + opt.ada_epsilon)
    return p - lr * upd, {"accum": accum}


_register("decayed_adagrad")((_decayed_adagrad_init, _decayed_adagrad_update))


def _adadelta_init(p, opt):
    return {"accum": torch.zeros_like(p), "accum_update": torch.zeros_like(p)}


def _adadelta_update(p, g, slots, lr, opt, t, **_):
    rho, eps = opt.ada_rho, opt.ada_epsilon
    accum = rho * slots["accum"] + (1.0 - rho) * torch.square(g)
    upd = g * torch.sqrt((slots["accum_update"] + eps) / (accum + eps))
    accum_update = rho * slots["accum_update"] + (1.0 - rho) * torch.square(upd)
    return p - lr * upd, {"accum": accum, "accum_update": accum_update}


_register("adadelta")((_adadelta_init, _adadelta_update))


def _rmsprop_init(p, opt):
    return {"accum_g2": torch.zeros_like(p), "accum_g": torch.zeros_like(p)}


def _rmsprop_update(p, g, slots, lr, opt, t, **_):
    """Graves-style RMSProp with the first-moment correction."""
    rho, eps = opt.ada_rho, opt.ada_epsilon
    g2 = rho * slots["accum_g2"] + (1.0 - rho) * torch.square(g)
    g1 = rho * slots["accum_g"] + (1.0 - rho) * g
    upd = g / torch.sqrt(g2 - torch.square(g1) + eps)
    return p - lr * upd, {"accum_g2": g2, "accum_g": g1}


_register("rmsprop")((_rmsprop_init, _rmsprop_update))


class StepCount:
    """The 1-based update count of one step as a 0-d float32 tensor on the
    parameters' device (from the updater's device counter), with each bias
    correction 1 - base ** t the rules take computed once for all
    parameters, without a host read."""

    def __init__(self, t: torch.Tensor):
        self.value = t.to(torch.float32)
        self._corrections: dict[float, torch.Tensor] = {}

    def correction(self, base: float) -> torch.Tensor:
        if base not in self._corrections:
            self._corrections[base] = 1.0 - torch.pow(base, self.value)
        return self._corrections[base]


def _correction(base: float, t) -> torch.Tensor:
    """1 - base ** t in float32, as 1 - jnp.power(base, t.astype(float32));
    `t` an int or a StepCount."""
    if isinstance(t, StepCount):
        return t.correction(base)
    return 1.0 - torch.pow(base, torch.tensor(float(t), dtype=torch.float32))


def _adam_init(p, opt):
    return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}


def _adam_update(p, g, slots, lr, opt, t, **_):
    b1, b2, eps = opt.adam_beta1, opt.adam_beta2, opt.adam_epsilon
    m = b1 * slots["m"] + (1.0 - b1) * g
    v = b2 * slots["v"] + (1.0 - b2) * torch.square(g)
    mhat = m / _correction(b1, t)
    vhat = v / _correction(b2, t)
    return p - lr * mhat / (torch.sqrt(vhat) + eps), {"m": m, "v": v}


_register("adam")((_adam_init, _adam_update))


def _adamax_init(p, opt):
    return {"m": torch.zeros_like(p), "u": torch.zeros_like(p)}


def _adamax_update(p, g, slots, lr, opt, t, **_):
    b1, b2 = opt.adam_beta1, opt.adam_beta2
    m = b1 * slots["m"] + (1.0 - b1) * g
    u = torch.maximum(b2 * slots["u"], torch.abs(g))
    lr_t = lr / _correction(b1, t)
    return p - lr_t * m / (u + 1e-12), {"m": m, "u": u}


_register("adamax")((_adamax_init, _adamax_update))


def get_optimizer(name: str):
    try:
        return optimizer_registry[name]
    except KeyError:
        raise ValueError(f"unknown learning_method {name!r}; "
                         f"known: {sorted(optimizer_registry)}") from None
