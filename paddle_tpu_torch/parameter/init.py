"""Parameter initialization and carrying weights over from the JAX side.

`init_params` follows the JAX package's rules (paddle_tpu/parameter/
init.py): normal(mean, std) by default, std = 1/sqrt(fan_in) for "smart"
parameters, uniform(mean - std, mean + std) and zeros where configured.
The draws come from a `torch.Generator`, so they differ from JAX's; to
run the same weights on both sides, carry them with `params_from_jax`, and
an optimizer state (Adam or momentum slots and the update counters) with
`opt_state_from_jax`.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch

from paddle_tpu_torch.config.schema import ModelConfig, ParameterConfig
from paddle_tpu_torch.device import DeviceLike, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a schema dtype name ('float32', 'bfloat16', ...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def default_std(cfg: ParameterConfig) -> float:
    """std = 1/sqrt(fan_in), fan_in = dims[0], for smart init; else the
    configured initial_std."""
    if cfg.initial_smart and cfg.dims:
        return 1.0 / math.sqrt(max(cfg.dims[0], 1))
    return cfg.initial_std


def init_parameter(cfg: ParameterConfig, gen: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    shape = tuple(cfg.dims) if cfg.dims else (cfg.size,)
    dtype = torch_dtype(cfg.dtype)
    strategy = "normal" if cfg.initial_smart else cfg.initial_strategy
    if strategy == "zero":
        return torch.zeros(shape, dtype=dtype, device=device)
    std = default_std(cfg)
    if strategy == "uniform":
        u = torch.rand(shape, generator=gen, device=device)
        return (cfg.initial_mean - std + 2.0 * std * u).to(dtype)
    z = torch.randn(shape, generator=gen, device=device)
    return (cfg.initial_mean + std * z).to(dtype)


def init_params(model: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """Fresh parameters for every ParameterConfig of `model`, drawn in
    config order from one generator on the target device seeded by `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return {pc.name: init_parameter(pc, gen, dev) for pc in model.parameters}


def params_from_jax(np_params: Mapping[str, np.ndarray],
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None
                    ) -> dict[str, torch.Tensor]:
    """Carry JAX parameters (`Trainer.params` converted with np.asarray, or
    the arrays of a saved `model.npz`) across by name, layout unchanged.
    `dtype` casts floating parameters; None keeps each array's own dtype
    (bfloat16 arrays stay bfloat16)."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        a = np.asarray(arr)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a, dtype=np.float32) if bf16
                             else np.array(a))
        if bf16:
            t = t.to(torch.bfloat16)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(dev)
    return out


def opt_state_from_jax(np_opt_state: Mapping[str, Any],
                       device: DeviceLike = None) -> dict[str, Any]:
    """Carry a JAX `ParameterUpdater` state (`Trainer.opt_state` with its
    leaves converted by np.asarray) into the port's form: the per-parameter
    slots as tensors (Adam's m/v, momentum, ...), `num_samples`,
    `num_updates`, `pass_id` as Python ints, under model averaging the
    `average` tensors and the int32 `average_count`, under gradient
    accumulation the window's `grad_accum` sums (float32) with its
    `grad_accum_count` and `grad_accum_samples` as Python ints, and the
    pruning `masks`."""
    dev = resolve_device(device)

    def tensors(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        return {name: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
                for name, v in tree.items()}
    slots = {name: tensors(per)
             for name, per in np_opt_state["slots"].items()}
    out: dict[str, Any] = {"slots": slots}
    for k in ("num_samples", "num_updates", "pass_id", "grad_accum_count",
              "grad_accum_samples"):
        if k in np_opt_state:
            out[k] = int(np.asarray(np_opt_state[k]))
    for k in ("grad_accum", "masks"):
        if k in np_opt_state:
            out[k] = tensors(np_opt_state[k])
    if "average" in np_opt_state:
        out["average"] = tensors(np_opt_state["average"])
        out["average_count"] = torch.tensor(
            int(np.asarray(np_opt_state["average_count"])),
            dtype=torch.int32, device=dev)
    return out
