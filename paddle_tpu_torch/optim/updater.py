"""ParameterUpdater — the port's counterpart of paddle_tpu/optim/updater.py.

Applies, per parameter: the learning-rate schedule (by processed samples),
the per-parameter learning-rate multiplier and momentum override, the
ELEMENTWISE gradient clip clip(g, -thr, thr) (global threshold or a
per-parameter one; not a norm clip), L2 then L1 decay added to the
gradient, and the update rule of `learning_method`.  Static parameters are
left alone.  The state holds each parameter's slots as tensors and three
host counters (`num_samples`, `num_updates`, `pass_id`).

Not ported yet, and refused when configured (ROADMAP.md): pruning hooks
(`update_hooks`), model averaging (`average_window`) and gradient
accumulation (`num_batches_per_send_parameter > 1`).
"""

from __future__ import annotations

from typing import Any

import torch

from paddle_tpu_torch.config.schema import (ModelConfig, OptimizationConfig,
                                            ParameterConfig)
from paddle_tpu_torch.optim.optimizers import get_optimizer
from paddle_tpu_torch.optim.schedulers import learning_rate_at

_MOMENTUM_RULES = ("momentum", "sgd", "sparse_momentum")


class ParameterUpdater:
    def __init__(self, model: ModelConfig, opt: OptimizationConfig):
        hooked = [p.name for p in model.parameters if p.update_hooks]
        if hooked:
            raise NotImplementedError(
                f"parameter update hooks (pruning) on {hooked} are not "
                f"ported yet (ROADMAP.md)")
        if opt.average_window > 0:
            raise NotImplementedError("model averaging (average_window > 0) "
                                      "is not ported yet (ROADMAP.md)")
        if int(opt.num_batches_per_send_parameter) > 1:
            raise NotImplementedError(
                "gradient accumulation (num_batches_per_send_parameter > 1) "
                "is not ported yet (ROADMAP.md)")
        self.model = model
        self.opt = opt
        self.param_cfgs: dict[str, ParameterConfig] = {
            p.name: p for p in model.parameters}
        self.init_slots_fn, self.update_fn = get_optimizer(
            opt.learning_method)

    def init_state(self, params: dict[str, torch.Tensor]) -> dict[str, Any]:
        slots = {name: self.init_slots_fn(p, self.opt)
                 for name, p in params.items()
                 if not self.param_cfgs[name].is_static}
        return {"slots": slots, "num_samples": 0, "num_updates": 0,
                "pass_id": 0}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor], state: dict[str, Any],
             batch_size: int):
        """One update.  Returns (new params, new state); the inputs are not
        modified."""
        opt = self.opt
        num_samples = state["num_samples"] + int(batch_size)
        t = state["num_updates"] + 1
        base_lr = learning_rate_at(opt, num_samples, state["pass_id"])
        new_params: dict[str, torch.Tensor] = {}
        new_slots: dict[str, Any] = {}
        for name, p in params.items():
            cfg = self.param_cfgs[name]
            if cfg.is_static or name not in grads:
                new_params[name] = p
                if name in state["slots"]:
                    new_slots[name] = state["slots"][name]
                continue
            g = grads[name]
            # per-param None inherits the global threshold; 0.0 disables
            thr = (cfg.gradient_clipping_threshold
                   if cfg.gradient_clipping_threshold is not None
                   else opt.gradient_clipping_threshold)
            if thr:
                g = torch.clamp(g, -thr, thr)
            l2 = cfg.decay_rate if cfg.decay_rate is not None else \
                opt.l2_weight
            if l2:
                g = g + l2 * p
            l1 = cfg.decay_rate_l1 if cfg.decay_rate_l1 is not None else \
                opt.l1_weight
            if l1:
                g = g + l1 * torch.sign(p)
            kw = ({"mom_override": cfg.momentum}
                  if cfg.momentum is not None
                  and opt.learning_method in _MOMENTUM_RULES else {})
            new_params[name], new_slots[name] = self.update_fn(
                p, g, state["slots"][name], base_lr * cfg.learning_rate,
                opt, t, **kw)
        return new_params, {"slots": new_slots, "num_samples": num_samples,
                            "num_updates": t, "pass_id": state["pass_id"]}

    def finish_pass(self, state: dict[str, Any]) -> dict[str, Any]:
        return dict(state, pass_id=state["pass_id"] + 1)
