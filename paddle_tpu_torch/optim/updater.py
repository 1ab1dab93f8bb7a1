"""ParameterUpdater — the port's counterpart of paddle_tpu/optim/updater.py.

Applies, per parameter: the learning-rate schedule (by processed samples),
the per-parameter learning-rate multiplier and momentum override, the
ELEMENTWISE gradient clip clip(g, -thr, thr) (global threshold or a
per-parameter one; not a norm clip), L2 then L1 decay added to the
gradient, and the update rule of `learning_method`.  Static parameters are
left alone.  The state holds each parameter's slots as tensors and three
host counters (`num_samples`, `num_updates`, `pass_id`).

An update writes the new parameters and slots into their tensors in place,
and reads the counters from 0-d device copies that it advances itself, so
it makes no host read and a CUDA graph of the training step can hold it:
`step` is `load_counters` (upload the host counters where they moved, not
capturable), `apply` (the update, capturable) and `advance` (the host
counters); the Trainer's fused dispatch runs the first and last around
every replay of a graph that holds `apply`.

Model averaging (`average_window > 0`, the reference's AverageOptimizer)
keeps a running mean of every parameter after each update in the state's
`average` tensors, with the number of updates it holds in
`average_count` (a 0-d int32 tensor on the device): avg += (p - avg) /
count, the count cast to the parameter's dtype; past
`max_average_window` updates the window restarts from the current
parameters (`torch.where`, so a captured step has no host branch).
`averaged_params` gives the parameters to evaluate with.

Not ported yet, and refused when configured (ROADMAP.md): pruning hooks
(`update_hooks`) and gradient accumulation
(`num_batches_per_send_parameter > 1`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from paddle_tpu_torch.config.schema import (ModelConfig, OptimizationConfig,
                                            ParameterConfig)
from paddle_tpu_torch.optim.optimizers import StepCount, get_optimizer
from paddle_tpu_torch.optim.schedulers import learning_rate_tensor

_MOMENTUM_RULES = ("momentum", "sgd", "sparse_momentum")


class ParameterUpdater:
    def __init__(self, model: ModelConfig, opt: OptimizationConfig):
        hooked = [p.name for p in model.parameters if p.update_hooks]
        if hooked:
            raise NotImplementedError(
                f"parameter update hooks (pruning) on {hooked} are not "
                f"ported yet (ROADMAP.md)")
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
        self.use_average = opt.average_window > 0
        # (num_samples, num_updates, pass_id) on the parameters' device,
        # and the host values they hold
        self._counters: Optional[torch.Tensor] = None
        self._mirror: Optional[tuple] = None

    def init_state(self, params: dict[str, torch.Tensor]) -> dict[str, Any]:
        slots = {name: self.init_slots_fn(p, self.opt)
                 for name, p in params.items()
                 if not self.param_cfgs[name].is_static}
        state = {"slots": slots, "num_samples": 0, "num_updates": 0,
                 "pass_id": 0}
        if self.use_average:
            first = next(iter(params.values()))
            state["average"] = {name: p.detach().clone()
                                for name, p in params.items()}
            state["average_count"] = torch.zeros((), dtype=torch.int32,
                                                 device=first.device)
        return state

    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor], state: dict[str, Any],
             batch_size: int):
        """One update.  The parameters and slots are updated in place;
        returns (params, the new state)."""
        self.load_counters(state, next(iter(params.values())).device)
        self.apply(params, grads, state, batch_size)
        return params, self.advance(state, batch_size)

    def load_counters(self, state: dict[str, Any],
                      device: torch.device) -> None:
        """Make the device counters hold the state's host counters: an
        upload only when they moved other than by `advance` (a new state,
        a loaded checkpoint, the end of a pass)."""
        host = (int(state["num_samples"]), int(state["num_updates"]),
                int(state["pass_id"]))
        device = torch.device(device)
        if self._counters is None or not _same_device(self._counters.device,
                                                      device):
            self._counters = torch.zeros(3, dtype=torch.int64, device=device)
            self._mirror = None
        if host != self._mirror:
            self._counters.copy_(torch.tensor(host, dtype=torch.int64))
            self._mirror = host

    def advance(self, state: dict[str, Any], batch_size: int
                ) -> dict[str, Any]:
        """The host counters after one `apply` (which advanced the device
        ones the same way)."""
        new = dict(state, num_samples=state["num_samples"] + int(batch_size),
                   num_updates=state["num_updates"] + 1)
        self._mirror = (new["num_samples"], new["num_updates"],
                        new["pass_id"])
        return new

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: dict[str, Any],
              batch_size: int) -> None:
        """The update on the device, in place: the counters advance, then
        every trainable parameter with a gradient and its slots (in
        `state["slots"]`) take the rule's new values, then the averages.
        No host read."""
        opt = self.opt
        slots = state["slots"]
        c = self._counters
        c[0].add_(int(batch_size))
        c[1].add_(1)
        base_lr = learning_rate_tensor(opt, c[0], c[2])
        step = StepCount(c[1])
        lrs: dict[float, torch.Tensor] = {}     # by per-parameter multiplier
        dst, src = [], []
        for name, p in params.items():
            cfg = self.param_cfgs[name]
            if cfg.is_static or name not in grads:
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
            if cfg.learning_rate not in lrs:
                lrs[cfg.learning_rate] = base_lr * cfg.learning_rate
            new_p, new_slots = self.update_fn(
                p, g, slots[name], lrs[cfg.learning_rate], opt, step, **kw)
            dst.append(p)
            src.append(new_p)
            for k, v in new_slots.items():
                dst.append(slots[name][k])
                src.append(v)
        if dst:
            torch._foreach_copy_(dst, src)
        if self.use_average:
            self._average(params, state)

    def _average(self, params: dict[str, torch.Tensor],
                 state: dict[str, Any]) -> None:
        """The running mean of every parameter after this update, the
        window restarting from the current parameters once it would hold
        more than max_average_window updates."""
        count = state["average_count"]
        cnt = count + 1
        max_win = self.opt.max_average_window or 0
        if max_win:
            reset = cnt > max_win
            cnt = torch.where(reset, torch.ones_like(cnt), cnt)
        dst, src = [], []
        for name, p in params.items():
            prev = state["average"][name]
            if max_win:
                prev = torch.where(reset, p, prev)
            dst.append(prev)
            src.append(prev + (p - prev) / cnt.to(p.dtype))
        torch._foreach_copy_([state["average"][n] for n in params], src)
        count.copy_(cnt)

    def averaged_params(self, params: dict[str, torch.Tensor],
                        state: dict[str, Any]) -> dict[str, torch.Tensor]:
        """The parameters to evaluate with: the averages under model
        averaging, else the parameters themselves."""
        return state["average"] if self.use_average else params

    def finish_pass(self, state: dict[str, Any]) -> dict[str, Any]:
        return dict(state, pass_id=state["pass_id"] + 1)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a and b name one device ('cuda' is the current CUDA device)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
