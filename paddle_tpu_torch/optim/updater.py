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

Gradient accumulation (`num_batches_per_send_parameter` = N > 1, the
reference's `accum_n`): every step adds its sample-weighted gradient
batch_size * g into `grad_accum` (float32 or wider, in place), and the N-th
step of a window applies the rule once to acc / n_samples, with n_samples
as the update's batch size for the schedule: the math of one step on the
N batches concatenated.  The accumulate-or-apply branch is decided on the
device from the window's device count: each step computes the update and
`torch.where` keeps it only on the window's last step, so a window
boundary inside a captured group of steps needs no host branch and no
graph per window phase.  The window's count and samples are host counters
beside the others (`grad_accum_count`, `grad_accum_samples`) with device
copies in the same counter tensor; `advance` moves `num_samples` and
`num_updates` only on apply steps, as the device does.  A partial window
is dropped at the end of a pass (`finish_pass`).

Pruning hooks (`update_hooks` of type "pruning", the reference's
StaticPruningHook): `apply_init_hooks` builds a 0/1 mask per hooked
parameter, from a `sparsity_ratio` (the ratio's smallest-|w| entries of
the initial value, by a stable argsort) or a `.npy` `mask_filename`, and
masks the initial value; the masks travel in `state["masks"]`, and every
update masks the gradient and re-masks the new value.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from paddle_tpu_torch.config.schema import (ModelConfig, OptimizationConfig,
                                            ParameterConfig)
from paddle_tpu_torch.optim.optimizers import StepCount, get_optimizer
from paddle_tpu_torch.optim.schedulers import learning_rate_tensor

_MOMENTUM_RULES = ("momentum", "sgd", "sparse_momentum")
# the host counters, in the order of their device copies
_COUNTERS = ("num_samples", "num_updates", "pass_id")
_WINDOW = ("grad_accum_count", "grad_accum_samples")


class ParameterUpdater:
    def __init__(self, model: ModelConfig, opt: OptimizationConfig):
        self.model = model
        self.opt = opt
        self.param_cfgs: dict[str, ParameterConfig] = {
            p.name: p for p in model.parameters}
        self.init_slots_fn, self.update_fn = get_optimizer(
            opt.learning_method)
        self.use_average = opt.average_window > 0
        # the window of gradient accumulation (ref: RemoteParameterUpdater
        # num_batches_per_send_parameter)
        self.accum_n = max(int(opt.num_batches_per_send_parameter), 1)
        self._masks: dict[str, torch.Tensor] = {}   # by apply_init_hooks
        # the host counters (and the window's, under accumulation) on the
        # parameters' device, and the host values they hold
        self._names = _COUNTERS + (_WINDOW if self.accum_n > 1 else ())
        self._counters: Optional[torch.Tensor] = None
        self._mirror: Optional[tuple] = None

    def apply_init_hooks(self, params: dict[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
        """Build the pruning masks from the parameters' values and return
        the parameters masked (new tensors for the hooked ones)."""
        out = dict(params)
        for name, cfg in self.param_cfgs.items():
            for hook in cfg.update_hooks:
                if hook.get("type") != "pruning":
                    raise ValueError(f"unknown updater hook {hook!r}")
                p = out[name]
                host = p.detach().float().cpu().numpy() \
                    if p.dtype == torch.bfloat16 else p.detach().cpu().numpy()
                if "mask_filename" in hook:
                    mask = np.load(hook["mask_filename"]).astype(host.dtype)
                    if mask.shape != host.shape:
                        raise ValueError(f"mask {mask.shape} vs param "
                                         f"{host.shape} of {name!r}")
                else:
                    k = int(float(hook.get("sparsity_ratio", 0.0))
                            * host.size)
                    mask = np.ones(host.size, host.dtype)
                    if k > 0:
                        order = np.argsort(np.abs(host.reshape(-1)),
                                           kind="stable")
                        mask[order[:k]] = 0.0
                    mask = mask.reshape(host.shape)
                m = torch.from_numpy(mask).to(device=p.device,
                                              dtype=p.dtype)
                self._masks[name] = m
                out[name] = p * m
        return out

    def init_state(self, params: dict[str, torch.Tensor]) -> dict[str, Any]:
        slots = {name: self.init_slots_fn(p, self.opt)
                 for name, p in params.items()
                 if not self.param_cfgs[name].is_static}
        state = {"slots": slots, "num_samples": 0, "num_updates": 0,
                 "pass_id": 0}
        if self._masks:
            state["masks"] = dict(self._masks)
        if self.use_average:
            first = next(iter(params.values()))
            state["average"] = {name: p.detach().clone()
                                for name, p in params.items()}
            state["average_count"] = torch.zeros((), dtype=torch.int32,
                                                 device=first.device)
        if self.accum_n > 1:
            # summed in at least float32: a rounding per add in a narrower
            # type would break the concatenated-batch equivalence
            state["grad_accum"] = {
                name: torch.zeros_like(p, dtype=torch.promote_types(
                    p.dtype, torch.float32) if p.is_floating_point()
                    else p.dtype)
                for name, p in params.items()
                if not self.param_cfgs[name].is_static}
            state["grad_accum_count"] = 0
            state["grad_accum_samples"] = 0
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
        host = tuple(int(state[k]) for k in self._names)
        device = torch.device(device)
        if self._counters is None or not _same_device(self._counters.device,
                                                      device):
            self._counters = torch.zeros(len(self._names), dtype=torch.int64,
                                         device=device)
            self._mirror = None
        if host != self._mirror:
            self._counters.copy_(torch.tensor(host, dtype=torch.int64))
            self._mirror = host

    def advance(self, state: dict[str, Any], batch_size: int
                ) -> dict[str, Any]:
        """The host counters after one `apply` (which advanced the device
        ones the same way): under accumulation the window's count and
        samples, and the update's counters on the window's last step."""
        bs = int(batch_size)
        if self.accum_n == 1:
            new = dict(state, num_samples=state["num_samples"] + bs,
                       num_updates=state["num_updates"] + 1)
        else:
            cnt = state["grad_accum_count"] + 1
            n = state["grad_accum_samples"] + bs
            if cnt >= self.accum_n:
                new = dict(state, num_samples=state["num_samples"] + n,
                           num_updates=state["num_updates"] + 1,
                           grad_accum_count=0, grad_accum_samples=0)
            else:
                new = dict(state, grad_accum_count=cnt,
                           grad_accum_samples=n)
        self._mirror = tuple(new[k] for k in self._names)
        return new

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: dict[str, Any],
              batch_size: int) -> None:
        """The update on the device, in place: the counters advance, then
        every trainable parameter with a gradient and its slots (in
        `state["slots"]`) take the rule's new values, then the averages;
        under accumulation the gradient goes into the window's sums and
        all of that takes effect on the window's last step only.  No host
        read."""
        c = self._counters
        bs = int(batch_size)
        if self.accum_n == 1:
            c[0].add_(bs)
            c[1].add_(1)
            self._update(params, grads, state, c[0], c[1], c[2], None)
            return
        acc = state["grad_accum"]
        summed = {name: (a + bs * grads[name].to(a.dtype)
                         if name in grads else a)
                  for name, a in acc.items()}
        cnt, n_samples = c[3] + 1, c[4] + bs
        now = cnt >= self.accum_n
        num_samples, num_updates = c[0] + n_samples, c[1] + 1
        self._update(params, self.window_mean(summed, n_samples), state,
                     num_samples, num_updates, c[2], now)
        zero = torch.zeros_like(cnt)
        c.copy_(torch.stack([torch.where(now, num_samples, c[0]),
                             torch.where(now, num_updates, c[1]), c[2],
                             torch.where(now, zero, cnt),
                             torch.where(now, zero, n_samples)]))
        torch._foreach_copy_(
            list(acc.values()),
            [torch.where(now, torch.zeros_like(s), s)
             for s in summed.values()])

    @staticmethod
    def window_mean(summed: dict[str, torch.Tensor],
                    n_samples: torch.Tensor) -> dict[str, torch.Tensor]:
        """The gradient an accumulated update consumes: the window's
        sample-weighted sums over its samples."""
        denom = n_samples.to(torch.float32)
        return {name: (a / denom).to(a.dtype) for name, a in summed.items()}

    def _update(self, params: dict[str, torch.Tensor],
                grads: dict[str, torch.Tensor], state: dict[str, Any],
                num_samples: torch.Tensor, num_updates: torch.Tensor,
                pass_id: torch.Tensor, now: Optional[torch.Tensor]) -> None:
        """The rule's new parameters and slots from the schedule at
        (num_samples, pass_id) and update count num_updates, written in
        place; where `now` is given, only where it holds."""
        opt = self.opt
        slots = state["slots"]
        masks = state.get("masks", {})
        base_lr = learning_rate_tensor(opt, num_samples, pass_id)
        step = StepCount(num_updates)
        lrs: dict[float, torch.Tensor] = {}     # by per-parameter multiplier
        dst, src = [], []
        for name, p in params.items():
            cfg = self.param_cfgs[name]
            if cfg.is_static or name not in grads:
                continue
            g = grads[name]
            mask = masks.get(name)
            if mask is not None:
                g = g * mask.to(g.dtype)
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
            if mask is not None:
                # decay and averaging must not bring a pruned weight back
                new_p = new_p * mask.to(new_p.dtype)
            dst.append(p)
            src.append(new_p)
            for k, v in new_slots.items():
                dst.append(slots[name][k])
                src.append(v)
        if now is not None:
            src = [torch.where(now, s, d) for d, s in zip(dst, src)]
        if dst:
            torch._foreach_copy_(dst, src)
        if self.use_average:
            self._average(params, state, now)

    def _average(self, params: dict[str, torch.Tensor],
                 state: dict[str, Any], now: Optional[torch.Tensor]) -> None:
        """The running mean of every parameter after this update, the
        window restarting from the current parameters once it would hold
        more than max_average_window updates; where `now` is given, only
        where it holds."""
        count = state["average_count"]
        cnt = count + 1
        max_win = self.opt.max_average_window or 0
        if max_win:
            reset = cnt > max_win
            cnt = torch.where(reset, torch.ones_like(cnt), cnt)
        dst, src = [], []
        for name, p in params.items():
            prev = state["average"][name]
            dst.append(prev)
            if max_win:
                prev = torch.where(reset, p, prev)
            src.append(prev + (p - prev) / cnt.to(p.dtype))
        if now is not None:
            src = [torch.where(now, s, d) for d, s in zip(dst, src)]
            cnt = torch.where(now, cnt, count)
        torch._foreach_copy_(dst, src)
        count.copy_(cnt)

    def averaged_params(self, params: dict[str, torch.Tensor],
                        state: dict[str, Any]) -> dict[str, torch.Tensor]:
        """The parameters to evaluate with: the averages under model
        averaging, else the parameters themselves."""
        return state["average"] if self.use_average else params

    def finish_pass(self, state: dict[str, Any]) -> dict[str, Any]:
        """The pass count moves on; a partial accumulation window is
        dropped (its batches would apply under the next pass's schedule),
        its sums zeroed in place."""
        state = dict(state, pass_id=state["pass_id"] + 1)
        if "grad_accum" in state:
            torch._foreach_zero_(list(state["grad_accum"].values()))
            state.update(grad_accum_count=0, grad_accum_samples=0)
        return state


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a and b name one device ('cuda' is the current CUDA device)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
