"""Learning-rate schedules — the port's copy of
paddle_tpu/optim/schedulers.py: constant, poly, caffe_poly, exp, discexp,
linear, manual, pass_manual, by the number of processed samples (or the
pass id for pass_manual).  The arithmetic is float32, as on the JAX side.
`learning_rate_at` reads host counters and returns a Python float;
`learning_rate_tensor` is the same schedule on device counters, a 0-d
float32 tensor computed without a host read (the updater's form, which a
CUDA graph of the training step can hold).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.config.schema import OptimizationConfig

_F = np.float32


def _pow32(base, exp) -> np.float32:
    """base ** exp for float32 operands, taken in float64 and rounded once
    to float32 (numpy's own float32 power is a vectorised approximation
    whose last bit depends on the CPU)."""
    return _F(np.power(np.float64(base), np.float64(exp)))


def _parse_segments(args: str) -> list[tuple[float, float]]:
    """'seg0:lr0,seg1:lr1,...'."""
    segs = []
    for part in args.split(","):
        if not part:
            continue
        a, _, b = part.partition(":")
        segs.append((float(a), float(b)))
    return segs


def learning_rate_at(opt: OptimizationConfig, num_samples: int,
                     pass_id: int = 0) -> float:
    """The global learning rate at this point of training."""
    lr, a, b = (_F(opt.learning_rate), _F(opt.learning_rate_decay_a),
                _F(opt.learning_rate_decay_b))
    x = _F(num_samples)
    sched = opt.learning_rate_schedule
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if sched == "constant":
            out = lr
        elif sched == "poly":
            out = lr * _pow32(_F(1.0) + a * x, -b)
        elif sched == "caffe_poly":
            out = lr * _pow32(np.maximum(_F(1.0) - x / a, _F(0.0)), b)
        elif sched == "exp":
            out = lr * _pow32(a, x / b)
        elif sched == "discexp":
            out = lr * _pow32(a, np.floor(x / b))
        elif sched == "linear":
            out = np.maximum(lr - a * x, b)
        elif sched in ("manual", "pass_manual"):
            segs = _parse_segments(opt.learning_rate_args)
            pos = _F(pass_id if sched == "pass_manual" else num_samples)
            rate = _F(segs[-1][1] if segs else 1.0)
            # the first segment whose boundary covers pos
            for bound, r in reversed(segs[:-1] if segs else []):
                if pos <= _F(bound):
                    rate = _F(r)
            out = lr * rate
        else:
            raise ValueError(f"unknown learning_rate_schedule {sched!r}")
    return float(_F(out))


def learning_rate_tensor(opt: OptimizationConfig, num_samples: torch.Tensor,
                         pass_id: torch.Tensor) -> torch.Tensor:
    """learning_rate_at on 0-d device counters: a 0-d float32 tensor on
    their device, each operation the host form's in float32 and a power,
    as there, in float64 rounded once to float32."""
    f32 = torch.float32

    def pow32(base, exp) -> torch.Tensor:
        if not isinstance(base, torch.Tensor):
            base = torch.full((), base, dtype=f32, device=x.device)
        if isinstance(exp, torch.Tensor):
            exp = exp.double()
        return torch.pow(base.double(), exp).to(f32)

    lr, a, b = (float(_F(opt.learning_rate)),
                float(_F(opt.learning_rate_decay_a)),
                float(_F(opt.learning_rate_decay_b)))
    x = num_samples.to(f32)
    sched = opt.learning_rate_schedule

    def const(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=f32, device=x.device)

    if sched == "constant":
        return const(lr)
    if sched == "poly":
        return lr * pow32(1.0 + a * x, -b)
    if sched == "caffe_poly":
        return lr * pow32(torch.clamp_min(1.0 - x / a, 0.0), b)
    if sched == "exp":
        return lr * pow32(a, x / b)
    if sched == "discexp":
        return lr * pow32(a, torch.floor(x / b))
    if sched == "linear":
        return torch.clamp_min(lr - a * x, b)
    if sched in ("manual", "pass_manual"):
        segs = _parse_segments(opt.learning_rate_args)
        pos = (pass_id if sched == "pass_manual" else num_samples).to(f32)
        rate = const(float(_F(segs[-1][1] if segs else 1.0)))
        for bound, r in reversed(segs[:-1] if segs else []):
            rate = torch.where(pos <= float(_F(bound)), float(_F(r)), rate)
        return lr * rate
    raise ValueError(f"unknown learning_rate_schedule {sched!r}")
