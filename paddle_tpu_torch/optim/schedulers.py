"""Learning-rate schedules — the port's copy of
paddle_tpu/optim/schedulers.py: constant, poly, caffe_poly, exp, discexp,
linear, manual, pass_manual, by the number of processed samples (or the
pass id for pass_manual).  The arithmetic is float32, as on the JAX side;
the result is a Python float.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.config.schema import OptimizationConfig

_F = np.float32


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
            out = lr * np.power(_F(1.0) + a * x, -b)
        elif sched == "caffe_poly":
            out = lr * np.power(np.maximum(_F(1.0) - x / a, _F(0.0)), b)
        elif sched == "exp":
            out = lr * np.power(a, x / b)
        elif sched == "discexp":
            out = lr * np.power(a, np.floor(x / b))
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
