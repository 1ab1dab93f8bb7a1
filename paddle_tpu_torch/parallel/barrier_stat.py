"""Per-step dispatch and sync timing windows — the port's copy of the
single-process part of paddle_tpu/parallel/barrier_stat.py (ref:
paddle/utils/BarrierStat.h BarrierStatBase / BarrierEndStat).

The trainer times, on the host:

- **dispatch**: one eager training step's launches;
- **sync**: one read of the buffered losses (the host waits there for the
  device to finish the steps it queued);
- **h2d**: one fused group's host-to-device staging (on the staging
  thread, beside the dispatch);
- **scan**: one fused group's dispatch (a CUDA-graph replay on the card).

A `BarrierTimer` keeps rolling windows of each and renders their
percentiles in one line; with a tracer attached and enabled every window
is also a span.  The reference also gathers each process's mean step time
across processes to name the straggler; the port's multi-process tiers are
not ported yet (ROADMAP.md, Queue 1 item 9), and `straggler_summary`
raises when more than one process is running rather than report one
process as the whole.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np


def _pct(xs, unit_scale: float = 1e3) -> dict[str, float]:
    a = np.asarray(xs, np.float64) * unit_scale
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max())}


def _fmt_pct(name: str, p: dict[str, float]) -> str:
    return (f"{name} p50={p['p50']:.2f}ms p95={p['p95']:.2f}ms "
            f"p99={p['p99']:.2f}ms max={p['max']:.2f}ms")


class BarrierTimer:
    """Rolling per-step timing windows, in seconds; `local_summary` gives
    their percentiles in ms."""

    def __init__(self, window: int = 500, tracer=None,
                 track: str = "trainer"):
        self.tracer = tracer
        self.track = track
        self.dispatch_s: deque[float] = deque(maxlen=window)
        self.sync_s: deque[float] = deque(maxlen=window)
        self.h2d_s: deque[float] = deque(maxlen=window)
        self.scan_s: deque[float] = deque(maxlen=window)

    def time_dispatch(self):
        """Context manager timing one step's dispatch."""
        return _Timed(self.dispatch_s, self.tracer, "dispatch", self.track)

    def time_sync(self):
        """Context manager timing one read of the device's losses."""
        return _Timed(self.sync_s, self.tracer, "sync", self.track)

    def time_h2d(self):
        """Context manager timing one group's staging (its own track: it
        runs on the staging thread, beside the dispatch)."""
        return _Timed(self.h2d_s, self.tracer, "h2d", self.track + ":h2d")

    def time_scan(self):
        """Context manager timing one fused group's dispatch."""
        return _Timed(self.scan_s, self.tracer, "scan", self.track)

    def local_summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in (("dispatch", self.dispatch_s),
                         ("sync", self.sync_s), ("h2d", self.h2d_s),
                         ("scan", self.scan_s)):
            if xs:
                out[name] = _pct(xs)
        return out

    def straggler_summary(self) -> Optional[dict[str, float]]:
        """None in a single process.  The cross-process table is not ported
        yet: with more than one process it raises."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                "the cross-process straggler table of the barrier timer is "
                "not ported yet (ROADMAP.md, Queue 1 item 9)")
        return None

    def render(self) -> str:
        """One log line of the windows' percentiles."""
        parts = [_fmt_pct(k, v) for k, v in self.local_summary().items()]
        self.straggler_summary()
        return "; ".join(parts) if parts else "no samples"


class _Timed:
    def __init__(self, sink: deque, tracer=None, name: str = "",
                 track: str = "trainer"):
        self.sink = sink
        self.tracer = tracer
        self.name = name
        self.track = track

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.sink.append(dt)
        t = self.tracer
        if t is not None and t.enabled:
            t.add(self.name, self.t0, dt, track=self.track)
        return False
