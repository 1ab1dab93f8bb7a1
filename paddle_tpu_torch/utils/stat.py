"""Timers and stat accumulation — the port's copy of
paddle_tpu/utils/stat.py (stdlib only).

Named accumulating timers (the reference's REGISTER_TIMER / StatSet,
paddle/utils/Stat.h:130-256) and bounded sample windows whose
percentiles the serving front end's stats RPC and metrics frame report
(`statset_collector` in obs/metrics.py).  Timers wrap host phases; the
card's own time comes from the profiler.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


#: bounded per-stat sample window for percentile queries — old samples are
#: overwritten ring-buffer style, so a long-lived server's stats RPC reports
#: RECENT latency percentiles at O(1) memory per stat
SAMPLE_WINDOW = 4096


def _quantile(snap: list, q: float) -> float:
    """Linear-interpolated quantile of an already-SORTED list (numpy
    percentile semantics); 0.0 when empty."""
    if not snap:
        return 0.0
    pos = (len(snap) - 1) * min(max(q, 0.0), 100.0) / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(snap) - 1)
    return snap[lo] + (snap[hi] - snap[lo]) * (pos - lo)


@dataclass
class Stat:
    name: str
    total_s: float = 0.0
    count: int = 0
    max_s: float = 0.0
    samples: list = field(default_factory=list)   # last SAMPLE_WINDOW dts
    # add() runs on the owning hot thread (serving pump, trainer loop)
    # while percentiles()/snapshots run on others (the asyncio stats
    # thread, the metrics render) — the lock makes the multi-field update
    # and the window copy atomic, instead of relying on GIL interleaving
    # (a ring overwrite racing a sort could pair count with a half-updated
    # window).  Uncontended acquire is ~100ns; these record host phases
    # measured in microseconds to milliseconds.
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def add(self, dt: float) -> None:
        with self.lock:
            if len(self.samples) < SAMPLE_WINDOW:
                self.samples.append(dt)
            else:
                self.samples[self.count % SAMPLE_WINDOW] = dt
            self.total_s += dt
            self.count += 1
            if dt > self.max_s:
                self.max_s = dt

    def reset(self) -> None:
        with self.lock:
            self.total_s = 0.0
            self.count = 0
            self.max_s = 0.0
            self.samples = []

    def window(self) -> list:
        """Consistent copy of the sample window."""
        with self.lock:
            return list(self.samples)

    def __str__(self) -> str:
        avg = self.total_s / max(self.count, 1)
        return (f"{self.name}: total={self.total_s * 1e3:.1f}ms "
                f"count={self.count} avg={avg * 1e3:.3f}ms "
                f"max={self.max_s * 1e3:.3f}ms")


@dataclass
class StatSet:
    """Named stat registry (ref: StatSet globalStat, Stat.h:94-128)."""

    name: str = "global"
    stats: dict[str, Stat] = field(default_factory=dict)
    # guards stat CREATION only — two threads get()ing a new name must not
    # both insert (the loser's Stat, and any samples it took, would vanish)
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def get(self, name: str) -> Stat:
        s = self.stats.get(name)
        if s is None:
            with self.lock:
                s = self.stats.setdefault(name, Stat(name))
        return s

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.get(name).add(time.perf_counter() - t0)

    def percentiles(self, name: str, qs=(50.0, 99.0)) -> dict[str, float]:
        """{"p50": ..., "p99": ...} in SECONDS for stat `name` (0.0s when
        the stat never recorded) — the serving stats RPC's building block.
        Copies the window under the stat's lock (add() runs on another
        thread — the serving pump), then sorts ONCE for all requested
        quantiles."""
        s = self.stats.get(name)
        snap = sorted(s.window()) if s else []
        return {f"p{q:g}": _quantile(snap, q) for q in qs}

    def print_all(self, log=None) -> str:
        lines = ["======= StatSet: [%s] =======" % self.name]
        for s in sorted(self.stats.values(), key=lambda s: -s.total_s):
            lines.append("  " + str(s))
        text = "\n".join(lines)
        if log is not None:
            log.info(text)
        return text

    def reset(self) -> None:
        for s in self.stats.values():
            s.reset()


global_stat = StatSet()


def timer(name: str):
    """``with timer("forwardBackward"): ...`` accumulates into global_stat."""
    return global_stat.time(name)
