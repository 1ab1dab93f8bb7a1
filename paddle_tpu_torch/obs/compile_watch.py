"""Compile observability: per-signature compile events and the
recompile-storm detector — the port's copy of
paddle_tpu/obs/compile_watch.py (stdlib only; the site names, the
`compile` tracer lane, the flight events and the collector's metric names
are the reference's).

The reference counts a compile when a jitted function's cache grows.  The
port has no jit cache: its steps run eagerly, or replay CUDA graphs.  So
a COMPILE EVENT here is the first call at a site with a signature the site
has not seen — `signature_of` over the call's tensors and static ints, the
key XLA compiles by — and every CUDA graph captured at a site (a capture
records under the signature it was captured at, so it adds a compile and
no signature).  A site's signature count is then what the reference's
would be for the same shapes: one decode step, one mixed step per token
budget, one window per k, one prefill per bucket, one restore scatter per
power-of-two page count.

  * `watch(site, key)` — context manager: the first call with a new `key`
    records an event timed over the whole call (the first run's wall
    time: for the port, eager launches or a capture);
  * `observe(site, *tensors)` — `watch(site, signature_of(tensors))`;
  * the STORM DETECTOR: >= `storm_n` distinct signatures for one site
    inside `storm_window_s` seconds fires once — a `recompile_storm`
    instant on the compile lane, a flight event, and
    `jit_recompile_storms_total` — then stays quiet until the window
    drains.

A process-global singleton (`get_compile_watch()`), always on: events are
rare.  The steady-state cost is one signature string and one set lookup
per watched call.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque

from paddle_tpu_torch.obs.flight import get_flight_recorder
from paddle_tpu_torch.obs.trace import get_tracer


def _dtype_name(dtype) -> str:
    """A dtype as the reference's signatures spell it: numpy's name, and a
    torch dtype without its `torch.` prefix (torch.bfloat16 -> bfloat16),
    so a tensor and a same-shaped JAX array describe alike."""
    return str(dtype).replace("torch.", "")


def signature_of(args: tuple, kwargs: dict) -> str:
    """A stable short signature for a call's shapes: walks the arguments
    duck-typed, describing array-like leaves as dtype[shape] and scalars by
    repr.  A long one hashes down to a digest so it stays log-line
    sized."""
    parts: list[str] = []

    def walk(x):
        if isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            parts.append(f"{_dtype_name(x.dtype)}"
                         f"[{','.join(map(str, x.shape))}]")
        elif isinstance(x, (bool, int, float, str)) or x is None:
            parts.append(repr(x))
        else:
            parts.append(type(x).__name__)

    walk(args)
    walk(kwargs)
    full = ";".join(parts)
    if len(full) <= 96:
        return full
    digest = hashlib.md5(full.encode()).hexdigest()[:10]
    return f"{len(parts)} leaves:{digest}:{full[:64]}…"


class _Watch:
    """Context manager for watch(): records on exit iff the key was new."""

    __slots__ = ("cw", "site", "key", "t0")

    def __init__(self, cw, site, key):
        self.cw = cw
        self.site = site
        self.key = key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None and self.key is not None:
            self.cw.note(self.site, self.key,
                         time.perf_counter() - self.t0, t0=self.t0)
        return False


class CompileWatch:
    """Per-site compile accounting + the recompile-storm detector."""

    def __init__(self, storm_n: int = 6, storm_window_s: float = 60.0):
        self.storm_n = int(storm_n)
        self.storm_window_s = float(storm_window_s)
        self._lock = threading.Lock()
        self.compiles: dict[str, int] = {}        # site -> compile count
        self.seconds: dict[str, float] = {}       # site -> wall seconds
        self.storms: dict[str, int] = {}          # site -> storms fired
        self._sigs: dict[str, set] = {}           # site -> distinct sigs
        self._recent: dict[str, deque] = {}       # site -> (t, sig) window
        self._armed: dict[str, bool] = {}         # storm re-arm per site

    def clear(self) -> None:
        with self._lock:
            self.compiles.clear()
            self.seconds.clear()
            self.storms.clear()
            self._sigs.clear()
            self._recent.clear()
            self._armed.clear()

    # -- instrumentation entry points --------------------------------------
    def watch(self, site: str, key) -> _Watch:
        """``with cw.watch("lm_decode.generate", (B, P, max_new)): ...`` —
        records a compile event on exit if `key` is new for the site."""
        with self._lock:
            known = key in self._sigs.get(site, ())
        return _Watch(self, site, None if known else key)

    def observe(self, site: str, *parts) -> _Watch:
        """watch() keyed on signature_of(parts): the call's tensors and
        the static ints its shape depends on."""
        return self.watch(site, signature_of(parts, {}))

    def note(self, site: str, key, seconds: float, t0: float = 0.0) -> None:
        """Record a first-call-for-key event unless the key raced in."""
        with self._lock:
            if key in self._sigs.get(site, ()):
                return
        self.record(site, str(key), seconds, t0=t0, raw_key=key)

    # -- the event ---------------------------------------------------------
    def record(self, site: str, sig: str, seconds: float,
               t0: float = 0.0, raw_key=None) -> None:
        """One compile happened at `site` with signature `sig`, costing
        `seconds` of wall time (a first run or a graph capture)."""
        now = time.perf_counter()
        storm = None
        key = raw_key if raw_key is not None else sig
        with self._lock:
            self.compiles[site] = self.compiles.get(site, 0) + 1
            self.seconds[site] = self.seconds.get(site, 0.0) + seconds
            self._sigs.setdefault(site, set()).add(key)
            dq = self._recent.setdefault(site, deque())
            while dq and dq[0][0] < now - self.storm_window_s:
                dq.popleft()
            if not dq:
                self._armed[site] = True   # window drained: re-arm
            dq.append((now, key))
            distinct = len({s for _, s in dq})
            if distinct >= self.storm_n and self._armed.get(site, True):
                self._armed[site] = False
                self.storms[site] = self.storms.get(site, 0) + 1
                storm = distinct
        tracer = get_tracer()
        if tracer.enabled:
            tracer.add(site, t0 or (now - seconds), seconds,
                       track="compile", attrs={"sig": sig})
        flight = get_flight_recorder()
        flight.record("compile", site=site, sig=sig,
                      seconds=round(seconds, 4))
        if storm is not None:
            if tracer.enabled:
                tracer.instant("recompile_storm", track="compile",
                               site=site, signatures=storm,
                               window_s=self.storm_window_s)
            flight.record("recompile_storm", site=site,
                          signatures=storm,
                          window_s=self.storm_window_s)

    # -- reading -----------------------------------------------------------
    def signature_count(self, site: str) -> int:
        with self._lock:
            return len(self._sigs.get(site, ()))

    def snapshot(self) -> dict:
        """{site: {"compiles", "seconds", "signatures", "storms"}} — the
        postmortem-bundle shape."""
        with self._lock:
            sites = set(self.compiles) | set(self._sigs)
            return {site: {
                "compiles": self.compiles.get(site, 0),
                "seconds": round(self.seconds.get(site, 0.0), 4),
                "signatures": len(self._sigs.get(site, ())),
                "storms": self.storms.get(site, 0),
            } for site in sorted(sites)}


def compile_collector(cw: "CompileWatch" = None):
    """obs.metrics collector: per-site compile counters + signature
    gauges."""

    def collect():
        w = cw or _watch
        out = []
        for site, st in w.snapshot().items():
            labels = {"site": site}
            out.append(("jit_compiles_total", "counter", labels,
                        float(st["compiles"])))
            out.append(("jit_compile_seconds", "counter", labels,
                        float(st["seconds"])))
            out.append(("jit_signatures", "gauge", labels,
                        float(st["signatures"])))
            out.append(("jit_recompile_storms_total", "counter", labels,
                        float(st["storms"])))
        return out

    return collect


#: process-global watcher every instrumented site records into (the
#: serving steps, prefills, page copies and restores, the draft rollout,
#: lm_generate)
_watch = CompileWatch()


def get_compile_watch() -> CompileWatch:
    return _watch
