"""In-memory metric time-series: rolling windows for the health plane.

The port's copy of paddle_tpu/obs/timeseries.py (stdlib only).

The metrics registry (obs/metrics.py) answers "what is the value NOW";
the flight recorder answers "what happened around death".  This module
holds the in-between: a bounded, downsampled ring of samples per
catalogued metric series, fed by a background sampler that walks the
registry, so a p99 TTFT blowup, a spec accept-rate collapse, or a
prefix-hit-rate regression has a *history* that an operator
(`tools/obs_top.py`), the SLO evaluator (`obs/slo.py`), and postmortem
bundles can read back.

Storage model, per series key (the registry `snapshot()` flat-dict key
shape — `name` or `name{k="v",...}`):

  * gauges store the LAST value seen in each resolution window;
  * counters store the DELTA against the previous raw reading, clamped
    at >= 0 (a process restart resets to a fresh baseline, never a
    negative spike) — so rates come free: `value / resolution_s`;
  * histograms ride their `_sum`/`_count` samples as counter deltas
    (per-window mean = dsum/dcount); per-bucket series are skipped to
    bound cardinality, and latency *quantiles* already arrive as
    StatSet quantile GAUGES (`statset_collector`), which downsample
    like any other gauge.

Threading follows the metrics/trace discipline: `sample()` runs on a
background `HistorySampler` thread (or a test's manual clock) and reads
only lock-guarded / GIL-atomic registry state — it never round-trips
the pump.  `snapshot()`/`points()` run on the asyncio loop thread
answering the `history` RPC, so the RPC is stale-ok by construction and
answers against a wedged pump; the staleness is visible as
`last_sample_unix`.  Stdlib-only, like the rest of `obs/`.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Iterable, Optional

from paddle_tpu_torch.obs.metrics import _fmt_labels
from paddle_tpu_torch.obs.trace import process_info

#: distinct series keys the ring refuses past this point — a label
#: explosion must degrade accounting (obs_history_dropped_series_total),
#: never memory
MAX_SERIES = 4096


class MetricHistory:
    """Bounded downsampled ring per metric series."""

    def __init__(self, registry=None, resolution_s: float = 5.0,
                 retention_s: float = 1800.0,
                 max_series: int = MAX_SERIES):
        if resolution_s <= 0 or retention_s <= 0:
            raise ValueError("resolution_s and retention_s must be > 0")
        self.registry = registry
        self.resolution_s = float(resolution_s)
        self.retention_s = float(retention_s)
        #: ring slots per series = retention / resolution
        self.capacity = max(2, int(round(self.retention_s
                                         / self.resolution_s)))
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        # key -> {"kind": "counter"|"gauge",
        #         "ring": deque[(window_index, value)]}, oldest first
        self._series: dict[str, dict] = {}
        self._prev_raw: dict[str, float] = {}   # counters: last raw value
        self.samples_taken = 0
        self.dropped_series = 0
        self.first_sample_unix = 0.0
        self.last_sample_unix = 0.0

    # -- writing (sampler thread / test clock) ----------------------------
    def sample(self, now: Optional[float] = None, samples=None) -> None:
        """Take one downsampling pass.  `samples` overrides the registry
        walk with explicit (name, kind, labels|None, value) tuples
        (tests); `now` overrides the wall clock (deterministic window
        alignment)."""
        if samples is None:
            if self.registry is None:
                raise ValueError("no registry bound and no samples given")
            samples = self.registry.samples()
        now = time.time() if now is None else float(now)
        win = int(now // self.resolution_s)
        with self._lock:
            for name, kind, labels, value in samples:
                if kind == "histogram" and name.endswith("_bucket"):
                    continue                     # cardinality guard
                key = name + _fmt_labels(labels)
                as_counter = kind in ("counter", "histogram")
                ser = self._series.get(key)
                if ser is None:
                    if len(self._series) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    ser = self._series[key] = {
                        "kind": "counter" if as_counter else "gauge",
                        "ring": collections.deque(maxlen=self.capacity)}
                ring = ser["ring"]
                if as_counter:
                    # counters start at 0 in a fresh process, so the
                    # first reading IS the delta since process start
                    prev = self._prev_raw.get(key, 0.0)
                    delta = max(0.0, float(value) - prev)
                    self._prev_raw[key] = float(value)
                    if ring and ring[-1][0] == win:
                        ring[-1] = (win, ring[-1][1] + delta)
                    else:
                        ring.append((win, delta))
                else:
                    v = float(value)
                    if ring and ring[-1][0] == win:
                        ring[-1] = (win, v)
                    else:
                        ring.append((win, v))
            self.samples_taken += 1
            if self.first_sample_unix == 0.0:
                self.first_sample_unix = now
            self.last_sample_unix = now

    # -- reading (any thread; the history RPC's loop-thread path) ---------
    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def kind(self, key: str) -> Optional[str]:
        with self._lock:
            ser = self._series.get(key)
            return ser["kind"] if ser else None

    def points(self, key: str, last_s: Optional[float] = None,
               now: Optional[float] = None) -> list[tuple]:
        """[(window_start_unix, value)] oldest first, optionally limited
        to the trailing `last_s` seconds."""
        now = time.time() if now is None else float(now)
        with self._lock:
            ser = self._series.get(key)
            pts = list(ser["ring"]) if ser else []
        lo = None if last_s is None else \
            int((now - float(last_s)) // self.resolution_s)
        return [(w * self.resolution_s, v) for w, v in pts
                if lo is None or w >= lo]

    def snapshot(self, last_s: Optional[float] = None,
                 names: Optional[Iterable[str]] = None,
                 now: Optional[float] = None) -> dict:
        """The `history` frame body (and the bundle's history.json):
        top-level ring accounting plus {key: {"kind", "points"}} with
        points as [window_start_unix, value] pairs, oldest first.
        `names` filters series by key prefix; `last_s` trims each series
        to the trailing window."""
        now = time.time() if now is None else float(now)
        pref = tuple(names) if names else None
        with self._lock:
            items = [(k, s["kind"], list(s["ring"]))
                     for k, s in sorted(self._series.items())
                     if pref is None or k.startswith(pref)]
            taken = self.samples_taken
            first = self.first_sample_unix
            last = self.last_sample_unix
            dropped = self.dropped_series
        lo = None if last_s is None else \
            int((now - float(last_s)) // self.resolution_s)
        series = {}
        for k, kind, pts in items:
            out = [[w * self.resolution_s, float(f"{v:.6g}")]
                   for w, v in pts if lo is None or w >= lo]
            if out:
                series[k] = {"kind": kind, "points": out}
        return {"resolution_s": self.resolution_s,
                "retention_s": self.retention_s,
                "samples_taken": taken,
                "first_sample_unix": first,
                "last_sample_unix": last,
                "dropped_series": dropped,
                "series": series}


class HistorySampler:
    """Background thread: one `sample()` per period, plus an optional
    post-sample hook (the SLO evaluator rides it).  `enabled` is a live
    flip — bench_serving's overhead probe toggles it mid-run to price
    the sampler against the decode hot path.  A collector that raises
    must never kill the health plane: errors are counted and the thread
    keeps ticking."""

    def __init__(self, history: MetricHistory,
                 period_s: Optional[float] = None, on_sample=None):
        self.history = history
        self.period_s = float(period_s) if period_s \
            else history.resolution_s
        self.on_sample = on_sample
        self.enabled = True
        self.errors = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="history-sampler",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            if not self.enabled:
                continue
            try:
                self.history.sample()
                if self.on_sample is not None:
                    self.on_sample()
            except Exception as e:     # noqa: BLE001 — the health plane
                self.errors += 1       # must outlive collector bugs
                self.last_error = f"{type(e).__name__}: {e}"


def history_collector(history: MetricHistory):
    """obs.metrics collector: the ring's own accounting (which the
    sampler then records into the ring like any other series)."""

    def collect():
        age = -1.0 if history.last_sample_unix == 0.0 else \
            max(0.0, time.time() - history.last_sample_unix)
        return [
            ("obs_history_series", "gauge", None,
             float(history.series_count())),
            ("obs_history_samples_total", "counter", None,
             float(history.samples_taken)),
            ("obs_history_sample_age_s", "gauge", None, age),
            ("obs_history_dropped_series_total", "counter", None,
             float(history.dropped_series)),
        ]

    return collect


def history_reply(history: MetricHistory, msg: dict, role: str,
                  host=None, port=None, **ident) -> dict:
    """Answer a `history` RPC frame — mirrors obs.trace.trace_reply:
    runs on the asyncio loop thread, reads only lock-guarded ring state,
    and therefore answers while the pump is wedged (stale-ok by
    construction)."""
    proc = process_info(role, host, port)
    proc.update(ident)
    out = {"type": "history", "id": msg.get("id"), "process": proc}
    out.update(history.snapshot(last_s=msg.get("last_s"),
                                names=msg.get("names")))
    return out


# -- fleet aggregation (the router's per-replica merge) ---------------------

_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def relabel_series_key(key: str, extra: dict) -> str:
    """Inject labels into a snapshot()-shaped series key, preserving the
    sorted-label formatting of obs.metrics._fmt_labels — e.g.
    `a{x="1"}` + {replica: "r0"} -> `a{replica="r0",x="1"}`."""
    name, _, inner = key.partition("{")
    labels = {m.group(1): re.sub(r"\\(.)", r"\1", m.group(2))
              for m in _LABEL_RE.finditer(inner)}
    labels.update({k: str(v) for k, v in extra.items()})
    return name + _fmt_labels(labels)


def merge_history(parts, label: str = "replica") -> dict:
    """Merge per-process `history` bodies into one reply body, tagging
    each labeled part's series with `label="<value>"` — the history
    analog of the router's _merge_prometheus metrics merge (PR 13).
    `parts` is [(label_value_or_None, body_dict)]; the None part (the
    router's own series) passes through unlabeled and supplies the
    top-level ring accounting."""
    out: dict = {"series": {}, "replicas": []}
    for value, body in parts:
        if not body:
            continue
        if value is None:
            for k in ("resolution_s", "retention_s", "samples_taken",
                      "first_sample_unix", "last_sample_unix",
                      "dropped_series"):
                if k in body:
                    out[k] = body[k]
            out["series"].update(body.get("series", {}))
        else:
            out["replicas"].append(value)
            for k, s in body.get("series", {}).items():
                out["series"][relabel_series_key(k, {label: value})] = s
    out["replicas"].sort()
    return out
