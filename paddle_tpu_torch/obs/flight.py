"""Flight recorder: a bounded structured-event ring and atomic postmortem
bundles — the port's copy of paddle_tpu/obs/flight.py (stdlib only; the
event kinds, the bundle layout and `load_bundle` are the reference's).

The ring holds the engine's state transitions (queued, admit, prefix hits
and misses, chunk scheduling, preemption, spills and restores, page
imports, window flushes, draft passes, speculation outcomes, finish) and
compile events — per request, per compile, never per token.  `dump()`
freezes it with whatever else an operator needs into one directory:

    <dir>/postmortem-<utc-ts>-<pid>/
        meta.json      reason, timestamps, pid/host, component versions
        events.jsonl   the flight-recorder ring, oldest first
        spans.jsonl    the span tracer's retained ring (obs/trace.py shape)
        engine.json    serving snapshot: slots, page occupancy, queued ids
        metrics.json   flat registry snapshot (obs/metrics.py shape)
        config.json    the serving configuration

The directory is staged under a `.tmp` suffix and committed with one
`os.replace`, so a crash mid-dump leaves a visible `.tmp` straggler,
never a half-readable bundle.  `record` takes a lock (events may come
from more than one thread); `dump()` may run on any thread.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from typing import Optional

#: bundle directory prefix — tests and tools key off it
BUNDLE_PREFIX = "postmortem-"

#: files every bundle carries (engine/config may hold {} for non-serving
#: dumps, but the file is always present so readers never stat-and-branch)
BUNDLE_FILES = ("meta.json", "events.jsonl", "spans.jsonl", "engine.json",
                "metrics.json", "config.json")


class FlightRecorder:
    """Bounded ring of structured events; off until `enabled` is set."""

    def __init__(self, capacity: int = 2048):
        self.capacity = int(capacity)
        assert self.capacity > 0
        self.enabled = False
        self._lock = threading.Lock()
        self._dump_lock = threading.Lock()   # serializes whole bundles
        self._ring: list = []          # grows to capacity, then wraps
        self._n = 0                    # events ever recorded (monotonic)
        self.bundles_written = 0
        self.last_bundle_path: Optional[str] = None

    # -- recording (any thread) -------------------------------------------
    def record(self, kind: str, **data) -> None:
        """Append one event.  `data` must be JSON-serializable; keep it
        small (ids and counts, not payloads)."""
        if not self.enabled:
            return
        with self._lock:
            rec = (self._n, time.time(), kind, data or None)
            if len(self._ring) < self.capacity:
                self._ring.append(rec)
            else:
                self._ring[self._n % self.capacity] = rec
            self._n += 1

    # -- reading -----------------------------------------------------------
    @property
    def recorded(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._n = 0

    def snapshot(self) -> list[dict]:
        """Retained events, oldest first, as dicts (the events.jsonl
        record shape)."""
        with self._lock:
            recs = sorted(self._ring)
        return [{"seq": r[0], "ts": r[1], "kind": r[2],
                 **({"data": r[3]} if r[3] else {})} for r in recs]

    # -- the postmortem bundle --------------------------------------------
    def dump(self, out_dir: str, reason: str, *, spans=None, engine=None,
             metrics=None, config=None, history=None,
             error: Optional[str] = None) -> str:
        """Write one atomic postmortem bundle under `out_dir`; returns the
        committed bundle path.  Never raises into a dying caller's frame
        for snapshot problems — a part that fails to serialize is replaced
        by an {"snapshot_error": ...} stub (the bundle must outlive the
        bug it documents); only out_dir-level I/O errors propagate.

        Serialized: concurrent dumps (a pump-death dump racing an
        operator `dump` RPC from the loop thread) each commit their OWN
        complete bundle instead of interleaving writes into a shared
        same-second staging dir."""
        with self._dump_lock:
            return self._dump_locked(out_dir, reason, spans=spans,
                                     engine=engine, metrics=metrics,
                                     config=config, history=history,
                                     error=error)

    def _dump_locked(self, out_dir: str, reason: str, *, spans=None,
                     engine=None, metrics=None, config=None, history=None,
                     error: Optional[str] = None) -> str:
        ts = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        base = os.path.join(out_dir, f"{BUNDLE_PREFIX}{ts}-{os.getpid()}")
        final = base
        n = 0
        # same-second re-dump: probe the .tmp path too, so a straggler
        # from a crashed earlier dump is never reused as our staging dir
        while os.path.exists(final) or os.path.exists(final + ".tmp"):
            n += 1
            final = f"{base}.{n}"
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)

        def _write_json(name, obj):
            with open(os.path.join(tmp, name), "w") as f:
                try:
                    json.dump(obj, f, indent=2, default=str)
                except (TypeError, ValueError) as e:
                    f.seek(0)
                    f.truncate()
                    json.dump({"snapshot_error": f"{type(e).__name__}: {e}"},
                              f)

        def _write_jsonl(name, records):
            with open(os.path.join(tmp, name), "w") as f:
                for rec in records:
                    try:
                        f.write(json.dumps(rec, separators=(",", ":"),
                                           default=str) + "\n")
                    except (TypeError, ValueError):
                        continue

        meta = {
            "reason": reason,
            "ts": time.time(),
            "ts_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "events_recorded": self.recorded,
            "events_dropped": self.dropped,
            "versions": _versions(),
        }
        if error:
            meta["error"] = error
        _write_json("meta.json", meta)
        _write_jsonl("events.jsonl", self.snapshot())
        _write_jsonl("spans.jsonl", _safe(lambda: spans or [], []))
        _write_json("engine.json", _safe(lambda: engine or {}, {}))
        _write_json("metrics.json", _safe(lambda: metrics or {}, {}))
        _write_json("config.json", _safe(lambda: config or {}, {}))
        # the health plane's trailing window — written by every dump but
        # not in BUNDLE_FILES, so bundles without it stay loadable
        _write_json("history.json", _safe(lambda: history or {}, {}))
        os.replace(tmp, final)             # commit: rename is the txn
        self.bundles_written += 1
        self.last_bundle_path = final
        return final


def _safe(fn, fallback):
    try:
        return fn()
    except Exception as e:                 # noqa: BLE001 — see dump()
        return {"snapshot_error": f"{type(e).__name__}: {e}"} \
            if isinstance(fallback, dict) else fallback


def _versions() -> dict:
    """Python, torch, the CUDA torch was built for, and numpy."""
    out = {"python": sys.version.split()[0]}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = __import__(mod).__version__
        except Exception:                  # noqa: BLE001 — absent is fine
            pass
    try:
        import torch
        out["cuda"] = torch.version.cuda
    except Exception:                      # noqa: BLE001
        pass
    return out


def load_bundle(path: str) -> dict:
    """Read a committed bundle back: {"path", "meta", "events", "spans",
    "engine", "metrics", "config"}.  Raises ValueError on a directory that
    is not a complete bundle (e.g. a crashed dump's `.tmp` straggler)."""
    if not os.path.isdir(path):
        raise ValueError(f"{path}: not a bundle directory")
    missing = [f for f in BUNDLE_FILES
               if not os.path.exists(os.path.join(path, f))]
    if missing:
        raise ValueError(f"{path}: incomplete bundle, missing {missing} "
                         f"(a .tmp straggler from a crashed dump?)")
    out = {"path": path}
    for name in ("meta", "engine", "metrics", "config"):
        with open(os.path.join(path, name + ".json")) as f:
            out[name] = json.load(f)
    for name in ("events", "spans"):
        recs = []
        with open(os.path.join(path, name + ".jsonl")) as f:
            for line in f:
                line = line.strip()
                if line:
                    recs.append(json.loads(line))
        out[name] = recs
    # optional part: the history ring snapshot (readers branch on the
    # key, never fail the load)
    hpath = os.path.join(path, "history.json")
    if os.path.exists(hpath):
        with open(hpath) as f:
            out["history"] = json.load(f)
    return out


def flight_collector(recorder: "FlightRecorder"):
    """obs.metrics collector: ring accounting + bundles written."""

    def collect():
        return [
            ("flight_events_recorded_total", "counter", None,
             float(recorder.recorded)),
            ("flight_events_dropped_total", "counter", None,
             float(recorder.dropped)),
            ("postmortem_bundles_total", "counter", None,
             float(recorder.bundles_written)),
        ]

    return collect


#: the process-global recorder the serving engine and the compile watch
#: record into.  Off until something (a test, a tool) flips `.enabled`.
_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _recorder
