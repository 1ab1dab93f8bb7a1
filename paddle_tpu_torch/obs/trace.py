"""Span tracer: request-lifecycle spans in a bounded ring — the port's
copy of paddle_tpu/obs/trace.py (stdlib only; the names and the export
shapes are the reference's, so a trace from either package loads in the
same viewer and `tools/trace_dump.py`).

  1. **Off means off.**  `tracer.enabled` is False by default and every
     recording entry point checks it first, so a disabled tracer costs
     one attribute read per call site.  The serving engine reads no
     tensor and synchronizes nothing for a span: spans time host clocks.
  2. **Single-writer ring.**  Spans are appended by the thread that owns
     the instrumented state (the thread driving ServingEngine.step());
     `snapshot()` may run on another thread and restores order from each
     record's monotonic `seq`.
  3. **Two export shapes.**  JSONL (one span per line) and Chrome
     `trace_event` JSON (Perfetto / chrome://tracing).

A span is (seq, name, track, ts, dur, attrs).  `track` is the viewer's
lane: one per request (`req:<id>`), one for the engine (`engine`), one
for compile events (`compile`).  `instant=True` marks a zero-length
event (preempt, done).  Times are `time.perf_counter()` seconds; the
exports convert to microseconds.  A request that crossed processes
carries `trace_id` / `parent` as span attrs, and `merge_chrome` stitches
span sets of several processes into one trace, each with its clock
offset.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
from typing import Optional


def new_trace_id() -> str:
    """One id per cross-process request — 16 hex chars, collision-safe at
    fleet request rates (os.urandom, no seeding to leak)."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """Parent-pointer currency for cross-process span stitching."""
    return os.urandom(4).hex()


def process_info(role: str, host: Optional[str] = None,
                 port: Optional[int] = None) -> dict:
    """The process-identity stamp a `trace` RPC reply (and a --trace-out
    file's meta line) carries, so a merged trace can name its tracks:
    role (replica/router/...), pid, hostname, and the bind address."""
    out = {"role": role, "pid": os.getpid(),
           "hostname": socket.gethostname()}
    if host is not None:
        out["addr"] = f"{host}:{port}"
    return out


def trace_reply(tracer: "Tracer", msg: dict, role: str,
                host: Optional[str] = None, port: Optional[int] = None,
                **ident) -> dict:
    """The reply of a `trace` request (the reference's RPC frame, field
    for field, so `tools/trace_dump.py --pull` reads either).  Applies a
    live `enable` flip BEFORE the snapshot (so enable:false returns the
    spans it just froze), stamps process
    identity (extra keyword fields like shard= ride along) plus a
    perf_counter/unix clock sample for ping-RTT alignment, and ships
    the retained ring with its accounting."""
    if isinstance(msg.get("enable"), bool):
        tracer.enabled = msg["enable"]
    proc = process_info(role, host, port)
    proc.update(ident)
    return {"type": "trace", "id": msg.get("id"),
            "process": proc,
            "clock": {"perf_counter": time.perf_counter(),
                      "unix": time.time()},
            "enabled": tracer.enabled,
            "recorded": tracer.recorded,
            "dropped": tracer.dropped,
            "spans": tracer.snapshot()}


def flush_trace_file(tracer: "Tracer", path: str, role: str,
                     host: Optional[str] = None,
                     port: Optional[int] = None, **ident) -> int:
    """Write `tracer`'s retained ring to `path` as JSONL with the
    leading `{"meta": {"process": ...}}` identity line, and note the
    count on stderr.  Extra
    keyword fields (rank=, shard=) ride in the identity record so
    trace_dump --merge can name the track."""
    proc = process_info(role, host, port)
    proc.update(ident)
    n = tracer.export_jsonl(path, meta={"process": proc})
    print(f"wrote {n} spans to {path} ({tracer.dropped} dropped by "
          f"ring wrap); stitch with tools/trace_dump.py --merge",
          file=sys.stderr, flush=True)
    return n


class _NullSpan:
    """Shared no-op context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """Context manager recording one complete span on exit."""

    __slots__ = ("tracer", "name", "track", "attrs", "t0")

    def __init__(self, tracer, name, track, attrs):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer.add(self.name, self.t0,
                        time.perf_counter() - self.t0,
                        track=self.track, attrs=self.attrs)
        return False


class Tracer:
    """Bounded-ring span recorder.  One writer thread; see module note."""

    def __init__(self, capacity: int = 16384):
        self.capacity = int(capacity)
        assert self.capacity > 0
        self.enabled = False
        self._ring: list = []          # grows to capacity, then wraps
        self._n = 0                    # spans ever recorded (monotonic)

    # -- recording (owner thread) -----------------------------------------
    def add(self, name: str, ts: float, dur: float, track: str = "main",
            attrs: Optional[dict] = None, instant: bool = False) -> None:
        """Record one completed span (ts/dur in perf_counter seconds).

        Single-writer (the thread driving the engine).  An occasional add
        from another thread is GIL-safe — list ops never tear — but a
        racing pair may overwrite one span; tracing tolerates a lost
        sample, so no lock is paid on the per-step path."""
        if not self.enabled:
            return
        rec = (self._n, name, track, ts, dur, attrs,
               True if instant else False)
        if len(self._ring) < self.capacity:
            self._ring.append(rec)
        else:
            self._ring[self._n % self.capacity] = rec
        self._n += 1

    def span(self, name: str, track: str = "main", **attrs):
        """``with tracer.span("prefill", bucket=32): ...`` — records on
        exit; a shared no-op object when disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, track, attrs or None)

    def begin(self, name: str, track: str = "main", **attrs):
        """Open a span that a LATER call (possibly in another method)
        closes via end().  Returns an opaque handle; None when disabled —
        end(None) is a no-op, so call sites never branch."""
        if not self.enabled:
            return None
        return [name, track, time.perf_counter(), attrs or None]

    def end(self, handle, **extra_attrs) -> None:
        if handle is None:
            return
        name, track, t0, attrs = handle
        if extra_attrs:
            attrs = dict(attrs or (), **extra_attrs)
        self.add(name, t0, time.perf_counter() - t0, track=track,
                 attrs=attrs)

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        """Zero-duration marker (preempt, done, cancelled)."""
        if not self.enabled:
            return
        self.add(name, time.perf_counter(), 0.0, track=track,
                 attrs=attrs or None, instant=True)

    # -- reading / export (any thread) ------------------------------------
    @property
    def recorded(self) -> int:
        """Spans ever recorded (monotonic, includes overwritten)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wrap-around."""
        return max(0, self._n - self.capacity)

    def clear(self) -> None:
        self._ring = []
        self._n = 0

    def snapshot(self) -> list[dict]:
        """Retained spans, oldest first, as dicts — the JSONL record
        shape.  Copies under the GIL; safe concurrent with recording
        (a span landing mid-copy may or may not appear, never torn)."""
        recs = sorted(list(self._ring))          # seq-first tuples
        return [{"seq": r[0], "name": r[1], "track": r[2],
                 "ts": r[3], "dur": r[4],
                 **({"attrs": r[5]} if r[5] else {}),
                 **({"instant": True} if r[6] else {})}
                for r in recs]

    def export_jsonl(self, path: str, meta: Optional[dict] = None) -> int:
        """Write retained spans as JSON-lines; returns the span count.
        `meta` (e.g. {"process": process_info(...)}) prepends one
        identity record — tools/trace_dump.py skips it when summarizing
        and uses it to label the process track when merging."""
        spans = self.snapshot()
        with open(path, "w") as f:
            if meta:
                f.write(json.dumps({"meta": meta},
                                   separators=(",", ":")) + "\n")
            for s in spans:
                f.write(json.dumps(s, separators=(",", ":")) + "\n")
        return len(spans)

    def chrome_trace(self) -> dict:
        """Chrome trace_event JSON object (Perfetto-loadable)."""
        return spans_to_chrome(self.snapshot())

    def export_chrome(self, path: str) -> int:
        spans = self.snapshot()
        with open(path, "w") as f:
            json.dump(spans_to_chrome(spans), f)
        return len(spans)


def spans_to_chrome(spans: list[dict]) -> dict:
    """JSONL-shaped span records -> Chrome trace_event JSON.

    Each track becomes a tid with a thread_name metadata event; complete
    spans are "X" events, instants are "i" (thread-scoped).  Times convert
    from perf_counter seconds to integer-friendly microseconds, rebased to
    the earliest span so the viewer opens at t=0."""
    events = _chrome_events(spans, pid=os.getpid(),
                            t_base=min((s["ts"] for s in spans),
                                       default=0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _chrome_events(spans: list[dict], pid: int, t_base: float,
                   offset_s: float = 0.0,
                   process_name: Optional[str] = None) -> list[dict]:
    """One source's spans as Chrome events under process `pid`, with its
    clock offset applied (local = source ts + offset) and all times
    rebased to `t_base` (already in the merged/local timebase)."""
    tids: dict[str, int] = {}
    events: list[dict] = []
    if process_name:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": process_name}})
    for s in spans:
        track = s.get("track", "main")
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": track}})
        ev = {"name": s["name"], "pid": pid, "tid": tid,
              "ts": round((s["ts"] + offset_s - t_base) * 1e6, 3),
              "cat": track.split(":", 1)[0]}
        if s.get("attrs"):
            ev["args"] = s["attrs"]
        if s.get("instant"):
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(s["dur"] * 1e6, 3)
        events.append(ev)
    return events


def merge_chrome(sources: list[dict]) -> dict:
    """Stitch span sets from SEVERAL processes into one Chrome trace.

    Each source is {"spans": [...], "process": {...}|None,
    "offset_s": float} — spans in that process's perf_counter timebase,
    `offset_s` mapping them onto the merger's timebase (local ≈ remote +
    offset; 0.0 for local files).  Every source becomes its own process
    track group (synthetic pids — two replicas on one host, or an
    in-process test fleet, must not collapse into one group), named from
    its process identity; all events rebase to the earliest aligned span
    so the merged trace opens at t=0 with the processes side by side."""
    t_base = min((s["ts"] + src.get("offset_s", 0.0)
                  for src in sources for s in src.get("spans", ())),
                 default=0.0)
    events: list[dict] = []
    for i, src in enumerate(sources):
        proc = src.get("process") or {}
        name = " ".join(
            str(x) for x in (proc.get("role"), proc.get("addr"),
                             f"pid={proc['pid']}" if "pid" in proc
                             else None, src.get("label"))
            if x) or f"process-{i + 1}"
        events.extend(_chrome_events(
            src.get("spans", []), pid=i + 1, t_base=t_base,
            offset_s=float(src.get("offset_s", 0.0)), process_name=name))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


#: the process-global tracer the serving engine records into by default
#: (and compile events always).  Off until something (a test, a
#: measurement, an embedder) flips `.enabled`.
_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer
