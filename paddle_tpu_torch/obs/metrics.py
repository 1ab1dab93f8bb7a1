"""Metrics registry: counters, gauges and histograms with labels — the
port's copy of paddle_tpu/obs/metrics.py (stdlib only).

  * `render()`: the Prometheus text exposition (text/plain; version
    0.0.4), byte for byte the reference's for the same samples;
  * `snapshot()`: a flat {name{labels}: value} dict.

Stat objects keep their own storage and are read at render time through
collectors (`register_collector`): a collector is a zero-arg callable
returning `(name, kind, labels|None, value)` samples.  `CATALOG` is the
reference's name -> help map, whole; a registry built with `strict=True`
refuses any name outside it.  The serving engine's histograms
(`step_tokens_hist`, `decode_gap_hist`, `draft_ms_hist`, `spec_k_hist`)
are standalone `Histogram`s of this module; `statset_collector` reads a
utils/stat.py `StatSet` (the serving front end's latency windows and
the trainer's host phases); `barrier_collector` reads the trainer's
parallel/barrier_stat.py `BarrierTimer`.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

#: every metric name this repo emits -> one-line help.  The single source
#: of truth the strict registries and the docs lint both anchor to.
CATALOG: dict[str, str] = {
    # -- serving: engine state (pump-consistent in the stats RPC) ---------
    "serving_queue_depth": "requests waiting in the engine FIFO",
    "serving_slots_in_use": "decode slots holding an in-flight request",
    "serving_num_slots": "configured decode slots",
    "serving_pages_in_use": "KV pages allocated to slots",
    "serving_free_pages": "KV pages on the free list",
    "serving_num_pages": "configured KV page pool size (incl. trash page)",
    "serving_private_pages_in_use":
        "KV pages mapped by exactly one slot and not prefix-cached",
    "serving_shared_pages_in_use":
        "slot-mapped KV pages shared read-only (multi-slot or prefix-cached)",
    "serving_prefix_cached_pages":
        "KV pages retained only by the prefix index (evictable on pressure)",
    "serving_prefix_nodes": "nodes in the radix prefix index",
    "serving_prefix_hits_total":
        "admissions that mapped at least one cached prefix page",
    "serving_prefix_misses_total":
        "admissions that found no cached prefix (prefix cache enabled)",
    "serving_prefix_tokens_saved_total":
        "prompt tokens skipped at prefill via cached prefixes",
    "serving_prefix_evictions_total":
        "prefix pages evicted by page-pool pressure (LRU, before pausing)",
    "serving_prefix_cow_total":
        "copy-on-write page copies (divergence inside a shared boundary page)",
    # -- host KV spill tier (docs/serving.md "KV spill tier") -------------
    "serving_spill_pages_total":
        "cold cached pages spilled to host RAM instead of destroyed",
    "serving_restore_pages_total":
        "spilled pages restored to device on a prefix hit",
    "serving_spill_bytes":
        "host-RAM bytes currently held by the spill tier",
    "serving_decode_steps_total": "compiled decode steps executed",
    # -- cross-replica KV transfer (docs/serving.md "Disaggregated
    # prefill/decode") ----------------------------------------------------
    "serving_kv_xfer_pushes_total":
        "outbound kv_push attempts (prefill_only completions that tried "
        "to ship their committed prefix to a decode replica)",
    "serving_kv_xfer_push_failures_total":
        "outbound kv_push attempts that failed (connect refused, peer "
        "error, timeout, nothing cached) — the router falls back to "
        "colocated placement on each",
    "serving_kv_xfer_pages_shipped_total":
        "committed KV pages serialized to the wire by export_pages",
    "serving_kv_xfer_pages_received_total":
        "KV pages scattered into the pool from inbound kv_push blobs",
    "serving_kv_xfer_mounts_total":
        "inbound blobs mounted read-only into the prefix tree "
        "(import_prefix calls that added at least zero runs)",
    # -- tensor-parallel sharded decode (docs/serving.md "Sharded decode")
    "serving_tp_shards":
        "tensor-parallel shards (mesh model-axis size; 1 = unsharded)",
    "serving_kv_pool_bytes_per_shard":
        "KV page-pool bytes resident PER DEVICE (kv-head axis split over "
        "the mesh model axis)",
    # -- speculative decoding (docs/serving.md "Speculative decoding") ----
    "serving_spec_drafted_total":
        "draft tokens scored by the verify step (host drafter proposals "
        "the target model checked)",
    "serving_spec_accepted_total":
        "draft tokens accepted exactly (the sampled chain matched the "
        "draft) — each one is a decode step the engine did not pay",
    "serving_spec_accept_rate":
        "accepted / drafted over the engine lifetime (0 before any "
        "draft; PERF.md 'Reading the accept rate')",
    "serving_draft_steps_total":
        "drafter proposal passes that proposed at least one token "
        "(a ModelDrafter pass is ONE batched device dispatch for all "
        "decoding slots)",
    "serving_draft_ms":
        "wall ms per drafter proposal pass (host lookup or batched "
        "draft-model dispatch) — must stay well under the verify step "
        "it feeds for speculation to pay",
    "serving_spec_k_effective":
        "per-slot draft depth chosen each flush window (dynamic k: the "
        "accept-EWMA policy's output, 0..spec_k; static: spec_k) — mass "
        "near 0 means the workload does not sustain speculation",
    # -- chunked prefill / mixed-step token budget -------------------------
    "serving_step_tokens":
        "scheduled token rows per compiled step (decode rows + prefill "
        "chunk rows; bounded by max_step_tokens — the p99 inter-token "
        "latency bound)",
    "serving_prefill_chunks_total":
        "prompt chunks scheduled into mixed prefill/decode steps",
    "serving_mixed_steps_total":
        "compiled steps that carried at least one prefill chunk row",
    "serving_scan_steps_total":
        "decode bodies run inside scanned multi-step dispatches "
        "(decode_steps per flush; see serving_scan_flushes_total)",
    "serving_scan_flushes_total":
        "scanned multi-step dispatches (host boundaries) — steps/flushes "
        "reads back the effective decode_steps",
    "serving_decode_gap_ms":
        "pump-step gap decoding slots saw (ms between consecutive steps "
        "advancing decode rows — HOL-blocking prefill shows here)",
    "serving_tokens_generated_total": "tokens emitted across all requests",
    "serving_preemptions_total": "slots preempted by page-pool pressure",
    "serving_cancelled_total": "requests aborted by client cancel/disconnect",
    "serving_expired_total": "requests aborted by deadline expiry",
    # -- serving: front-end admission state -------------------------------
    "serving_inflight": "accepted-but-unfinished requests",
    "serving_max_inflight": "admission cap (num_slots + max_queue)",
    "serving_draining": "1 while the server refuses new work to drain",
    "serving_requests_accepted_total": "generate requests admitted",
    "serving_overload_total": "generate requests refused with overload",
    "serving_latency_seconds":
        "request/first-token/inter-token latency quantiles "
        "(labels: stat, quantile; bounded recent-sample windows)",
    "serving_latency_count": "samples recorded per latency stat (label: stat)",
    # -- fleet router (paddle_tpu/fleet/router.py) -------------------------
    "fleet_requests_accepted_total": "generate requests the router placed",
    "fleet_relay_latency_seconds":
        "router-tier relay latency quantiles (labels: stat, quantile; "
        "relay_token_latency = burst-honest inter-token gap — a scanned "
        "k-token burst charges each token gap/k)",
    "fleet_relay_latency_count":
        "samples recorded per router relay stat (label: stat)",
    "fleet_placements_total":
        "placements by policy decision (label: policy = "
        "affinity/least_loaded/random/disagg)",
    "fleet_retries_total":
        "requests transparently re-placed after replica death/circuit-open "
        "(only never-streamed requests retry)",
    "fleet_sheds_total":
        "requests refused with overload at the fleet level (every healthy "
        "replica saturated, none registered, or router draining)",
    "fleet_joins_total": "replica registrations (hello handshake passed)",
    "fleet_leaves_total":
        "replica departures (ctl leave, connection lost, heartbeat expiry)",
    "fleet_inflight": "requests routed and not yet finished",
    "fleet_replicas_registered": "replicas in the router's table",
    "fleet_replicas_healthy": "replicas placement may choose from",
    "fleet_replicas_draining":
        "replicas finishing in-flight work while refused new placements",
    "fleet_replicas_broken":
        "replicas with the circuit open (polled pump wedged/dead)",
    "fleet_affinity_keys":
        "prefix-affinity index entries (bounded LRU; first page-run -> "
        "replica)",
    "fleet_draining": "1 while the router refuses new work to drain",
    # -- disaggregated prefill/decode placement (docs/serving.md) ---------
    "fleet_kv_pushes_total":
        "disaggregated placements the router started (prefill_only sent "
        "to a prefill-tier replica with a push_to target)",
    "fleet_kv_push_failures_total":
        "disaggregated placements whose kv_push failed (done frame came "
        "back push_ok:false) — each falls back to colocated placement",
    "fleet_kv_fallbacks_total":
        "requests re-placed colocated after a disagg attempt failed "
        "(push failure, prefill replica death, decode tier gone)",
    "fleet_kv_pages_shipped_total":
        "KV pages the router observed shipped on successful kv_pushes "
        "(sum of pushed_pages off done frames)",
    # -- parameter server (paddle_tpu/pserver/) ----------------------------
    "pserver_version": "optimizer updates committed (the parameter version)",
    "pserver_pass_id": "training passes completed server-side",
    "pserver_trainers_active": "trainers the sync barrier waits for",
    "pserver_trainers_draining":
        "trainers finishing a final batch before leaving (never stall "
        "the barrier)",
    "pserver_updates_total": "optimizer applies (sync windows + async "
        "contributions) committed by the update thread",
    "pserver_grads_received_total": "send_grad frames accepted",
    "pserver_grads_discarded_total":
        "in-flight contributions discarded (dead trainer mid-window, or "
        "the drop-last convention at a pass barrier)",
    "pserver_async_rejected_total":
        "async gradients refused for exceeding max_staleness (the "
        "trainer must re-pull)",
    "pserver_async_staleness":
        "versions behind at async apply — the honest divergence signal "
        "of bounded-staleness training",
    "pserver_barrier_wait_seconds":
        "time a sync barrier waiter spent blocked until its window "
        "committed (straggler skew shows here)",
    "pserver_snapshots_total": "streaming checkpoints committed",
    "pserver_snapshot_seconds":
        "wall seconds per streaming checkpoint (capture is O(blocks) "
        "pointer copies; the write overlaps live send_grad traffic)",
    "pserver_blocks": "parameter/optimizer blocks held by this shard",
    "pserver_block_bytes": "bytes held by this shard's parameter blocks",
    "pserver_window_skew_ms":
        "per-window barrier-arrival skew (last arriver minus first, ms) "
        "on the shard-0 coordinator — the straggler signal",
    "pserver_apply_seconds":
        "update-thread wall per window commit (accumulate + optimizer "
        "apply, device-synced)",
    "pserver_update_lag_s":
        "seconds the update thread has been inside its current job — "
        "0 when idle; growing = a wedged optimizer apply",
    "pserver_update_alive":
        "1 while the update thread is running and error-free",
    # -- pump-thread heartbeat watchdog -----------------------------------
    "pump_alive":
        "1 while the engine pump is running (0 the moment it has fatally "
        "errored, even mid-unwind)",
    "pump_last_step_age_s":
        "seconds since the pump last completed a loop iteration — a wedged "
        "engine shows here before clients time out",
    # -- trainer -----------------------------------------------------------
    "trainer_pass_id": "passes completed",
    "trainer_cost": "mean cost of the last finished pass",
    "trainer_samples_per_sec": "throughput of the last finished pass",
    "trainer_batches_total": "batches trained since process start",
    "trainer_samples_total": "samples trained since process start",
    "trainer_host_phase_seconds":
        "host-phase duration quantiles from the global StatSet "
        "(labels: phase, quantile)",
    "trainer_host_phase_count": "timed occurrences per host phase",
    "trainer_host_phase_seconds_total": "accumulated seconds per host phase",
    "trainer_barrier_seconds":
        "BarrierTimer window quantiles: dispatch/sync/h2d/scan "
        "(labels: window, quantile)",
    # -- tracer ------------------------------------------------------------
    "trace_spans_recorded_total": "spans recorded since enable (incl. wrapped)",
    "trace_spans_dropped_total": "spans overwritten by ring wrap-around",
    "trace_ring_capacity":
        "span-ring capacity — dropped_total climbing against it means the "
        "trace window is shorter than the workload being debugged",
    # -- compile observability (obs/compile_watch.py) ----------------------
    "jit_compiles_total":
        "jit compiles observed per instrumented entry point (label: site)",
    "jit_compile_seconds":
        "accumulated compile+first-run wall seconds per site (label: site)",
    "jit_signatures":
        "distinct compiled signatures seen per site (label: site)",
    "jit_recompile_storms_total":
        "recompile-storm warnings fired per site (label: site)",
    # -- device-memory accounting (obs/hbm.py) -----------------------------
    "hbm_bytes_in_use":
        "device-reported bytes in use (absent when the backend, e.g. CPU, "
        "does not report)",
    "hbm_bytes_limit": "device-reported memory limit (absent on CPU)",
    "hbm_live_array_bytes": "total nbytes over jax.live_arrays()",
    "hbm_live_arrays": "count of live device arrays",
    "hbm_param_bytes": "bytes held by the model parameter pytree",
    "hbm_kv_pool_bytes": "bytes held by the paged KV cache pools",
    # -- flight recorder (obs/flight.py) -----------------------------------
    "flight_events_recorded_total":
        "flight-recorder events recorded (incl. wrapped)",
    "flight_events_dropped_total":
        "flight-recorder events overwritten by ring wrap-around",
    "postmortem_bundles_total": "postmortem bundles written by this process",
    # -- health plane (obs/timeseries.py + obs/slo.py) ---------------------
    "obs_history_series":
        "distinct metric series tracked by the in-memory history ring",
    "obs_history_samples_total":
        "sampling passes the history sampler has taken over the registry",
    "obs_history_sample_age_s":
        "seconds since the history sampler last walked the registry "
        "(-1 before the first pass) — a stuck sampler shows here",
    "obs_history_dropped_series_total":
        "series refused by the history ring's cardinality cap",
    "obs_slo_firing":
        "1 while the named SLO is firing (label: slo; burn-rate "
        "semantics in docs/observability.md 'Health plane')",
    "obs_slo_fired_total": "firing transitions per SLO (label: slo)",
}


def _validate_name(name: str) -> None:
    if not name or not all(c.isalnum() or c == "_" for c in name) \
            or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")


def _escape_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._vals: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} declared labels "
                f"{self.labelnames}, got {tuple(sorted(labels))}")
        return tuple(labels[k] for k in self.labelnames)

    def _labels_of(self, key: tuple) -> Optional[dict]:
        return dict(zip(self.labelnames, key)) if self.labelnames else None

    def samples(self) -> list[tuple]:
        with self._lock:
            items = list(self._vals.items())
        return [(self.name, self.kind, self._labels_of(k), v)
                for k, v in items]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._vals.get(self._key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._vals[self._key(labels)] = float(value)

    def set_fn(self, fn: Callable[[], float], **labels) -> None:
        """Callback gauge: `fn` is sampled at render time (on the render
        thread — keep it a cheap read of GIL-atomic state)."""
        self._vals[self._key(labels)] = fn

    def value(self, **labels) -> float:
        v = self._vals.get(self._key(labels), 0.0)
        return float(v()) if callable(v) else v

    def samples(self) -> list[tuple]:
        with self._lock:
            items = list(self._vals.items())
        return [(self.name, self.kind, self._labels_of(k),
                 float(v()) if callable(v) else v)
                for k, v in items]


#: latency-shaped default buckets, seconds
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b
        # per label-key: ([cumulative counts per bucket + inf], sum, count)

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        v = float(value)
        with self._lock:
            st = self._vals.get(k)
            if st is None:
                st = self._vals[k] = [[0] * (len(self.buckets) + 1),
                                      0.0, 0]
            for i, le in enumerate(self.buckets):
                if v <= le:
                    st[0][i] += 1
            st[0][-1] += 1                       # +Inf
            st[1] += v
            st[2] += 1

    def samples(self) -> list[tuple]:
        with self._lock:
            items = [(k, ([*st[0]], st[1], st[2]))
                     for k, st in self._vals.items()]
        out = []
        for k, (counts, total, n) in items:
            base = self._labels_of(k) or {}
            for i, le in enumerate(self.buckets):
                out.append((self.name + "_bucket", "histogram",
                            dict(base, le=f"{le:g}"), float(counts[i])))
            out.append((self.name + "_bucket", "histogram",
                        dict(base, le="+Inf"), float(counts[-1])))
            out.append((self.name + "_sum", "histogram",
                        self._labels_of(k), total))
            out.append((self.name + "_count", "histogram",
                        self._labels_of(k), float(n)))
        return out


class MetricsRegistry:
    """Named metric registry + render surface.  `strict=True` pins every
    metric name (declared or collector-emitted) to CATALOG."""

    def __init__(self, strict: bool = False):
        self.strict = strict
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], Iterable[tuple]]] = []

    # -- declaration -------------------------------------------------------
    def _declare(self, cls, name: str, help: str, labels, **kw):
        _validate_name(name)
        if self.strict and name not in CATALOG:
            raise ValueError(
                f"metric {name!r} is not in obs.metrics.CATALOG — add it "
                f"(and document it in docs/observability.md; "
                f"tools/check_metrics_names.py enforces the pairing)")
        help = help or CATALOG.get(name, "")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-declared as {cls.kind} with "
                        f"labels {tuple(labels)} (was {m.kind} "
                        f"{m.labelnames})")
                return m
            m = cls(name, help, tuple(labels), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, labels, buckets=buckets)

    def register_collector(self, fn: Callable[[], Iterable[tuple]]) -> None:
        """`fn()` -> iterable of (name, kind, labels|None, value), pulled
        at every render/snapshot — the adapter hook for stat objects that
        keep their own storage (StatSet, BarrierTimer, engine counters)."""
        with self._lock:
            self._collectors.append(fn)

    # -- reading -----------------------------------------------------------
    def _all_samples(self) -> list[tuple]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out = []
        for m in metrics:
            out.extend(m.samples())
        for fn in collectors:
            for name, kind, labels, value in fn():
                if self.strict and \
                        self._family_of(name, kind) not in CATALOG:
                    raise ValueError(
                        f"collector emitted uncataloged metric {name!r}")
                out.append((name, kind, labels, value))
        return out

    @staticmethod
    def _family_of(name: str, kind: str) -> str:
        """Metric family a sample belongs to: histogram samples group
        under their base name (x_bucket/x_sum/x_count -> x), which is
        where the exposition format wants the one HELP/TYPE pair."""
        if kind == "histogram":
            for suf in ("_bucket", "_sum", "_count"):
                if name.endswith(suf):
                    return name[: -len(suf)]
        return name

    def samples(self) -> list[tuple]:
        """Public kinded view: [(name, kind, labels|None, value)] — the
        raw feed `render()`/`snapshot()` are built from.  The history
        sampler (obs/timeseries.py) reads this rather than `snapshot()`
        because downsampling needs `kind` (counters store as deltas),
        which the flat dict loses."""
        return self._all_samples()

    def render(self) -> str:
        """Prometheus text exposition (text/plain; version 0.0.4)."""
        families: dict[str, dict] = {}
        for name, kind, labels, value in self._all_samples():
            base = self._family_of(name, kind)
            fam = families.setdefault(base, {"kind": kind, "samples": []})
            fam["samples"].append((name, labels, value))
        lines = []
        for base in sorted(families):
            fam = families[base]
            help = self._metrics[base].help if base in self._metrics \
                else CATALOG.get(base, "")
            if help:
                lines.append(f"# HELP {base} {help}")
            lines.append(f"# TYPE {base} {fam['kind']}")
            for name, labels, value in fam["samples"]:
                v = f"{value:.10g}" if isinstance(value, float) else value
                lines.append(f"{name}{_fmt_labels(labels)} {v}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """Flat {name or name{k=v,...}: value} dict — the metrics.jsonl
        record shape."""
        return {name + _fmt_labels(labels): value
                for name, _kind, labels, value in self._all_samples()}


# -- collector adapters ----------------------------------------------------

def statset_collector(statset, metric: str, count_metric: str,
                      label: str = "stat", qs=(50.0, 90.0, 99.0),
                      total_metric: Optional[str] = None):
    """Expose a utils/stat.py StatSet as quantile gauges + sample counts.
    Pure read-time adapter: the StatSet keeps its owner and its per-Stat
    lock; quantiles come from its bounded recent-sample windows."""

    def collect():
        out = []
        for name in sorted(statset.stats):
            s = statset.stats.get(name)
            if s is None:
                continue
            for q, v in statset.percentiles(name, qs).items():
                out.append((metric, "gauge",
                            {label: name, "quantile": q}, v))
            out.append((count_metric, "counter", {label: name},
                        float(s.count)))
            if total_metric is not None:
                out.append((total_metric, "counter", {label: name},
                            float(s.total_s)))
        return out

    return collect


def barrier_collector(bt, metric: str = "trainer_barrier_seconds"):
    """Expose a BarrierTimer's rolling windows (dispatch/sync/h2d/scan)
    as quantile gauges, in seconds."""

    def collect():
        out = []
        for window, pct in bt.local_summary().items():     # values in ms
            for q, v in pct.items():
                out.append((metric, "gauge",
                            {"window": window, "quantile": q}, v / 1e3))
        return out

    return collect


def tracer_collector(tracer):
    """Expose the span tracer's ring accounting: recorded/dropped totals
    plus the ring capacity they are read against — the Tracer overwrites
    silently when full, so the dropped counter is the only place that
    loss is visible."""

    def collect():
        return [
            ("trace_spans_recorded_total", "counter", None,
             float(tracer.recorded)),
            ("trace_spans_dropped_total", "counter", None,
             float(tracer.dropped)),
            ("trace_ring_capacity", "gauge", None,
             float(tracer.capacity)),
        ]

    return collect
