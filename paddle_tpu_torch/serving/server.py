"""RPC serving front end: asyncio TCP server + continuous engine pump —
the port's copy of paddle_tpu/serving/server.py, over the port's
ServingEngine, with the same frames, RPCs and metric rows.

The reference's layer 5 is a length-prefixed RPC socket server in front of
the compute (ref: paddle/pserver/ProtoServer.h:37, LightNetwork.h:41);
this is a request-lifecycle front end (admission, deadlines,
cancellation, streaming, drain) over `serving/engine.py`:

  * ONE background PUMP THREAD owns the ServingEngine and drives step()
    continuously — requests arrive mid-flight, per-token completions
    stream back as they decode.  All engine access goes through the pump:
    the asyncio side never touches scheduler state, it posts commands
    (add/cancel/kv_import/stats) to a thread-safe queue the pump drains
    between steps, and the engine's on_token/on_finish hooks post frames
    back via call_soon_threadsafe.  No locks around the scheduler.
  * ONLY THE PUMP THREAD TOUCHES CUDA: steps, window-graph captures and
    replays, `export_prefix` when a disaggregated prefill finishes,
    `import_prefix` mounts between steps.  It sets its own thread-local
    torch state first (the engine's device, grad mode off): both are
    per-thread in torch.  The asyncio loop thread and the history
    sampler thread read host counters and the caching allocator's
    statistics only — no kernel, no tensor read — so the stale-ok
    `stats`, `metrics` and `history` frames answer while the pump is
    wedged, and a window capture on the pump thread (thread-local
    capture mode, utils/cuda_graphs.py) is never invalidated by them.
  * BOUNDED ADMISSION: at most `num_slots + max_queue` unfinished
    requests; one more gets an explicit `overload` response.
  * DEADLINES and CANCELLATION free the request's slot and KV pages
    mid-flight (engine.cancel / the per-step deadline sweep).
  * GRACEFUL DRAIN: stop admitting (new requests get
    `overload/reason=draining`), finish everything in flight, stop the
    pump, close the listener.  tools/serve.py wires SIGTERM to this and
    exits 0.
  * STATS RPC: queue depth, slot/page occupancy, preemptions, and
    per-request / per-token latency percentiles from a utils/stat.py
    StatSet.  The engine-state part is built ON THE PUMP THREAD via a
    command-queue round trip (`consistent: true`); `{"stale_ok": true}`
    answers from the loop thread without waiting on the pump.
  * METRICS + WATCHDOG: a Prometheus-style `metrics` frame answered on the
    LOOP thread; the pump heartbeats every loop iteration and
    `pump_last_step_age_s` exposes a hung engine.
  * HEALTH PLANE: a `MetricHistory` ring fed by a `HistorySampler` thread,
    SLO burn-rate alerting on each pass, the `history` RPC.
  * KV_PUSH: a `prefill_only` request ships its committed prefix's pages
    (`export_prefix`, the reference's wire layout) to a decode replica as
    BIN frames; an inbound blob mounts through `import_prefix`.

Wire protocol: serving/wire.py; the blocking-socket client is
serving/client.py.
"""

from __future__ import annotations

import asyncio
import json
import queue
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.obs import (MetricsRegistry, statset_collector,
                                  tracer_collector)
from paddle_tpu_torch.obs.compile_watch import (compile_collector,
                                                get_compile_watch)
from paddle_tpu_torch.obs.flight import flight_collector, get_flight_recorder
from paddle_tpu_torch.obs.hbm import hbm_collector, hbm_snapshot
from paddle_tpu_torch.obs.slo import SloEvaluator, default_serving_slos
from paddle_tpu_torch.obs.timeseries import (HistorySampler, MetricHistory,
                                             history_collector,
                                             history_reply)
from paddle_tpu_torch.obs.trace import trace_reply
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.engine import Request, ServingEngine
from paddle_tpu_torch.utils.stat import StatSet


class _ReqState:
    """Server-side lifecycle of one accepted request."""

    __slots__ = ("conn", "cid", "stream", "t_submit", "t_last", "next_idx",
                 "burst_left", "burst_share", "push_to", "prompt")

    def __init__(self, conn, cid, stream):
        self.conn = conn
        self.cid = cid                # the client's id (frame field)
        self.stream = bool(stream)
        # disaggregated prefill (docs/serving.md): a prefill_only request
        # carries the decode replica to kv_push the committed pages to —
        # the done frame is then DELAYED until the push resolves, so the
        # router learns push_ok before it sends the real generate
        self.push_to = None           # {"host", "port"} or None
        self.prompt = None            # np.int32 prompt (prefill_only only)
        self.t_submit = time.monotonic()
        self.t_last = self.t_submit   # last token emission (TTFT base)
        self.next_idx = 0             # next UNSEEN token index — a
                                      # preempted request replays identical
                                      # tokens from 0; indexes below this
                                      # are dropped, not re-streamed
        # burst-honest inter-token latency (multi-step decode): a scanned
        # dispatch banks up to k tokens back-to-back, so the first token
        # of a burst divides the whole inter-arrival gap by the burst size
        # and the rest charge the SAME share — token_latency percentiles
        # stay comparable across decode_steps settings
        self.burst_left = 0           # burst tokens still to charge
        self.burst_share = 0.0        # per-token share of the burst gap


#: one client connection (asyncio side): the shared slow-reader-severing
#: frame connection — hoisted to wire.py so the fleet router's client
#: face can never drift from this server's (conn.rids maps client id ->
#: engine req_id here)
_Conn = wire.FrameConn


def _kv_push_frames(cid, toks, meta: dict, payload: bytes) -> list[bytes]:
    """Split one kv_push blob into encoded BIN frames, each under the
    receiver's MAX_BIN_PAYLOAD bin_cap.  The cap bounds the WHOLE
    declared body (header-length word + JSON header + chunk), and part
    0's header carries the full token list + per-layer meta — for long
    prompts that header alone runs to hundreds of KiB, so the part-0
    chunk is sized from the ENCODED header rather than a fixed headroom
    (a fixed 64 KiB reserve silently busts the cap past ~9k tokens —
    exactly the prompts --disagg-min-prompt selects for).  Raises
    wire.FrameError when even an empty-chunk part 0 would exceed the cap
    (the caller degrades to push_ok:false)."""
    tokens = [int(t) for t in toks]
    probe = {"type": "kv_push", "id": cid, "seq": 0, "last": False,
             "tokens": tokens, "meta": meta}
    h0 = len(json.dumps(probe, separators=(",", ":")).encode("utf-8"))
    # 64 bytes absorb the real header's drift from this probe (the
    # length word, last:true vs false)
    room0 = wire.MAX_BIN_PAYLOAD - h0 - 64
    if room0 < 0:
        raise wire.FrameError(
            f"kv_push part-0 header is {h0} bytes, over the "
            f"{wire.MAX_BIN_PAYLOAD}-byte binary-frame cap")
    # later parts carry a tiny header; 4096 bytes of slack covers it at
    # any seq digit count
    chunk = wire.MAX_BIN_PAYLOAD - 4096
    parts = [payload[:room0]]
    parts += [payload[i:i + chunk]
              for i in range(len(parts[0]), len(payload), chunk)]
    frames = []
    for i, part in enumerate(parts):
        hdr = {"type": "kv_push", "id": cid, "seq": i,
               "last": i == len(parts) - 1}
        if i == 0:
            hdr["tokens"] = tokens
            hdr["meta"] = meta
        frames.append(wire.encode_bin(hdr, part))
    return frames


class ServingServer:
    """TCP front end over one ServingEngine.

    >>> eng = ServingEngine(tr.executor, tr.params, num_slots=4)
    >>> srv = ServingServer(eng, port=0)           # 0 = ephemeral
    >>> host, port = srv.start_background()
    >>> ...                                        # serving/client.py
    >>> srv.stop_background(drain=True)

    `max_queue` bounds requests accepted beyond the engine's slots:
    admission cap = num_slots + max_queue unfinished requests.
    """

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, max_queue: int = 32,
                 postmortem_dir: Optional[str] = None,
                 wedge_threshold_s: float = 30.0, role: str = "both",
                 kv_push_timeout_s: float = 10.0,
                 history_resolution_s: float = 5.0,
                 history_retention_s: float = 1800.0, slo_specs=None):
        assert role in ("prefill", "decode", "both"), role
        self.engine = engine
        self.host = host
        self.port = port
        self.max_inflight = len(engine.slots) + int(max_queue)
        # disaggregated prefill/decode (docs/serving.md): the replica's
        # advertised placement role — ADVISORY, any replica can serve any
        # request; the router's placement tiers read it off hello
        self.role = role
        self.kv_push_timeout_s = float(kv_push_timeout_s)
        # kv_push accounting (loop thread): outbound pushes attempted /
        # failed; page counts live on the engine/kv counters
        self._kv_pushes = 0
        self._kv_push_failures = 0
        # in-progress inbound multi-part kv_push blobs, keyed by
        # (conn.seq, client id) — dropped wholesale when the conn closes
        self._kv_parts: dict = {}
        # the server exports/dumps the ENGINE's tracer (the process-global
        # one unless the embedder gave the engine its own ring), so the
        # `trace` RPC snapshot, the metrics accounting, and the
        # postmortem spans all describe the same spans
        self.tracer = engine.tracer
        self.stats = StatSet("serving_server")
        # flight recorder (obs/flight.py): lifecycle events always record
        # while a server exists (they are per-request, not per-token);
        # postmortem BUNDLES are written only when a directory is
        # configured — on pump death, on the watchdog-wedge threshold
        # (pump_last_step_age_s > wedge_threshold_s), and on an operator
        # `dump` frame.
        self.flight = get_flight_recorder()
        self.flight.enabled = True
        self.postmortem_dir = postmortem_dir
        self._last_dump_error = "unknown"
        self.wedge_threshold_s = float(wedge_threshold_s)
        self._wedge_dumped = False    # one bundle per wedge episode
        self._last_beat_event = 0.0   # flight beats sampled at ~1/s
        self._inflight = 0            # accepted, not finished (loop thread)
        self._draining = False
        # pump heartbeat: (monotonic time, engine step count) written by
        # the pump once per loop iteration — a single tuple rebind, so any
        # thread reads it torn-free.  None until the pump first runs.
        self._pump_beat: Optional[tuple] = None
        self._conns: set = set()      # open connections (loop thread)
        self._routes: dict[str, _ReqState] = {}
        self._cmds: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_error: Optional[BaseException] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._idle: Optional[asyncio.Event] = None
        self._closed: Optional[asyncio.Event] = None
        self._crashed: Optional[asyncio.Event] = None
        self._watch_task = None       # the loop-side wedge watchdog
        self._bg_thread: Optional[threading.Thread] = None
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish
        # the card the engine's tensors live on ("cuda" without an index
        # is the constructing thread's current device)
        dev = engine.device
        self._cuda_index = None if dev.type != "cuda" else (
            torch.cuda.current_device() if dev.index is None else dev.index)
        self._init_metrics()
        # the health plane (docs/observability.md "Health plane"): a
        # bounded time-series ring over the registry, fed by a background
        # sampler thread, with SLO burn-rate alerting riding each
        # sampling pass.  `slo_specs=None` takes the serving defaults;
        # pass () to disable alerting while keeping history.
        self.history = MetricHistory(self.metrics,
                                     resolution_s=history_resolution_s,
                                     retention_s=history_retention_s)
        self.metrics.register_collector(history_collector(self.history))
        self.slo = SloEvaluator(
            self.history,
            default_serving_slos() if slo_specs is None else slo_specs,
            flight=self.flight, registry=self.metrics,
            dump_fn=self._slo_dump)
        self.history_sampler = HistorySampler(self.history,
                                              on_sample=self.slo.evaluate)

    def _init_metrics(self) -> None:
        """The unified registry behind the `metrics` frame.  Rendered on
        the LOOP thread: engine-derived values are advisory stale-ok
        reads of pump-owned state (each individually GIL-atomic; the
        CONSISTENT view is the stats RPC's pump round trip) — that is
        what keeps metrics answerable while the pump is wedged, which is
        the whole point of the watchdog gauges."""
        reg = self.metrics = MetricsRegistry(strict=True)
        self._m_accepted = reg.counter("serving_requests_accepted_total")
        self._m_overload = reg.counter("serving_overload_total")
        # disaggregated prefill/decode: outbound kv_push attempts/failures
        # (loop thread increments, mirrored in self._kv_pushes for stats)
        self._m_kv_pushes = reg.counter("serving_kv_xfer_pushes_total")
        self._m_kv_push_fail = \
            reg.counter("serving_kv_xfer_push_failures_total")
        reg.gauge("serving_inflight").set_fn(lambda: float(self._inflight))
        reg.gauge("serving_max_inflight").set(float(self.max_inflight))
        reg.gauge("serving_draining").set_fn(
            lambda: 1.0 if self._draining else 0.0)
        reg.gauge("pump_alive").set_fn(
            lambda: 1.0 if self.pump_alive() else 0.0)
        reg.gauge("pump_last_step_age_s").set_fn(self.pump_last_step_age)
        eng = self.engine

        def engine_state():
            return [
                ("serving_queue_depth", "gauge", None,
                 float(len(eng.queue))),
                ("serving_slots_in_use", "gauge", None,
                 float(sum(1 for s in eng.slots if s is not None))),
                ("serving_num_slots", "gauge", None, float(len(eng.slots))),
                ("serving_pages_in_use", "gauge", None,
                 float(eng.kv.pages_in_use)),
                ("serving_free_pages", "gauge", None,
                 float(eng.kv.free_page_count)),
                ("serving_num_pages", "gauge", None,
                 float(eng.kv.num_pages)),
                ("serving_decode_steps_total", "counter", None,
                 float(eng.n_decode_steps)),
                ("serving_tokens_generated_total", "counter", None,
                 float(eng.tokens_generated)),
                ("serving_preemptions_total", "counter", None,
                 float(eng.n_preemptions)),
                ("serving_cancelled_total", "counter", None,
                 float(eng.n_cancelled)),
                ("serving_expired_total", "counter", None,
                 float(eng.n_expired)),
                # prefix caching: hit/miss/saved counters plus the
                # private/shared/cached page-accounting split
                ("serving_private_pages_in_use", "gauge", None,
                 float(eng.kv.private_pages_in_use)),
                ("serving_shared_pages_in_use", "gauge", None,
                 float(eng.kv.shared_pages_in_use)),
                ("serving_prefix_cached_pages", "gauge", None,
                 float(eng.kv.cached_page_count)),
                ("serving_prefix_nodes", "gauge", None,
                 float(eng.prefix.n_nodes if eng.prefix else 0)),
                ("serving_prefix_hits_total", "counter", None,
                 float(eng.n_prefix_hits)),
                ("serving_prefix_misses_total", "counter", None,
                 float(eng.n_prefix_misses)),
                ("serving_prefix_tokens_saved_total", "counter", None,
                 float(eng.prefill_tokens_saved)),
                ("serving_prefix_evictions_total", "counter", None,
                 float(eng.prefix.n_evictions if eng.prefix else 0)),
                ("serving_prefix_cow_total", "counter", None,
                 float(eng.kv.n_cow)),
                # KV spill tier: device->host spills, host->device
                # restores, and the host-RAM bytes currently resident
                # (bounded by spill_bytes_budget)
                ("serving_spill_pages_total", "counter", None,
                 float(eng.kv.n_spilled)),
                ("serving_restore_pages_total", "counter", None,
                 float(eng.kv.n_restored)),
                ("serving_spill_bytes", "gauge", None,
                 float(eng.kv.host_bytes)),
                # chunked prefill: mixed-step/chunk counters plus the
                # engine-owned token-budget histograms (step_tokens_hist /
                # decode_gap_hist keep their own locks; their samples()
                # splice straight into the frame)
                ("serving_prefill_chunks_total", "counter", None,
                 float(eng.n_prefill_chunks)),
                ("serving_mixed_steps_total", "counter", None,
                 float(eng.n_mixed_steps)),
                # multi-step decode: scan body iterations vs boundary
                # flushes — steps/flushes ≈ decode_steps in steady state
                ("serving_scan_steps_total", "counter", None,
                 float(eng.n_scan_steps)),
                ("serving_scan_flushes_total", "counter", None,
                 float(eng.n_scan_flushes)),
                # speculative decoding: drafted/accepted counters + the
                # lifetime accept rate (the throughput-multiplier dial)
                ("serving_spec_drafted_total", "counter", None,
                 float(eng.n_spec_drafted)),
                ("serving_spec_accepted_total", "counter", None,
                 float(eng.n_spec_accepted)),
                ("serving_spec_accept_rate", "gauge", None,
                 float(eng.spec_accept_rate)),
                # tensor-parallel sharded decode: shard count + per-device
                # pool residency (the HBM split sharding exists for)
                ("serving_tp_shards", "gauge", None, float(eng.tp)),
                ("serving_kv_pool_bytes_per_shard", "gauge", None,
                 float(eng.kv.pool_bytes_per_shard)),
                # speculative drafting: the drafter's host+device wall
                # per proposal pass and the per-slot chosen depth (the
                # dynamic-k policy's OUTPUT — an operator reads this
                # histogram to see whether the workload sustains depth)
                ("serving_draft_steps_total", "counter", None,
                 float(eng.n_draft_steps)),
                # cross-replica kv transfer: pages serialized to / scattered
                # from the wire, and blob mounts into the prefix tree
                ("serving_kv_xfer_pages_shipped_total", "counter", None,
                 float(eng.kv.n_exported)),
                ("serving_kv_xfer_pages_received_total", "counter", None,
                 float(eng.kv.n_imported)),
                ("serving_kv_xfer_mounts_total", "counter", None,
                 float(eng.n_kv_mounts)),
            ] + eng.step_tokens_hist.samples() \
              + eng.decode_gap_hist.samples() \
              + eng.draft_ms_hist.samples() \
              + eng.spec_k_hist.samples()

        reg.register_collector(engine_state)
        reg.register_collector(statset_collector(
            self.stats, "serving_latency_seconds", "serving_latency_count"))
        reg.register_collector(tracer_collector(self.tracer))
        # deep introspection: per-site jit compile counters (the recompile-
        # storm fuel), device-memory accounting (KV pool / param / live-
        # array bytes, CPU-safe), and flight-recorder ring accounting —
        # all render-time reads, nothing on the token hot path
        reg.register_collector(compile_collector())
        reg.register_collector(hbm_collector(
            params_fn=lambda: eng.params, kv_fn=lambda: eng.kv))
        reg.register_collector(flight_collector(self.flight))

    def pump_alive(self) -> bool:
        """False the moment the pump has fatally errored, even while its
        thread is still unwinding (recording the death, writing the
        bundle): `_pump_error` is written BEFORE the death is announced
        to the loop, so a client that just saw its routes failed must
        never read `pump_alive: true` in the next stats frame."""
        return (self._pump_error is None
                and self._pump_thread is not None
                and self._pump_thread.is_alive())

    def pump_last_step_age(self) -> float:
        """Seconds since the pump last completed a loop iteration; -1.0
        when it has not run yet.  Healthy: < ~0.6s even when idle (the
        idle wait is bounded at 0.5s).  Growing: the engine is wedged
        inside step() — visible here (and in the metrics frame) while
        generate streams merely stall."""
        beat = self._pump_beat
        if beat is None:
            return -1.0
        return time.monotonic() - beat[0]

    # -- lifecycle (asyncio side) -----------------------------------------
    async def start(self, start_pump: bool = True) -> tuple[str, int]:
        """Bind the listener (port 0 = ephemeral; self.port is updated to
        the bound port) and start the engine pump."""
        self._loop = asyncio.get_running_loop()
        self._idle = asyncio.Event()
        self._closed = asyncio.Event()
        self._crashed = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        # the wedge watchdog rides the LOOP thread (it must keep running
        # while the pump is stuck inside step()): past the threshold it
        # records a wedge event and freezes one postmortem bundle
        self._watch_task = self._loop.create_task(self._wedge_watchdog())
        # the health plane's sampler is a daemon thread like the pump: it
        # reads lock-guarded registry state, so it keeps the time-series
        # (and SLO evaluation) running while the pump is wedged
        self.history_sampler.start()
        if start_pump:
            self.start_pump()
        return self.host, self.port

    async def wait_crashed(self) -> None:
        """Resolves when the engine pump dies (tools/serve.py races this
        against its signal wait so a crashed server flushes its trace and
        exits nonzero instead of idling forever)."""
        await self._crashed.wait()

    def start_pump(self) -> None:
        """Start (or no-op if running) the engine pump thread.  Split from
        start() so tests can stage deterministic admission states before
        any scheduling happens."""
        if self._pump_thread is not None and self._pump_thread.is_alive():
            return
        self._pump_thread = threading.Thread(
            target=self._pump, name="serving-engine-pump", daemon=True)
        self._pump_thread.start()

    async def drain(self) -> None:
        """Graceful shutdown: stop admitting (new generates get an
        `overload/reason=draining` response), let every accepted request
        finish (deadlines still fire on schedule), then stop the pump and
        close the listener."""
        self._draining = True
        if self._inflight > 0:
            self._ensure_pump_for_inflight()
            self._idle.clear()
            await self._idle.wait()
        await self._shutdown()

    async def stop(self) -> None:
        """Hard shutdown: cancel everything in flight, then close."""
        self._draining = True
        for rid in list(self._routes):
            self._cmds.put(("cancel", rid))
        self._wake.set()
        if self._inflight > 0:
            self._ensure_pump_for_inflight()
            self._idle.clear()
            await self._idle.wait()
        await self._shutdown()

    def _ensure_pump_for_inflight(self) -> None:
        """Waiting on in-flight work with no pump running would wedge the
        drain forever (start_background(start_pump=False) is a public
        path).  Accepted work is drain's to finish — start the pump; a
        pump that DIED already failed every route via _pump_died_on_loop,
        so don't resurrect it."""
        if self._pump_error is None and (
                self._pump_thread is None or not self._pump_thread.is_alive()):
            self.start_pump()

    async def _shutdown(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
        self.history_sampler.stop()
        if self._pump_thread is not None and self._pump_thread.is_alive():
            self._cmds.put(("stop",))
            self._wake.set()
            await asyncio.get_running_loop().run_in_executor(
                None, self._pump_thread.join)
        # TOCTOU sweep, mirroring _pump_died_on_loop: _handle_stats may
        # have seen the pump alive and enqueued AFTER the pump's own
        # stop-drain ran.  We are on the loop thread, so any such put
        # either already happened (visible here) or its _handle_stats
        # runs after this and sees the dead pump (stale fast path).
        try:
            while True:
                cmd = self._cmds.get_nowait()
                if cmd[0] == "stats":
                    self._stats_on_loop(cmd[1], None)
                elif cmd[0] == "kv_import":
                    cmd[2].send({"type": "kv_push", "id": cmd[1]["cid"],
                                 "ok": False, "error": "replica stopping"})
        except queue.Empty:
            pass
        # close every live connection EXPLICITLY, before waiting on the
        # listener: a client blocked on a read must see EOF now, and
        # since Python 3.12 Server.wait_closed() waits for every
        # connection to close, so a client that stays connected would
        # otherwise hold the shutdown forever
        for conn in list(self._conns):
            conn.dead = True
            try:
                conn.writer.close()
            except (ConnectionError, RuntimeError):
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._closed.set()

    async def wait_closed(self) -> None:
        await self._closed.wait()

    # -- lifecycle (thread-facing wrappers) --------------------------------
    def start_background(self, start_pump: bool = True) -> tuple[str, int]:
        """Run the asyncio loop on a daemon thread; returns (host, port)
        once bound.  For embedders and tests — tools/serve.py runs the
        loop in the foreground instead."""
        started = threading.Event()
        addr: list = []

        async def _amain():
            addr.extend(await self.start(start_pump=start_pump))
            started.set()
            await self.wait_closed()

        self._bg_thread = threading.Thread(
            target=lambda: asyncio.run(_amain()),
            name="serving-server-loop", daemon=True)
        self._bg_thread.start()
        if not started.wait(timeout=60):
            raise RuntimeError("serving server failed to bind within 60s")
        return addr[0], addr[1]

    def stop_background(self, drain: bool = True, timeout: float = 120):
        """Drain (or hard-stop) a start_background() server and join its
        loop thread."""
        if self._loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(
            self.drain() if drain else self.stop(), self._loop)
        fut.result(timeout=timeout)
        if self._bg_thread is not None:
            self._bg_thread.join(timeout=timeout)
        if self._pump_error is not None:
            raise RuntimeError("engine pump died") from self._pump_error

    # -- the engine pump (its own thread; sole owner of the engine) --------
    def _pump(self) -> None:
        try:
            # torch's grad mode and current device are per thread: set
            # this thread's own, as it is the one that runs the engine
            torch.set_grad_enabled(False)
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while True:
                # heartbeat FIRST: written once per loop iteration, so a
                # wedge anywhere below (a hung compiled step, a stuck
                # host sync) freezes it and pump_last_step_age_s grows
                now = time.monotonic()
                self._pump_beat = (now, self.engine.n_decode_steps)
                if now - self._last_beat_event >= 1.0:
                    # SAMPLED into the flight ring (~1/s): a postmortem
                    # shows how recently, and at what step, the pump was
                    # demonstrably alive — without beats evicting the
                    # lifecycle events the ring exists for
                    self._last_beat_event = now
                    self.flight.record(
                        "pump_beat", step=self.engine.n_decode_steps,
                        queue_depth=len(self.engine.queue),
                        inflight=self._inflight)
                try:
                    while True:
                        cmd = self._cmds.get_nowait()
                        if cmd[0] == "stop":
                            # commands queued behind "stop" must not be
                            # orphaned: a consistent-stats client is
                            # blocking on its reply — answer it here (we
                            # ARE between steps on the pump thread, so
                            # the snapshot is consistent); _shutdown
                            # sweeps anything put after this drain
                            try:
                                while True:
                                    cmd = self._cmds.get_nowait()
                                    if cmd[0] == "stats":
                                        self._loop.call_soon_threadsafe(
                                            self._stats_on_loop, cmd[1],
                                            self._engine_stats())
                                    elif cmd[0] == "kv_import":
                                        self._loop.call_soon_threadsafe(
                                            cmd[2].send,
                                            {"type": "kv_push",
                                             "id": cmd[1]["cid"],
                                             "ok": False,
                                             "error": "replica stopping"})
                            except queue.Empty:
                                pass
                            return
                        if cmd[0] == "add":
                            req = cmd[1]
                            try:
                                self.engine.add_request(req)
                            except (ValueError, AssertionError) as e:
                                # validate() ran at admission, so only a
                                # race with a reconfigured engine lands
                                # here — still must answer the client
                                self._loop.call_soon_threadsafe(
                                    self._fail_on_loop, req.req_id, str(e))
                        elif cmd[0] == "cancel":
                            self.engine.cancel(cmd[1])
                        elif cmd[0] == "kv_import":
                            # between steps kv.pools is authoritative (the
                            # engine rebuilds its state pytree from it at
                            # every dispatch), so the mount's scatter is
                            # exactly as safe as an admission-time restore
                            push, conn = cmd[1], cmd[2]
                            try:
                                added = self.engine.import_prefix(
                                    push["tokens"], push["meta"],
                                    b"".join(push["parts"]))
                                reply = {"type": "kv_push",
                                         "id": push["cid"], "ok": True,
                                         "pages": int(push["meta"]
                                                      ["n_pages"]),
                                         "mounted": int(added)}
                            except (ValueError, AssertionError) as e:
                                reply = {"type": "kv_push",
                                         "id": push["cid"], "ok": False,
                                         "error": f"{type(e).__name__}: "
                                                  f"{e}"}
                            self._loop.call_soon_threadsafe(
                                conn.send, reply)
                        elif cmd[0] == "stats":
                            # between-steps = the consistent view: no
                            # slot/page/queue mutation can interleave
                            self._loop.call_soon_threadsafe(
                                self._stats_on_loop, cmd[1],
                                self._engine_stats())
                except queue.Empty:
                    pass
                busy = self.engine.step()
                if not busy:
                    # idle: nothing queued or in flight — sleep until a
                    # command arrives (bounded wait as a safety net)
                    self._wake.wait(timeout=0.5)
                    self._wake.clear()
        except BaseException as e:                     # noqa: BLE001
            self._pump_error = e
            # the black-box moment: the pump thread is dying with the
            # engine state frozen exactly as the failure left it — record
            # the death and freeze one bundle HERE, before the loop-side
            # cleanup mutates anything (routes, inflight)
            import traceback

            err = f"{type(e).__name__}: {e}"
            self.flight.record("pump_death", error=err)
            self._write_bundle("pump_death",
                               error=err + "\n" + traceback.format_exc())
            if self._loop is not None:
                self._loop.call_soon_threadsafe(self._pump_died_on_loop)

    def _pump_died_on_loop(self) -> None:
        """A dead pump strands every accepted request — fail them all so
        no client hangs on a stream that will never finish.  Pending
        consistent-stats round trips must answer too (stale): draining
        them HERE, on the loop thread, closes the TOCTOU where
        _handle_stats checks pump health, the pump dies and drains, and
        only then does the command land in the queue — any such late put
        happens on this thread, so it is either already in the queue now
        or its _handle_stats saw _pump_error set (the pump writes it
        before scheduling this callback) and took the stale path."""
        try:
            while True:
                cmd = self._cmds.get_nowait()     # nobody else reads now
                if cmd[0] == "stats":
                    self._stats_on_loop(cmd[1], None)
                elif cmd[0] == "kv_import":
                    cmd[2].send({"type": "kv_push", "id": cmd[1]["cid"],
                                 "ok": False, "error": "engine pump died"})
        except queue.Empty:
            pass
        for rid in list(self._routes):
            self._fail_on_loop(rid, f"engine pump died: "
                                    f"{type(self._pump_error).__name__}: "
                                    f"{self._pump_error}")
        if self._crashed is not None:
            self._crashed.set()

    # -- the flight recorder / postmortem bundles --------------------------
    async def _wedge_watchdog(self) -> None:
        """Loop-side wedge detector: when the pump is ALIVE but its beat
        age crosses `wedge_threshold_s`, record a wedge event and freeze
        one postmortem bundle (engine reads are stale-ok — the pump is
        stuck, not racing).  Re-arms when the beat recovers, so a flapping
        engine produces one bundle per episode, not one per poll."""
        period = max(0.05, min(1.0, self.wedge_threshold_s / 4.0))
        while True:
            await asyncio.sleep(period)
            age = self.pump_last_step_age()
            # pump_alive() is False once _pump_error is set: a DEAD pump
            # already froze its own pump_death bundle — the watchdog must
            # not stack a wedge bundle on top of it
            if self.pump_alive() and age > self.wedge_threshold_s:
                if not self._wedge_dumped:
                    self._wedge_dumped = True
                    self.flight.record("wedge", age_s=round(age, 3),
                                       step=(self._pump_beat or (0, -1))[1])
                    self._write_bundle(
                        "wedge", error=f"pump wedged: last beat "
                                       f"{age:.1f}s ago "
                                       f"(threshold "
                                       f"{self.wedge_threshold_s:g}s)")
            elif age >= 0.0 and age <= self.wedge_threshold_s:
                self._wedge_dumped = False

    def _engine_snapshot(self) -> dict:
        """Engine state for a bundle: per-slot occupancy, queued request
        ids, pool accounting.  Stale-ok reads from whatever thread dumps
        (the pump is dead or wedged in every trigger path); a racing
        mutation degrades one field to an error string, never the dump."""
        eng = self.engine

        def _safe(fn):
            try:
                return fn()
            except Exception as e:             # noqa: BLE001 — see above
                return f"snapshot_error: {type(e).__name__}: {e}"

        return {
            "slots": _safe(lambda: [
                None if sl is None else {
                    "slot": i, "req_id": str(sl.req.req_id),
                    "pos": int(sl.pos), "generated": int(sl.gen),
                    "max_new": int(sl.req.max_new),
                    "replay_until": int(sl.replay_until),
                } for i, sl in enumerate(list(eng.slots))]),
            "queued": _safe(lambda: [str(r.req_id)
                                     for r in list(eng.queue)]),
            "inflight_routes": _safe(lambda: [str(r)
                                              for r in list(self._routes)]),
            "pages_in_use": _safe(lambda: int(eng.kv.pages_in_use)),
            "free_pages": _safe(lambda: int(eng.kv.free_page_count)),
            "num_pages": int(eng.kv.num_pages),
            "page_size": int(eng.kv.page_size),
            "num_slots": len(eng.slots),
            "tp_shards": int(eng.tp),
            "kv_pool_bytes_per_shard": _safe(
                lambda: int(eng.kv.pool_bytes_per_shard)),
            "n_decode_steps": eng.n_decode_steps,
            "tokens_generated": eng.tokens_generated,
            "n_preemptions": eng.n_preemptions,
            "n_cancelled": eng.n_cancelled,
            "n_expired": eng.n_expired,
            "speculation": _safe(lambda: {
                "spec_k": eng.spec_k,
                "drafter": eng.drafter_kind,
                "dynamic": bool(eng.spec_dynamic),
                "draft_steps": eng.n_draft_steps,
                "steps": eng.n_spec_steps,
                "chains": eng.n_spec_chains,
                "drafted": eng.n_spec_drafted,
                "accepted": eng.n_spec_accepted,
                "tokens": eng.n_spec_tokens,
                "accept_rate": round(eng.spec_accept_rate, 4),
                # per-slot dynamic-k state: the learned accept EWMA each
                # live slot steers its draft depth by (null = cold/idle)
                "slot_accept_ewma": [
                    None if sl is None or sl.accept_ewma is None
                    else round(float(sl.accept_ewma), 4)
                    for sl in eng.slots],
            }),
            "prefix_cache": _safe(lambda: {
                "enabled": eng.prefix is not None,
                "nodes": eng.prefix.n_nodes if eng.prefix else 0,
                "cached_pages": int(eng.kv.cached_page_count),
                "shared_pages_in_use": int(eng.kv.shared_pages_in_use),
                "private_pages_in_use": int(eng.kv.private_pages_in_use),
                "hits": eng.n_prefix_hits,
                "misses": eng.n_prefix_misses,
                "tokens_saved": eng.prefill_tokens_saved,
                "evictions": eng.prefix.n_evictions if eng.prefix else 0,
                "cow": int(eng.kv.n_cow),
                # KV spill tier (docs/serving.md): host-resident pages/
                # bytes + the spill/restore lifecycle counters
                "spill_bytes_budget": int(eng.kv.spill_bytes_budget),
                "host_pages": int(eng.kv.host_page_count),
                "spill_bytes": int(eng.kv.host_bytes),
                "spilled_pages": int(eng.kv.n_spilled),
                "restored_pages": int(eng.kv.n_restored),
                "host_evicted_pages": int(eng.kv.n_host_evicted),
                "restore_hits": eng.n_restore_hits,
                "restore_tokens_saved": eng.restore_tokens_saved,
            }),
            "compile_watch": get_compile_watch().snapshot(),
            "hbm": hbm_snapshot(params=eng.params, kv=eng.kv),
        }

    def _config_snapshot(self) -> dict:
        return {
            "host": self.host, "port": self.port,
            "max_inflight": self.max_inflight,
            "num_slots": len(self.engine.slots),
            "page_size": int(self.engine.kv.page_size),
            "num_pages": int(self.engine.kv.num_pages),
            "capacity_tokens": int(self.engine.kv.capacity_tokens),
            "prefix_cache": self.engine.prefix is not None,
            "spill_bytes_budget": int(self.engine.kv.spill_bytes_budget),
            "tp_shards": int(self.engine.tp),
            "spec_k": int(self.engine.spec_k),
            "spec_dynamic": bool(self.engine.spec_dynamic),
            "drafter": self.engine.drafter_kind,
            "decode_steps": int(self.engine.decode_steps),
            "decode_mode": self.engine.decode_mode,
            "role": self.role,
            "wedge_threshold_s": self.wedge_threshold_s,
            "postmortem_dir": self.postmortem_dir,
        }

    def _slo_dump(self, fired) -> None:
        """The SLO evaluator's episode hook (sampler thread): freeze the
        bundle with the offending series attached while the pump is
        still ALIVE — the proactive counterpart of the wedge dump, same
        stale-ok snapshot paths."""
        names = ",".join(sorted({str(f.get("slo", "?")) for f in fired}))
        self._write_bundle(f"slo:{names}", error=f"slo firing: {names}")

    def _write_bundle(self, reason: str,
                      error: Optional[str] = None) -> Optional[str]:
        """Freeze one postmortem bundle; returns its path, or None when no
        directory is configured or the dump itself failed (a broken dump
        must never mask the failure being documented)."""
        if not self.postmortem_dir:
            return None
        try:
            path = self.flight.dump(
                self.postmortem_dir, reason,
                spans=self.tracer.snapshot(),
                engine=self._engine_snapshot(),
                metrics=self.metrics.snapshot(),
                config=self._config_snapshot(),
                history=self.history.snapshot(),
                error=error)
            print(f"postmortem bundle ({reason}): {path}", file=sys.stderr,
                  flush=True)
            return path
        except Exception as e:                 # noqa: BLE001
            self._last_dump_error = f"{type(e).__name__}: {e}"
            print(f"postmortem dump failed ({reason}): "
                  f"{self._last_dump_error}", file=sys.stderr, flush=True)
            return None

    # -- engine hooks (pump thread) ----------------------------------------
    def _on_token(self, rid: str, tok: int, idx: int) -> None:
        st = self._routes.get(rid)
        if st is None:
            return
        now = time.monotonic()
        # burst bookkeeping counts EVERY banked token (replays included —
        # within one burst replayed indexes precede fresh ones), so the
        # position within the engine's current ≤k-token burst is exact
        if st.burst_left > 0:
            st.burst_left -= 1
        else:                                  # first token of a new burst
            st.burst_left = max(1, int(self.engine.cur_burst)) - 1
            st.burst_share = -1.0
        if idx >= st.next_idx:                 # fresh, not a preempt replay
            if idx == 0:
                self.stats.get("first_token_latency").add(now - st.t_submit)
            else:
                if st.burst_share < 0.0:
                    # first FRESH token since t_last: the gap since then
                    # covers this token and the burst_left still to come
                    # (all fresh — replays sort first), so each owns an
                    # equal share.  At decode_steps=1 the burst is one
                    # token and this is the classic per-token charge;
                    # at k>1 this keeps token_latency percentiles
                    # comparable across decode_steps settings.
                    st.burst_share = (now - st.t_last) / (st.burst_left + 1)
                self.stats.get("token_latency").add(st.burst_share)
            # t_last advances on FRESH tokens only: replayed (deduped)
            # emissions reach no client, so the first post-replay fresh
            # token must charge the whole preempt+re-prefill+replay stall
            # to token_latency — that stall is exactly what the stats
            # RPC's p99 exists to expose
            st.t_last = now
            st.next_idx = idx + 1
            if st.stream:
                self._loop.call_soon_threadsafe(
                    st.conn.send, {"type": "token", "id": st.cid,
                                   "token": int(tok), "index": int(idx),
                                   "burst": st.burst_left + 1})

    def _on_finish(self, rid: str, toks: np.ndarray, reason: str) -> None:
        # the server owns delivery — keep the engine's archive empty so a
        # long-lived process holds no unbounded result map
        self.engine.results.pop(rid, None)
        self.engine.finish_reasons.pop(rid, None)
        timing = self.engine.finish_timing.pop(rid, None)
        st = self._routes.get(rid)
        if st is None:
            return
        wall = time.monotonic() - st.t_submit
        self.stats.get("request_latency").add(wall)
        if timing is not None:
            # the server-observed request wall time (accept -> finish)
            # rides next to the engine-phase sum: the gap between them is
            # command-queue/pump-pickup latency, and the gap between
            # request_ms and the CLIENT's wall time is the wire + front
            # tier — per-hop attribution with no trace viewer needed
            timing["request_ms"] = round(wall * 1e3, 3)
        if st.push_to is not None and reason in ("stop", "length"):
            # disaggregated prefill: the prompt's pages were just donated
            # (_retire runs _donate before _finish), so the committed
            # prefix is exportable RIGHT HERE on the pump thread; the
            # loop side then ships it and delays the done frame until the
            # push resolves, so the router learns push_ok from `done`.
            # A cancelled/expired prefill finishes NORMALLY — shipping
            # pages nobody will decode would only burn wire and counters.
            export = self.engine.export_prefix(st.prompt)
            self._loop.call_soon_threadsafe(
                self._push_then_finish_on_loop, rid,
                np.asarray(toks).astype(int).tolist(), reason, timing,
                export)
            return
        self._loop.call_soon_threadsafe(
            self._finish_on_loop, rid,
            np.asarray(toks).astype(int).tolist(), reason, timing)

    # -- loop-side completion/error delivery -------------------------------
    def _finish_on_loop(self, rid: str, tokens: list, reason: str,
                        timing: Optional[dict] = None,
                        extra: Optional[dict] = None) -> None:
        st = self._routes.pop(rid, None)
        if st is None:
            return
        st.conn.rids.pop(st.cid, None)
        # accounting settles BEFORE the terminal frame can reach the
        # client: asyncio flushes small writes inside send(), so a client
        # acting on `done` (e.g. polling stats, or a test asserting
        # inflight) must never observe the request still counted
        self._dec_inflight()
        out = {"type": "done", "id": st.cid, "tokens": tokens,
               "reason": reason}
        if timing is not None:
            out["timing"] = timing
        if extra:
            out.update(extra)
        st.conn.send(out)

    # -- the kv_push sender (prefill side, loop thread) --------------------
    def _push_then_finish_on_loop(self, rid: str, tokens: list, reason: str,
                                  timing: Optional[dict],
                                  export) -> None:
        """Ship a finished prefill_only request's committed prefix to its
        decode replica, then deliver the (delayed) done frame carrying
        the push outcome.  Every failure mode — nothing cached, connect
        refused, peer error, timeout — degrades to push_ok:false on the
        done frame; the ROUTER owns the fallback placement."""
        st = self._routes.get(rid)
        if st is None:
            return

        async def _run():
            ok, err, pages, nbytes = False, "nothing cached to ship", 0, 0
            if export is not None:
                xtoks, meta, payload = export
                pages, nbytes = int(meta["n_pages"]), len(payload)
                try:
                    ok, err = await asyncio.wait_for(
                        self._kv_push(st.push_to, st.cid, xtoks, meta,
                                      payload),
                        timeout=self.kv_push_timeout_s)
                except asyncio.TimeoutError:
                    ok, err = False, f"kv_push timed out after " \
                                     f"{self.kv_push_timeout_s:g}s"
                except (OSError, wire.FrameError) as e:
                    # FrameError: the peer closed mid-frame or replied
                    # malformed/over-cap — same degradation as a socket
                    # error, NOT a task-killing exception
                    ok, err = False, f"kv_push failed: {e}"
                except Exception as e:       # noqa: BLE001 — this task is
                    # fire-and-forget: an exception escaping here would
                    # swallow the done frame (the router's prefill leg
                    # hangs with no retry), leak the route, and pin an
                    # inflight slot forever; ANY failure must degrade to
                    # push_ok:false so _finish_on_loop always runs
                    ok, err = False, f"kv_push failed: " \
                                     f"{type(e).__name__}: {e}"
            self._kv_pushes += 1
            self._m_kv_pushes.inc()
            if ok:
                self.flight.record(
                    "kv_ship", pages=pages, bytes=nbytes,
                    dest=f"{st.push_to.get('host')}:"
                         f"{st.push_to.get('port')}")
            else:
                self._kv_push_failures += 1
                self._m_kv_push_fail.inc()
            extra = {"push_ok": ok, "pushed_pages": pages if ok else 0}
            if not ok:
                extra["push_error"] = err
            self._finish_on_loop(rid, tokens, reason, timing, extra=extra)

        self._loop.create_task(_run())

    async def _kv_push(self, push_to: dict, cid, toks, meta: dict,
                       payload: bytes) -> tuple[bool, str]:
        """One outbound kv_push: connect to the decode replica, stream
        the blob as BIN frames chunked under the serving binary-frame cap
        (part 0 carries tokens + meta; the receiver mounts on `last`),
        await the single kv_push reply.  The caller bounds the whole
        exchange with kv_push_timeout_s."""
        frames = _kv_push_frames(cid, toks, meta, payload)
        reader, writer = await asyncio.open_connection(
            str(push_to.get("host")), int(push_to.get("port")))
        try:
            for frame in frames:
                writer.write(frame)
                await writer.drain()
            while True:
                reply = await wire.read_frame(
                    reader, bin_cap=wire.MAX_BIN_PAYLOAD)
                if reply is None:
                    return False, "peer closed during kv_push"
                if reply.get("type") == "kv_push":
                    return (bool(reply.get("ok")),
                            str(reply.get("error", "")))
                if reply.get("type") == "error":
                    return False, str(reply.get("error"))
        finally:
            try:
                writer.close()
            except ConnectionError:
                pass

    def _fail_on_loop(self, rid: str, message: str) -> None:
        st = self._routes.pop(rid, None)
        if st is None:
            return
        st.conn.rids.pop(st.cid, None)
        self._dec_inflight()
        st.conn.send({"type": "error", "id": st.cid, "error": message})

    def _dec_inflight(self) -> None:
        self._inflight -= 1
        if self._inflight == 0 and self._idle is not None:
            self._idle.set()

    # -- connection handling (asyncio side) --------------------------------
    async def _handle(self, reader, writer) -> None:
        conn = _Conn(writer)
        self._conns.add(conn)
        first_frame = True
        try:
            while True:
                try:
                    msg = await wire.read_frame(
                        reader, bin_cap=wire.MAX_BIN_PAYLOAD)
                except wire.FrameError as e:
                    # a malformed FIRST frame is usually a peer speaking the
                    # wrong protocol entirely (an HTTP probe, a bare JSON
                    # line) — name what this socket expects instead of a
                    # bare parse error, so the peer (and the fleet router's
                    # classification path) learns what it reached
                    err = str(e)
                    if first_frame:
                        err += f"; expected the {wire.PROTO_DESC}"
                    conn.send({"type": "error", "error": err})
                    break
                if msg is None:
                    break
                first_frame = False
                try:
                    self._dispatch(conn, msg)
                except Exception as e:         # noqa: BLE001 — protocol
                    # garbage (e.g. an unhashable JSON id) must answer an
                    # error frame, not tear down the connection and every
                    # other request multiplexed on it
                    bad_id = msg.get("id")
                    conn.send({"type": "error",
                               "id": bad_id if isinstance(bad_id, (str, int))
                               else None,
                               "error": f"bad {msg.get('type')!r} frame: "
                                        f"{type(e).__name__}: {e}"})
                try:
                    await writer.drain()
                except ConnectionError:
                    break
        finally:
            conn.dead = True
            self._conns.discard(conn)
            # client went away: everything it still has in flight is a
            # client-initiated cancel — slots and pages must not stay
            # pinned to a dead socket
            for rid in list(conn.rids.values()):
                self._cmds.put(("cancel", rid))
            # half-shipped kv_push blobs die with their connection — the
            # buffered parts must not outlive the peer that was sending
            for key in [k for k in self._kv_parts if k[0] == conn.seq]:
                del self._kv_parts[key]
            self._wake.set()
            try:
                writer.close()
            except ConnectionError:
                pass

    def _dispatch(self, conn: _Conn, msg: dict) -> None:
        t = msg.get("type")
        if t == "generate":
            self._handle_generate(conn, msg)
        elif t == "kv_push":
            self._handle_kv_push(conn, msg)
        elif t == "cancel":
            cid = msg.get("id")
            rid = conn.rids.get(cid) if isinstance(cid, (str, int)) else None
            if rid is not None:
                self._cmds.put(("cancel", rid))
                self._wake.set()
            # unknown/already-finished id: the done frame already answered
        elif t == "stats":
            self._handle_stats(conn, msg)
        elif t == "metrics":
            # answered on the LOOP thread on purpose: the Prometheus view
            # (incl. pump_last_step_age_s) must stay readable while the
            # pump is wedged — engine-derived values are stale-ok reads
            conn.send({"type": "metrics", "text": self.metrics.render(),
                       "content_type": "text/plain; version=0.0.4"})
        elif t == "dump":
            # operator-initiated postmortem: freeze a bundle NOW (loop
            # thread, stale-ok engine reads — works against a wedged or
            # dead pump, which is exactly when an operator wants one)
            self.flight.record("dump_rpc")
            if not self.postmortem_dir:
                conn.send({"type": "error", "id": msg.get("id"),
                           "error": "no postmortem dir configured "
                                    "(ServingServer(postmortem_dir=...) / "
                                    "tools/serve.py --postmortem-dir)"})
                return
            path = self._write_bundle("rpc")
            if path is None:
                # configured but the dump itself failed (disk full, bad
                # permissions, ...) — tell the operator the REAL cause,
                # not "go configure the directory you already configured"
                conn.send({"type": "error", "id": msg.get("id"),
                           "error": f"postmortem dump failed: "
                                    f"{self._last_dump_error}"})
            else:
                conn.send({"type": "dump", "id": msg.get("id"),
                           "path": path,
                           "events": self.flight.recorded,
                           "spans": self.tracer.recorded})
        elif t == "trace":
            # trace collection over the wire (loop thread, stale-ok like
            # `metrics` — snapshot() is safe concurrent with the pump, so
            # this answers even against a wedged engine): the retained
            # span ring plus the process identity a merger needs to put
            # these spans on their own track group, and a perf_counter
            # sample for ping-RTT clock alignment (the span timebase is
            # THIS process's perf_counter epoch).  `enable` flips tracing
            # LIVE (no restart — the operator's "start tracing NOW on the
            # misbehaving replica" move, and the bench overhead probe's
            # same-fleet A/B switch); the flip applies before the
            # snapshot, so enable:false returns the spans it just froze.
            conn.send(trace_reply(self.tracer, msg, "replica",
                                  self.host, self.port))
        elif t == "history":
            # the health plane's time-series pull (loop thread, stale-ok
            # like `metrics`/`trace`: the ring is fed by its own sampler
            # thread and read here under its lock — no pump round trip,
            # no shared lock with any other reply type — so it answers
            # against a wedged pump; staleness shows as last_sample_unix)
            conn.send(history_reply(self.history, msg, "replica",
                                    self.host, self.port))
        elif t == "hello":
            # version/capabilities negotiation: answered on connect so a
            # peer (the fleet router, a ctl, a probing operator) can
            # classify this end before sending work at it.  `page_size`
            # rides along because the router's prefix-affinity index keys
            # on the first page_size-aligned token run — the granularity
            # must match the replica's prefix tree for affinity to pay.
            conn.send(wire.hello_msg(
                "replica",
                server="paddle_tpu_torch-serving",
                capabilities=sorted(["hello", "generate", "cancel", "stats",
                                     "metrics", "dump", "ping", "trace",
                                     "history", "kv_xfer"]),
                role_mode=self.role,
                num_slots=len(self.engine.slots),
                max_inflight=self.max_inflight,
                page_size=int(self.engine.kv.page_size),
                prefix_cache=self.engine.prefix is not None,
                tp_shards=int(self.engine.tp),
                spec_k=int(self.engine.spec_k),
                spec_dynamic=bool(self.engine.spec_dynamic),
                drafter=self.engine.drafter_kind,
                draining=self._draining))
        elif t == "ping":
            conn.send({"type": "pong"})
        else:
            conn.send({"type": "error", "id": msg.get("id"),
                       "error": f"unknown message type {t!r}"})

    def _handle_kv_push(self, conn: _Conn, msg: dict) -> None:
        """Inbound cross-replica KV blob (decode side).  Multi-part BIN
        frames accumulate per (connection, id) — part 0 carries tokens +
        meta and declares the page count, later parts append payload
        bytes, `last` hands the whole blob to the pump for an
        import_prefix mount between steps.  Buffering is bounded twice:
        each accumulation by its DECLARED blob (itself bounded by the
        receiver's own pool size), and the SUM of declared blobs across
        all live accumulations by one pool's worth of bytes — so a peer
        opening many connections (or interleaving many ids) cannot
        buffer multiples of the pool in host RAM.  A sender that
        overruns its declaration, skips part 0, or repeats part 0 for a
        live id is refused immediately — never buffered unboundedly."""
        cid = msg.get("id")
        if not isinstance(cid, (str, int)):
            conn.send({"type": "error", "id": None,
                       "error": "kv_push needs a string or int 'id'"})
            return
        key = (conn.seq, cid)

        def refuse(err: str) -> None:
            self._kv_parts.pop(key, None)
            conn.send({"type": "kv_push", "id": cid, "ok": False,
                       "error": err})

        if self.engine.prefix is None:
            refuse("prefix cache disabled on this replica")
            return
        if self._draining:
            refuse("replica is draining")
            return
        if not self.pump_alive():
            refuse("engine pump is not running")
            return
        payload = msg.get(wire.PAYLOAD_KEY) or b""
        if int(msg.get("seq", 0)) == 0:
            if key in self._kv_parts:
                # a repeated part 0 means the sender's stream is confused
                # — refuse (dropping the half-built blob) rather than
                # silently restarting the accumulation mid-flight
                refuse(f"kv_push part 0 repeated for id {cid!r} while "
                       f"its blob is still accumulating")
                return
            meta = msg.get("meta") or {}
            n = int(meta.get("n_pages", 0))
            if n <= 0 or n >= self.engine.kv.num_pages:
                refuse(f"blob declares {n} pages; this replica's pool "
                       f"holds {self.engine.kv.num_pages}")
                return
            expect = n * self.engine.kv.page_nbytes
            # server-wide budget: total DECLARED bytes across every live
            # accumulation stays under one pool's worth — any single
            # blob fits (it declares < num_pages), so only concurrent
            # pushes that could never all mount anyway are refused
            pending = sum(s["expect"] for s in self._kv_parts.values())
            budget = self.engine.kv.num_pages * self.engine.kv.page_nbytes
            if pending + expect > budget:
                refuse(f"kv_push buffer budget exhausted: {pending} "
                       f"bytes already accumulating, blob declares "
                       f"{expect} more, budget is {budget}")
                return
            self._kv_parts[key] = {
                "cid": cid, "tokens": msg.get("tokens") or [],
                "meta": meta, "parts": [], "bytes": 0,
                "expect": expect}
        st = self._kv_parts.get(key)
        if st is None:
            refuse("kv_push part arrived with no part 0")
            return
        st["parts"].append(payload)
        st["bytes"] += len(payload)
        if st["bytes"] > st["expect"]:
            refuse(f"kv_push accumulated {st['bytes']} bytes, over the "
                   f"{st['expect']}-byte declared blob")
            return
        if msg.get("last"):
            self._kv_parts.pop(key, None)
            self._cmds.put(("kv_import", st, conn))
            self._wake.set()

    def _handle_generate(self, conn: _Conn, msg: dict) -> None:
        cid = msg.get("id")
        if not isinstance(cid, (str, int)):
            # echo whatever id the client sent (it came off the wire, so it
            # is JSON-serializable) — an id-less error frame could never be
            # routed by the client and would stall its collect()
            conn.send({"type": "error", "id": cid,
                       "error": "generate needs a string or int 'id'"})
            return
        if cid in conn.rids:
            conn.send({"type": "error", "id": cid,
                       "error": f"id {cid!r} is already in flight on this "
                                f"connection"})
            return
        if self._pump_error is not None:
            # a dead pump can never serve this — fail fast instead of
            # letting the client block on frames that will never come
            conn.send({"type": "error", "id": cid,
                       "error": f"engine pump died: "
                                f"{type(self._pump_error).__name__}: "
                                f"{self._pump_error}"})
            return
        if self._draining:
            self._m_overload.inc()
            self.flight.record("overload", reason="draining")
            conn.send({"type": "overload", "id": cid, "reason": "draining"})
            return
        if self._inflight >= self.max_inflight:
            # the explicit backpressure contract: never queue unboundedly
            self._m_overload.inc()
            self.flight.record("overload", reason="queue_full",
                               inflight=self._inflight)
            conn.send({"type": "overload", "id": cid, "reason": "queue_full",
                       "inflight": self._inflight,
                       "max_inflight": self.max_inflight})
            return
        if msg.get("prefill_only"):
            # disaggregated prefill: run the prompt through admission
            # (prefill + donation) but generate nothing beyond the one
            # token sampling requires — the router discards it; streaming
            # is forced off so the decode replica's run owns every token
            msg = dict(msg, max_new=1, stream=False)
        try:
            req = self._build_request(conn, cid, msg)
            self.engine.validate(req)
        except (ValueError, AssertionError, TypeError) as e:
            conn.send({"type": "error", "id": cid, "error": str(e)})
            return
        st = _ReqState(conn, cid, msg.get("stream", True))
        if msg.get("prefill_only"):
            push_to = msg.get("push_to")
            st.push_to = push_to if isinstance(push_to, dict) else None
            st.prompt = req.prompt_ids
        self._routes[req.req_id] = st
        conn.rids[cid] = req.req_id
        self._inflight += 1
        self._m_accepted.inc()
        self.flight.record("accept", req=str(req.req_id),
                           inflight=self._inflight)
        self._cmds.put(("add", req))
        self._wake.set()

    def _build_request(self, conn: _Conn, cid, msg: dict) -> Request:
        prompt = np.asarray(msg.get("prompt", []), np.int32)
        deadline = None
        if msg.get("timeout_s") is not None:
            # absolute on the ENGINE clock — the deadline sweep in step()
            # compares against engine.clock(), not the server's wall clock
            deadline = self.engine.clock() + float(msg["timeout_s"])
        # distributed-trace context: a router (or a tracing client)
        # stamps {"trace": {"trace_id", "parent"?}} on the generate frame;
        # adopting it here is what joins the engine's lifecycle spans to
        # the sender's trace (wire.get_trace drops malformed contexts —
        # shared with the pserver's send_grad/barrier adoption).
        trace = wire.get_trace(msg)
        # engine req_ids are namespaced per connection so two clients
        # picking "0" can never collide inside the scheduler; the type tag
        # keeps JSON id 1 and id "1" distinct too (conn.rids already does)
        tag = "i" if isinstance(cid, int) else "s"
        return Request(f"c{conn.seq}:{tag}:{cid}", prompt,
                       max_new=int(msg.get("max_new", 32)),
                       temperature=float(msg.get("temperature", 0.0)),
                       top_k=int(msg.get("top_k", 0)),
                       top_p=float(msg.get("top_p", 0.0)),
                       eos_id=int(msg.get("eos_id", -1)),
                       seed=(None if msg.get("seed") is None
                             else int(msg["seed"])), deadline=deadline,
                       trace=trace)

    def _handle_stats(self, conn: _Conn, msg: dict) -> None:
        """Default path: the engine-state half of the snapshot is built
        BETWEEN STEPS on the pump thread (command-queue round trip), so
        `slots_in_use`/`pages_in_use`/`queue_depth` can never tear across
        a step boundary.  `{"stale_ok": true}` (or a pump that is dead /
        never started) answers immediately from the loop thread with
        GIL-atomic-but-unsynchronized reads — the watchdog's fast path,
        which must not block behind a wedged or absent pump."""
        if msg.get("stale_ok") or not self.pump_alive():
            conn.send(self._stats_msg(engine_part=None))
            return
        self._cmds.put(("stats", conn))
        self._wake.set()

    def _stats_on_loop(self, conn: _Conn, engine_part: Optional[dict]):
        conn.send(self._stats_msg(engine_part=engine_part))

    def _engine_stats(self) -> dict:
        """The engine-owned snapshot half.  Mutually consistent ONLY when
        called on the pump thread between steps; the stale fast path
        calls it from the loop thread and labels the result."""
        eng = self.engine
        return {
            "queue_depth": len(eng.queue),
            "slots_in_use": sum(1 for s in eng.slots if s is not None),
            "num_slots": len(eng.slots),
            "pages_in_use": int(eng.kv.pages_in_use),
            "free_pages": int(eng.kv.free_page_count),
            "num_pages": int(eng.kv.num_pages),
            "decode_steps": eng.n_decode_steps,
            "tokens_generated": eng.tokens_generated,
            "preemptions": eng.n_preemptions,
            "cancelled": eng.n_cancelled,
            "expired": eng.n_expired,
            "prefix_hits": eng.n_prefix_hits,
            "prefix_misses": eng.n_prefix_misses,
            "prefix_tokens_saved": eng.prefill_tokens_saved,
            "prefix_cached_pages": int(eng.kv.cached_page_count),
            "prefix_evictions": (eng.prefix.n_evictions
                                 if eng.prefix else 0),
            # host spill tier: pages parked in host RAM + restore traffic
            "spill_pages": int(eng.kv.host_page_count),
            "spill_bytes": int(eng.kv.host_bytes),
            "spilled_pages_total": int(eng.kv.n_spilled),
            "restored_pages_total": int(eng.kv.n_restored),
            "restore_hits": eng.n_restore_hits,
            "restore_tokens_saved": eng.restore_tokens_saved,
            # cross-replica kv transfer (the disagg plane's operator view)
            "kv_pages_shipped": int(eng.kv.n_exported),
            "kv_pages_received": int(eng.kv.n_imported),
            "kv_mounts": eng.n_kv_mounts,
            "prefill_chunk": eng.prefill_chunk,
            "max_step_tokens": eng.max_step_tokens,
            "prefill_chunks": eng.n_prefill_chunks,
            "mixed_steps": eng.n_mixed_steps,
            # speculative decoding: the A/B-able knobs + the counters the
            # accept rate reconciles from, plus the adaptive state
            # (drafter kind, dynamic-k flag, per-slot learned EWMAs)
            "spec_k": eng.spec_k,
            "spec_drafter": eng.drafter_kind,
            "spec_dynamic": bool(eng.spec_dynamic),
            "spec_draft_steps": eng.n_draft_steps,
            "spec_drafted": eng.n_spec_drafted,
            "spec_accepted": eng.n_spec_accepted,
            "spec_accept_rate": round(eng.spec_accept_rate, 4),
            "spec_slot_accept_ewma": [
                None if sl is None or sl.accept_ewma is None
                else round(float(sl.accept_ewma), 4)
                for sl in eng.slots],
            # multi-step decode: the A/B-able knobs + scan dispatch
            # counters (flushes = boundaries, steps = body iterations)
            "decode_steps_k": eng.decode_steps,
            "decode_mode": eng.decode_mode,
            "scan_steps": eng.n_scan_steps,
            "scan_flushes": eng.n_scan_flushes,
            # sharding: model-axis shard count + per-device pool bytes
            "tp_shards": eng.tp,
            "kv_pool_bytes_per_shard": int(eng.kv.pool_bytes_per_shard),
        }

    def _stats_msg(self, engine_part: Optional[dict]) -> dict:
        # Loop-thread half (admission state, latency percentiles, pump
        # health) merged with the engine half — either the pump-built
        # consistent one, or a fresh stale read (engine_part=None).
        ms = 1e3
        lat = {name: {k: round(v * ms, 3) for k, v in
                      self.stats.percentiles(name, (50.0, 90.0, 99.0)).items()}
               for name in ("request_latency", "first_token_latency",
                            "token_latency")}
        out = {
            "type": "stats",
            "consistent": engine_part is not None,
            "inflight": self._inflight,
            "max_inflight": self.max_inflight,
            "draining": self._draining,
            "role": self.role,
            "kv_pushes": self._kv_pushes,
            "kv_push_failures": self._kv_push_failures,
            "pump_alive": self.pump_alive(),
            "pump_last_step_age_s": round(self.pump_last_step_age(), 3),
            "latency_ms": lat,
        }
        out.update(engine_part if engine_part is not None
                   else self._engine_stats())
        return out
