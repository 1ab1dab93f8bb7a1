"""The fleet router: one wire-protocol front tier over N serving replicas —
the port's copy of paddle_tpu/fleet/router.py (stdlib only).

The serving-side echo of the reference's pserver networking layer
(ProtoServer/LightNetwork — a thin RPC tier fanning many clients over
many servers, PAPER.md layer 5): clients speak to the router EXACTLY as
they speak to one `serving/server.py` replica — same length-prefixed JSON
frames (`serving/wire.py`), same generate/cancel/stats/metrics/dump/ping
message types, per-token streaming preserved — and the router multiplexes
them across N engine-pump replicas (separate processes/hosts running
`python -m paddle_tpu_torch.tools.serve`, or the JAX package's serve).
Placement state lives HERE, in a thin restartable tier, never in the
replicas (the PS-vs-graph lesson of arXiv:1605.08695): losing the router
loses an affinity index worth a few cold prefills, nothing
correctness-bearing.

Architecture — ONE asyncio loop owns everything (no pump thread: the
router computes nothing):

  * one persistent multiplexed backend connection per replica, opened at
    join with a `hello` handshake that CLASSIFIES the peer (a non-replica
    answering the hello — or failing to — is refused);
  * a background POLLER sends each replica `{"stats", stale_ok: true}`
    every `poll_interval_s` — stale-ok so the poll keeps answering while
    a replica's pump is wedged, which is exactly when the circuit breaker
    below needs the data.  The poll doubles as the heartbeat: a replica
    missing `heartbeat_misses` consecutive polls (or dropping its backend
    connection) LEAVES the fleet;
  * KV-aware placement (`fleet/policy.py`): prefix-affinity first (the
    first page_size-aligned token run steers shared-prefix traffic to the
    replica already holding those KV pages, so PR 7's prefix cache hits
    under fan-out), least-loaded otherwise (load fraction of the
    admission cap, then KV page occupancy);
  * per-replica CIRCUIT BREAKING: polled `pump_last_step_age_s` past
    `wedge_age_s` (or `pump_alive` false) opens the circuit — placement
    stops, not-yet-streamed requests are cancelled there and retried
    elsewhere — and a recovering beat closes it;
  * transparent RETRY on replica death: a request whose client has seen
    ZERO streamed tokens is re-sent verbatim to a surviving replica (same
    prompt/knobs/seed → bit-identical tokens); one that already streamed
    gets an honest error frame (re-running it could emit a divergent
    stream mid-flight);
  * fleet-level OVERLOAD SHEDDING: when every healthy replica is
    saturated (router-tracked outstanding + polled external traffic at
    the replica's admission cap) the router answers `overload`
    immediately — it never queues, so it can never queue unboundedly;
  * drain-aware ops (`fleet/ctl.py`): drain marks a replica unplaceable
    while its in-flight work finishes, which is the first half of the
    rolling-restart runbook (docs/serving.md "Fleet").

Observability: flight events (`replica_join`/`replica_leave`/`route`/
`retry`/`shed` + broken/recovered/fleet_unhealthy) on the process-global
recorder, a strict metrics registry behind the `metrics` frame
(fleet_* rows in obs.metrics.CATALOG), and a postmortem bundle frozen
the moment the WHOLE fleet goes unhealthy — `obs/flight.py` reused
unchanged.

Stdlib-only: the router imports no torch (it can run on a box with no
card, in front of replicas that have them).
"""

from __future__ import annotations

import asyncio
import sys
import threading
import time
from typing import Optional

from paddle_tpu_torch.fleet import replica as rep
from paddle_tpu_torch.fleet.policy import DISAGG, PlacementPolicy
from paddle_tpu_torch.fleet.replica import Replica, ReplicaTable
from paddle_tpu_torch.obs import (MetricsRegistry, statset_collector,
                                  tracer_collector)
from paddle_tpu_torch.obs.flight import flight_collector, get_flight_recorder
from paddle_tpu_torch.obs.slo import SloEvaluator, default_router_slos
from paddle_tpu_torch.obs.timeseries import (HistorySampler, MetricHistory,
                                             history_collector,
                                             history_reply, merge_history)
from paddle_tpu_torch.obs.trace import (get_tracer, new_span_id,
                                        new_trace_id, trace_reply)
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.utils.stat import StatSet


#: one client connection (the router's client face): the SAME slow-reader
#: severing frame connection the replica server uses — shared via wire.py
#: so the backpressure discipline can never drift between the two front
#: ends (conn.rids maps client id -> router grid here)
_ClientConn = wire.FrameConn


class _RoutedReq:
    """One accepted generate, across however many placements it takes."""

    __slots__ = ("conn", "cid", "msg", "grid", "rid", "stream", "streamed",
                 "retries", "t_submit", "trace_id", "span_id",
                 "client_parent", "t0", "t_last_tok", "burst_left",
                 "burst_share", "phase", "decode_rid", "disagg_pages")

    def __init__(self, conn, cid, msg, grid):
        self.conn = conn
        self.cid = cid
        self.msg = msg                 # the original frame, resent verbatim
        self.grid = grid               # router-global id (re-minted on retry
        self.rid = None                # so a stale replica's late frames
        self.stream = bool(msg.get("stream", True))   # can never route)
        self.streamed = 0              # token frames the CLIENT has seen
        self.retries = 0
        # disaggregated prefill/decode (docs/serving.md): "prefill" while
        # the prefill_only leg is in flight at a prefill-tier replica;
        # its done frame then routes the ORIGINAL msg to decode_rid (the
        # replica the kv_push mounted the prompt's pages on) — or falls
        # back to colocated placement when the push failed
        self.phase = None              # None | "prefill"
        self.decode_rid = None         # planned decode replica
        self.disagg_pages = 0          # pages shipped for this request
        self.t_submit = time.monotonic()
        # burst-aware relay inter-token latency (multi-step decode): a
        # replica running decode_steps=k relays ≤k token frames back to
        # back, each stamped with `burst` = fresh tokens remaining in its
        # burst including itself — the router divides the inter-burst
        # arrival gap by the burst size so relay ITL percentiles stay
        # comparable across decode_steps settings (one arrival is k
        # tokens of progress, not one)
        self.t_last_tok = 0.0          # last relayed-token arrival
        self.burst_left = 0            # burst tokens still to charge
        self.burst_share = 0.0         # per-token share of the burst gap
        # distributed-trace identity, stamped at ingress: one trace_id per
        # request (adopted from the client's frame when it sent one), and
        # the router's ingress span id — the `parent` every router-side
        # span AND the replica's lifecycle spans point back at
        tc = msg.get("trace") if isinstance(msg.get("trace"), dict) else {}
        self.trace_id = tc.get("trace_id") if \
            isinstance(tc.get("trace_id"), str) else new_trace_id()
        # a tracing CLIENT's own span id: the ingress span parents on it,
        # so the client's span stitches above the router's in a merge
        self.client_parent = tc.get("parent") if \
            isinstance(tc.get("parent"), str) else None
        self.span_id = new_span_id()
        self.t0 = time.perf_counter()  # ingress-span base (tracer timebase)


class _Backend:
    """One persistent multiplexed connection router -> replica."""

    def __init__(self, router: "FleetRouter", replica: Replica):
        self.router = router
        self.replica = replica
        self.reader = None
        self.writer = None
        self.dead = False
        self.expected_down = False     # intentional close (leave/shutdown):
        self._task = None              # skip the death-handling path
        # one outstanding router-originated RPC per REPLY TYPE (stats/
        # metrics/trace carry no ids the replica echoes back usefully on
        # a multiplexed backend connection, so the reply type IS the
        # correlation key); one lock PER TYPE — a slow metrics/trace
        # collection must never hold up the heartbeat stats poll, whose
        # cadence is the dead-replica detector
        self._rpc_futs: dict[str, asyncio.Future] = {}
        self._rpc_locks: dict[str, asyncio.Lock] = {}

    async def connect(self, timeout_s: float = 20.0) -> dict:
        """Open + hello handshake; returns the replica's hello reply.
        Raises on a peer that is not a serving replica — the router must
        classify what it is about to route traffic at."""
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection(self.replica.host, self.replica.port),
            timeout_s)
        try:
            self.writer.write(wire.encode({"type": "hello"}))
            msg = await asyncio.wait_for(wire.read_frame(self.reader),
                                         timeout_s)
            if not isinstance(msg, dict) or msg.get("type") != "hello" \
                    or msg.get("role") != "replica":
                got = None if not isinstance(msg, dict) else \
                    (msg.get("role") or msg.get("type") or
                     msg.get("error", "")[:80])
                raise ConnectionError(
                    f"peer at {self.replica.addr} is not a serving "
                    f"replica (hello answered {got!r}; expected role "
                    f"'replica' — is this a router, or something else "
                    f"entirely?)")
        except BaseException:
            # EVERY handshake failure closes the socket — a silent
            # non-replica peer that times out here would otherwise leak
            # one fd per JOINING retry for the life of the router
            self.writer.close()
            raise
        self._task = asyncio.get_running_loop().create_task(
            self._read_loop())
        return msg

    def send(self, msg: dict) -> bool:
        if self.dead or self.writer is None or self.writer.is_closing():
            return False
        try:
            self.writer.write(wire.encode(msg))
            return True
        except (ConnectionError, RuntimeError):
            self.dead = True
            return False

    async def rpc(self, msg: dict, reply_type: str,
                  timeout_s: float) -> Optional[dict]:
        """One router-originated round trip correlated by reply type
        (stats poll, metrics aggregation, trace collection).  Returns
        None on a dead connection or timeout — callers treat that as
        'replica did not answer', never an error."""
        lock = self._rpc_locks.get(reply_type)
        if lock is None:
            lock = self._rpc_locks[reply_type] = asyncio.Lock()
        async with lock:
            fut = asyncio.get_running_loop().create_future()
            self._rpc_futs[reply_type] = fut
            if not self.send(msg):
                return None
            try:
                return await asyncio.wait_for(fut, timeout_s)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                return None
            finally:
                if self._rpc_futs.get(reply_type) is fut:
                    del self._rpc_futs[reply_type]

    async def poll_stats(self, timeout_s: float) -> Optional[dict]:
        """One stale-ok stats round trip (the heartbeat probe)."""
        return await self.rpc({"type": "stats", "stale_ok": True},
                              "stats", timeout_s)

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await wire.read_frame(self.reader)
                if msg is None:
                    break
                self.router._on_backend_frame(self.replica, self, msg)
        except (wire.FrameError, ConnectionError):
            pass
        finally:
            self.dead = True
            for fut in list(self._rpc_futs.values()):
                if not fut.done():
                    fut.set_result(None)
            if not self.expected_down:
                self.router._backend_lost(self.replica, self)

    def close(self, expected: bool = True) -> None:
        self.expected_down = self.expected_down or expected
        self.dead = True
        if self.writer is not None:
            try:
                self.writer.close()
            except (ConnectionError, RuntimeError):
                pass

    def abort(self) -> None:
        """Hard RST — the 'replica host vanished' path (tests use this to
        make a replica die abruptly without the graceful-close frames a
        drain would send)."""
        self.expected_down = False
        self.dead = True
        if self.writer is not None:
            try:
                self.writer.transport.abort()
            except (ConnectionError, RuntimeError):
                pass


class FleetRouter:
    """Front-tier router over N serving replicas (see module docstring).

    >>> rt = FleetRouter(port=0, replicas=[("127.0.0.1", 8431),
    ...                                    ("127.0.0.1", 8432)])
    >>> host, port = rt.start_background()
    >>> # clients now use serving/client.py against (host, port)
    >>> rt.stop_background(drain=True)
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 replicas=(), policy: str = "affinity",
                 affinity_capacity: int = 8192,
                 poll_interval_s: float = 0.5,
                 heartbeat_misses: int = 10,
                 wedge_age_s: float = 30.0,
                 retry_limit: int = 2,
                 disagg_min_prompt: int = 0,
                 postmortem_dir: Optional[str] = None,
                 tracer=None,
                 history_resolution_s: float = 5.0,
                 history_retention_s: float = 1800.0,
                 slo_specs=None):
        self.host = host
        self.port = port
        # router-side distributed tracing: every router action for a
        # traced request (ingress, placement, token relay, retry, shed)
        # records on this ring carrying the request's trace_id, so a
        # merged trace threads client -> router -> replica.  Off by
        # default like every tracer; `tracer=` gives an in-process
        # embedder (tests, bench) a private ring.
        self.tracer = tracer if tracer is not None else get_tracer()
        self._initial = [(h, int(p)) for h, p in replicas]
        self.table = ReplicaTable()
        self.policy = PlacementPolicy(policy, window=0,
                                      capacity=affinity_capacity)
        self.poll_interval_s = float(poll_interval_s)
        self.heartbeat_misses = int(heartbeat_misses)
        self.wedge_age_s = float(wedge_age_s)
        self.retry_limit = int(retry_limit)
        # disaggregated prefill/decode: prompts at least this long place
        # on a prefill-tier replica first (kv_push to the chosen decode
        # replica, then the real generate follows).  0 = auto (one
        # affinity window, i.e. one KV page — the smallest prefix worth
        # shipping); negative disables disagg placement entirely.  Only
        # fires while BOTH a prefill-role and a decode-role replica are
        # placeable; everything else places colocated as before.
        self.disagg_min_prompt = int(disagg_min_prompt)
        self.postmortem_dir = postmortem_dir
        self._last_dump_error = "unknown"
        self.flight = get_flight_recorder()
        self.flight.enabled = True
        # router-side latency stats (utils/stat.py): today one stat —
        # relay_token_latency, the burst-honest inter-token gap clients
        # actually observed at the router tier
        self.stats = StatSet("fleet_router")
        self._routes: dict[str, _RoutedReq] = {}
        self._seq = 0
        self._draining = False
        self._unhealthy_dumped = False
        self._conns: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._poll_task = None
        self._dump_task = None        # in-flight fleet_unhealthy dump
        self._idle: Optional[asyncio.Event] = None
        self._closed: Optional[asyncio.Event] = None
        self._bg_thread: Optional[threading.Thread] = None
        self._init_metrics()
        # the health plane (obs/timeseries.py + obs/slo.py): the router
        # records its OWN fleet_* series only — per-replica series come
        # in over the aggregate `history` fanout, never sampled here —
        # and its SLOs (shed ratio, zero-healthy) burn over them.  The
        # sampler thread reads lock-guarded registry state, so it rides
        # alongside the asyncio loop without touching it.
        self.history = MetricHistory(self.metrics,
                                     resolution_s=history_resolution_s,
                                     retention_s=history_retention_s)
        self.metrics.register_collector(history_collector(self.history))
        self.slo = SloEvaluator(
            self.history,
            default_router_slos() if slo_specs is None else slo_specs,
            flight=self.flight, registry=self.metrics,
            dump_fn=self._slo_dump)
        self.history_sampler = HistorySampler(self.history,
                                              on_sample=self.slo.evaluate)

    # -- metrics -----------------------------------------------------------
    def _init_metrics(self) -> None:
        reg = self.metrics = MetricsRegistry(strict=True)
        self._m_accepted = reg.counter("fleet_requests_accepted_total")
        self._m_placements = reg.counter("fleet_placements_total",
                                         labels=("policy",))
        self._m_retries = reg.counter("fleet_retries_total")
        self._m_sheds = reg.counter("fleet_sheds_total")
        self._m_joins = reg.counter("fleet_joins_total")
        self._m_leaves = reg.counter("fleet_leaves_total")
        # disaggregated prefill/decode accounting (docs/serving.md)
        self._m_kv_pushes = reg.counter("fleet_kv_pushes_total")
        self._m_kv_push_fail = reg.counter("fleet_kv_push_failures_total")
        self._m_kv_fallbacks = reg.counter("fleet_kv_fallbacks_total")
        self._m_kv_pages = reg.counter("fleet_kv_pages_shipped_total")
        for m in (self._m_accepted, self._m_retries, self._m_sheds,
                  self._m_joins, self._m_leaves, self._m_kv_pushes,
                  self._m_kv_push_fail, self._m_kv_fallbacks,
                  self._m_kv_pages):
            m.inc(0.0)     # unlabeled counters render 0, not absent
        reg.gauge("fleet_inflight").set_fn(lambda: float(len(self._routes)))
        reg.gauge("fleet_replicas_registered").set_fn(
            lambda: float(len(self.table)))
        reg.gauge("fleet_replicas_healthy").set_fn(
            lambda: float(self.table.counts()[rep.HEALTHY]))
        reg.gauge("fleet_replicas_draining").set_fn(
            lambda: float(self.table.counts()[rep.DRAINING]))
        reg.gauge("fleet_replicas_broken").set_fn(
            lambda: float(self.table.counts()[rep.BROKEN]))
        reg.gauge("fleet_affinity_keys").set_fn(
            lambda: float(len(self.policy.index)))
        reg.gauge("fleet_draining").set_fn(
            lambda: 1.0 if self._draining else 0.0)
        reg.register_collector(statset_collector(
            self.stats, "fleet_relay_latency_seconds",
            "fleet_relay_latency_count"))
        reg.register_collector(tracer_collector(self.tracer))
        reg.register_collector(flight_collector(self.flight))

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> tuple[str, int]:
        self._loop = asyncio.get_running_loop()
        self._idle = asyncio.Event()
        self._closed = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        for h, p in self._initial:
            # a replica not up yet stays JOINING; the poller keeps
            # retrying the connect, so start order is never a crash
            try:
                await self._join(h, p, keep_on_fail=True)
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                print(f"fleet: replica {h}:{p} not reachable yet ({e}); "
                      f"will keep trying", file=sys.stderr, flush=True)
        self._poll_task = self._loop.create_task(self._poll_loop())
        self.history_sampler.start()
        return self.host, self.port

    async def drain(self) -> None:
        """Stop placing (new generates get overload/draining), let every
        routed request finish, then close."""
        self._draining = True
        if self._routes:
            self._idle.clear()
            await self._idle.wait()
        await self._shutdown()

    async def stop(self) -> None:
        """Hard shutdown: cancel everything routed, then close (replicas
        answer done/cancelled, which drains the route table)."""
        self._draining = True
        for st in list(self._routes.values()):
            r = self.table.get(st.rid)
            if r is not None and r.backend is not None:
                r.backend.send({"type": "cancel", "id": st.grid})
        if self._routes:
            self._idle.clear()
            try:
                await asyncio.wait_for(self._idle.wait(), 30.0)
            except asyncio.TimeoutError:
                for st in list(self._routes.values()):
                    self._finish_error(st, "router stopped")
        await self._shutdown()

    async def _shutdown(self) -> None:
        self.history_sampler.stop()
        if self._poll_task is not None:
            self._poll_task.cancel()
            self._poll_task = None
        if self._dump_task is not None and not self._dump_task.done():
            # a fleet_unhealthy dump in flight (it pulls replica traces
            # asynchronously) must commit before the loop dies — losing
            # the black box to the shutdown race would defeat it
            try:
                await asyncio.wait_for(self._dump_task, 10.0)
            except (asyncio.TimeoutError, Exception):  # noqa: BLE001
                pass
        self._dump_task = None
        for r in list(self.table):
            if r.backend is not None:
                r.backend.close(expected=True)
        # client connections first: since Python 3.12 Server.wait_closed()
        # waits for every connection to close (serving/server.py)
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

    def start_background(self) -> tuple[str, int]:
        started = threading.Event()
        addr: list = []

        async def _amain():
            addr.extend(await self.start())
            started.set()
            await self.wait_closed()

        self._bg_thread = threading.Thread(
            target=lambda: asyncio.run(_amain()),
            name="fleet-router-loop", daemon=True)
        self._bg_thread.start()
        if not started.wait(timeout=60):
            raise RuntimeError("fleet router failed to bind within 60s")
        return addr[0], addr[1]

    def stop_background(self, drain: bool = True, timeout: float = 120):
        if self._loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(
            self.drain() if drain else self.stop(), self._loop)
        fut.result(timeout=timeout)
        if self._bg_thread is not None:
            self._bg_thread.join(timeout=timeout)

    # -- join/leave --------------------------------------------------------
    async def _join(self, host: str, port: int,
                    keep_on_fail: bool = False) -> Replica:
        """Register + connect one replica.  `keep_on_fail` leaves a
        JOINING entry behind on connect failure for the poller to keep
        retrying (the static start()-list path: replicas may come up
        after the router); an explicit ctl join reports the failure and
        leaves no residue."""
        existing = self.table.by_addr(host, port)
        if existing is not None and existing.state != rep.JOINING:
            raise ConnectionError(
                f"{host}:{port} is already registered as "
                f"{existing.rid} ({existing.state})")
        r = existing or self.table.add(host, port)
        try:
            await self._connect_replica(r)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            if not keep_on_fail and existing is None:
                self.table.drop(r.rid)
            raise
        return r

    async def _connect_replica(self, r: Replica) -> None:
        backend = _Backend(self, r)
        hello = await backend.connect()
        r.hello = hello
        r.backend = backend
        r.poll_fails = 0
        r.state = rep.DRAINING if r.drain_requested else rep.HEALTHY
        if self.policy.index.window == 0 and r.page_size:
            # adopt the fleet's page size for the affinity granularity
            # from the first replica's hello (homogeneous fleets — a
            # mixed-page-size fleet would shard its own prefix cache)
            self.policy.set_window(r.page_size)
        self._m_joins.inc()
        self.flight.record("replica_join", replica=r.rid, addr=r.addr,
                           num_slots=hello.get("num_slots"),
                           max_inflight=hello.get("max_inflight"))
        self._unhealthy_dumped = False

    def _leave(self, rid: str, why: str) -> Optional[Replica]:
        """Remove a replica; retry its unstreamed requests elsewhere."""
        r = self.table.drop(rid)
        if r is None:
            return None
        if r.backend is not None:
            r.backend.close(expected=True)
        dropped = self.policy.index.drop_replica(rid)
        self._m_leaves.inc()
        self.flight.record("replica_leave", replica=rid, addr=r.addr,
                           why=why, pending=len(r.pending),
                           affinity_keys_dropped=dropped)
        for grid in sorted(r.pending):
            st = self._routes.get(grid)
            if st is not None:
                self._requeue(st, why=f"replica {rid} {why}")
        r.pending.clear()
        self._fleet_health_check()
        return r

    def _backend_lost(self, r: Replica, backend: _Backend) -> None:
        """Reader task saw EOF/reset on a connection we did not close —
        the replica (or the path to it) died."""
        if self.table.get(r.rid) is not r or r.backend is not backend:
            return
        self._leave(r.rid, "connection_lost")

    # -- the poller (heartbeat + circuit breaker) --------------------------
    async def _poll_loop(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval_s)
            for r in list(self.table):
                if r.polling:
                    continue
                r.polling = True
                asyncio.get_running_loop().create_task(self._poll_one(r))

    async def _poll_one(self, r: Replica) -> None:
        try:
            if self.table.get(r.rid) is not r:
                return
            if r.state == rep.JOINING:
                # a statically-configured replica that was not up at
                # start(): keep attempting the connect+hello
                try:
                    await self._connect_replica(r)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    pass
                return
            if r.backend is None or r.backend.dead:
                return                 # the death path owns this one
            stats = await r.backend.poll_stats(
                timeout_s=max(0.05, self.poll_interval_s * 0.9))
            if self.table.get(r.rid) is not r:
                return
            if stats is None:
                r.poll_fails += 1
                if r.poll_fails >= self.heartbeat_misses:
                    self._leave(r.rid, "heartbeat_expired")
                return
            r.absorb_poll(stats)
            why = r.pump_wedged(self.wedge_age_s)
            if why and r.state in (rep.HEALTHY, rep.DRAINING):
                self._break_replica(r, why)
            elif not why and r.state == rep.BROKEN:
                self._recover_replica(r)
        finally:
            r.polling = False

    def _break_replica(self, r: Replica, why: str) -> None:
        """Open the circuit on a wedged pump: stop placing, cancel+retry
        the requests its clients have seen nothing of (the wedged pump
        cannot be streaming them anyway), leave streamed ones pinned —
        they resume if the wedge clears."""
        r.state = rep.BROKEN
        r.broken_reason = why
        self.flight.record("replica_broken", replica=r.rid, why=why)
        for grid in sorted(r.pending):
            st = self._routes.get(grid)
            if st is not None and st.streamed == 0:
                # best-effort cancel at the broken replica (processed
                # whenever its pump unwedges); the retry mints a fresh
                # grid, so a late done/cancelled frame routes nowhere
                r.backend.send({"type": "cancel", "id": grid})
                r.pending.discard(grid)
                self._requeue(st, why=f"replica {r.rid} circuit open "
                                      f"({why})")
        self._fleet_health_check()

    def _recover_replica(self, r: Replica) -> None:
        r.state = rep.DRAINING if r.drain_requested else rep.HEALTHY
        r.broken_reason = ""
        self.flight.record("replica_recovered", replica=r.rid)
        self._unhealthy_dumped = False

    def _fleet_health_check(self) -> None:
        """Freeze ONE postmortem bundle per total-fleet-unhealthy episode
        (zero healthy replicas while any are registered) — the black-box
        moment for the fleet tier, mirroring the replica server's
        pump-death dump.  The dump itself runs as a task so it can first
        pull span snapshots from the still-connected (wedged/draining)
        replicas — a fleet_unhealthy bundle is cross-process."""
        counts = self.table.counts()
        if counts[rep.HEALTHY] > 0 or not self.table.ever_registered:
            return
        if self._unhealthy_dumped:
            return
        self._unhealthy_dumped = True
        self.flight.record("fleet_unhealthy", counts=counts,
                           inflight=len(self._routes))
        err = (f"no healthy replicas "
               f"({len(self.table)} registered: {counts})")
        if self._loop is not None and self._loop.is_running():
            self._dump_task = self._loop.create_task(
                self._dump_unhealthy(err))
        else:
            self._write_bundle("fleet_unhealthy", error=err)

    async def _dump_unhealthy(self, error: str) -> None:
        self._write_bundle("fleet_unhealthy", error=error,
                           replica_traces=await
                           self._collect_replica_traces())

    async def _collect_replica_traces(self, timeout_s: float = 2.0) -> dict:
        """Span-ring snapshots from every replica whose backend
        connection still answers (a BROKEN replica's loop thread does —
        the trace RPC is loop-side like stats stale_ok; a dead one is
        skipped).  Keyed by rid; embedded in the bundle's engine.json."""
        targets = [r for r in self.table
                   if r.backend is not None and not r.backend.dead]
        if not targets:
            return {}
        replies = await asyncio.gather(
            *[r.backend.rpc({"type": "trace"}, "trace", timeout_s)
              for r in targets])
        out = {}
        for r, msg in zip(targets, replies):
            if isinstance(msg, dict):
                out[r.rid] = {"process": msg.get("process"),
                              "recorded": msg.get("recorded"),
                              "dropped": msg.get("dropped"),
                              "spans": msg.get("spans") or []}
        return out

    async def _aggregate_metrics(self) -> tuple[str, int]:
        """The router's render + each answering replica's metrics frame,
        merged into one Prometheus text with replica samples labeled
        `replica="rN"` (families regrouped so HELP/TYPE render once even
        for names both tiers emit, e.g. the tracer/flight accounting)."""
        targets = [r for r in self.table
                   if r.backend is not None and not r.backend.dead]
        replies = await asyncio.gather(
            *[r.backend.rpc({"type": "metrics"}, "metrics", 5.0)
              for r in targets]) if targets else []
        parts = [(None, self.metrics.render())]
        answered = 0
        for r, msg in zip(targets, replies):
            if isinstance(msg, dict) and isinstance(msg.get("text"), str):
                answered += 1
                parts.append((r.rid, msg["text"]))
        return _merge_prometheus(parts), answered

    async def _aggregate_history(self, msg: dict) -> dict:
        """The fleet history view: the router's own series plus every
        answering replica's, each labeled `replica="rN"` — the history
        analog of _aggregate_metrics, over the same per-reply-type rpc
        lane (so a slow fanout never holds up the stats heartbeat)."""
        fwd = {"type": "history"}
        for k in ("last_s", "names"):
            if msg.get(k) is not None:
                fwd[k] = msg[k]
        targets = [r for r in self.table
                   if r.backend is not None and not r.backend.dead]
        replies = await asyncio.gather(
            *[r.backend.rpc(dict(fwd), "history", 5.0)
              for r in targets]) if targets else []
        parts = [(None, self.history.snapshot(
            last_s=msg.get("last_s"), names=msg.get("names")))]
        for r, reply in zip(targets, replies):
            if isinstance(reply, dict) and reply.get("type") == "history":
                parts.append((r.rid, reply))
        return merge_history(parts)

    # -- postmortem --------------------------------------------------------
    def _slo_dump(self, fired: list) -> None:
        """One proactive bundle per SLO episode (obs/slo.py calls this on
        the sampler thread at the no-SLOs -> some-SLOs transition).  Same
        contract as the replica server's: the bundle freezes BEFORE the
        operator asks, with the offending series in history.json."""
        names = ",".join(sorted({str(f.get("slo", "?")) for f in fired}))
        self._write_bundle(f"slo:{names}", error=f"slo firing: {names}")

    def _router_snapshot(self) -> dict:
        return {
            "router": True,
            "replicas": [r.summary() for r in self.table],
            "inflight": len(self._routes),
            "routes": [{"grid": st.grid, "replica": st.rid,
                        "streamed": st.streamed, "retries": st.retries}
                       for st in list(self._routes.values())],
            "affinity_keys": len(self.policy.index),
            "policy": self.policy.mode,
            "draining": self._draining,
        }

    def _config_snapshot(self) -> dict:
        return {
            "host": self.host, "port": self.port, "router": True,
            "policy": self.policy.mode,
            "affinity_window": self.policy.index.window,
            "poll_interval_s": self.poll_interval_s,
            "heartbeat_misses": self.heartbeat_misses,
            "wedge_age_s": self.wedge_age_s,
            "retry_limit": self.retry_limit,
            "disagg_min_prompt": self.disagg_min_prompt,
            "postmortem_dir": self.postmortem_dir,
        }

    def _write_bundle(self, reason: str, error: Optional[str] = None,
                      replica_traces: Optional[dict] = None
                      ) -> Optional[str]:
        if not self.postmortem_dir:
            return None
        try:
            engine = self._router_snapshot()
            if replica_traces:
                # per-replica span snapshots (pulled over the trace RPC
                # just before this dump), tagged with process identity:
                # the fleet bundle holds every tier's view of the episode
                engine["replica_traces"] = replica_traces
            path = self.flight.dump(
                self.postmortem_dir, reason,
                spans=self.tracer.snapshot(),
                engine=engine,
                metrics=self.metrics.snapshot(),
                config=self._config_snapshot(),
                history=self.history.snapshot(),
                error=error)
            print(f"fleet postmortem bundle ({reason}): {path}",
                  file=sys.stderr, flush=True)
            return path
        except Exception as e:             # noqa: BLE001 — a broken dump
            self._last_dump_error = f"{type(e).__name__}: {e}"
            print(f"fleet postmortem dump failed ({reason}): "
                  f"{self._last_dump_error}", file=sys.stderr, flush=True)
            return None

    # -- backend frame routing ---------------------------------------------
    def _on_backend_frame(self, r: Replica, backend: _Backend,
                          msg: dict) -> None:
        t = msg.get("type")
        if t in ("stats", "metrics", "trace", "history"):
            fut = backend._rpc_futs.get(t)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return
        if t in ("pong", "hello"):
            return
        grid = msg.get("id")
        st = self._routes.get(grid) if isinstance(grid, str) else None
        if st is None or st.grid != grid:
            return                     # a retried/finished request's ghost
        if t == "token":
            # `streamed` counts tokens DELIVERED to the client (the retry
            # safety predicate), not tokens the replica produced: a
            # stream=False client has seen nothing no matter how far its
            # replica got, so its request stays transparently retryable
            # (the router always asks the replica to stream — that is how
            # it forwards per-token — but only st.stream clients receive)
            if st.stream:
                st.streamed += 1
                # relay ITL, burst-honest: charge each token of a ≤k
                # burst an equal share of the inter-burst gap.  Kept to
                # arithmetic + one Stat.add (~100ns lock) — per-token
                # loop-thread work beyond that measurably costs tok/s
                # (see the tracer note below).
                now = time.monotonic()
                if st.streamed > 1:
                    if st.burst_left > 0:
                        st.burst_left -= 1
                        self.stats.get("relay_token_latency").add(
                            st.burst_share)
                    else:
                        b = max(1, int(msg.get("burst") or 1))
                        st.burst_share = (now - st.t_last_tok) / b
                        st.burst_left = b - 1
                        self.stats.get("relay_token_latency").add(
                            st.burst_share)
                st.t_last_tok = now
                if self.tracer.enabled and st.streamed == 1:
                    # FIRST-token relay only: the router-side TTFT stitch
                    # point.  A marker per token here would put python
                    # dict+ring work on the loop thread's per-token
                    # critical path (measured ~3-5% tok/s at CPU rates,
                    # blowing the <= 2% tracing budget); the per-token
                    # cadence is already on the replica's engine lane,
                    # and the ingress span carries the relayed count.
                    self.tracer.instant(
                        "relay", track=f"req:{st.trace_id[:12]}",
                        index=msg.get("index"), trace_id=st.trace_id,
                        parent=st.span_id)
                st.conn.send({"type": "token", "id": st.cid,
                              "token": msg.get("token"),
                              "index": msg.get("index")})
        elif t == "done":
            r.pending.discard(grid)
            if st.phase == "prefill":
                self._on_prefill_done(st, msg)
                return
            self._finish(st, {"type": "done", "id": st.cid,
                              "tokens": msg.get("tokens"),
                              "reason": msg.get("reason"),
                              "timing": self._merge_timing(st, msg)})
        elif t == "error":
            r.pending.discard(grid)
            self._finish(st, {"type": "error", "id": st.cid,
                              "error": msg.get("error")})
        elif t == "overload":
            # admission race: the replica filled up (external traffic, or
            # our poll went stale) between placement and arrival — force
            # the saturated view until the next poll tells us better, and
            # try the remaining capacity
            r.pending.discard(grid)
            r.external = max(r.external,
                             r.max_inflight - len(r.pending))
            self._requeue(st, why=f"replica {r.rid} answered overload",
                          count_retry=False)

    def _merge_timing(self, st: _RoutedReq, msg: dict) -> dict:
        """Extend the replica's per-request timing breakdown with the
        router-side attribution: hops (placements) and retries, the
        replica that finally served it, and the router-observed request
        wall — so the `done` frame alone answers "where did this
        request's seconds go" across the fleet."""
        timing = dict(msg.get("timing") or {})
        timing["router"] = {
            "hops": st.retries + 1,
            "retries": st.retries,
            "replica": st.rid,
            "total_ms": round((time.perf_counter() - st.t0) * 1e3, 3),
        }
        if st.disagg_pages:
            timing["router"]["disagg_pages"] = st.disagg_pages
        return timing

    def _finish(self, st: _RoutedReq, frame: dict) -> None:
        self._routes.pop(st.grid, None)
        st.conn.rids.pop(st.cid, None)
        if self.tracer.enabled:
            # the ingress span: the request's whole router-side lifetime,
            # ending at the terminal frame (done/error/overload) — the
            # parent of every place/relay/retry span and of the replica's
            # lifecycle spans
            attrs = {"trace_id": st.trace_id, "span_id": st.span_id,
                     "terminal": frame.get("type"),
                     "streamed": st.streamed, "retries": st.retries}
            if st.client_parent:
                attrs["parent"] = st.client_parent
            self.tracer.add(
                "ingress", st.t0, time.perf_counter() - st.t0,
                track=f"req:{st.trace_id[:12]}", attrs=attrs)
        st.conn.send(frame)
        if not self._routes and self._idle is not None:
            self._idle.set()

    def _finish_error(self, st: _RoutedReq, message: str) -> None:
        self._finish(st, {"type": "error", "id": st.cid, "error": message})

    # -- placement + retry -------------------------------------------------
    def _requeue(self, st: _RoutedReq, why: str,
                 count_retry: bool = True) -> None:
        """Re-place one routed request after its replica failed it.  Only
        a request the CLIENT has seen nothing of may retry — re-running a
        partially-streamed request could splice a divergent stream."""
        self._routes.pop(st.grid, None)
        if st.streamed > 0:
            self._finish_error(
                st, f"{why} after {st.streamed} tokens were already "
                    f"streamed; not retried (a retry would re-stream "
                    f"from the start) — resubmit the request")
            return
        if st.phase == "prefill":
            # the prefill leg died under us (replica left, circuit open,
            # overload race) — a prefill_only request never streams, so
            # the retry below IS the disagg fallback: re-place the
            # ORIGINAL generate colocated and count the degradation
            st.phase = None
            st.decode_rid = None
            self._m_kv_fallbacks.inc()
        if count_retry:
            st.retries += 1
            if st.retries > self.retry_limit:
                self._finish_error(
                    st, f"{why}; retry limit {self.retry_limit} reached")
                return
        candidates = self._decode_candidates(
            [c for c in self.table.placeable() if c.rid != st.rid])
        if not candidates:
            if not count_retry:
                # the replica REFUSED admission (overload race) and nobody
                # else has capacity: that is fleet saturation, and the
                # client must see the retryable `overload` contract —
                # a terminal error frame would turn transient saturation
                # into a hard failure
                self._m_sheds.inc()
                self.flight.record("shed", reason="replica_overload",
                                   inflight=len(self._routes))
                if self.tracer.enabled:
                    self.tracer.instant(
                        "shed", track=f"req:{st.trace_id[:12]}",
                        reason="replica_overload", trace_id=st.trace_id,
                        parent=st.span_id)
                self._finish(st, {"type": "overload", "id": st.cid,
                                  "reason": "fleet_saturated",
                                  "inflight": len(self._routes),
                                  "max_inflight": sum(
                                      r.max_inflight for r in
                                      self.table.in_state(rep.HEALTHY))})
                return
            self._finish_error(
                st, f"{why}; no healthy replica to retry on")
            return
        replica, policy = self.policy.place(st.msg.get("prompt", []),
                                            candidates)
        if count_retry:
            self._m_retries.inc()
            self.flight.record("retry", req=st.grid, to=replica.rid,
                               why=why, attempt=st.retries)
            if self.tracer.enabled:
                self.tracer.instant(
                    "retry", track=f"req:{st.trace_id[:12]}",
                    to=replica.rid, why=why, attempt=st.retries,
                    trace_id=st.trace_id, parent=st.span_id)
        self._send_to(st, replica, policy)

    def _decode_candidates(self, candidates: list) -> list:
        """Placement preference for the DECODE/colocated path: keep
        prefill-role replicas out of it while any other capacity exists
        (their pool is sized for prompt churn, not long residencies) —
        but roles are ADVISORY, so an all-prefill fleet still serves."""
        return [c for c in candidates if c.role != "prefill"] or candidates

    def _send_to(self, st: _RoutedReq, replica: Replica,
                 policy: str, extra: Optional[dict] = None) -> None:
        # anything that can raise runs BEFORE the routing state mutates:
        # an exception after routes/rids/pending were touched would leak
        # a phantom in-flight request (inflated load, drain wedged)
        t_place = time.perf_counter()
        akey = self.policy.index.key_of(st.msg.get("prompt", []))
        # wire-level trace context: the forwarded frame carries the
        # request's trace_id with the router's ingress span as parent —
        # the replica server adopts it (serving/server.py), which is the
        # whole cross-process stitch
        fwd = dict(st.msg, id=None, stream=True,
                   trace={"trace_id": st.trace_id, "parent": st.span_id})
        if extra:
            fwd.update(extra)          # the prefill_only/push_to leg
        grid = f"g{self._seq}"
        self._seq += 1
        fwd["id"] = grid
        st.grid = grid
        st.rid = replica.rid
        self._routes[grid] = st
        st.conn.rids[st.cid] = grid
        replica.pending.add(grid)
        replica.routed_total += 1
        self._m_placements.inc(policy=policy)
        self.flight.record("route", req=grid, replica=replica.rid,
                           policy=policy,
                           akey=None if akey is None else
                           (hash(akey) & 0xFFFFFFFF))
        ok = replica.backend.send(fwd)
        if self.tracer.enabled:
            # placement decision + backend send, as one span: which
            # replica, under which policy, and whether the send stuck
            self.tracer.add(
                "place", t_place, time.perf_counter() - t_place,
                track=f"req:{st.trace_id[:12]}",
                attrs={"replica": replica.rid, "policy": policy,
                       "sent": ok, "trace_id": st.trace_id,
                       "parent": st.span_id})
        if not ok:
            # the connection died under us before the reader task noticed;
            # take the leave path NOW so this request retries immediately
            self._leave(replica.rid, "connection_lost")

    # -- client connection handling ----------------------------------------
    async def _handle(self, reader, writer) -> None:
        conn = _ClientConn(writer)
        self._conns.add(conn)
        first_frame = True
        try:
            while True:
                try:
                    msg = await wire.read_frame(reader)
                except wire.FrameError as e:
                    err = str(e)
                    if first_frame:
                        err += f"; expected the {wire.PROTO_DESC}"
                    conn.send({"type": "error", "error": err})
                    break
                if msg is None:
                    break
                first_frame = False
                try:
                    await self._dispatch(conn, msg)
                except Exception as e:         # noqa: BLE001 — protocol
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
            # a vanished client's in-flight work is a cancel, forwarded to
            # whichever replica holds each request
            for grid in list(conn.rids.values()):
                st = self._routes.get(grid)
                if st is None:
                    continue
                r = self.table.get(st.rid)
                if r is not None and r.backend is not None:
                    r.backend.send({"type": "cancel", "id": grid})
            try:
                writer.close()
            except ConnectionError:
                pass

    async def _dispatch(self, conn: _ClientConn, msg: dict) -> None:
        t = msg.get("type")
        if t == "generate":
            self._handle_generate(conn, msg)
        elif t == "cancel":
            cid = msg.get("id")
            grid = conn.rids.get(cid) if isinstance(cid, (str, int)) \
                else None
            st = self._routes.get(grid) if grid else None
            if st is not None:
                r = self.table.get(st.rid)
                if r is not None and r.backend is not None:
                    r.backend.send({"type": "cancel", "id": st.grid})
        elif t == "stats":
            conn.send(self._stats_msg())
        elif t == "metrics":
            if msg.get("aggregate"):
                # the fleet scrape endpoint: the router's own fleet_*
                # rows plus every reachable replica's families under a
                # `replica` label — one text blob for the whole fleet
                text, answered = await self._aggregate_metrics()
                conn.send({"type": "metrics", "text": text,
                           "aggregate": True, "replicas": answered,
                           "content_type": "text/plain; version=0.0.4"})
            else:
                conn.send({"type": "metrics",
                           "text": self.metrics.render(),
                           "content_type": "text/plain; version=0.0.4"})
        elif t == "trace":
            # the router's own span ring, same shape as a replica's
            # trace reply — trace_dump --pull treats both alike, and
            # `enable` flips router-side tracing live (see server.py)
            conn.send(trace_reply(self.tracer, msg, "router",
                                  self.host, self.port))
        elif t == "history":
            # the health plane's ring (loop-thread, stale-ok — see
            # obs/timeseries.py); `aggregate` fans out to every live
            # replica and merges their series under `replica` labels
            if msg.get("aggregate"):
                body = await self._aggregate_history(msg)
                reply = history_reply(self.history,
                                      {"id": msg.get("id")}, "router",
                                      self.host, self.port)
                reply.update(body)
                reply["aggregate"] = True
                conn.send(reply)
            else:
                conn.send(history_reply(self.history, msg, "router",
                                        self.host, self.port))
        elif t == "dump":
            self.flight.record("dump_rpc", router=True)
            if not self.postmortem_dir:
                conn.send({"type": "error", "id": msg.get("id"),
                           "error": "no postmortem dir configured "
                                    "(FleetRouter(postmortem_dir=...) / "
                                    "tools/fleet_router.py "
                                    "--postmortem-dir)"})
                return
            path = self._write_bundle(
                "rpc", replica_traces=await self._collect_replica_traces())
            if path is None:
                conn.send({"type": "error", "id": msg.get("id"),
                           "error": f"postmortem dump failed: "
                                    f"{self._last_dump_error}"})
            else:
                conn.send({"type": "dump", "id": msg.get("id"),
                           "path": path, "events": self.flight.recorded,
                           "spans": self.tracer.recorded})
        elif t == "hello":
            conn.send(wire.hello_msg(
                "router",
                server="paddle_tpu_torch-fleet-router",
                capabilities=sorted(["hello", "generate", "cancel", "stats",
                                     "metrics", "dump", "ping", "fleet",
                                     "trace", "history"]),
                replicas=len(self.table),
                policy=self.policy.mode,
                page_size=self.policy.index.window,
                draining=self._draining))
        elif t == "ping":
            conn.send({"type": "pong"})
        elif t == "fleet":
            await self._handle_fleet_op(conn, msg)
        else:
            conn.send({"type": "error", "id": msg.get("id"),
                       "error": f"unknown message type {t!r}"})

    def _handle_generate(self, conn: _ClientConn, msg: dict) -> None:
        cid = msg.get("id")
        if not isinstance(cid, (str, int)):
            conn.send({"type": "error", "id": cid,
                       "error": "generate needs a string or int 'id'"})
            return
        if cid in conn.rids:
            conn.send({"type": "error", "id": cid,
                       "error": f"id {cid!r} is already in flight on this "
                                f"connection"})
            return
        prompt = msg.get("prompt", [])
        if not isinstance(prompt, list) or \
                not all(isinstance(t, (int, float)) and
                        not isinstance(t, bool) for t in prompt):
            # shape-check the prompt BEFORE placement: the affinity key
            # and every later retry re-read this frame, and garbage must
            # answer an error frame without ever touching routing state
            # (content validation — lengths, ranges — stays the
            # replica's job; its error frame forwards back as-is)
            conn.send({"type": "error", "id": cid,
                       "error": "generate needs a 'prompt' list of "
                                "token ids"})
            return
        if self._draining:
            self._m_sheds.inc()
            self.flight.record("shed", reason="draining")
            conn.send({"type": "overload", "id": cid, "reason": "draining"})
            return
        candidates = self.table.placeable()
        if not candidates:
            # the fleet-level backpressure contract: every healthy
            # replica saturated (or none registered) answers overload
            # NOW — the router holds no queue, so it cannot hold an
            # unbounded one
            reason = "no_replicas" if len(self.table) == 0 \
                else "fleet_saturated"
            self._m_sheds.inc()
            self.flight.record("shed", reason=reason,
                               inflight=len(self._routes))
            if self.tracer.enabled:
                self.tracer.instant("shed", track="router", reason=reason,
                                    inflight=len(self._routes))
            conn.send({"type": "overload", "id": cid, "reason": reason,
                       "inflight": len(self._routes),
                       "max_inflight": sum(
                           r.max_inflight for r in
                           self.table.in_state(rep.HEALTHY))})
            return
        prompt = msg.get("prompt", [])
        st = _RoutedReq(conn, cid, msg, grid="")
        self._m_accepted.inc()
        plan = self._disagg_plan(prompt, candidates)
        if plan is not None:
            prefill_r, decode_r = plan
            st.phase = "prefill"
            st.decode_rid = decode_r.rid
            self._m_kv_pushes.inc()
            self._send_to(st, prefill_r, DISAGG,
                          extra={"prefill_only": True,
                                 "push_to": {"host": decode_r.host,
                                             "port": decode_r.port}})
            return
        replica, policy = self.policy.place(
            prompt, self._decode_candidates(candidates))
        self._send_to(st, replica, policy)

    def _disagg_plan(self, prompt, candidates) -> Optional[tuple]:
        """(prefill replica, decode replica) for a disaggregated
        placement, or None to place colocated.  Fires only for prompts
        past the threshold while BOTH role tiers have a placeable
        member: the decode replica is chosen FIRST (affinity — its
        prefix tree is where the pushed pages will live, so followers
        sharing the prefix chase it there), the prefill replica
        least-loaded within its tier."""
        if self.disagg_min_prompt < 0:
            return None
        floor = self.disagg_min_prompt or self.policy.index.window
        if floor <= 0 or len(prompt) < floor:
            return None
        prefill_tier = [c for c in candidates if c.role == "prefill"]
        decode_tier = [c for c in candidates if c.role == "decode"]
        if not prefill_tier or not decode_tier:
            return None
        decode_r, _ = self.policy.place(prompt, decode_tier)
        prefill_r = min(prefill_tier, key=lambda r: r.score())
        return prefill_r, decode_r

    def _on_prefill_done(self, st: _RoutedReq, msg: dict) -> None:
        """The prefill leg finished: on a successful kv_push route the
        ORIGINAL generate to the decode replica holding the pages (its
        admission is now a prefix hit); on any failure — push refused,
        decode replica gone/unplaceable, prefill cancelled — degrade
        honestly (fallback colocated, or forward the terminal frame)."""
        self._routes.pop(st.grid, None)
        st.conn.rids.pop(st.cid, None)
        st.phase = None
        reason = msg.get("reason")
        if reason not in ("stop", "length"):
            # the client cancelled (or the deadline fired) during the
            # prefill leg — that terminates the REQUEST, not just the leg
            self._finish(st, {"type": "done", "id": st.cid,
                              "tokens": msg.get("tokens"),
                              "reason": reason,
                              "timing": self._merge_timing(st, msg)})
            return
        ok = bool(msg.get("push_ok"))
        if ok:
            st.disagg_pages = int(msg.get("pushed_pages") or 0)
            self._m_kv_pages.inc(float(st.disagg_pages))
        else:
            self._m_kv_push_fail.inc()
        decode_r = self.table.get(st.decode_rid)
        st.decode_rid = None
        if ok and decode_r is not None and decode_r.state == rep.HEALTHY \
                and not decode_r.saturated():
            self._send_to(st, decode_r, DISAGG)
            return
        # fallback: the push failed, or the decode replica died/filled
        # while the prompt prefilled — place colocated like a both-mode
        # fleet would have (zero client-visible failures: nothing
        # streamed, so the re-place is transparent)
        self._m_kv_fallbacks.inc()
        st.disagg_pages = 0
        candidates = self._decode_candidates(self.table.placeable())
        if not candidates:
            self._m_sheds.inc()
            self.flight.record("shed", reason="disagg_fallback",
                               inflight=len(self._routes))
            self._finish(st, {"type": "overload", "id": st.cid,
                              "reason": "fleet_saturated",
                              "inflight": len(self._routes),
                              "max_inflight": sum(
                                  r.max_inflight for r in
                                  self.table.in_state(rep.HEALTHY))})
            return
        replica, policy = self.policy.place(st.msg.get("prompt", []),
                                            candidates)
        self._send_to(st, replica, policy)

    async def _handle_fleet_op(self, conn: _ClientConn, msg: dict) -> None:
        """Operator control frames (fleet/ctl.py): join/leave/drain/
        undrain/list.  Replies echo `op` (and the request id, if any)."""
        op = msg.get("op")
        base = {"type": "fleet", "op": op}
        if msg.get("id") is not None:
            base["id"] = msg["id"]
        try:
            if op == "join":
                r = await self._join(str(msg["host"]), int(msg["port"]))
                conn.send({**base, "ok": True, "replica": r.rid,
                           "state": r.state})
            elif op == "leave":
                r = self._leave(str(msg["replica"]), "ctl_leave")
                if r is None:
                    raise KeyError(f"no replica {msg.get('replica')!r}")
                conn.send({**base, "ok": True, "replica": r.rid})
            elif op in ("drain", "undrain"):
                r = self.table.get(str(msg.get("replica")))
                if r is None:
                    raise KeyError(f"no replica {msg.get('replica')!r}")
                r.drain_requested = op == "drain"
                if r.state in (rep.HEALTHY, rep.DRAINING):
                    r.state = rep.DRAINING if r.drain_requested \
                        else rep.HEALTHY
                # literal kinds on both branches: the event-table lint
                # (tools/check_metrics_names.py) reads first-arg string
                # literals, so a computed kind could ship undocumented
                if op == "drain":
                    self.flight.record("replica_drain", replica=r.rid)
                else:
                    self.flight.record("replica_undrain", replica=r.rid)
                conn.send({**base, "ok": True, "replica": r.rid,
                           "state": r.state,
                           "pending": len(r.pending)})
            elif op == "list":
                conn.send({**base, "ok": True,
                           "replicas": [r.summary() for r in self.table]})
            else:
                conn.send({**base, "ok": False,
                           "error": f"unknown fleet op {op!r} (know: "
                                    f"join/leave/drain/undrain/list)"})
        except (KeyError, ValueError, TypeError, ConnectionError, OSError,
                asyncio.TimeoutError) as e:
            conn.send({**base, "ok": False,
                       "error": f"{type(e).__name__}: {e}"})

    def _stats_msg(self) -> dict:
        counts = self.table.counts()
        placements = {k[0]: v for k, v in
                      self._m_placements._vals.items()}
        return {
            "type": "stats", "fleet": True,
            "inflight": len(self._routes),
            "draining": self._draining,
            "policy": self.policy.mode,
            "affinity_window": self.policy.index.window,
            "affinity_keys": len(self.policy.index),
            "replicas_registered": len(self.table),
            "replicas_healthy": counts[rep.HEALTHY],
            "replicas_draining": counts[rep.DRAINING],
            "replicas_broken": counts[rep.BROKEN],
            "placements": placements,
            "retries": self._m_retries.value(),
            "sheds": self._m_sheds.value(),
            # disaggregated prefill/decode traffic (docs/serving.md)
            "disagg_min_prompt": self.disagg_min_prompt,
            "kv_pushes": self._m_kv_pushes.value(),
            "kv_push_failures": self._m_kv_push_fail.value(),
            "kv_fallbacks": self._m_kv_fallbacks.value(),
            "kv_pages_shipped": self._m_kv_pages.value(),
            # burst-honest relay inter-token latency (ms): one scanned
            # k-token burst is k tokens of progress, each charged an
            # equal share of the inter-burst gap — comparable across
            # replicas running different decode_steps
            "relay_itl_ms": {k: round(v * 1e3, 3) for k, v in
                             self.stats.percentiles(
                                 "relay_token_latency",
                                 (50.0, 90.0, 99.0)).items()},
            "replicas": [r.summary() for r in self.table],
        }


def _merge_prometheus(parts: list[tuple[Optional[str], str]]) -> str:
    """Merge several Prometheus text expositions into one.

    `parts` is [(replica_label_or_None, text), ...] — the router's own
    render first (unlabeled), then each replica's frame.  Labeled parts
    get `replica="<label>"` injected into every sample, and families are
    REGROUPED so each base name renders exactly one HELP/TYPE pair even
    when both tiers emit it (the tracer/flight accounting does): a
    scraper must never see a family's TYPE declared twice.

    Relies on the renderer's contract (obs/metrics.py render()): samples
    follow their family's HELP/TYPE header contiguously, histogram
    samples (`_bucket`/`_sum`/`_count`) under the base-name header."""
    families: dict = {}            # base -> {"kind", "help", "samples"}
    order: list[str] = []

    def family(base: str) -> dict:
        fam = families.get(base)
        if fam is None:
            fam = families[base] = {"kind": "untyped", "help": "",
                                    "samples": []}
            order.append(base)
        return fam

    for label, text in parts:
        current = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP "):
                base, _, help_ = line[len("# HELP "):].partition(" ")
                fam = family(base)
                fam["help"] = fam["help"] or help_
                current = base
            elif line.startswith("# TYPE "):
                base, _, kind = line[len("# TYPE "):].partition(" ")
                fam = family(base)
                if fam["kind"] == "untyped" and kind:
                    fam["kind"] = kind
                current = base
            elif line.startswith("#"):
                continue
            else:
                head, _, value = line.rpartition(" ")
                if not head:
                    continue
                if label is not None:
                    if head.endswith("}"):
                        head = head[:-1] + f',replica="{label}"}}'
                    else:
                        head = head + f'{{replica="{label}"}}'
                name = head.partition("{")[0]
                base = (current if current and name.startswith(current)
                        else name)
                family(base)["samples"].append(f"{head} {value}")
    lines = []
    for base in order:
        fam = families[base]
        if fam["help"]:
            lines.append(f"# HELP {base} {fam['help']}")
        lines.append(f"# TYPE {base} {fam['kind']}")
        lines.extend(fam["samples"])
    return "\n".join(lines) + ("\n" if lines else "")
