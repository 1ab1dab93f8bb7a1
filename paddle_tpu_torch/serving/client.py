"""Blocking-socket client for the serving front end (serving/server.py) —
the port's copy of paddle_tpu/serving/client.py.

Dependency-light (stdlib sockets + serving/wire.py framing; no torch, no
asyncio): a deploy target or load generator can lift this file plus
wire.py, rewriting the one package import.  It drives a replica or a
fleet router of either package.  One connection multiplexes many
requests: `submit()` fires a generate, `collect()` routes the
interleaved token/done frames back per request, `cancel()` can be sent
while streams are in flight — the shape tests/test_torch_server.py and
tools/serve.py's --client mode drive.

>>> with ServingClient(host, port) as c:
...     toks, reason = c.generate([2, 7, 9], max_new=16, eos_id=3)
"""

from __future__ import annotations

import random
import socket
import time
from typing import Callable, Optional

from paddle_tpu_torch.serving import wire

#: connect() errors worth retrying: the server is restarting (rolling
#: restart's SIGTERM→rebind window shows as ECONNREFUSED — an immediate,
#: cheap failure) or shed the half-open connection (reset/abort).
#: Deliberately NOT the generic OSError (a bad hostname or unroutable
#: address must fail fast) and NOT TimeoutError: a SYN-blackholed host
#: already burned the FULL I/O timeout discovering nothing — retrying
#: would multiply that by the attempt count.
_RETRYABLE_CONNECT = (ConnectionRefusedError, ConnectionResetError,
                      ConnectionAbortedError)


#: what each hello role is served by — used to make a wrong-port connect
#: name BOTH ends instead of failing with a generic frame error
_ROLE_TOOLS = {"replica": "a serving replica (tools/serve.py)",
               "router": "a fleet router (tools/fleet_router.py)",
               "pserver": "a parameter server (tools/pserver.py)"}


def _role_desc(role) -> str:
    return _ROLE_TOOLS.get(role, f"an unknown peer (role {role!r})")


def connect_with_backoff(host: str, port: int, timeout: float,
                         attempts: int = 5, backoff_s: float = 0.05,
                         backoff_max_s: float = 2.0,
                         jitter: Optional[random.Random] = None,
                         expect_role: Optional[str] = None):
    """create_connection with bounded jittered exponential backoff on
    ECONNREFUSED/reset — a replica mid-rolling-restart must not surface
    as an instant client failure.  `attempts` caps the total tries; the
    final failure re-raises the last connect error with an actionable
    message (same OSError family, so existing `except OSError` callers
    keep working).

    `expect_role` additionally runs the `hello` handshake on the fresh
    socket and verifies the peer's advertised role ("replica" / "router"
    / "pserver") — a wrong-port connect (e.g. a trainer pointed at a
    serving replica) then fails with an error NAMING both roles instead
    of a generic frame error several RPCs later.  With `expect_role`
    set, returns `(socket, hello_reply)`; without, the bare socket."""
    attempts = max(1, int(attempts))
    jitter = jitter or random.Random()
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    sock: Optional[socket.socket] = None
    for i in range(attempts):
        if i:
            # full jitter on an exponential base: concurrent clients
            # retrying a restarting server must not stampede in lockstep
            delay = min(backoff_max_s, backoff_s * (2.0 ** (i - 1)))
            time.sleep(delay * (0.5 + 0.5 * jitter.random()))
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            break
        except _RETRYABLE_CONNECT as e:
            last = e
    if sock is None:
        waited = time.monotonic() - t0
        raise type(last)(
            f"connect to {host}:{port} failed after {attempts} attempts "
            f"over {waited:.1f}s ({type(last).__name__}: {last}) — the "
            f"server is down, still binding after a restart, or the "
            f"address is wrong; raise ServingClient(connect_attempts=...) "
            f"if its restart drain takes longer than the backoff window"
        ) from last
    if expect_role is None:
        return sock
    try:
        wire.write_frame_sync(sock, {"type": "hello"})
        reply = wire.read_frame_sync(sock)
    except (wire.FrameError, OSError) as e:
        sock.close()
        raise ConnectionError(
            f"connected to {host}:{port} expecting "
            f"{_role_desc(expect_role)}, but the hello handshake failed "
            f"({type(e).__name__}: {e}) — the far end does not speak the "
            f"{wire.PROTO_DESC}") from e
    if reply is None:
        sock.close()
        raise ConnectionError(
            f"connected to {host}:{port} expecting "
            f"{_role_desc(expect_role)}, but the peer closed the "
            f"connection on the hello handshake")
    role = reply.get("role")
    if role != expect_role:
        sock.close()
        raise ConnectionError(
            f"{host}:{port} is {_role_desc(role)}, not the expected "
            f"{_role_desc(expect_role)} — check the address/port "
            f"(hello reply: proto={reply.get('proto')}, role={role!r})")
    return sock, reply


class OverloadError(RuntimeError):
    """Server refused admission (bounded queue full, or draining)."""

    def __init__(self, msg: dict):
        super().__init__(f"server overloaded: {msg.get('reason', '?')} "
                         f"(inflight={msg.get('inflight')}, "
                         f"max={msg.get('max_inflight')})")
        self.info = msg


class ServerError(RuntimeError):
    """Server answered a request with an error frame."""


class ServingClient:
    def __init__(self, host: str, port: int, timeout: float = 300.0,
                 connect_attempts: int = 5, connect_backoff_s: float = 0.05,
                 connect_backoff_max_s: float = 2.0):
        self.sock = connect_with_backoff(
            host, port, timeout, attempts=connect_attempts,
            backoff_s=connect_backoff_s, backoff_max_s=connect_backoff_max_s)
        self._next_id = 0
        # frames that arrived while collect() was routing for OTHER ids
        # (e.g. a stats reply read mid-stream) are buffered, never dropped
        self._pending: list[dict] = []

    # -- context management ------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- low-level frames --------------------------------------------------
    def send(self, msg: dict) -> None:
        wire.write_frame_sync(self.sock, msg)

    def recv(self) -> dict:
        if self._pending:
            return self._pending.pop(0)
        msg = wire.read_frame_sync(self.sock)
        if msg is None:
            raise ConnectionError("server closed the connection")
        return msg

    def _route(self, match: Callable[[dict], bool]) -> dict:
        """Return the next frame for which match(msg) is true.  Non-matching
        frames stay in _pending (in arrival order) for later calls: the
        buffer is scanned ONCE per invocation, then we fall through to the
        socket — so a backlog of other requests' frames can never starve
        the socket read."""
        for i, msg in enumerate(self._pending):
            if match(msg):
                return self._pending.pop(i)
        while True:
            msg = wire.read_frame_sync(self.sock)
            if msg is None:
                raise ConnectionError("server closed the connection")
            if match(msg):
                return msg
            self._pending.append(msg)           # someone else's frame

    # -- request lifecycle -------------------------------------------------
    def submit(self, prompt, max_new: int = 32, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0, eos_id: int = -1,
               seed: Optional[int] = None, timeout_s: Optional[float] = None,
               stream: bool = True, req_id=None,
               trace: Optional[dict] = None,
               prefill_only: bool = False,
               push_to: Optional[dict] = None):
        """Fire one generate; returns the request id (auto-assigned unless
        given).  Does NOT wait — pair with collect().  `trace`
        ({"trace_id": ..., "parent": ...?}) threads a client-originated
        distributed-trace context through the router/replica spans
        (docs/observability.md "Distributed tracing").  `prefill_only`
        (+ `push_to={"host", "port"}`) is the disaggregated-prefill
        control frame the fleet router normally originates: prefill the
        prompt, kv_push the committed pages to `push_to`, report the push
        outcome on the done frame (docs/serving.md)."""
        if req_id is None:
            req_id = f"q{self._next_id}"
            self._next_id += 1
        msg = {"type": "generate", "id": req_id,
               "prompt": [int(t) for t in prompt],
               "max_new": int(max_new), "stream": bool(stream)}
        if prefill_only:
            msg["prefill_only"] = True
            if push_to is not None:
                msg["push_to"] = {"host": str(push_to["host"]),
                                  "port": int(push_to["port"])}
        if trace is not None:
            msg["trace"] = dict(trace)
        if temperature:
            msg["temperature"] = float(temperature)
        if top_k:
            msg["top_k"] = int(top_k)
        if top_p:
            msg["top_p"] = float(top_p)
        if eos_id != -1:
            msg["eos_id"] = int(eos_id)
        if seed is not None:
            msg["seed"] = int(seed)
        if timeout_s is not None:
            msg["timeout_s"] = float(timeout_s)
        self.send(msg)
        return req_id

    def cancel(self, req_id) -> None:
        """Client-initiated cancellation; the stream's final frame will be
        `done` with reason "cancelled" (or whatever finished it first)."""
        self.send({"type": "cancel", "id": req_id})

    def collect(self, req_ids, on_token: Optional[Callable] = None) -> dict:
        """Route frames until every id in `req_ids` reached its terminal
        frame.  Returns {req_id: {"tokens": [...], "reason": str,
        "stream": [token ids in arrival order]}}.  `on_token(req_id,
        token, index)` observes streaming tokens as they arrive.  Raises
        OverloadError / ServerError on those terminal frames."""
        want = set(req_ids)
        out = {rid: {"tokens": None, "reason": None, "stream": [],
                     "timing": None} for rid in want}
        mine = ("token", "done", "overload", "error")
        while any(out[rid]["reason"] is None for rid in want):
            msg = self._route(lambda m: m.get("id") in want
                              and m.get("type") in mine)
            rid = msg["id"]
            t = msg["type"]
            if t == "token":
                out[rid]["stream"].append(int(msg["token"]))
                if on_token is not None:
                    on_token(rid, int(msg["token"]), int(msg["index"]))
            elif t == "done":
                out[rid]["tokens"] = list(msg["tokens"])
                out[rid]["reason"] = msg["reason"]
                # per-request latency attribution (queue/prefill/decode/
                # replay ms + preempt/spec counts; the router adds its
                # hop/retry fields) — docs/serving.md "Message schemas"
                out[rid]["timing"] = msg.get("timing")
                # disaggregated prefill: a prefill_only done frame carries
                # the kv_push outcome (push_ok / pushed_pages / push_error)
                for k in ("push_ok", "pushed_pages", "push_error"):
                    if k in msg:
                        out[rid][k] = msg[k]
            elif t == "overload":
                raise OverloadError(msg)
            else:
                raise ServerError(msg.get("error", "unknown server error"))
        return out

    def generate(self, prompt, on_token: Optional[Callable] = None,
                 **kw) -> tuple[list, str]:
        """Submit one request and wait it out: (tokens, reason).  `tokens`
        is prompt + generated, exactly lm_generate's layout."""
        rid = self.submit(prompt, **kw)
        res = self.collect([rid], on_token=on_token)[rid]
        return res["tokens"], res["reason"]

    # -- ops ----------------------------------------------------------------
    def stats(self, stale_ok: bool = False) -> dict:
        """The server's stats RPC (queue/slot/page occupancy, latency
        percentiles).  Safe to call with streams in flight: interleaved
        token frames are buffered for the next collect().

        Default: the engine half of the snapshot is built between steps
        on the pump thread — mutually consistent (`"consistent": true`).
        `stale_ok=True` answers immediately from the server's loop thread
        without waiting on the pump — the watchdog path, which also works
        against a wedged engine (watch `pump_last_step_age_s`)."""
        msg = {"type": "stats"}
        if stale_ok:
            msg["stale_ok"] = True
        self.send(msg)
        return self._route(lambda m: m.get("type") == "stats")

    def metrics(self, aggregate: bool = False) -> str:
        """The server's Prometheus-style text exposition (the `metrics`
        frame; answered on the loop thread, readable even while the
        engine pump is wedged).  Against a fleet router,
        `aggregate=True` asks for the FLEET view: the router's own
        fleet_* rows plus every reachable replica's serving_* families
        relabeled with `replica="rN"` — one scrape endpoint for the
        whole fleet.  Metric reference: docs/observability.md."""
        msg = {"type": "metrics"}
        if aggregate:
            msg["aggregate"] = True
        self.send(msg)
        return self._route(lambda m: m.get("type") == "metrics")["text"]

    def trace(self, pings: int = 3, enable: Optional[bool] = None) -> dict:
        """Pull the server's span-ring snapshot (the `trace` RPC —
        answered on the loop thread, so it works against a wedged pump)
        and measure this connection's clock offset: `pings` ping round
        trips estimate the minimum RTT, and the reply's perf_counter
        sample midpoints to `offset_s` with local ≈ remote + offset —
        what trace_dump --merge/--pull uses to align process tracks.
        `enable` flips the server's tracing LIVE before the snapshot
        (True to start tracing a running replica without a restart,
        False to stop and collect what it froze).  Returns the reply
        frame plus `offset_s`/`rtt_s`."""
        rtts = []
        for _ in range(max(1, int(pings))):
            t0 = time.perf_counter()
            self.ping()
            rtts.append(time.perf_counter() - t0)
        rtt = min(rtts)
        rid = f"trace{self._next_id}"
        self._next_id += 1
        msg = {"type": "trace", "id": rid}
        if enable is not None:
            msg["enable"] = bool(enable)
        t_send = time.perf_counter()
        self.send(msg)
        msg = self._route(lambda m: m.get("type") in ("trace", "error")
                          and m.get("id") == rid)
        if msg["type"] == "error":
            raise ServerError(msg.get("error", "trace pull failed"))
        remote = (msg.get("clock") or {}).get("perf_counter")
        msg["rtt_s"] = rtt
        msg["offset_s"] = ((t_send + rtt / 2.0) - float(remote)
                           if remote is not None else 0.0)
        return msg

    def history(self, last_s: Optional[float] = None,
                names=None, aggregate: bool = False) -> dict:
        """Pull the server's metric time-series ring (the `history` RPC —
        loop thread, stale-ok: answers against a wedged pump, exactly
        when the trailing window matters).  `last_s` trims each series
        to the trailing window, `names` filters series keys by prefix.
        Against a fleet router, `aggregate=True` asks for the FLEET
        view: the router's own series plus every reachable replica's
        relabeled `replica="rN"` — what tools/obs_top.py renders.
        Returns the reply frame: ring accounting + {"series": {key:
        {"kind", "points": [[unix_ts, value], ...]}}}."""
        rid = f"hist{self._next_id}"
        self._next_id += 1
        msg = {"type": "history", "id": rid}
        if last_s is not None:
            msg["last_s"] = float(last_s)
        if names is not None:
            msg["names"] = [str(n) for n in names]
        if aggregate:
            msg["aggregate"] = True
        self.send(msg)
        msg = self._route(lambda m: m.get("type") in ("history", "error")
                          and m.get("id") == rid)
        if msg["type"] == "error":
            raise ServerError(msg.get("error", "history pull failed"))
        return msg

    def dump(self) -> dict:
        """Ask the server to freeze a postmortem bundle NOW (answered on
        the loop thread — works against a wedged or dead engine pump).
        Returns {"path", "events", "spans"}; raises ServerError when the
        server has no postmortem directory configured.  Pretty-print the
        bundle with `python tools/postmortem.py <path>`."""
        # the dump gets its own id (the server echoes it on both reply
        # types): matching bare `error` frames would steal another
        # request's terminal error on a multiplexed connection — e.g. a
        # generate failed by a dying pump, exactly the scenario dump()
        # is advertised for
        rid = f"dump{self._next_id}"
        self._next_id += 1
        self.send({"type": "dump", "id": rid})
        msg = self._route(lambda m: m.get("type") in ("dump", "error")
                          and m.get("id") == rid)
        if msg["type"] == "error":
            raise ServerError(msg.get("error", "dump failed"))
        return {k: msg[k] for k in ("path", "events", "spans") if k in msg}

    def hello(self) -> dict:
        """Version/capabilities negotiation: the server's `hello` reply
        (`proto`, `role` — "replica" for an engine-pump server, "router"
        for the fleet front tier — `capabilities`, and sizing facts like
        `page_size`/`max_inflight`).  Safe mid-stream: interleaved frames
        are buffered like every other RPC."""
        self.send({"type": "hello"})
        return self._route(lambda m: m.get("type") == "hello")

    def ping(self) -> bool:
        self.send({"type": "ping"})
        self._route(lambda m: m.get("type") == "pong")
        return True
