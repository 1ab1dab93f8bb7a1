"""The router's replica table: registration state + polled health.

One `Replica` per registered engine-pump server.  The router owns all
mutation (single asyncio loop — same no-cross-thread-mutation discipline
as the serving server's pump); everything here is plain bookkeeping so it
stays unit-testable without sockets.

State machine:

    JOINING --connect+hello ok--> HEALTHY
    HEALTHY --ctl drain--> DRAINING --ctl undrain--> HEALTHY
    HEALTHY/DRAINING --polled pump wedged--> BROKEN --beat recovers--> back
    any --connection lost / heartbeat expiry / ctl leave--> DEAD (dropped)

Placement only ever considers HEALTHY replicas; DRAINING and BROKEN stay
in the table (their in-flight work may still finish — a draining replica
is SUPPOSED to finish it) but receive nothing new.  DEAD replicas are
removed; their not-yet-streamed requests retry elsewhere.
"""

from __future__ import annotations

import time
from typing import Optional

JOINING = "joining"
HEALTHY = "healthy"
DRAINING = "draining"
BROKEN = "broken"          # circuit open: pump wedged/dead per polled stats
DEAD = "dead"

#: states a replica can be placed on
PLACEABLE = (HEALTHY,)
#: states the poller keeps polling (everything still in the table)
POLLABLE = (HEALTHY, DRAINING, BROKEN)


class Replica:
    """One registered engine-pump server, as the router sees it."""

    __slots__ = ("rid", "host", "port", "state", "hello", "stats",
                 "last_poll_t", "poll_fails", "pending", "external",
                 "joined_t", "backend", "routed_total", "broken_reason",
                 "drain_requested", "polling")

    def __init__(self, rid: str, host: str, port: int):
        self.rid = rid
        self.host = host
        self.port = int(port)
        self.state = JOINING
        # drain survives a circuit-break episode: a replica that wedges
        # WHILE draining must come back as draining, not placeable
        self.drain_requested = False
        self.polling = False           # one in-flight stats poll at a time
        self.hello: dict = {}          # the replica's hello reply
        self.stats: dict = {}          # last polled stats frame
        self.last_poll_t: Optional[float] = None
        self.poll_fails = 0
        # router-owned outstanding request ids (grid -> True): exact and
        # fresh, unlike the polled inflight — this is the primary load
        # signal between polls
        self.pending: set = set()
        # polled inflight the router did NOT place (other direct clients
        # of the replica), computed at poll time — the least-loaded score
        # must see traffic it never routed
        self.external = 0
        self.joined_t = time.monotonic()
        self.backend = None            # fleet.router._Backend, once up
        self.routed_total = 0
        self.broken_reason = ""

    # -- identity ----------------------------------------------------------
    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- capacity / load ---------------------------------------------------
    @property
    def max_inflight(self) -> int:
        """Admission cap learned from the hello handshake (fallback: the
        last polled stats; final fallback 1 so an unknown replica is
        conservatively one-request saturated rather than unbounded)."""
        v = self.hello.get("max_inflight") or self.stats.get("max_inflight")
        return max(1, int(v)) if v else 1

    @property
    def page_size(self) -> int:
        return int(self.hello.get("page_size") or 0)

    @property
    def role(self) -> str:
        """Advertised placement role (hello `role_mode`): "prefill",
        "decode", or "both".  ADVISORY — any replica can serve any
        request; the router's disaggregated placement tiers read it, and
        normal placement merely prefers non-prefill replicas when any
        exist (docs/serving.md "Disaggregated prefill/decode")."""
        return str(self.hello.get("role_mode") or "both")

    def load(self) -> int:
        """Requests this replica is carrying as far as the router knows:
        its own outstanding placements (exact) plus the externally-placed
        inflight seen at the last poll (stale but better than blind)."""
        return len(self.pending) + self.external

    def saturated(self) -> bool:
        return self.load() >= self.max_inflight

    def score(self) -> tuple:
        """Least-loaded ordering key — lower is better.  Primary: load
        fraction of the admission cap (the queue-depth signal: pending
        beyond the slots IS the replica's queue).  Secondary: KV page
        occupancy from the last poll (two equally-loaded replicas break
        toward the one with more free pages, where a long prompt is least
        likely to pause or preempt).  Final: rid, for determinism."""
        frac = self.load() / self.max_inflight
        pages = self.stats.get("pages_in_use") or 0
        num = self.stats.get("num_pages") or 0
        page_frac = pages / num if num else 0.0
        return (frac, page_frac, self.rid)

    def poll_age_s(self) -> float:
        if self.last_poll_t is None:
            return -1.0
        return time.monotonic() - self.last_poll_t

    def absorb_poll(self, stats: dict) -> None:
        """Record one stats reply; recompute the external-traffic term."""
        self.stats = stats
        self.last_poll_t = time.monotonic()
        self.poll_fails = 0
        inflight = int(stats.get("inflight") or 0)
        self.external = max(0, inflight - len(self.pending))

    def pump_wedged(self, wedge_age_s: float) -> str:
        """Non-empty reason iff the last poll shows a wedged/dead pump —
        the per-replica circuit-breaker predicate (stats are polled
        stale_ok, so they stay readable while the pump is stuck; see
        serving/server.py's watchdog)."""
        if not self.stats:
            return ""
        if self.stats.get("pump_alive") is False:
            return "pump_alive=false"
        age = self.stats.get("pump_last_step_age_s")
        if age is not None and float(age) > wedge_age_s:
            return f"pump_last_step_age_s={float(age):.1f}s"
        return ""

    def summary(self) -> dict:
        """One row of the router's fleet stats frame."""
        s = self.stats
        return {
            "replica": self.rid, "addr": self.addr, "state": self.state,
            "role": self.role,
            "draining": self.drain_requested,
            "pending": len(self.pending), "external": self.external,
            "max_inflight": self.max_inflight,
            "routed_total": self.routed_total,
            "poll_age_s": round(self.poll_age_s(), 3),
            "poll_fails": self.poll_fails,
            "broken_reason": self.broken_reason,
            # the KV-awareness inputs, echoed so an operator sees what
            # placement saw
            "queue_depth": s.get("queue_depth"),
            "slots_in_use": s.get("slots_in_use"),
            "num_slots": s.get("num_slots"),
            "pages_in_use": s.get("pages_in_use"),
            "num_pages": s.get("num_pages"),
            "inflight": s.get("inflight"),
            "pump_last_step_age_s": s.get("pump_last_step_age_s"),
            "prefix_hits": s.get("prefix_hits"),
            "prefix_misses": s.get("prefix_misses"),
            # cross-replica kv transfer, echoed from the polled stats so
            # `ctl list` shows each replica's disagg traffic in place
            "kv_pushes": s.get("kv_pushes"),
            "kv_push_failures": s.get("kv_push_failures"),
            "kv_pages_shipped": s.get("kv_pages_shipped"),
            "kv_pages_received": s.get("kv_pages_received"),
        }


class ReplicaTable:
    """All registered replicas, keyed by router-assigned id r0, r1, ..."""

    def __init__(self):
        self._seq = 0
        self.replicas: dict[str, Replica] = {}

    @property
    def ever_registered(self) -> bool:
        """True once any replica has ever joined — losing the LAST
        replica is a total-fleet-unhealthy event, an empty table at
        startup is not."""
        return self._seq > 0

    def add(self, host: str, port: int) -> Replica:
        r = Replica(f"r{self._seq}", host, port)
        self._seq += 1
        self.replicas[r.rid] = r
        return r

    def drop(self, rid: str) -> Optional[Replica]:
        r = self.replicas.pop(rid, None)
        if r is not None:
            r.state = DEAD
        return r

    def get(self, rid: str) -> Optional[Replica]:
        return self.replicas.get(rid)

    def by_addr(self, host: str, port: int) -> Optional[Replica]:
        for r in self.replicas.values():
            if r.host == host and r.port == int(port):
                return r
        return None

    def __iter__(self):
        return iter(list(self.replicas.values()))

    def __len__(self):
        return len(self.replicas)

    def in_state(self, *states: str) -> list[Replica]:
        return [r for r in self.replicas.values() if r.state in states]

    def placeable(self) -> list[Replica]:
        """Replicas a new request may land on: healthy AND not saturated.
        Empty while any are registered = the fleet-level overload
        condition (shed, never queue unboundedly)."""
        return [r for r in self.replicas.values()
                if r.state in PLACEABLE and not r.saturated()]

    def counts(self) -> dict:
        out = {HEALTHY: 0, DRAINING: 0, BROKEN: 0, JOINING: 0}
        for r in self.replicas.values():
            out[r.state] = out.get(r.state, 0) + 1
        return out
