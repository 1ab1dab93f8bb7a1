"""Fleet tier: multi-replica serving with KV-aware placement — the port's
copy of paddle_tpu/fleet/ (stdlib only).

The reference's layer-5 pserver networking (ProtoServer/LightNetwork —
a thin RPC tier fanning many trainers over many parameter servers) reborn
on the serving side: a front-tier ROUTER speaking the existing
`serving/wire.py` frame protocol on both faces.  Clients connect to the
router exactly as they connect to one `serving/server.py` replica (same
generate/cancel/stats/metrics/dump frames, per-token streaming
preserved); the router multiplexes them across N engine-pump replicas —
separate processes or hosts each running `python -m
paddle_tpu_torch.tools.serve` (or the JAX package's tools/serve.py: the
wire is the same).

Pieces (stdlib only, as the client and the wire are, so the router runs
on a box with no card):

  * `fleet.replica` — the replica table: per-replica registration state
    (joining/healthy/draining/broken/dead), the last polled stats
    snapshot, and the router's own outstanding-request accounting.
  * `fleet.policy` — KV-aware placement: a bounded prefix-affinity index
    (hash of the first page_size-aligned token run, mirroring
    `serving/prefix_tree.py` granularity) steers shared-prefix traffic to
    the replica that already holds the prefix's KV pages; everything else
    goes least-loaded on polled queue/slot/page occupancy.
  * `fleet.router` — the router itself: asyncio TCP listener, one
    persistent multiplexed backend connection per replica, a background
    stats poller doubling as the heartbeat, live join/leave, per-replica
    circuit breaking on a wedged pump, transparent retry of
    not-yet-streamed requests on replica death, and fleet-level overload
    shedding (never unbounded queueing).
  * `fleet.ctl` — operator control: join/leave/drain/undrain over the
    wire plus the drain-aware rolling-restart runbook as code.

CLI: `python -m paddle_tpu_torch.tools.fleet_router` (serve a router),
`python -m paddle_tpu_torch.fleet.ctl` (drive one).  Design notes:
docs/serving.md "Fleet".
"""

from paddle_tpu_torch.fleet.policy import (AffinityIndex,  # noqa: F401
                                           PlacementPolicy)
from paddle_tpu_torch.fleet.replica import Replica, ReplicaTable  # noqa: F401
from paddle_tpu_torch.fleet.router import FleetRouter  # noqa: F401

__all__ = ["FleetRouter", "FleetCtl", "Replica", "ReplicaTable",
           "PlacementPolicy", "AffinityIndex"]


def __getattr__(name):
    # ctl imports lazily: `python -m paddle_tpu_torch.fleet.ctl` would
    # otherwise warn about the module landing in sys.modules twice (the runpy
    # double-import), and nothing in the router path needs it
    if name == "FleetCtl":
        from paddle_tpu_torch.fleet.ctl import FleetCtl
        return FleetCtl
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
