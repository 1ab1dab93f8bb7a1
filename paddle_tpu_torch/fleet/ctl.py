"""Fleet control: join/leave/drain/undrain over the wire, and the
drain-aware rolling-restart runbook as code.

`FleetCtl` is a thin client over the router's `fleet` op frames (it rides
`serving/client.py`, so it inherits the reconnect-with-backoff that makes
a restarting router a wait, not an error).  The CLI form:

  python -m paddle_tpu_torch.fleet.ctl --router 127.0.0.1:8440 list
  python -m paddle_tpu_torch.fleet.ctl --router ... join 127.0.0.1:8431
  python -m paddle_tpu_torch.fleet.ctl --router ... drain r0
  python -m paddle_tpu_torch.fleet.ctl --router ... wait-drained r0
  python -m paddle_tpu_torch.fleet.ctl --router ... leave r0
  python -m paddle_tpu_torch.fleet.ctl --router ... undrain r0

Rolling restart of a replica, zero dropped requests (the runbook
docs/serving.md "Fleet" spells out; `rolling_restart()` below automates
it given a restart callback):

  1. `drain rX` — the router stops placing on rX; its in-flight work
     keeps streaming.
  2. `wait-drained rX` — until the router's own outstanding count AND the
     replica's polled inflight both reach zero (the replica may have
     direct clients the router never sees).
  3. `leave rX` — drop it from the table (nothing pending, so nothing to
     retry).
  4. restart the replica process — its own SIGTERM path drains whatever
     the router could not see, then the new process binds.
  5. `join host:port` — hello handshake, back in rotation.

Stdlib-only, like everything on the fleet tier.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Optional

from paddle_tpu_torch.serving.client import ServerError, ServingClient


class FleetCtl:
    """Operator handle on one fleet router."""

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 **client_kw):
        self.client = ServingClient(host, port, timeout=timeout,
                                    **client_kw)

    # -- context management ------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self.client.close()

    # -- ops ---------------------------------------------------------------
    def _op(self, op: str, **fields) -> dict:
        self.client.send({"type": "fleet", "op": op, **fields})
        reply = self.client._route(
            lambda m: m.get("type") == "fleet" and m.get("op") == op)
        if not reply.get("ok"):
            raise ServerError(f"fleet {op} failed: "
                              f"{reply.get('error', 'unknown')}")
        return reply

    def join(self, host: str, port: int) -> str:
        """Register a replica; returns its router-assigned id."""
        return self._op("join", host=host, port=int(port))["replica"]

    def leave(self, replica: str) -> None:
        self._op("leave", replica=replica)

    def drain(self, replica: str) -> dict:
        """Stop placing on `replica`; returns {state, pending}."""
        return self._op("drain", replica=replica)

    def undrain(self, replica: str) -> dict:
        return self._op("undrain", replica=replica)

    def list(self) -> list[dict]:
        return self._op("list")["replicas"]

    def status(self, replica: str) -> dict:
        for row in self.list():
            if row["replica"] == replica:
                return row
        raise ServerError(f"no replica {replica!r} in the fleet")

    def stats(self) -> dict:
        return self.client.stats()

    # -- the rolling-restart runbook ---------------------------------------
    def wait_drained(self, replica: str, timeout_s: float = 300.0,
                     poll_s: float = 0.1) -> dict:
        """Block until the router has ZERO outstanding requests on
        `replica` AND the replica's own polled inflight is zero (it may
        serve direct clients the router never placed).  Returns the final
        status row; raises TimeoutError with the stuck counts."""
        deadline = time.monotonic() + timeout_s
        row = self.status(replica)
        while time.monotonic() < deadline:
            row = self.status(replica)
            if row["pending"] == 0 and not (row.get("inflight") or 0):
                return row
            time.sleep(poll_s)
        raise TimeoutError(
            f"replica {replica} still busy after {timeout_s:.0f}s "
            f"(router pending={row['pending']}, "
            f"replica inflight={row.get('inflight')}) — is a request "
            f"ignoring its deadline?")

    def rolling_restart(self, restart: Callable[[dict], tuple[str, int]],
                        replicas: Optional[list[str]] = None,
                        drain_timeout_s: float = 300.0,
                        log=lambda s: print(s, file=sys.stderr,
                                            flush=True)) -> list[str]:
        """Restart every replica (or the given ids) one at a time with
        zero dropped requests: drain -> wait-drained -> leave ->
        `restart(status_row)` (stop the old process — its SIGTERM drain
        finishes anything the router could not see — and start the new
        one; return its (host, port)) -> join.  Returns the new replica
        ids.  A failing restart raises with the fleet still serving on
        the remaining replicas — the operator fixes the one box and
        re-runs."""
        todo = replicas if replicas is not None \
            else [row["replica"] for row in self.list()]
        new_ids = []
        for rid in todo:
            row = self.status(rid)
            log(f"fleet ctl: draining {rid} ({row['addr']})")
            self.drain(rid)
            self.wait_drained(rid, timeout_s=drain_timeout_s)
            self.leave(rid)
            log(f"fleet ctl: {rid} drained and left; restarting")
            host, port = restart(row)
            new_id = self.join(host, port)
            new_ids.append(new_id)
            log(f"fleet ctl: {host}:{port} rejoined as {new_id}")
        return new_ids


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="drive a fleet router: join/leave/drain/undrain/"
                    "list/wait-drained")
    ap.add_argument("--router", required=True, metavar="HOST:PORT")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("op", choices=["join", "leave", "drain", "undrain",
                                   "list", "wait-drained", "stats"])
    ap.add_argument("target", nargs="?", default="",
                    help="replica id (drain/undrain/leave/wait-drained) "
                         "or HOST:PORT (join)")
    args = ap.parse_args(argv)
    host, _, port = args.router.rpartition(":")
    try:
        ctl_handle = FleetCtl(host or "127.0.0.1", int(port),
                              timeout=args.timeout)
    except OSError as e:
        print(f"error: cannot reach the router at {args.router}: {e}",
              file=sys.stderr)
        return 1
    with ctl_handle as ctl:
        try:
            if args.op == "list":
                print(json.dumps(ctl.list(), indent=2))
            elif args.op == "stats":
                print(json.dumps(ctl.stats(), indent=2))
            elif args.op == "join":
                h, _, p = args.target.rpartition(":")
                if not p:
                    print("join needs HOST:PORT", file=sys.stderr)
                    return 2
                print(ctl.join(h or "127.0.0.1", int(p)))
            elif not args.target:
                print(f"{args.op} needs a replica id (see `list`)",
                      file=sys.stderr)
                return 2
            elif args.op == "leave":
                ctl.leave(args.target)
            elif args.op == "drain":
                print(json.dumps(ctl.drain(args.target)))
            elif args.op == "undrain":
                print(json.dumps(ctl.undrain(args.target)))
            elif args.op == "wait-drained":
                print(json.dumps(ctl.wait_drained(
                    args.target, timeout_s=args.timeout)))
        except (ServerError, TimeoutError, ConnectionError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
