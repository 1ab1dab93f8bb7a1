"""Serve a fleet router over N serving replicas (paddle_tpu_torch/fleet/) —
the port's copy of tools/fleet_router.py, same flags, same FLEET_JSON line.

Router (foreground; SIGTERM or SIGINT drains — finish routed requests,
refuse new ones, exit 0).  Replicas are serving processes of either
package; list them up front and/or join them live with the ctl:

  # replicas (each prints SERVE_JSON:{"port": ...})
  python -m paddle_tpu_torch.tools.serve --config ... --port 8431 &
  python -m paddle_tpu_torch.tools.serve --config ... --port 8432 &

  # the router (stdlib only: it runs on a box with no card)
  python -m paddle_tpu_torch.tools.fleet_router --port 8440 \
      --replica 127.0.0.1:8431 --replica 127.0.0.1:8432 \
      [--policy affinity] [--postmortem-dir runs/postmortems]

On bind it prints one machine-readable line (same contract as serve):

  FLEET_JSON:{"host": "127.0.0.1", "port": 8440, "pid": 12345}

Clients connect to the router exactly as to one replica — serving/client.py,
`python -m paddle_tpu_torch.tools.serve --client HOST:PORT`, same frames,
streaming preserved.  Operate the fleet with `python -m
paddle_tpu_torch.fleet.ctl --router HOST:PORT
join|leave|drain|undrain|list|wait-drained`.

One-shot client ops (stats / fleet-aggregated metrics / health-plane
history):

  python -m paddle_tpu_torch.tools.fleet_router --client 127.0.0.1:8440 \
      --stats
  python -m paddle_tpu_torch.tools.fleet_router --client 127.0.0.1:8440 \
      --metrics --aggregate
  python -m paddle_tpu_torch.tools.fleet_router --client 127.0.0.1:8440 \
      --history --aggregate
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys


def parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def _render_history(reply: dict) -> str:
    # compact one-line-per-series view for --watch (tools/serve.py has
    # the same shape; tools/obs_top.py is the real dashboard)
    lines = [f"samples={reply.get('samples_taken')} "
             f"resolution={reply.get('resolution_s')}s "
             f"replicas={reply.get('replicas')} "
             f"series={len(reply.get('series') or {})}"]
    for key, ser in sorted((reply.get("series") or {}).items()):
        pts = ser.get("points") or []
        last = pts[-1][1] if pts else "?"
        lines.append(f"  {ser.get('kind', '?'):7s} {key}  "
                     f"last={last} n={len(pts)}")
    return "\n".join(lines)


def run_client(args) -> int:
    import time

    from paddle_tpu_torch.serving.client import ServingClient

    host, port = parse_addr(args.client)
    with ServingClient(host, port) as c:
        if args.metrics:
            print(c.metrics(aggregate=args.aggregate), end="")
        elif args.history:
            while True:
                reply = c.history(last_s=args.last_s or None,
                                  aggregate=args.aggregate)
                if not args.watch:
                    print(json.dumps(reply, indent=2))
                    break
                print("\x1b[H\x1b[J" + _render_history(reply), flush=True)
                time.sleep(args.watch)
        elif args.dump:
            print(json.dumps(c.dump(), indent=2))
        else:
            print(json.dumps(c.stats(), indent=2))
    return 0


async def amain(args) -> int:
    from paddle_tpu_torch.fleet import FleetRouter

    tracer = None
    if args.trace_out:
        from paddle_tpu_torch.obs import get_tracer

        tracer = get_tracer()
        tracer.enabled = True

    rt = FleetRouter(host=args.host, port=args.port,
                     replicas=[parse_addr(s) for s in args.replica],
                     policy=args.policy,
                     poll_interval_s=args.poll_interval_s,
                     heartbeat_misses=args.heartbeat_misses,
                     wedge_age_s=args.wedge_age_s,
                     retry_limit=args.retry_limit,
                     disagg_min_prompt=args.disagg_min_prompt,
                     postmortem_dir=args.postmortem_dir or None)

    def flush_trace():
        # EVERY exit path flushes (the serve.py discipline, PR 6): a
        # crashed router must never leave an empty trace file — the
        # placement/relay spans up to the failure are exactly what a
        # postmortem wants.  The meta line stamps process identity so
        # trace_dump --merge labels this file's track group.
        if tracer is not None:
            from paddle_tpu_torch.obs import flush_trace_file

            flush_trace_file(tracer, args.trace_out, "router", args.host,
                             rt.port)

    try:
        host, port = await rt.start()
        print("FLEET_JSON:" + json.dumps(
            {"host": host, "port": port, "pid": os.getpid()}), flush=True)

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        print("draining: refusing new requests, finishing routed ones...",
              file=sys.stderr, flush=True)
        await rt.drain()
        print("drained; bye", file=sys.stderr, flush=True)
        return 0
    finally:
        flush_trace()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (see the FLEET_JSON line)")
    ap.add_argument("--replica", action="append", default=[],
                    metavar="HOST:PORT",
                    help="replica to join at start (repeatable); one not "
                         "up yet is retried until it is — or join live "
                         "via `python -m paddle_tpu_torch.fleet.ctl`")
    ap.add_argument("--policy", default="affinity",
                    choices=["affinity", "least_loaded", "random"],
                    help="placement policy (random exists for the "
                         "fleet bench's hit-rate A/B baseline)")
    ap.add_argument("--poll-interval-s", type=float, default=0.5,
                    help="stats-poll (= heartbeat) period per replica")
    ap.add_argument("--heartbeat-misses", type=int, default=10,
                    help="consecutive missed polls before a replica is "
                         "declared dead and leaves the fleet")
    ap.add_argument("--wedge-age-s", type=float, default=30.0,
                    help="polled pump_last_step_age_s past which the "
                         "replica's circuit opens (placement stops)")
    ap.add_argument("--retry-limit", type=int, default=2,
                    help="max transparent re-placements of a "
                         "never-streamed request after replica failures")
    ap.add_argument("--disagg-min-prompt", type=int, default=0,
                    help="disaggregated prefill/decode: prompts at least "
                         "this long place on a prefill-role replica and "
                         "kv_push to a decode-role one (0 = auto: one KV "
                         "page; negative = never; only fires while both "
                         "role tiers are placeable — docs/serving.md)")
    ap.add_argument("--postmortem-dir", default="",
                    help="arm the flight recorder: total-fleet-unhealthy "
                         "or a client dump frame freezes an atomic "
                         "bundle here")
    ap.add_argument("--trace-out", default="",
                    help="enable router-side distributed tracing "
                         "(ingress/place/relay/retry spans carrying "
                         "trace ids); spans written as JSONL here on "
                         "EVERY exit path — clean drain, crash, SIGTERM "
                         "— ready for tools/trace_dump.py --merge")
    # client mode
    ap.add_argument("--client", default="",
                    help="HOST:PORT — run as a one-shot client instead")
    ap.add_argument("--stats", action="store_true",
                    help="with --client: print the fleet stats frame "
                         "(the default op)")
    ap.add_argument("--metrics", action="store_true",
                    help="with --client: print the Prometheus text")
    ap.add_argument("--history", action="store_true",
                    help="with --client: print the health-plane "
                         "time-series ring (the `history` RPC)")
    ap.add_argument("--aggregate", action="store_true",
                    help="with --metrics/--history: the FLEET view — "
                         "router series plus every replica's under "
                         "replica=\"rN\" labels")
    ap.add_argument("--last-s", type=float, default=0.0,
                    help="with --history: trailing window in seconds "
                         "(0 = full retention)")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="with --history: re-poll every N seconds as a "
                         "compact live view (tools/obs_top.py is the "
                         "full dashboard)")
    ap.add_argument("--dump", action="store_true",
                    help="with --client: freeze a fleet postmortem "
                         "bundle and print its path")
    args = ap.parse_args(argv)
    if args.client:
        return run_client(args)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
