"""Serve a transformer-LM config over TCP (serving/server.py front end) —
the port's copy of tools/serve.py, with the same flags and the same
SERVE_JSON line.  The engine runs on the CUDA card unless `--device cpu`
asks for the host.

Server (foreground; SIGTERM or SIGINT drains — finish in-flight requests,
refuse new ones, exit 0):

  python -m paddle_tpu_torch.tools.serve \
      --config demo/model_zoo/transformer_lm.py \
      --config-args "vocab=256,dim=64,layers=2,heads=4,batch_size=8" \
      --slots 8 --page-size 16 --max-context 256 --port 8431
      [--checkpoint runs/lm/  # newest committed pass dir, .tmp skipped]
      [--device cpu]

On bind it prints one machine-readable line (the scripting contract):

  SERVE_JSON:{"host": "127.0.0.1", "port": 8431, "pid": 12345}

Client one-shot (stdlib only; drives a replica or a router of either
package):

  python -m paddle_tpu_torch.tools.serve --client 127.0.0.1:8431 \
      --prompt 2,7,9 --max-new 16 --stream
  python -m paddle_tpu_torch.tools.serve --client 127.0.0.1:8431 --stats
  python -m paddle_tpu_torch.tools.serve --client 127.0.0.1:8431 --metrics

`--trace-out spans.jsonl` enables the span tracer for the server's
lifetime and writes the retained spans as JSONL on every exit path;
`--postmortem-dir DIR` arms the flight recorder's bundles (pump crash,
watchdog wedge, a client `--dump`).  `--mesh` (tensor-parallel serving)
is not ported yet and exits with a message saying so.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time


def render_history(reply: dict) -> str:
    """Compact per-series text for --history --watch: one line per
    series with the newest value (the full JSON stays available without
    --watch; tools/obs_top.py is the real dashboard)."""
    lines = [f"samples={reply.get('samples_taken')} "
             f"resolution={reply.get('resolution_s')}s "
             f"series={len(reply.get('series') or {})}"]
    for key, ser in sorted((reply.get("series") or {}).items()):
        pts = ser.get("points") or []
        last = pts[-1][1] if pts else "?"
        lines.append(f"  {ser.get('kind', '?'):7s} {key}  "
                     f"last={last} n={len(pts)}")
    return "\n".join(lines)


def run_client(args) -> int:
    from paddle_tpu_torch.serving.client import ServingClient

    host, _, port = args.client.rpartition(":")
    with ServingClient(host or "127.0.0.1", int(port)) as c:
        if args.metrics:
            print(c.metrics(aggregate=args.aggregate), end="")
            return 0
        if args.history:
            while True:
                reply = c.history(last_s=args.last_s or None,
                                  aggregate=args.aggregate)
                if not args.watch:
                    print(json.dumps(reply, indent=2))
                    return 0
                # \x1b[H\x1b[J = home + clear: a cheap live view
                print("\x1b[H\x1b[J" + render_history(reply), flush=True)
                time.sleep(args.watch)
        if args.dump:
            print(json.dumps(c.dump(), indent=2))
            return 0
        if args.stats:
            print(json.dumps(c.stats(stale_ok=args.stale_ok), indent=2))
            return 0
        prompt = [int(t) for t in str(args.prompt).split(",") if t != ""]
        if not prompt:
            print("need --prompt id,id,... (or --stats)", file=sys.stderr)
            return 2

        def on_token(rid, tok, idx):
            if args.stream:
                print(f"token[{idx}] = {tok}", flush=True)

        toks, reason = c.generate(
            prompt, max_new=args.max_new, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id,
            seed=args.seed, timeout_s=args.timeout_s, on_token=on_token)
        print(json.dumps({"tokens": toks, "reason": reason}))
    return 0


def build_engine(args):
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.trainer.trainer import Trainer

    if args.mesh:
        raise SystemExit("--mesh: tensor-parallel serving is not ported yet "
                         "(ROADMAP.md, Queue 1)")
    device = args.device or None
    cfg = parse_config(args.config, args.config_args)
    tr = Trainer(cfg, seed=args.seed or 0, device=device)
    if args.checkpoint:
        from paddle_tpu_torch.trainer.checkpoint import latest_checkpoint

        path = latest_checkpoint(args.checkpoint) or args.checkpoint
        print(f"loading checkpoint {path}", file=sys.stderr)
        tr.load(path)
    if args.prefill_chunk < 0:
        chunk = None                 # chunking off: whole-prompt prefill
    else:
        chunk = args.prefill_chunk or -1   # 0 = engine default
    drafter = None
    if args.spec_k > 0:
        if args.drafter == "model":
            # self-speculation: the target drafts for itself over a
            # truncated window
            from paddle_tpu_torch.serving.drafter import ModelDrafter
            drafter = ModelDrafter.from_target(tr.executor, tr.params,
                                               device=device)
        dyn = " (dynamic per-slot k)" if args.spec_dynamic else ""
        print(f"speculative decoding: up to {args.spec_k} drafts/slot/"
              f"step ({args.drafter} drafter{dyn}; emitted tokens "
              f"unchanged)", file=sys.stderr)
    if args.decode_steps > 1:
        print(f"multi-step decode: {args.decode_steps} decode bodies per "
              f"window (a CUDA graph) when pure-decode (emitted tokens "
              f"unchanged; tokens stream in bursts)", file=sys.stderr)
    if args.spill_budget > 0:
        print(f"KV spill tier: cold cached pages spill to host RAM "
              f"(budget {args.spill_budget} bytes) and restore on "
              f"prefix hits", file=sys.stderr)
    return ServingEngine(tr.executor, tr.params, num_slots=args.slots,
                         page_size=args.page_size,
                         max_context=args.max_context,
                         num_pages=args.num_pages,
                         prefill_chunk=chunk,
                         max_step_tokens=args.max_step_tokens or None,
                         spec_k=args.spec_k,
                         drafter=drafter,
                         spec_dynamic=args.spec_dynamic,
                         decode_steps=args.decode_steps,
                         decode_mode=args.decode_mode,
                         spill_bytes_budget=args.spill_budget,
                         device=device)


async def amain(args) -> int:
    from paddle_tpu_torch.serving.server import ServingServer

    tracer = None
    if args.trace_out:
        from paddle_tpu_torch.obs import get_tracer

        tracer = get_tracer()
        tracer.enabled = True

    def flush_trace(srv=None):
        # EVERY exit path flushes — a crashed or wedged server must never
        # leave an empty trace file behind (the spans up to the failure
        # are exactly the ones a postmortem wants).  The leading meta
        # line stamps process identity so trace_dump --merge can label
        # this file's track group in a stitched fleet trace.
        if tracer is not None:
            from paddle_tpu_torch.obs import flush_trace_file

            flush_trace_file(tracer, args.trace_out, "replica", args.host,
                             srv.port if srv is not None else args.port)

    engine = build_engine(args)
    srv = ServingServer(engine, host=args.host, port=args.port,
                        max_queue=args.max_queue,
                        postmortem_dir=args.postmortem_dir or None,
                        wedge_threshold_s=args.wedge_threshold_s,
                        role=args.role)
    try:
        host, port = await srv.start()
        print("SERVE_JSON:" + json.dumps(
            {"host": host, "port": port, "pid": os.getpid()}), flush=True)

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        # a dead engine pump must take the PROCESS down (nonzero, trace
        # flushed, bundle already frozen by the server) instead of leaving
        # a zombie listener that answers every generate with an error
        stop_w = asyncio.ensure_future(stop.wait())
        crash_w = asyncio.ensure_future(srv.wait_crashed())
        done, pending = await asyncio.wait(
            [stop_w, crash_w], return_when=asyncio.FIRST_COMPLETED)
        for fut in pending:
            fut.cancel()
        if crash_w in done:
            print("engine pump died; shutting down", file=sys.stderr,
                  flush=True)
            await srv.stop()
            return 1
        print("draining: refusing new requests, finishing in-flight...",
              file=sys.stderr, flush=True)
        await srv.drain()
        print("drained; bye", file=sys.stderr, flush=True)
        return 0
    finally:
        flush_trace(srv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="demo/model_zoo/transformer_lm.py")
    ap.add_argument("--config-args",
                    default="vocab=256,dim=64,layers=2,heads=4,batch_size=8")
    ap.add_argument("--checkpoint", default="",
                    help="save_dir (newest committed pass used) or pass dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (see the SERVE_JSON line)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-context", type=int, default=256)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="overcommit the page pool (default: worst case)")
    ap.add_argument("--spill-budget", type=int, default=0,
                    help="host-RAM bytes for the KV spill tier (0 = off): "
                         "cold cached pages spill instead of evicting and "
                         "restore on prefix hits (docs/serving.md)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill chunk size in tokens "
                         "(0 = engine default 4*page_size, negative = "
                         "disable chunking: legacy whole-prompt prefill)")
    ap.add_argument("--max-step-tokens", type=int, default=0,
                    help="per-step token budget for mixed prefill/decode "
                         "steps (0 = prefill_chunk + slots)")
    ap.add_argument("--device", default="",
                    help="torch device of the engine ('' = the CUDA card; "
                         "'cpu' runs on the host)")
    ap.add_argument("--mesh", default="",
                    help="tensor-parallel serving mesh, e.g. 'model=2' "
                         "(not ported yet: exits with a message)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: up to K drafted tokens "
                         "per decoding slot per step, verified exactly "
                         "in one ragged dispatch (0 = off; emitted "
                         "tokens are identical either way — "
                         "docs/serving.md 'Speculative decoding')")
    ap.add_argument("--drafter", choices=["ngram", "model"],
                    default="ngram",
                    help="with --spec-k: the draft proposer — 'ngram' "
                         "(host prompt lookup) or 'model' "
                         "(self-speculation: the target drafts for "
                         "itself over a truncated window, one batched "
                         "dispatch for all slots)")
    ap.add_argument("--spec-dynamic", action="store_true",
                    help="with --spec-k: per-slot dynamic draft depth — "
                         "an accept-rate EWMA picks k in 0..K per slot "
                         "per flush window; low-accept slots degrade to "
                         "plain decode (emitted tokens unchanged)")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="multi-step decode: run K decode bodies per "
                         "window (one CUDA graph replay) whenever every "
                         "live slot is pure-decode (1 = off; emitted "
                         "tokens are identical either way, streaming "
                         "arrives in <=K bursts — docs/serving.md "
                         "'Multi-step decode')")
    ap.add_argument("--decode-mode", choices=["auto", "static"],
                    default="auto",
                    help="step dispatch policy: 'auto' composes "
                         "speculation and multi-step per flush window "
                         "(draft-free pure-decode windows ride the "
                         "scan); 'static' keeps the legacy exclusivity "
                         "(spec disables the scan)")
    ap.add_argument("--role", choices=["prefill", "decode", "both"],
                    default="both",
                    help="disaggregated prefill/decode placement role, "
                         "advertised to the fleet router via hello: "
                         "'prefill' replicas run long prompts and "
                         "kv_push the committed pages to 'decode' "
                         "replicas, which own the token streams; 'both' "
                         "(default) serves everything colocated "
                         "(docs/serving.md 'Disaggregated "
                         "prefill/decode')")
    ap.add_argument("--max-queue", type=int, default=32,
                    help="admission bound beyond the slots; one more "
                         "request gets an overload response")
    ap.add_argument("--postmortem-dir", default="",
                    help="arm the flight recorder: pump crash / watchdog "
                         "wedge / a client --dump each freeze an atomic "
                         "postmortem bundle here (tools/postmortem.py "
                         "pretty-prints one)")
    ap.add_argument("--wedge-threshold-s", type=float, default=30.0,
                    help="pump beat age past which the watchdog declares "
                         "a wedge and dumps a bundle")
    ap.add_argument("--seed", type=int, default=0)
    # client mode
    ap.add_argument("--client", default="",
                    help="HOST:PORT — run as a one-shot client instead")
    ap.add_argument("--prompt", default="", help="comma-separated token ids")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--timeout-s", type=float, default=None)
    ap.add_argument("--stream", action="store_true",
                    help="print token frames as they arrive")
    ap.add_argument("--stats", action="store_true",
                    help="with --client: print the stats RPC and exit")
    ap.add_argument("--stale-ok", action="store_true",
                    help="with --stats: loop-thread fast path that never "
                         "waits on the engine pump (the watchdog poll — "
                         "works against a wedged engine)")
    ap.add_argument("--metrics", action="store_true",
                    help="with --client: print the Prometheus-style "
                         "metrics frame and exit")
    ap.add_argument("--aggregate", action="store_true",
                    help="with --client --metrics against a fleet "
                         "router: the fleet-wide view — router fleet_* "
                         "rows + every replica's families under a "
                         "replica=\"rN\" label")
    ap.add_argument("--dump", action="store_true",
                    help="with --client: ask the server to freeze a "
                         "postmortem bundle and print its path (works "
                         "against a wedged engine)")
    ap.add_argument("--history", action="store_true",
                    help="with --client: print the metric time-series "
                         "ring (the `history` RPC — loop thread, "
                         "answers against a wedged engine); against a "
                         "router --aggregate merges every replica's "
                         "series under replica=\"rN\" labels")
    ap.add_argument("--last-s", type=float, default=0.0,
                    help="with --history: only the trailing window, in "
                         "seconds (0 = full retention)")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="with --history: re-poll every N seconds and "
                         "render a compact live view (0 = print JSON "
                         "once); tools/obs_top.py is the full dashboard")
    # server-side tracing
    ap.add_argument("--trace-out", default="",
                    help="enable request-lifecycle tracing; write spans "
                         "as JSONL here on drain (tools/trace_dump.py "
                         "converts to Perfetto-loadable Chrome JSON)")
    args = ap.parse_args(argv)

    if args.client:
        return run_client(args)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
