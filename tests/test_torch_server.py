"""PyTorch port: the RPC serving front end (serving/server.py, client.py,
tools/serve.py) against the JAX package's on the CPU.

A JAX `ServingServer` over the JAX engine and the port's over the port's
engine (the weights carried across by `params_from_jax`) serve the same
greedy requests over TCP at decode_steps 1 and 4, admitted before the pump
starts and disturbed at fixed engine steps (a cancel frame, a stats and a
metrics request, a drain with a late request), so both schedules are the
same.  They must agree exactly on every `token` frame (token, index,
burst), every `done` frame (tokens, reason), the `overload` frames (a
small max_queue, then draining), the step-clock deadline, the `stats`
reply's keys and engine part and the `metrics` families; the completed
tokens equal the port's `lm_generate`.  A port client drives the JAX
server and a JAX client the port server.  The engine attributes the
server reads (`cur_burst`, `tp`, `pool_bytes_per_shard`) equal the JAX
engine's; `python -m paddle_tpu_torch.tools.serve` binds, serves,
refuses `--mesh` and drains on SIGTERM.

Toy widths: vocab 31, dim 16, 1 layer, 2 heads; tokens exact."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu.serving.wire as jwire
import paddle_tpu_torch.serving.wire as pwire
from test_torch_prefix_cache import lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M31 = (31, 16, 1, 2)
ENGINE = dict(num_slots=2, page_size=8, max_context=64)


def engine(side: str, decode_steps: int = 1, **kw):
    """One package's engine ("jax" or "port") on the step clock."""
    tr, ex, params = lm(*M31)
    kw = {**ENGINE, **kw}
    if side == "jax":
        from paddle_tpu.serving import ServingEngine
        eng = ServingEngine(tr.executor, tr.params, decode_steps=decode_steps,
                            **kw)
    else:
        from paddle_tpu_torch.serving import ServingEngine
        eng = ServingEngine(ex, params, device="cpu",
                            decode_steps=decode_steps, **kw)
    eng.clock = lambda: float(eng.n_decode_steps)
    return eng


def server(side: str, eng, **kw):
    if side == "jax":
        from paddle_tpu.serving.server import ServingServer
    else:
        from paddle_tpu_torch.serving.server import ServingServer
    return ServingServer(eng, **kw)


def oracle(prompt, max_new: int) -> list:
    """The port's per-request lm_generate (dense cache)."""
    from paddle_tpu_torch.graph.lm_decode import lm_generate
    _, ex, params = lm(*M31)
    toks, lens = lm_generate(ex, params, np.asarray([prompt], np.int32),
                             max_new=max_new, use_cache=True, device="cpu")
    return toks[0, :int(lens[0])].tolist()


def prompts(seed: int, lens) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 31, n).tolist() for n in lens]


class FrameRun:
    """A server and one raw connection: generate frames are sent before
    the pump starts (their admission answered in order, up to a pong), so
    the engine's schedule is fixed; `hooks` {engine step: [frames]} send
    frames from a helper thread while the pump is held at that step, and
    their replies (up to a pong) are read before it goes on.  A hook
    frame {"type": "_drain"} starts the server's drain instead.  Returns
    every frame the server sent, in order, with wall-time fields left
    out."""

    def __init__(self, side: str, decode_steps: int, max_queue: int = 3):
        self.side = side
        self.wire = jwire if side == "jax" else pwire
        self.eng = engine(side, decode_steps)
        self.srv = server(side, self.eng, max_queue=max_queue)

    def run(self, requests, hooks=None) -> list:
        hooks = dict(hooks or {})
        eng, srv, w = self.eng, self.srv, self.wire
        held, go = threading.Event(), threading.Event()
        at = {"step": None}
        orig_step = eng.step

        def step():
            if eng.n_decode_steps in hooks and at["step"] is None:
                at["step"] = eng.n_decode_steps
                go.clear()
                held.set()
                assert go.wait(60)
            return orig_step()

        eng.step = step
        host, port = srv.start_background(start_pump=False)
        sock = socket.create_connection((host, port))
        sock.settimeout(60)
        frames = []

        def read_until_pong():
            while True:
                msg = w.read_frame_sync(sock)
                assert msg is not None
                if msg["type"] == "pong":
                    return
                frames.append(msg)

        for cid, prompt, kw in requests:
            w.write_frame_sync(sock, {"type": "generate", "id": cid,
                                      "prompt": prompt, **kw})
        w.write_frame_sync(sock, {"type": "ping"})
        read_until_pong()
        accepted = {cid for cid, _, _ in requests} - {
            f["id"] for f in frames}
        srv.start_pump()

        def helper():
            while hooks:
                assert held.wait(60)
                held.clear()
                for msg in hooks.pop(at["step"]):
                    if msg["type"] == "_drain":
                        self.drain = asyncio.run_coroutine_threadsafe(
                            srv.drain(), srv._loop)
                        # FIFO on the loop: runs after drain()'s first
                        # step, which sets the draining flag
                        assert asyncio.run_coroutine_threadsafe(
                            _flag(srv), srv._loop).result(30)
                    else:
                        w.write_frame_sync(sock, msg)
                w.write_frame_sync(sock, {"type": "ping"})

        th = threading.Thread(target=helper, daemon=True)
        th.start()
        pending, pongs, n_hooks = set(accepted), 0, len(hooks)
        while pending or pongs < n_hooks:
            msg = w.read_frame_sync(sock)
            if msg is None:
                break
            if msg["type"] == "pong":
                pongs += 1
                at["step"] = None if hooks else -1
                go.set()
                continue
            if msg["type"] in ("done", "error"):
                pending.discard(msg.get("id"))
            frames.append(msg)
        th.join(30)
        assert not th.is_alive()
        go.set()
        # the JAX server's drain waits for its clients to hang up (Python
        # 3.12's Server.wait_closed); the port's closes them itself
        sock.close()
        if getattr(self, "drain", None) is not None:
            self.drain.result(60)
            srv._bg_thread.join(60)
        else:
            srv.stop_background(drain=True)
        for f in frames:
            f.pop("timing", None)
        return frames


async def _flag(srv):
    return srv._draining


def by_id(frames, kind: str) -> dict:
    out = {}
    for f in frames:
        if f["type"] == kind:
            out.setdefault(f.get("id"), []).append(
                {k: v for k, v in f.items() if k not in ("id", "type")})
    return out


def engine_part(stats: dict, srv) -> dict:
    keys = set(srv._engine_stats())
    return {k: v for k, v in stats.items() if k in keys}


def families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE")}


def workload(k: int):
    """Requests (a deadline 3 steps out, a cancel target, one over the
    admission cap) and the hooks: at step 6 (k = 1; 3 at k = 4) a cancel,
    stats, metrics and hello, at step 9 (5) the drain and a late
    request."""
    p = prompts(0, (4, 3, 9, 6, 5, 12, 7))
    reqs = [("dead", p[0], dict(max_new=30, timeout_s=3.0)),
            (0, p[1], dict(max_new=6)), (1, p[2], dict(max_new=16)),
            ("cancel", p[3], dict(max_new=30)), (2, p[4], dict(max_new=13)),
            ("over", p[5], dict(max_new=4))]
    at_cancel, at_drain = (6, 9) if k == 1 else (3, 5)
    hooks = {at_cancel: [{"type": "cancel", "id": "cancel"},
                         {"type": "stats"}, {"type": "metrics"},
                         {"type": "hello"}],
             at_drain: [{"type": "_drain"},
                        {"type": "generate", "id": "late", "prompt": p[6],
                         "max_new": 3}]}
    return reqs, hooks


@pytest.fixture(scope="module", params=[1, 4], ids=["k1", "k4"])
def frame_runs(request):
    """Both packages' frames of the workload at decode_steps k."""
    reqs, hooks = workload(request.param)
    out = {}
    for side in ("jax", "port"):
        fr = FrameRun(side, request.param)
        out[side] = (fr.run(reqs, {k: list(v) for k, v in hooks.items()}),
                     fr.srv)
    return request.param, reqs, out


def test_token_frames_equal_jax(frame_runs):
    """Every streamed token frame (token, index, burst) per request."""
    k, _, runs = frame_runs
    got, want = (by_id(runs[s][0], "token") for s in ("port", "jax"))
    assert got == want and got
    for cid, frames in got.items():
        assert [f["index"] for f in frames] == list(range(len(frames)))
        assert all(1 <= f["burst"] <= k for f in frames)
    bursts = [f["burst"] for fs in got.values() for f in fs]
    assert (max(bursts) > 1) == (k > 1)


def test_done_overload_and_deadline_frames_equal_jax(frame_runs):
    """done (tokens, reason), overload (queue_full, then draining) and
    error frames; the deadline expired on the step clock, the cancel
    ended its request, drain refused the late request and finished the
    rest; the completed tokens equal lm_generate's."""
    k, reqs, runs = frame_runs
    for kind in ("done", "overload", "error"):
        assert by_id(runs["port"][0], kind) == by_id(runs["jax"][0], kind)
    done = {i: f[0] for i, f in by_id(runs["port"][0], "done").items()}
    over = by_id(runs["port"][0], "overload")
    assert over["over"][0] == {"reason": "queue_full", "inflight": 5,
                               "max_inflight": 5}
    assert over["late"] == [{"reason": "draining"}]
    assert done["dead"]["reason"] == "deadline"
    assert done["cancel"]["reason"] == "cancelled"
    spec = {cid: (p, kw) for cid, p, kw in reqs}
    for cid in (0, 1, 2):
        assert done[cid]["reason"] == "length"
        p, kw = spec[cid]
        assert done[cid]["tokens"] == oracle(p, kw["max_new"])
    for cid in ("dead", "cancel"):
        full = oracle(spec[cid][0], 30)
        assert done[cid]["tokens"] == full[:len(done[cid]["tokens"])]


def test_stats_metrics_and_hello_frames_equal_jax(frame_runs):
    """The stats reply (pump-consistent, taken between steps) has the JAX
    reply's keys and engine part; the metrics frame renders the JAX
    families with # HELP / # TYPE (the allocator's gauges absent on the
    CPU); hello carries the same fields."""
    _, _, runs = frame_runs
    (pf, psrv), (jf, jsrv) = runs["port"], runs["jax"]
    pstats = [f for f in pf if f["type"] == "stats"]
    jstats = [f for f in jf if f["type"] == "stats"]
    assert len(pstats) == len(jstats) == 1
    assert pstats[0]["consistent"] and jstats[0]["consistent"]
    assert set(pstats[0]) == set(jstats[0])
    assert engine_part(pstats[0], psrv) == engine_part(jstats[0], jsrv)
    assert pstats[0]["tp_shards"] == 1
    ptext = [f for f in pf if f["type"] == "metrics"][0]["text"]
    jtext = [f for f in jf if f["type"] == "metrics"][0]["text"]
    live = {"hbm_live_array_bytes", "hbm_live_arrays"}
    assert families(ptext) == families(jtext) - live
    for fam in families(ptext):
        assert f"# HELP {fam} " in ptext
    phello = [f for f in pf if f["type"] == "hello"][0]
    jhello = [f for f in jf if f["type"] == "hello"][0]
    assert phello.pop("server") == "paddle_tpu_torch-serving"
    jhello.pop("server")
    assert phello == jhello


@pytest.mark.parametrize("client_side", ["port", "jax"])
def test_clients_drive_the_other_package_server(client_side):
    """A port ServingClient against the JAX server and a JAX one against
    the port server: generate (streamed), stats, metrics, history,
    trace, hello, ping; the tokens equal lm_generate's."""
    if client_side == "port":
        from paddle_tpu_torch.serving.client import (OverloadError,
                                                     ServingClient)
        srv_side = "jax"
    else:
        from paddle_tpu.serving.client import OverloadError, ServingClient
        srv_side = "port"
    srv = server(srv_side, engine(srv_side, decode_steps=4), max_queue=0)
    host, port = srv.start_background()
    try:
        with ServingClient(host, port) as c:
            assert c.ping() and c.hello()["role"] == "replica"
            p = prompts(3, (5, 11))
            seen = []
            toks, reason = c.generate(p[0], max_new=7,
                                      on_token=lambda r, t, i: seen.append(t))
            assert toks == oracle(p[0], 7) and reason == "length"
            assert seen == toks[len(p[0]):]
            r = [c.submit(p[1], max_new=4), c.submit(p[0], max_new=4)]
            got = c.collect(r)
            assert got[r[0]]["tokens"] == oracle(p[1], 4)
            st = c.stats()
            assert st["consistent"] and st["tokens_generated"] == 15
            assert "serving_decode_steps_total" in c.metrics()
            assert "series" in c.history()
            assert "spans" in c.trace(pings=1)
            # admission: 2 slots, max_queue 0 -> the third is refused
            r = [c.submit(p[0], max_new=20) for _ in range(2)]
            with pytest.raises(OverloadError):
                c.generate(p[1], max_new=2)
            c.collect(r)
    finally:
        srv.stop_background(drain=True)


def test_engine_attributes_the_server_reads_equal_jax():
    """cur_burst around a window's banking (on_token reads it), tp and the
    pools' bytes per shard."""
    seen = {}
    for side in ("jax", "port"):
        eng = engine(side, decode_steps=4)
        rec = seen[side] = []
        eng.on_token = lambda rid, tok, idx, e=eng, rec=rec: rec.append(
            (rid, idx, tok, e.cur_burst))
        if side == "jax":
            from paddle_tpu.serving import Request
        else:
            from paddle_tpu_torch.serving import Request
        eng.run([Request(i, p, max_new=n) for i, (p, n) in enumerate(
            zip(prompts(5, (4, 9, 6)), (9, 6, 13)))])
        assert eng.cur_burst == 1
        seen[side].append((eng.tp, eng.kv.pool_bytes_per_shard,
                           eng.kv.pool_bytes))
    assert seen["port"] == seen["jax"]
    assert max(b for *_, b in seen["port"][:-1]) == 4
    assert seen["port"][-1][0] == 1


def _serve(*args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serve",
         "--config", "demo/model_zoo/transformer_lm.py",
         "--config-args", "vocab=31,dim=16,layers=1,heads=2,batch_size=4",
         "--slots", "2", "--page-size", "8", "--max-context", "64",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, **kw)


def test_serve_cli_binds_serves_and_drains_on_sigterm():
    """SERVE_JSON on bind, a streamed request and the --client one-shots
    served, SIGTERM drains and exits 0; --mesh exits with the not-ported
    message."""
    proc = _serve("--device", "cpu", "--port", "0", "--seed", "3")
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVE_JSON:"), proc.stderr.read()
        addr = json.loads(line[len("SERVE_JSON:"):])
        assert addr["pid"] == proc.pid
        from paddle_tpu_torch.serving.client import ServingClient
        with ServingClient(addr["host"], addr["port"]) as c:
            toks, reason = c.generate([3, 4, 5], max_new=4)
            assert len(toks) == 7 and reason == "length"
        one = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.serve",
             "--client", f"{addr['host']}:{addr['port']}", "--prompt",
             "3,4,5", "--max-new", "4"], cwd=REPO, capture_output=True,
            text=True, env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
        assert json.loads(one.stdout)["tokens"] == toks
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        assert "drained" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    mesh = _serve("--device", "cpu", "--mesh", "model=2")
    _, err = mesh.communicate(timeout=120)
    assert mesh.returncode != 0 and "not ported yet" in err


@pytest.mark.parametrize("dirs", [(), ("pass-init",),
                                  ("pass-00000", "pass-00002.tmp"),
                                  ("pass-init", "pass-00001", "pass-00003",
                                   "pass-00004.tmp", "other")])
def test_latest_checkpoint_equals_jax(tmp_path, dirs):
    """serve --checkpoint's pick of a save_dir's newest committed pass:
    `.tmp` stragglers never, `pass-init` last, None when empty."""
    from paddle_tpu.trainer.checkpoint import latest_checkpoint as jlatest
    from paddle_tpu_torch.trainer.checkpoint import latest_checkpoint
    for d in dirs:
        (tmp_path / d).mkdir()
    assert latest_checkpoint(str(tmp_path)) == jlatest(str(tmp_path))
    assert latest_checkpoint(str(tmp_path / "missing")) is None
