"""PyTorch port: the fleet tier (fleet/replica.py, policy.py, router.py,
ctl.py) over the port's serving replicas, against the JAX package's on
the CPU.

`AffinityIndex` and `PlacementPolicy` give the JAX package's keys,
evictions and placements on the same random inputs.  A port router over
two port replicas serves a shared-prefix burst with the tokens and the
per-replica placements of the JAX router over two JAX replicas; a
disaggregated fleet (a prefill-role and a decode-role replica) ships the
same pages with exact tokens; kv_push carries pages from a JAX prefill
replica to a port decode replica and back; a replica killed mid-stream
has its unstreamed requests retried on the survivor while the streamed
one gets the reference's error; a JAX router serves port replicas.  All
completed tokens equal the port's `lm_generate`.

Determinism: each burst is one write of all its generate frames, so each
router places it in one pass over its pending counts; the routers poll
only at join (poll_interval_s 60), so no stale occupancy moves a
placement; the kill waits on a ping round trip, never on a sleep.

Toy widths: vocab 31, dim 16, 1 layer, 2 heads; pages of 8; tokens
exact."""

import socket
import threading

import numpy as np
import pytest

import paddle_tpu.fleet.policy as jpolicy
import paddle_tpu.fleet.replica as jreplica
import paddle_tpu.serving.wire as jwire
import paddle_tpu_torch.fleet.policy as ppolicy
import paddle_tpu_torch.fleet.replica as preplica
import paddle_tpu_torch.serving.wire as pwire
from test_torch_server import engine, oracle, prompts, server

PAGE = 8


# ---------------------------------------------------------------------------
# placement policy (no sockets)
# ---------------------------------------------------------------------------

def _policy_trace(pol_mod, rep_mod, seed: int) -> list:
    """A random run of placements over three replicas whose loads,
    polled occupancy and membership change between calls."""
    rng = np.random.default_rng(seed)
    pol = pol_mod.PlacementPolicy(
        ["affinity", "least_loaded", "random"][seed % 3], window=2,
        capacity=5)
    reps = [rep_mod.Replica(f"r{i}", "h", i) for i in range(3)]
    for r in reps:
        r.hello = {"max_inflight": int(rng.integers(1, 6))}
    out = []
    for step in range(60):
        for r in reps:
            r.pending = {f"g{j}" for j in range(int(rng.integers(0, 4)))}
            r.stats = {"pages_in_use": int(rng.integers(0, 9)),
                       "num_pages": 9}
        live = [r for r in reps if rng.random() > 0.25] or reps[:1]
        prompt = rng.integers(2, 5, int(rng.integers(1, 5))).tolist()
        r, why = pol.place(prompt, live)
        out.append((r.rid, why, len(pol.index)))
        if step % 17 == 16:
            out.append(("drop", pol.index.drop_replica("r1")))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_placement_policy_equals_jax(seed):
    got = _policy_trace(ppolicy, preplica, seed)
    assert got == _policy_trace(jpolicy, jreplica, seed)
    assert {why for e in got if len(e) == 3 for why in e[1:2]}


def test_affinity_index_equals_jax():
    rng = np.random.default_rng(11)
    out = []
    for mod in (ppolicy, jpolicy):
        idx = mod.AffinityIndex(window=3, capacity=4)
        trace = [idx.key_of([1, 2]), mod.AffinityIndex(0).key_of([1, 2, 3])]
        for _ in range(80):
            key = idx.key_of(rng.integers(0, 3, 4).tolist())
            op = rng.integers(0, 3)
            if op == 0:
                idx.put(key, f"r{rng.integers(0, 3)}")
            elif op == 1:
                trace.append(idx.get(key))
            else:
                trace.append(idx.drop_replica(f"r{rng.integers(0, 3)}"))
            trace.append(len(idx))
        out.append((trace, list(idx._map.items())))
        rng = np.random.default_rng(11)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# routers over real TCP loopback
# ---------------------------------------------------------------------------

def replica(side: str, role: str = "both", **kw):
    """A started server of one package over that package's engine."""
    srv = server(side, engine(side, **kw), max_queue=16, role=role)
    srv.start_background()
    return srv


def router(side: str, srvs, **kw):
    if side == "jax":
        from paddle_tpu.fleet import FleetRouter
    else:
        from paddle_tpu_torch.fleet import FleetRouter
    rt = FleetRouter(port=0, replicas=[(s.host, s.port) for s in srvs],
                     poll_interval_s=60.0, heartbeat_misses=100, **kw)
    rt.start_background()
    return rt


def stop_all(rt, srvs):
    rt.stop_background(drain=True)
    for srv in srvs:
        try:
            srv.stop_background(drain=True)
        except RuntimeError:
            pass


def burst(rt, wire, reqs, stream: bool = True) -> dict:
    """All of `reqs` [(id, prompt, max_new)] in one write to the router;
    returns {id: (tokens, reason, streamed tokens)}."""
    sock = socket.create_connection((rt.host, rt.port))
    sock.settimeout(120)
    try:
        sock.sendall(b"".join(wire.encode(
            {"type": "generate", "id": cid, "prompt": p, "max_new": n,
             "stream": stream}) for cid, p, n in reqs))
        out, streams = {}, {}
        while len(out) < len(reqs):
            msg = wire.read_frame_sync(sock)
            assert msg is not None and msg["type"] in ("token", "done"), msg
            if msg["type"] == "token":
                streams.setdefault(msg["id"], []).append(msg["token"])
            else:
                out[msg["id"]] = (msg["tokens"], msg["reason"],
                                  streams.get(msg["id"], []))
        return out
    finally:
        sock.close()


def prefix_skew(seed: int, n: int) -> list:
    """The prefix-skew workload at toy width: 4 prefixes of two pages
    drawn with Zipf exponent 1.0, suffixes of 2-6 tokens."""
    rng = np.random.default_rng(seed)
    pre = [rng.integers(2, 31, 2 * PAGE).tolist() for _ in range(4)]
    w = 1.0 / np.arange(1, 5)
    w /= w.sum()
    return [(i, pre[int(rng.choice(4, p=w))]
             + rng.integers(2, 31, int(rng.integers(2, 7))).tolist(),
             3 + i % 3) for i in range(n)]


def placements(rt) -> dict:
    """{replica port: requests routed there} from the router's table."""
    return {r.port: r.routed_total for r in rt.table}


def test_router_over_replicas_equals_jax():
    """The shared-prefix burst through each package's router over its own
    replicas: the same tokens (lm_generate's), the same routed counts per
    replica and the same placement reasons; the replicas' prefix caches
    hit alike."""
    reqs = prefix_skew(0, 12)
    runs = {}
    for side in ("jax", "port"):
        srvs = [replica(side) for _ in range(2)]
        rt = router(side, srvs)
        try:
            out = burst(rt, jwire if side == "jax" else pwire, reqs)
            # the replicas in join order: r0, r1
            runs[side] = (out, [placements(rt)[s.port] for s in srvs],
                          dict(rt._m_placements._vals),
                          [s.engine.n_prefix_hits for s in srvs])
        finally:
            stop_all(rt, srvs)
    assert runs["port"] == runs["jax"]
    out, routed, policy, hits = runs["port"]
    assert sum(routed) == 12 and min(routed) > 0
    assert policy[("affinity",)] > 0 and sum(hits) > 0
    for cid, p, n in reqs:
        assert out[cid][:2] == (oracle(p, n), "length")
        assert out[cid][2] == out[cid][0][len(p):]


def disagg(prefill_side: str, decode_side: str, router_side: str, reqs):
    sp = replica(prefill_side, role="prefill")
    sd = replica(decode_side, role="decode")
    rt = router(router_side, [sp, sd])
    try:
        out = burst(rt, jwire if router_side == "jax" else pwire, reqs)
        st = rt._stats_msg()
        return out, {k: st[k] for k in ("kv_pushes", "kv_push_failures",
                                        "kv_fallbacks", "kv_pages_shipped",
                                        "placements")}, \
            (sp._kv_pushes, sp.engine.kv.n_exported, sd.engine.kv.n_imported,
             sd.engine.n_kv_mounts)
    finally:
        stop_all(rt, [sp, sd])


DISAGG_REQS = [(i, p, 5) for i, p in enumerate(
    prompts(4, (2 * PAGE + 1, 3 * PAGE - 1, 2 * PAGE + 5, 5)))]


def test_disagg_prefill_decode_equals_jax():
    """A prefill-role and a decode-role replica behind each package's
    router: the long prompts split (prefill leg, kv_push, decode leg) and
    ship the same pages; the short one stays colocated; tokens exact."""
    port = disagg("port", "port", "port", DISAGG_REQS)
    assert port == disagg("jax", "jax", "jax", DISAGG_REQS)
    out, router_st, (pushes, shipped, received, mounts) = port
    assert router_st["kv_pushes"] == 3 and router_st["kv_fallbacks"] == 0
    assert router_st["kv_push_failures"] == 0
    assert router_st["kv_pages_shipped"] == shipped == received == 6
    assert pushes == 3 and mounts == 3
    for cid, p, n in DISAGG_REQS:
        assert out[cid][:2] == (oracle(p, n), "length")


@pytest.mark.parametrize("prefill_side,decode_side",
                         [("jax", "port"), ("port", "jax")])
def test_kv_push_across_the_packages(prefill_side, decode_side):
    """JAX pages pushed into a port decode replica, and the port's into a
    JAX one: the decode replica mounts them and decodes lm_generate's
    tokens."""
    out, router_st, (pushes, shipped, received, mounts) = disagg(
        prefill_side, decode_side, "port", DISAGG_REQS)
    assert router_st["kv_pushes"] == 3 and router_st["kv_fallbacks"] == 0
    assert shipped == received == 6 and mounts == 3
    for cid, p, n in DISAGG_REQS:
        assert out[cid][:2] == (oracle(p, n), "length")


def _loop_call(rt, fn):
    done = threading.Event()
    rt._loop.call_soon_threadsafe(lambda: (fn(), done.set()))
    assert done.wait(10)


def test_replica_killed_midstream_retries_unstreamed_requests():
    """Three requests sharing a first page are co-located by affinity; the
    replica dies after the first streamed a token: the two whose client
    saw nothing retry on the survivor with lm_generate's tokens, the
    streamed one gets the 'already streamed' error."""
    from paddle_tpu_torch.serving.client import ServerError, ServingClient
    srvs = [replica("port") for _ in range(2)]
    rt = router("port", srvs)
    try:
        prefix = prompts(2, (PAGE,))[0]
        p_a, p_b, p_c = prefix + [3, 4], prefix + [5, 6], prefix + [7, 8]
        with ServingClient(rt.host, rt.port) as c:
            ra = c.submit(p_a, max_new=30)
            msg = c.recv()
            while msg.get("type") != "token":
                msg = c.recv()
            c._pending.append(msg)
            rb = c.submit(p_b, max_new=25, stream=False)
            rc = c.submit(p_c, max_new=4, stream=False)
            assert c.ping()             # both placed before the pong
            victim = next(r for r in rt.table if len(r.pending) == 3)
            survivor = next(r for r in rt.table if r is not victim)
            _loop_call(rt, victim.backend.abort)
            next(s for s in srvs if s.port == victim.port).stop_background(
                drain=False)
            out = c.collect([rb, rc])
            assert out[rb]["tokens"] == oracle(p_b, 25)
            assert out[rc]["tokens"] == oracle(p_c, 4)
            with pytest.raises(ServerError, match="already streamed"):
                c.collect([ra])
            s = c.stats()
            assert s["replicas_registered"] == 1 and s["retries"] >= 2
            assert s["replicas"][0]["replica"] == survivor.rid
    finally:
        stop_all(rt, [s for s in srvs if s.port == survivor.port])


def test_jax_router_serves_port_replicas():
    """The JAX package's router (and its ctl) in front of port replicas:
    placements, streamed tokens and the fleet's stats and metrics."""
    from paddle_tpu.fleet import FleetCtl
    from paddle_tpu.serving.client import ServingClient
    srvs = [replica("port", decode_steps=4) for _ in range(2)]
    rt = router("jax", srvs)
    try:
        reqs = prefix_skew(1, 6)
        out = burst(rt, jwire, reqs)
        for cid, p, n in reqs:
            assert out[cid][:2] == (oracle(p, n), "length")
        with ServingClient(rt.host, rt.port) as c:
            s = c.stats()
            assert s["replicas_healthy"] == 2
            assert sum(r["routed_total"] for r in s["replicas"]) == 6
            text = c.metrics(aggregate=True)
            assert 'serving_tokens_generated_total{replica="r0"}' in text
        with FleetCtl(rt.host, rt.port) as ctl:
            assert sorted(r["replica"] for r in ctl.list()) == ["r0", "r1"]
    finally:
        stop_all(rt, srvs)
