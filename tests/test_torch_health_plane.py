"""PyTorch port: the health plane — utils/stat.py (`StatSet`), obs/
timeseries.py (`MetricHistory`, `merge_history`, `relabel_series_key`,
`history_reply`), obs/slo.py (`SloEvaluator`, the default specs),
`statset_collector` and obs/hbm.py — against the JAX package on the CPU.

Every scenario runs once on each package's modules, driven by synthetic
clocks (`sample(now=...)`, `evaluate(now=...)`), and the two runs' records
must be equal exactly: points, kinds, snapshots, rendered metrics, SLO
transitions, flight events (time stamps aside), dumps per episode (fire,
clear, re-arm).  Over TCP, a port server's `history` RPC answers while
its pump is wedged, its SLO episode freezes one bundle per episode as the
JAX server's does, and on the CPU its `metrics` frame renders without the
allocator's memory gauges.

Toy widths: vocab 31, dim 16, 1 layer, 2 heads."""

import threading
import types

import pytest

import paddle_tpu.obs.flight as jflight
import paddle_tpu.obs.metrics as jmetrics
import paddle_tpu.obs.slo as jslo
import paddle_tpu.obs.timeseries as jts
import paddle_tpu.utils.stat as jstat
import paddle_tpu_torch.obs.flight as pflight
import paddle_tpu_torch.obs.hbm as phbm
import paddle_tpu_torch.obs.metrics as pmetrics
import paddle_tpu_torch.obs.slo as pslo
import paddle_tpu_torch.obs.timeseries as pts
import paddle_tpu_torch.utils.stat as pstat

#: synthetic clock origin, far past any real wall-clock sample
T = 2_000_000_000.0

J = types.SimpleNamespace(metrics=jmetrics, ts=jts, slo=jslo, stat=jstat,
                          flight=jflight)
P = types.SimpleNamespace(metrics=pmetrics, ts=pts, slo=pslo, stat=pstat,
                          flight=pflight)


def events(rec) -> list:
    """A flight recorder's events without their time stamps."""
    return [(e["kind"], e["data"]) for e in rec.snapshot()]


def gauge_ring(m):
    h = m.ts.MetricHistory(resolution_s=5.0, retention_s=20.0)
    h.sample(now=T, samples=[("g", "gauge", None, 1.0)])
    h.sample(now=T + 1, samples=[("g", "gauge", None, 2.0)])
    out = [h.capacity, h.points("g")]
    for k in range(1, 7):
        h.sample(now=T + 5 * k, samples=[("g", "gauge", None, float(k))])
    return out + [h.points("g"), h.points("g", last_s=10.0, now=T + 30)]


def counter_ring(m):
    h = m.ts.MetricHistory(resolution_s=1.0, retention_s=10.0)
    for k, raw in enumerate([5.0, 12.0, 3.0, 10.0]):
        h.sample(now=T + k, samples=[("c_total", "counter", None, raw)])
    h.sample(now=T + 4.1, samples=[("c_total", "counter", None, 11.0)])
    h.sample(now=T + 4.9, samples=[("c_total", "counter", None, 14.0)])
    return [h.points("c_total"), h.kind("c_total")]


def histogram_series(m):
    h = m.ts.MetricHistory(resolution_s=1.0, retention_s=10.0)
    h.sample(now=T, samples=[("lat_sum", "histogram", None, 4.0),
                             ("lat_count", "histogram", None, 2.0),
                             ("lat_bucket", "histogram", {"le": "1"}, 2.0)])
    return [h.points("lat_sum"), h.kind("lat_count"),
            h.points('lat_bucket{le="1"}'), h.series_count(), h.keys()]


def series_cap(m):
    h = m.ts.MetricHistory(resolution_s=1.0, retention_s=5.0, max_series=2)
    h.sample(now=T, samples=[("a", "gauge", None, 1.0),
                             ("b", "gauge", None, 1.0),
                             ("c", "gauge", None, 1.0)])
    return [h.series_count(), h.dropped_series,
            sorted((n, k, l, v) for n, k, l, v in
                   m.ts.history_collector(h)()
                   if n != "obs_history_sample_age_s")]


def snapshots(m):
    h = m.ts.MetricHistory(resolution_s=1.0, retention_s=30.0)
    for k in range(5):
        h.sample(now=T + k, samples=[
            ("serving_num_slots", "gauge", None, 2.0),
            ("fleet_inflight", "gauge", None, float(k))])
    return [h.snapshot(names=["serving_"], now=T + 4),
            h.snapshot(last_s=2.0, now=T + 4), h.snapshot(now=T + 40)]


def relabel_merge(m):
    local = {"resolution_s": 5.0, "samples_taken": 3,
             "series": {"fleet_inflight": {"kind": "gauge",
                                           "points": [[T, 1.0]]}}}
    rep = {"series": {"serving_num_slots": {"kind": "gauge",
                                            "points": [[T, 2.0]]},
                      'x{q="1"}': {"kind": "counter",
                                   "points": [[T, 3.0]]}}}
    return [m.ts.relabel_series_key('a{x="1"}', {"replica": "r0"}),
            m.ts.relabel_series_key("plain", {"replica": "r1"}),
            m.ts.merge_history([(None, local), ("r0", rep), ("r1", rep)])]


def history_rpc(m):
    reg = m.metrics.MetricsRegistry(strict=True)
    reg.gauge("serving_inflight").set(3.0)
    reg.counter("serving_overload_total").inc(2.0)
    h = m.ts.MetricHistory(reg, resolution_s=1.0, retention_s=10.0)
    reg.register_collector(m.ts.history_collector(h))
    for k in range(3):
        h.sample(now=T + k)
    reply = m.ts.history_reply(h, {"names": ["serving_"], "last_s": 1.0},
                               "replica", "127.0.0.1", 1)
    reply.pop("process")
    return [reply, m.ts.history_reply(h, {}, "router")["series"].keys()
            == h.snapshot()["series"].keys()]


def slo_episodes(m):
    """Warm-up gate, fire, one dump per episode, clear, re-arm."""
    h = m.ts.MetricHistory(resolution_s=1.0, retention_s=60.0)
    reg = m.metrics.MetricsRegistry()
    rec = m.flight.FlightRecorder()
    rec.enabled = True
    dumps = []
    spec = m.slo.SloSpec(name="lat", series="g", objective=1.0, op=">",
                         short_window_s=2.0, long_window_s=4.0)
    ev = m.slo.SloEvaluator(h, [spec], flight=rec, registry=reg,
                            dump_fn=dumps.append)
    out = []
    for k, v in enumerate([5.0] * 6 + [0.5] * 4 + [9.0] * 5):
        h.sample(now=T + k, samples=[("g", "gauge", None, v)])
        out.append((k, ev.evaluate(now=T + k), ev.firing(),
                    reg.snapshot(), len(dumps)))
    return out + [ev.status(), events(rec), dumps]


def ratio_slos(m):
    h = m.ts.MetricHistory(resolution_s=1.0, retention_s=60.0)
    specs = [m.slo.SloSpec(name="shed", kind="ratio", series=("sheds",),
                           den=("ok", "sheds"), objective=0.05, op=">",
                           short_window_s=2.0, long_window_s=4.0),
             m.slo.SloSpec(name="mean", kind="hist_mean", series="lat",
                           objective=2.0, op=">", short_window_s=2.0,
                           long_window_s=4.0)]
    ev = m.slo.SloEvaluator(h, specs)
    out, tot = [], 0.0
    for k in range(16):
        tot += 5.0 if k >= 10 else 0.0
        h.sample(now=T + k, samples=[
            ("sheds", "counter", None, tot), ("ok", "counter", None, 0.0),
            ("lat_sum", "histogram", None, 3.0 * k),
            ("lat_count", "histogram", None, float(k))])
        out.append((ev.evaluate(now=T + k), ev.firing()))
    return out + [ev.status()]


def default_specs(m):
    return [[vars(s) for s in fn()] for fn in (
        m.slo.default_serving_slos, m.slo.default_router_slos,
        m.slo.default_pserver_slos)]


def statsets(m):
    """Percentiles over a wrapped sample window, the collector's render."""
    ss = m.stat.StatSet("s")
    for i in range(m.stat.SAMPLE_WINDOW + 37):
        ss.get("first_token_latency").add(((i * 7919) % 1000) / 1e3)
    for dt in (0.5, 0.25, 2.0):
        ss.get("token_latency").add(dt)
    with ss.time("timed"):
        pass
    ss.get("timed").reset()
    reg = m.metrics.MetricsRegistry(strict=True)
    reg.register_collector(m.metrics.statset_collector(
        ss, "serving_latency_seconds", "serving_latency_count"))
    return [ss.percentiles("first_token_latency", (50.0, 90.0, 99.0)),
            ss.percentiles("token_latency"), ss.percentiles("none"),
            [m.stat._quantile(sorted([3.0, 1.0, 2.0]), q)
             for q in (0.0, 25.0, 50.0, 99.0, 100.0, 150.0)],
            m.stat._quantile([], 50.0), reg.render(), reg.snapshot(),
            str(ss.get("token_latency"))]


SCENARIOS = [gauge_ring, counter_ring, histogram_series, series_cap,
             snapshots, relabel_merge, history_rpc, slo_episodes,
             ratio_slos, default_specs, statsets]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_health_plane_equals_jax(scenario):
    """Exact: the port's records equal the JAX package's."""
    got, want = scenario(P), scenario(J)
    assert got == want
    assert want                     # the scenario recorded something


def test_slo_episode_fires_clears_and_rearms():
    """The recorded episode itself: nothing before the 4 s warm-up, one
    fire and one dump, a clear, then a second fire dumping again."""
    out = slo_episodes(P)
    steps, ev = out[:-3], out[-2]
    fired = [k for k, tr, *_ in steps for t in tr if t["event"] == "slo_fire"]
    cleared = [k for k, tr, *_ in steps
               for t in tr if t["event"] == "slo_clear"]
    assert fired == [4, 12] and cleared == [7]
    assert [n for *_, n in steps][-1] == 2
    assert [kind for kind, _ in ev] == ["slo_fire", "slo_clear", "slo_fire"]


def test_memory_gauges_are_absent_on_the_cpu():
    """No card in use: the allocator's gauges are absent (as the
    reference's are where its backend does not report); the parameter and
    pool bytes are numel * element_size."""
    import torch
    params = {"w": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.int16)}
    kv = types.SimpleNamespace(pools={"l": {"k": torch.zeros(2, 8),
                                            "v": torch.zeros(2, 8)}})
    assert phbm.device_memory_stats() is None
    assert phbm.live_array_bytes() is None
    got = {n: v for n, _k, _l, v in phbm.hbm_collector(
        params_fn=lambda: params, kv_fn=lambda: kv)()}
    assert got == {"hbm_param_bytes": 58.0, "hbm_kv_pool_bytes": 128.0}
    assert phbm.hbm_snapshot(params=params, kv=kv) == {
        "param_bytes": 58, "kv_pool_bytes": 128}


# ---------------------------------------------------------------------------
# over TCP
# ---------------------------------------------------------------------------

def _server(side: str, **kw):
    """A server of one package ("jax" or "port") over that package's
    engine, one configuration (the weights carried across)."""
    from test_torch_server import engine, server
    return server(side, engine(side), **kw)


def test_history_rpc_answers_against_a_wedged_pump():
    """The port server's `history` frame is served on the loop thread from
    the ring: it answers while the pump is stuck inside step()."""
    from paddle_tpu_torch.serving.client import ServingClient
    srv = _server("port", max_queue=4)
    eng = srv.engine
    orig_step = eng.step
    wedged, release = threading.Event(), threading.Event()

    def wedge_step():
        if not release.is_set() and \
                (eng.queue or any(s is not None for s in eng.slots)):
            wedged.set()
            release.wait(60)
        return orig_step()

    eng.step = wedge_step
    host, port = srv.start_background()
    try:
        srv.history_sampler.stop()
        with ServingClient(host, port) as c:
            assert "history" in c.hello()["capabilities"]
            rid = c.submit([3, 4, 5], max_new=3)
            assert wedged.wait(30), "pump never picked up the request"
            srv.history.sample()
            reply = c.history()
            assert reply["type"] == "history"
            assert reply["process"]["role"] == "replica"
            assert "serving_num_slots" in reply["series"]
            assert {s["kind"] for s in reply["series"].values()} <= {
                "counter", "gauge"}
            assert c.stats(stale_ok=True)["pump_alive"]
            text = c.metrics()
            assert "pump_last_step_age_s" in text
            for absent in ("hbm_bytes_in_use", "hbm_bytes_limit",
                           "hbm_live_array_bytes"):
                assert absent not in text
            assert "# TYPE hbm_kv_pool_bytes gauge" in text
            release.set()
            assert c.collect([rid])[rid]["reason"] == "length"
    finally:
        release.set()
        srv.stop_background(drain=True)


def test_slo_episode_over_tcp_matches_jax(tmp_path):
    """An induced first-token p99 blowup on each package's server, ticked
    on one synthetic clock: the same transitions, one bundle per episode
    (two in all), the labelled gauge over the wire."""
    from paddle_tpu_torch.obs.flight import load_bundle
    from paddle_tpu_torch.serving.client import ServingClient
    q = 'serving_latency_seconds{quantile="p99",stat="first_token_latency"}'
    runs = []
    for side, m in (("jax", J), ("port", P)):
        spec = m.slo.SloSpec(name="ttft_p99", series=q, objective=0.1,
                             op=">", short_window_s=2.0, long_window_s=4.0)
        srv = _server(side, max_queue=4, history_resolution_s=1.0,
                      history_retention_s=60.0, slo_specs=[spec],
                      postmortem_dir=str(tmp_path / side))
        # the ring is ticked by hand below, on the synthetic clock only
        srv.history_sampler.enabled = False
        host, port = srv.start_background()
        try:
            srv.history_sampler.stop()
            t0 = T + 3600.0
            st = srv.stats.get("first_token_latency")
            seen = []
            for k, dt in enumerate([5.0] * 6 + [0.01] * 4 + [5.0] * 6):
                if k in (0, 6, 10):
                    st.reset()
                    for _ in range(8):
                        st.add(dt)
                srv.history.sample(now=t0 + k)
                seen.append((k, [t["event"] for t in
                                 srv.slo.evaluate(now=t0 + k)],
                             srv.slo.firing()))
            with ServingClient(host, port) as c:
                assert q in c.history()["series"]
                assert 'obs_slo_firing{slo="ttft_p99"} 1' in c.metrics()
            runs.append(seen)
        finally:
            srv.stop_background(drain=True)
    assert runs[0] == runs[1]
    assert [ev for _, ev, _ in runs[1] if ev] == [
        ["slo_fire"], ["slo_clear"], ["slo_fire"]]
    import glob
    found = sorted(glob.glob(str(tmp_path / "port" / "postmortem-*")))
    assert len(found) == 2
    b = load_bundle(found[0])
    assert b["meta"]["reason"] == "slo:ttft_p99"
    assert b["history"]["series"][q]["points"][-1][1] == 5.0
    assert b["engine"]["tp_shards"] == 1
    assert "hbm" in b["engine"] and "device_memory_stats" not in \
        b["engine"]["hbm"]
