"""PyTorch port: observability — the port's copies of the tracer, the
flight recorder, the metrics registry and the compile watch
(paddle_tpu_torch/obs/) and the serving engine's use of them — against
the JAX package on the CPU, exactly.

Units: the same calls on both packages' modules, the clocks injected,
give equal span rings, Chrome JSON and JSONL exports, equal flight rings
and bundles, an equal Prometheus text and equal storm firing.

Engine: three workloads run on a JAX engine and a port engine of one
configuration each (tests/test_torch_prefix_cache.py's `Pair`, built
fresh with the compile watches replaced, so the JAX engine's compiles
fall inside them):
  (W1) preemption and replay on an overcommitted pool, a cancel and a
       deadline on the step clock, then spills, a restore and a copy on
       write, then windows of 4;
  (W2) speculative decode (n-gram drafts over a repetitive prompt) with
       windows of 4 where no slot drafts;
  (W3) the whole-prompt prefill (prefill_chunk=None), cold and on prefix
       hits.
Each engine records into its own tracer, both packages' flight recorders
are on, and the request-lane and engine-lane spans (names, attrs, order),
the flight events (kinds and data, times removed), the histograms, the
per-request `timing` keys and counts and each site's signature count must
be equal.  Compile events are left out of the flight comparison: the
port's `sig` strings describe its own calls (obs/compile_watch.py), and
only their per-site counts are the reference's.

Toy widths: vocab 23, dim 16, 2 layers, 2 heads."""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.obs.compile_watch as jcw_mod
import paddle_tpu.obs.flight as jfl_mod
import paddle_tpu.obs.metrics as jmx_mod
import paddle_tpu.obs.trace as jtr_mod
import paddle_tpu_torch.obs.compile_watch as cw_mod
import paddle_tpu_torch.obs.flight as fl_mod
import paddle_tpu_torch.obs.metrics as mx_mod
import paddle_tpu_torch.obs.trace as tr_mod
from test_torch_prefix_cache import Pair, lm

M23 = (23, 16, 2, 2)
BIG = 1 << 20


class Clock:
    """A fake perf_counter / time.time: each read advances 0.25 ms."""

    def __init__(self, t0: float):
        self.t = t0

    def __call__(self) -> float:
        self.t += 0.00025
        return self.t


# ---------------------------------------------------------------------------
# units: the same calls on both packages' modules
# ---------------------------------------------------------------------------

def drive_tracer(mod):
    t = mod.Tracer(capacity=6)
    t.instant("dropped_while_disabled")
    t.enabled = True
    with t.span("prefill", track="req:a", bucket=32):
        pass
    h = t.begin("decode", track="req:a", slot=1)
    t.instant("preempt", track="req:a")
    t.end(h, tokens=3)
    t.end(None)
    t.add("decode_step", 0.5, 0.01, track="engine", attrs={"live": 2})
    for i in range(4):                         # wraps the ring
        t.add(f"s{i}", 1.0 + i, 0.5, track="req:b")
    return t


def test_tracer_exports_equal_the_reference(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "perf_counter", Clock(100.0))
    monkeypatch.setattr(time, "time", Clock(1.7e9))
    j = drive_tracer(jtr_mod)
    monkeypatch.setattr(time, "perf_counter", Clock(100.0))
    p = drive_tracer(tr_mod)
    assert (p.recorded, p.dropped) == (j.recorded, j.dropped) == (8, 2)
    assert p.snapshot() == j.snapshot()
    assert p.chrome_trace() == j.chrome_trace()
    paths = [str(tmp_path / f"{n}.jsonl") for n in ("j", "p")]
    meta = {"process": tr_mod.process_info("replica", "h", 1)}
    assert meta == {"process": jtr_mod.process_info("replica", "h", 1)}
    assert j.export_jsonl(paths[0], meta) == p.export_jsonl(paths[1], meta)
    assert open(paths[0]).read() == open(paths[1]).read()
    sources = [{"spans": j.snapshot(), "process": meta["process"],
                "offset_s": 0.5}, {"spans": j.snapshot(), "label": "x"}]
    assert tr_mod.merge_chrome(sources) == jtr_mod.merge_chrome(sources)
    monkeypatch.setattr(time, "perf_counter", lambda: 5.0)
    monkeypatch.setattr(time, "time", lambda: 6.0)
    msg = {"id": 7, "enable": False}
    assert tr_mod.trace_reply(p, dict(msg), "replica") == \
        jtr_mod.trace_reply(j, dict(msg), "replica")
    assert not p.enabled
    reg = mx_mod.MetricsRegistry(strict=True)
    jreg = jmx_mod.MetricsRegistry(strict=True)
    reg.register_collector(mx_mod.tracer_collector(p))
    jreg.register_collector(jmx_mod.tracer_collector(j))
    assert reg.render() == jreg.render()


def drive_flight(mod):
    fr = mod.FlightRecorder(capacity=4)
    fr.record("dropped_while_disabled")
    fr.enabled = True
    for i in range(6):
        fr.record("ev", i=i, req=f"r{i}")
    fr.record("queued")
    return fr


def test_flight_recorder_and_bundles_equal_the_reference(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(time, "time", Clock(1.7e9))
    j = drive_flight(jfl_mod)
    monkeypatch.setattr(time, "time", Clock(1.7e9))
    p = drive_flight(fl_mod)
    assert p.snapshot() == j.snapshot()
    assert (p.recorded, p.dropped) == (j.recorded, j.dropped) == (7, 3)
    parts = dict(spans=[{"seq": 0, "name": "queued", "track": "req:a",
                         "ts": 0.0, "dur": 0.5}],
                 engine={"slots": [None]}, metrics={"x": 1.0},
                 config={"num_slots": 1}, error="boom")
    bundles = []
    for fr, sub in ((j, "j"), (p, "p")):
        os.makedirs(tmp_path / sub)
        bundles.append(jfl_mod.load_bundle(fr.dump(str(tmp_path / sub),
                                                   "test", **parts)))
    assert fl_mod.load_bundle(bundles[1]["path"])["events"] == \
        bundles[1]["events"]
    for b in bundles:
        b.pop("path")
        for k in ("ts", "ts_iso", "versions"):
            b["meta"].pop(k)
    assert bundles[1] == bundles[0]
    assert [x for x in (j.bundles_written, p.bundles_written)] == [1, 1]
    assert [v for *_, v in fl_mod.flight_collector(p)()] == \
        [v for *_, v in jfl_mod.flight_collector(j)()]
    straggler = tmp_path / "postmortem-x.tmp"
    straggler.mkdir()
    for mod in (jfl_mod, fl_mod):
        with pytest.raises(ValueError, match="incomplete bundle"):
            mod.load_bundle(str(straggler))
    assert "torch" in fl_mod._versions() and "jax" not in fl_mod._versions()


def drive_registry(mod):
    reg = mod.MetricsRegistry(strict=True)
    c = reg.counter("serving_preemptions_total")
    c.inc(3)
    g = reg.gauge("serving_queue_depth", labels=("pool",))
    g.set(4, pool="a")
    g.set_fn(lambda: 2.5, pool="b")
    h = reg.histogram("serving_step_tokens", buckets=(1, 4, 16))
    for v in (1, 3, 3, 20):
        h.observe(v)
    hl = reg.histogram("serving_decode_gap_ms", labels=("slot",))
    hl.observe(0.004, slot="1")
    reg.register_collector(lambda: [("serving_num_slots", "gauge", None,
                                     4.0)])
    return reg


def test_registry_render_and_histograms_equal_the_reference():
    reg, jreg = drive_registry(mx_mod), drive_registry(jmx_mod)
    assert mx_mod.CATALOG == jmx_mod.CATALOG
    assert reg.render() == jreg.render()
    assert reg.snapshot() == jreg.snapshot()
    for mod in (mx_mod, jmx_mod):
        with pytest.raises(ValueError, match="CATALOG"):
            mod.MetricsRegistry(strict=True).counter("not_a_metric")
        with pytest.raises(ValueError, match="re-declared"):
            drive_registry(mod).gauge("serving_preemptions_total")
        with pytest.raises(ValueError, match="cannot decrease"):
            drive_registry(mod).counter("serving_preemptions_total").inc(-1)


def test_compile_watch_signatures_and_storms_equal_the_reference(
        monkeypatch):
    a = np.zeros((4, 8), np.float32)
    args = ((a, 3, "greedy", {"b": np.zeros(2, np.int32)}), {"flag": True})
    assert cw_mod.signature_of(*args) == jcw_mod.signature_of(*args)
    big = (tuple(np.zeros(i + 1) for i in range(64)),)
    assert cw_mod.signature_of(big, {}) == jcw_mod.signature_of(big, {})
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.int32, jnp.int32)):
        assert cw_mod.signature_of((torch.zeros(2, 3, dtype=tdt),), {}) == \
            jcw_mod.signature_of((jnp.zeros((2, 3), jdt),), {})
    snaps = []
    for mod, fl in ((jcw_mod, jfl_mod), (cw_mod, fl_mod)):
        monkeypatch.setattr(time, "perf_counter", Clock(10.0))
        cw = mod.CompileWatch(storm_n=3, storm_window_s=0.01)
        for i in range(5):                   # one storm, not five
            cw.record("site", f"sig{i}", 0.001)
        for _ in range(100):                 # the window drains: re-arm
            time.perf_counter()
        for i in range(3):
            cw.record("site", f"late{i}", 0.001)
        for key in ((2, 8), (2, 8), (4, 8)):
            with cw.watch("lm_decode.generate", key):
                pass
        snaps.append((cw.snapshot(), cw.storms, sorted(
            (n, k, tuple(sorted((l or {}).items())), v)
            for n, k, l, v in mod.compile_collector(cw)())))
    assert snaps[1] == snaps[0]
    assert snaps[1][1] == {"site": 2}
    assert snaps[1][0]["lm_decode.generate"]["signatures"] == 2


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def spans(tracer) -> list:
    return [(s["name"], s["track"], s.get("attrs"), s.get("instant", False))
            for s in tracer.snapshot()]


def flight_events(rec) -> list:
    out = []
    for e in rec.snapshot():
        if e["kind"] == "compile":
            continue
        data = dict(e.get("data") or {})
        data.pop("ms", None)                 # a draft pass's wall time
        out.append((e["kind"], data))
    return out


def hist(h, full: bool = True):
    """A histogram's samples, or only its observation count."""
    s = h.samples()
    return s if full else [x for x in s if x[0].endswith("_count")]


def finished_timing(eng, rid) -> tuple:
    t = eng.finish_timing[rid]
    return tuple(sorted(t)), {k: v for k, v in t.items()
                              if not k.endswith("_ms")}


def drive(pair, specs, cancel_at=None, cancel=()):
    """Add `specs` to both engines and step them in lockstep; at step
    `cancel_at` (since the start) cancel `cancel` on both."""
    pair.add(specs)
    n = 0
    while pair.step():
        n += 1
        if n == cancel_at:
            for rid in cancel:
                assert pair.jeng.cancel(rid) and pair.eng.cancel(rid)
    pair.check()


def w1(pair):
    rng = np.random.default_rng(1)
    eng, jeng = pair.eng, pair.jeng
    for e in (eng, jeng):
        e.clock = lambda e=e: float(e.n_decode_steps)
    drive(pair, [("r0", rng.integers(2, 23, 8), dict(max_new=8)),
                 ("r1", rng.integers(2, 23, 8), dict(max_new=8)),
                 ("cx", rng.integers(2, 23, 5), dict(max_new=9)),
                 ("late", rng.integers(2, 23, 4),
                  dict(max_new=4, deadline=3.0))], cancel_at=9,
          cancel=("cx",))
    for e in (eng, jeng):
        e.clock = time.monotonic
    res = {}
    for rid in ("a", "b", "b2"):
        res[rid] = rng.integers(2, 23, 7)
        drive(pair, [(rid, res[rid], dict(max_new=5))])
    seq_a = np.asarray(pair.eng.results["a"]).astype(np.int32)
    d = np.concatenate([seq_a[:6], (seq_a[6:8] + 1) % 21 + 2])
    drive(pair, [("c", seq_a[:9].copy(), dict(max_new=4)),
                 ("d", d.astype(np.int32), dict(max_new=3))])
    for e in (eng, jeng):
        e.set_decode_steps(4)
    drive(pair, [("k0", rng.integers(2, 23, 3), dict(max_new=7)),
                 ("k1", rng.integers(2, 23, 5), dict(max_new=6, rng=3,
                                                     temperature=0.8))])


def w2(pair):
    motif = np.array([3, 9, 4, 11, 5], np.int32)
    for e in (pair.eng, pair.jeng):
        e.set_decode_steps(4)
    drive(pair, [("s0", np.tile(motif, 3), dict(max_new=12)),
                 ("s1", np.array([7, 8, 2, 6], np.int32), dict(max_new=9)),
                 ("s2", np.tile(motif[:3], 4), dict(max_new=10))])


def w3(pair):
    rng = np.random.default_rng(3)
    base = rng.integers(2, 23, 12).astype(np.int32)
    drive(pair, [("p0", base[:3], dict(max_new=4)),
                 ("p1", base, dict(max_new=5)),
                 ("p2", rng.integers(2, 23, 20).astype(np.int32),
                  dict(max_new=3))])
    # into p1's donated boundary page and past it: a copy on write
    seq = np.asarray(pair.eng.results["p1"]).astype(np.int32)
    drive(pair, [("p3", np.concatenate([seq[:14], [5]]).astype(np.int32),
                  dict(max_new=4))])


WORKLOADS = {
    "w1": (w1, dict(num_slots=2, page_size=4, max_context=24, num_pages=7,
                    spill_bytes_budget=BIG)),
    "w2": (w2, dict(num_slots=2, page_size=4, max_context=32, spec_k=2)),
    "w3": (w3, dict(num_slots=2, page_size=4, max_context=32,
                    prefill_chunk=None)),
}


@pytest.fixture(scope="module")
def runs():
    """Each workload once on a fresh Pair, tracers and flight recorders
    on, the compile watches fresh: {name: (JAX side, port side)}, each a
    dict of what the tests compare."""
    out = {}
    jfl, fl = jfl_mod.get_flight_recorder(), fl_mod.get_flight_recorder()
    saved = [(r.enabled, r._ring, r._n) for r in (jfl, fl)]
    with pytest.MonkeyPatch.context() as mp:
        for name, (fn, kw) in WORKLOADS.items():
            jcw = jcw_mod.CompileWatch(storm_n=1000)
            cw = cw_mod.CompileWatch(storm_n=1000)
            mp.setattr(jcw_mod, "get_compile_watch", lambda w=jcw: w)
            mp.setattr("paddle_tpu.serving.engine.get_compile_watch",
                       lambda w=jcw: w)
            for mod in ("serving.engine", "serving.paged_kv",
                        "serving.drafter", "graph.lm_decode"):
                mp.setattr(f"paddle_tpu_torch.{mod}.get_compile_watch",
                           lambda w=cw: w)
            for r in (jfl, fl):
                r.clear()
                r.enabled = True
            pair = Pair(lm(*M23), **kw)
            pair.jeng.tracer = jtr_mod.Tracer(capacity=1 << 16)
            pair.eng.tracer = tr_mod.Tracer(capacity=1 << 16)
            for e in (pair.jeng, pair.eng):
                e.tracer.enabled = True
            fn(pair)
            sides = []
            for e, rec, w in ((pair.jeng, jfl, jcw), (pair.eng, fl, cw)):
                sides.append({
                    "spans": spans(e.tracer), "flight": flight_events(rec),
                    "step_tokens": hist(e.step_tokens_hist),
                    "spec_k": hist(e.spec_k_hist),
                    "decode_gap": hist(e.decode_gap_hist, False),
                    "draft_ms": hist(e.draft_ms_hist, False),
                    "timing": {rid: finished_timing(e, rid)
                               for rid in e.finish_timing},
                    "signatures": {site: st["signatures"] for site, st in
                                   w.snapshot().items()},
                    "occupancy_sum": e.occupancy_sum,
                    "preemptions": e.n_preemptions,
                    "spec_steps": e.n_spec_steps,
                    "scan_flushes": e.n_scan_flushes,
                    "restore_hits": e.n_restore_hits,
                    "n_cow": e.kv.n_cow})
            out[name] = tuple(sides)
    for r, (en, ring, n) in zip((jfl, fl), saved):
        r.enabled, r._ring, r._n = en, ring, n
    return out


@pytest.mark.parametrize("w", sorted(WORKLOADS))
def test_request_and_engine_lanes_equal_the_jax_engine(runs, w):
    """Every span of both engines' tracers — the request lanes' phases
    queued -> prefill -> decode (-> preempt -> queued -> prefill ->
    replay) -> done / cancelled / deadline with their attrs and instants,
    and the engine lane's decode_step / scan_step / draft_step — in the
    same order with the same attrs."""
    j, p = runs[w]
    assert p["spans"] == j["spans"]
    lanes = {}
    for name, track, _, _ in p["spans"]:
        lanes.setdefault(track, []).append(name)
    assert all(ph[0] == "queued" for t, ph in lanes.items()
               if t.startswith("req:"))
    if w == "w1":
        assert "replay" in sum(lanes.values(), [])
        assert lanes["req:cx"][-1] == "cancelled"
        assert lanes["req:late"] == ["queued", "deadline"]
        assert "scan_step" in lanes["engine"]
    if w == "w2":
        assert "draft_step" in lanes["engine"]


@pytest.mark.parametrize("w", sorted(WORKLOADS))
def test_flight_events_equal_the_jax_engine(runs, w):
    j, p = runs[w]
    assert p["flight"] == j["flight"]
    kinds = {k for k, _ in p["flight"]}
    want = {"queued", "admit", "finish"} | {
        "w1": {"preempt", "prefix_hit", "prefix_miss", "chunk_sched",
               "spill", "restore", "prefix_cow", "scan_flush",
               "prefix_evict"},
        "w2": {"draft_step", "spec_propose", "spec_accept", "spec_reject",
               "scan_flush"},
        "w3": {"prefix_hit", "prefix_miss"}}[w]
    assert want <= kinds, want - kinds


@pytest.mark.parametrize("w", sorted(WORKLOADS))
def test_histograms_timing_and_counters_equal_the_jax_engine(runs, w):
    """The step-token and draft-depth histograms whole, the gap and draft
    ms histograms' observation counts, each finished request's timing
    keys and counts, occupancy_sum and the counters behind the events."""
    j, p = runs[w]
    for k in ("step_tokens", "spec_k", "decode_gap", "draft_ms", "timing",
              "occupancy_sum", "preemptions", "spec_steps", "scan_flushes",
              "restore_hits", "n_cow"):
        assert p[k] == j[k], k
    assert p["step_tokens"][-1][3] > 0
    if w == "w1":
        assert p["preemptions"] and p["restore_hits"] and p["scan_flushes"]
        assert any(t[1].get("preempts") for t in p["timing"].values())
    if w == "w2":
        assert p["spec_steps"] and p["draft_ms"][0][3] > 0


# the reference's engine sites each workload reaches
SITES = {"w1": {"serving.decode_step", "serving.mixed_step",
                "serving.scan_step", "serving.cow_copy",
                "serving.spill_restore"},
         "w2": {"serving.spec_step", "serving.scan_step"},
         "w3": {"serving.decode_step", "serving.prefill", "serving.pack",
                "serving.prefix_prefill", "serving.prefix_pack",
                "serving.cow_copy"}}


@pytest.mark.parametrize("w", sorted(WORKLOADS))
def test_signature_counts_per_site_equal_the_jax_engine(runs, w):
    """Each site's distinct signatures: one decode step, one mixed step
    per token budget, one verify step per (budget, depth), one window per
    k, a prefill and a pack per bucket, a suffix prefill per (prefix
    pages, bucket), one COW copy, one restore scatter per power-of-two
    page count.  No site of these workloads differs; what does differ is
    the compile count on the card, where the port also counts each CUDA
    graph capture (the reference has no graphs), and the `sig` strings."""
    j, p = runs[w]
    assert p["signatures"] == j["signatures"]
    assert SITES[w] <= set(p["signatures"]), SITES[w] - set(p["signatures"])


def test_lm_generate_compile_watch_matches_the_reference(monkeypatch):
    """lm_decode.generate: one event per new (model, B, P, max_new, path,
    knobs) key, on both packages (the JAX decode loop stubbed out: the
    watch's key is computed before it)."""
    from paddle_tpu.graph.lm_decode import lm_generate as jgen
    from paddle_tpu_torch.graph.lm_decode import lm_generate as gen
    tr, ex, params = lm(*M23)
    jcw, cw = jcw_mod.CompileWatch(), cw_mod.CompileWatch()
    monkeypatch.setattr(jcw_mod, "get_compile_watch", lambda: jcw)
    monkeypatch.setattr("paddle_tpu_torch.graph.lm_decode.get_compile_watch",
                        lambda: cw)
    monkeypatch.setattr("paddle_tpu.graph.lm_decode._chunked_scan",
                        lambda step, carry, *a, **k: carry)
    ids = np.array([[3, 4, 5], [6, 7, 8]], np.int32)
    for n in (1, 1, 2):
        jgen(tr.executor, tr.params, ids, max_new=n)
        gen(ex, params, ids, max_new=n, device="cpu")
    assert cw.signature_count("lm_decode.generate") == \
        jcw.signature_count("lm_decode.generate") == 2
    assert json.dumps(cw.snapshot()["lm_decode.generate"]["compiles"]) == \
        json.dumps(jcw.snapshot()["lm_decode.generate"]["compiles"])
