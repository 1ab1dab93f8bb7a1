"""PyTorch port: a request's life in the serving engine against the JAX
engine on the CPU, exactly — overcommitted pools with pause and
preempt-replay, validation and the completion bound, failed admissions,
cancel and deadlines (queued, in flight, preempted, mid-replay), the
token and finish hooks (tests/test_serving.py:145-436), chunked prefill
with prefix hits, copy-on-write and preemption mid-prefill
(tests/test_chunked_prefill.py:148-275), and a paused slot beside a
cached prefix: its write lands in the trash page, at k = 1 and inside a
window, and the cached page's bytes never change.

Each case runs on both engines in one configuration through
tests/test_torch_prefix_cache.py's `Pair`: tokens, finish reasons, every
streamed token, the counters and the allocator and index state equal.
Toy widths, as the reference's tests: vocab 11, 23 or 31, dim 16, one
layer, 2 heads."""

import numpy as np
import pytest

from test_torch_prefix_cache import KNOBS, pairs, prompts  # noqa: F401

M11 = (11, 16, 1, 2)
M23 = (23, 16, 1, 2)
M31 = (31, 16, 1, 2)


def both(pair, fn):
    """fn(engine, request class) on the JAX engine and the port's: the
    same exception type and message, or the same result."""
    from paddle_tpu.serving import Request as JRequest
    from paddle_tpu_torch.serving import Request
    outs = []
    for eng, cls in ((pair.jeng, JRequest), (pair.eng, Request)):
        try:
            outs.append(("ok", fn(eng, cls)))
        except (ValueError, AssertionError) as e:
            outs.append((type(e).__name__, str(e)))
    assert outs[1] == outs[0]
    return outs[0]


# ---------------------------------------------------------------------------
# tests/test_serving.py:145-436
# ---------------------------------------------------------------------------

def test_overcommitted_pool_preempts(pairs):
    """5 real pages for 2 slots of 4: pauses and preemptions, tokens
    equal, every page reclaimable at the end."""
    pair = pairs(model=M11, num_slots=2, page_size=4, max_context=16,
                 num_pages=6)
    pair.run([(i, p, dict(max_new=8))
              for i, p in enumerate(prompts((6, 4, 5, 3, 6), 11, seed=3))])
    assert pair.counters()[1]["n_preemptions"] > 0
    pair.eng.kv.check_reclaimed()


def test_request_validation_and_the_completion_bound(pairs):
    """The same refusals with the same messages: sampling knobs without a
    temperature, the slot capacity, a negative max_new, an empty prompt,
    a request the whole pool cannot complete; max_new 0 answers the
    prompt at once, whatever its length."""
    pair = pairs(model=M11, num_slots=2, page_size=4, max_context=16)
    assert both(pair, lambda e, R: R(0, [3, 4], max_new=4, top_k=5))[0] \
        == "ValueError"
    assert "slot capacity" in both(pair, lambda e, R: e.add_request(
        R(0, list(range(2, 10)), max_new=12)))[1]
    assert "negative" in both(pair, lambda e, R: e.add_request(
        R(0, [3, 4], max_new=-1)))[1]
    assert "empty prompt" in both(pair, lambda e, R: R(0, [], max_new=4))[1]
    pair.add([("p", [3, 4, 5], dict(max_new=0)),
              ("big0", list(range(2, 40)), dict(max_new=0))])
    assert not pair.step()
    pair.check()
    assert pair.eng.results["big0"].size == 38

    pair = pairs(model=M11, num_slots=1, page_size=4, max_context=32,
                 num_pages=4)
    assert "pages to complete" in both(pair, lambda e, R: e.add_request(
        R(0, [3, 4, 5, 6], max_new=16)))[1]
    pair.run([(1, [3, 4, 5, 6], dict(max_new=9))])


def test_failed_admission_releases_its_partial_grab(pairs):
    """B (5 pages) waits for A to finish, then takes the whole pool on
    whichever slot it lands."""
    pair = pairs(model=M11, num_slots=2, page_size=4, max_context=20,
                 num_pages=6)
    rng = np.random.default_rng(0)
    pair.run([("a", rng.integers(2, 11, 14).astype(np.int32),
               dict(max_new=3)),
              ("b", rng.integers(2, 11, 17).astype(np.int32),
               dict(max_new=2))])
    pair.eng.kv.check_reclaimed()


def test_run_returns_only_its_own_completions(pairs):
    pair = pairs(model=M31, num_slots=2, page_size=8, max_context=32)
    a, b = prompts((4, 7), 31, seed=6)
    assert set(pair.run([("a", a, dict(max_new=3))])) == {"a"}
    assert set(pair.run([("b", b, dict(max_new=3))])) == {"b"}
    assert not pair.eng.results and not pair.eng.finish_reasons


def test_cancel_in_flight(pairs):
    """A cancelled slot's pages return (donated or free) this call, its
    tokens so far are reported with reason 'cancelled', a second cancel
    is refused, and the survivors finish as on the JAX engine."""
    pair = pairs(model=M31, num_slots=2, page_size=8, max_context=32)
    pair.add([(i, p, dict(max_new=8))
              for i, p in enumerate(prompts((5, 9, 4, 7), 31, seed=4))])
    for _ in range(3):
        pair.step()
    victim = next(sl.req.req_id for sl in pair.eng.slots if sl is not None)
    kv = pair.eng.kv
    mapped = kv.private_pages_in_use + kv.shared_pages_in_use
    assert both(pair, lambda e, R: e.cancel(victim)) == ("ok", True)
    assert kv.private_pages_in_use + kv.shared_pages_in_use < mapped
    assert both(pair, lambda e, R: e.cancel(victim)) == ("ok", False)
    assert pair.eng.finish_reasons[victim] == "cancelled"
    pair.check()
    pair.run()
    assert pair.counters()[1]["n_cancelled"] == 1
    kv.check_reclaimed()


def test_deadline_frees_pages_for_a_waiting_request(pairs):
    """A deadline on a step-count clock over 8 real pages: the expired
    request's pages let the waiting one in."""
    pair = pairs(model=M31, num_slots=2, page_size=4, max_context=16,
                 num_pages=9)
    for e in (pair.jeng, pair.eng):
        e.clock = (lambda e: lambda: float(e.n_decode_steps))(e)
    rng = np.random.default_rng(5)
    pair.run([("a", rng.integers(2, 31, 9).astype(np.int32),
               dict(max_new=7, deadline=3.0)),
              ("b", rng.integers(2, 31, 10).astype(np.int32),
               dict(max_new=6)),
              ("c", rng.integers(2, 31, 11).astype(np.int32),
               dict(max_new=5))])
    assert pair.counters()[1]["n_expired"] == 1
    assert pair.finishes[1]["a"][1] == "deadline"
    pair.eng.kv.check_reclaimed()


def test_cancel_and_deadline_of_queued_requests(pairs):
    pair = pairs(model=M11, num_slots=1, page_size=4, max_context=16)
    for e in (pair.jeng, pair.eng):
        e.clock = (lambda e: lambda: float(e.n_decode_steps))(e)
    pair.add([("run", [3, 4, 5], dict(max_new=4)),
              ("qc", [4, 5], dict(max_new=4)),
              ("qe", [5, 6], dict(max_new=4, deadline=0.0))])
    assert both(pair, lambda e, R: e.cancel("qc")) == ("ok", True)
    pair.check()
    res = pair.run()
    assert res["qe"].tolist() == [5, 6]
    c = pair.counters()[1]
    assert c["n_expired"] == 1 and c["n_cancelled"] == 1
    assert both(pair, lambda e, R: e.cancel("nonexistent")) == ("ok", False)


def test_cancel_of_a_preempted_queued_request_keeps_its_tokens(pairs):
    """Cancelled while it waits after a preemption, a request reports the
    tokens it had emitted (its stash) and counts them again."""
    pair = pairs(model=M11, num_slots=2, page_size=4, max_context=16,
                 num_pages=6)
    pair.add([(i, p, dict(max_new=8))
              for i, p in enumerate(prompts((6, 4, 5), 11, seed=3))])
    while pair.eng.n_preemptions == pair._base[1]["n_preemptions"] and \
            pair.step():
        pass
    victim = pair.eng.queue[0]
    stash = list(victim._preempted_gen)
    assert stash and stash == pair.jeng.queue[0]._preempted_gen
    assert both(pair, lambda e, R: e.cancel(victim.req_id)) == ("ok", True)
    toks = pair.eng.results[victim.req_id]
    assert toks[victim.prompt_ids.size:].tolist() == stash
    pair.check()
    pair.run()
    pair.eng.kv.check_reclaimed()


def test_cancel_mid_replay_reports_every_streamed_token(pairs):
    """Preempted after 3 tokens and cancelled while its replay is behind,
    a request reports all 3 and counts the ones not yet replayed."""
    pair = pairs(model=M11, num_slots=1, page_size=4, max_context=16)
    pair.add([("r", [3, 4, 5], dict(max_new=8))])
    for _ in range(3):
        assert pair.step()
    for e in (pair.jeng, pair.eng):
        e._preempt(0)
    pair.check()
    assert pair.step()
    assert pair.eng.slots[0].gen < 3
    assert both(pair, lambda e, R: e.cancel("r")) == ("ok", True)
    assert pair.eng.results["r"][3:].tolist() == \
        [t for _, t in pair.streams[1]["r"][:3]]
    pair.check()
    pair.eng.kv.check_reclaimed()


def test_token_and_finish_hooks(pairs):
    """on_token sees every token once, its index dense from 0; on_finish
    once per request with the final tokens and reason."""
    pair = pairs(model=M11, num_slots=2, page_size=4, max_context=16)
    res = pair.run([(i, p, dict(max_new=m)) for i, (p, m) in enumerate(
        zip(prompts((3, 5, 4), 11, seed=7), (4, 6, 1)))])
    for rid, toks in res.items():
        idx = [i for i, _ in pair.streams[1][rid]]
        assert idx == list(range(len(idx)))
        assert pair.finishes[1][rid] == (toks.tolist(), "length")


# ---------------------------------------------------------------------------
# tests/test_chunked_prefill.py:148-275
# ---------------------------------------------------------------------------

def test_prefix_hit_ending_mid_chunk(pairs):
    pair = pairs(model=M23, num_slots=2, page_size=4, max_context=32,
                 prefill_chunk=8, max_step_tokens=10)
    rng = np.random.default_rng(3)
    base = rng.integers(2, 23, 13).astype(np.int32)
    pair.run([("a", base.copy(), dict(max_new=6))])
    b = np.concatenate([base[:11], (base[11:13] + 1) % 23 + 2,
                        rng.integers(2, 23, 4)]).astype(np.int32)
    pair.run([("b", b, dict(max_new=6))])
    c = pair.counters()[1]
    assert c["n_prefix_hits"] >= 1 and c["n_cow"] >= 1
    assert c["prefill_tokens_saved"] >= 11
    pair.run([("c", base.copy(), dict(max_new=6))])
    pair.eng.kv.check_reclaimed()


def test_cow_divergence_inside_a_chunk(pairs):
    pair = pairs(model=M23, num_slots=2, page_size=4, max_context=32,
                 prefill_chunk=4, max_step_tokens=6)
    base = np.random.default_rng(4).integers(2, 23, 10).astype(np.int32)
    pair.run([("warm", base.copy(), dict(max_new=5))])
    pair.add([("x", np.concatenate([base[:9], [3, 4, 5]]).astype(np.int32),
               dict(max_new=5)),
              ("y", np.concatenate([base[:9], [7, 8]]).astype(np.int32),
               dict(max_new=5))])
    pair.step()
    pair.check()
    c = pair.counters()[1]
    assert c["n_prefix_hits"] >= 2 and c["n_cow"] >= 2
    assert pair.eng.kv.shared_pages_in_use >= 2
    pair.run()
    pair.run([("again", base.copy(), dict(max_new=5))])
    pair.eng.kv.check_reclaimed()


def test_preempt_of_a_half_chunked_prefill(pairs):
    """A decoder starves while `big` is still chunking: big is preempted
    mid-prefill, donates its committed pages and its re-admission hits
    them."""
    pair = pairs(model=M23, num_slots=2, page_size=4, max_context=24,
                 num_pages=9, prefill_chunk=4, max_step_tokens=5)
    rng = np.random.default_rng(5)
    pair.add([("a", rng.integers(2, 23, 8).astype(np.int32),
               dict(max_new=8))])
    pair.step()
    pair.add([("big", rng.integers(2, 23, 20).astype(np.int32),
               dict(max_new=3))])
    mid_prefill = False
    for _ in range(80):
        n = pair.eng.n_preemptions
        busy = pair.step()
        pair.check()
        if pair.eng.n_preemptions > n and any(
                r.req_id == "big" and not r._preempted_gen
                for r in pair.eng.queue):
            mid_prefill = True
        if not busy:
            break
    assert mid_prefill and pair.counters()[1]["n_prefix_hits"] > 0
    assert (pair.eng.kv._ref == 0).all()


def test_preempt_of_a_decoding_slot_with_chunks_in_flight(pairs):
    pair = pairs(model=M23, num_slots=2, page_size=4, max_context=16,
                 num_pages=6, prefill_chunk=4, max_step_tokens=6)
    rng = np.random.default_rng(6)
    pair.run([(i, rng.integers(2, 23, n).astype(np.int32),
               dict(max_new=8, rng=70 + i, **KNOBS[i]))
              for i, n in enumerate((6, 4, 7))])
    assert pair.counters()[1]["n_preemptions"] > 0
    assert (pair.eng.kv._ref == 0).all()


# ---------------------------------------------------------------------------
# a paused slot beside a cached prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_paused_slot_writes_to_the_trash_page(pairs, k):
    """W donates two pages; A's prompt hits them (its first two pages are
    cached and shared) and B decodes beside it on a pool of 6 real pages.
    A reaches a page boundary with the pool dry and PAUSES while B runs —
    k = 1 steps, and at k = 4 windows too.  A paused slot is staged at
    its own position, whose page is unmapped, so its write lands in trash
    page 0: the cached pages' bytes never change, and the tokens equal
    the JAX engine's."""
    pair = pairs(model=M23, num_slots=2, page_size=8, max_context=32,
                 num_pages=7)
    pair.reset(decode_steps=k)
    rng = np.random.default_rng(8)
    w = rng.integers(2, 23, 17).astype(np.int32)
    pair.run([("w", w, dict(max_new=2))])
    kv = pair.eng.kv
    cached = np.flatnonzero(kv._cached).tolist()
    assert len(cached) == 2
    held = {p: page_bytes(kv, p) for p in cached}
    pair.add([("a", np.concatenate([w[:16], rng.integers(2, 23, 3)])
               .astype(np.int32), dict(max_new=13)),
              ("b", rng.integers(2, 23, 12).astype(np.int32),
               dict(max_new=16, rng=5, temperature=0.9))])
    paused = paused_windows = 0
    while True:
        a = [(s, sl, sl.gen) for s, sl in enumerate(pair.eng.slots)
             if sl is not None and sl.req.req_id == "a" and sl.gen >= 1]
        flushes = pair.eng.n_scan_flushes
        if not pair.step():
            break
        pair.check()
        for s, sl, gen in a:
            if pair.eng.slots[s] is sl and sl.gen == gen:
                assert int(kv.table[s, 0]) in cached
                paused += 1
                paused_windows += pair.eng.n_scan_flushes > flushes
        for p, b in held.items():
            assert page_bytes(kv, p) == b, f"cached page {p} was written"
    assert paused > 0 and (paused_windows > 0) == (k > 1)
    assert pair.counters()[1]["n_prefix_hits"] >= 1
    kv.check_reclaimed()


def page_bytes(kv, page: int) -> bytes:
    """Physical page `page` of every layer's k and v pool."""
    return b"".join(t[page].numpy().tobytes() for pool in kv.pools.values()
                    for t in pool.values())


@pytest.mark.parametrize("k", [1, 4])
def test_every_paged_attention_call_carries_the_engines_split_count(
        pairs, monkeypatch, k):
    """The kernel's result for a row depends on its split count, so the
    engine pins one for all its launches — decode steps, mixed steps and
    window bodies — and a token's bits do not depend on which step type
    carried it (on the card the cache-on tokens differed from cache-off
    without it).  It is the mixed launch's own plan."""
    import paddle_tpu_torch.ops.attention as attn_ops
    from paddle_tpu_torch.ops.paged_attention import split_plan
    pair = pairs(model=M23, num_slots=2, page_size=4, max_context=24,
                 num_pages=9, prefill_chunk=4, max_step_tokens=5)
    pair.reset(decode_steps=k)
    eng = pair.eng
    assert eng.splits == split_plan(eng.max_step_tokens, len(eng.slots) + 1,
                                    eng.kv.pages_per_slot,
                                    eng.kv.page_size)[0]
    seen = []
    real = attn_ops.pa.paged_attention

    def recording(*a, splits=None, **kw):
        seen.append((a[0].shape[0], splits))
        return real(*a, splits=splits, **kw)

    monkeypatch.setattr(attn_ops.pa, "paged_attention", recording)
    rng = np.random.default_rng(9)
    pair.run([(i, rng.integers(2, 23, n).astype(np.int32), dict(max_new=8))
              for i, n in enumerate((8, 13, 5))])
    assert {rows for rows, _ in seen} >= {2, eng.max_step_tokens}
    assert {s for _, s in seen} == {eng.splits}


def test_features_not_ported_are_refused():
    """A mesh raises NotImplementedError naming ROADMAP.md, so an engine
    has one model-axis shard (`tp` 1, the pools' bytes per shard all of
    them), and the serving tool's --mesh exits the same way
    (tests/test_torch_server.py).  The spill tier, a tracer and page
    export / import serve (tests/test_torch_kv_spill.py,
    test_torch_kv_xfer.py, test_torch_obs.py), as do speculative decode
    and decode_mode="static" (tests/test_torch_spec_decode.py), the
    whole-prompt prefill, at construction and through set_chunking
    (tests/test_torch_legacy_prefill.py), and the RPC front end and the
    fleet (tests/test_torch_server.py, test_torch_fleet.py)."""
    from paddle_tpu_torch.obs import Tracer
    from paddle_tpu_torch.serving import Request, ServingEngine
    from test_torch_prefix_cache import lm
    _, ex, params = lm(*M11)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(ex, params, device="cpu", mesh=object())
    legacy = ServingEngine(ex, params, device="cpu", prefill_chunk=None)
    assert legacy.tp == legacy.kv.tp_shards == 1
    assert legacy.kv.pool_bytes_per_shard == legacy.kv.pool_bytes > 0
    eng = ServingEngine(ex, params, device="cpu", spec_k=2,
                        decode_mode="static")
    eng.set_chunking(None)
    for e in (legacy, eng):
        assert e.prefill_chunk is None
        out = e.run([Request("a", [3, 4, 5, 6], max_new=3)])
        assert out["a"].size == 7 and e.n_prefill_chunks == 0
    tracer = Tracer()
    tracer.enabled = True
    kw = dict(device="cpu", page_size=4, spill_bytes_budget=1 << 20)
    src = ServingEngine(ex, params, tracer=tracer, **kw)
    dst = ServingEngine(ex, params, **kw)
    prompt = [3, 4, 5, 6, 7, 8, 9, 3, 4]
    want = src.run([Request("a", prompt, max_new=3)])["a"]
    assert [sp["name"] for sp in tracer.snapshot()
            if sp["track"] == "req:a"] == ["queued", "prefill", "decode",
                                           "done"]
    toks, meta, payload = src.export_prefix(prompt)
    assert toks.size == 8 and dst.import_prefix(toks, meta, payload) == 2
    got = dst.run([Request("b", prompt, max_new=3)])["b"]
    np.testing.assert_array_equal(got, want)
    assert dst.n_prefix_hits == 1 and dst.kv.n_imported == 2
    src.set_spill_budget(0)
    assert src.kv.spill_bytes_budget == 0
