"""PyTorch port: the engine's mid-flight checkpoint and restore, and
multi-step decode windows beside prefix hits, preemption and chunked
prefill — against the JAX engine on the CPU, exactly.

`checkpoint_state()` taken with requests queued, decoding and mid-chunk
(through a file: save_state / load_state) restores onto a fresh engine,
which finishes with the tokens, finish reasons, counters and allocator
and index state of the uninterrupted engine — itself equal to the JAX
engine — also when the snapshot's decode_steps and the restoring
engine's differ (k = 1 and k = 4); a snapshot refuses an engine of
another configuration or a busy one (tests/test_engine_state.py:150-214).
The snapshot carries the counters occupancy_sum, n_restore_hits and
restore_tokens_saved, and the host spill tier's pages with the index's
HOST nodes; a restore takes them under the restoring engine's generation
(tests/test_kv_spill.py:345-390, the checkpoint half of
tests/test_engine_state.py).
Windows of k = 4 equal k = 1 and the JAX engine at k = 4 under prefix
hits with copy-on-write, preempt-replay on an overcommitted pool and
chunked prefill (tests/test_multi_step.py:251-390).

Through tests/test_torch_prefix_cache.py's `Pair`; toy widths: vocab 61,
dim 32, 2 layers, 4 heads; vocab 23 and 11, dim 16."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving import ServingEngine
from test_torch_prefix_cache import (KNOBS, alloc_state, lm, pairs,  # noqa
                                     prompts, tree_state)

M61 = (61, 32, 2, 4)
M23 = (23, 16, 2, 2)
M11 = (11, 16, 1, 2)
ENGINE = dict(num_slots=2, page_size=8, max_context=64, prefill_chunk=8)


def workload(seed: int = 9):
    """A short sampled request, a 30-token one to chunk, two queued."""
    rng = np.random.default_rng(seed)
    mk = lambda n: rng.integers(2, 61, n).astype(np.int32)  # noqa: E731
    return [("dec", mk(5), dict(max_new=10, rng=3, **KNOBS[1])),
            ("chunky", mk(30), dict(max_new=8, rng=4, **KNOBS[2])),
            ("q1", mk(9), dict(max_new=6)),
            ("q2", mk(12), dict(max_new=5, rng=5, **KNOBS[3]))]


def staged(eng) -> bool:
    """A slot decoding, a slot part way through its prompt's chunks, and
    a request queued."""
    live = [sl for sl in eng.slots if sl is not None]
    return (any(sl.gen >= 1 for sl in live)
            and any(sl.gen == 0 and 0 < sl.pos < sl.req.prompt_ids.size
                    for sl in live)
            and bool(eng.queue))


def fresh(pair, k: int) -> ServingEngine:
    _, ex, params = lm(*M61)
    return ServingEngine(ex, params, device="cpu", noise=pair._noise,
                         decode_steps=k, **ENGINE)


def finish(eng) -> dict:
    while eng.step():
        pass
    return {"results": {k: v.tolist() for k, v in eng.results.items()},
            "reasons": dict(eng.finish_reasons),
            "counters": {c: getattr(eng, c) for c in (
                "n_decode_steps", "n_mixed_steps", "n_prefill_chunks",
                "tokens_generated", "n_preemptions", "n_prefix_hits",
                "n_prefix_misses", "prefill_tokens_saved", "occupancy_sum",
                "n_restore_hits", "restore_tokens_saved")},
            "kv": alloc_state(eng.kv), "n_cow": eng.kv.n_cow,
            "tree": tree_state(eng.prefix)}


@pytest.mark.parametrize("k_snap,k_restore", [(1, 1), (4, 4), (4, 1),
                                              (1, 4)])
def test_checkpoint_midflight_restores_bit_for_bit(pairs, tmp_path, k_snap,
                                                   k_restore):
    """Snapshot with a slot decoding, a slot mid-chunk and two requests
    queued, on the engine running beside the JAX engine; a fresh engine
    loads it from the file and finishes exactly as the uninterrupted one
    (whose tokens equal JAX's), the snapshot's k and the fresh engine's
    k free to differ.  The pools come back byte for byte; at the same k
    the counters and the allocator and index state end equal too."""
    pair = pairs(model=M61, **ENGINE)
    pair.reset(decode_steps=k_snap)
    pair.add(workload())

    for _ in range(200):
        if staged(pair.eng):
            break
        assert pair.step()
        pair.check()
    assert staged(pair.eng)
    path = str(tmp_path / "engine_state.pkl")
    pair.eng.save_state(path)
    pools = {n: {p: t.clone() for p, t in pool.items()}
             for n, pool in pair.eng.kv.pools.items()}
    while pair.step():
        pair.check()
    want = finish(pair.eng)
    assert set(want["results"]) == {"dec", "chunky", "q1", "q2"}

    eng = fresh(pair, k_restore)
    eng.load_state(path)
    for n, pool in eng.kv.pools.items():
        for p, t in pool.items():
            assert torch.equal(t, pools[n][p])
    got = finish(eng)
    if k_snap == k_restore:
        # counters, the LRU clock and n_cow carried over as they were
        assert got == want
    else:
        # a window is one step and grows its pages ahead: only the tokens
        # and reasons are k's to keep
        assert (got["results"], got["reasons"]) == (want["results"],
                                                    want["reasons"])
    eng.kv.check_reclaimed()


def test_restore_refuses_another_configuration_or_a_busy_engine(pairs):
    pair = pairs(model=M61, **ENGINE)
    _, ex, params = lm(*M61)
    snap = pair.eng.checkpoint_state()
    for kw in (dict(num_slots=3), dict(num_pages=9), dict(prefix_cache=False),
               dict(prefill_chunk=16)):
        other = ServingEngine(ex, params, device="cpu", **(ENGINE | kw))
        with pytest.raises(ValueError, match="configuration mismatch"):
            other.restore_state(snap)
    busy = fresh(pair, 1)
    pair.add(workload()[:1])
    busy.add_request(pair.requests(workload()[:1])[1][0])
    with pytest.raises(ValueError, match="idle"):
        busy.restore_state(busy.checkpoint_state())
    pair.run()


SPILL = dict(num_slots=2, page_size=4, max_context=16, num_pages=6,
             spill_bytes_budget=1 << 20)


def test_checkpoint_carries_the_host_tier_and_the_restore_counters(
        pairs, tmp_path):
    """A snapshot taken mid-flight with pages on the host: the counters
    (occupancy_sum, n_restore_hits, restore_tokens_saved among them)
    equal the JAX engine's at that point, and a fresh engine loaded from
    it — its own generation stamped on the host entries — restores from
    the migrated bytes and finishes as the uninterrupted engine, itself
    equal to JAX's, with the same counters, spill ledger and state."""
    pair = pairs(model=M23, **SPILL)
    rng = np.random.default_rng(21)
    done = {}
    for n in ("a", "b", "b2"):
        done.update(pair.run([(n, rng.integers(2, 23, 7).astype(np.int32),
                               dict(max_new=5))]))
    seq_a = np.asarray(done["a"]).astype(np.int32)
    pair.add([("c", seq_a[:9].copy(), dict(max_new=5)),
              ("d", seq_a[:6].copy(), dict(max_new=4, rng=9, **KNOBS[1])),
              ("e", rng.integers(2, 23, 6).astype(np.int32),
               dict(max_new=5))])
    assert pair.step()
    assert pair.eng.kv.host_page_count > 0
    for c in ("occupancy_sum", "n_restore_hits", "restore_tokens_saved"):
        assert getattr(pair.eng, c) == getattr(pair.jeng, c), c
    path = str(tmp_path / "engine_state.pkl")
    pair.eng.save_state(path)
    snap = pair.eng.checkpoint_state()
    assert snap["kv"]["host"] and all(
        k in snap["counters"] for k in ("occupancy_sum", "n_restore_hits",
                                        "restore_tokens_saved"))
    while pair.step():
        pair.check()
    want = finish(pair.eng)
    assert pair.eng.n_restore_hits > 0
    _, ex, params = lm(*M23)
    eng = ServingEngine(ex, params, device="cpu", noise=pair._noise,
                        **SPILL)
    eng.kv._host_gen = 5                  # another engine's generation
    eng.load_state(path)
    assert all(e["gen"] == 5 for e in eng.kv._host.values())
    assert sorted(eng.kv._host) == sorted(snap["kv"]["host"])
    got = finish(eng)
    assert got == want
    for a in ("n_spilled", "n_restored", "n_host_evicted", "_host_drained",
              "host_bytes"):
        assert getattr(eng.kv, a) == getattr(pair.jeng.kv, a), a
    eng.kv.check_reclaimed()


# ---------------------------------------------------------------------------
# tests/test_multi_step.py:251-390, at k = 1 and 4
# ---------------------------------------------------------------------------

def windows_equal_k1(pair, case) -> None:
    """case(pair) at k = 1 and at k = 4, each held against the JAX engine
    at its k by `Pair.run`: the same tokens both ways, windows only at
    k = 4."""
    out = {}
    for k in (1, 4):
        pair.reset(decode_steps=k)
        out[k] = case(pair)
        assert (pair.counters()[1]["n_scan_flushes"] > 0) == (k > 1)
        pair.eng.kv.check_reclaimed()
    assert sorted(out[4], key=str) == sorted(out[1], key=str)
    for rid in out[1]:
        np.testing.assert_array_equal(out[4][rid], out[1][rid])


def test_prefix_hits_and_cow_under_windows(pairs):
    """Later requests map an earlier one's pages read-only (the window's
    tripwire holds every write private)."""
    system = np.random.default_rng(0).integers(2, 23, 19).astype(np.int32)

    def case(pair):
        r2 = np.random.default_rng(1)
        out = {}
        for i, kw in enumerate(KNOBS):
            out.update(pair.run([(f"r{i}", np.concatenate(
                [system, r2.integers(2, 23, 3 + i).astype(np.int32)]),
                dict(max_new=5, rng=40 + i, **kw))]))
        assert pair.counters()[1]["n_prefix_hits"] >= 3
        return out

    windows_equal_k1(pairs(model=M23, num_slots=2, page_size=8,
                           max_context=64), case)


def test_preempt_replay_at_window_boundaries(pairs):
    def case(pair):
        out = pair.run([(i, p, dict(max_new=8)) for i, p in
                        enumerate(prompts((6, 4, 5, 3, 6), 11, seed=3))])
        assert pair.counters()[1]["n_preemptions"] > 0
        return out

    windows_equal_k1(pairs(model=M11, num_slots=2, page_size=4,
                           max_context=16, num_pages=6), case)


def test_chunked_prefill_beside_windows(pairs):
    def case(pair):
        out = pair.run([(i, p, dict(max_new=6, rng=200 + i,
                                    **(KNOBS[1] if i == 1 else {})))
                        for i, p in enumerate(prompts((30, 5, 9), 61,
                                                      seed=8))])
        assert pair.counters()[1]["n_mixed_steps"] > 0
        return out

    windows_equal_k1(pairs(model=M61, **ENGINE), case)
