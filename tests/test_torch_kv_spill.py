"""PyTorch port: the host KV spill tier — the allocator's spill and
restore of pages (serving/paged_kv.py), the prefix index's HOST nodes and
two-level eviction (serving/prefix_tree.py) and the engine's restore on a
prefix hit, `set_spill_budget`, the drains and the checkpoint that
carries the tier (serving/engine.py) — against the JAX engine on the CPU,
exactly.

The cases of tests/test_kv_spill.py run on a JAX engine and a port engine
of the same configuration (tests/test_torch_prefix_cache.py's `Pair`):
tokens, every streamed token, the counters, the allocator, the index with
its HOST nodes and their host ids, and the spill counters
(n_spilled, n_restored, n_host_evicted, the drains, host bytes, the next
host id, the generation, restore hits and tokens saved) must be equal
after every run.  Sampled requests get the JAX engine's Gumbel noise
through the port's `noise` hook.

Toy widths, as the reference's tests: vocab 23, dim 16, 2 layers, 2
heads; pages of 4 tokens."""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu_torch.serving import PagedKVCache, ServingEngine
from test_torch_prefix_cache import (KNOBS, alloc_state, lm,  # noqa: F401
                                     pairs)

M23 = (23, 16, 2, 2)
BIG = 1 << 20                       # never the binding constraint
# 1 slot over 5 usable pages: one retired 12-token sequence donates 2
# pages, so the second distinct sequence already evicts (tests/
# test_kv_spill.py `_tight_engine`)
TIGHT = dict(num_slots=1, page_size=4, max_context=16, num_pages=6,
             spill_bytes_budget=BIG)


def host_nodes(tree) -> list:
    """(token path, host id) of every HOST node."""
    out, stack = [], [(tree.root, ())]
    while stack:
        node, path = stack.pop()
        for ch in node.children.values():
            p = path + ch.run
            if ch.host_id is not None:
                out.append((p, int(ch.host_id)))
            stack.append((ch, p))
    return sorted(out)


def spill_state(e) -> dict:
    kv = e.kv
    return {"spilled": kv.n_spilled, "restored": kv.n_restored,
            "host_evicted": kv.n_host_evicted, "drained": kv._host_drained,
            "host_pages": kv.host_page_count, "host_bytes": kv.host_bytes,
            "next_hid": kv._next_hid, "gen": kv._host_gen,
            "hids": sorted(kv._host), "budget": kv.spill_bytes_budget,
            "restore_hits": e.n_restore_hits,
            "restore_tokens_saved": e.restore_tokens_saved,
            "host_nodes": [] if e.prefix is None else host_nodes(e.prefix)}


def check(pair) -> dict:
    """The Pair's checks plus the spill tier's state; returns the port's."""
    pair.check()
    want, got = spill_state(pair.jeng), spill_state(pair.eng)
    assert got == want
    pair.eng.kv.check()
    return got


def recycle(pairs, budget=BIG, **kw):
    """The configuration's Pair from a cold cache at `budget` bytes."""
    pair = pairs(model=M23, **(TIGHT | kw))
    for e in (pair.jeng, pair.eng):
        e.set_prefix_cache(True)
        e.reset_prefix_cache()
        e.set_spill_budget(budget)
    return pair


def pressure_abb(pair, rng, max_new=5) -> dict:
    """a, b, b2: three distinct 12-token sequences through the tight pool,
    one at a time; b2's admission overflows the pool and spills a's pages
    (with a budget).  Returns the results."""
    results = {}
    for n in ("a", "b", "b2"):
        results.update(pair.run([(n, rng.integers(2, 23, 7).astype(np.int32),
                                  dict(max_new=max_new))]))
        check(pair)
    return results


def test_spill_then_restore_hit_matches_jax(pairs):
    """Pressure spills a retired run to the host, a later admission hits
    it and restores its pages; tokens, allocator, index and tier equal
    JAX's, restored tokens are bounded by restored pages, and the spilled
    pages freed their device pages."""
    pair = recycle(pairs)
    s0 = spill_state(pair.eng)
    res = pressure_abb(pair, np.random.default_rng(0))
    kv = pair.eng.kv
    assert kv.n_spilled - s0["spilled"] >= 2 and kv.host_page_count >= 2
    assert kv.free_page_count + kv.cached_page_count == kv.num_pages - 1
    seq_a = np.asarray(res["a"]).astype(np.int32)
    pair.run([("c", seq_a[:9].copy(), dict(max_new=4))])
    s1 = check(pair)
    assert s1["restore_hits"] - s0["restore_hits"] >= 1
    restored = s1["restored"] - s0["restored"]
    assert restored >= 2
    assert 0 < s1["restore_tokens_saved"] - s0["restore_tokens_saved"] \
        <= restored * kv.page_size
    kv.check_reclaimed()


def test_sampled_restore_hit_matches_jax(pairs):
    """Seeded sampling through a restored prefix (the JAX keys' noise)."""
    pair = recycle(pairs)
    rng = np.random.default_rng(1)
    s0 = spill_state(pair.eng)
    res = pair.run([("a", rng.integers(2, 23, 7).astype(np.int32),
                     dict(max_new=5, rng=11, **KNOBS[1]))])
    for n in ("b", "b2"):
        pair.run([(n, rng.integers(2, 23, 7).astype(np.int32),
                   dict(max_new=5))])
    assert check(pair)["spilled"] > s0["spilled"]
    seq_a = np.asarray(res["a"]).astype(np.int32)
    pair.run([("c", seq_a[:9].copy(), dict(max_new=4, rng=12, **KNOBS[2]))])
    assert check(pair)["restore_hits"] > s0["restore_hits"]
    pair.eng.kv.check_reclaimed()


def test_cow_divergence_mid_restored_page_matches_jax(pairs):
    """A prompt that follows a's sequence into a restored page and then
    diverges: the boundary page is restored, then copied on write; a
    later request of a's exact sequence still hits the untouched
    original."""
    pair = recycle(pairs)
    rng = np.random.default_rng(2)
    s0 = spill_state(pair.eng)
    res = pressure_abb(pair, rng)
    seq_a = np.asarray(res["a"]).astype(np.int32)
    cow0 = pair.eng.kv.n_cow
    d = np.concatenate([seq_a[:6], (seq_a[6:8] + 1) % 21 + 2,
                        rng.integers(2, 23, 2)]).astype(np.int32)
    pair.run([("d", d, dict(max_new=3))])
    assert check(pair)["restore_hits"] > s0["restore_hits"]
    assert pair.eng.kv.n_cow > cow0
    pair.run([("e", seq_a[:9].copy(), dict(max_new=3))])
    check(pair)
    pair.eng.kv.check_reclaimed()


def test_preempt_replay_with_the_spill_tier_matches_jax(pairs):
    """Two slots over the spilling pool: preemptions, evictions, spills
    and restores interleave."""
    pair = recycle(pairs, num_slots=2)
    rng = np.random.default_rng(3)
    res = pressure_abb(pair, rng)
    seq_a = np.asarray(res["a"]).astype(np.int32)
    seq_b = np.asarray(res["b"]).astype(np.int32)
    pre0 = pair.eng.n_preemptions
    pair.run([("r1", seq_a[:9].copy(), dict(max_new=6)),
              ("r2", seq_b[:9].copy(), dict(max_new=6)),
              ("r3", rng.integers(2, 23, 6).astype(np.int32),
               dict(max_new=6))])
    st = check(pair)
    assert pair.eng.n_preemptions > pre0 and st["spilled"] > 0
    assert (pair.eng.kv._ref == 0).all()
    pair.eng.kv.check_reclaimed()


def test_host_budget_evicts_lru_and_never_overflows_like_jax(pairs):
    """A one-page budget under two pages of spill pressure: the tier drops
    its least recently used HOST leaf; a hit on the dropped run admits the
    missing part cold."""
    pair = pairs(model=M23, **TIGHT)
    budget = pair.eng.kv.page_nbytes
    assert budget == pair.jeng.kv.page_nbytes
    pair = recycle(pairs, budget)
    s0 = spill_state(pair.eng)
    res = pressure_abb(pair, np.random.default_rng(4))
    st = check(pair)
    assert st["spilled"] - s0["spilled"] >= 2
    assert st["host_evicted"] > s0["host_evicted"]
    assert st["host_bytes"] <= budget
    seq_a = np.asarray(res["a"]).astype(np.int32)
    pair.run([("c", seq_a[:9].copy(), dict(max_new=4))])
    check(pair)
    pair.eng.kv.check_reclaimed()


def test_zero_budget_is_the_engine_without_the_tier(pairs):
    """Budget 0: pressure destroys victims, nothing spills or restores."""
    pair = recycle(pairs, 0)
    s0 = spill_state(pair.eng)
    ev0 = pair.eng.prefix.n_evictions
    res = pressure_abb(pair, np.random.default_rng(0))
    assert pair.eng.prefix.n_evictions > ev0
    seq_a = np.asarray(res["a"]).astype(np.int32)
    pair.run([("c", seq_a[:9].copy(), dict(max_new=4))])
    st = check(pair)
    assert (st["spilled"], st["restore_hits"], st["host_pages"]) == \
        (s0["spilled"], s0["restore_hits"], 0)
    pair.eng.kv.check_reclaimed()


def test_reset_prefix_cache_drains_the_tier_and_reproduces(pairs):
    """reset_prefix_cache drains both tiers and moves the generation; the
    workload run again gives the same tokens."""
    pair = recycle(pairs)
    first = pressure_abb(pair, np.random.default_rng(50))
    assert pair.eng.kv.host_page_count > 0
    gen0 = pair.eng.kv._host_gen
    for e in (pair.jeng, pair.eng):
        e.reset_prefix_cache()
    st = check(pair)
    assert (st["host_pages"], st["host_bytes"]) == (0, 0)
    assert st["gen"] == gen0 + 1
    assert pair.eng.kv.free_page_count == pair.eng.kv.num_pages - 1
    again = pressure_abb(pair, np.random.default_rng(50))
    for rid in first:
        np.testing.assert_array_equal(first[rid], again[rid])
    pair.eng.kv.check_reclaimed()


def test_set_prefix_cache_off_drains_the_tier(pairs):
    """Disabling the cache drains spilled nodes from the host tier and
    drops the device nodes' retention; re-enabled, it serves cold."""
    pair = recycle(pairs)
    res = pressure_abb(pair, np.random.default_rng(6))
    assert pair.eng.kv.host_page_count > 0
    for e in (pair.jeng, pair.eng):
        e.set_prefix_cache(False)
    assert (pair.eng.kv.host_page_count, pair.eng.kv.host_bytes,
            pair.eng.kv.cached_page_count) == (0, 0, 0)
    assert pair.eng.kv._host_drained == pair.jeng.kv._host_drained
    for e in (pair.jeng, pair.eng):
        e.set_prefix_cache(True)
    hits0 = pair.eng.n_restore_hits
    pair.run([("c", np.asarray(res["a"])[:9].astype(np.int32),
               dict(max_new=4))])
    assert check(pair)["restore_hits"] == hits0
    pair.eng.kv.check_reclaimed()


def test_set_spill_budget_shrinks_drains_and_regrows_like_jax(pairs):
    """Shrinking the budget drops LRU host leaves until the tier fits, 0
    drains it, growing it back spills again; the free list never moves."""
    pair = recycle(pairs)
    rng = np.random.default_rng(7)
    pressure_abb(pair, rng)
    assert pair.eng.kv.host_page_count >= 2
    free0 = list(pair.eng.kv._free)
    one = pair.eng.kv.page_nbytes
    for budget, pages in ((one, 1), (0, 0)):
        for e in (pair.jeng, pair.eng):
            e.set_spill_budget(budget)
        assert check(pair)["host_pages"] == pages
    assert pair.eng.kv._free == free0
    for e in (pair.jeng, pair.eng):
        e.set_spill_budget(BIG)
    s0 = spill_state(pair.eng)
    pair.run([("again", rng.integers(2, 23, 7).astype(np.int32),
               dict(max_new=5))])
    assert check(pair)["spilled"] > s0["spilled"]
    jbusy, busy = pair.requests([("busy", [3, 4, 5], dict(max_new=2))])
    pair.eng.add_request(busy[0])
    with pytest.raises(RuntimeError, match="idle"):
        pair.eng.set_spill_budget(0)
    pair.eng.run()
    pair.jeng.run(jbusy)
    pair.eng.kv.check_reclaimed()


def test_stale_generation_never_restores_like_jax(pairs):
    """Host entries of a dead generation never restore: the hit drops the
    stale subtree (drains) and admits cold."""
    pair = recycle(pairs)
    res = pressure_abb(pair, np.random.default_rng(8))
    assert pair.eng.kv.host_page_count == 2
    for e in (pair.jeng, pair.eng):
        e.kv._host_gen += 1
    s0 = spill_state(pair.eng)
    seq_a = np.asarray(res["a"]).astype(np.int32)
    pair.run([("c", seq_a[:9].copy(), dict(max_new=3))])
    st = check(pair)
    assert (st["restore_hits"], st["restored"]) == (s0["restore_hits"],
                                                    s0["restored"])
    assert st["drained"] == s0["drained"] + 2
    assert all(pair.eng.kv.host_entry_live(h) for h in pair.eng.kv._host)
    pair.eng.kv.check_reclaimed()


def test_save_load_state_carries_the_host_tier(pairs, tmp_path):
    """A snapshot taken with pages on the host carries them; a fresh port
    engine loaded from it holds the same residency, and a hit on the
    migrated run restores from the migrated bytes with the donor's and
    JAX's tokens."""
    pair = recycle(pairs)
    res = pressure_abb(pair, np.random.default_rng(9))
    h0 = pair.eng.kv.host_page_count
    assert h0 > 0
    path = str(tmp_path / "engine.pkl")
    pair.eng.save_state(path)
    seq_a = np.asarray(res["a"]).astype(np.int32)
    want = pair.run([("c", seq_a[:9].copy(), dict(max_new=4))])
    _, ex, params = lm(*M23)
    other = ServingEngine(ex, params, device="cpu", noise=pair._noise,
                          **TIGHT)
    other.load_state(path)
    assert spill_state(other)["host_nodes"] and \
        other.kv.host_page_count == h0
    other.kv.check()
    restored0 = other.kv.n_restored
    got = other.run(pair.requests([("c", seq_a[:9].copy(),
                                    dict(max_new=4))])[1])
    assert other.kv.n_restored > restored0
    np.testing.assert_array_equal(got["c"], want["c"])
    other.kv.check_reclaimed()


def test_allocator_spill_restore_units_match_jax():
    """PagedKVCache on both packages: spill frees the device page and banks
    its bytes, the budget bound refuses a spill, take/untake roll back
    exactly, a restore moves the bytes back (a planted marker survives),
    and reset drains the tier and moves the generation — states equal
    after every operation."""
    tr, ex, _ = lm(*M23)
    jkv = JPagedKVCache(tr.executor, num_slots=2, page_size=4,
                        pages_per_slot=3, num_pages=8, spill_bytes_budget=BIG)
    kv = PagedKVCache(ex, 2, 4, 3, torch.device("cpu"), num_pages=8,
                      spill_bytes_budget=BIG)

    def same(out=(None, None)):
        assert out[1] == out[0]
        assert alloc_state(kv) == alloc_state(jkv)
        for a in ("n_spilled", "n_restored", "n_host_evicted",
                  "_host_drained", "host_bytes", "host_page_count",
                  "_next_hid", "_host_gen", "page_nbytes"):
            assert getattr(kv, a) == getattr(jkv, a), a

    same((jkv.try_grow(0, 12), kv.try_grow(0, 12)))
    pages = [int(kv.table[0, j]) for j in range(3)]
    name = next(iter(kv.pools))
    jkv.pools[name]["k"] = jkv.pools[name]["k"].at[pages[0], 1, 0, 2].set(7.5)
    kv.pools[name]["k"][pages[0], 1, 0, 2] = 7.5
    for p in pages:
        jkv.cache_page(p)
        kv.cache_page(p)
    jkv.release(0)
    kv.release(0)
    same()
    kv.check()
    hid = kv.spill_page(pages[0])
    same((jkv.spill_page(pages[0]), hid))
    for k in (jkv, kv):
        k.spill_bytes_budget = k.page_nbytes
    same((jkv.spill_page(pages[1]), kv.spill_page(pages[1])))
    for k in (jkv, kv):
        k.spill_bytes_budget = BIG
    free0 = list(kv._free)
    taken = kv.take_pages(2)
    same((jkv.take_pages(2), taken))
    jkv.untake_pages(taken)
    kv.untake_pages(taken)
    same()
    assert kv._free == free0
    dst = kv.take_pages(1)
    same((jkv.take_pages(1), dst))
    jkv.restore_pages([hid], dst)
    kv.restore_pages([hid], dst)
    jkv.adopt_restored(dst)
    kv.adopt_restored(dst)
    same()
    assert float(kv.pools[name]["k"][dst[0], 1, 0, 2]) == 7.5
    np.testing.assert_array_equal(
        kv.pools[name]["k"][dst[0]].numpy(),
        np.asarray(jkv.pools[name]["k"][dst[0]]))
    assert not kv.host_entry_live(hid)
    kv.drop_host_page(hid)
    jkv.drop_host_page(hid)
    same()
    kv.check()
    hid2 = kv.spill_page(pages[1])
    same((jkv.spill_page(pages[1]), hid2))
    jkv.reset()
    kv.reset()
    same()
    kv.check()
    assert not kv.host_entry_live(hid2) and kv.host_page_count == 0
