"""PyTorch port: the prefix cache — the refcounted allocator
(serving/paged_kv.py), the radix index (serving/prefix_tree.py) and the
engine's prefix-hit admission, copy-on-write, eviction and
preempt-replay — against the JAX package on the CPU, exactly.

A seeded random sequence of allocator and index operations runs on both
packages with the table, refcounts, cached marks, free-list order, COW
count and the index's nodes equal after every operation.  The engine
cases of tests/test_prefix_cache.py run on both engines in the same
configuration (prefix cache on, pools overcommitted where the reference
overcommits them): tokens, finish reasons, every streamed token, the
counters and the allocator and index state must be equal; sampled
requests get the JAX engine's Gumbel noise through the port's `noise`
hook.

`Pair` (also used by tests/test_torch_serving_lifecycle.py and
tests/test_torch_engine_state.py) builds each configuration's two
engines once per module and resets them between cases with
`reset_prefix_cache()`, so the JAX engine compiles its steps once.

Toy widths, as the reference's tests: vocab 23, dim 16, 2 layers, 2
heads."""

import functools
import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import PrefixTree as JPrefixTree
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.trainer.trainer import Trainer
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.models import transformer_lm_config
from paddle_tpu_torch.parameter import params_from_jax
from paddle_tpu_torch.serving import (PagedKVCache, PrefixTree, Request,
                                      ServingEngine)

# counters the two engines must move alike
COUNTERS = ("n_decode_steps", "n_mixed_steps", "n_prefill_chunks",
            "tokens_generated", "n_preemptions", "n_cancelled", "n_expired",
            "n_prefix_hits", "n_prefix_misses", "prefill_tokens_saved",
            "n_scan_flushes", "n_scan_steps")


@functools.lru_cache(maxsize=None)
def lm(vocab: int, dim: int, layers: int, heads: int):
    """(JAX trainer, port executor, the trainer's parameters carried
    across), once per width."""
    cfg = parse_config("demo/model_zoo/transformer_lm.py",
                       f"vocab={vocab},dim={dim},layers={layers},"
                       f"heads={heads},batch_size=4")
    tr = Trainer(cfg, seed=7)
    ex = GraphExecutor(transformer_lm_config(vocab, dim, layers, heads))
    params = params_from_jax({k: np.asarray(v) for k, v in tr.params.items()},
                             device="cpu")
    return tr, ex, params


def alloc_state(kv) -> dict:
    return {"table": kv.table.tolist(), "ref": kv._ref.tolist(),
            "cached": kv._cached.tolist(), "free": list(kv._free),
            "n_pages": kv._n_pages.tolist()}


def tree_state(tree, clock0: int = 0) -> list:
    """Every node as (token path, page, LRU stamp - clock0), in walk
    order, then the clock and the node count."""
    if tree is None:
        return []
    out, stack = [], [(tree.root, ())]
    while stack:
        node, path = stack.pop()
        for ch in node.children.values():
            p = path + ch.run
            out.append((p, int(ch.page), ch.last_use - clock0))
            stack.append((ch, p))
    return sorted(out) + [("clock", tree._clock - clock0),
                          ("nodes", tree.n_nodes)]


def _token_recorder(stream: dict):
    return lambda rid, tok, i: stream.setdefault(rid, []).append((i, tok))


def _finish_recorder(fin: dict):
    def record(rid, toks, why):
        fin[rid] = (np.asarray(toks).tolist(), why)
    return record


class Pair:
    """A JAX engine and a port engine of one configuration.  `reset()`
    returns both to a cold start (and forgets results, hooks, the clock
    and the case's noise keys); `check()` holds the port against the JAX
    engine: counters moved alike since the reset, allocator, index, queue
    and slots equal, and every token streamed and every finish equal."""

    def __init__(self, model, **kw):
        tr, ex, params = model
        self.jeng = JServingEngine(tr.executor, tr.params, **kw)
        self.eng = ServingEngine(ex, params, device="cpu", noise=self._noise,
                                 **kw)
        self.reset()

    def _noise(self, req, g, vocab, device):
        key = (req.req_id, g)
        if key not in self._drawn:
            k = jax.random.split(self._keys[req.req_id], req.max_new)[g]
            self._drawn[key] = np.asarray(jax.random.gumbel(k, (1, vocab)))[0]
        return torch.tensor(self._drawn[key], device=device)

    def reset(self, decode_steps: int = 1) -> None:
        self._keys, self._drawn = {}, {}
        self.streams = ({}, {})           # JAX, port: rid -> [(idx, tok)]
        self.finishes = ({}, {})          # rid -> (tokens, reason)
        for e, stream, fin in zip((self.jeng, self.eng), self.streams,
                                  self.finishes):
            assert not e.queue and all(sl is None for sl in e.slots)
            e.reset_prefix_cache()
            e.set_decode_steps(decode_steps)
            e.results.clear()
            e.finish_reasons.clear()
            e.clock = time.monotonic
            e.on_token = _token_recorder(stream)
            e.on_finish = _finish_recorder(fin)
        self._base = [{c: getattr(e, c) for c in COUNTERS}
                      | {"n_cow": e.kv.n_cow,
                         "n_evictions": getattr(e.prefix, "n_evictions", 0)}
                      for e in (self.jeng, self.eng)]
        self._clock0 = [getattr(e.prefix, "_clock", 0)
                        for e in (self.jeng, self.eng)]

    def requests(self, specs):
        """[(req_id, prompt, knobs)] -> (JAX requests, port requests);
        knobs may hold `rng` (the JAX key's seed, default 0)."""
        jreqs, reqs = [], []
        for rid, prompt, kw in specs:
            kw = dict(kw)
            rng = jax.random.PRNGKey(kw.pop("rng", 0))
            self._keys[rid] = rng
            jreqs.append(JRequest(rid, prompt, rng=rng, **kw))
            reqs.append(Request(rid, prompt, **kw))
        return jreqs, reqs

    def add(self, specs) -> None:
        jreqs, reqs = self.requests(specs)
        for a, b in zip(jreqs, reqs):
            self.jeng.add_request(a)
            self.eng.add_request(b)

    def step(self) -> bool:
        busy = self.jeng.step()
        assert self.eng.step() == busy
        return busy

    def run(self, specs=()) -> dict:
        jreqs, reqs = self.requests(specs)
        want = self.jeng.run(jreqs)
        got = self.eng.run(reqs)
        assert sorted(got, key=str) == sorted(want, key=str)
        for rid in want:
            np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                          err_msg=f"request {rid!r}")
        self.check()
        return got

    def counters(self) -> tuple[dict, dict]:
        out = []
        for e, base in zip((self.jeng, self.eng), self._base):
            now = {c: getattr(e, c) for c in COUNTERS} | {
                "n_cow": e.kv.n_cow,
                "n_evictions": getattr(e.prefix, "n_evictions", 0)}
            out.append({c: now[c] - base[c] for c in now})
        return out[0], out[1]

    def check(self) -> None:
        j, p = self.jeng, self.eng
        cj, cp = self.counters()
        assert cp == cj
        assert alloc_state(p.kv) == alloc_state(j.kv)
        assert tree_state(p.prefix, self._clock0[1]) == \
            tree_state(j.prefix, self._clock0[0])
        assert [r.req_id for r in p.queue] == [r.req_id for r in j.queue]
        assert [None if sl is None else
                (sl.req.req_id, sl.pos, sl.gen, list(sl.generated))
                for sl in p.slots] == \
            [None if sl is None else
             (sl.req.req_id, sl.pos, sl.gen, list(sl.generated))
             for sl in j.slots]
        assert set(p.results) == set(j.results)
        for rid in j.results:
            np.testing.assert_array_equal(p.results[rid],
                                          np.asarray(j.results[rid]))
        assert p.finish_reasons == j.finish_reasons
        assert self.streams[1] == self.streams[0]
        assert self.finishes[1] == self.finishes[0]


def prompts(lens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lens]


KNOBS = [dict(), dict(temperature=0.8, top_k=5),
         dict(temperature=0.7, top_p=0.9), dict(temperature=1.1)]

M23 = (23, 16, 2, 2)


@pytest.fixture(scope="module")
def pairs():
    """One Pair per configuration, built on first use."""
    built = {}

    def get(model=M23, **kw):
        key = (model, tuple(sorted(kw.items())))
        if key not in built:
            built[key] = Pair(lm(*model), **kw)
        pair = built[key]
        pair.reset()
        return pair
    return get


# ---------------------------------------------------------------------------
# allocator and index: a seeded random operation sequence on both packages
# ---------------------------------------------------------------------------

def test_random_allocator_and_index_operations_match_jax():
    """About 200 operations — try_grow with and without eviction,
    map_shared of a match, ensure_writable, release, insert, match,
    evict_for, reset — on a 4-slot allocator of 13 real pages and its
    index: return values, table, refcounts, cached marks, free-list
    order, n_cow and the nodes equal after every operation, and the
    invariants hold."""
    tr, ex, _ = lm(*M23)
    S, ps, pps, P = 4, 2, 4, 14
    jkv = JPagedKVCache(tr.executor, S, ps, pps, num_pages=P)
    kv = PagedKVCache(ex, S, ps, pps, torch.device("cpu"), num_pages=P)
    jtree, tree = JPrefixTree(jkv), PrefixTree(kv)
    jkv.on_page_pressure, kv.on_page_pressure = jtree.evict_for, \
        tree.evict_for
    rng = np.random.default_rng(11)
    toks = [[] for _ in range(S)]      # the tokens each slot's pages hold
    kinds = {}
    for _ in range(200):
        op = rng.choice(["grow", "grow_noevict", "map", "cow", "release",
                         "insert", "match", "evict", "reset"],
                        p=[.22, .08, .14, .12, .12, .14, .08, .06, .04])
        s = int(rng.integers(S))
        n = int(kv._n_pages[s])
        if op in ("grow", "grow_noevict"):
            want = int(rng.integers(1, pps * ps + 1))
            ev = op == "grow"
            out = (jkv.try_grow(s, want, evict=ev),
                   kv.try_grow(s, want, evict=ev))
            toks[s] += rng.integers(2, 5, int(kv._n_pages[s]) * ps
                                    - len(toks[s])).tolist()
        elif op == "map":
            if n:
                continue
            query = rng.integers(2, 5, int(rng.integers(1, 9))).astype(
                np.int32)
            (jp, jpart), (pp, ppart) = jtree.match(query), tree.match(query)
            out = ((jp, jpart), (pp, ppart))
            pages = pp + ([ppart[0]] if ppart is not None else [])
            if pages:
                jkv.map_shared(s, pages)
                kv.map_shared(s, pages)
                toks[s] = query.tolist()[:len(pp) * ps] + [
                    -1] * (len(pages) * ps - len(pp) * ps)
        elif op == "cow":
            if not n:
                continue
            j = int(rng.integers(n))
            out = (jkv.ensure_writable(s, j), kv.ensure_writable(s, j))
        elif op == "release":
            jkv.release(s)
            kv.release(s)
            toks[s] = []
            out = (None, None)
        elif op == "insert":
            m = int(rng.integers(0, n + 1))
            if not m or -1 in toks[s][:m * ps]:
                continue
            seq = np.asarray(toks[s][:m * ps], np.int32)
            pages = [int(kv.table[s, j]) for j in range(m)]
            out = (jtree.insert(seq, pages), tree.insert(seq, pages))
        elif op == "match":
            query = rng.integers(2, 5, int(rng.integers(1, 10))).astype(
                np.int32)
            out = (jtree.match(query), tree.match(query))
        elif op == "evict":
            k = int(rng.integers(1, 4))
            out = (jtree.evict_for(k), tree.evict_for(k))
        else:
            jkv.reset()
            kv.reset()
            jtree.clear()
            tree.clear()
            toks = [[] for _ in range(S)]
            out = (None, None)
        kinds[op] = kinds.get(op, 0) + 1
        assert out[1] == out[0], op
        assert alloc_state(kv) == alloc_state(jkv), op
        assert kv.n_cow == jkv.n_cow, op
        assert tree_state(tree) == tree_state(jtree), op
        kv.check()
    assert kv.n_cow > 0 and tree.n_evictions > 0 and kinds["reset"] > 0
    assert sum(kinds.values()) >= 150


def test_allocator_units_match_jax():
    """The reference's allocator units: release is idempotent, reset
    rebuilds the canonical free list, map_shared refcounts and a COW that
    copies the page's bytes, a COW on a dry pool answers None, and the
    index's match / insert / LRU leaf-first eviction — on both packages,
    states equal."""
    tr, ex, _ = lm(*M23)

    def both(S, pps, P, ps=4):
        return (JPagedKVCache(tr.executor, S, ps, pps, num_pages=P),
                PagedKVCache(ex, S, ps, pps, torch.device("cpu"),
                             num_pages=P))

    jkv, kv = both(2, 3, 8)
    for k in (jkv, kv):
        assert k.try_grow(0, 9) and k.try_grow(1, 4)
        free = k.free_page_count
        k.release(0)
        k.release(0)
        assert k.free_page_count == free + 3
        k.reset()
        k.release(1)
        assert k.free_page_count == k.num_pages - 1
        assert k.try_grow(0, 12) and k.try_grow(1, 7)
        k.release(1)
        k.cache_page(int(k.table[0, 0]))
        k.reset()
        assert k._free == k._canonical_free() and k.cached_page_count == 0
    assert alloc_state(kv) == alloc_state(jkv)

    jkv, kv = both(3, 2, 8)
    name = next(iter(kv.pools))
    for k in (jkv, kv):
        assert k.try_grow(0, 8)
        donor = [int(k.table[0, 0]), int(k.table[0, 1])]
        k.cache_page(donor[0])
        k.cache_page(donor[1])
        k.map_shared(1, donor)
        k.map_shared(2, donor[:1])
        assert k._ref[donor[0]] == 3 and k.shared_pages_in_use == 2
    kv.pools[name]["k"][donor[0], 0, 0, 0] = 7.5
    jkv.pools[name]["k"] = jkv.pools[name]["k"].at[donor[0], 0, 0, 0].set(7.5)
    assert kv.ensure_writable(1, 0) is jkv.ensure_writable(1, 0) is True
    fresh = int(kv.table[1, 0])
    assert float(kv.pools[name]["k"][fresh, 0, 0, 0]) == 7.5
    assert kv.ensure_writable(1, 0) is jkv.ensure_writable(1, 0) is False
    for k in (jkv, kv):
        for s in range(3):
            k.release(s)
        assert k.cached_page_count == 2
    assert alloc_state(kv) == alloc_state(jkv)

    jkv, kv = both(2, 2, 3)
    for k in (jkv, kv):
        assert k.try_grow(0, 8)
        k.cache_page(int(k.table[0, 0]))
        k.map_shared(1, [int(k.table[0, 0])])
        assert k.ensure_writable(1, 0) is None
        k.check()

    jkv, kv = both(1, 4, 12)
    jtree, tree = JPrefixTree(jkv), PrefixTree(kv)
    seq = np.arange(2, 18, dtype=np.int32)
    for k, t in ((jkv, jtree), (kv, tree)):
        k.on_page_pressure = t.evict_for
        assert k.try_grow(0, 16)
        pages = [int(k.table[0, j]) for j in range(4)]
        assert t.insert(seq, pages) == 4 and t.insert(seq, pages) == 0
        k.release(0)
        assert t.match(seq[:11]) == (pages[:2], (pages[2], 3))
        assert t.match(np.asarray([99, 98], np.int32)) == ([], None)
        assert t.evict_for(1) == 1 and t.match(seq)[0] == pages[:3]
        k.map_shared(0, pages[:3])
        assert t.evict_for(99) == 0
        k.release(0)
        assert t.evict_for(99) == 3
        assert k.free_page_count == k.num_pages - 1
    assert alloc_state(kv) == alloc_state(jkv)
    assert tree_state(tree) == tree_state(jtree)


# ---------------------------------------------------------------------------
# the engine cases of tests/test_prefix_cache.py, on both engines
# ---------------------------------------------------------------------------

def test_shared_prefix_hits(pairs):
    """Requests sharing a 19-token system prompt, mixed sampling knobs,
    run one after another: the later ones hit the earlier donations."""
    pair = pairs(num_slots=2, page_size=8, max_context=64)
    rng = np.random.default_rng(0)
    system = rng.integers(2, 23, 19).astype(np.int32)
    for i, kw in enumerate(KNOBS):
        pair.run([(f"r{i}", np.concatenate(
            [system, rng.integers(2, 23, 3 + i).astype(np.int32)]),
            dict(max_new=5, rng=40 + i, **kw))])
    cj, cp = pair.counters()
    assert cp["n_prefix_hits"] >= 3 and cp["prefill_tokens_saved"] >= 48
    pair.eng.kv.check_reclaimed()


def test_concurrent_same_prefix_requests_share_pages(pairs):
    """Two live slots map the same cached prefix at once (refcount > 1);
    each writes only its private boundary copy."""
    pair = pairs(num_slots=2, page_size=8, max_context=64)
    rng = np.random.default_rng(1)
    system = rng.integers(2, 23, 17).astype(np.int32)
    pair.run([("warm", system.copy(), dict(max_new=9))])
    pair.add([("a", np.concatenate([system, [3, 4, 5]]).astype(np.int32),
               dict(max_new=6)),
              ("b", np.concatenate([system, [6, 7]]).astype(np.int32),
               dict(max_new=6))])
    pair.step()
    pair.check()
    assert pair.eng.kv.shared_pages_in_use >= 2
    assert pair.counters()[1]["n_prefix_hits"] == 2
    pair.run()
    pair.eng.kv.check_reclaimed()


def test_cow_divergence_mid_page_keeps_the_donor_page(pairs):
    """B follows A's prompt into a page and diverges mid-page (COW); C
    repeats A's prompt and hits the original page, unchanged."""
    pair = pairs(num_slots=2, page_size=8, max_context=64)
    rng = np.random.default_rng(2)
    base = rng.integers(2, 23, 13).astype(np.int32)
    pair.run([("a", base.copy(), dict(max_new=6))])
    b = np.concatenate([base[:11], (base[11:13] + 1) % 23 + 2,
                        rng.integers(2, 23, 4)]).astype(np.int32)
    pair.run([("b", b, dict(max_new=6))])
    assert pair.counters()[1]["n_cow"] > 0
    pair.run([("c", base.copy(), dict(max_new=6))])
    assert pair.counters()[1]["n_prefix_hits"] >= 2
    pair.eng.kv.check_reclaimed()


def test_eviction_runs_before_pausing(pairs):
    """4 real pages, a tree fat with retired prefixes: admission and
    growth reclaim by LRU eviction, no preemption."""
    pair = pairs(num_slots=1, page_size=4, max_context=16, num_pages=5)
    rng = np.random.default_rng(3)
    for i in range(2):
        pair.run([(f"f{i}", rng.integers(2, 23, 7).astype(np.int32),
                   dict(max_new=5))])
    assert pair.eng.kv.cached_page_count > 0
    pair.run([("big", rng.integers(2, 23, 9).astype(np.int32),
               dict(max_new=7))])
    c = pair.counters()[1]
    assert c["n_evictions"] > 0 and c["n_preemptions"] == 0
    pair.eng.kv.check_reclaimed()


def test_eviction_racing_admission_of_the_same_prefix(pairs):
    """The admission that hits a prefix evicts for its suffix pages: the
    matched pages are mapped first, so eviction takes other nodes."""
    pair = pairs(num_slots=1, page_size=4, max_context=16, num_pages=7)
    rng = np.random.default_rng(4)
    keep = rng.integers(2, 23, 8).astype(np.int32)
    pair.run([("keep", keep, dict(max_new=5))])
    pair.run([("other", rng.integers(2, 23, 7).astype(np.int32),
               dict(max_new=4))])
    ev0 = pair.counters()[1]["n_evictions"]
    pair.run([("hit", np.concatenate([keep, rng.integers(2, 23, 5)])
               .astype(np.int32), dict(max_new=3))])
    c = pair.counters()[1]
    assert c["n_prefix_hits"] >= 1 and c["n_evictions"] > ev0
    pair.eng.kv.check_reclaimed()


@pytest.mark.parametrize("sampled", [False, True])
def test_preempt_replay_hits_its_own_donation(pairs, sampled):
    """5 real pages for 2 slots of 4: preemption donates the victim's
    committed pages, its replay prefix-hits them and draws the same
    noise; refcounts end at zero."""
    pair = pairs(num_slots=2, page_size=4, max_context=16, num_pages=6)
    rng = np.random.default_rng(5)
    pair.run([(i, p, dict(max_new=8, rng=60 + i,
                          **(KNOBS[i + 1] if sampled else {})))
              for i, p in enumerate([rng.integers(2, 23, n).astype(np.int32)
                                     for n in (6, 4, 5)])])
    c = pair.counters()[1]
    assert c["n_preemptions"] > 0 and c["n_prefix_hits"] > 0
    assert (pair.eng.kv._ref == 0).all()
    pair.eng.kv.check_reclaimed()


def test_overcommitted_pool_with_hits_under_churn(pairs):
    """Three waves of two repeated bases over 7 real pages, one request
    added per step: hits, evictions, COWs and preemptions interleave."""
    pair = pairs(num_slots=2, page_size=4, max_context=16, num_pages=8)
    rng = np.random.default_rng(6)
    bases = [rng.integers(2, 23, 9).astype(np.int32) for _ in range(2)]
    for w in range(3):
        for i, base in enumerate(bases):
            pair.add([(f"w{w}b{i}", np.concatenate(
                [base, rng.integers(2, 23, 1 + w).astype(np.int32)]),
                dict(max_new=4))])
            pair.step()
            pair.check()
    pair.run()
    assert pair.counters()[1]["n_prefix_hits"] > 0
    pair.eng.kv.check_reclaimed()


def test_reset_prefix_cache_restores_cold_start(pairs):
    """reset_prefix_cache empties the index and restores the canonical
    free list: the same workload again gives the same tokens and the same
    cached pages."""
    pair = pairs(num_slots=2, page_size=8, max_context=64)
    system = np.random.default_rng(5).integers(2, 23, 18).astype(np.int32)

    def specs():
        return [(f"r{j}", np.concatenate(
            [system, np.random.default_rng(50 + j).integers(2, 23, 2 + j)
             .astype(np.int32)]), dict(max_new=4)) for j in range(3)]

    first = pair.run(specs())
    cached = np.flatnonzero(pair.eng.kv._cached).tolist()
    assert pair.counters()[1]["n_prefix_hits"] > 0
    pair.reset()
    kv = pair.eng.kv
    assert pair.eng.prefix.n_nodes == 0 and kv.cached_page_count == 0
    assert kv._free == kv._canonical_free()
    again = pair.run(specs())
    for rid in first:
        np.testing.assert_array_equal(first[rid], again[rid])
    assert np.flatnonzero(kv._cached).tolist() == cached
    kv.check_reclaimed()


def test_set_prefix_cache_detaches_and_attaches(pairs):
    """Turned off on an idle engine, the index lets go of every page (the
    pool drains to the free list) and admissions count neither hits nor
    misses; turned on again it starts empty — on both engines alike."""
    pair = pairs(num_slots=2, page_size=8, max_context=64)
    base = np.random.default_rng(7).integers(2, 23, 20).astype(np.int32)
    pair.run([("a", base, dict(max_new=4))])
    assert pair.eng.kv.cached_page_count > 0
    for e in (pair.jeng, pair.eng):
        e.set_prefix_cache(False)
    assert pair.eng.prefix is None
    assert pair.eng.kv.free_page_count == pair.eng.kv.num_pages - 1
    assert alloc_state(pair.eng.kv) == alloc_state(pair.jeng.kv)
    pair.run([("b", base, dict(max_new=4))])
    for e in (pair.jeng, pair.eng):
        e.set_prefix_cache(True)
    pair.run([("c", base, dict(max_new=4))])
    pair.run([("d", base, dict(max_new=4))])
    c = pair.counters()[1]
    assert (c["n_prefix_hits"], c["n_prefix_misses"]) == (1, 2)
    pair.eng.kv.check_reclaimed()
