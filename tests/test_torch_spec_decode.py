"""PyTorch port: speculative decode in the serving engine — the verify
step (serving/engine.py `_run_spec_step`), the drafters
(serving/drafter.py), `pick_next_chain` (serving/sampler.py),
`uncommit_tail` (serving/paged_kv.py) and `build_draft_roll`
(graph/lm_decode.py) — against the JAX package on the CPU, exactly.

The engine cases mirror tests/test_spec_decode.py and
tests/test_multi_step.py's decode_mode cases.  Each runs on a JAX engine
and a port engine of one configuration (tests/test_torch_prefix_cache.py's
`Pair`, extended here by the speculation counters and each slot's
accept-rate state): tokens, every streamed token, finish reasons, the
counters and the allocator and prefix-index state equal; sampled requests
get the JAX engine's Gumbel noise through the port's `noise` hook.  The
port's spec-on tokens are also held against the port with speculation off.
Each configuration's pair is built once per module and reset between
cases, so the JAX engine compiles its steps once.

Unit cases hold the drafters' proposals, the chain sampler fed JAX's
noise and the allocator with `uncommit_tail` in a seeded random operation
sequence equal to the JAX package's.  Token, id and allocator checks are
exact; no case has a tolerance.

Toy widths, as the reference's tests: vocab 11, 23 or 97, dim 16 or 32,
1-2 layers, 2-4 heads."""

import functools

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.serving import NgramDrafter as JNgramDrafter
from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import PrefixTree as JPrefixTree
from paddle_tpu.serving.drafter import ModelDrafter as JModelDrafter
from paddle_tpu.serving.drafter import clamp_proposal as jclamp_proposal
from paddle_tpu.serving.sampler import pick_next_chain as jpick_next_chain
from paddle_tpu.trainer.trainer import Trainer
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.models import transformer_lm_config
from paddle_tpu_torch.parameter import params_from_jax
from paddle_tpu_torch.serving import (ModelDrafter, NgramDrafter,
                                      PagedKVCache, PrefixTree,
                                      ServingEngine, clamp_proposal)
from paddle_tpu_torch.serving.sampler import pick_next_chain
from test_torch_prefix_cache import (KNOBS, Pair, alloc_state, lm,
                                     tree_state)

SPEC_COUNTERS = ("n_spec_steps", "n_spec_chains", "n_spec_drafted",
                 "n_spec_accepted", "n_spec_tokens", "n_draft_steps")

M11 = (11, 16, 1, 2)
M23 = (23, 16, 1, 2)
# the reference's main configuration, its tight-budget one, its
# overcommitted one and its decode_mode one
S23 = dict(num_slots=2, page_size=4, max_context=32, spec_k=3)
TIGHT = dict(num_slots=2, page_size=4, max_context=32, prefill_chunk=4,
             max_step_tokens=8, spec_k=2)
OVER = dict(num_slots=2, page_size=4, max_context=16, num_pages=6, spec_k=3)
MODES = dict(num_slots=2, page_size=8, max_context=64, spec_k=2)


@functools.lru_cache(maxsize=None)
def lm_gqa(vocab: int, dim: int, layers: int, heads: int, kv_heads: int):
    """As test_torch_prefix_cache.lm, grouped-query attention."""
    cfg = parse_config("demo/model_zoo/transformer_lm.py",
                       f"vocab={vocab},dim={dim},layers={layers},"
                       f"heads={heads},batch_size=4,kv_heads={kv_heads}")
    tr = Trainer(cfg, seed=5)
    ex = GraphExecutor(transformer_lm_config(vocab, dim, layers, heads,
                                             kv_heads=kv_heads))
    params = params_from_jax({k: np.asarray(v) for k, v in tr.params.items()},
                             device="cpu")
    return tr, ex, params


class SpecPair(Pair):
    """`Pair` with speculation: `spec()` configures both engines alike,
    and `check()` also holds the speculation counters (since the reset)
    and each live slot's accept-rate state."""

    def reset(self, decode_steps: int = 1) -> None:
        super().reset(decode_steps)
        self._spec_base = [{c: getattr(e, c) for c in SPEC_COUNTERS}
                           for e in (self.jeng, self.eng)]

    def spec(self, k: int, drafter=None, jdrafter=None, dynamic=False,
             mode: str = "auto") -> None:
        """Speculation at depth k on both engines: `drafter` on both (a
        numpy drafter), or `jdrafter` / `drafter` each its own, default a
        fresh NgramDrafter each."""
        if jdrafter is None:
            jdrafter = drafter if drafter is not None else JNgramDrafter()
        self.jeng.set_speculation(k, jdrafter, dynamic=dynamic)
        self.eng.set_speculation(
            k, drafter if drafter is not None else NgramDrafter(),
            dynamic=dynamic)
        self.jeng.set_decode_mode(mode)
        self.eng.set_decode_mode(mode)
        assert self.eng.max_step_tokens == self.jeng.max_step_tokens

    def spec_counters(self) -> tuple[dict, dict]:
        return tuple({c: getattr(e, c) - base[c] for c in SPEC_COUNTERS}
                     for e, base in zip((self.jeng, self.eng),
                                        self._spec_base))

    def check(self) -> None:
        super().check()
        cj, cp = self.spec_counters()
        assert cp == cj
        assert [None if sl is None else (sl.accept_ewma, sl.probe_tick)
                for sl in self.eng.slots] == \
            [None if sl is None else (sl.accept_ewma, sl.probe_tick)
             for sl in self.jeng.slots]

    def port_alone(self, model, specs, **kw) -> tuple[dict, ServingEngine]:
        """`specs` on a fresh port engine of configuration `kw` (spec off
        unless kw says otherwise), with this pair's noise."""
        _, ex, params = model
        eng = ServingEngine(ex, params, device="cpu", noise=self._noise,
                            **kw)
        _, reqs = self.requests(specs)
        return eng.run(reqs), eng


@pytest.fixture(scope="module")
def spec_pairs():
    """One SpecPair per configuration, built on first use, reset and set
    to spec_k with the default drafter for each case."""
    built = {}

    def get(model=M23, loader=lm, **kw):
        key = (model, tuple(sorted(kw.items())))
        if key not in built:
            built[key] = SpecPair(loader(*model), **kw)
        pair = built[key]
        pair.reset()
        pair.spec(kw.get("spec_k", 0))
        return pair
    return get


def rep_prompt(rng, vocab: int, n: int, motif: int = 4) -> np.ndarray:
    """A tiled random motif: the locally repetitive prompt a prompt-lookup
    drafter finds continuations in."""
    m = rng.integers(2, vocab, motif).astype(np.int32)
    return np.tile(m, -(-n // motif))[:n]


def assert_same(got: dict, want: dict, what: str) -> None:
    assert sorted(got, key=str) == sorted(want, key=str)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{what}: request {rid!r}")


def spec_off(spec: dict) -> dict:
    return {k: v for k, v in spec.items() if k != "spec_k"}


class Wrong:
    """Always wrong: token 0 is never emitted (prompts draw from 2..)."""

    def propose(self, ctx, k):
        return np.zeros(k, np.int32)


class Replay:
    """Replays a recorded continuation `full` while the context is its
    prefix (the oracle drafter); `parity` proposes only at even context
    lengths, so drafted and draft-free steps alternate."""

    def __init__(self, full, parity: bool = False):
        self.full, self.parity = np.asarray(full, np.int32), parity

    def propose(self, ctx, k):
        n = ctx.size
        if (not self.parity or n % 2 == 0) and n < self.full.size and \
                np.array_equal(self.full[:n], ctx):
            return self.full[n:n + k]
        return np.zeros(0, np.int32)


# ---------------------------------------------------------------------------
# the engine cases of tests/test_spec_decode.py
# ---------------------------------------------------------------------------

def test_spec_on_equals_spec_off_across_sampling_knobs(spec_pairs):
    """Greedy, top-k, nucleus and full sampling on repetitive prompts: the
    port's spec-on tokens equal JAX's and the port's spec-off, with drafts
    accepted."""
    pair = spec_pairs(**S23)
    specs = [(f"r{i}", rep_prompt(np.random.default_rng(100 + i), 23,
                                  11 + 2 * i), dict(max_new=8, rng=40 + i,
                                                    **kw))
             for i, kw in enumerate(KNOBS)]
    got = pair.run(specs)
    off, _ = pair.port_alone(lm(*M23), specs, **spec_off(S23))
    assert_same(got, off, "spec on against off")
    cj, cp = pair.spec_counters()
    assert cp["n_spec_drafted"] > 0 and cp["n_spec_accepted"] > 0
    assert pair.eng.drafter_kind == "ngram"
    pair.eng.kv.check_reclaimed()


def test_spec_gqa_grouped_heads_stay_exact(spec_pairs):
    """Grouped-query attention (4 heads over 2 kv heads) under the verify
    step's multi-row chains."""
    model = (97, 32, 2, 4, 2)
    kw = dict(num_slots=2, page_size=8, max_context=64, spec_k=3)
    pair = spec_pairs(model=model, loader=lm_gqa, **kw)
    rng = np.random.default_rng(2)
    specs = [(i, rep_prompt(rng, 97, n, motif=5), dict(max_new=6))
             for i, n in enumerate((7, 12, 9))]
    got = pair.run(specs)
    off, _ = pair.port_alone(lm_gqa(*model), specs, **spec_off(kw))
    assert_same(got, off, "GQA spec on against off")
    assert pair.spec_counters()[1]["n_spec_drafted"] > 0


def test_spec_with_prefix_hits_and_cow_stays_exact(spec_pairs):
    """Followers map a donor's pages, diverge inside the boundary page
    (copy-on-write) and speculate over their own tokens; an exact repeat
    hits the donor page unchanged."""
    pair = spec_pairs(**S23)
    base = rep_prompt(np.random.default_rng(7), 23, 13)
    pair.run([("a", base.copy(), dict(max_new=6))])
    pair.run([("b", np.concatenate([base[:11], (base[11:13] - 1) % 21 + 2])
               .astype(np.int32), dict(max_new=6))])
    pair.run([("again", base.copy(), dict(max_new=6))])
    c = pair.counters()[1]
    assert c["n_prefix_hits"] >= 1 and c["n_cow"] >= 1
    assert pair.spec_counters()[1]["n_spec_drafted"] > 0
    pair.eng.kv.check_reclaimed()


def test_spec_chains_coexist_with_prefill_chunks_under_budget(spec_pairs):
    """A 25-token prompt commits in 4-row chunks on the verify steps that
    carry another slot's chains, under an 8-row budget: the decoder
    advances on every chunk-carrying step, at least one step carries
    chunks and a chain together, and the state equals JAX's after every
    step."""
    pair = spec_pairs(**TIGHT)
    rng = np.random.default_rng(8)
    short = ("short", rep_prompt(rng, 23, 4), dict(max_new=12))
    long_ = ("long", rep_prompt(rng, 23, 25), dict(max_new=4))
    pair.add([short])
    pair.step()                       # short: final chunk + token 0
    pair.step()
    pair.add([long_])
    overlapped = 0
    eng = pair.eng
    while any(sl is not None and sl.req.req_id == "long" and sl.gen == 0
              for sl in eng.slots) or any(r.req_id == "long"
                                          for r in eng.queue):
        chunks0, chains0 = eng.n_prefill_chunks, eng.n_spec_chains
        before = eng.tokens_generated
        pair.step()
        pair.check()
        if eng.n_prefill_chunks > chunks0 and eng.n_spec_chains > chains0:
            overlapped += 1
        assert eng.tokens_generated > before
    assert overlapped > 0
    pair.run()
    assert pair.counters()[1]["n_mixed_steps"] > 0


def test_spec_preempt_replay_with_drafts_in_flight_stays_exact(spec_pairs):
    """An overcommitted pool (5 real pages for 2 slots of 4) with
    speculation on: victims are preempted with draft pages grown, replay
    through verify steps, and every request equals JAX's and the port's
    spec-off; refcounts end at zero."""
    pair = spec_pairs(model=M11, **OVER)
    rng = np.random.default_rng(9)
    specs = [(i, rep_prompt(rng, 11, n, motif=3), dict(max_new=8))
             for i, n in enumerate((6, 4, 5, 3, 6))]
    got = pair.run(specs)
    off, eng_off = pair.port_alone(lm(*M11), specs, **spec_off(OVER))
    assert eng_off.n_preemptions > 0
    assert_same(got, off, "overcommitted spec on against off")
    c = pair.counters()[1]
    assert c["n_preemptions"] > 0
    assert pair.spec_counters()[1]["n_spec_drafted"] > 0
    assert (pair.eng.kv._ref == 0).all()
    pair.eng.kv.check()


def test_forced_full_rejection_rolls_back_pages_exactly(spec_pairs):
    """An always-wrong drafter: every chain rejects all its drafts and
    uncommit_tail returns every page they grew; after every step the
    allocator equals JAX's and its invariants hold."""
    pair = spec_pairs(**S23)
    pair.spec(3, drafter=Wrong())
    rng = np.random.default_rng(10)
    specs = [(i, rep_prompt(rng, 23, 6 + i), dict(max_new=6))
             for i in range(3)]
    pair.add(specs)
    while pair.step():
        pair.check()
        pair.eng.kv.check()
    c = pair.spec_counters()[1]
    assert c["n_spec_drafted"] > 0 and c["n_spec_accepted"] == 0
    off, _ = pair.port_alone(lm(*M23), specs, **spec_off(S23))
    assert_same(dict(pair.eng.results), off, "full rejection against off")
    pair.eng.kv.check_reclaimed()


def test_oracle_drafter_multiplies_steps_down(spec_pairs):
    """A drafter that knows the continuation: accept rate 1.0, 12 tokens
    in at most 5 steps, and chain tokens = accepted + chains."""
    pair = spec_pairs(**S23)
    prompt = rep_prompt(np.random.default_rng(11), 23, 9)
    specs = [("o", prompt, dict(max_new=12))]
    off, _ = pair.port_alone(lm(*M23), specs, **spec_off(S23))
    pair.spec(3, drafter=Replay(off["o"]))
    pair.run(specs)
    cp = pair.spec_counters()[1]
    assert cp["n_spec_accepted"] == cp["n_spec_drafted"] > 0
    assert cp["n_spec_tokens"] == cp["n_spec_accepted"] + \
        cp["n_spec_chains"]
    assert pair.counters()[1]["n_decode_steps"] <= 5


def test_draft_growth_never_evicts_cached_prefix_pages(spec_pairs):
    """try_grow(evict=False), the draft tail's growth, takes free pages
    only: on a dry free list it fails and the cached prefix pages stay;
    admission-mode growth may evict.  Both allocators alike."""
    pair = spec_pairs(model=M11, **OVER)
    rng = np.random.default_rng(13)
    pair.run([("a", rep_prompt(rng, 11, 11, motif=3), dict(max_new=2))])
    kv, jkv = pair.eng.kv, pair.jeng.kv
    cached0 = kv.cached_page_count
    assert cached0 > 0
    for k in (jkv, kv):
        assert k.try_grow(0, len(k._free) * k.page_size)
        assert k.free_page_count == 0
        assert not k.try_grow(1, 8, evict=False)
        assert k.cached_page_count == cached0
        assert k.try_grow(1, 4)
        assert k.cached_page_count < cached0
        k.release(0)
        k.release(1)
        k.check()
    assert alloc_state(kv) == alloc_state(jkv)
    assert tree_state(pair.eng.prefix) == tree_state(pair.jeng.prefix)


def test_dynamic_k_rises_to_full_depth_under_oracle_drafter(spec_pairs):
    """Dynamic depth with an oracle drafter: the cold one-draft probe, then
    the EWMA drives the slot to the full spec_k and keeps it there."""
    pair = spec_pairs(**S23)
    prompt = rep_prompt(np.random.default_rng(16), 23, 6)
    specs = [("o", prompt, dict(max_new=16))]
    off, _ = pair.port_alone(lm(*M23), specs, **spec_off(S23))
    pair.spec(3, drafter=Replay(off["o"]), dynamic=True)
    pair.add(specs)
    ks = []
    while pair.step():
        pair.check()
        for sl in pair.eng.slots:
            if sl is not None and sl.accept_ewma is not None:
                ks.append(int(round(sl.accept_ewma * pair.eng.spec_k)))
    assert_same(dict(pair.eng.results), off, "dynamic k rising")
    pair.check()
    cp = pair.spec_counters()[1]
    assert cp["n_spec_accepted"] == cp["n_spec_drafted"] > 0
    assert ks and max(ks) == ks[-1] == pair.eng.spec_k


def test_dynamic_k_decays_to_plain_decode_under_adversarial_drafter(
        spec_pairs):
    """Dynamic depth with an always-wrong drafter: the slot decays to
    depth 0 after its probe rejects, leaving only the paced re-probe —
    at most 4 drafts and 4 verify steps over 20 tokens."""
    pair = spec_pairs(**S23)
    pair.spec(3, drafter=Wrong(), dynamic=True)
    specs = [("w", rep_prompt(np.random.default_rng(17), 23, 5),
              dict(max_new=20))]
    pair.add(specs)
    saw_zero = False
    while pair.step():
        pair.check()
        for sl in pair.eng.slots:
            if sl is not None and sl.accept_ewma is not None:
                saw_zero |= int(round(sl.accept_ewma * pair.eng.spec_k)) == 0
    off, _ = pair.port_alone(lm(*M23), specs, **spec_off(S23))
    assert_same(dict(pair.eng.results), off, "dynamic k decaying")
    c = pair.spec_counters()[1]
    assert saw_zero and c["n_spec_accepted"] == 0
    assert c["n_spec_drafted"] <= 4 and c["n_spec_steps"] <= 4


@pytest.mark.parametrize("mode", ["auto", "static"])
def test_decode_mode_with_windows(spec_pairs, mode):
    """spec_k = 2 beside decode_steps = 3 with a drafter that proposes only
    at even context lengths: "auto" runs the drafted steps as verify
    steps and the draft-free ones as windows (each staging the positions
    the verify steps moved), "static" never runs a window; tokens equal
    the port's spec-off k = 1 run either way."""
    pair = spec_pairs(**MODES)
    pair.reset(decode_steps=3)
    prompt = np.random.default_rng(11).integers(2, 23, 10).astype(np.int32)
    specs = [("c", prompt, dict(max_new=20))]
    off, _ = pair.port_alone(lm(*M23), specs, **spec_off(MODES))
    pair.spec(2, drafter=Replay(off["c"], parity=True), mode=mode)
    got = pair.run(specs)
    assert_same(got, off, f"decode_mode={mode}")
    c, s = pair.counters()[1], pair.spec_counters()[1]
    assert s["n_spec_steps"] > 0 and s["n_spec_accepted"] > 0
    assert (c["n_scan_flushes"] > 0) == (mode == "auto")
    pair.eng.kv.check_reclaimed()


def test_set_speculation_validates_and_toggles(spec_pairs):
    """A negative depth is refused; on a defaulted budget the budget
    follows the depth (chunk + S * (k + 1)) on both engines; the tokens
    stay the same off, on and off again; the idle-only setters refuse a
    busy engine."""
    pair = spec_pairs(num_slots=2, page_size=4, max_context=32)
    for e in (pair.jeng, pair.eng):
        with pytest.raises(ValueError, match="spec_k"):
            e.set_speculation(-1)
    prompt = rep_prompt(np.random.default_rng(12), 23, 10)
    outs = []
    for k in (0, 3, 0):
        pair.reset()
        pair.spec(k)
        assert pair.eng.max_step_tokens == 16 + 2 * (k + 1)
        outs.append(pair.run([("r", prompt.copy(), dict(max_new=6))])["r"])
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    pair.spec(3, dynamic=True)
    assert pair.eng.spec_dynamic and pair.eng.spec_k == 3
    pair.spec(3, dynamic=False)
    assert not pair.eng.spec_dynamic
    eng = pair.eng
    eng.add_request(pair.requests([("busy", prompt, dict(max_new=3))])[1][0])
    for fn in (lambda: eng.set_speculation(2), lambda: eng.set_chunking(8),
               lambda: eng.set_decode_mode("static")):
        with pytest.raises(RuntimeError, match="idle"):
            fn()
    with pytest.raises(ValueError, match="decode_mode"):
        pair.jeng.set_decode_mode("sometimes")
    eng.run()
    with pytest.raises(ValueError, match="decode_mode"):
        eng.set_decode_mode("sometimes")
    pair.spec(0)


def test_engine_asserts_on_drafter_clamp_violation(spec_pairs):
    """A drafter returning more than k tokens trips both engines'
    assertion instead of being truncated."""
    class Overlong:
        def propose(self, ctx, k):
            return np.zeros(k + 2, np.int32)

    pair = spec_pairs(**S23)
    pair.spec(3, drafter=Overlong())
    pair.add([("r", rep_prompt(np.random.default_rng(14), 23, 8),
               dict(max_new=6))])
    for e in (pair.jeng, pair.eng):
        with pytest.raises(AssertionError, match="clamp contract"):
            while e.step():
                pass
        assert e.cancel("r")


def test_model_drafter_in_the_engine_and_checkpoint_roundtrip(spec_pairs):
    """Self-speculation (ModelDrafter.from_target, window 16) with dynamic
    depth on both engines, every sampling mode: tokens and state equal
    JAX's after every step, drafts accepted; a checkpoint taken after
    three steps carries each slot's accept_ewma and probe_tick, and a
    fresh port engine restored from it finishes as JAX's uninterrupted
    engine."""
    pair = spec_pairs(**S23)
    tr, ex, params = lm(*M23)
    pair.spec(3, drafter=ModelDrafter.from_target(ex, params, window=16,
                                                  device="cpu"),
              jdrafter=JModelDrafter.from_target(tr.executor, tr.params,
                                                 window=16), dynamic=True)
    assert pair.eng.drafter_kind == "model"
    specs = [(f"m{i}", rep_prompt(np.random.default_rng(200 + i), 23,
                                  9 + 2 * i), dict(max_new=8, rng=60 + i,
                                                   **kw))
             for i, kw in enumerate(KNOBS)]
    pair.add(specs)
    for _ in range(3):
        pair.step()
        pair.check()
    live = [sl for sl in pair.eng.slots if sl is not None]
    assert any(sl.accept_ewma is not None for sl in live)
    live[0].probe_tick = 5
    next(sl for sl in pair.jeng.slots if sl is not None).probe_tick = 5
    snap = pair.eng.checkpoint_state()
    assert [None if d is None else (d["accept_ewma"], d["probe_tick"])
            for d in snap["slots"]] == \
        [None if sl is None else (sl.accept_ewma, sl.probe_tick)
         for sl in pair.jeng.slots]
    while pair.step():
        pair.check()
    want = dict(pair.jeng.results)
    fresh = ServingEngine(ex, params, device="cpu", noise=pair._noise,
                          drafter=ModelDrafter.from_target(
                              ex, params, window=16, device="cpu"),
                          spec_dynamic=True, **spec_off(S23), spec_k=3)
    fresh.restore_state(snap)
    assert fresh.n_draft_steps == snap["counters"]["n_draft_steps"]
    got = fresh.run() | {k: v for k, v in snap["results"].items()}
    assert_same(got, {k: np.asarray(v) for k, v in want.items()},
                "restored against uninterrupted JAX")
    c = pair.spec_counters()[1]
    assert c["n_draft_steps"] > 0 and c["n_spec_accepted"] > 0
    for c in SPEC_COUNTERS:
        assert getattr(fresh, c) == getattr(pair.eng, c), c
    pair.eng.kv.check_reclaimed()


# ---------------------------------------------------------------------------
# units: the drafters, the chain sampler, the allocator's rollback
# ---------------------------------------------------------------------------

def test_ngram_drafter_and_clamp_match_jax():
    """Prompt lookup and the clamp on 300 seeded contexts (motif-tiled and
    random, lengths 0-40, depths 0-5, eos absent or drawn from the
    context, windows 4-256, n-gram ranges 1-3): equal proposals."""
    rng = np.random.default_rng(21)
    for _ in range(300):
        n = int(rng.integers(0, 41))
        ctx = (rep_prompt(rng, 9, n, motif=int(rng.integers(1, 6)))
               if rng.random() < 0.5 else
               rng.integers(0, 9, n).astype(np.int32))
        k = int(rng.integers(0, 6))
        eos = int(rng.choice(ctx)) if n and rng.random() < 0.5 else -1
        lo = int(rng.integers(1, 4))
        hi = int(rng.integers(lo, 4))
        window = int(rng.choice([4, 16, 256]))
        args = dict(max_ngram=hi, min_ngram=lo, window=window)
        np.testing.assert_array_equal(
            NgramDrafter(**args).propose(ctx, k, eos_id=eos),
            JNgramDrafter(**args).propose(ctx, k, eos_id=eos))
        np.testing.assert_array_equal(clamp_proposal(ctx, k, eos),
                                      jclamp_proposal(ctx, k, eos))
    # the reference's fixed cases
    d = NgramDrafter(max_ngram=3, min_ngram=1)
    ctx = np.asarray([5, 6, 7, 9, 5, 6, 7, 8, 5, 6, 7], np.int32)
    np.testing.assert_array_equal(d.propose(ctx, 2), [8, 5])
    ctx = np.asarray([5, 6, 9, 3, 8, 2, 5, 6], np.int32)
    np.testing.assert_array_equal(NgramDrafter(2).propose(ctx, 3, 3), [9, 3])


def test_model_drafter_proposals_match_jax():
    """ModelDrafter.propose_batch on seeded [S, W] windows with ragged
    lengths and eos cuts, and propose: the port's ids equal the JAX
    drafter's, the target's parameters carried across; distilled_init's
    sliced embedding and tied head equal JAX's, and with the rest of the
    JAX drafter's parameters carried across its proposals do too."""
    tr, ex, params = lm(23, 16, 2, 2)
    V = 23
    jd = JModelDrafter.from_target(tr.executor, tr.params, window=16)
    pd = ModelDrafter.from_target(ex, params, window=16, device="cpu")
    rng = np.random.default_rng(22)
    ctx = rng.integers(2, V, (5, 16)).astype(np.int32)
    ctx[1, 6:] = 0
    lens = np.asarray([16, 6, 1, 11, 16], np.int32)
    for k in (1, 3):
        jout = np.asarray(jd.propose_batch(ctx, lens, k))
        eos = jout[:, 0].copy()
        eos[::2] = -1
        np.testing.assert_array_equal(pd.propose_batch(ctx, lens, k),
                                      jout)
        np.testing.assert_array_equal(
            pd.propose_batch(ctx, lens, k, eos_ids=eos),
            np.asarray(jd.propose_batch(ctx, lens, k, eos_ids=eos)))
    np.testing.assert_array_equal(pd.propose(ctx[3, :11], 4, eos_id=5),
                                  jd.propose(ctx[3, :11], 4, eos_id=5))

    jdist = JModelDrafter.distilled_init(tr.executor, tr.params, dim=8,
                                         window=16, seed=3)
    pdist = ModelDrafter.distilled_init(ex, params, dim=8, window=16,
                                        seed=3, device="cpu")
    assert sorted(pdist.params) == sorted(jdist.params)
    emb = np.asarray(tr.params["_tok_embedding"])
    head = next(n for n in pdist.params if n.startswith("_lm_head"))
    for p in (pdist.params, jdist.params):
        np.testing.assert_array_equal(np.asarray(p["_tok_embedding"]),
                                      emb[:, :8])
        np.testing.assert_array_equal(np.asarray(p[head]), emb[:, :8].T)
    carried = ModelDrafter(pdist.executor, params_from_jax(
        {n: np.asarray(v) for n, v in jdist.params.items()}, device="cpu"),
        window=16, device="cpu")
    np.testing.assert_array_equal(carried.propose_batch(ctx, lens, 3),
                                  np.asarray(jdist.propose_batch(ctx, lens,
                                                                 3)))


def test_pick_next_chain_matches_jax():
    """[S, K+1, V] chain scores (ties planted) with every sampling mode
    and both score kinds: the port fed each position's Gumbel noise from
    its JAX key picks JAX's tokens."""
    S, K, V = 6, 4, 37
    rng = np.random.default_rng(23)
    for is_probs in (False, True):
        last = rng.normal(size=(S, K, V)).astype(np.float32)
        last[:, :, 5] = last[:, :, 9]              # ties
        if is_probs:
            last = np.exp(last) / np.exp(last).sum(-1, keepdims=True)
        keys = jax.random.split(jax.random.PRNGKey(4), S * K).reshape(
            S, K, 2)
        temp = np.asarray([0.0, 0.8, 0.7, 1.1, 0.0, 0.5], np.float32)
        top_k = np.asarray([0, 5, 0, 0, 0, 3], np.int32)
        top_p = np.asarray([0.0, 0.0, 0.9, 0.0, 0.0, 0.5], np.float32)
        want = np.asarray(jpick_next_chain(last, keys, temp, top_k, top_p,
                                           is_probs=is_probs))
        noise = np.stack([[np.asarray(jax.random.gumbel(keys[s, i],
                                                        (1, V)))[0]
                           for i in range(K)] for s in range(S)])
        got = pick_next_chain(torch.from_numpy(last),
                              torch.from_numpy(noise),
                              torch.from_numpy(temp),
                              torch.from_numpy(top_k.astype(np.int64)),
                              torch.from_numpy(top_p), is_probs=is_probs)
        np.testing.assert_array_equal(got.numpy(), want)


def test_random_allocator_operations_with_uncommit_tail_match_jax():
    """About 300 operations — try_grow with and without eviction,
    map_shared of a match, ensure_writable, uncommit_tail to a random
    length whose released pages are private, release, insert, evict_for,
    reset — on a 4-slot allocator of 13 real pages and its index: return
    values, table, refcounts, cached marks, free-list order and the nodes
    equal after every operation, and the invariants hold."""
    tr, ex, _ = lm(*M23)
    S, ps, pps, P = 4, 2, 4, 14
    jkv = JPagedKVCache(tr.executor, S, ps, pps, num_pages=P)
    kv = PagedKVCache(ex, S, ps, pps, torch.device("cpu"), num_pages=P)
    jtree, tree = JPrefixTree(jkv), PrefixTree(kv)
    jkv.on_page_pressure, kv.on_page_pressure = jtree.evict_for, \
        tree.evict_for
    rng = np.random.default_rng(24)
    toks = [[] for _ in range(S)]
    kinds = {}
    for _ in range(300):
        op = rng.choice(["grow", "grow_noevict", "map", "cow", "uncommit",
                         "release", "insert", "evict", "reset"],
                        p=[.2, .1, .12, .1, .2, .08, .12, .05, .03])
        s = int(rng.integers(S))
        n = int(kv._n_pages[s])
        if op in ("grow", "grow_noevict"):
            ev = op == "grow"
            want = int(rng.integers(1, pps * ps + 1))
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
                toks[s] = query.tolist()[:len(pp) * ps] + [-1] * (
                    len(pages) * ps - len(pp) * ps)
        elif op == "cow":
            if not n:
                continue
            j = int(rng.integers(n))
            out = (jkv.ensure_writable(s, j), kv.ensure_writable(s, j))
        elif op == "uncommit":
            shared = [j for j in range(n)
                      if not kv.page_writable(int(kv.table[s, j]))]
            keep = shared[-1] + 1 if shared else 0
            if keep >= n:
                continue
            tokens = int(rng.integers(keep * ps, n * ps + 1))
            out = (jkv.uncommit_tail(s, tokens), kv.uncommit_tail(s, tokens))
            toks[s] = toks[s][:int(kv._n_pages[s]) * ps]
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
        elif op == "evict":
            k = int(rng.integers(1, 4))
            out = (jtree.evict_for(k), tree.evict_for(k))
        else:
            for a in (jkv, kv):
                a.reset()
            jtree.clear()
            tree.clear()
            toks = [[] for _ in range(S)]
            out = (None, None)
        kinds[op] = kinds.get(op, 0) + 1
        assert out[1] == out[0], op
        assert alloc_state(kv) == alloc_state(jkv), op
        assert tree_state(tree) == tree_state(jtree), op
        kv.check()
    assert kinds.get("uncommit", 0) >= 20 and kinds.get("reset", 0) > 0
