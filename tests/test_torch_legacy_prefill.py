"""PyTorch port: the serving engine's whole-prompt prefill
(`prefill_chunk=None`, the reference's legacy admission and the baseline
of its chunked-prefill A/B) against the JAX engine on the CPU, exactly.

Through tests/test_torch_prefix_cache.py's `Pair` (and
tests/test_torch_spec_decode.py's `SpecPair`): a cold run with every
sampling knob, prefix hits whose suffix prefills through the dense
cache's "cont" path (a partially matched page copied on write), an
overcommitted pool with preemption and replay, speculation (verify steps
of S * (spec_k + 1) rows), and a checkpoint taken mid-flight and restored
on a fresh engine — tokens, every streamed token, finishes, counters, the
allocator and the prefix index equal to the JAX engine's after every run.
The bucket set for prompts of 3/5/7/12 tokens on pages of 8 is {8, 16}
(tests/test_serving.py:126), and chunking toggles both ways on an idle
engine.  Toy widths: vocab 23, dim 16, 2 layers, 2 heads."""

import numpy as np
import pytest

from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.ops.paged_attention import split_plan
from paddle_tpu_torch.serving import Request, ServingEngine
from test_torch_prefix_cache import (KNOBS, M23, lm, pairs,  # noqa: F401
                                     prompts)
from test_torch_spec_decode import spec_pairs  # noqa: F401

LEGACY = dict(num_slots=3, page_size=4, max_context=48, prefill_chunk=None)


def specs(lens, seed: int, max_new: int = 6, tag: str = "r", prefix=None):
    """Requests of these prompt lengths (after `prefix`, when given), each
    with the next sampling knobs and its own key."""
    out = []
    for i, p in enumerate(prompts(lens, 23, seed)):
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append((f"{tag}{i}", p, dict(max_new=max_new, rng=seed * 10 + i,
                                         **KNOBS[i % len(KNOBS)])))
    return out


def test_whole_prompt_cold_and_prefix_hits_match_jax(pairs):
    """A cold run (eos on one request), then prompts that extend the first
    runs' donated pages, whole and partly matched: suffix prefills on a
    prefix-seeded cache, copy-on-write of the boundary page; no mixed step
    and no prefill chunk anywhere."""
    pair = pairs(**LEGACY)
    assert (pair.eng.prefill_chunk, pair.eng.max_step_tokens) == (None, 0)
    cold = specs([5, 9, 3, 12, 7, 20], seed=1)
    cold[2][2]["eos_id"] = 4
    pair.run(cold)
    base = cold[5][1]
    pair.run(specs([1, 3, 6], seed=2, tag="h", prefix=base[:10]))
    pair.run(specs([2, 5], seed=3, tag="k", prefix=base[:17]))
    cj, cp = pair.counters()
    assert cp["n_prefix_hits"] >= 3 and cp["n_cow"] >= 1
    assert cp["n_mixed_steps"] == cp["n_prefill_chunks"] == 0


def test_whole_prompt_overcommitted_pool_preempts_match_jax(pairs):
    """A pool of 12 real pages for three slots: decoding slots pause and
    the youngest is preempted; its replay prefix-hits its own donation
    and re-emits its tokens."""
    pair = pairs(num_pages=13, **LEGACY)
    pair.run(specs([9, 14, 6, 11, 8], seed=4, max_new=12))
    cj, _ = pair.counters()
    assert cj["n_preemptions"] >= 1
    pair.eng.kv.check_reclaimed()


def test_whole_prompt_with_speculation_matches_jax(spec_pairs):
    """spec_k=3 without chunking: verify steps of S * 4 rows, all slots'
    chains; the engine's one K5 split count is that launch's plan."""
    pair = spec_pairs(spec_k=3, **LEGACY)
    eng = pair.eng
    S = len(eng.slots)
    assert eng.splits == split_plan(S * 4, S + 1, eng.kv.pages_per_slot,
                                    eng.kv.page_size)[0]
    rng = np.random.default_rng(5)
    reps = [("m0", np.tile(rng.integers(2, 23, 3), 4), dict(max_new=10)),
            ("m1", np.tile(rng.integers(2, 23, 4), 3), dict(max_new=9)),
            ("m2", rng.integers(2, 23, 7),
             dict(max_new=8, rng=3, **KNOBS[1])),
            ("m3", np.tile(rng.integers(2, 23, 2), 5), dict(max_new=10))]
    pair.run(reps)
    cj, cp = pair.spec_counters()
    assert cj["n_spec_steps"] > 0 and cj["n_spec_accepted"] > 0


def test_whole_prompt_checkpoint_midflight_restores(pairs):
    """A snapshot with slots decoding and requests queued restores onto a
    fresh engine, which finishes with the tokens of the uninterrupted
    engine (itself equal to the JAX engine's) and its allocator and
    index state."""
    pair = pairs(**LEGACY)
    pair.add(specs([5, 9, 3, 12, 7], seed=6, max_new=8))
    for _ in range(100):
        if pair.eng.queue and any(sl is not None and sl.gen > 1
                                  for sl in pair.eng.slots):
            break
        assert pair.step()
    snap = pair.eng.checkpoint_state()
    assert snap["config"]["prefill_chunk"] is None
    while pair.step():
        pair.check()
    pair.check()
    _, ex, params = lm(*M23)
    fresh = ServingEngine(ex, params, device="cpu", noise=pair._noise,
                          **LEGACY)
    fresh.restore_state(snap)
    while fresh.step():
        pass
    assert {k: v.tolist() for k, v in fresh.results.items()} == \
        {k: v.tolist() for k, v in pair.eng.results.items()}
    assert fresh.tokens_generated == pair.eng.tokens_generated
    fresh.kv.check_reclaimed()
    with pytest.raises(ValueError, match="configuration mismatch"):
        ServingEngine(ex, params, device="cpu",
                      **(LEGACY | dict(prefill_chunk=8))).restore_state(snap)


def test_whole_prompt_buckets_and_chunking_toggle():
    """Prompts of 3/5/7/12 tokens on pages of 8 prefill at the buckets
    {8, 16}, as the JAX engine compiles them, with its tokens; chunking
    then toggles on and off on the idle engine, each way serving the
    same tokens."""
    tr, ex, params = lm(*M23)
    ps = prompts((3, 5, 7, 12), 23, 2)
    kw = dict(num_slots=2, page_size=8, max_context=32, prefill_chunk=None)
    jeng = JServingEngine(tr.executor, tr.params, **kw)
    want = jeng.run([JRequest(i, p, max_new=3) for i, p in enumerate(ps)])
    eng = ServingEngine(ex, params, device="cpu", **kw)
    seen = []
    prefill = eng._prefill_prompt
    eng._prefill_prompt = lambda prompt, Lb: seen.append(Lb) or \
        prefill(prompt, Lb)
    got = eng.run([Request(i, p, max_new=3) for i, p in enumerate(ps)])
    assert sorted(set(seen)) == sorted(jeng._prefill_cache) == [8, 16]
    assert [eng.bucket_for(n) for n in (3, 5, 7, 12)] == [8, 8, 8, 16]
    for i in want:
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    assert eng.n_mixed_steps == eng.n_prefill_chunks == 0
    eng.set_chunking(8)
    assert (eng.prefill_chunk, eng.max_step_tokens) == (8, 10)
    again = eng.run([Request(i, p, max_new=3) for i, p in enumerate(ps)])
    assert eng.n_prefill_chunks > 0
    eng.set_chunking(None)
    assert (eng.prefill_chunk, eng.max_step_tokens) == (None, 0)
    third = eng.run([Request(i, p, max_new=3) for i, p in enumerate(ps)])
    for i in want:
        np.testing.assert_array_equal(again[i], got[i])
        np.testing.assert_array_equal(third[i], got[i])
