"""PyTorch port: the serving engine's multi-step decode (`decode_steps=k`)
on the CPU — tokens equal to the port at k = 1 and to the JAX
ServingEngine(decode_steps=k, prefix_cache=False), greedy and sampled (the
port given the JAX engine's Gumbel noise, as tests/test_torch_engine.py
does), eos inside a window, mixed steps falling back, windows whose pages
cannot be grown falling back, the set_decode_steps guards and the
counters (decode steps, mixed steps, chunks, windows and their bodies)
equal to JAX's.

Small size: vocab 61, dim 32, 2 layers, 4 heads, 2 or 3 slots, page size
8.  On the CPU a window runs uncaptured (on the card it is a CUDA graph,
tests/test_torch_cuda.py)."""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.trainer.trainer import Trainer
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.models import transformer_lm_config
from paddle_tpu_torch.parameter import params_from_jax
from paddle_tpu_torch.serving import Request, ServingEngine

VOCAB = 61
COUNTERS = ("n_decode_steps", "n_mixed_steps", "n_prefill_chunks",
            "n_scan_flushes", "n_scan_steps", "tokens_generated")
KNOBS = [dict(), dict(temperature=0.8, top_k=5),
         dict(temperature=0.7, top_p=0.9), dict(temperature=1.1)]


@pytest.fixture(scope="module")
def model():
    cfg = parse_config("demo/model_zoo/transformer_lm.py",
                       f"vocab={VOCAB},dim=32,layers=2,heads=4,batch_size=4")
    tr = Trainer(cfg, seed=7)
    ex = GraphExecutor(transformer_lm_config(VOCAB, 32, 2, 4))
    params = params_from_jax({k: np.asarray(v) for k, v in tr.params.items()},
                             device="cpu")
    return tr, ex, params


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, n).astype(np.int32) for n in lens]


def _jax_noise(jreqs):
    keys = {r.req_id: r.rng for r in jreqs}

    def noise(req, g, vocab, device):
        k = jax.random.split(keys[req.req_id], req.max_new)[g]
        return torch.tensor(np.asarray(jax.random.gumbel(k, (1, vocab)))[0],
                            device=device)
    return noise


def _serve(model, specs, k, jax_side=False, **eng_kw):
    """Serve `specs` [(prompt, knobs)] on the port at decode_steps=k (and
    on the JAX engine at the same k); returns (port engine, results, JAX
    engine or None, its results)."""
    tr, ex, params = model
    jreqs = [JRequest(i, p, rng=jax.random.PRNGKey(100 + i), **kw)
             for i, (p, kw) in enumerate(specs)]
    jeng = jres = None
    if jax_side:
        jeng = JServingEngine(tr.executor, tr.params, prefix_cache=False,
                              decode_steps=k, **eng_kw)
        jres = jeng.run(jreqs)
    eng = ServingEngine(ex, params, device="cpu", noise=_jax_noise(jreqs),
                        decode_steps=k, **eng_kw)
    res = eng.run([Request(i, p, **kw) for i, (p, kw) in enumerate(specs)])
    return eng, res, jeng, jres


def _assert_same(a, b, what):
    assert sorted(a) == sorted(b)
    for i in a:
        np.testing.assert_array_equal(a[i], b[i], err_msg=f"{what}: {i}")


def _assert_drained(eng):
    eng.kv.check()
    assert eng.kv.free_page_count == eng.kv.num_pages - 1
    assert all(sl is None for sl in eng.slots) and not eng.queue


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_tokens_equal_k1_and_the_jax_engine(model, k, mode):
    """More requests than slots, mixed prompt lengths and max_new: the
    tokens at decode_steps=k equal the port's at k = 1 and the JAX
    engine's at k, and every counter equals JAX's."""
    prompts = _prompts((4, 9, 6, 11, 5), seed=1)
    knobs = KNOBS * 2 if mode == "sampled" else [{}] * 5
    specs = [(p, dict(max_new=m, **kw))
             for p, m, kw in zip(prompts, (7, 9, 5, 8, 6), knobs)]
    kw = dict(num_slots=2, page_size=8, max_context=64)
    eng, res, jeng, jres = _serve(model, specs, k, jax_side=True, **kw)
    _, res_1, _, _ = _serve(model, specs, 1, **kw)
    _assert_same(res_1, res, f"decode_steps={k} against 1")
    _assert_same(jres, res, f"decode_steps={k} against JAX")
    assert {c: getattr(eng, c) for c in COUNTERS} == \
        {c: getattr(jeng, c) for c in COUNTERS}
    assert (eng.n_scan_flushes > 0) == (k > 1)
    assert eng.n_scan_steps == k * eng.n_scan_flushes
    _assert_drained(eng)


@pytest.mark.parametrize("k", [3, 4])
def test_eos_inside_a_window(model, k):
    """eos lands inside windows: the run mask freezes the slot where the
    host's banking cuts its column, the freed slot refills; tokens and
    counters equal k = 1 / JAX, and some request stops early."""
    tr, ex, params = model
    prompts = _prompts((6, 13, 5, 3, 9, 4), seed=3)
    first = ServingEngine(ex, params, num_slots=1, page_size=8,
                          max_context=32, device="cpu").run(
        [Request(0, prompts[0], max_new=1)])[0]
    eos = int(first[-1])
    specs = [(p, dict(max_new=8, eos_id=eos)) for p in prompts]
    kw = dict(num_slots=2, page_size=8, max_context=32)
    eng, res, jeng, jres = _serve(model, specs, k, jax_side=True, **kw)
    _, res_1, _, _ = _serve(model, specs, 1, **kw)
    _assert_same(res_1, res, "eos inside a window")
    _assert_same(jres, res, "eos inside a window, JAX")
    assert {c: getattr(eng, c) for c in COUNTERS} == \
        {c: getattr(jeng, c) for c in COUNTERS}
    assert any(res[i].size < p.size + 8 for i, (p, _) in enumerate(specs))
    assert eng.n_scan_flushes > 0
    _assert_drained(eng)


def test_mixed_steps_fall_back_and_admissions_never_wait(model):
    """A long prompt prefilling in chunks beside decoding slots: those
    steps are mixed (never a window), windows resume once every slot
    decodes, and a request admitted while windows run starts its prefill
    on the very next step."""
    specs = [(p, dict(max_new=6, **({"temperature": 0.8, "top_k": 5}
                                    if i == 1 else {})))
             for i, p in enumerate(_prompts((30, 5, 9), seed=8))]
    kw = dict(num_slots=2, page_size=8, max_context=64, prefill_chunk=8)
    eng, res, jeng, jres = _serve(model, specs, 4, jax_side=True, **kw)
    _, res_1, _, _ = _serve(model, specs, 1, **kw)
    _assert_same(res_1, res, "chunked prefill beside windows")
    _assert_same(jres, res, "chunked prefill beside windows, JAX")
    assert eng.n_mixed_steps > 0 and eng.n_scan_flushes > 0
    assert {c: getattr(eng, c) for c in COUNTERS} == \
        {c: getattr(jeng, c) for c in COUNTERS}

    _, ex, params = model
    eng = ServingEngine(ex, params, num_slots=2, page_size=8,
                        max_context=64, prefill_chunk=8, decode_steps=4,
                        device="cpu")
    short, long_ = _prompts((5, 30), seed=13)
    eng.add_request(Request("short", short, max_new=24))
    while eng.n_scan_flushes == 0:
        assert eng.step()
    eng.add_request(Request("long", long_, max_new=4))
    chunks, flushes = eng.n_prefill_chunks, eng.n_scan_flushes
    eng.step()
    assert eng.n_prefill_chunks > chunks
    while any(sl is not None and sl.gen == 0 for sl in eng.slots):
        assert eng.n_scan_flushes == flushes
        eng.step()
    out = eng.run()
    solo = ServingEngine(ex, params, num_slots=2, page_size=8,
                         max_context=64, prefill_chunk=8, device="cpu").run(
        [Request("short", short, max_new=24), Request("long", long_,
                                                      max_new=4)])
    _assert_same(solo, out, "admission during windows")


def test_windows_without_pages_run_the_k1_step(model, monkeypatch):
    """When a window's pages cannot be grown, the step runs the k = 1
    decode step instead (pages already taken stay with the slot), and the
    tokens stay those of k = 1."""
    _, ex, params = model
    specs = [(p, dict(max_new=9)) for p in _prompts((4, 7), seed=5)]
    kw = dict(num_slots=2, page_size=4, max_context=32)
    _, res_1, _, _ = _serve(model, specs, 1, **kw)
    eng = ServingEngine(ex, params, device="cpu", decode_steps=4, **kw)
    grow, denied = eng.kv.try_grow, []

    def try_grow(slot, n_tokens):
        sl = eng.slots[slot]
        # refuse every other window's growth past the next token
        if sl is not None and sl.gen > 0 and n_tokens > sl.pos + 1 \
                and len(denied) % 2 == 0 and len(denied) < 6:
            denied.append(slot)
            return False
        if sl is not None and sl.gen > 0 and n_tokens > sl.pos + 1:
            denied.append(None)
        return grow(slot, n_tokens)

    monkeypatch.setattr(eng.kv, "try_grow", try_grow)
    res = eng.run([Request(i, p, **k) for i, (p, k) in enumerate(specs)])
    _assert_same(res_1, res, "windows refused pages")
    assert any(d is not None for d in denied) and eng.n_scan_flushes > 0
    # a refused window ran one k = 1 step instead
    assert eng.n_decode_steps > eng.n_scan_flushes + eng.n_mixed_steps
    _assert_drained(eng)


def test_set_decode_steps_guards(model):
    """Below 1 raises ValueError; on a busy engine it raises (the JAX
    engine asserts); an idle engine takes a new k, and the page table
    stays one buffer across table changes."""
    tr, ex, params = model
    eng = ServingEngine(ex, params, num_slots=2, page_size=8,
                        max_context=32, device="cpu")
    jeng = JServingEngine(tr.executor, tr.params, prefix_cache=False,
                          num_slots=2, page_size=8, max_context=32)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="decode_steps"):
            e.set_decode_steps(0)
    with pytest.raises(ValueError, match="decode_steps"):
        ServingEngine(ex, params, device="cpu", decode_steps=0)
    prompt = np.asarray([3, 4, 5], np.int32)
    eng.add_request(Request("x", prompt, max_new=4))
    jeng.add_request(JRequest("x", prompt, max_new=4))
    with pytest.raises(RuntimeError, match="idle"):
        eng.set_decode_steps(4)
    with pytest.raises(AssertionError, match="idle"):
        jeng.set_decode_steps(4)
    table = eng._d_table
    eng.run()
    eng.set_decode_steps(3)
    out = eng.run([Request("y", prompt, max_new=7)])["y"]
    assert eng.decode_steps == 3 and eng.n_scan_flushes == 2
    assert eng._d_table is table
    assert out.size == prompt.size + 7
