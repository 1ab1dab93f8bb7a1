"""PyTorch port: the serving engine against the JAX ServingEngine on the
CPU — token for token on greedy requests, and on sampled requests when
the port is given the Gumbel noise of the JAX engine's per-request key
schedule (jax.random.split(req.rng, max_new)[g] samples token g)."""

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
from paddle_tpu_torch.parameter import init_params, params_from_jax
from paddle_tpu_torch.serving import Request, ServingEngine

_MODELS = {}


def _model(extra: str = ""):
    """(JAX trainer, port executor, carried params), built once per config."""
    if extra not in _MODELS:
        vocab = 61 if not extra else 97
        cfg = parse_config("demo/model_zoo/transformer_lm.py",
                           f"vocab={vocab},dim=32,layers=2,heads=4,"
                           f"batch_size=4{extra}")
        tr = Trainer(cfg, seed=7)
        kw = dict(kv.split("=") for kv in extra.strip(",").split(",") if kv)
        ex = GraphExecutor(transformer_lm_config(
            vocab, 32, 2, 4, **{k: int(v) for k, v in kw.items()}))
        params = params_from_jax({k: np.asarray(v)
                                  for k, v in tr.params.items()},
                                 device="cpu")
        _MODELS[extra] = (tr, ex, params)
    return _MODELS[extra]


def _prompts(lens, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lens]


def _run_both(extra, specs, noise=None, **eng_kw):
    """Serve `specs` [(prompt, knobs)] on both engines; returns both
    engines and both result dicts."""
    tr, ex, params = _model(extra)
    jreqs = [JRequest(i, p, rng=jax.random.PRNGKey(100 + i), **kw)
             for i, (p, kw) in enumerate(specs)]
    jeng = JServingEngine(tr.executor, tr.params, prefix_cache=False,
                          **eng_kw)
    jres = jeng.run(jreqs)
    if noise == "jax":
        keys = {r.req_id: r.rng for r in jreqs}

        def noise(req, g, vocab, device):
            k = jax.random.split(keys[req.req_id], req.max_new)[g]
            return torch.tensor(np.asarray(jax.random.gumbel(k, (1, vocab)))
                                [0], device=device)
    eng = ServingEngine(ex, params, device="cpu", noise=noise, **eng_kw)
    res = eng.run([Request(i, p, **kw) for i, (p, kw) in enumerate(specs)])
    return jeng, eng, jres, res


def _assert_same(jres, res, specs):
    assert sorted(res) == sorted(jres) == list(range(len(specs)))
    for i in range(len(specs)):
        np.testing.assert_array_equal(res[i], jres[i],
                                      err_msg=f"request {i} diverged")
        assert res[i].dtype == np.int32


def _assert_drained(eng):
    eng.kv.check()
    assert eng.kv.free_page_count == eng.kv.num_pages - 1
    assert all(sl is None for sl in eng.slots) and not eng.queue


def test_engine_matches_jax_engine_greedy():
    """Mixed prompt lengths and max_new, more requests than slots: freed
    slots refill mid-flight; same tokens, same step counts."""
    prompts = _prompts((3, 9, 5, 12, 7, 4), 61)
    specs = [(p, dict(max_new=m)) for p, m in zip(prompts, (5, 7, 3, 6, 8, 2))]
    jeng, eng, jres, res = _run_both("", specs, num_slots=3, page_size=8,
                                     max_context=64)
    _assert_same(jres, res, specs)
    _assert_drained(eng)
    assert (eng.n_decode_steps, eng.n_mixed_steps, eng.n_prefill_chunks) == \
        (jeng.n_decode_steps, jeng.n_mixed_steps, jeng.n_prefill_chunks)
    assert eng.n_mixed_steps > 0 and eng.n_decode_steps > eng.n_mixed_steps
    assert eng.tokens_generated == sum(m for _, m in
                                       ((p, k["max_new"]) for p, k in specs))


@pytest.mark.parametrize("extra", [",kv_heads=2", ",window=5"])
def test_engine_matches_jax_engine_gqa_and_window(extra):
    """Grouped-query heads (kernel route) and sliding-window attention
    (gather route) through the paged steps."""
    specs = [(p, dict(max_new=6)) for p in _prompts((3, 9, 6), 97)]
    jeng, eng, jres, res = _run_both(extra, specs, num_slots=2, page_size=8,
                                     max_context=64)
    _assert_same(jres, res, specs)
    _assert_drained(eng)
    assert eng.n_decode_steps == jeng.n_decode_steps


def test_engine_matches_jax_engine_sampled():
    """Greedy / top-k / nucleus / full sampling per request, with the JAX
    engine's Gumbel noise."""
    prompts = _prompts((4, 9, 6, 11), 61, seed=1)
    knobs = [dict(), dict(temperature=0.8, top_k=5),
             dict(temperature=0.7, top_p=0.9), dict(temperature=1.1)]
    specs = [(p, dict(max_new=6, **kw)) for p, kw in zip(prompts, knobs)]
    _, eng, jres, res = _run_both("", specs, noise="jax", num_slots=2,
                                  page_size=8, max_context=64)
    _assert_same(jres, res, specs)
    _assert_drained(eng)


def test_engine_eos_and_token_budget_match_jax():
    """eos retires a slot early; a small chunk and token budget split
    prompts over several mixed steps and hold chunk rows back behind the
    decode rows — both engines schedule and emit the same."""
    tr, ex, params = _model("")
    prompts = _prompts((6, 13, 5, 3, 9, 4), 61, seed=3)
    first = ServingEngine(ex, params, num_slots=1, page_size=8,
                          max_context=32, device="cpu").run(
        [Request(0, prompts[0], max_new=1)])[0]
    eos = int(first[-1])
    specs = [(p, dict(max_new=8, eos_id=eos)) for p in prompts]
    jeng, eng, jres, res = _run_both("", specs, num_slots=2, page_size=8,
                                     max_context=32, prefill_chunk=4,
                                     max_step_tokens=5)
    _assert_same(jres, res, specs)
    _assert_drained(eng)
    assert any(res[i].size < p.size + 8 for i, (p, _) in enumerate(specs))
    assert (eng.n_decode_steps, eng.n_mixed_steps, eng.n_prefill_chunks) == \
        (jeng.n_decode_steps, jeng.n_mixed_steps, jeng.n_prefill_chunks)


def test_default_noise_is_per_request_and_deterministic():
    """The default Philox-style noise depends on (seed, token index) only:
    the same sampled request gives the same tokens alone or beside
    others, and another seed gives other tokens."""
    _, ex, params = _model("")
    p = _prompts((7,), 61, seed=4)[0]
    kw = dict(max_new=12, temperature=1.5)
    alone = ServingEngine(ex, params, num_slots=2, page_size=8,
                          max_context=64, device="cpu").run(
        [Request("a", p, seed=5, **kw)])["a"]
    crowd = ServingEngine(ex, params, num_slots=2, page_size=8,
                          max_context=64, device="cpu").run(
        [Request("x", _prompts((11,), 61, 9)[0], seed=1, **kw),
         Request("a", p, seed=5, **kw), Request("b", p, seed=6, **kw)])
    np.testing.assert_array_equal(alone, crowd["a"])
    assert not np.array_equal(crowd["a"], crowd["b"])


def test_engine_validation_and_device_policy():
    _, ex, params = _model("")
    eng = ServingEngine(ex, params, num_slots=2, page_size=8, max_context=16,
                        device="cpu")
    assert eng.run([Request("z", [3, 4, 5], max_new=0)])["z"].tolist() == \
        [3, 4, 5]
    with pytest.raises(ValueError, match="capacity"):
        eng.add_request(Request("long", np.arange(2, 14), max_new=8))
    with pytest.raises(ValueError, match="vocabulary"):
        eng.add_request(Request("oov", [3, 61], max_new=2))
    with pytest.raises(ValueError, match="temperature"):
        Request("k", [3], top_k=4)
    with pytest.raises(NotImplementedError):
        ServingEngine(ex, params, prefill_chunk=None, device="cpu")
    with pytest.raises(ValueError, match="max_step_tokens"):
        ServingEngine(ex, params, num_slots=4, max_step_tokens=4,
                      device="cpu")
    # entry points default to the CUDA card and never drop to the CPU
    if torch.cuda.is_available():
        assert ServingEngine(ex, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(ex, params)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(ex.model, seed=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_jax({"w": np.zeros(2, np.float32)})
