"""PyTorch port: the dense decode path — `cached_attention_step` and
`blockwise_attention` (ops/attention.py), `lm_generate` in both modes and
`lm_beam_generate` (graph/lm_decode.py) — against the JAX package on the
CPU.

The ops within 1e-5 (float32; the JAX versions on the same numpy
inputs); tokens and lengths exactly; beam scores within 1e-5.  The
models are the transformer LM of demo/model_zoo/transformer_lm.py at toy
widths with the JAX Trainer's parameters carried across
(`params_from_jax`); sampling gets JAX's Gumbel noise for keys =
split(rng, max_new) through the `noise` hook.  The K4 prefill route runs
the Pallas kernel in interpret mode on the JAX side and the flash plain
version in the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.graph import lm_decode as jdecode
from paddle_tpu.ops import attention as jattn
from paddle_tpu.trainer.trainer import Trainer
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.graph.lm_decode import lm_beam_generate, lm_generate
from paddle_tpu_torch.models import transformer_lm_config
from paddle_tpu_torch.ops import attention as attn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parameter import params_from_jax

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Many small ops: two torch threads keep them from spinning against
    the other test workers' threads (tests/test_torch_image.py's rule)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def lm(vocab: int, dim: int, layers: int, heads: int, **kw):
    """(JAX trainer, port executor, the trainer's parameters carried
    across) of the transformer LM with these config args."""
    args = f"vocab={vocab},dim={dim},layers={layers},heads={heads}," \
           f"batch_size=4" + "".join(f",{k}={v}" for k, v in kw.items())
    tr = Trainer(parse_config("demo/model_zoo/transformer_lm.py", args),
                 seed=7)
    ex = GraphExecutor(transformer_lm_config(vocab, dim, layers, heads, **kw))
    params = params_from_jax({k: np.asarray(v) for k, v in tr.params.items()},
                             device="cpu")
    return tr, ex, params


def prompts(B, P, vocab, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (B, P)).astype(np.int32)
    lens = (rng.integers(2, P + 1, B).astype(np.int32) if ragged
            else np.full((B,), P, np.int32))
    return ids, lens


def jax_noise(rng, max_new: int, B: int, vocab: int):
    """The port's noise hook giving JAX's step-i Gumbel noise."""
    keys = jax.random.split(rng, max_new)
    return lambda i: torch.tensor(np.asarray(
        jax.random.gumbel(keys[i], (B, vocab))))


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def test_cached_attention_step_matches_jax():
    """A multi-token call at per-row offsets (GQA, window 4), then a
    one-token call: outputs within 1e-5, caches and positions exactly."""
    rng = np.random.default_rng(1)
    B, H, Hkv, D, Tmax = 3, 4, 2, 8, 12

    def mk(*shape):
        return rng.normal(size=shape).astype(np.float32)

    cache_k, cache_v = mk(B, Tmax, Hkv, D), mk(B, Tmax, Hkv, D)
    pos = np.array([0, 3, 5], np.int32)
    jck, jcv, jpos = cache_k, cache_v, pos
    ck, cv = torch.tensor(cache_k), torch.tensor(cache_v)
    tpos = torch.tensor(pos)
    for Tn, n_new in ((4, [4, 2, 3]), (1, [1, 1, 1])):
        q, k, v = mk(B, Tn, H, D), mk(B, Tn, Hkv, D), mk(B, Tn, Hkv, D)
        n_new = np.asarray(n_new, np.int32)
        jo, jck, jcv, jpos = jattn.cached_attention_step(
            *map(jnp.asarray, (q, k, v, jck, jcv, jpos, n_new)), window=4)
        o, ck, cv, tpos = attn.cached_attention_step(
            *map(torch.tensor, (q, k, v)), ck, cv, tpos,
            torch.tensor(n_new), window=4)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL)
        np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
        np.testing.assert_array_equal(cv.numpy(), np.asarray(jcv))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("causal,window,h_kv,ragged,block_k", [
    (True, None, 2, False, 4),       # GQA, Tk = 11 leaves a padded tail
    (True, 3, 4, True, 5),           # window, ragged query and key rows
    (False, None, 4, True, 16),      # one block, a row without keys
])
def test_blockwise_attention_matches_jax(causal, window, h_kv, ragged,
                                         block_k):
    """The forward within 1e-5 of JAX's blockwise and dense attention; in
    the first case also the gradients of a weighted sum (the per-block
    recompute) within 1e-5 of JAX's (through its dense attention, the
    same function)."""
    rng = np.random.default_rng(2)
    B, T, H, D = 2, 11, 4, 8
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, h_kv, D)).astype(np.float32)
            for _ in range(2))
    qv = kv = None
    if ragged:
        qv = np.arange(T)[None] < np.array([[9], [T]])
        kv = np.arange(T)[None] < np.array([[0 if not causal else 7], [T]])
    kw = dict(causal=causal, window=window)
    want = jattn.blockwise_attention(
        *map(jnp.asarray, (q, k, v)),
        q_valid=None if qv is None else jnp.asarray(qv),
        k_valid=None if kv is None else jnp.asarray(kv), block_k=block_k,
        **kw)
    dense = jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)),
        q_valid=None if qv is None else jnp.asarray(qv),
        k_valid=None if kv is None else jnp.asarray(kv), **kw)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = attn.blockwise_attention(
        tq, tk, tv, q_valid=None if qv is None else torch.tensor(qv),
        k_valid=None if kv is None else torch.tensor(kv), block_k=block_k,
        **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(dense),
                               atol=TOL)
    if h_kv == 2:
        w = rng.normal(size=got.shape).astype(np.float32)
        jg = jax.grad(lambda a, b, c: jnp.sum(jattn.dot_product_attention(
            a, b, c, **kw) * w), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
        (got * torch.tensor(w)).sum().backward()
        for t, j in zip((tq, tk, tv), jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       atol=TOL)


# ---------------------------------------------------------------------------
# lm_generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,ragged", [
    ({}, True),                         # MHA + rope, ragged prompts
    ({"kv_heads": 2}, False),           # grouped-query heads
    ({"window": 5}, True),              # sliding window
    ({"block_k_min": 4}, True),         # the long-prompt prefill branch
])
def test_lm_generate_matches_jax(kw, ragged):
    """tests/test_lm_cache.py's cases: both modes give JAX's tokens and
    lengths exactly (and so agree with each other).  At block_k_min=4 the
    port's prefill takes flash (its plain version here), JAX's the
    blockwise loop."""
    tr, ex, params = lm(97, 32, 2, 4, **kw)
    ids, lens = prompts(4, 9, 97, ragged=ragged)
    for use_cache in (False, True):
        want = jdecode.lm_generate(tr.executor, tr.params, ids,
                                   prompt_lengths=lens, max_new=7,
                                   use_cache=use_cache)
        fa.counts.reset()
        got = lm_generate(ex, params, ids, prompt_lengths=lens, max_new=7,
                          use_cache=use_cache, device="cpu")
        assert_same(got, want)
        if use_cache:
            assert fa.counts.plain == (2 if "block_k_min" in kw else 0)


def test_lm_generate_eos_and_early_exit_match_jax(monkeypatch):
    """eos stops rows early (the eos id one that every row's greedy
    continuation holds); with early_exit_chunk=2 the loop ends with the
    chunk in which the last row stopped.  Both modes give JAX's tokens
    (JAX's without chunks: its chunked scan is bit-exact with it)."""
    tr, ex, params = lm(11, 16, 1, 2)
    ids, lens = prompts(3, 6, 11, seed=7)
    free, _ = lm_generate(ex, params, ids, prompt_lengths=lens, max_new=8,
                          use_cache=True, device="cpu")
    rows = [set(free[b, lens[b]:lens[b] + 8].tolist()) for b in range(3)]
    eos = min(set.intersection(*rows))
    kw = dict(prompt_lengths=lens, max_new=8, eos_id=eos)
    want = jdecode.lm_generate(tr.executor, tr.params, ids, use_cache=True,
                               **kw)
    forwards = []
    run = ex.forward
    monkeypatch.setattr(ex, "forward",
                        lambda *a, **k: forwards.append(1) or run(*a, **k))
    for use_cache in (False, True):
        for chunk in (0, 2):
            forwards.clear()
            got = lm_generate(ex, params, ids, use_cache=use_cache,
                              early_exit_chunk=chunk, device="cpu", **kw)
            assert_same(got, want)
            if chunk:
                # the step that stopped the last row; the loop ends with
                # that step's chunk (the cached mode's prefill is step 0,
                # its chunks start at step 1)
                s = int((got[1].numpy() - lens).max()) - 1
                assert len(forwards) == (
                    1 + min(7, ((max(s, 1) - 1) // 2 + 1) * 2) if use_cache
                    else min(8, (s // 2 + 1) * 2))
    assert int((got[1].numpy() - lens).max()) < 4


@pytest.mark.parametrize("knobs,use_cache", [
    (dict(temperature=1.3), False), (dict(temperature=0.8, top_k=5), True),
    (dict(temperature=0.7, top_p=0.9), True),
    (dict(temperature=0.7, top_p=0.9), False)])
def test_lm_generate_sampling_with_jax_noise(knobs, use_cache):
    """Sampled decoding fed JAX's Gumbel noise gives JAX's tokens."""
    tr, ex, params = lm(97, 32, 2, 4)
    ids, lens = prompts(4, 9, 97, seed=4)
    rng = jax.random.PRNGKey(3)
    want = jdecode.lm_generate(tr.executor, tr.params, ids,
                               prompt_lengths=lens, max_new=6, rng=rng,
                               use_cache=use_cache, **knobs)
    got = lm_generate(ex, params, ids, prompt_lengths=lens, max_new=6,
                      noise=jax_noise(rng, 6, 4, 97), use_cache=use_cache,
                      device="cpu", **knobs)
    assert_same(got, want)


@pytest.mark.parametrize("B,P,lens,max_new", [
    (1, 1, [1], 1),           # singleton everything
    (3, 4, [1, 4, 2], 5),     # ragged prompts incl. length 1
    (2, 3, [3, 2], 0),        # nothing to generate
])
def test_lm_generate_edges_match_jax(B, P, lens, max_new):
    """tests/test_degenerate_shapes.py's edges: both modes give JAX's
    cached tokens (its own tests hold its two modes equal); and the knob
    check."""
    tr, ex, params = lm(11, 16, 1, 2)
    ids = np.ones((B, P), np.int32)
    lens = np.asarray(lens, np.int32)
    want = jdecode.lm_generate(tr.executor, tr.params, ids,
                               prompt_lengths=lens, max_new=max_new,
                               use_cache=True)
    for use_cache in (False, True):
        got = lm_generate(ex, params, ids, prompt_lengths=lens,
                          max_new=max_new, use_cache=use_cache, device="cpu")
        assert_same(got, want)
    with pytest.raises(ValueError, match="temperature"):
        lm_generate(ex, params, ids, max_new=max_new, top_k=3, device="cpu")


def test_flash_prefill_matches_pallas_interpret(monkeypatch):
    """At block_k_min=8 the cached prefill of 12-token prompts runs the
    flash route: the JAX Pallas kernel in interpret mode, the port's flash
    plain version (once per layer, the paged and dense paths never):
    tokens equal."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    tr, ex, params = lm(61, 32, 2, 4, block_k_min=8)
    ids, lens = prompts(3, 12, 61, seed=5)
    lens[0] = 12
    want = jdecode.lm_generate(tr.executor, tr.params, ids,
                               prompt_lengths=lens, max_new=4,
                               use_cache=True)
    fa.counts.reset()
    got = lm_generate(ex, params, ids, prompt_lengths=lens, max_new=4,
                      use_cache=True, device="cpu")
    assert_same(got, want)
    assert fa.counts.plain == 2


# ---------------------------------------------------------------------------
# lm_beam_generate
# ---------------------------------------------------------------------------

def test_beam_matches_jax_and_greedy():
    """Tokens and lengths exactly, scores within 1e-5 of JAX's; beam 1 is
    greedy cached decoding; a beam that emits eos is frozen at its
    score."""
    tr, ex, params = lm(97, 32, 2, 4)
    ids, lens = prompts(3, 9, 97, seed=6)
    want = jdecode.lm_beam_generate(tr.executor, tr.params, ids,
                                    prompt_lengths=lens, beam_size=3,
                                    max_new=6)
    got = lm_beam_generate(ex, params, ids, prompt_lengths=lens,
                           beam_size=3, max_new=6, device="cpu")
    assert_same(got[:2], want[:2])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=TOL)
    assert (np.diff(got[2].numpy(), axis=1) <= 0).all()
    one = lm_beam_generate(ex, params, ids, prompt_lengths=lens,
                           beam_size=1, max_new=6, device="cpu")
    greedy = lm_generate(ex, params, ids, prompt_lengths=lens, max_new=6,
                         use_cache=True, device="cpu")
    np.testing.assert_array_equal(one[0][:, 0].numpy(), greedy[0].numpy())
    # eos: the best beam's second token stops it; the frozen beam keeps
    # its length and score
    eos = int(got[0][0, 0, lens[0] + 1])
    want = jdecode.lm_beam_generate(tr.executor, tr.params, ids,
                                    prompt_lengths=lens, beam_size=3,
                                    max_new=6, eos_id=eos)
    got = lm_beam_generate(ex, params, ids, prompt_lengths=lens,
                           beam_size=3, max_new=6, eos_id=eos, device="cpu")
    assert_same(got[:2], want[:2])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=TOL)
    assert (got[1].numpy() < lens[:, None] + 6).any()
    empty = lm_beam_generate(ex, params, ids, beam_size=2, max_new=0,
                             device="cpu")
    assert empty[0].shape == (3, 2, 9) and not empty[2].any()
