"""Sampled tokens of the port equal the JAX package's, with no noise fed
across: the port draws its Gumbel noise from the request keys with its own
threefry (utils/prng.py), as the JAX engine and lm_generate draw theirs.

Held on the CPU at a toy LM (vocab 31, dim 16, 1 layer, 2 heads; the JAX
trainer's parameters carried by `params_from_jax`): the serving engine at
decode_steps 1 and 4 (the window bodies draw on the device), speculative
decode, `lm_generate` in both modes, and a request through the
`ServingServer` whose wire `seed` is PRNGKey(seed).  Tokens exactly
equal.
"""

import jax
import numpy as np
import pytest

from test_torch_prefix_cache import lm
from test_torch_server import M31, FrameRun, by_id

ENGINE = dict(num_slots=4, page_size=8, max_context=64)


def _specs(n: int = 12):
    """n sampled requests: prompts of 2-9 tokens, temperature 0.6-1.6,
    top_k among 0, 3 and 8, top_p among 0, 0.6 and 0.9, max_new 4-9, and
    each its own seed."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(n):
        out.append((rng.integers(2, 31, int(rng.integers(2, 10))).astype(
            np.int32), dict(max_new=int(rng.integers(4, 10)),
                            temperature=float(rng.uniform(0.6, 1.6)),
                            top_k=(0, 3, 8)[i % 3],
                            top_p=(0.0, 0.6, 0.9)[(i // 3) % 3]),
                    1000 + 7 * i))
    return out


def _run_jax(specs, **kw):
    from paddle_tpu.serving import Request, ServingEngine
    tr, _, _ = lm(*M31)
    eng = ServingEngine(tr.executor, tr.params, **{**ENGINE, **kw})
    return eng.run([Request(i, p, rng=jax.random.PRNGKey(s), **k)
                    for i, (p, k, s) in enumerate(specs)])


def _run_port(specs, **kw):
    from paddle_tpu_torch.serving import Request, ServingEngine
    _, ex, params = lm(*M31)
    eng = ServingEngine(ex, params, device="cpu", **{**ENGINE, **kw})
    res = eng.run([Request(i, p, seed=s, **k)
                   for i, (p, k, s) in enumerate(specs)])
    return eng, res


def _assert_same(jres, res, n):
    assert sorted(res) == sorted(jres) == list(range(n))
    for i in range(n):
        np.testing.assert_array_equal(res[i], jres[i],
                                      err_msg=f"request {i} diverged")


@pytest.mark.parametrize("k", [1, 4])
def test_engine_sampled_tokens_equal_jax(k):
    """12 sampled requests through 4 slots (refills mid-flight, mixed
    steps) at decode_steps k: the port's tokens are the JAX engine's."""
    specs = _specs()
    jres = _run_jax(specs, decode_steps=k)
    eng, res = _run_port(specs, decode_steps=k)
    _assert_same(jres, res, len(specs))
    if k > 1:
        assert eng.n_scan_flushes > 0


def test_spec_decode_sampled_tokens_equal_jax():
    """Speculative decode (n-gram drafter, 2 drafts): each chain position
    samples with its generation's key, so the tokens equal the JAX
    engine's with speculation and the port's without."""
    specs = _specs()
    jres = _run_jax(specs, spec_k=2)
    eng, res = _run_port(specs, spec_k=2)
    _assert_same(jres, res, len(specs))
    assert eng.n_spec_steps > 0
    _, plain = _run_port(specs)
    _assert_same(plain, res, len(specs))


@pytest.mark.parametrize("use_cache", [False, True])
def test_lm_generate_sampled_equals_jax(use_cache):
    """lm_generate's step i samples the whole batch with split(rng,
    max_new)[i], on both sides: equal tokens and lengths, and seed= spells
    rng=PRNGKey(seed)."""
    from paddle_tpu.graph.lm_decode import lm_generate as jgen
    from paddle_tpu_torch.graph.lm_decode import lm_generate
    from paddle_tpu_torch.utils import prng
    tr, ex, params = lm(*M31)
    ids = np.random.default_rng(3).integers(2, 31, (3, 5)).astype(np.int32)
    lens = np.array([5, 3, 4], np.int32)
    kw = dict(max_new=6, temperature=1.3, top_k=6, top_p=0.9, eos_id=2)
    want, wlen = jgen(tr.executor, tr.params, ids, lens,
                      rng=jax.random.PRNGKey(77), use_cache=use_cache, **kw)
    got, glen = lm_generate(ex, params, ids, lens, rng=prng.PRNGKey(77),
                            use_cache=use_cache, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    again, _ = lm_generate(ex, params, ids, lens, seed=77,
                           use_cache=use_cache, device="cpu", **kw)
    assert np.array_equal(again.numpy(), got.numpy())


def test_server_seed_is_the_jax_key():
    """A generate frame's `seed` becomes PRNGKey(seed) on both servers (no
    seed: the Request's PRNGKey(0)): the port server's token and done
    frames equal the JAX server's."""
    p = np.random.default_rng(5).integers(2, 31, (2, 6)).tolist()
    knobs = dict(max_new=7, temperature=1.2, top_k=5)
    reqs = [(0, p[0], dict(knobs, seed=42)), (1, p[1], dict(knobs)),
            (2, p[0], dict(knobs, seed=43))]
    frames = {side: FrameRun(side, 1).run(reqs) for side in ("jax", "port")}
    for kind in ("token", "done"):
        assert by_id(frames["port"], kind) == by_id(frames["jax"], kind)
    done = by_id(frames["port"], "done")
    assert done[0] != done[2]
