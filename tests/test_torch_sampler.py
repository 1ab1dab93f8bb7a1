"""PyTorch port: the per-slot sampler against the JAX package's, fed the
Gumbel noise jax.random.gumbel(key, (1, V)) that jax.random.categorical
draws for each slot's key — the tokens must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.sampler import pick_next_per_slot as jax_pick
from paddle_tpu_torch.serving.sampler import greedy_next, pick_next_per_slot

# (temperature, top_k, top_p) per slot: greedy, top-k, nucleus, full,
# top-k + nucleus, and a k that exceeds the vocabulary
KNOBS = [(0.0, 0, 0.0), (0.8, 5, 0.0), (0.7, 0, 0.9), (1.1, 0, 0.0),
         (0.9, 7, 0.6), (1.3, 500, 1.0)]


def _both(last, knobs, key_seed, is_probs):
    S, V = last.shape
    temp = np.array([k[0] for k in knobs], np.float32)
    top_k = np.array([k[1] for k in knobs], np.int32)
    top_p = np.array([k[2] for k in knobs], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(key_seed), S)
    want = jax_pick(jnp.asarray(last), keys, jnp.asarray(temp),
                    jnp.asarray(top_k), jnp.asarray(top_p),
                    is_probs=is_probs)
    noise = np.concatenate([np.asarray(jax.random.gumbel(k, (1, V)))
                            for k in keys])
    got = pick_next_per_slot(torch.from_numpy(last), torch.from_numpy(noise),
                             torch.from_numpy(temp),
                             torch.from_numpy(top_k),
                             torch.from_numpy(top_p), is_probs=is_probs)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("is_probs", [False, True], ids=["logits", "probs"])
def test_sampler_matches_jax_exactly(seed, is_probs):
    rng = np.random.default_rng(seed)
    V = 61
    last = rng.normal(0, 2, (len(KNOBS), V)).astype(np.float32)
    if is_probs:
        e = np.exp(last - last.max(-1, keepdims=True))
        last = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    got, want = _both(last, KNOBS, 100 + seed, is_probs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed", range(3))
def test_sampler_tie_order_matches_jax(seed):
    """Scores drawn from a few distinct values, so top-k cuts through tie
    groups and the nucleus sort orders equal probabilities: top-k keeps
    the lowest indices of a tie (lax.top_k), the nucleus the highest
    (flipped stable argsort), greedy the first maximum."""
    rng = np.random.default_rng(10 + seed)
    V = 24
    knobs = [(0.0, 0, 0.0), (1.0, 3, 0.0), (1.0, 0, 0.3), (1.0, 5, 0.45),
             (0.5, 2, 0.0), (1.0, 0, 0.0)] * 2
    last = rng.choice(np.array([-1.0, 0.0, 1.5, 2.0], np.float32),
                      (len(knobs), V))
    last[:, :4] = 2.0                       # a guaranteed 4-way top tie
    for key_seed in range(6):
        got, want = _both(last, knobs, 1000 * seed + key_seed, False)
        np.testing.assert_array_equal(got, want)


def test_greedy_takes_the_first_maximum_and_needs_no_noise():
    last = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 5.0, 5.0, 5.0]])
    assert greedy_next(last).tolist() == [1, 0]
    zeros = torch.zeros(2)
    got = pick_next_per_slot(last, None, zeros, zeros.int(), zeros)
    assert got.tolist() == [1, 0]
    with pytest.raises(ValueError, match="noise"):
        pick_next_per_slot(last, None, torch.ones(2), zeros.int(), zeros)
