"""The port's threefry2x32 (paddle_tpu_torch/utils/prng.py) held against
`jax.random` in its partitionable mode, on the CPU.

Integer streams (PRNGKey, split, fold_in, bits), uniform, bernoulli and
categorical's ids are held bit for bit.  normal goes through torch.erfinv
and gumbel through torch.log, which differ from XLA's in the last bits of
some values: normal within 2e-5 and gumbel within 2e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.utils import prng

SHAPES = [(), (7,), (3, 5), (1, 97)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def test_jax_draws_in_partitionable_mode():
    """Every comparison below assumes this mode (jax_threefry_partitionable,
    True by default since jax 0.5); an upgrade that changes it fails here."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_random123_known_answers(key, count, want):
    """Random123's threefry2x32-20 known answers, on tensors and on Python
    ints (the host key schedule's path)."""
    got = prng.threefry2x32(*(torch.tensor(v) for v in key + count))
    assert tuple(int(g) for g in got) == want
    assert prng.threefry2x32(*key, *count) == want


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -2 ** 31,
                                  2 ** 32 + 5, -2 ** 63])
def test_prng_key_equals_jax(seed):
    assert np.array_equal(_np(prng.PRNGKey(seed)),
                          np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_out_of_int64_raises_as_jax():
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2 ** 63)
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 63)


@pytest.mark.parametrize("n", [2, 5, 1000])
def test_split_equals_jax(n):
    k = jax.random.PRNGKey(1234)
    want = np.asarray(jax.random.split(k, n))
    assert np.array_equal(_np(prng.split(prng.PRNGKey(1234), n)), want)
    # batched keys split row by row
    ks = prng.split(prng.PRNGKey(7), 3)
    got = prng.split(ks, n)
    for i in range(3):
        assert np.array_equal(_np(got[i]), np.asarray(jax.random.split(
            jax.random.split(jax.random.PRNGKey(7), 3)[i], n)))


@pytest.mark.parametrize("data", [0, 1, 17, 2 ** 31 - 1 - 2])
def test_fold_in_equals_jax(data):
    k = jax.random.PRNGKey(99)
    want = np.asarray(jax.random.fold_in(k, data))
    assert np.array_equal(_np(prng.fold_in(prng.PRNGKey(99), data)), want)
    # a tensor of data against [S, 2] keys (the engine's device path)
    keys = prng.split(prng.PRNGKey(99), 4)
    got = prng.fold_in(keys[:, None], torch.tensor([[data, data + 1]] * 4))
    for s in range(4):
        js = jax.random.split(k, 4)[s]
        assert np.array_equal(_np(got[s, 0]),
                              np.asarray(jax.random.fold_in(js, data)))
        assert np.array_equal(_np(got[s, 1]),
                              np.asarray(jax.random.fold_in(js, data + 1)))
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), -1)


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli_bit_exact(shape):
    k = jax.random.PRNGKey(31)
    tk = prng.PRNGKey(31)
    assert np.array_equal(_np(prng.bits(tk, shape)),
                          np.asarray(jax.random.bits(k, shape)))
    assert np.array_equal(_np(prng.uniform(tk, shape)),
                          np.asarray(jax.random.uniform(k, shape)))
    assert np.array_equal(
        _np(prng.uniform(tk, shape, minval=-0.3, maxval=0.7)),
        np.asarray(jax.random.uniform(k, shape, minval=-0.3, maxval=0.7)))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        assert np.array_equal(
            prng.uniform(tk, shape, dt).float().numpy(),
            np.asarray(jax.random.uniform(k, shape, jdt), np.float32))
    for p in (0.1, 0.5, 0.8):
        assert np.array_equal(_np(prng.bernoulli(tk, p, shape)),
                              np.asarray(jax.random.bernoulli(k, p, shape)))


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_and_gumbel_within_last_bits(shape):
    k = jax.random.PRNGKey(5)
    tk = prng.PRNGKey(5)
    np.testing.assert_allclose(_np(prng.normal(tk, shape)),
                               np.asarray(jax.random.normal(k, shape)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(prng.gumbel(tk, shape)),
                               np.asarray(jax.random.gumbel(k, shape)),
                               rtol=0, atol=2e-6)


def test_batched_gumbel_rows_equal_jax_per_slot_draw():
    """The engine's [S, V] noise: row s is JAX's per-slot gumbel(keys[s],
    (1, V))[0]."""
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    got = prng.gumbel(prng.as_key(np.asarray(keys)), (11,))
    for s in range(5):
        np.testing.assert_allclose(
            _np(got[s]), np.asarray(jax.random.gumbel(keys[s], (1, 11)))[0],
            rtol=0, atol=2e-6)


@pytest.mark.parametrize("axis,shape", [(-1, None), (-1, (4, 3)),
                                        (0, None), (0, (2, 6))])
def test_categorical_ids_exact(axis, shape):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 6) if axis == -1 else (6, 3)).astype(
        np.float32) * 3.0
    if axis == 0 and shape is not None:
        logits = rng.normal(size=(5, 6)).astype(np.float32)
    k = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.categorical(k, logits, axis=axis,
                                             shape=shape))
    got = prng.categorical(prng.PRNGKey(11), torch.from_numpy(logits),
                           axis=axis, shape=shape)
    assert np.array_equal(_np(got), want)


def test_last_bit_deltas_over_two_million_draws():
    """normal and gumbel over 2,000,000 draws of one key against
    jax.random's: uniform bit for bit; normal within 1e-5 of max(1, |x|)
    and gumbel within 2e-6 absolute (torch's erfinv and log against XLA's
    differ in the last bits; run with -s for the counts ROADMAP.md Queue 3
    records)."""
    n = 2_000_000
    k, tk = jax.random.PRNGKey(1234), prng.PRNGKey(1234)
    assert np.array_equal(_np(prng.uniform(tk, (n,))),
                          np.asarray(jax.random.uniform(k, (n,))))
    for name, tol, scaled in (("normal", 1e-5, True),
                              ("gumbel", 2e-6, False)):
        got = _np(getattr(prng, name)(tk, (n,)))
        want = np.asarray(getattr(jax.random, name)(k, (n,)))
        err = np.abs(got - want)
        print(f"{name}: {int((got != want).sum())} of {n} differ, max abs "
              f"{float(err.max()):.3g}")
        if scaled:
            err = err / np.maximum(1.0, np.abs(want))
        assert float(err.max()) <= tol, (name, float(err.max()))
