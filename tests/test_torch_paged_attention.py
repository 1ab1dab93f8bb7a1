"""PyTorch port: the ragged paged-attention function (the CUDA kernel's
plain PyTorch version, which its wrapper runs for CPU tensors) and the
paged attention steps, against the JAX gather path and the Pallas kernel
run in interpret mode, in float32 (tolerance 2e-5: summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)
# (slots, heads, kv heads, head dim, page size, pages per slot)
SHAPES = [(3, 4, 2, 8, 4, 4), (2, 8, 8, 16, 8, 3), (4, 6, 3, 32, 16, 2)]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _pools(rng, S, Hkv, D, ps, maxp):
    P = 1 + S * maxp
    kp = rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)
    return kp, vp


def _table(rng, S, ps, maxp, need_tokens):
    """Distinct physical pages (never the trash page 0) covering each
    slot's tokens, plus the all-zero row S that padding rows address."""
    table = np.zeros((S + 1, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, 1 + S * maxp)))
    for s in range(S):
        for j in range(-(-int(need_tokens[s]) // ps)):
            table[s, j] = free.pop()
    return table


def _decode_case(seed, S, H, Hkv, D, ps, maxp):
    rng = np.random.default_rng(seed)
    kp, vp = _pools(rng, S, Hkv, D, ps, maxp)
    pos = rng.integers(0, maxp * ps - 1, S).astype(np.int32)
    table = _table(rng, S, ps, maxp, pos + 1)[:S]
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    kn = rng.normal(size=(S, 1, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(S, 1, Hkv, D)).astype(np.float32)
    return q, kn, vn, kp, vp, table, pos


def _ragged_case(seed, S, H, Hkv, D, ps, maxp, n_pad=3):
    """Slot 0 prefills a chunk of rows, the other slots decode one row
    each, then padding rows (row_slot S, row_pos 0)."""
    rng = np.random.default_rng(seed)
    kp, vp = _pools(rng, S, Hkv, D, ps, maxp)
    cap = maxp * ps
    end = rng.integers(2, cap + 1, S)
    start0 = int(rng.integers(0, end[0]))
    table = _table(rng, S, ps, maxp, end)
    row_slot = np.concatenate([np.zeros(end[0] - start0), np.arange(1, S),
                               np.full(n_pad, S)]).astype(np.int32)
    row_pos = np.concatenate([np.arange(start0, end[0]), end[1:] - 1,
                              np.zeros(n_pad)]).astype(np.int32)
    T = row_slot.size
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    kn = rng.normal(size=(T, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(T, Hkv, D)).astype(np.float32)
    return q, kn, vn, kp, vp, table, row_slot, row_pos


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("use_kernel", [None, False], ids=["kernel",
                                                           "gather"])
def test_decode_step_matches_jax_gather(shape, use_kernel):
    """paged_attention_step: scatter-write then read; on the CPU the kernel
    route runs the plain version.  Output and pools (outside the trash
    page) equal the JAX gather path's; the pools update in place."""
    q, kn, vn, kp, vp, table, pos = _decode_case(1, *shape)
    want, jk, jv = jattn.paged_attention_step(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(pos),
        use_kernel=False)
    tk, tv = _t(kp), _t(vp)
    before = pa.counts.plain
    out, ck, cv = tattn.paged_attention_step(
        _t(q), _t(kn), _t(vn), tk, tv, _t(table), _t(pos),
        use_kernel=use_kernel)
    assert ck is tk and cv is tv
    assert pa.counts.plain - before == (1 if use_kernel is None else 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(ck.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(cv.numpy()[1:], np.asarray(jv)[1:])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("use_kernel", [None, False], ids=["kernel",
                                                           "gather"])
def test_ragged_step_matches_jax_gather(shape, use_kernel):
    """ragged_paged_attention_step with a prompt chunk, decode rows and
    padding rows: chunk rows see each other's K/V under the causal mask."""
    q, kn, vn, kp, vp, table, row_slot, row_pos = _ragged_case(2, *shape)
    want, jk, jv = jattn.ragged_paged_attention_step(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(row_slot),
        jnp.asarray(row_pos), use_kernel=False)
    out, ck, cv = tattn.ragged_paged_attention_step(
        _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(table), _t(row_slot),
        _t(row_pos), use_kernel=use_kernel)
    real = row_slot < shape[0]              # padding rows read the trash page
    np.testing.assert_allclose(out.numpy()[real], np.asarray(want)[real],
                               **TOL)
    np.testing.assert_array_equal(ck.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(cv.numpy()[1:], np.asarray(jv)[1:])


def test_window_routes_through_the_gather():
    """Sliding-window layers read through the gather, as in JAX; the
    kernel route refuses a window."""
    shape = SHAPES[0]
    q, kn, vn, kp, vp, table, row_slot, row_pos = _ragged_case(3, *shape)
    want, _, _ = jattn.ragged_paged_attention_step(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(row_slot),
        jnp.asarray(row_pos), window=3, use_kernel=False)
    before = pa.counts.plain
    out, _, _ = tattn.ragged_paged_attention_step(
        _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(table), _t(row_slot),
        _t(row_pos), window=3)
    assert pa.counts.plain == before
    real = row_slot < shape[0]
    np.testing.assert_allclose(out.numpy()[real], np.asarray(want)[real],
                               **TOL)
    with pytest.raises(ValueError, match="window"):
        tattn.ragged_paged_attention_step(
            _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(table), _t(row_slot),
            _t(row_pos), window=3, use_kernel=True)


@pytest.mark.parametrize("rows", ["decode", "ragged"])
def test_plain_version_matches_pallas_interpret(rows):
    """The plain version equals the Pallas TPU kernel run in interpret
    mode on the same (already written) pools, padding rows included —
    one tiny shape each, interpret mode being slow."""
    from paddle_tpu.ops.pallas_paged import paged_attention as pallas
    S, H, Hkv, D, ps, maxp = 2, 4, 2, 8, 4, 3
    if rows == "decode":
        q, _, _, kp, vp, table, pos = _decode_case(5, S, H, Hkv, D, ps,
                                                   maxp)
        q, lengths, row_slot = q[:, 0], pos + 1, None
    else:
        q, _, _, kp, vp, table, row_slot, row_pos = _ragged_case(
            6, S, H, Hkv, D, ps, maxp, n_pad=1)
        lengths = row_pos + 1
    want = pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(table), jnp.asarray(lengths),
                  row_slot=None if row_slot is None
                  else jnp.asarray(row_slot))
    got = pa.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                             _t(lengths),
                             row_slot=None if row_slot is None
                             else _t(row_slot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_checks_its_inputs():
    q, _, _, kp, vp, table, pos = _decode_case(7, *SHAPES[0])
    args = (_t(q[:, 0]), _t(kp), _t(vp), _t(table))
    lengths = _t(pos + 1)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(*args, lengths.long())
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_attention(args[0].double(), *args[1:], lengths)
    with pytest.raises(ValueError):
        pa.paged_attention(args[0][:, :3], *args[1:], lengths)
    with pytest.raises(ValueError):
        pa.paged_attention(*args, lengths[:2])
    assert pa.paged_attention(*args, lengths).shape == args[0].shape
