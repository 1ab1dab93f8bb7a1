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
    with pytest.raises(ValueError, match="own table rows"):
        pa.paged_attention(*args[:3], args[3][:2], lengths)
    assert pa.paged_attention(*args, lengths).shape == args[0].shape


@pytest.mark.parametrize("maxp,ps,want", [
    (48, 16, (8, 96)),        # the serving run: 768 positions
    (256, 16, (8, 512)),      # 4096 positions: 8 splits of 512
    (4, 16, (1, 64)),         # short tables: one split
    (8, 16, (1, 128)),
    (9, 16, (2, 96)),
    (154, 5, (8, 128)),       # 770 positions, pages of 5
    (16, 48, (8, 96))])
def test_split_plan_reads_shapes_alone(maxp, ps, want):
    """The split count and tokens per split come from (maxp, page size):
    the splits cover every position, each a multiple of 32 tokens."""
    splits, spl = pa.split_plan(16, 16, maxp, ps)
    assert (splits, spl) == want
    assert splits in (1, 2, 4, 8) and spl % pa.BLOCK_TOKENS == 0
    assert splits * spl >= maxp * ps


@pytest.mark.parametrize("rows,tables,want", [
    (16, 16, 8), (16, 17, 8),     # decode: the context decides
    (80, 17, 1),                  # the serving run's mixed step
    (34, 17, 4), (18, 17, 4), (40, 5, 1)])
def test_split_plan_takes_fewer_splits_for_more_rows(rows, tables, want):
    assert pa.split_plan(rows, tables, 48, 16)[0] == want


def test_split_plan_takes_a_pinned_count():
    assert pa.split_plan(16, 16, 48, 16, splits=2) == (2, 384)
    assert pa.split_plan(16, 16, 48, 16, splits=1) == (1, 768)
    with pytest.raises(ValueError, match="splits"):
        pa.split_plan(16, 16, 48, 16, splits=3)


@pytest.mark.parametrize("splits", [None, 1, 8])
def test_pinned_launch_refuses_cpu_tensors(splits):
    """The measurement launch (`_launch`, the split count pinned or not)
    runs the kernel or raises: on CPU tensors it raises, never falling
    back to the plain version."""
    q, _, _, kp, vp, table, pos = _decode_case(7, *SHAPES[0])
    args = (_t(q[:, 0]), _t(kp), _t(vp), _t(table), _t(pos + 1))
    plain = pa.counts.plain
    with pytest.raises(ValueError, match="no kernel"):
        pa._launch(*args, splits=splits)
    assert pa.counts.plain == plain


def _kernel_model(q, kp, vp, table, lengths, row_slot, scale, splits, spl):
    """The kernel's algorithm in float64 PyTorch: per (row, kv head,
    split) an online softmax over blocks of 32 staged tokens of the row's
    table row, masked at the row's length, the splits' states merged in
    rank order; a split past the length holds no state."""
    R, H, D = q.shape
    _, ps, hkv, _ = kp.shape
    rep = H // hkv
    cap = table.shape[1] * ps
    out = torch.zeros(R, H, D, dtype=torch.float64)
    for r in range(R):
        n = min(max(int(lengths[r]), 0), cap)
        trow = table[int(row_slot[r])].long()
        live = max(1, min(splits, -(-n // spl)))
        for g in range(hkv):
            qv = q[r, g * rep:(g + 1) * rep].double()
            states = []
            for z in range(live):
                m = torch.full((rep,), -1e30, dtype=torch.float64)
                l = torch.zeros(rep, dtype=torch.float64)
                acc = torch.zeros(rep, D, dtype=torch.float64)
                for tb in range(z * spl, min(z * spl + spl, n), 32):
                    t = torch.arange(tb, min(tb + 32, z * spl + spl, n))
                    k = kp[trow[t // ps], t % ps, g].double()
                    v = vp[trow[t // ps], t % ps, g].double()
                    s = qv @ k.T * scale
                    m_new = torch.maximum(m, s.max(1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ v
                    m = m_new
                states.append((m, l, acc))
            mx = torch.stack([st[0] for st in states]).max(0).values
            lsum = sum(torch.exp(st[0] - mx) * st[1] for st in states)
            o = sum(torch.exp(st[0] - mx)[:, None] * st[2] for st in states)
            out[r, g * rep:(g + 1) * rep] = o / lsum.clamp_min(1e-30)[:, None]
    return out


def _layout_case(seed, S, H, Hkv, D, ps, maxp, layout):
    """Pools, table and rows: 'decode' one row per slot; 'edge' decode rows
    of slots 2, 3 (length 1, full), a chunk of slot 0 from row 2, the chunk
    of slot 1 right after it, two padding rows on the all-zero table row
    S."""
    rng = np.random.default_rng(seed)
    kp, vp = _pools(rng, S, Hkv, D, ps, maxp)
    cap = maxp * ps
    lens = rng.integers(20, cap + 1, S)
    lens[2], lens[3] = 1, cap
    table = _table(rng, S, ps, maxp, lens)
    if layout == "decode":
        row_slot, lengths = np.arange(S), lens
    else:
        row_slot = np.array([2, 3] + [0] * 19 + [1] * 11 + [S, S])
        lengths = np.concatenate([[1, cap], np.arange(lens[0] - 18,
                                                      lens[0] + 1),
                                  np.arange(lens[1] - 10, lens[1] + 1),
                                  [1, 1]])
    q = rng.normal(size=(row_slot.size, H, D)).astype(np.float32)
    return (_t(q), _t(kp), _t(vp), _t(table),
            _t(lengths.astype(np.int32)), _t(row_slot.astype(np.int32)))


@pytest.mark.parametrize("layout", ["decode", "edge"])
@pytest.mark.parametrize("H,Hkv,D,ps,maxp", [
    (4, 4, 8, 4, 24), (4, 2, 8, 8, 12), (8, 2, 16, 16, 6), (8, 1, 8, 4, 24),
    (6, 2, 8, 5, 20)], ids=["rep1", "rep2", "rep4", "rep8", "rep3-ps5"])
def test_kernel_model_matches_the_plain_version(layout, H, Hkv, D, ps, maxp):
    """The kernel's split and merge (modelled in float64) give the plain
    version's output: a prompt chunk beside another slot's chunk, padding
    and length-1 rows, a row longer than a split while other splits hold
    no live token."""
    args = _layout_case(11, 5, H, Hkv, D, ps, maxp, layout)
    q, kp, vp, table, lengths, row_slot = args
    R = q.shape[0]
    splits, spl = pa.split_plan(R, table.shape[0], maxp, ps)
    spl = min(spl, 32)                    # small shapes: split at 32 tokens
    splits = -(-maxp * ps // spl)
    got = _kernel_model(q, kp, vp, table, lengths, row_slot, D ** -0.5,
                        splits, spl)
    if layout == "edge":
        assert splits > 1 and int(lengths.max()) > spl
        assert int(lengths.min()) <= spl          # splits with no live token
    want = pa.paged_attention_plain(q, kp, vp, table, lengths,
                                    row_slot=row_slot)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), **TOL)
