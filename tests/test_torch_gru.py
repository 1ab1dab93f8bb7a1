"""PyTorch port: the GRU op against the JAX package on the CPU.

The same numpy inputs (seeded) go through `paddle_tpu.ops.rnn.gru_scan`
(the lax.scan route), `pallas_rnn.gru_fused` (the Pallas kernels in
interpret mode, as tests/test_pallas_rnn.py runs them) and the port's
`gru_scan` / `gru_fused`, which on CPU tensors run the kernels' plain
version.  Outputs within rtol/atol 1e-5, gradients 1e-4 (float32, sums in
another order).  The backward kernels' data flow, transcribed to PyTorch
beside the plain version (from the forward's saved gates, the products'
partial sums per column slice added in slice order), is held against
autograd of the plain version and the Pallas kernels, so the formulas the
CUDA source copies are checked where there is no card; so are the launch
plan's invariants on the H100's limits.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_rnn
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu_torch.ops import gru_fused as gf
from paddle_tpu_torch.ops import rnn as trnn

B, T, D = 4, 6, 8
CASES = list(itertools.product([False, True], [False, True],
                               ["tanh", "relu"]))
IDS = [f"{'rev' if r else 'fwd'}-{'ragged' if g else 'full'}-{a}"
       for r, g, a in CASES]


def _case(seed, ragged, B=B, T=T, D=D):
    """x3, w [D, 3D] (the layer's one parameter), bias [3D], lengths (one
    row of length 0 and one full row when ragged), a non-zero h0, and
    cotangents for (hs, h_last) — numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = {"x3": rng.standard_normal((B, T, 3 * D)).astype(f32),
         "w": (rng.standard_normal((D, 3 * D)) * 0.4).astype(f32),
         "bias": (rng.standard_normal(3 * D) * 0.2).astype(f32),
         "h0": (rng.standard_normal((B, D)) * 0.5).astype(f32),
         "g_hs": rng.standard_normal((B, T, D)).astype(f32),
         "g_hl": rng.standard_normal((B, D)).astype(f32)}
    lengths = np.full(B, T, np.int32)
    if ragged:
        lengths = rng.integers(1, T + 1, B).astype(np.int32)
        lengths[0], lengths[-1] = 0, T
    c["lengths"] = lengths
    return c


def _weighted(out, c, xp):
    hs, hl = out
    return (hs * xp.asarray(c["g_hs"])).sum() + (hl * xp.asarray(c["g_hl"])
                                                 ).sum()


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _split(w):
    d = w.shape[0]
    return w[:, :2 * d], w[:, 2 * d:]


@pytest.mark.parametrize("reverse,ragged,act", CASES, ids=IDS)
def test_gru_scan_matches_the_jax_scan(reverse, ragged, act):
    """The port's gru_scan (bias, h0, reverse, freeze; the weight slices of
    one [D, 3D] parameter) against paddle_tpu.ops.rnn.gru_scan: outputs
    1e-5, the gradients with respect to x3, w, the bias and h0 1e-4."""
    c = _case(1, ragged)
    names = ("x3", "w", "bias", "h0")
    kw = dict(active_type=act, reverse=reverse)

    def jloss(x3, w, bias, h0):
        out = jrnn.gru_scan(x3, jnp.asarray(c["lengths"]), *_split(w), bias,
                            h0, **kw)
        return _weighted(out, c, jnp), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(c[n]) for n in names))
    x3, w, bias, h0 = (torch.from_numpy(c[n]).requires_grad_(True)
                       for n in names)
    gf.counts.reset()
    out = trnn.gru_scan(x3, torch.from_numpy(c["lengths"]), *_split(w), bias,
                        h0, **kw)
    assert (gf.counts.plain, gf.counts.fwd) == (1, 0)     # the CPU route
    _weighted(out, c, torch).backward()
    for name, got, want in zip(("hs", "h_last"), out, jout):
        _close(got.detach(), want, 1e-5, name)
    for name, t, want in zip(names, (x3, w, bias, h0), jgrads):
        _close(t.grad, want, 1e-4, f"d{name}")


@pytest.mark.parametrize("reverse,ragged,act", CASES, ids=IDS)
def test_gru_fused_matches_the_pallas_kernel(reverse, ragged, act):
    """The port's gru_fused against pallas_rnn.gru_fused run in interpret
    mode (forward and backward Pallas kernels): outputs 1e-5, dx3, dw_gate,
    dw_cand, dh0 1e-4."""
    c = _case(2, ragged)
    wg, wc = (np.ascontiguousarray(a) for a in _split(c["w"]))
    kw = dict(active_type=act, gate_active_type="sigmoid", reverse=reverse)
    args = (c["x3"], wg, wc, c["h0"])

    def jloss(x3, wg, wc, h0):
        out = pallas_rnn.gru_fused(x3, jnp.asarray(c["lengths"]), wg, wc, h0,
                                   **kw)
        return _weighted(out, c, jnp), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    x3, w_gate, w_cand, h0 = leaves
    out = gf.gru_fused(x3, torch.from_numpy(c["lengths"]), w_gate, w_cand,
                       h0, **kw)
    _weighted(out, c, torch).backward()
    for name, got, want in zip(("hs", "h_last"), out, jout):
        _close(got.detach(), want, 1e-5, name)
    for name, t, want in zip(("dx3", "dw_gate", "dw_cand", "dh0"), leaves,
                             jgrads):
        _close(t.grad, want, 1e-4, name)


SHAPES = [(4, 6, 8), (3, 1, 8), (5, 7, 32)]
BWD_CASES = list(itertools.product([False, True], [False, True],
                                   ["tanh", "relu", "sigmoid", "linear"]))


@pytest.mark.parametrize("shape", SHAPES, ids=["B4T6D8", "T1", "B5T7D32"])
@pytest.mark.parametrize("reverse,ragged,act", BWD_CASES,
                         ids=[f"{'rev' if r else 'fwd'}-"
                              f"{'ragged' if g else 'full'}-{a}"
                              for r, g, a in BWD_CASES])
def test_backward_transcription_matches_autograd(reverse, ragged, act,
                                                 shape):
    """gru_fused_bwd_plain — the backward kernel's step (recompute u, r, c
    from the stored h, the freeze rules, the cotangent of every step's h) —
    against autograd of gru_fused_plain: 1e-5 of each gradient's scale."""
    Bx, Tx, Dx = shape
    c = _case(3, ragged, Bx, Tx, Dx)
    lens = torch.from_numpy(c["lengths"])
    kw = dict(active_type=act, gate_active_type="sigmoid", reverse=reverse)
    x3, w, h0 = (torch.from_numpy(c[n]).requires_grad_(True)
                 for n in ("x3", "w", "h0"))
    wg, wc = _split(w)
    out = gf.gru_fused_plain(x3, lens, wg, wc, h0, **kw)
    want = torch.autograd.grad(_weighted(out, c, torch), (x3, wg, wc, h0))
    with torch.no_grad():
        got = gf.gru_fused_bwd_plain(
            x3, lens, wg, wc, h0, out[0],
            *(torch.from_numpy(c[n]) for n in ("g_hs", "g_hl")), **kw)
    for name, g, wnt in zip(("dx3", "dw_gate", "dw_cand", "dh0"), got,
                            want):
        scale = max(float(wnt.abs().max()), 1.0)
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_frozen_rows_keep_their_state_and_length_zero_returns_h0():
    """hs repeats the frozen state over the padding; a length-0 row returns
    h0 in either direction."""
    c = _case(4, True)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    for reverse in (False, True):
        hs, hl = trnn.gru_scan(t["x3"], t["lengths"], *_split(t["w"]),
                               t["bias"], t["h0"], reverse=reverse)
        np.testing.assert_array_equal(hl[0].numpy(), c["h0"][0])
        assert torch.equal(hs[0], t["h0"][0].expand(T, D))
        n = int(c["lengths"][1])
        if not reverse and n < T:
            assert torch.equal(hs[1, n:], hs[1, n - 1].expand(T - n, D))


def test_gru_scan_rejects_bad_arguments_and_casts_back():
    c = _case(5, False)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    wg, wc = _split(t["w"])
    with pytest.raises(ValueError, match="impl"):
        trnn.gru_scan(t["x3"], t["lengths"], wg, wc, None, impl="scan")
    with pytest.raises(ValueError, match="w_cand"):
        trnn.gru_scan(t["x3"], t["lengths"], wg, wc[:, :-1], None)
    hs, hl = trnn.gru_scan(t["x3"].bfloat16(), t["lengths"], wg.bfloat16(),
                           wc.bfloat16(), None, impl="plain")
    assert hs.dtype == hl.dtype == torch.bfloat16
    want, _ = trnn.gru_scan(t["x3"].bfloat16().float(), t["lengths"],
                            wg.bfloat16().float(), wc.bfloat16().float(),
                            None)
    assert torch.equal(hs, want.bfloat16())       # float32 inside


def test_the_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel: gru_fused runs the plain
    version, and the launch wrappers refuse it instead of falling back."""
    c = _case(6, False)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    wg, wc = _split(t["w"])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        gf.gru_fwd_kernel(t["x3"], t["lengths"], wg, wc, t["h0"],
                          ("tanh", "sigmoid"), False)
    assert gf.kernel.built is None


def test_launch_geometry():
    """The weight-gradient product's splits put ~4 of its 64-thread CTAs on
    each of the H100's 132 SMs without empty splits (its tiles are 64 x 64
    over [D, 3D])."""
    assert gf.dw_splits(64, 30, 512, H100_SMS) == 3
    assert gf.dw_splits(5, 7, 32, H100_SMS) == 1
    assert gf.dw_splits(64, 30, 64, H100_SMS) == 30
    for B_, T_, D_ in ((64, 30, 512), (5, 7, 32), (64, 3, 64), (1, 1, 96)):
        s = gf.dw_splits(B_, T_, D_, H100_SMS)
        n = B_ * T_
        assert 1 <= s <= n and -(-n // s) * (s - 1) < n


H100_SMS, H100_SMEM = 132, 232448


def _assert_plan_invariants(p, Bx, D):
    """One launch of Bx rows: every batch row in exactly one group, every
    hidden unit owned once in a group, slices on 16-byte boundaries, at
    most one CTA per SM, and both walk kernels' shared memory (recomputed
    here) within the limit."""
    owner = np.full(Bx, -1)
    for g in range(p.groups):
        rows = np.arange(g * p.rows, min(Bx, (g + 1) * p.rows))
        assert rows.size >= 1                       # no group is empty
        assert (owner[rows] == -1).all()
        owner[rows] = g
    assert (owner >= 0).all()
    units = np.zeros(D, int)
    for c in range(p.ctas):
        assert (c * p.units * 4) % 16 == 0           # slice start, bytes
        units[c * p.units:(c + 1) * p.units] += 1
    assert (units == 1).all() and p.ctas * p.units == D
    assert p.units % 4 == 0 and p.grid <= H100_SMS
    assert p.rows_pad % 8 == 0 and p.rows <= p.rows_pad < p.rows + 8
    assert p.chunk % 4 == 0 and p.rows_pad % p.chunk == 0
    U, Rp, C = p.units, p.rows_pad, p.chunk
    assert (C // 4) * (2 * U // 4) <= gf.WALK_THREADS    # one tile a thread
    # weights, state chunk (the partial sums after it), h and u, two
    # steps' x3
    fwd = 4 * (3 * U * D + max(C * (D + 4), 16 * gf.WALK_THREADS)
               + 2 * Rp * U + 2 * Rp * 3 * U) + 4 * Rp
    # weights, dz, six state arrays, two steps' g_hs, u, r, c, h_prev
    bwd = 4 * (3 * U * D + 3 * U * Rp + 6 * Rp * U + 2 * Rp * 5 * U) + 4 * Rp
    assert (p.smem_fwd, p.smem_bwd) == (fwd, bwd)
    assert max(fwd, bwd) <= H100_SMEM
    assert p.exch_bytes == 4 * p.groups * Rp * D
    assert p.scratch_bytes == 4 * p.grid * Rp * D


@pytest.mark.parametrize("D", [32, 96, 256, 512])
@pytest.mark.parametrize("Bx", [1, 5, 64, 256, 1024, 4096])
def test_launch_plan_invariants(Bx, D):
    """gru_launches on the H100 (132 SMs, 232,448 bytes a block): the
    slices cover the batch once, in order, all of one size but the last,
    and each launch's plan keeps the invariants; so does gru_plan's single
    launch wherever one takes the whole batch."""
    launches = gf.gru_launches(Bx, D, H100_SMS, H100_SMEM)
    size = launches[0][1]
    assert [b0 for b0, _, _ in launches] == list(range(0, Bx, size))
    assert all(n == min(size, Bx - b0) for b0, n, _ in launches)
    for _, n, p in launches:
        _assert_plan_invariants(p, n, D)
    try:
        p = gf.gru_plan(Bx, D, H100_SMS, H100_SMEM)
    except ValueError:
        assert len(launches) > 1
    else:
        _assert_plan_invariants(p, Bx, D)


def test_launch_plan_slices_a_batch_no_launch_takes():
    """At hidden 512 a group's rows must fit one CTA's shared memory beside
    its weights, so no single launch takes 1,024 rows: gru_launches walks
    them in equal slices that each fit; a batch one launch takes stays one
    launch of gru_plan's pick; a pinned plan is cut the same way."""
    with pytest.raises(ValueError, match="no split"):
        gf.gru_plan(1024, 512, H100_SMS, H100_SMEM)
    launches = gf.gru_launches(1024, 512, H100_SMS, H100_SMEM)
    assert len(launches) > 1
    assert sum(n for _, n, _ in launches) == 1024
    for Bx, D in ((64, 512), (1024, 256)):      # one launch where one fits
        assert gf.gru_launches(Bx, D, H100_SMS, H100_SMEM) == (
            (0, Bx, gf.gru_plan(Bx, D, H100_SMS, H100_SMEM)),)
    # a pinned plan walks the batch in slices of as many rows as it takes
    alt = gf.gru_plan(342, 512, H100_SMS, H100_SMEM, units=16)
    pinned = gf._slices(1024, 512, alt, H100_SMS, H100_SMEM)
    assert [(b0, n) for b0, n, _ in pinned] == [(0, 344), (344, 344),
                                                (688, 336)]
    assert pinned[0][2] == pinned[1][2] == alt
    assert pinned[2][2].units == 16
    _assert_plan_invariants(pinned[2][2], 336, 512)


def test_launch_model_ranks_the_timed_plans_as_they_ran():
    """The cost model behind gru_plan orders the four plans timed at the
    seq2seq shape [64, 30, 512] as they ran on the H100 (PERF.md §6: (8,
    32) fastest, then (16, 16), (32, 8), (64, 4)), and picks the first."""
    timed = [(8, 32), (16, 16), (32, 8), (64, 4)]
    cycles = [gf._step_cycles(512, 512 // u, u, -(-r // 8) * 8)
              for r, u in timed]
    assert cycles == sorted(cycles)
    p = gf.gru_plan(64, 512, H100_SMS, H100_SMEM)
    assert (p.rows, p.units) == timed[0]


SAVED_CASES = [(r, g, a, n) for r, g, a in CASES for n in (1, 2)]


@pytest.mark.parametrize("reverse,ragged,act,slices", SAVED_CASES,
                         ids=[f"{i}-{n}slices" for i, (_, _, _, n) in zip(
                             [x for x in IDS for _ in (1, 2)], SAVED_CASES)])
def test_saved_gates_backward_matches_autograd_and_pallas(reverse, ragged,
                                                          act, slices):
    """The kernels' data flow: gru_fwd_gates_plain's hs and gates (u, r, c)
    saved by the forward, then gru_fused_bwd_plain from those gates with
    the products' partial sums taken per column slice and added in slice
    order — against autograd of gru_fused_plain and against the Pallas
    kernels in interpret mode: 1e-5 of each tensor's scale."""
    c = _case(7, ragged)
    lens = torch.from_numpy(c["lengths"])
    kw = dict(active_type=act, gate_active_type="sigmoid", reverse=reverse)
    x3, w, h0 = (torch.from_numpy(c[n]).requires_grad_(True)
                 for n in ("x3", "w", "h0"))
    wg, wc = _split(w)
    out = gf.gru_fused_plain(x3, lens, wg, wc, h0, **kw)
    want = torch.autograd.grad(_weighted(out, c, torch), (x3, wg, wc, h0))
    with torch.no_grad():
        hs, gates = gf.gru_fwd_gates_plain(x3, lens, wg, wc, h0, **kw)
        assert torch.equal(hs, out[0])
        got = gf.gru_fused_bwd_plain(
            x3, lens, wg, wc, h0, hs,
            *(torch.from_numpy(c[n]) for n in ("g_hs", "g_hl")),
            gates=gates, slices=slices, **kw)

    wg_np, wc_np = (np.ascontiguousarray(a) for a in _split(c["w"]))

    def jloss(x3, wg, wc, h0):
        o = pallas_rnn.gru_fused(x3, jnp.asarray(c["lengths"]), wg, wc, h0,
                                 **kw)
        return _weighted(o, c, jnp)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (c["x3"], wg_np, wc_np, c["h0"])))
    for name, g, a, j in zip(("dx3", "dw_gate", "dw_cand", "dh0"), got,
                             want, jgrads):
        scale = max(float(a.abs().max()), 1.0)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5 * scale, err_msg=f"{name} pallas")
