"""PyTorch port: the LSTM op against the JAX package on the CPU.

The same numpy inputs (seeded) go through `paddle_tpu.ops.rnn.lstm_scan`
(the lax.scan route), `pallas_rnn.lstm_fused` (the Pallas kernel in
interpret mode, as tests/test_pallas_rnn.py runs it) and the port's
`lstm_scan` / `lstm_fused`, which on CPU tensors run the kernels' plain
version.  Outputs within rtol/atol 1e-5, gradients 1e-4 (float32, sums in
another order).  The backward kernel's arithmetic, transcribed to PyTorch
beside the plain version, is held against autograd of the plain version, so
the formulas the CUDA source copies are checked where there is no card.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_rnn
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu_torch.ops import lstm_fused as lf
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops.activations import (ACT_GRAD_FROM_OUTPUT,
                                              activation_registry)

B, T, D = 4, 6, 8
CASES = list(itertools.product([False, True], [False, True], [False, True],
                               ["tanh", "relu"]))
IDS = [f"{'rev' if r else 'fwd'}-{'peep' if p else 'nopeep'}-"
       f"{'ragged' if g else 'full'}-{a}" for r, p, g, a in CASES]


def _case(seed, peep, ragged, B=B, T=T, D=D):
    """x4, w, bias ([7D] with peepholes, else [4D]), lengths (one row of
    length 0 and one full row when ragged), non-zero h0/c0, and cotangents
    for (hs, h_last, c_last) — numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = {"x4": rng.standard_normal((B, T, 4 * D)).astype(f32),
         "w": (rng.standard_normal((D, 4 * D)) * 0.3).astype(f32),
         "bias": (rng.standard_normal((7 if peep else 4) * D) * 0.2
                  ).astype(f32),
         "h0": (rng.standard_normal((B, D)) * 0.5).astype(f32),
         "c0": (rng.standard_normal((B, D)) * 0.5).astype(f32),
         "g_hs": rng.standard_normal((B, T, D)).astype(f32),
         "g_hl": rng.standard_normal((B, D)).astype(f32),
         "g_cl": rng.standard_normal((B, D)).astype(f32)}
    lengths = np.full(B, T, np.int32)
    if ragged:
        lengths = rng.integers(1, T + 1, B).astype(np.int32)
        lengths[0], lengths[-1] = 0, T
    c["lengths"] = lengths
    return c


def _peeps(c):
    d = c["w"].shape[0]
    bias = c["bias"]
    return (bias[4 * d:].reshape(3, d) if bias.shape[0] == 7 * d
            else np.zeros((3, d), np.float32))


def _weighted(out, c, xp):
    hs, hl, cl = out
    return ((hs * xp.asarray(c["g_hs"])).sum()
            + (hl * xp.asarray(c["g_hl"])).sum()
            + (cl * xp.asarray(c["g_cl"])).sum())


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("reverse,peep,ragged,act", CASES, ids=IDS)
def test_lstm_scan_matches_the_jax_scan(reverse, peep, ragged, act):
    """The port's lstm_scan (bias split, peepholes, h0/c0, reverse, freeze)
    against paddle_tpu.ops.rnn.lstm_scan: outputs 1e-5, the gradients with
    respect to x4, w, the bias (its peephole part is dpeep), h0 and c0
    1e-4."""
    c = _case(1, peep, ragged)
    names = ("x4", "w", "bias", "h0", "c0")
    kw = dict(active_type=act, reverse=reverse)

    def jloss(*a):
        x4, w, bias, h0, c0 = a
        out = jrnn.lstm_scan(x4, jnp.asarray(c["lengths"]), w, bias, h0, c0,
                             **kw)
        return _weighted(out, c, jnp), out

    jargs = [jnp.asarray(c[n]) for n in names]
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                           has_aux=True)(*jargs)
    targs = [torch.from_numpy(c[n]).requires_grad_(True) for n in names]
    lf.counts.reset()
    out = trnn.lstm_scan(targs[0], torch.from_numpy(c["lengths"]),
                         *targs[1:], **kw)
    assert (lf.counts.plain, lf.counts.fwd) == (1, 0)     # the CPU route
    _weighted(out, c, torch).backward()
    for name, got, want in zip(("hs", "h_last", "c_last"), out, jout):
        _close(got.detach(), want, 1e-5, name)
    for name, t, want in zip(names, targs, jgrads):
        _close(t.grad, want, 1e-4, f"d{name}")


@pytest.mark.parametrize("reverse,peep,ragged,act", CASES, ids=IDS)
def test_lstm_fused_matches_the_pallas_kernel(reverse, peep, ragged, act):
    """The port's lstm_fused against pallas_rnn.lstm_fused run in interpret
    mode (forward and backward Pallas kernels): outputs 1e-5, dx4, dw,
    dpeeps, dh0, dc0 1e-4."""
    c = _case(2, peep, ragged)
    c["peeps"] = _peeps(c)
    names = ("x4", "w", "peeps", "h0", "c0")
    kw = dict(active_type=act, gate_active_type="sigmoid",
              state_active_type="tanh", reverse=reverse)

    def jloss(*a):
        x4, w, peeps, h0, c0 = a
        out = pallas_rnn.lstm_fused(x4, jnp.asarray(c["lengths"]), w, peeps,
                                    h0, c0, **kw)
        return _weighted(out, c, jnp), out

    jargs = [jnp.asarray(c[n]) for n in names]
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                           has_aux=True)(*jargs)
    x4, w, peeps, h0, c0 = (torch.from_numpy(c[n]).requires_grad_(True)
                            for n in names)
    out = lf.lstm_fused(x4, torch.from_numpy(c["lengths"]), w, peeps, h0, c0,
                        **kw)
    _weighted(out, c, torch).backward()
    for name, got, want in zip(("hs", "h_last", "c_last"), out, jout):
        _close(got.detach(), want, 1e-5, name)
    for name, t, want in zip(names, (x4, w, peeps, h0, c0), jgrads):
        _close(t.grad, want, 1e-4, f"d{name}")


SHAPES = [(4, 6, 8), (3, 1, 8), (5, 7, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=["B4T6D8", "T1", "B5T7D32"])
@pytest.mark.parametrize("reverse,peep,ragged,act", CASES, ids=IDS)
def test_backward_transcription_matches_autograd(reverse, peep, ragged, act,
                                                 shape):
    """lstm_fused_bwd_plain — the backward kernel's step (recompute the
    gates from the stored h and c, the freeze rules, the cotangent of every
    step's h) — against autograd of lstm_fused_plain: 1e-5 of each
    gradient's scale."""
    Bx, Tx, Dx = shape
    c = _case(3, peep, ragged, Bx, Tx, Dx)
    lens = torch.from_numpy(c["lengths"])
    kw = dict(active_type=act, gate_active_type="sigmoid",
              state_active_type="tanh", reverse=reverse)
    x4, w, peeps, h0, c0 = (torch.from_numpy(a).requires_grad_(True)
                            for a in (c["x4"], c["w"], _peeps(c), c["h0"],
                                      c["c0"]))
    out = lf.lstm_fused_plain(x4, lens, w, peeps, h0, c0, **kw)
    want = torch.autograd.grad(_weighted(out, c, torch),
                               (x4, w, peeps, h0, c0))
    with torch.no_grad():
        hs, cs = lf._plain_steps(x4, lens, w, peeps, h0, c0,
                                 (act, "sigmoid", "tanh"), reverse)
        got = lf.lstm_fused_bwd_plain(
            x4, lens, w, peeps, h0, c0, hs, cs,
            *(torch.from_numpy(c[n]) for n in ("g_hs", "g_hl", "g_cl")),
            **kw)
    assert torch.equal(hs, out[0])
    for name, g, wnt in zip(("dx4", "dw", "dpeeps", "dh0", "dc0"), got, want):
        scale = max(float(wnt.abs().max()), 1.0)
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "relu", "linear", ""])
def test_activation_and_its_derivative_from_the_output(name):
    """Each activation the kernels take equals the JAX package's, and its
    derivative written from the output equals autograd's and
    pallas_rnn._ACTS'."""
    x = np.linspace(-3, 3, 25).astype(np.float32)
    x = x[np.abs(x) > 1e-3]                       # relu's kink
    jf, jd = pallas_rnn._ACTS[name]
    t = torch.from_numpy(x).requires_grad_(True)
    y = activation_registry[name](t)
    _close(y.detach(), jf(jnp.asarray(x)), 1e-6, "value")
    (auto,) = torch.autograd.grad(y.sum(), t)
    got = ACT_GRAD_FROM_OUTPUT[name](y.detach())
    _close(got, auto, 1e-6, "derivative vs autograd")
    _close(got, jd(jf(jnp.asarray(x))), 1e-6, "derivative vs _ACTS")
    assert name in lf.ACT_CODES


def test_frozen_rows_keep_their_state_and_length_zero_returns_h0():
    """hs repeats the frozen state over the padding; a length-0 row returns
    (h0, c0) in either direction."""
    c = _case(4, True, True)
    for reverse in (False, True):
        hs, hl, cl = trnn.lstm_scan(
            *(torch.from_numpy(c[n]) for n in ("x4", "lengths", "w", "bias",
                                                "h0", "c0")),
            reverse=reverse)
        np.testing.assert_array_equal(hl[0].numpy(), c["h0"][0])
        np.testing.assert_array_equal(cl[0].numpy(), c["c0"][0])
        assert torch.equal(hs[0], torch.from_numpy(c["h0"][0]).expand(T, D))
        n = int(c["lengths"][1])
        if not reverse and n < T:
            assert torch.equal(hs[1, n:], hs[1, n - 1].expand(T - n, D))


def test_lstm_scan_rejects_bad_arguments_and_casts_back():
    c = _case(5, False, False)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    with pytest.raises(ValueError, match="impl"):
        trnn.lstm_scan(t["x4"], t["lengths"], t["w"], None, impl="scan")
    with pytest.raises(ValueError, match="bias"):
        trnn.lstm_scan(t["x4"], t["lengths"], t["w"], torch.zeros(5 * D))
    with pytest.raises(ValueError, match="w "):
        trnn.lstm_scan(t["x4"], t["lengths"], t["w"][:, :-4], None)
    hs, hl, _ = trnn.lstm_scan(t["x4"].bfloat16(), t["lengths"],
                               t["w"].bfloat16(), None, impl="plain")
    assert hs.dtype == hl.dtype == torch.bfloat16
    want, _, _ = trnn.lstm_scan(t["x4"].bfloat16().float(), t["lengths"],
                                t["w"].bfloat16().float(), None)
    assert torch.equal(hs, want.bfloat16())       # float32 inside


@pytest.mark.parametrize("D,acts,refused", [
    (128, ("relu", "sigmoid", "tanh"), None),
    (32, ("tanh", "sigmoid", "tanh"), None),
    (512, ("linear", "sigmoid", "relu"), None),
    (8, ("tanh", "sigmoid", "tanh"), "hidden size 8"),
    (544, ("tanh", "sigmoid", "tanh"), "hidden size 544"),
    (100, ("tanh", "sigmoid", "tanh"), "hidden size 100"),
    (128, ("softmax", "sigmoid", "tanh"), "softmax"),
], ids=["D128", "D32", "D512", "D8", "D544", "D100", "softmax"])
def test_what_the_kernels_take(D, acts, refused):
    """kernel_takes: multiples of 32 from 32 to 512 and the four kernel
    activations; a CPU tensor is never asked (it runs the plain version)."""
    got = lf.kernel_takes(D, *acts)
    assert (got is None) if refused is None else (refused in got)


H100_SMS, H100_SMEM = 132, 232448


def test_launch_geometry():
    """The weight-gradient product's splits put ~4 of its 64-thread CTAs on
    each of the H100's 132 SMs without empty splits (its tiles are 64 x 64
    over [D, 4D])."""
    assert lf.dw_splits(128, 100, 128, H100_SMS) == 33
    assert lf.dw_splits(5, 7, 32, H100_SMS) == 1
    assert lf.dw_splits(128, 100, 512, H100_SMS) == 3
    for B_, T_, D_ in ((128, 100, 128), (5, 7, 32), (64, 3, 64), (1, 1, 96),
                       (1000, 12, 512)):
        s = lf.dw_splits(B_, T_, D_, H100_SMS)
        n = B_ * T_
        assert 1 <= s <= n and -(-n // s) * (s - 1) < n


def _assert_plan_invariants(p, Bx, D):
    """Every batch row in exactly one group, every hidden unit owned once
    in a cluster of at most 16 CTAs (C U = D, slices on 16-byte
    boundaries), resident rows in whole k-quads, and both walk kernels'
    shared memory (recomputed here) within the limit."""
    owner = np.full(Bx, -1)
    for g in range(p.clusters):
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
    assert p.ctas in (1, 2, 4, 8, 16) and p.units % 4 == 0
    assert p.rows_pad % 4 == 0 and p.rows <= p.rows_pad < p.rows + 4
    assert 0 <= p.res_fwd <= D and p.res_fwd % 4 == 0
    assert 0 <= p.res_bwd <= 4 * p.units and p.res_bwd % 4 == 0
    U, Rp = p.units, p.rows_pad
    assert Rp * U <= 256                       # one (row, unit) a thread
    # the k-quads of W a lane keeps in registers: KQ / KS when that is 2 or
    # 4 with one tile (4 rows x 8 columns) a lane, KS the lanes a tile (a
    # power of two, at most 16, tiles x KS within the 256 threads)
    def ks(tiles):
        k = 1
        while 2 * k <= 16 and tiles * 2 * k <= 256:
            k *= 2
        return k

    def quads(KQ, tiles):
        nm = KQ // ks(tiles)
        return nm if tiles <= 256 and KQ % ks(tiles) == 0 and nm in (
            2, 4) else 0

    assert ks(Rp // 4 * U // 2) >= 8           # a (row, unit) a lane
    reg_f = quads(D // 4, Rp // 4 * U // 2)
    reg_b = quads(U, Rp // 4 * D // 8)
    assert lf.fwd_quads(D, U, Rp) == reg_f
    assert lf.bwd_quads(D, U, Rp) == reg_b
    if reg_f:
        assert p.res_fwd == D
    if reg_b:
        assert p.res_bwd == 4 * U
    # W slice rows (columns interleaved by unit, padded) unless in
    # registers, h [2][Rp][D + 4]; then the lengths
    fwd = 4 * ((0 if reg_f else p.res_fwd * (4 * U + 4))
               + 2 * Rp * (D + 4)) + 4 * Rp
    # W^T slice rows (padded) unless in registers, partial dh [2][Rp][D],
    # dx4 [Rp][4U + 4]
    bwd = 4 * ((0 if reg_b else p.res_bwd * (D + 4)) + 2 * Rp * D
               + Rp * (4 * U + 4)) + 4 * Rp
    assert (p.smem_fwd, p.smem_bwd) == (fwd, bwd)
    assert max(fwd, bwd) <= H100_SMEM
    # as many rows of the slices resident as fit: one more k-quad does not
    if p.res_fwd < D:
        assert fwd + 4 * 4 * (4 * U + 4) > H100_SMEM
    if p.res_bwd < 4 * U:
        assert bwd + 4 * 4 * (D + 4) > H100_SMEM


@pytest.mark.parametrize("D", [32, 128, 256, 512])
@pytest.mark.parametrize("Bx", [1, 5, 128, 133, 1000])
def test_launch_plan_invariants(Bx, D):
    """lstm_plans on the H100 (132 SMs, 232,448 bytes a block): every plan
    keeps the invariants, the fastest by the model comes first and is
    lstm_plan's pick; where the whole W slice fits it stays resident."""
    plans = lf.lstm_plans(Bx, D, H100_SMS, H100_SMEM)
    assert plans
    for p in plans:
        _assert_plan_invariants(p, Bx, D)
    assert lf.lstm_plan(Bx, D, H100_SMS, H100_SMEM) == plans[0]
    if D <= 256:     # a cluster of 16 holds W up to about D = 448
        assert any(p.res_fwd == D and p.res_bwd == 4 * p.units
                   for p in plans)


def test_launch_plan_refuses_a_card_too_small():
    """Where no split fits a block's shared memory, lstm_plan raises."""
    with pytest.raises(ValueError, match="no split"):
        lf.lstm_plan(128, 512, H100_SMS, 4000)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel: lstm_fused runs the plain
    version, and the launch wrappers refuse it instead of falling back."""
    c = _case(6, True, True)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lf.lstm_fwd_kernel(t["x4"], t["lengths"], t["w"],
                           torch.from_numpy(_peeps(c)), t["h0"], t["c0"],
                           ("tanh", "sigmoid", "tanh"), False)
    assert lf.kernel.built is None


SAVED_CASES = [(r, p, g, a, n) for r, p, g, a in CASES for n in (1, 2)]


@functools.lru_cache(maxsize=None)
def _pallas_grads(reverse, peep, ragged, act):
    """The Pallas kernels' gradients (interpret mode) of case 8."""
    c = _case(8, peep, ragged)
    kw = dict(active_type=act, gate_active_type="sigmoid",
              state_active_type="tanh", reverse=reverse)

    def jloss(x4, w, peeps, h0, c0):
        out = pallas_rnn.lstm_fused(x4, jnp.asarray(c["lengths"]), w, peeps,
                                    h0, c0, **kw)
        return _weighted(out, c, jnp)

    grads = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in (c["x4"], c["w"], _peeps(c), c["h0"],
                                   c["c0"])))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("reverse,peep,ragged,act,slices", SAVED_CASES,
                         ids=[f"{i}-{n}slices" for i, (*_, n) in zip(
                             [x for x in IDS for _ in (1, 2)], SAVED_CASES)])
def test_saved_gates_backward_matches_autograd_and_pallas(
        reverse, peep, ragged, act, slices):
    """The kernels' data flow: lstm_fwd_gates_plain's hs, cs and gates (a,
    i, f, o) saved by the forward, then lstm_fused_bwd_plain from those
    gates with dx4 W^T taken per slice of the hidden units (all four gate
    columns of a slice, as one CTA of a cluster owns them) and added in
    slice order — against autograd of lstm_fused_plain and against the
    Pallas kernels in interpret mode: 1e-5 of each gradient's scale."""
    c = _case(8, peep, ragged)
    lens = torch.from_numpy(c["lengths"])
    kw = dict(active_type=act, gate_active_type="sigmoid",
              state_active_type="tanh", reverse=reverse)
    x4, w, peeps, h0, c0 = (torch.from_numpy(a).requires_grad_(True)
                            for a in (c["x4"], c["w"], _peeps(c), c["h0"],
                                      c["c0"]))
    out = lf.lstm_fused_plain(x4, lens, w, peeps, h0, c0, **kw)
    want = torch.autograd.grad(_weighted(out, c, torch),
                               (x4, w, peeps, h0, c0))
    with torch.no_grad():
        hs, cs, gates = lf.lstm_fwd_gates_plain(x4, lens, w, peeps, h0, c0,
                                                **kw)
        assert torch.equal(hs, out[0])
        got = lf.lstm_fused_bwd_plain(
            x4, lens, w, peeps, h0, c0, hs, cs,
            *(torch.from_numpy(c[n]) for n in ("g_hs", "g_hl", "g_cl")),
            gates=gates, slices=slices, **kw)
    jgrads = _pallas_grads(reverse, peep, ragged, act)
    for name, g, a, j in zip(("dx4", "dw", "dpeeps", "dh0", "dc0"), got,
                             want, jgrads):
        scale = max(float(a.abs().max()), 1.0)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{name} pallas")
