"""PyTorch port: the additive-attention step against the JAX package on the
CPU.

The same numpy inputs (seeded, unaligned sizes as tests/
test_additive_attention.py uses) go through the JAX package's dense formula
(`paddle_tpu.ops.attention.additive_attention_step`), its Pallas route
(`pallas_additive.additive_attention_step` with lengths, the kernel in
interpret mode) and the port's dense formula and autograd function, whose
forward on CPU tensors is the kernel's plain version.  Forward within
1e-5, the gradients of all five inputs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.ops import additive_attention as aa
from paddle_tpu_torch.ops import attention as tattn

NAMES = ("dec", "w", "v", "proj", "seq")


def _case(seed, lengths, B=5, T=7, Ds=11, D=19, Dv=13):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = {"dec": rng.standard_normal((B, Ds)).astype(f32),
         "w": (rng.standard_normal((Ds, D)) * 0.3).astype(f32),
         "v": rng.standard_normal(D).astype(f32),
         "proj": rng.standard_normal((B, T, D)).astype(f32),
         "seq": rng.standard_normal((B, T, Dv)).astype(f32),
         "g": rng.standard_normal((B, Dv)).astype(f32),
         "lengths": np.asarray(lengths, np.int32)}
    return c


def _mask(c):
    T = c["proj"].shape[1]
    return np.arange(T)[None, :] < c["lengths"][:, None]


def _jax_route(c, fn):
    """(out, grads of the five inputs) of fn(dec, w, v, proj, seq) under
    the cotangent g."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(c[n]) for n in NAMES))
    return out, vjp(jnp.asarray(c["g"]))


def _port_route(c, fn):
    leaves = [torch.from_numpy(c[n]).requires_grad_(True) for n in NAMES]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(c["g"]))
    return out.detach(), grads


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("lengths", [[7, 3, 1, 5, 7], [7] * 5],
                         ids=["ragged", "full"])
def test_dense_formula_matches_jax(lengths):
    """The port's dense formula (the kernel's backward recomputes through
    it) against the JAX package's, with the length mask."""
    c = _case(0, lengths)
    mask = _mask(c)
    want, jgrads = _jax_route(c, lambda *a: jattn.additive_attention_step(
        *a, jnp.asarray(mask)))
    got, grads = _port_route(c, lambda *a: tattn.additive_attention_step(
        *a, torch.from_numpy(mask)))
    _close(got, want, 1e-5, "context")
    for n, g, wg in zip(NAMES, grads, jgrads):
        _close(g, wg, 1e-4, f"d{n}")


@pytest.mark.parametrize("lengths", [[7, 3, 1, 5, 7], [7] * 5, [1] * 5],
                         ids=["ragged", "full", "one-key"])
def test_kernel_route_matches_the_pallas_kernel(lengths, monkeypatch):
    """The port's autograd function (its CPU forward is the kernel's plain
    version) against pallas_additive.additive_attention_step with lengths,
    the Pallas kernel run in interpret mode: forward 1e-5, the five
    gradients 1e-4."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    from paddle_tpu.ops import pallas_additive
    c = _case(1, lengths)
    lens = c["lengths"]
    want, jgrads = _jax_route(
        c, lambda *a: pallas_additive.additive_attention_step(
            *a, lengths=jnp.asarray(lens)))
    aa.counts.reset()
    got, grads = _port_route(c, lambda *a: aa.additive_attention(
        *a, torch.from_numpy(lens)))
    assert (aa.counts.plain, aa.counts.kernel, aa.counts.recompute) == \
        (1, 0, 1)
    _close(got, want, 1e-5, "context")
    for n, g, wg in zip(NAMES, grads, jgrads):
        _close(g, wg, 1e-4, f"d{n}")


def test_length_zero_row_keeps_the_kernel_routes_result(monkeypatch):
    """A row with no valid key: the kernel route (the JAX package's Pallas
    kernel, and the port's kernel and its plain version) returns a zero
    context where the dense formula averages all keys; the backward is the
    dense formula's gradient either way, as `_vjp_bwd` makes it."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    from paddle_tpu.ops import pallas_additive
    c = _case(2, [0, 4, 7, 2, 7])
    lens = c["lengths"]
    want, jgrads = _jax_route(
        c, lambda *a: pallas_additive.additive_attention_step(
            *a, lengths=jnp.asarray(lens)))
    got, grads = _port_route(c, lambda *a: aa.additive_attention(
        *a, torch.from_numpy(lens)))
    assert not np.asarray(want)[0].any() and not got[0].any()
    _close(got, want, 1e-5, "context")
    dense, dgrads = _port_route(c, lambda *a: tattn.additive_attention_step(
        *a, torch.from_numpy(_mask(c))))
    _close(dense[0], c["seq"][0].mean(0), 1e-5, "the dense row averages")
    _close(dense[1:], got[1:], 1e-5, "the other rows agree")
    for n, g, wg, dg in zip(NAMES, grads, jgrads, dgrads):
        _close(g, wg, 1e-4, f"d{n} (JAX)")
        _close(g, dg, 1e-6, f"d{n} (dense)")
    assert grads[4][0].abs().sum() > 0       # the averaged row's gradient


def test_plain_version_in_bfloat16_accumulates_in_float32():
    """bfloat16 enc_proj / enc_seq: the context comes back in bfloat16,
    computed in float32 (equal to the float32 computation rounded once)."""
    c = _case(3, [7, 3, 1, 5, 7])
    u = torch.from_numpy(c["dec"] @ c["w"])
    v = torch.from_numpy(c["v"])
    proj, seq = (torch.from_numpy(c[n]).bfloat16() for n in ("proj", "seq"))
    lens = torch.from_numpy(c["lengths"])
    got = aa.additive_attention_plain(u, v, proj, seq, lens)
    want = aa.additive_attention_plain(u, v, proj.float(), seq.float(), lens)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_the_kernel_wrapper_refuses_what_it_does_not_take():
    """A CPU tensor never reaches the kernel (the autograd function runs the
    plain version for it); the launch wrapper refuses it, and shapes that
    do not fit, instead of falling back."""
    c = _case(4, [7] * 5)
    t = {n: torch.from_numpy(c[n]) for n in c}
    u = t["dec"] @ t["w"]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        aa.additive_attention_kernel(u, t["v"], t["proj"], t["seq"],
                                     t["lengths"])
    with pytest.raises(ValueError, match="v"):
        aa.additive_attention_plain(u, t["v"][:-1], t["proj"], t["seq"],
                                    t["lengths"])
    assert aa.kernel.built is None


@pytest.mark.parametrize("B,Dv,sms,want", [
    (64, 1024, 132, 4),      # the decoder's training shape: 256 CTAs
    (192, 1024, 132, 4),     # the beam search's: 768 CTAs
    (16, 1024, 132, 8),      # a small batch: 128 CTAs
    (64, 2048, 132, 8),      # Dv 2048: slices of 256 need 8 CTAs
    (1000, 2048, 132, 8),
    (1000, 512, 132, 2),     # slices of at most 256 columns
    (1000, 256, 132, 1),
    (3, 24, 132, 8)])
def test_additive_plan_reads_shapes_alone(B, Dv, sms, want):
    ctas = aa.additive_plan(B, Dv, sms)
    assert ctas == want and ctas in (1, 2, 4, 8)
    assert -(-Dv // ctas) <= aa.MAX_SLICE


def _cluster_model(u, v, proj, seq, lens, ctas):
    """The kernel's algorithm in float64: CTA c scores the keys over its D
    slice (rounded to 4), the partial scores summed in rank order for every
    tile of 32 keys, an online softmax over the tiles, each CTA the context
    of its Dv slice (rounded to 8)."""
    B, T, D = proj.shape
    Dv = seq.shape[2]
    def round_up(x, m):
        return -(-x // m) * m
    dc = round_up(-(-D // ctas), 4)
    dvc = round_up(-(-Dv // ctas), 8)
    out = torch.zeros(B, Dv, dtype=torch.float64)
    for b in range(B):
        n_b = max(0, min(int(lens[b]), T))
        m, l = -float("inf"), 0.0
        acc = torch.zeros(Dv, dtype=torch.float64)
        for t0 in range(0, n_b, 32):
            t = torch.arange(t0, min(t0 + 32, n_b))
            s = torch.zeros(t.numel(), dtype=torch.float64)
            for c in range(ctas):
                sl = slice(c * dc, min(D, (c + 1) * dc))
                s = s + (v[sl].double() * torch.tanh(
                    proj[b, t, sl].double() + u[b, sl].double())).sum(1)
            m_new = max(m, float(s.max()))
            corr = np.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + float(p.sum())
            acc = acc * corr
            for c in range(ctas):
                sl = slice(c * dvc, min(Dv, (c + 1) * dvc))
                acc[sl] += p @ seq[b, t, sl].double()
            m = m_new
        out[b] = acc / max(l, 1e-30)
    return out


@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("T,D,Dv", [(7, 19, 13), (70, 33, 50)],
                         ids=["small", "tiles"])
def test_cluster_model_matches_the_plain_version(ctas, T, D, Dv):
    """The kernel's split of D and Dv over a cluster, its tiles of 32 keys
    (the last partial) and its rows without a key (modelled in float64)
    give the plain version's context."""
    rng = np.random.default_rng(5)
    B = 4
    u = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    seq = torch.from_numpy(rng.standard_normal((B, T, Dv)).astype(np.float32))
    lens = torch.tensor([T, 0, 1, T - 3], dtype=torch.int32)
    got = _cluster_model(u, v, proj, seq, lens, ctas)
    want = aa.additive_attention_plain(u, v, proj, seq, lens)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not bool(got[1].any())
