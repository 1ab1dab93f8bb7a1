"""PyTorch port: flash attention (K4).  On the CPU its wrapper runs the
plain versions of the three CUDA kernels; they are held here against the
JAX package's dense `dot_product_attention` and its gradients,
`blockwise_attention`, and the Pallas `flash_attention` kernel itself in
interpret mode (with offsets and an lse cotangent), in float32.  Tolerance
2e-5 absolute on o, lse and the gradients: the same arithmetic summed in
another order over at most 40 keys.  A plain model of the bfloat16
tensor-core kernels' rounding is held against the float32 plain versions
and the Pallas kernel on bf16 inputs at chip_smoke's bf16 limits."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRAD_TOL, o_limit_share
from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops import pallas_attention
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _case(seed, B=2, Tq=24, Tk=24, H=4, Hkv=2, D=8, ragged=True):
    """Random q/k/v, key and query validity; with `ragged`, batch row 1 is
    shorter and its first keys invalid, so that with causal masking its
    first query rows see no valid key at all."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk, Hkv, D)).astype(np.float32)
    kval = np.ones((B, Tk), bool)
    qval = np.ones((B, Tq), bool)
    if ragged:
        kval[1, Tk - 7:] = False
        kval[1, :3] = False
        qval[1, Tq - 5:] = False
    do = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    return q, k, v, kval, qval, do


def _jax_lse(q, k, kval, causal, window, q_off=0, k_off=0):
    """log-sum-exp of the masked scores, -inf for rows without a key."""
    kk = jnp.repeat(jnp.asarray(k), q.shape[2] // k.shape[2], axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kk) * q.shape[-1] ** -0.5
    mask = jattn._score_mask(q_off + jnp.arange(q.shape[1]),
                             k_off + jnp.arange(k.shape[1]), None,
                             jnp.asarray(kval), causal, window)
    s = jnp.where(mask, s, -jnp.inf)
    return jax.nn.logsumexp(s, axis=-1)


GRID = [(causal, window, hkv) for causal in (False, True)
        for window in (None, 5) for hkv in (4, 2, 1)]


@pytest.mark.parametrize("causal,window,hkv", GRID,
                         ids=[f"c{int(c)}-w{w}-kv{h}" for c, w, h in GRID])
def test_plain_forward_and_backward_match_dense_jax(causal, window, hkv):
    """o against dot_product_attention and blockwise_attention, lse against
    the masked log-sum-exp, and (dq, dk, dv) of the plain backward against
    jax.grad of sum(attention * do) through both; ragged key masks, GQA,
    fully masked rows."""
    q, k, v, kval, _, do = _case(1, Hkv=hkv)
    tk = _t(kval)
    o, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), tk, causal,
                                      window=window)
    jq, jk, jv, jkv = map(jnp.asarray, (q, k, v, kval))
    want = jattn.dot_product_attention(jq, jk, jv, k_valid=jkv,
                                       causal=causal, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)
    blk = jattn.blockwise_attention(jq, jk, jv, k_valid=jkv, causal=causal,
                                    block_k=8, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(blk), **TOL)
    want_lse = np.asarray(_jax_lse(q, k, kval, causal, window))
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(want_lse))
    if causal:
        assert np.isinf(want_lse).any()          # fully masked rows exist
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)

    grads = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), tk, o, lse,
                                         _t(do), None, causal, window=window)
    for attn in (jattn.dot_product_attention,
                 functools.partial(jattn.blockwise_attention, block_k=8)):
        def f(q_, k_, v_, attn=attn):
            return jnp.sum(attn(q_, k_, v_, k_valid=jkv, causal=causal,
                                window=window) * do)
        jg = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
        for got, w in zip(grads, jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_autograd_function_matches_torch_autograd_through_dense():
    """flash_attention's autograd.Function on CPU tensors (query validity
    applied outside) gives the gradients torch.autograd takes through the
    port's plain dense attention."""
    q, k, v, kval, qval, do = _case(2, Tq=20, Tk=28, D=16)
    for causal in (False, True):
        a = [_t(x).requires_grad_(True) for x in (q, k, v)]
        b = [_t(x).requires_grad_(True) for x in (q, k, v)]
        fa.counts.reset()
        o = fa.flash_attention(*a, q_valid=_t(qval), k_valid=_t(kval),
                               causal=causal)
        (o * _t(do)).sum().backward()
        assert fa.counts.plain == 2 and fa.counts.fwd == 0
        want = tattn.dot_product_attention(*b, q_valid=_t(qval),
                                           k_valid=_t(kval), causal=causal)
        (want * _t(do)).sum().backward()
        np.testing.assert_allclose(o.detach().numpy(),
                                   want.detach().numpy(), **TOL)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), **TOL)


@pytest.mark.parametrize("causal,window,q_off,k_off",
                         [(True, None, 16, 0), (True, 6, 3, 11),
                          (False, 6, 0, 9)],
                         ids=["causal-off16", "causal-w6-off", "w6-koff"])
def test_matches_the_pallas_kernel_in_interpret_mode(monkeypatch, causal,
                                                     window, q_off, k_off):
    """Against paddle_tpu's Pallas flash_attention (interpret mode, 8 x 8
    tiles): o and lse with query/key validity, global-position offsets,
    GQA; and the gradients of sum(o * do) + sum(lse * dlse) over the rows
    with a finite lse — the lse cotangent folds into delta."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q, k, v, kval, qval, do = _case(3, Tq=16, Tk=20)
    dlse = np.random.default_rng(4).normal(size=(2, 4, 16)).astype(np.float32)
    jargs = list(map(jnp.asarray, (q, k, v)))

    def jf(q_, k_, v_):
        o, lse = pallas_attention.flash_attention(
            q_, k_, v_, q_valid=jnp.asarray(qval), k_valid=jnp.asarray(kval),
            causal=causal, block_q=8, block_k=8, q_offset=q_off,
            k_offset=k_off, return_lse=True, window=window)
        fin = jnp.isfinite(lse)
        return (jnp.sum(o * do) + jnp.sum(jnp.where(fin, lse, 0.0) * dlse),
                (o, lse))
    (_, (jo, jlse)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                             has_aux=True)(*jargs)
    targs = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = fa.flash_attention(*targs, q_valid=_t(qval), k_valid=_t(kval),
                                causal=causal, q_offset=q_off,
                                k_offset=k_off, return_lse=True,
                                window=window)
    fin = torch.isfinite(lse)
    loss = (o * _t(do)).sum() + (torch.where(fin, lse, 0.0)
                                 * _t(dlse)).sum()
    loss.backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    assert np.array_equal(fin.numpy(), np.isfinite(np.asarray(jlse)))
    np.testing.assert_allclose(lse.detach().numpy()[fin.numpy()],
                               np.asarray(jlse)[fin.numpy()], **TOL)
    for x, w in zip(targs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL)


def test_fully_masked_rows_give_zero_and_minus_inf():
    q, k, v, _, _, do = _case(5, B=1, Tq=6, Tk=6, ragged=False)
    kval = np.zeros((1, 6), bool)
    o, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), _t(kval), True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()
    dq, dk, dv = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(kval), o, lse,
                                        _t(do))
    for g in (dq, dk, dv):
        assert torch.equal(g, torch.zeros_like(g))


def test_wrapper_rejects_bad_inputs():
    q, k, v, kval, _, _ = (_t(x) for x in _case(6))
    with pytest.raises(ValueError, match=r"\[B,Tq,H,D\]"):
        fa.flash_attention_fwd(q[0], k, v, kval)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention_fwd(q, k[..., :4], v[..., :4], kval)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention_fwd(q[:, :, :3], k, v, kval)
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_attention_fwd(q, k, v, kval[:, :5])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q, k.double(), v, kval)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q.long(), k.long(), v.long(), kval)
    with pytest.raises(ValueError, match="do must match"):
        fa.flash_attention_bwd(q, k, v, kval, q, q[..., 0, 0], q[:, :3])
    with pytest.raises(ValueError, match="no kernel for device"):
        fa._check_cuda("flash_attention", q=q.to("meta"))


# -- the tensor-core kernels' rounding (bfloat16) -----------------------------

def _bf(x):
    return x.to(torch.bfloat16).float()


def _bf2(x):
    """x as the sum of two bfloat16 terms, hi + lo (16 significant bits)."""
    hi = _bf(x)
    return hi + _bf(x - hi)


def _tc_model(q, k, v, kv_mask, do, dlse, causal, q_offset, k_offset,
              window, fwd_p=_bf2):
    """Plain-PyTorch model of csrc/flash_attention_tc.cu's arithmetic on
    bfloat16 q/k/v/do: products of bf16 operands with float32 sums; the
    forward's p (relative to the row max) enters P V as two bf16 terms,
    hi + lo; the backward's p = exp(s - lse) and dS are rounded to bf16
    where they enter a product; l, delta and the softmax in float32; o and
    the gradients rounded to bf16.  Returns (o, lse, dq, dk, dv) as float32
    tensors.  `fwd_p` rounds the forward's p (default: two terms)."""
    B, Tq, H, D = q.shape
    h_kv = k.shape[2]
    scale = D ** -0.5
    qh, doh = (x.float().permute(0, 2, 1, 3) for x in (q, do))
    kh, vh = fa._expand(k, H), fa._expand(v, H)
    mask = fa._score_mask(kv_mask, Tq, causal, q_offset, k_offset, window)
    s = torch.where(mask, torch.matmul(qh, kh.transpose(-1, -2)) * scale,
                    0.0)
    live = mask.any(dim=-1)
    m = torch.where(mask, s, float("-inf")).amax(dim=-1)
    m = torch.where(live, m, 0.0)
    e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(dim=-1)
    o = torch.matmul(fwd_p(e), vh) / l.clamp_min(1e-30)[..., None]
    o = _bf(torch.where(live[..., None], o, 0.0)).permute(0, 2, 1, 3)
    lse = torch.where(live, m + torch.log(l.clamp_min(1e-30)), float("-inf"))
    delta = fa.backward_delta(o, do.float(), dlse)
    p = torch.where(mask, torch.exp(s - torch.where(live, lse, 0.0)[..., None]),
                    0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(_bf(ds), kh)
    dk = torch.matmul(_bf(ds).transpose(-1, -2), qh)
    dv = torch.matmul(_bf(p).transpose(-1, -2), doh)

    def to_kv(g):
        g = g.reshape(B, h_kv, H // h_kv, *g.shape[2:]).sum(dim=2)
        return _bf(g.permute(0, 2, 1, 3))

    return (o, lse.expand(B, H, Tq).contiguous(),
            _bf(dq.permute(0, 2, 1, 3)), to_kv(dk), to_kv(dv))


# (D, H_kv, causal, window, q_offset, k_offset); Tq = 70, Tk = 90, H = 4,
# batch row 1's first 6 and last 20 keys invalid (with causal masking and
# these offsets its first rows see no key)
TC_MODEL_CASES = [(64, 2, True, None, 0, 0), (40, 2, True, 24, 5, 0),
                  (64, 1, False, 24, 0, 7), (40, 4, True, None, 30, 10)]
TC_MODEL_IDS = ["d64-causal-gqa", "d40-causal-w24-qoff", "d64-mqa-w24-koff",
                "d40-causal-offsets"]


def _tc_case(seed, D, hkv):
    q, k, v, kval, _, do = _case(seed, B=2, Tq=70, Tk=90, H=4, Hkv=hkv, D=D,
                                 ragged=False)
    kval[1, :6] = False
    kval[1, 70:] = False
    dlse = np.random.default_rng(seed + 1).normal(
        size=(2, 4, 70)).astype(np.float32) * 0.1
    bf16 = [torch.from_numpy(x).bfloat16() for x in (q, k, v, do)]
    return bf16, _t(kval), _t(dlse)


@pytest.mark.parametrize("D,hkv,causal,window,q_off,k_off", TC_MODEL_CASES,
                         ids=TC_MODEL_IDS)
def test_tc_rounding_model_within_chip_limits_of_fp32_plain(
        D, hkv, causal, window, q_off, k_off):
    """The tensor-core kernels' rounding (bf16 operands; the forward's p as
    two bf16 terms, the backward's p and dS rounded to bf16, entering a
    product) held against the float32 plain versions on the same bf16
    inputs at chip_smoke's bf16 limits: o per element within 2^-7 |ref| +
    1e-3, lse within 2e-5 and -inf on exactly the rows without a key,
    dq/dk/dv within 1e-2 of their max.  The plain backward is fed the
    model's o and lse, as chip_smoke feeds it the kernel's."""
    (q, k, v, do), kval, dlse = _tc_case(7, D, hkv)
    mask = dict(causal=causal, q_offset=q_off, k_offset=k_off, window=window)
    o, lse, *grads = _tc_model(q, k, v, kval, do, dlse, **mask)
    f = [x.float() for x in (q, k, v)]
    want_o, want_lse = fa.flash_attention_plain(*f, kval, **mask)
    assert o_limit_share(o, want_o, torch.bfloat16) <= 1
    fin = torch.isfinite(want_lse)
    assert (~fin).any() == (causal and q_off <= k_off + 5)
    assert torch.equal(torch.isfinite(lse), fin)
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 2e-5
    want = fa.flash_attention_bwd_plain(*f, kval, o, lse, do.float(), dlse,
                                        **mask)
    for got, ref in zip(grads, want):
        err = float((got - ref).abs().max())
        assert err <= GRAD_TOL[torch.bfloat16] * float(ref.abs().max()), err


def test_tc_rounding_model_needs_two_bf16_terms_for_p():
    """Why the forward kernel multiplies P V as two bf16 products: with p
    rounded to one bf16 term, o misses its limit (causal rows with few keys
    whose values cancel), while the gradients, whose p and dS do enter as
    one term, stay within theirs."""
    (q, k, v, do), kval, dlse = _tc_case(7, 64, 2)
    o, _, *_ = _tc_model(q, k, v, kval, do, dlse, True, 0, 0, None,
                         fwd_p=_bf)
    want_o, _ = fa.flash_attention_plain(*(x.float() for x in (q, k, v)),
                                         kval, causal=True)
    assert o_limit_share(o, want_o, torch.bfloat16) > 1


@pytest.mark.parametrize("D,hkv,causal,window,q_off,k_off", TC_MODEL_CASES,
                         ids=TC_MODEL_IDS)
def test_tc_rounding_model_within_chip_limits_of_pallas_bf16(
        monkeypatch, D, hkv, causal, window, q_off, k_off):
    """The same model against paddle_tpu's Pallas flash_attention on the
    same bf16 inputs (interpret mode, 32 x 32 tiles), o, lse and the vjp
    of (o, lse) with cotangents (do, dlse), at the same limits.  Also the
    Pallas kernel's own o against the float32 plain version, as a share of
    the o limit: in interpret mode its default-precision products run in
    float32 on the CPU, so p enters P V unrounded and o stays within the
    limit; the MXU's one bf16 pass rounds p to one term, the rounding that
    test_tc_rounding_model_needs_two_bf16_terms_for_p shows to miss it."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    (q, k, v, do), kval, dlse = _tc_case(7, D, hkv)
    mask = dict(causal=causal, q_offset=q_off, k_offset=k_off, window=window)
    o, lse, *grads = _tc_model(q, k, v, kval, do, dlse, **mask)

    def jf(q_, k_, v_):
        return pallas_attention.flash_attention(
            q_, k_, v_, k_valid=jnp.asarray(kval.numpy()), causal=causal,
            block_q=32, block_k=32, q_offset=q_off, k_offset=k_off,
            return_lse=True, window=window)
    jbf = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
    (jo, jlse), vjp = jax.vjp(jf, *jbf)
    jfin = np.isfinite(np.asarray(jlse))
    jg = vjp((jnp.asarray(do.float().numpy(), jnp.bfloat16),
              jnp.asarray(np.where(jfin, dlse.numpy(), 0.0))))
    want_o = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    plain_o, _ = fa.flash_attention_plain(*(x.float() for x in (q, k, v)),
                                          kval, **mask)
    pallas_share = o_limit_share(want_o, plain_o, torch.bfloat16)
    assert pallas_share <= 1, pallas_share
    assert o_limit_share(o, want_o, torch.bfloat16) <= 1
    assert np.array_equal(torch.isfinite(lse).numpy(), jfin)
    assert np.abs(lse.numpy()[jfin] - np.asarray(jlse)[jfin]).max() <= 2e-5
    for got, w in zip(grads, jg):
        ref = np.asarray(w.astype(jnp.float32))
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= GRAD_TOL[torch.bfloat16] * float(np.abs(ref).max()), err


# -- the float32 kernels' arithmetic (three TF32 passes) ----------------------

def _tf32(x):
    """x rounded to tf32 (10 explicit mantissa bits) to nearest, ties away
    from zero, on the bit pattern: the kernels' cvt.rna.tf32.f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as csrc/flash_attention.cu multiplies: hi = tf32(x), lo =
    tf32(x - hi) for each operand, three tf32 products (the small terms
    first) with float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.matmul(ah, bl) + torch.matmul(al, bh)) + torch.matmul(ah, bh)


def _mm1(a, b):
    """a @ b in one tf32 pass."""
    return torch.matmul(_tf32(a), _tf32(b))


def _tf32x3_model(q, k, v, kv_mask, do, dlse, causal, q_offset, k_offset,
                  window, mm=_mm3):
    """Plain-PyTorch model of csrc/flash_attention.cu's arithmetic on float32
    q/k/v/do: every product through `mm` (default: three tf32 passes), the
    softmax, l, delta and the masks in float32.  Returns (o, lse, dq, dk,
    dv)."""
    B, Tq, H, D = q.shape
    h_kv = k.shape[2]
    scale = D ** -0.5
    qh, doh = (x.float().permute(0, 2, 1, 3) for x in (q, do))
    kh, vh = fa._expand(k, H), fa._expand(v, H)
    mask = fa._score_mask(kv_mask, Tq, causal, q_offset, k_offset, window)
    s = torch.where(mask, mm(qh, kh.transpose(-1, -2)) * scale, 0.0)
    live = mask.any(dim=-1)
    m = torch.where(mask, s, float("-inf")).amax(dim=-1)
    m = torch.where(live, m, 0.0)
    e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(dim=-1)
    o = mm(e, vh) / l.clamp_min(1e-30)[..., None]
    o = torch.where(live[..., None], o, 0.0).permute(0, 2, 1, 3)
    lse = torch.where(live, m + torch.log(l.clamp_min(1e-30)), float("-inf"))
    delta = fa.backward_delta(o, do.float(), dlse)
    p = torch.where(mask, torch.exp(s - torch.where(live, lse, 0.0)[..., None]),
                    0.0)
    dp = mm(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = mm(ds, kh)
    dk = mm(ds.transpose(-1, -2), qh)
    dv = mm(p.transpose(-1, -2), doh)

    def to_kv(g):
        g = g.reshape(B, h_kv, H // h_kv, *g.shape[2:]).sum(dim=2)
        return g.permute(0, 2, 1, 3)

    return (o, lse.expand(B, H, Tq).contiguous(), dq.permute(0, 2, 1, 3),
            to_kv(dk), to_kv(dv))


# the masks of TC_MODEL_CASES at the float32 kernels' two head-dim instances
F32_MODEL_CASES = [(D, hkv, causal, window, q_off, k_off)
                   for _, hkv, causal, window, q_off, k_off in TC_MODEL_CASES
                   for D in (64, 128)]
F32_MODEL_IDS = [f"{name.split('-', 1)[1]}-d{D}" for name in TC_MODEL_IDS
                 for D in (64, 128)]


def _f32_case(seed, D, hkv, q_scale=1.0):
    """_tc_case's shapes and masks in float32; q scaled by `q_scale`."""
    q, k, v, kval, _, do = _case(seed, B=2, Tq=70, Tk=90, H=4, Hkv=hkv, D=D,
                                 ragged=False)
    kval[1, :6] = False
    kval[1, 70:] = False
    dlse = np.random.default_rng(seed + 1).normal(
        size=(2, 4, 70)).astype(np.float32) * 0.1
    return ([_t(q) * q_scale, _t(k), _t(v), _t(do)], _t(kval), _t(dlse))


def _assert_f32_limits(o, lse, grads, want_o, want_lse, want_grads):
    """chip_smoke's float32 limits: o within 2e-5, lse within 2e-5 and -inf
    on exactly the same rows, gradients within GRAD_TOL[float32] of their
    max."""
    assert o_limit_share(o, want_o, torch.float32) <= 1
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 2e-5
    for got, ref in zip(grads, want_grads):
        ref = torch.as_tensor(np.array(ref))
        err = float((got - ref).abs().max())
        assert err <= GRAD_TOL[torch.float32] * float(ref.abs().max()), err


@pytest.mark.parametrize("D,hkv,causal,window,q_off,k_off", F32_MODEL_CASES,
                         ids=F32_MODEL_IDS)
def test_tf32x3_model_within_chip_limits_of_fp32_plain(
        D, hkv, causal, window, q_off, k_off):
    """The float32 kernels' arithmetic (every product three tf32 passes on
    a hi/lo split) held against the float32 plain versions at chip_smoke's
    float32 limits; the plain backward is fed the model's o and lse, as
    chip_smoke feeds it the kernel's."""
    (q, k, v, do), kval, dlse = _f32_case(7, D, hkv)
    mask = dict(causal=causal, q_offset=q_off, k_offset=k_off, window=window)
    o, lse, *grads = _tf32x3_model(q, k, v, kval, do, dlse, **mask)
    want_o, want_lse = fa.flash_attention_plain(q, k, v, kval, **mask)
    want = fa.flash_attention_bwd_plain(q, k, v, kval, o, lse, do, dlse,
                                        **mask)
    _assert_f32_limits(o, lse, grads, want_o, want_lse, want)


@pytest.mark.parametrize("D,hkv,causal,window,q_off,k_off", F32_MODEL_CASES,
                         ids=F32_MODEL_IDS)
def test_tf32x3_model_within_chip_limits_of_pallas_highest(
        monkeypatch, D, hkv, causal, window, q_off, k_off):
    """The same model against paddle_tpu's Pallas flash_attention on the
    same float32 inputs (interpret mode, 32 x 32 tiles; float32 inputs take
    Precision.HIGHEST in its products): o, lse and the vjp of (o, lse) with
    cotangents (do, dlse), at the same limits."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    (q, k, v, do), kval, dlse = _f32_case(7, D, hkv)
    mask = dict(causal=causal, q_offset=q_off, k_offset=k_off, window=window)
    o, lse, *grads = _tf32x3_model(q, k, v, kval, do, dlse, **mask)

    def jf(q_, k_, v_):
        return pallas_attention.flash_attention(
            q_, k_, v_, k_valid=jnp.asarray(kval.numpy()), causal=causal,
            block_q=32, block_k=32, q_offset=q_off, k_offset=k_off,
            return_lse=True, window=window)
    (jo, jlse), vjp = jax.vjp(jf, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    jfin = np.isfinite(np.asarray(jlse))
    jg = vjp((jnp.asarray(do.numpy()),
              jnp.asarray(np.where(jfin, dlse.numpy(), 0.0))))
    _assert_f32_limits(o, lse, grads, _t(jo), _t(jlse), jg)


def test_tf32x3_model_needs_three_passes():
    """Why every product takes three tf32 passes: with one pass, lse misses
    its 2e-5 limit at scores of a few units (q scaled by 4), while three
    passes stay well within it."""
    (q, k, v, do), kval, dlse = _f32_case(7, 64, 2, q_scale=4.0)
    _, want_lse = fa.flash_attention_plain(q, k, v, kval, causal=True)
    fin = torch.isfinite(want_lse)
    err = {}
    for name, mm in (("one", _mm1), ("three", _mm3)):
        _, lse, *_ = _tf32x3_model(q, k, v, kval, do, dlse, True, 0, 0, None,
                                   mm=mm)
        err[name] = float((lse[fin] - want_lse[fin]).abs().max())
    assert err["one"] > 2e-5, err
    assert err["three"] <= 2e-5, err
