"""Attention ops — counterparts of paddle_tpu/ops/attention.py: those of
the transformer LM (dense, blockwise and cached-decode attention, the paged
serving steps), and the seq2seq decoder's dense additive-attention step.

Layouts are the JAX package's: q/k/v [..., T, H, D] (heads before the head
dim), page pools [P, page_size, H_kv, D], page tables
[S(+1), pages_per_slot] int32.  The paged steps write the new K/V into the
pools IN PLACE (`index_put_`) and return the same pool tensors — where the
JAX side gets the same effect from buffer donation; `cached_attention_step`
writes its dense per-request cache in place the same way.  The paged read
goes through the ragged paged-attention kernel (ops/paged_attention.py),
or through a page-table gather for sliding-window configs and for layers
pinned to attn_impl 'dense'/'blockwise', as the JAX package routes it.
`blockwise_attention` and `cached_attention_step` are plain PyTorch, as
their JAX counterparts are jnp (no Pallas kernel behind either).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.utils.dtypes import promote_compute

_NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, rotate-half layout (feature i pairs with
    i + D/2).  x [B, T, H, D]; positions [T] or [B, T] global positions.
    Angles in float32; the result is cast back to x's dtype."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"rope needs an even head dim, got {D}")
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs     # [..., T, half]
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def _expand_kv_heads(k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Grouped-query attention: repeat each of the H_kv heads (axis 2) over
    its query-head group."""
    h_kv = k.shape[2]
    if h_kv == num_heads:
        return k, v
    if num_heads % h_kv:
        raise ValueError(f"num_heads {num_heads} not divisible by "
                         f"num_kv_heads {h_kv}")
    rep = num_heads // h_kv
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _score_mask(q_pos, k_pos, q_valid, k_valid, causal: bool,
                window: Optional[int]):
    """Validity mask broadcastable to [B, 1, Tq, Tk]; None = all valid."""
    mask = None
    if causal:
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    if window is not None:
        d = q_pos[:, None] - k_pos[None, :]
        w = (d.abs() < window)[None, None]
        mask = w if mask is None else mask & w
    if k_valid is not None:
        kv = k_valid[:, None, None, :]
        mask = kv if mask is None else mask & kv
    if q_valid is not None:
        qv = q_valid[:, None, :, None]
        mask = qv if mask is None else mask & qv
    return mask


def dot_product_attention(q, k, v, q_valid=None, k_valid=None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Dense attention.  q [B,Tq,H,D], k/v [B,Tk,H_kv,D] -> [B,Tq,H,D].
    Rows with no valid key output exactly 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _expand_kv_heads(k, v, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    dev = q.device
    mask = _score_mask(torch.arange(q.shape[1], device=dev),
                       torch.arange(k.shape[1], device=dev),
                       q_valid, k_valid, causal, window)
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where(mask.any(dim=-1, keepdim=True), p,
                        torch.zeros((), dtype=p.dtype, device=dev))
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _online_block(acc, q, k_blk, v_blk, q_pos, k_pos, q_valid, k_valid_blk,
                  causal: bool, scale: float, window: Optional[int]):
    """Fold one key/value block into the online-softmax accumulator
    acc = (o [B, Tq, H, D] float32, m [B, H, Tq] running max, l [B, H, Tq]
    running sum)."""
    o, m, l = acc
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    mask = _score_mask(q_pos, k_pos, q_valid, k_valid_blk, causal, window)
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1).float())
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), dtype=p.dtype,
                                             device=p.device))
    corr = torch.exp(m - m_new)
    l_new = corr * l + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.to(p.dtype))
    return o * corr.transpose(1, 2)[..., None] + pv, m_new, l_new


def blockwise_attention(q, k, v, q_valid=None, k_valid=None,
                        causal: bool = False,
                        scale: Optional[float] = None, block_k: int = 512,
                        window: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over key blocks of `block_k` (the last one
    shorter when block_k does not divide Tk): the (o, m, l) accumulator
    instead of the [Tq, Tk] score matrix.  The math of
    `dot_product_attention` (grouped kv heads, sliding window, rows with
    no valid key give 0).  Under autograd each block is recomputed in the
    backward (`torch.utils.checkpoint`), so the saved state stays O(T), as
    the JAX version remats its scan body."""
    B, Tq, H, D = q.shape
    k, v = _expand_kv_heads(k, v, H)
    Tk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    q_pos = torch.arange(Tq, device=dev)
    acc = (torch.zeros((B, Tq, H, D), dtype=torch.float32, device=dev),
           torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32, device=dev),
           torch.zeros((B, H, Tq), dtype=torch.float32, device=dev))
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for start in range(0, Tk, max(1, min(int(block_k), Tk))):
        stop = min(start + int(block_k), Tk)
        args = (q, k[:, start:stop], v[:, start:stop], q_pos,
                torch.arange(start, stop, device=dev), q_valid,
                None if k_valid is None else k_valid[:, start:stop])
        if remat:
            acc = checkpoint(_online_block, acc, *args, causal, scale,
                             window, use_reentrant=False)
        else:
            acc = _online_block(acc, *args, causal, scale, window)
    o, _, l = acc
    denom = l.transpose(1, 2)[..., None]
    return torch.where(denom > 0, o / denom.clamp_min(1e-30),
                       torch.zeros((), device=dev)).to(q.dtype)


def cached_attention_step(q_new, k_new, v_new, cache_k, cache_v, pos, n_new,
                          scale: Optional[float] = None,
                          window: Optional[int] = None):
    """Incremental causal attention against a dense per-request KV cache:
    row b's Tn new tokens (q/k/v_new [B, Tn, H(_kv), D]) land at cache
    positions pos[b] .. pos[b] + Tn - 1 of cache_k/v [B, Tmax, H_kv, D]
    and attend over every position up to their own (and inside the window)
    on global positions; scores in at least float32 (promote_compute), the
    probabilities cast to the cache dtype for the value sum.  The write is
    an index write into the caches, in place — the values of the JAX
    version's one-hot product, without reading and writing the whole cache.
    Positions past pos + n_new hold whatever padded tokens wrote there;
    causality keeps every valid query off them and the next call
    overwrites them.  Every written position must lie inside the cache
    (an index past it raises; the JAX version drops such writes, and no
    caller makes them).  Returns (out [B, Tn, H, D], cache_k, cache_v,
    pos + n_new)."""
    B, Tn, H, D = q_new.shape
    Tmax = cache_k.shape[1]
    if scale is None:
        scale = D ** -0.5
    dev = q_new.device
    qpos = pos.long()[:, None] + torch.arange(Tn, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None].expand(B, Tn)
    cache_k.index_put_((rows, qpos), k_new.to(cache_k.dtype))
    cache_v.index_put_((rows, qpos), v_new.to(cache_v.dtype))
    t = torch.arange(Tmax, device=dev)
    mask = t[None, None, :] <= qpos[:, :, None]                # [B, Tn, Tmax]
    if window is not None:
        mask = mask & (t[None, None, :] > qpos[:, :, None] - window)
    k_full, v_full = _expand_kv_heads(cache_k, cache_v, H)
    s = promote_compute(torch.einsum("bqhd,bkhd->bhqk", q_new, k_full)
                        * scale)
    s = torch.where(mask[:, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_full.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v_full)
    return out, cache_k, cache_v, pos + n_new


def _gather_read(q, ck, cv, rows_table, row_pos, scale: float,
                 window: Optional[int]) -> torch.Tensor:
    """The page-table gather read: rows' pages gathered to a contiguous
    [T, T_ctx] view, masked causally (and by the window), softmax in at
    least float32, probabilities cast to the pool dtype for the value sum —
    the arithmetic of the JAX fallback path."""
    T, H, D = q.shape
    T_ctx = rows_table.shape[1] * ck.shape[1]
    kc = ck[rows_table.long()].reshape(T, T_ctx, *ck.shape[2:])
    vc = cv[rows_table.long()].reshape(T, T_ctx, *cv.shape[2:])
    k_full, v_full = _expand_kv_heads(kc, vc, H)
    t = torch.arange(T_ctx, device=q.device)
    mask = t[None, :] <= row_pos[:, None]
    if window is not None:
        mask = mask & (t[None, :] > row_pos[:, None] - window)
    s = torch.einsum("qhd,qkhd->qhk", q, k_full) * scale
    if s.dtype in (torch.bfloat16, torch.float16):
        s = s.float()
    s = torch.where(mask[:, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_full.dtype)
    return torch.einsum("qhk,qkhd->qhd", p, v_full)


def paged_attention_step(q_new, k_new, v_new, k_pages, v_pages, page_table,
                         pos, scale: Optional[float] = None,
                         window: Optional[int] = None,
                         use_kernel: Optional[bool] = None,
                         splits: Optional[int] = None):
    """One decode micro-step against the paged KV pool: slot s's new token
    (q/k/v_new [S, 1, H(_kv), D]) lands at logical position pos[s] —
    physical page page_table[s, pos[s] // page_size], offset
    pos[s] % page_size — and attends over positions 0..pos[s].  Unmapped
    logical pages are 0, the trash page.  Returns (out [S, 1, H, D],
    k_pages, v_pages) with the pools updated in place.  `use_kernel=None`
    routes the read through the kernel unless a window is set; False
    forces the gather read.  `splits` pins the kernel's split count
    (ops/paged_attention.py)."""
    S, Tn, H, D = q_new.shape
    if Tn != 1:
        raise ValueError("paged decode feeds exactly one new token per slot")
    ps = k_pages.shape[1]
    if scale is None:
        scale = D ** -0.5
    pos = pos.to(torch.int64)
    phys = page_table.long().gather(1, (pos // ps)[:, None])[:, 0]
    off = pos % ps
    k_pages.index_put_((phys, off), k_new[:, 0].to(k_pages.dtype))
    v_pages.index_put_((phys, off), v_new[:, 0].to(v_pages.dtype))
    if use_kernel is None:
        use_kernel = window is None
    if use_kernel:
        if window is not None:
            raise ValueError("paged_attention_step: the paged-attention "
                             "kernel has no sliding-window support — pass "
                             "use_kernel=False or None")
        out = pa.paged_attention(q_new[:, 0].contiguous(), k_pages, v_pages,
                                 page_table, (pos + 1).to(torch.int32),
                                 scale=scale, splits=splits)
        return out[:, None], k_pages, v_pages
    out = _gather_read(q_new[:, 0], k_pages, v_pages, page_table, pos,
                       scale, window)
    return out[:, None], k_pages, v_pages


def ragged_paged_attention_step(q_new, k_new, v_new, k_pages, v_pages,
                                page_table, row_slot, row_pos,
                                scale: Optional[float] = None,
                                window: Optional[int] = None,
                                use_kernel: Optional[bool] = None,
                                splits: Optional[int] = None):
    """The mixed prefill/decode step: packed query rows q/k/v_new
    [T, H(_kv), D], row r being one token of table row row_slot[r] at
    global position row_pos[r].  Every row's K/V is written first, so the
    rows of one prompt chunk see each other under the causal mask; padding
    rows point row_slot at an all-zero table row and write into trash page
    0.  Returns (out [T, H, D], k_pages, v_pages), pools updated in place.
    Routing as in paged_attention_step."""
    T, H, D = q_new.shape
    ps = k_pages.shape[1]
    if scale is None:
        scale = D ** -0.5
    rs = row_slot.long()
    rp = row_pos.to(torch.int64)
    phys = page_table.long()[rs, rp // ps]
    off = rp % ps
    k_pages.index_put_((phys, off), k_new.to(k_pages.dtype))
    v_pages.index_put_((phys, off), v_new.to(v_pages.dtype))
    if use_kernel is None:
        use_kernel = window is None
    if use_kernel:
        if window is not None:
            raise ValueError("ragged_paged_attention_step: the "
                             "paged-attention kernel has no sliding-window "
                             "support — pass use_kernel=False or None")
        out = pa.paged_attention(q_new.contiguous(), k_pages, v_pages,
                                 page_table, (rp + 1).to(torch.int32),
                                 scale=scale,
                                 row_slot=row_slot.to(torch.int32),
                                 splits=splits)
        return out, k_pages, v_pages
    out = _gather_read(q_new, k_pages, v_pages, page_table[rs], rp, scale,
                       window)
    return out, k_pages, v_pages


def additive_attention_step(dec_state: torch.Tensor, w: torch.Tensor,
                            v: torch.Tensor, enc_proj: torch.Tensor,
                            enc_seq: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One Bahdanau additive-attention step as a dense formula: dec_state
    [B, Ds], w [Ds, D], v [D], enc_proj [B, T, D], enc_seq [B, T, Dv], mask
    [B, T] -> context [B, Dv].  Scores v . tanh(enc_proj + dec_state w),
    softmax in at least float32 over the valid keys (a row without one
    averages all keys), the weights cast to enc_seq's dtype for the sum.
    The additive-attention kernel's backward recomputes through it
    (ops/additive_attention.py)."""
    s = torch.einsum("btd,d->bt",
                     torch.tanh(enc_proj + (dec_state @ w)[:, None, :]), v)
    if s.dtype in (torch.bfloat16, torch.float16):
        s = s.float()
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    alpha = torch.softmax(s, dim=-1)
    return torch.einsum("bt,btd->bd", alpha.to(enc_seq.dtype), enc_seq)
