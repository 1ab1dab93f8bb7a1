"""Attention layers — the counterparts of paddle_tpu/graph/layers_attn.py
for the serving and training slices (`multi_head_attention`) and the
seq2seq decoder (`additive_attention_step`).

Four cases:
  * full sequence (no state): `attn_impl` 'auto' runs dense attention
    below `block_k_min` (default 2048) keys and the flash-attention kernels
    (ops/flash_attention.py, K4) at or above it, as does a layer pinned to
    'flash'; 'dense' pins dense attention, 'blockwise' the online-softmax
    loop over key blocks of `block_k` (default 512).  The context-parallel
    paths (ring, ulysses) are not ported yet and raise (ROADMAP.md);
  * `_cached_step`: new tokens against the dense per-request KV cache of
    graph/lm_decode.py and the serving engine's whole-prompt prefill — a
    multi-token call on an empty cache (the prefill) through the
    implementation the layer selects, flash (K4) for long prompts; one
    token, or a state marked "cont" (a prefix-seeded cache), through
    `cached_attention_step`;
  * `_paged_step`: one decode token per slot against the serving engine's
    paged KV pool;
  * `_paged_ragged_step`: the mixed prefill/decode step, packed query rows
    each addressing its own table row at its own position.
The paged steps read through the ragged paged-attention kernel, or
through the page-table gather for sliding-window layers and layers pinned
to attn_impl 'dense'/'blockwise' — the JAX package's routing.
"""

from __future__ import annotations

import functools

import torch

from paddle_tpu_torch.config.schema import LayerConfig
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.ops import additive_attention as additive_ops
from paddle_tpu_torch.ops.attention import (
    additive_attention_step,
    blockwise_attention,
    cached_attention_step,
    dot_product_attention,
    paged_attention_step,
    ragged_paged_attention_step,
    rope,
)
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.parameter.argument import Argument

# the JAX package's dense -> flash/blockwise crossover in key positions
_BLOCKWISE_MIN_KEYS = 2048
_IMPLS = ("auto", "ring", "ulysses", "flash", "blockwise", "dense")


def _impl(cfg: LayerConfig) -> str:
    impl = str(cfg.attrs.get("attn_impl", "auto"))
    if impl not in _IMPLS:
        raise ValueError(f"layer {cfg.name!r}: unknown attn_impl {impl!r} "
                         f"(expected {'/'.join(_IMPLS)})")
    return impl


def _window(cfg: LayerConfig):
    return int(cfg.attrs["window"]) if "window" in cfg.attrs else None


def _paged_use_kernel(cfg: LayerConfig):
    """None = auto (the kernel unless a window is set); False = gather."""
    return False if _impl(cfg) in ("dense", "blockwise") else None


@register_layer("multi_head_attention")
def multi_head_attention_layer(ctx: ForwardContext,
                               cfg: LayerConfig) -> Argument:
    """inputs: [query, key, value, query again carrying the out-proj];
    attrs: num_heads, causal, attn_impl, block_k_min, num_kv_heads,
    window, use_rope/rope_theta."""
    q_arg, k_arg, v_arg = (ctx.get_input(cfg, i) for i in range(3))
    w_q, w_k, w_v, w_o = (ctx.param_of(cfg, i) for i in range(4))
    num_heads = int(cfg.attrs["num_heads"])
    causal = bool(cfg.attrs.get("causal", False))

    cache = ctx.state_in.get(cfg.name)
    if isinstance(cache, dict) and "k_pages" in cache:
        if not causal:
            raise ValueError(f"layer {cfg.name!r}: paged decode requires "
                             f"causal attention")
        if "row_slot" in cache:
            return _paged_ragged_step(ctx, cfg, q_arg, w_q, w_k, w_v, w_o,
                                      num_heads, cache)
        return _paged_step(ctx, cfg, q_arg, w_q, w_k, w_v, w_o, num_heads,
                           cache)
    if isinstance(cache, dict) and "k" in cache:
        if not causal:
            raise ValueError(f"layer {cfg.name!r}: KV-cache decode requires "
                             f"causal attention")
        return _cached_step(ctx, cfg, q_arg, w_q, w_k, w_v, w_o, num_heads,
                            cache)

    impl = _impl(cfg)
    if impl == "auto":
        long_keys = k_arg.max_len >= int(cfg.attrs.get("block_k_min",
                                                       _BLOCKWISE_MIN_KEYS))
        impl = "flash" if long_keys else "dense"
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"layer {cfg.name!r}: attn_impl {impl!r} (the context-parallel "
            f"paths) is not ported yet (ROADMAP.md)")
    # the block_q/block_k attrs (and PADDLE_TPU_FLASH_BLOCK_Q/K) tune the
    # TPU flash kernel's tiles; the CUDA kernels have fixed 64 x 64 tiles
    # and ignore them (block_k still sizes blockwise attention's blocks)
    if impl == "blockwise":
        attn_fn = functools.partial(
            blockwise_attention, block_k=int(cfg.attrs.get("block_k", 512)))
    else:
        attn_fn = flash_attention if impl == "flash" \
            else dot_product_attention

    B, Tq, _ = q_arg.value.shape
    Tk = k_arg.value.shape[1]
    model_dim = w_q.shape[1]
    Dh = model_dim // num_heads
    h_kv = int(cfg.attrs.get("num_kv_heads", 0) or num_heads)
    q = (q_arg.value @ w_q).reshape(B, Tq, num_heads, Dh)
    k = (k_arg.value @ w_k).reshape(B, Tk, h_kv, Dh)
    v = (v_arg.value @ w_v).reshape(B, Tk, h_kv, Dh)
    if bool(cfg.attrs.get("use_rope", False)):
        theta = float(cfg.attrs.get("rope_theta", 10000.0))
        q = rope(q, torch.arange(Tq, device=q.device), theta)
        k = rope(k, torch.arange(Tk, device=k.device), theta)
    o = attn_fn(q.contiguous(), k.contiguous(), v.contiguous(),
                q_valid=q_arg.mask(), k_valid=k_arg.mask(), causal=causal,
                window=_window(cfg))
    return _out_proj(ctx, cfg, o.reshape(B, Tq, model_dim), w_o, q_arg)


def _project(x, w_q, w_k, w_v, num_heads: int, h_kv: int):
    lead = x.shape[:-1]
    Dh = w_q.shape[1] // num_heads
    return ((x @ w_q).reshape(*lead, num_heads, Dh),
            (x @ w_k).reshape(*lead, h_kv, Dh),
            (x @ w_v).reshape(*lead, h_kv, Dh))


def _out_proj(ctx: ForwardContext, cfg: LayerConfig, out, w_o, x_arg):
    o = out @ w_o
    bias = ctx.bias_of(cfg)
    if bias is not None:
        o = o + bias
    return finish_layer(ctx, cfg, o, like=x_arg)


def _prefill_attn(cfg: LayerConfig, Tn: int):
    """The attention of a cached prefill of Tn tokens: a pinned 'flash',
    'blockwise' (its default blocks) or 'dense', else (auto, and the
    context-parallel impls, which have no cached analog) flash at Tn >=
    block_k_min, dense below."""
    impl = _impl(cfg)
    if impl == "blockwise":
        return blockwise_attention
    if impl == "dense":
        return dot_product_attention
    if impl == "flash" or Tn >= int(cfg.attrs.get("block_k_min",
                                                  _BLOCKWISE_MIN_KEYS)):
        return flash_attention
    return dot_product_attention


def _cached_step(ctx: ForwardContext, cfg: LayerConfig, x_arg: Argument,
                 w_q, w_k, w_v, w_o, num_heads: int, cache: dict) -> Argument:
    """New tokens x [B, Tn, model_dim] against this layer's dense KV cache
    {"k", "v" [B, Tmax, H_kv, D], "pos" [B]}: row b's valid tokens are its
    first x_arg.lengths[b] (all Tn without lengths), at global positions
    pos[b] + i.  A multi-token call on a state without "cont" is the
    PREFILL: the cache is empty, so attention is causal self-attention over
    the new tokens (`_prefill_attn`, valid rows and keys as the lengths
    say) and their K/V land in cache[:, :Tn].  One token, or a state
    carrying "cont" (the serving engine's prefix-seeded cache, continued
    from pos), goes through `cached_attention_step`.  Emits {"k", "v",
    "pos"} (the caches written in place, pos advanced by the lengths)
    through ctx.state_out."""
    x = x_arg.value
    B, Tn, _ = x.shape
    model_dim = w_q.shape[1]
    h_kv = int(cfg.attrs.get("num_kv_heads", 0) or num_heads)
    pos = cache["pos"]
    q, k, v = _project(x, w_q, w_k, w_v, num_heads, h_kv)
    if bool(cfg.attrs.get("use_rope", False)):
        qpos = pos[:, None] + torch.arange(Tn, device=x.device)[None, :]
        theta = float(cfg.attrs.get("rope_theta", 10000.0))
        q, k = rope(q, qpos, theta), rope(k, qpos, theta)
    n_new = (x_arg.lengths.to(torch.int32) if x_arg.lengths is not None
             else torch.full((B,), Tn, dtype=torch.int32, device=x.device))
    if Tn > 1 and "cont" not in cache:
        valid = torch.arange(Tn, device=x.device)[None, :] < n_new[:, None]
        out = _prefill_attn(cfg, Tn)(
            q.contiguous(), k.contiguous(), v.contiguous(), q_valid=valid,
            k_valid=valid, causal=True, window=_window(cfg))
        ck, cv = cache["k"], cache["v"]
        ck[:, :Tn] = k.to(ck.dtype)
        cv[:, :Tn] = v.to(cv.dtype)
        newpos = pos + n_new
    else:
        out, ck, cv, newpos = cached_attention_step(
            q, k, v, cache["k"], cache["v"], pos, n_new, window=_window(cfg))
    ctx.state_out[cfg.name] = {"k": ck, "v": cv, "pos": newpos}
    return _out_proj(ctx, cfg, out.reshape(B, Tn, model_dim), w_o, x_arg)


def _paged_step(ctx: ForwardContext, cfg: LayerConfig, x_arg: Argument,
                w_q, w_k, w_v, w_o, num_heads: int, cache: dict) -> Argument:
    """One decode micro-step: project each slot's single new token
    ([S, 1, model_dim]), write its K/V into the slot's current page, attend
    over the slot's paged context.  Emits the (in-place updated) pools
    through ctx.state_out.  cache["splits"], when given, pins the kernel's
    split count."""
    x = x_arg.value
    S, Tn, model_dim = x.shape
    if Tn != 1:
        raise ValueError(f"layer {cfg.name!r}: paged decode feeds exactly "
                         f"one new token per slot (got {Tn})")
    h_kv = int(cfg.attrs.get("num_kv_heads", 0) or num_heads)
    pos = cache["pos"]
    q, k, v = _project(x, w_q, w_k, w_v, num_heads, h_kv)
    if bool(cfg.attrs.get("use_rope", False)):
        theta = float(cfg.attrs.get("rope_theta", 10000.0))
        q, k = rope(q, pos[:, None], theta), rope(k, pos[:, None], theta)
    out, ck, cv = paged_attention_step(
        q, k, v, cache["k_pages"], cache["v_pages"], cache["page_table"],
        pos, window=_window(cfg), use_kernel=_paged_use_kernel(cfg),
        splits=cache.get("splits"))
    ctx.state_out[cfg.name] = {"k_pages": ck, "v_pages": cv,
                               "page_table": cache["page_table"],
                               "pos": pos + 1}
    return _out_proj(ctx, cfg, out.reshape(S, 1, model_dim), w_o, x_arg)


def _paged_ragged_step(ctx: ForwardContext, cfg: LayerConfig,
                       x_arg: Argument, w_q, w_k, w_v, w_o, num_heads: int,
                       cache: dict) -> Argument:
    """One mixed prefill/decode step: the input is a packed ragged token
    list [1, T, model_dim]; row r is one token of table row
    cache["row_slot"][r] at global position cache["row_pos"][r].  Emits the
    (in-place updated) pools through ctx.state_out.  cache["splits"], when
    given, pins the kernel's split count."""
    x = x_arg.value
    B, T, model_dim = x.shape
    if B != 1:
        raise ValueError(f"layer {cfg.name!r}: the mixed paged step packs "
                         f"all query rows into one batch row (got B={B})")
    h_kv = int(cfg.attrs.get("num_kv_heads", 0) or num_heads)
    row_pos = cache["row_pos"]
    q, k, v = _project(x[0], w_q, w_k, w_v, num_heads, h_kv)
    if bool(cfg.attrs.get("use_rope", False)):
        theta = float(cfg.attrs.get("rope_theta", 10000.0))
        q = rope(q[None], row_pos, theta)[0]
        k = rope(k[None], row_pos, theta)[0]
    out, ck, cv = ragged_paged_attention_step(
        q, k, v, cache["k_pages"], cache["v_pages"], cache["page_table"],
        cache["row_slot"], row_pos, window=_window(cfg),
        use_kernel=_paged_use_kernel(cfg), splits=cache.get("splits"))
    ctx.state_out[cfg.name] = {"k_pages": ck, "v_pages": cv,
                               "page_table": cache["page_table"],
                               "row_slot": cache["row_slot"],
                               "row_pos": row_pos}
    return _out_proj(ctx, cfg, out.reshape(1, T, model_dim), w_o, x_arg)


@register_layer("additive_attention_step")
def additive_attention_step_layer(ctx: ForwardContext,
                                  cfg: LayerConfig) -> Argument:
    """One Bahdanau attention step inside a decoder group.  inputs:
    [decoder state [B, Ds] (carries W [Ds, D]), encoded_proj [B, T, D]
    (carries v [D, 1]), encoded_sequence [B, T, Dv]]; output: context
    [B, Dv].  The keys' lengths come from encoded_proj, else from
    encoded_sequence (all keys when neither is a sequence)."""
    dec, proj, seq = (ctx.get_input(cfg, i) for i in range(3))
    w = ctx.param_of(cfg, 0)
    v = ctx.param_of(cfg, 1).reshape(-1)
    keys = proj if proj.lengths is not None else seq
    if str(cfg.attrs.get("attn_impl", "auto")) == "dense":
        out = additive_attention_step(dec.value, w, v, proj.value, seq.value,
                                      keys.mask())
    else:
        lengths = keys.lengths
        if lengths is None:
            B, T = proj.value.shape[:2]
            lengths = torch.full((B,), T, dtype=torch.int32,
                                 device=proj.value.device)
        out = additive_ops.additive_attention(dec.value, w, v, proj.value,
                                              seq.value, lengths)
    return finish_layer(ctx, cfg, out, like=dec)
