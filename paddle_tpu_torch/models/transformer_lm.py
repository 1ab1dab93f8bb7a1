"""Decoder-only transformer LM config builders: the port's parse of
demo/model_zoo/transformer_lm.py.

Pre-norm blocks: h = h + MHA(LN(h)) with rotary positions, then
h = h + W2 gelu(W1 LN(h)); a final layer norm feeds a softmax `lm_head`.
The compute dtype is not part of the model: pass it to
`GraphExecutor(model, compute_dtype=...)`, or take
`transformer_lm_trainer_config`, whose optimization settings are the demo
config's `settings(...)` (Adam, learning rate 3e-4, elementwise gradient
clipping at 1.0) and whose data source is the demo's provider
(demo/model_zoo/lm_provider.py).
"""

from __future__ import annotations

from paddle_tpu_torch.config.schema import ModelConfig, TrainerConfig
from paddle_tpu_torch.models.demos import parse_demo

CONFIG = "model_zoo/transformer_lm.py"


def transformer_lm_config(vocab: int, dim: int, layers: int, heads: int,
                          kv_heads: int = 0, window: int = 0,
                          ffn_mult: int = 4, attn_impl: str = "auto",
                          block_k_min: int = 0) -> ModelConfig:
    """The transformer LM graph.  `kv_heads=0` is full multi-head
    attention, `window=0` full (not sliding-window) attention, and
    `block_k_min=0` the default dense/flash crossover."""
    return transformer_lm_trainer_config(
        vocab, dim, layers, heads, kv_heads=kv_heads, window=window,
        ffn_mult=ffn_mult, attn_impl=attn_impl,
        block_k_min=block_k_min).model_config


def transformer_lm_trainer_config(vocab: int, dim: int, layers: int,
                                  heads: int, batch_size: int = 16,
                                  compute_dtype: str = "",
                                  **model_kw) -> TrainerConfig:
    """The `TrainerConfig` of demo/model_zoo/transformer_lm.py with these
    config args (the model keywords of `transformer_lm_config` pass
    through)."""
    kv_heads = model_kw.get("kv_heads", 0)
    if dim % heads:
        raise ValueError(f"dim {dim} must divide into {heads} heads")
    if kv_heads and heads % kv_heads:
        raise ValueError(f"kv_heads {kv_heads} must divide heads {heads}")
    if (dim // heads) % 2:
        raise ValueError(f"rotary positions need an even head dim, got "
                         f"{dim // heads}")
    return parse_demo(CONFIG, vocab=vocab, dim=dim, layers=layers,
                      heads=heads, batch_size=batch_size,
                      compute_dtype=compute_dtype, **model_kw)
