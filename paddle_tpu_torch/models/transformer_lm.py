"""Decoder-only transformer LM config builder.

Builds, without the config DSL, the `ModelConfig` that
`parse_config("demo/model_zoo/transformer_lm.py", args).model_config`
produces on the JAX side: the same layer names, types, attrs, parameter
names, dims and init attrs, in the same order.  Pre-norm blocks:
h = h + MHA(LN(h)) with rotary positions, then h = h + W2 gelu(W1 LN(h));
a final layer norm feeds a softmax `lm_head`.  The compute dtype is not
part of the model: pass it to `GraphExecutor(model, compute_dtype=...)`,
or take `transformer_lm_trainer_config`, whose optimization settings are
the demo config's `settings(...)` (Adam, learning rate 3e-4, elementwise
gradient clipping at 1.0).
"""

from __future__ import annotations

from paddle_tpu_torch.config.schema import (
    EvaluatorConfig,
    LayerConfig,
    LayerInput,
    ModelConfig,
    OptimizationConfig,
    ParameterConfig,
    ProjectionConfig,
    TrainerConfig,
)


def transformer_lm_config(vocab: int, dim: int, layers: int, heads: int,
                          kv_heads: int = 0, window: int = 0,
                          ffn_mult: int = 4, attn_impl: str = "auto",
                          block_k_min: int = 0) -> ModelConfig:
    """The transformer LM graph.  `kv_heads=0` is full multi-head
    attention, `window=0` full (not sliding-window) attention, and
    `block_k_min=0` the default dense/flash crossover."""
    if dim % heads:
        raise ValueError(f"dim {dim} must divide into {heads} heads")
    if kv_heads and heads % kv_heads:
        raise ValueError(f"kv_heads {kv_heads} must divide heads {heads}")
    if (dim // heads) % 2:
        raise ValueError(f"rotary positions need an even head dim, got "
                         f"{dim // heads}")
    model = ModelConfig()
    params = model.parameters

    def param(name: str, dims: list[int], **init) -> str:
        size = 1
        for d in dims:
            size *= d
        params.append(ParameterConfig(name=name, size=size, dims=list(dims),
                                      **init))
        return name

    def layer(name: str, type_: str, size: int, inputs: list[LayerInput],
              bias: str = "", act: str = "", **attrs) -> str:
        model.layers.append(LayerConfig(
            name=name, type=type_, size=size, active_type=act, inputs=inputs,
            bias_parameter_name=bias, attrs=attrs))
        return name

    def layer_norm(name: str, x: str) -> str:
        w = param(f"_{name}.w0", [1, dim], initial_mean=1.0, initial_std=0.0)
        b = param(f"_{name}.wbias", [1, dim], initial_strategy="zero")
        return layer(name, "layer_norm", dim, [LayerInput(x, w)], bias=b)

    def fc(name: str, x: str, size: int, act: str, bias: bool) -> str:
        in_size = model.layer(x).size
        w = param(f"_{name}.w0", [in_size, size], initial_std=0.02)
        b = param(f"_{name}.wbias", [1, size], initial_strategy="zero") \
            if bias else ""
        return layer(name, "fc", size, [LayerInput(x, w)], bias=b, act=act)

    tokens = layer("tokens", "data", vocab, [])
    emb = param("_tok_embedding", [vocab, dim], initial_std=0.02)
    h = layer("__mixed_0__", "mixed", dim, [LayerInput(
        tokens, emb, ProjectionConfig(type="table", input_size=vocab,
                                      output_size=dim))])
    kv_dim = dim if not kv_heads else (dim // heads) * kv_heads
    for i in range(layers):
        attn_in = layer_norm(f"blk{i}_ln1", h)
        attrs = {"num_heads": heads, "causal": True}
        if block_k_min:
            attrs["block_k_min"] = block_k_min
        if attn_impl != "auto":
            attrs["attn_impl"] = attn_impl
        if kv_heads:
            attrs["num_kv_heads"] = kv_heads
        if window:
            attrs["window"] = window
        attrs["use_rope"] = True
        attrs["rope_theta"] = 10000.0
        name = f"blk{i}_attn"
        ws = [param(f"_{name}.w{j}", [dim, out], initial_smart=True)
              for j, out in enumerate((dim, kv_dim, kv_dim, dim))]
        attn = layer(name, "multi_head_attention", dim,
                     [LayerInput(attn_in, w) for w in ws], **attrs)
        h = layer(f"blk{i}_res1", "addto", dim,
                  [LayerInput(h), LayerInput(attn)])
        ffn_in = layer_norm(f"blk{i}_ln2", h)
        ffn_h = fc(f"blk{i}_ffn1", ffn_in, dim * ffn_mult, "gelu", True)
        ffn_o = fc(f"blk{i}_ffn2", ffn_h, dim, "", True)
        h = layer(f"blk{i}_res2", "addto", dim,
                  [LayerInput(h), LayerInput(ffn_o)])
    final = layer_norm("final_ln", h)
    logits = fc("lm_head", final, vocab, "softmax", False)
    labels = layer("next_tokens", "data", vocab, [])
    cost = layer("__classification_cost_0__", "multi-class-cross-entropy", 1,
                 [LayerInput(logits), LayerInput(labels)])
    model.input_layer_names = [tokens, labels]
    model.output_layer_names = [cost]
    model.evaluators = [EvaluatorConfig(
        name=f"{cost}.classification_error",
        input_layer_names=[logits, labels])]
    return model


def transformer_lm_trainer_config(vocab: int, dim: int, layers: int,
                                  heads: int, batch_size: int = 16,
                                  compute_dtype: str = "",
                                  **model_kw) -> TrainerConfig:
    """The `TrainerConfig` of demo/model_zoo/transformer_lm.py: the model of
    `transformer_lm_config` (its keyword options pass through) and the
    `OptimizationConfig` that `parse_config` makes of the demo's
    `settings(...)`.  The data provider is not ported, so the config names
    no data source: batches go to `Trainer.train_one_pass(batches=...)`."""
    opt = OptimizationConfig(
        batch_size=batch_size, learning_method="adam", learning_rate=3e-4,
        learning_rate_schedule="poly", gradient_clipping_threshold=1.0,
        compute_dtype=compute_dtype)
    return TrainerConfig(
        model_config=transformer_lm_config(vocab, dim, layers, heads,
                                           **model_kw),
        opt_config=opt)
