"""The attention seq2seq network, built without the config DSL.

`seq2seq_trainer_config` builds the `TrainerConfig` that
`parse_config("demo/seqToseq/seqToseq_net.py", ...)` produces on the JAX
side (the reference's demo/seqToseq/seqToseq_net.py): the same layer names,
types, attrs, recurrent sub-model, memories, generator, parameter names,
dims and init, in the same order, and the demo's `settings(...)` (Adam,
learning rate 5e-4, L2 3.2e-3, elementwise gradient clipping at 25).  The
data provider is not ported, so the config names no data source: batches go
to `Trainer.train_one_pass(batches=...)` as {"source_language_word",
"target_language_word", "target_language_next_word": ids [B, T] + lengths},
and `generate` takes {"source_language_word": ...}.

Encoder: a `hidden_dim` embedding of the source words, a forward and a
reversed `simple_gru` (a mixed full-matrix projection to 3 x hidden, then
`gated_recurrent`), their concat, its projection to hidden (encoded_proj),
and the decoder's boot state (tanh projection of the reversed GRU's first
step).  Decoder: the recurrent group "decoder_group" over the target
embedding with the encoder outputs as static links and the memory
"gru_decoder" — per step `additive_attention_step`, the mixed
decoder_inputs (context and word, each projected to 3 x hidden), `gru_step`
and the softmax over the vocabulary, decoder_prob.  Training ends in the
classification cost against the next words; generation replaces the target
embedding with the embedding of the previous generated word (the id memory
booted with BOS = 0) and beam-searches for EOS = 1.
"""

from __future__ import annotations

from paddle_tpu_torch.config.schema import (
    GeneratorConfig,
    LayerInput,
    MemoryConfig,
    OptimizationConfig,
    ProjectionConfig,
    SubModelConfig,
    TrainerConfig,
)
from paddle_tpu_torch.models.net import Net

BOS_ID, EOS_ID = 0, 1


def _proj(n_in: int, n_out: int, type_: str = "fc") -> ProjectionConfig:
    return ProjectionConfig(type=type_, input_size=n_in, output_size=n_out)


def seq2seq_trainer_config(dict_size: int, hidden_dim: int = 64,
                           batch_size: int = 0, is_generating: bool = False,
                           beam_size: int = 3, max_length: int = 12,
                           compute_dtype: str = "") -> TrainerConfig:
    """demo/seqToseq/seqToseq_net.py with these config args (batch_size 0:
    the demo's default, 32 for training and 8 for generation)."""
    net = Net()
    hid = hidden_dim
    zero_bias = dict(initial_strategy="zero")

    def embedding(data: str, param: str) -> str:
        w = net.param(param, [dict_size, hid], initial_smart=True)
        return net.layer(net.auto_name("mixed"), "mixed", hid, [LayerInput(
            data, w, _proj(dict_size, hid, "table"))])

    def projection(x: str, size: int, act: str = "") -> str:
        name = net.auto_name("mixed")
        w = net.param(f"_{name}.w0", [net.size(x), size], initial_smart=True)
        return net.layer(name, "mixed", size,
                         [LayerInput(x, w, _proj(net.size(x), size))],
                         act=act)

    def simple_gru(x: str, reverse: bool) -> str:
        x3 = projection(x, 3 * hid)
        name = net.auto_name("gru")
        w = net.param(f"_{name}.w0", [hid, 3 * hid], initial_smart=True)
        b = net.param(f"_{name}.wbias", [1, 3 * hid], **zero_bias)
        return net.layer(name, "gated_recurrent", hid, [LayerInput(x3, w)],
                         bias=b, act="tanh", reversed=reverse,
                         attrs={"active_gate_type": "sigmoid"})

    # -- encoder
    src = net.layer("source_language_word", "data", dict_size, [])
    src_emb = embedding(src, "_source_language_embedding")
    src_fwd = simple_gru(src_emb, False)
    src_bwd = simple_gru(src_emb, True)
    encoded = net.layer(net.auto_name("concat"), "concat", 2 * hid,
                        [LayerInput(src_fwd), LayerInput(src_bwd)])
    encoded_proj = projection(encoded, hid)
    first = net.layer(net.auto_name("seqfirstins"), "seqlastins", hid,
                      [LayerInput(src_bwd)], select_first=True)
    boot = projection(first, hid, act="tanh")

    # -- the decoder group
    group = SubModelConfig(name="decoder_group",
                           is_recurrent_layer_group=True)
    members = []

    def member(name: str, type_: str, size: int, inputs=(), **kw) -> str:
        members.append(net.layer(name, type_, size, list(inputs), **kw))
        return name

    if not is_generating:
        trg = net.layer("target_language_word", "data", dict_size, [])
        trg_emb = embedding(trg, "_target_language_embedding")
    statics = []
    for outer in (encoded, encoded_proj):
        statics.append(member(f"__static_{outer}_0__", "agent",
                              net.size(outer)))
        group.static_links.append(outer)
        group.static_link_layers.append(statics[-1])
    if is_generating:
        id_mem = member("__memory_anon_0__", "agent", dict_size)
        group.memories.append(MemoryConfig(
            link_name="decoder_prob", layer_name=id_mem,
            boot_with_const_id=BOS_ID, size=dict_size))
        w = net.param("_target_language_embedding", [dict_size, hid],
                      initial_smart=True)
        word = member("__gen_emb_0__", "mixed", hid, [LayerInput(
            id_mem, w, _proj(dict_size, hid, "table"))])
        group.generator = GeneratorConfig(
            max_num_frames=max_length, beam_size=beam_size, eos_id=EOS_ID,
            bos_id=BOS_ID, num_results_per_sample=beam_size,
            prob_layer_name="decoder_prob", id_memory_layer_name=id_mem)
    else:
        word = member(f"__inlink_{trg_emb}_0__", "scatter_agent", hid)
        group.in_links.append(trg_emb)
        group.in_link_layers.append(word)
    mem = member("__memory_gru_decoder_0__", "agent", hid)
    group.memories.append(MemoryConfig(
        link_name="gru_decoder", layer_name=mem, boot_layer_name=boot,
        size=hid))

    w_state = net.param("_attention_transform.w0", [hid, hid],
                        initial_smart=True)
    w_score = net.param("_attention_scores.w0", [hid, 1], initial_smart=True)
    context = member("attention", "additive_attention_step", 2 * hid, [
        LayerInput(mem, w_state), LayerInput(statics[1], w_score),
        LayerInput(statics[0])])
    w_ctx = net.param("_decoder_inputs.w0", [2 * hid, 3 * hid],
                      initial_smart=True)
    w_word = net.param("_decoder_inputs.w1", [hid, 3 * hid],
                       initial_smart=True)
    inputs = member("decoder_inputs", "mixed", 3 * hid, [
        LayerInput(context, w_ctx, _proj(2 * hid, 3 * hid)),
        LayerInput(word, w_word, _proj(hid, 3 * hid))])
    w_gru = net.param("_gru_decoder.w0", [hid, 3 * hid], initial_smart=True)
    b_gru = net.param("_gru_decoder.wbias", [1, 3 * hid], **zero_bias)
    gru = member("gru_decoder", "gru_step", hid,
                 [LayerInput(inputs, w_gru), LayerInput(mem)], bias=b_gru,
                 act="tanh", attrs={"active_gate_type": "sigmoid"})
    w_out = net.param("_decoder_prob.w0", [hid, dict_size],
                      initial_smart=True)
    b_out = net.param("_decoder_prob.wbias", [1, dict_size], **zero_bias)
    prob = member("decoder_prob", "mixed", dict_size,
                  [LayerInput(gru, w_out, _proj(hid, dict_size))],
                  bias=b_out, act="softmax")
    group.layer_names = members
    group.output_layer_names = [prob]

    m = net.model
    m.sub_models = [group]
    if is_generating:
        m.type = "recurrent_nn"
        m.input_layer_names = [src]
        m.output_layer_names = [prob]
    else:
        nxt = net.layer("target_language_next_word", "data", dict_size, [])
        m.input_layer_names = [src, trg, nxt]
        m.output_layer_names = [net.classification_cost(prob, nxt)]
    opt = OptimizationConfig(
        batch_size=batch_size or (8 if is_generating else 32),
        learning_method="adam", learning_rate=5e-4,
        learning_rate_schedule="poly", l2_weight=1e-4 * 32,
        gradient_clipping_threshold=25.0, compute_dtype=compute_dtype)
    return TrainerConfig(model_config=m, opt_config=opt)
