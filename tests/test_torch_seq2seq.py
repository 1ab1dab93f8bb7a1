"""PyTorch port: the attention seq2seq of demo/seqToseq/seqToseq_net.py
against the JAX package on the CPU — the training and generating configs,
the TEST forward, one TRAIN step's gradients, three Adam steps of the
Trainer, test(), checkpoints in both directions and the beam search — and
the recurrent-group executor on the flat test configs (a reversed group, a
group with an id in-link, a group with nothing to defer).

Small size: vocabulary 32, hidden 16, B = 4, source length 6 with ragged
lengths, sources and targets of the sequence-reversal language of
demo/seqToseq/seq_provider.py.  On CPU tensors the port's gated_recurrent
runs the GRU kernels' plain version and the attention step the additive
kernel's plain version; the JAX side runs its lax.scan routes.  The demo's
zero-initialised biases are made non-zero first, so that every gradient
path carries signal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.graph.builder import GraphExecutor as JExecutor
from paddle_tpu.graph.generator import generate as jgenerate
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.schema import TrainerConfig
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.generator import (BeamSearchControls, generate,
                                              _gather_beam, _tile_beam)
from paddle_tpu_torch.models import seq2seq_trainer_config
from paddle_tpu_torch.ops import additive_attention as aa
from paddle_tpu_torch.ops import gru_fused as gf
from paddle_tpu_torch.parameter import (Argument, opt_state_from_jax,
                                        params_from_jax)
from paddle_tpu_torch.trainer import Trainer

CONFIG = "demo/seqToseq/seqToseq_net.py"
V, H, B, TS = 32, 16, 4, 6
LENS = np.array([6, 3, 5, 1], np.int32)
TRAIN_ARGS = f"dict_size={V},hidden_dim={H},batch_size={B}"
GEN_ARGS = f"dict_size={V},hidden_dim={H},is_generating=1,beam_size=3," \
           f"max_length=12"


def _batches(n, seed=0):
    """Reversal-language batches as numpy: (source, target, next words)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        src = rng.integers(3, V, (B, TS)).astype(np.int32)
        trg = np.zeros((B, TS + 1), np.int32)
        nxt = np.ones((B, TS + 1), np.int32)
        for b in range(B):
            rev = src[b, :LENS[b]][::-1]
            trg[b, 1:LENS[b] + 1] = rev
            nxt[b, :LENS[b]] = rev
        out.append((src, trg, nxt))
    return out


NAMES = ("source_language_word", "target_language_word",
         "target_language_next_word")


def _jbatch(b):
    lens = (LENS, LENS + 1, LENS + 1)
    return {n: JArgument(ids=jnp.asarray(x), lengths=jnp.asarray(l))
            for n, x, l in zip(NAMES, b, lens)}


def _tbatch(b):
    lens = (LENS, LENS + 1, LENS + 1)
    return {n: Argument(ids=x, lengths=l) for n, x, l in zip(NAMES, b, lens)}


def _np_params(jtr):
    return {k: np.asarray(v) for k, v in jtr.params.items()}


def _pair(seed):
    """A JAX Trainer and a port Trainer from the same parameters."""
    jtr = JTrainer(parse_config(CONFIG, TRAIN_ARGS), seed=seed)
    rng = np.random.default_rng(seed)
    for name, v in jtr.params.items():
        if not np.asarray(v).any():
            jtr.params[name] = jnp.asarray(
                rng.standard_normal(v.shape).astype(np.float32) * 0.1)
    ttr = Trainer(seq2seq_trainer_config(V, H, B), device="cpu",
                  params=params_from_jax(_np_params(jtr), device="cpu"))
    return jtr, ttr


@pytest.mark.parametrize("args,kw", [
    (TRAIN_ARGS, dict(dict_size=V, hidden_dim=H, batch_size=B)),
    (GEN_ARGS, dict(dict_size=V, hidden_dim=H, is_generating=True,
                    beam_size=3, max_length=12)),
    ("dict_size=30000,hidden_dim=512,batch_size=64",
     dict(dict_size=30000, hidden_dim=512, batch_size=64)),
    ("dict_size=30000,hidden_dim=512,is_generating=1,beam_size=3,"
     "max_length=30",
     dict(dict_size=30000, hidden_dim=512, is_generating=True, beam_size=3,
          max_length=30)),
    (f"dict_size={V},compute_dtype=bfloat16",
     dict(dict_size=V, compute_dtype="bfloat16")),
], ids=["train", "generate", "full-width-train", "full-width-generate",
        "defaults-bf16"])
def test_builder_equals_the_dsl_parse(args, kw):
    """The model and optimization configs — the whole to_dict() form,
    sub-model, memories and generator included — equal the DSL parse of
    demo/seqToseq/seqToseq_net.py."""
    want = parse_config(CONFIG, args)
    got = seq2seq_trainer_config(**kw)
    assert got.model_config.to_dict() == want.model_config.to_dict()
    assert got.opt_config.to_dict() == want.opt_config.to_dict()


def test_full_width_graph_census():
    """The main path's configuration: 22 layers (three of them data
    layers) and 18 parameters for training; the decoder group's static
    links, in-link and memory; the vocabulary softmax deferred out of the
    step loop; the generating config's id memory and generator."""
    m = seq2seq_trainer_config(30000, 512, 64).model_config
    assert len(m.layers) == 22 and len(m.parameters) == 18
    assert [l.type for l in m.layers if l.type == "gated_recurrent"] == \
        ["gated_recurrent"] * 2
    assert m.parameter("___gru_0__.w0").dims == [512, 1536]
    assert m.parameter("_decoder_prob.w0").dims == [512, 30000]
    (sm,) = m.sub_models
    assert sm.static_links == ["__concat_0__", "__mixed_3__"]
    assert sm.in_links == ["__mixed_5__"]
    assert [(x.link_name, x.boot_layer_name) for x in sm.memories] == \
        [("gru_decoder", "__mixed_4__")]
    spec = GraphExecutor(m)._split_deferred(sm)
    assert spec["deferred"] == {"decoder_prob"}
    assert spec["emit"] == {"gru_decoder"}
    g = seq2seq_trainer_config(30000, 512, is_generating=True, beam_size=3,
                               max_length=30).model_config
    (gsm,) = g.sub_models
    assert gsm.generator.id_memory_layer_name == "__memory_anon_0__"
    assert (gsm.generator.bos_id, gsm.generator.eos_id,
            gsm.generator.log_prob, gsm.generator.beam_size,
            gsm.generator.max_num_frames) == (0, 1, True, 3, 30)
    assert GraphExecutor(g)._split_deferred(gsm) is None


def test_test_forward_matches_jax():
    """TEST forward on a ragged batch: decoder_prob within 1e-5, rows that
    sum to 1; two GRU plain runs (the encoder) and one additive-attention
    plain run per decoder step."""
    jtr, ttr = _pair(seed=3)
    b = _batches(1, seed=1)[0]
    want, _, _ = jtr.executor.forward(jtr.params, _jbatch(b), None, "test")
    gf.counts.reset()
    aa.counts.reset()
    out, costs, _ = ttr.executor.forward(ttr.params,
                                         ttr.prepare_batch(_tbatch(b)))
    assert (gf.counts.plain, aa.counts.plain, aa.counts.kernel) == \
        (2, TS + 1, 0)
    for name in ("__gru_0__", "__gru_1__", "__mixed_3__", "__mixed_4__",
                 "decoder_prob"):
        np.testing.assert_allclose(out[name].value.numpy(),
                                   np.asarray(want[name].value), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    prob = out["decoder_prob"].value
    assert prob.shape == (B, TS + 1, V)
    np.testing.assert_allclose(prob.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(out["decoder_prob"].lengths, torch.from_numpy(LENS + 1))
    (cost,) = costs.values()
    assert cost.shape == (B,)


def test_one_train_step_gradients_match_jax():
    """One TRAIN step: the loss within rtol 1e-5, every parameter's
    gradient within 1e-4 of its own scale (float32, another summation
    order); the attention's backward recomputes once per decoder step."""
    jtr, ttr = _pair(seed=5)
    b = _batches(1, seed=2)[0]
    want_loss, jgrads = jax.value_and_grad(
        lambda p: jtr.executor.loss(p, _jbatch(b), {}, "train")[0])(
            jtr.params)
    aa.counts.reset()
    loss, grads, _ = ttr.compute_gradients(ttr.prepare_batch(_tbatch(b)))
    assert aa.counts.recompute == TS + 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(jgrads) and len(grads) == 18
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want,
                                   atol=1e-7 + 1e-4 * scale, rtol=0,
                                   err_msg=name)


def test_three_adam_steps_and_test_match_the_jax_trainer():
    """Three Trainer steps (Adam at 5e-4, L2 3.2e-3, clipping at 25): the
    per-step losses within rtol 1e-5, the classification error equal; then
    Trainer.test() on two batches: cost within rtol 1e-5, error equal."""
    jtr, ttr = _pair(seed=7)
    jl, tl = [], []
    for b in _batches(3, seed=4):
        jl.append(float(jtr.train_one_batch(_jbatch(b))))
        tl.append(float(ttr.train_one_batch(_tbatch(b))))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jerr = jtr.evaluators.finalize(jtr._acc)["classification_error"]
    terr = ttr.evaluators.finalize(ttr._acc)["classification_error"]
    assert terr == pytest.approx(jerr, abs=1e-12)
    assert ttr.opt_state["num_updates"] == 3
    batches = _batches(2, seed=6)
    jt = jtr.test(iter([_jbatch(b) for b in batches]))
    tt = ttr.test([_tbatch(b) for b in batches])
    assert tt["cost"] == pytest.approx(jt["cost"], rel=1e-5)
    assert tt["classification_error"] == pytest.approx(
        jt["classification_error"], abs=1e-12)


def test_checkpoints_load_on_both_sides(tmp_path):
    """A JAX save() of the seq2seq loads in the port (parameters, Adam
    slots, counters; the [D, 3D] GRU weights by name) and the reverse."""
    jtr = JTrainer(parse_config(CONFIG, TRAIN_ARGS), seed=3)
    b1, b2 = _batches(2, seed=8)
    jtr.train_one_pass(iter([_jbatch(b1)]))
    jdir = jtr.save(str(tmp_path / "jax"))
    ttr = Trainer(seq2seq_trainer_config(V, H, B), device="cpu", seed=21)
    ttr.load(jdir)
    assert ttr.pass_id == jtr.pass_id == 1
    for n, v in jtr.params.items():
        np.testing.assert_array_equal(ttr.params[n].numpy(), np.asarray(v))
    want = opt_state_from_jax(jax.tree.map(np.asarray, jtr.opt_state),
                              device="cpu")
    for n, slots in want["slots"].items():
        for k, v in slots.items():
            assert torch.equal(ttr.opt_state["slots"][n][k], v), (n, k)

    ttr.train_one_pass([_tbatch(b2)])
    tdir = ttr.save(str(tmp_path / "port"))
    back = JTrainer(parse_config(CONFIG, TRAIN_ARGS), seed=9)
    back.load(tdir)
    for n, v in ttr.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[n]), v.numpy())
    assert int(back.opt_state["num_updates"]) == 2


def _gen_feed(seed=11):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, V, (B, TS)).astype(np.int32)
    return src


def test_generate_matches_jax():
    """Beam search at beam 3, max_length 12 on the same parameters and
    sources: ids exactly the JAX generate's, scores within 1e-5, beams
    best-first, EOS after a path's first EOS; the encoder runs the GRU
    plain version twice, the attention once per step; a second call gives
    the same ids."""
    jtr, ttr = _pair(seed=13)
    src = _gen_feed()
    gcfg = parse_config(CONFIG, GEN_ARGS)
    jex = JExecutor(gcfg.model_config)
    jparams = {p.name: jtr.params[p.name]
               for p in gcfg.model_config.parameters}
    ids, scores = jgenerate(jex, jparams, {"source_language_word": JArgument(
        ids=jnp.asarray(src), lengths=jnp.asarray(LENS))})
    tex = GraphExecutor(seq2seq_trainer_config(
        V, H, is_generating=True, beam_size=3, max_length=12).model_config)
    feed = {"source_language_word": Argument(ids=src, lengths=LENS)}
    gf.counts.reset()
    aa.counts.reset()
    tids, tscores = generate(tex, ttr.params, feed)
    assert (gf.counts.plain, aa.counts.plain) == (2, 12)
    assert tids.shape == (B, 3, 12) and tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(scores),
                               rtol=1e-5, atol=1e-5)
    assert bool((tscores[:, :-1] >= tscores[:, 1:]).all())
    eos_seen = torch.cumsum((tids == 1).long(), dim=-1)
    assert bool((tids[eos_seen > 0] == 1).all())
    again, _ = generate(tex, ttr.params, feed)
    assert torch.equal(again, tids)


def test_generate_controls_and_beam_helpers():
    """The search's hooks are plain callables: a ban of every word but EOS
    from step 0 ends each path at once, on_step sees every step, and the
    norm_path hook replaces the final scores.  The beam helpers tile and
    re-gather rows."""
    _, ttr = _pair(seed=17)
    tex = GraphExecutor(seq2seq_trainer_config(
        V, H, is_generating=True, beam_size=2, max_length=5).model_config)
    feed = {"source_language_word": Argument(ids=_gen_feed(), lengths=LENS)}
    steps = []

    def only_eos(step, tokens, logp):
        keep = torch.full_like(logp, -1e9)
        keep[..., 1] = logp[..., 1]
        return keep

    ctl = BeamSearchControls(adjust_logp=only_eos, on_step=steps.append,
                             norm_path=lambda s, n: s / n)
    ids, scores = generate(tex, ttr.params, feed, controls=ctl)
    assert steps == list(range(5))
    assert bool((ids[:, 0] == 1).all())
    x = torch.arange(6).reshape(3, 2)
    tiled = _tile_beam(x, 2)
    assert tiled.tolist() == [[0, 1], [0, 1], [2, 3], [2, 3], [4, 5], [4, 5]]
    parent = torch.tensor([[1, 1], [0, 1], [1, 0]])
    rows = torch.arange(6)[:, None].expand(6, 2)
    assert _gather_beam(rows, parent, 3, 2)[:, 0].tolist() == \
        [1, 1, 2, 3, 5, 4]
    with pytest.raises(ValueError, match="generator"):
        generate(GraphExecutor(seq2seq_trainer_config(V, H).model_config),
                 ttr.params, feed)


# -- the recurrent-group executor on flat DSL configs ------------------------

REVERSED_RNN = '''
from paddle_tpu.dsl import *
settings(batch_size=2, learning_rate=0.01)
data = data_layer(name="word", size=10)
emb = embedding_layer(input=data, size=8)


def step(y):
    mem = memory(name="rnn_state", size=8)
    state = fc_layer(input=[y, mem], size=8, act=TanhActivation(),
                     bias_attr=True, name="rnn_state")
    return fc_layer(input=state, size=6, act=SigmoidActivation(),
                    name="readout")


out = recurrent_group(name="rnn", step=step, input=emb, reverse=True)
rep = last_seq(input=out)
prob = fc_layer(size=3, input=rep, act=SoftmaxActivation(), bias_attr=True)
classification_cost(input=prob, label=data_layer(name="label", size=3))
'''


def _executor_params(ex, params):
    """A JAX executor's parameters as numpy, in its config's order."""
    return {p.name: np.asarray(params[p.name]) for p in ex.model.parameters}


def _group_config(path):
    cfg = parse_config(str(path), "")
    return cfg, TrainerConfig.from_json(cfg.to_json())


@pytest.mark.parametrize("which", ["reversed", "flat", "id-in-link"])
def test_recurrent_group_matches_jax(which, tmp_path):
    """The scan executor on three flat groups against the JAX executor:
    a reversed group whose readout layer is deferred out of the loop, the
    flat group of tests/configs/sequence_rnn.py (its output is its memory:
    nothing to defer), and tests/configs/sequence_rnn_multi_input.py (an id
    in-link embedded inside the step).  Ragged lengths with a length-1 row;
    the group's output sequence within 1e-5, the loss within rtol 1e-5,
    every gradient within 1e-4 of its scale."""
    if which == "reversed":
        path = tmp_path / "reversed_rnn.py"
        path.write_text(REVERSED_RNN)
    else:
        path = {"flat": "tests/configs/sequence_rnn.py",
                "id-in-link": "tests/configs/sequence_rnn_multi_input.py"}[
                    which]
    jcfg, tcfg = _group_config(path)
    (sm,) = tcfg.model_config.sub_models
    ex = GraphExecutor(tcfg.model_config)
    spec = ex._split_deferred(sm)
    if which == "reversed":
        assert sm.reversed and spec["deferred"] == {"readout"}
    else:
        assert spec is None
    jtr = JTrainer(jcfg, seed=4)
    rng = np.random.default_rng(4)
    for name, v in jtr.params.items():
        jtr.params[name] = jnp.asarray(
            rng.standard_normal(v.shape).astype(np.float32) * 0.5)
    params = params_from_jax(_np_params(jtr), device="cpu")
    ids = rng.integers(0, 10, (3, 5)).astype(np.int32)
    lens = np.array([5, 1, 3], np.int32)
    label = np.array([0, 2, 1], np.int32)
    jb = {"word": JArgument(ids=jnp.asarray(ids), lengths=jnp.asarray(lens)),
          "label": JArgument(ids=jnp.asarray(label))}
    tb = {"word": Argument(ids=torch.from_numpy(ids).long(),
                           lengths=torch.from_numpy(lens)),
          "label": Argument(ids=torch.from_numpy(label).long())}
    want, _, _ = jtr.executor.forward(jtr.params, jb, None, "test")
    got, _, _ = ex.forward(params, tb)
    out_name = sm.output_layer_names[0]
    np.testing.assert_allclose(got[out_name].value.numpy(),
                               np.asarray(want[out_name].value), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got[out_name].lengths, torch.from_numpy(lens))
    want_loss, jgrads = jax.value_and_grad(
        lambda p: jtr.executor.loss(p, jb, {}, "train")[0])(jtr.params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = ex.loss(leaves, tb, mode="train")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for name, g in grads.items():
        w = np.asarray(jgrads[name])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=1e-7 + 1e-4 * scale,
                                   rtol=0, err_msg=name)


def test_group_paths_not_ported_raise():
    """Groups nested in groups, nested (SubsequenceInput, [B, S, T, ...])
    in-links and sparse in-links run as the JAX executor runs them: the
    nested config's out-link ([B, S, T, D] with the feed's sub_lengths) and
    the flat group's output over sparse rows (the fc in its step gathering
    the rows they touch) within 1e-5.  The GEN mode belongs to generate(),
    not to forward()."""
    from paddle_tpu.graph.context import ForwardContext as JContext
    rng = np.random.default_rng(2)
    jcfg = parse_config("tests/configs/sequence_nest_rnn.py", "")
    nested = TrainerConfig.from_json(jcfg.to_json()).model_config
    jex = JExecutor(jcfg.model_config)
    jparams = jex.init_params(jax.random.PRNGKey(1))
    nparams = params_from_jax(_executor_params(jex, jparams), device="cpu")
    ids = rng.integers(0, 10, (2, 2, 3)).astype(np.int32)
    n_sub, sub = np.array([2, 1], np.int32), np.array([[3, 1], [2, 0]],
                                                        np.int32)
    want, _, _ = jex.forward(jparams, {"word": JArgument(
        ids=jnp.asarray(ids), lengths=jnp.asarray(n_sub),
        sub_lengths=jnp.asarray(sub))}, None, "test")
    got, _, _ = GraphExecutor(nested).forward(nparams, {"word": Argument(
        ids=torch.from_numpy(ids).long(), lengths=torch.from_numpy(n_sub),
        sub_lengths=torch.from_numpy(sub))})
    (outer,) = [sm for sm in nested.sub_models if not sm.parent]
    name = outer.output_layer_names[0]
    np.testing.assert_allclose(got[name].value.numpy(),
                               np.asarray(want[name].value), rtol=1e-5,
                               atol=1e-5)
    assert got[name].value.shape == (2, 2, 3, 8)
    assert torch.equal(got[name].sub_lengths, torch.from_numpy(sub))

    jflat, tcfg = _group_config("tests/configs/sequence_rnn.py")
    ex = GraphExecutor(tcfg.model_config)
    jfex = JExecutor(jflat.model_config)
    jfparams = jfex.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(_executor_params(jfex, jfparams), device="cpu")
    lens = torch.tensor([2, 1])
    (sm,) = ex.model.sub_models
    cols = rng.integers(0, 8, (2, 2, 3)).astype(np.int32)
    vals = rng.standard_normal((2, 2, 3)).astype(np.float32)
    ctx = ForwardContext(model=ex.model, params=params, mode="test")
    ctx.outputs[sm.in_links[0]] = Argument(
        ids=torch.from_numpy(cols).long(), sparse_vals=torch.from_numpy(vals),
        sparse_dim=8, lengths=lens)
    jctx = JContext(model=jfex.model, params=jfparams, mode="test")
    jctx.outputs[sm.in_links[0]] = JArgument(
        ids=jnp.asarray(cols), sparse_vals=jnp.asarray(vals), sparse_dim=8,
        lengths=jnp.asarray(lens.numpy()))
    ex._run_scan(ctx, sm)
    jfex._run_scan(jctx, jfex._sub_by_name[sm.name])
    out = sm.output_layer_names[0]
    np.testing.assert_allclose(ctx.outputs[out].value.numpy(),
                               np.asarray(jctx.outputs[out].value),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        ex.forward(params, {"word": Argument(ids=torch.zeros(
            2, 2, dtype=torch.long), lengths=lens)}, mode="gen")
