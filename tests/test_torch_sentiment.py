"""PyTorch port: the IMDB sentiment LSTM nets against the JAX package on the
CPU — the configs, the TEST forward, one TRAIN step's gradients with JAX's
dropout masks, three Adam steps of the Trainer, test(), checkpoints in both
directions.

Small size: vocabulary 50, hid_dim 32 (lstm hidden 8) for the stacked net
(the bidirectional net keeps its fixed hidden 128), B = 4, T = 9, ragged
lengths.  On CPU tensors the port's lstmemory runs the kernels' plain
version; the JAX side runs its lax.scan route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.graph import TEST, GraphExecutor
from paddle_tpu_torch.models import (bidirectional_lstm_net_config,
                                     stacked_lstm_net_config)
from paddle_tpu_torch.ops import lstm_fused as lf
from paddle_tpu_torch.parameter import (Argument, opt_state_from_jax,
                                        params_from_jax)
from paddle_tpu_torch.trainer import Trainer

CONFIG = "demo/sentiment/trainer_config.py"
VOCAB, HID, BATCH, T = 50, 32, 4, 9
LENS = np.array([9, 4, 1, 7], np.int32)
NETS = {"stacked": (f"dict_dim={VOCAB},hid_dim={HID},batch_size={BATCH}",
                    lambda **kw: stacked_lstm_net_config(
                        VOCAB, BATCH, HID, **kw)),
        "bidi": (f"net=bidi,dict_dim={VOCAB},batch_size={BATCH}",
                 lambda **kw: bidirectional_lstm_net_config(
                     VOCAB, BATCH, **kw))}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32),
             rng.integers(0, 2, BATCH).astype(np.int32)) for _ in range(n)]


def _jbatch(b):
    return {"word": JArgument(ids=jnp.asarray(b[0]),
                              lengths=jnp.asarray(LENS)),
            "label": JArgument(ids=jnp.asarray(b[1]))}


def _tbatch(b):
    return {"word": Argument(ids=b[0], lengths=LENS),
            "label": Argument(ids=b[1])}


def _np_params(jtr):
    return {k: np.asarray(v) for k, v in jtr.params.items()}


def _pair(net, seed):
    """A JAX Trainer and a port Trainer from the same parameters.  The
    demo's zero-initialised lstm edges and biases are made non-zero first,
    so that every gradient path carries signal."""
    args, build = NETS[net]
    jtr = JTrainer(parse_config(CONFIG, args), seed=seed)
    rng = np.random.default_rng(seed)
    for name, v in jtr.params.items():
        if not np.asarray(v).any():
            jtr.params[name] = jnp.asarray(
                rng.standard_normal(v.shape).astype(np.float32) * 0.1)
    ttr = Trainer(build(), device="cpu",
                  params=params_from_jax(_np_params(jtr), device="cpu"))
    return jtr, ttr


def _jax_masks(model, key, shapes):
    """The keep-masks the JAX forward draws from `key`: one
    bernoulli(fold_in(key, k), 1 - p) per layer with drop_rate > 0, k
    counting those layers in config order (graph/common.py apply_dropout,
    ForwardContext.next_rng)."""
    masks, k = {}, 0
    for layer in model.layers:
        if layer.drop_rate > 0:
            k += 1
            masks[layer.name] = torch.from_numpy(np.array(
                jax.random.bernoulli(jax.random.fold_in(key, k),
                                     1.0 - layer.drop_rate,
                                     shapes[layer.name])))
    return masks


def _mask_shapes(model):
    return {l.name: ((BATCH, T, l.size) if l.type == "lstmemory"
                     else (BATCH, l.size))
            for l in model.layers if l.drop_rate > 0}


@pytest.mark.parametrize("args,build", [
    (f"dict_dim={VOCAB},hid_dim={HID},batch_size={BATCH}",
     lambda: stacked_lstm_net_config(VOCAB, BATCH, HID)),
    (f"net=bidi,dict_dim={VOCAB},batch_size={BATCH}",
     lambda: bidirectional_lstm_net_config(VOCAB, BATCH)),
    (f"is_predict=1,dict_dim={VOCAB},hid_dim={HID}",
     lambda: stacked_lstm_net_config(VOCAB, hid_dim=HID, is_predict=True)),
    (f"is_predict=1,net=bidi,dict_dim={VOCAB},compute_dtype=bfloat16",
     lambda: bidirectional_lstm_net_config(VOCAB, is_predict=True,
                                           compute_dtype="bfloat16")),
    ("dict_dim=30000", lambda: stacked_lstm_net_config(30000)),
], ids=["stacked", "bidi", "stacked-predict", "bidi-predict-bf16",
        "full-width"])
def test_builders_equal_the_dsl_parse(args, build):
    """The model and optimization configs — the whole to_dict() form —
    equal the DSL parse of demo/sentiment/trainer_config.py."""
    want = parse_config(CONFIG, args)
    got = build()
    assert got.model_config.to_dict() == want.model_config.to_dict()
    assert got.opt_config.to_dict() == want.opt_config.to_dict()


def test_full_width_graph_census():
    """The main path's configuration: lstm hidden 128, recurrent weights
    [128, 512], biases [1, 896] with peepholes, relu cells with
    drop_rate 0.5 and alternating direction."""
    m = stacked_lstm_net_config(30000).model_config
    lstms = [l for l in m.layers if l.type == "lstmemory"]
    assert [(l.size, l.active_type, l.drop_rate, l.reversed) for l in lstms] \
        == [(128, "relu", 0.5, False), (128, "relu", 0.5, True),
            (128, "relu", 0.5, False)]
    assert m.parameter("___lstmemory_0__.w0").dims == [128, 512]
    assert m.parameter("___lstmemory_0__.wbias").dims == [1, 896]
    assert m.parameter("___fc_layer_1__.w0").learning_rate == 1e-3
    assert sum(p.size for p in m.parameters) == 4_763_010
    with pytest.raises(ValueError, match="odd"):
        from paddle_tpu_torch.models.sentiment import stacked_lstm_net
        stacked_lstm_net(50, 32, stacked_num=2)


@pytest.mark.parametrize("net", ["stacked", "bidi"])
def test_test_forward_matches_jax(net):
    """TEST forward (dropout scaling, no draw) on a ragged batch: class
    probabilities within 1e-5 through the training config and through the
    is_predict config, whose output layer they are."""
    jtr, ttr = _pair(net, seed=3)
    b = _batches(1, seed=1)[0]
    want, _, _ = jtr.executor.forward(jtr.params, _jbatch(b), None, "test")
    lf.counts.reset()
    out, costs, _ = ttr.executor.forward(ttr.params,
                                         ttr.prepare_batch(_tbatch(b)))
    assert lf.counts.plain == (3 if net == "stacked" else 2)
    name = ttr.model.evaluators[0].input_layer_names[0]
    got = out[name].value.numpy()
    np.testing.assert_allclose(got, np.asarray(want[name].value), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    predict = NETS[net][1](is_predict=True).model_config
    assert predict.output_layer_names == [name]
    feed = ttr.prepare_batch(_tbatch(b))
    feed.pop("label")
    pout, pcosts, _ = GraphExecutor(predict).forward(ttr.params, feed,
                                                     mode=TEST)
    assert torch.equal(pout[name].value, out[name].value) and not pcosts


@pytest.mark.parametrize("net", ["stacked", "bidi"])
def test_one_train_step_gradients_match_jax(net):
    """One TRAIN step with the dropout masks JAX drew fed through
    dropout_masks: the loss within rtol 1e-5, every gradient within 1e-4
    of its own scale (float32, another summation order)."""
    jtr, ttr = _pair(net, seed=5)
    b = _batches(1, seed=2)[0]
    key = jax.random.PRNGKey(11)
    want_loss, jgrads = jax.value_and_grad(
        lambda p: jtr.executor.loss(p, _jbatch(b), {}, "train", key)[0])(
            jtr.params)
    masks = _jax_masks(ttr.model, key, _mask_shapes(ttr.model))
    assert len(masks) == (3 if net == "stacked" else 1)
    loss, grads, _ = ttr.compute_gradients(ttr.prepare_batch(_tbatch(b)),
                                           dropout_masks=masks)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want,
                                   atol=1e-7 + 1e-4 * scale, rtol=0,
                                   err_msg=name)
    # the port's own draw gives another loss: the masks were used
    other, _, _ = ttr.compute_gradients(ttr.prepare_batch(_tbatch(b)))
    assert abs(float(other) - float(loss)) > 1e-6


@pytest.mark.parametrize("net", ["stacked", "bidi"])
def test_three_adam_steps_match_the_jax_trainer(net):
    """Three Trainer steps (Adam, L2 8e-4, clipping at 25, the fc edges'
    learning rate 1e-3), each fed the masks the JAX Trainer draws for it:
    per-step losses within rtol 1e-5, the classification error equal."""
    jtr, ttr = _pair(net, seed=7)
    shapes = _mask_shapes(ttr.model)
    jl, tl = [], []
    for b in _batches(3, seed=4):
        key = jax.random.split(jtr.rng)[1]      # the key the step will use
        jl.append(float(jtr.train_one_batch(_jbatch(b))))
        tl.append(float(ttr.train_one_batch(
            _tbatch(b), dropout_masks=_jax_masks(ttr.model, key, shapes))))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jerr = jtr.evaluators.finalize(jtr._acc)["classification_error"]
    terr = ttr.evaluators.finalize(ttr._acc)["classification_error"]
    assert terr == pytest.approx(jerr, abs=1e-12)
    assert ttr.opt_state["num_updates"] == 3
    moved = max(float(np.abs(np.asarray(jtr.params[n])
                             - ttr.params[n].numpy()).max())
                for n in ttr.params)
    assert moved < 2e-2          # Adam steps of +-lr on noise-level entries


def test_trainer_test_matches_jax():
    """Trainer.test(): the TEST cost within rtol 1e-5 and the
    classification error equal, over two ragged batches."""
    jtr, ttr = _pair("stacked", seed=9)
    batches = _batches(2, seed=6)
    jt = jtr.test(iter([_jbatch(b) for b in batches]))
    tt = ttr.test([_tbatch(b) for b in batches])
    assert tt["cost"] == pytest.approx(jt["cost"], rel=1e-5)
    assert tt["classification_error"] == pytest.approx(
        jt["classification_error"], abs=1e-12)


def test_checkpoints_load_on_both_sides(tmp_path):
    """A JAX save() of the stacked net loads in the port (parameters, Adam
    slots, counters; the [D, 4D] recurrent weights and [1, 7D] biases by
    name) and the reverse; the port's dropout generator rides in the
    checkpoint and a fresh port Trainer resumes its stream."""
    args, build = NETS["stacked"]
    jtr = JTrainer(parse_config(CONFIG, args), seed=3)
    b1, b2 = _batches(2, seed=8)
    jtr.train_one_pass(iter([_jbatch(b1)]))
    jdir = jtr.save(str(tmp_path / "jax"))
    ttr = Trainer(build(), device="cpu", seed=21)
    ttr.load(jdir)
    assert ttr.pass_id == jtr.pass_id == 1
    for n, v in jtr.params.items():
        np.testing.assert_array_equal(ttr.params[n].numpy(), np.asarray(v))
    want = opt_state_from_jax(jax.tree.map(np.asarray, jtr.opt_state),
                              device="cpu")
    for n, slots in want["slots"].items():
        for k, v in slots.items():
            assert torch.equal(ttr.opt_state["slots"][n][k], v), (n, k)
    np.testing.assert_array_equal(ttr.rng, np.asarray(jtr.rng))

    ttr.train_one_pass([_tbatch(b2)])
    tdir = ttr.save(str(tmp_path / "port"))
    back = JTrainer(parse_config(CONFIG, args), seed=9)
    back.load(tdir)
    for n, v in ttr.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[n]), v.numpy())
    assert int(back.opt_state["num_updates"]) == 2
    np.testing.assert_array_equal(np.asarray(back.rng), ttr.rng)

    fresh = Trainer(build(), device="cpu", seed=99)
    fresh.load(tdir)
    assert torch.equal(fresh.dropout_rng.get_state(),
                       ttr.dropout_rng.get_state())
    a = ttr.train_one_batch(_tbatch(b1))
    b = fresh.train_one_batch(_tbatch(b1))
    assert float(a) == float(b)          # same parameters, same masks


def test_dropout_stream_follows_the_trainer_seed():
    """The same seed gives the same training losses (same masks), another
    seed other masks; test() draws nothing."""
    _, build = NETS["stacked"]
    b = _batches(1, seed=10)[0]

    def losses(seed):
        tr = Trainer(build(), device="cpu", seed=1)
        tr.dropout_rng.manual_seed(seed)
        for name, p in tr.params.items():       # wake the zero lstm edges
            if not p.any():
                tr.params[name] = torch.full_like(p, 0.05)
        state = tr.dropout_rng.get_state()
        tr.test([_tbatch(b)])
        assert torch.equal(tr.dropout_rng.get_state(), state)
        return [float(tr.train_one_batch(_tbatch(b))) for _ in range(2)]

    assert losses(5) == losses(5)
    assert losses(5) != losses(6)


def test_recurrent_layers_refuse_what_is_not_ported():
    """The carry-over of the final state into the next batch
    (--prev_batch_state): handed the forward LSTMs' states, the stacked
    net's TEST forward boots them from it and hands on their final states,
    as the JAX executor does (costs and states within 1e-5); the reversed
    LSTMs carry none."""
    from paddle_tpu.utils.flags import FLAGS as JFLAGS
    from paddle_tpu_torch.utils.flags import FLAGS
    jtr, ttr = _pair("stacked", 0)
    b = _batches(1)[0]
    feed = ttr.prepare_batch(_tbatch(b))
    saved = FLAGS.prev_batch_state, JFLAGS.prev_batch_state
    FLAGS.prev_batch_state = JFLAGS.prev_batch_state = True
    try:
        _, _, first = ttr.executor.forward(ttr.params, feed)
        reversed_ = {l.name for l in ttr.model.layers if l.reversed}
        assert first and not any(k.split(":")[0] in reversed_
                                 for k in first)
        rng = np.random.default_rng(3)
        state = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                 for k, v in first.items()}
        _, got, got_state = ttr.executor.forward(
            ttr.params, feed, state={k: torch.from_numpy(v)
                                     for k, v in state.items()})
        _, want, want_state = jtr.executor.forward(
            jtr.params, _jbatch(b), {k: jnp.asarray(v)
                                     for k, v in state.items()}, "test")
    finally:
        FLAGS.prev_batch_state, JFLAGS.prev_batch_state = saved
    for name, c in got.items():
        np.testing.assert_allclose(c.numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)
    assert set(got_state) == set(want_state) == set(first)
    for k, v in got_state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_state[k]),
                                   rtol=1e-5, atol=1e-5)
        assert not torch.equal(v, first[k])


def test_bfloat16_compute_dtype_runs_and_stays_close_to_jax():
    """compute_dtype=bfloat16: the lstm runs in float32 on the widened
    bfloat16 projection and hands bfloat16 on, as the JAX scan route's
    output dtype; TEST probabilities within 1e-2 of the JAX side's, and a
    TRAIN step gives finite float32 master gradients."""
    args, build = NETS["stacked"]
    jtr = JTrainer(parse_config(CONFIG, args + ",compute_dtype=bfloat16"),
                   seed=5)
    rng = np.random.default_rng(5)
    for name, v in jtr.params.items():
        if not np.asarray(v).any():
            jtr.params[name] = jnp.asarray(
                rng.standard_normal(v.shape).astype(np.float32) * 0.1)
    ttr = Trainer(build(compute_dtype="bfloat16"), device="cpu",
                  params=params_from_jax(_np_params(jtr), device="cpu"))
    b = _batches(1, seed=12)[0]
    want, _, _ = jtr.executor.forward(jtr.params, _jbatch(b), None, "test")
    out, _, _ = ttr.executor.forward(ttr.params,
                                     ttr.prepare_batch(_tbatch(b)))
    name = ttr.model.evaluators[0].input_layer_names[0]
    got = out[name].value
    assert got.dtype == torch.bfloat16
    assert out["__lstmemory_0__"].value.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want[name].value.astype(jnp.float32)), atol=1e-2)
    loss, grads, _ = ttr.compute_gradients(ttr.prepare_batch(_tbatch(b)))
    assert np.isfinite(float(loss))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
