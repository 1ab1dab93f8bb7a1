"""PyTorch port: the training slice against the JAX package on the CPU —
the trainer config, one step's gradients, three Adam steps of the Trainer,
a bfloat16 step, checkpoints in both directions.

Small widths (vocab 61, dim 32, 2 layers, 4 heads; kv_heads 2 in one case)
with block_k_min=16, so that at T=24 both sides take the long-context
route: the port's flash attention (its plain version on the CPU) and the
JAX package's blockwise attention (its flash kernel needs a TPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.models import transformer_lm_trainer_config
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parameter import (Argument, opt_state_from_jax,
                                        params_from_jax)
from paddle_tpu_torch.trainer import Trainer

VOCAB, DIM, LAYERS, HEADS, BATCH, T = 61, 32, 2, 4, 4, 24
LENS = np.array([24, 17, 9, 24], np.int32)


def _args(extra=""):
    return (f"vocab={VOCAB},dim={DIM},layers={LAYERS},heads={HEADS},"
            f"batch_size={BATCH},block_k_min=16" + extra)


def _port_cfg(**kw):
    return transformer_lm_trainer_config(VOCAB, DIM, LAYERS, HEADS,
                                         batch_size=BATCH, block_k_min=16,
                                         **kw)


def _batches(n, seed=0):
    """Repeated-motif token streams (the shape of lm_provider's synthetic
    language), ragged lengths, as numpy."""
    rng = np.random.default_rng(seed)
    motifs = [rng.integers(2, VOCAB, rng.integers(3, 8)) for _ in range(5)]
    out = []
    for _ in range(n):
        rows = []
        for _ in range(BATCH):
            seq = [1]
            while len(seq) < T + 1:
                seq += motifs[int(rng.integers(0, len(motifs)))].tolist()
            rows.append(seq[:T + 1])
        ids = np.asarray(rows, np.int32)
        out.append((ids[:, :-1].copy(), ids[:, 1:].copy()))
    return out


def _jbatch(b):
    return {"tokens": JArgument(ids=jnp.asarray(b[0]),
                                lengths=jnp.asarray(LENS)),
            "next_tokens": JArgument(ids=jnp.asarray(b[1]),
                                     lengths=jnp.asarray(LENS))}


def _tbatch(b):
    return {"tokens": Argument(ids=b[0], lengths=LENS),
            "next_tokens": Argument(ids=b[1], lengths=LENS)}


def _jax_value_and_grad(jtr, b):
    """(loss, grads) of the JAX executor's TRAIN loss on one batch."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, batch: jtr.executor.loss(p, batch, {}, "train")[0]))
    return fn(jtr.params, _jbatch(b))


def _np_params(tr):
    return {k: np.asarray(v) for k, v in tr.params.items()}


@pytest.fixture(scope="module", params=["", ",kv_heads=2"],
                ids=["mha", "gqa"])
def pair(request):
    """A JAX Trainer and a port Trainer from the same parameters."""
    extra = request.param
    jtr = JTrainer(parse_config("demo/model_zoo/transformer_lm.py",
                                _args(extra)), seed=7)
    kw = {"kv_heads": 2} if extra else {}
    ttr = Trainer(_port_cfg(**kw), device="cpu",
                  params=params_from_jax(_np_params(jtr), device="cpu"))
    return jtr, ttr


def test_trainer_config_equals_the_dsl_parse():
    for extra, kw in (("", {}), (",compute_dtype=bfloat16",
                                 {"compute_dtype": "bfloat16"})):
        want = parse_config("demo/model_zoo/transformer_lm.py", _args(extra))
        got = _port_cfg(**kw)
        assert got.opt_config.to_dict() == want.opt_config.to_dict()
        assert got.model_config.to_dict() == want.model_config.to_dict()


def test_one_step_gradients_match_jax(pair):
    """fp32 d loss / d param of one batch equal jax.grad(executor.loss):
    atol 2e-6 + rtol 1e-4 of each gradient's own scale (summation order
    only)."""
    jtr, ttr = pair
    b = _batches(1, seed=3)[0]
    want_loss, jgrads = _jax_value_and_grad(jtr, b)
    fa.counts.reset()
    loss, grads, _ = ttr.compute_gradients(ttr.prepare_batch(_tbatch(b)))
    assert fa.counts.plain == 2 * LAYERS        # fwd + bwd per layer
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want,
                                   atol=2e-6 + 1e-4 * scale, rtol=0,
                                   err_msg=name)


def test_three_adam_steps_match_the_jax_trainer():
    """Per-step losses within rtol 1e-5 and the classification_error
    evaluator equal over three Adam steps with clipping.  The parameters
    are compared after step 1 only: from there on Adam's g/(sqrt(v)+eps)
    turns gradient entries at the noise level into updates of +-lr, so
    their equality is not a tolerance question."""
    jtr = JTrainer(parse_config("demo/model_zoo/transformer_lm.py",
                                _args()), seed=11)
    ttr = Trainer(_port_cfg(), device="cpu",
                  params=params_from_jax(_np_params(jtr), device="cpu"))
    batches = _batches(3, seed=5)
    jl = [float(jtr.train_one_batch(_jbatch(b))) for b in batches[:1]]
    tl = [float(ttr.train_one_batch(_tbatch(b))) for b in batches[:1]]
    moved = max(float(np.abs(np.asarray(jtr.params[n]) - ttr.params[n].numpy())
                      .max()) for n in ttr.params)
    assert moved < 1e-5, moved
    jl += [float(jtr.train_one_batch(_jbatch(b))) for b in batches[1:]]
    tl += [float(ttr.train_one_batch(_tbatch(b))) for b in batches[1:]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jerr = jtr.evaluators.finalize(jtr._acc)["classification_error"]
    terr = ttr.evaluators.finalize(ttr._acc)["classification_error"]
    assert terr == pytest.approx(jerr, abs=1e-12)
    assert ttr.opt_state["num_updates"] == 3
    assert ttr.opt_state["num_samples"] == 3 * BATCH


def test_train_one_pass_and_test_match_the_jax_trainer():
    """The pass statistics (mean cost within rtol 1e-5, the classification
    error equal, the counts) and test()'s cost after the pass (rtol 1e-4:
    the parameters after two Adam steps differ at the 1e-7 level, see
    above)."""
    jtr = JTrainer(parse_config("demo/model_zoo/transformer_lm.py",
                                _args()), seed=5)
    ttr = Trainer(_port_cfg(), device="cpu",
                  params=params_from_jax(_np_params(jtr), device="cpu"))
    batches = _batches(2, seed=9)
    js = jtr.train_one_pass(iter([_jbatch(b) for b in batches]))
    ts = ttr.train_one_pass([_tbatch(b) for b in batches])
    assert ts["cost"] == pytest.approx(js["cost"], rel=1e-5)
    assert ts["classification_error"] == pytest.approx(
        js["classification_error"], abs=1e-12)
    assert (ts["batches"], ts["samples"]) == (js["batches"], js["samples"])
    assert ttr.opt_state["pass_id"] == 1 and ttr.pass_id == 1
    jt = jtr.test(iter([_jbatch(b) for b in batches]))
    tt = ttr.test([_tbatch(b) for b in batches])
    assert tt["cost"] == pytest.approx(jt["cost"], rel=1e-4)


def test_bfloat16_step_within_a_looser_tolerance():
    """compute_dtype=bfloat16: the loss within 1e-2 relative and every
    gradient within 5e-2 of its own max (the two frameworks round to
    bfloat16 at different places: matmul outputs, softmax, the cost)."""
    jtr = JTrainer(parse_config("demo/model_zoo/transformer_lm.py",
                                _args(",compute_dtype=bfloat16")), seed=7)
    ttr = Trainer(_port_cfg(compute_dtype="bfloat16"), device="cpu",
                  params=params_from_jax(_np_params(jtr), device="cpu"))
    b = _batches(1, seed=2)[0]
    jloss, jgrads = _jax_value_and_grad(jtr, b)
    loss, grads, _ = ttr.compute_gradients(ttr.prepare_batch(_tbatch(b)))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-2)
    for name, g in grads.items():
        assert g.dtype == torch.float32            # fp32 master gradients
        want = np.asarray(jgrads[name]).astype(np.float32)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, atol=5e-2 * scale,
                                   rtol=0, err_msg=name)


def test_checkpoints_load_on_both_sides(tmp_path):
    """A port save() loads in the JAX Trainer.load with equal parameters,
    Adam slots and counters, and the reverse; the JAX rng entry rides
    through the port unchanged."""
    jtr = JTrainer(parse_config("demo/model_zoo/transformer_lm.py",
                                _args()), seed=3)
    b1, b2 = _batches(2, seed=4)
    jtr.train_one_pass(iter([_jbatch(b1)]))
    jdir = jtr.save(str(tmp_path / "jax"))
    ttr = Trainer(_port_cfg(), device="cpu")
    ttr.load(jdir)
    assert ttr.pass_id == jtr.pass_id == 1
    for n, v in jtr.params.items():
        np.testing.assert_array_equal(ttr.params[n].numpy(), np.asarray(v))
    want = opt_state_from_jax(jax.tree.map(np.asarray, jtr.opt_state),
                              device="cpu")
    for n, slots in want["slots"].items():
        for k, v in slots.items():
            assert torch.equal(ttr.opt_state["slots"][n][k], v), (n, k)
    for k in ("num_samples", "num_updates", "pass_id"):
        assert ttr.opt_state[k] == want[k]
    np.testing.assert_array_equal(ttr.rng, np.asarray(jtr.rng))

    ttr.train_one_pass([_tbatch(b2)])
    tdir = ttr.save(str(tmp_path / "port"))
    assert tdir.endswith("pass-00001")
    back = JTrainer(parse_config("demo/model_zoo/transformer_lm.py",
                                 _args()), seed=9)
    back.load(tdir)
    for n, v in ttr.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[n]), v.numpy())
    for n, slots in ttr.opt_state["slots"].items():
        for k, v in slots.items():
            np.testing.assert_array_equal(
                np.asarray(back.opt_state["slots"][n][k]), v.numpy())
    assert int(back.opt_state["num_updates"]) == 2
    assert int(back.opt_state["pass_id"]) == 2
    np.testing.assert_array_equal(np.asarray(back.rng), ttr.rng)
    assert back.pass_id == 2


def test_port_checkpoint_round_trip_is_exact(tmp_path):
    """save() -> a fresh Trainer's load() gives identical parameters,
    slots, counters and threefry key, which is written as the JAX trainer
    writes it (uint32 [2])."""
    ttr = Trainer(_port_cfg(), device="cpu", seed=4)
    ttr.train_one_pass([_tbatch(b) for b in _batches(2, seed=1)])
    d = ttr.save(str(tmp_path))
    fresh = Trainer(_port_cfg(), device="cpu", seed=99)
    fresh.load(str(tmp_path))                   # the save_dir: newest pass
    assert fresh.pass_id == ttr.pass_id
    for n in ttr.params:
        assert torch.equal(fresh.params[n], ttr.params[n])
        for k, v in ttr.opt_state["slots"][n].items():
            assert torch.equal(fresh.opt_state["slots"][n][k], v)
    assert {k: fresh.opt_state[k] for k in ("num_samples", "num_updates",
                                            "pass_id")} == \
        {k: ttr.opt_state[k] for k in ("num_samples", "num_updates",
                                       "pass_id")}
    assert torch.equal(fresh.rng, ttr.rng)
    with np.load(f"{d}/model.npz") as z:
        assert z["rng"].dtype == np.uint32
        assert np.array_equal(z["rng"], ttr.rng.numpy())
        assert z["opt|num_updates"].dtype == np.int32


def test_trainer_defaults_to_cuda_and_refuses_unported_paths():
    """Without a card, Trainer() without device='cpu' raises; the
    binary-shard data source (not ported), a steps_per_dispatch below 1
    and batch-shape mistakes raise clearly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_port_cfg())
    ttr = Trainer(_port_cfg(), device="cpu")
    shards = _port_cfg()
    shards.data_config.type = "ptsh"
    with pytest.raises(NotImplementedError, match="ptsh"):
        Trainer(shards, device="cpu").train_one_pass()
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        ttr.train_one_pass([], steps_per_dispatch=0)
    b = _tbatch(_batches(1)[0])
    with pytest.raises(KeyError, match="missing"):
        ttr.train_one_batch({"tokens": b["tokens"]})
    bad = dict(b, tokens=Argument(ids=np.full((BATCH, T), VOCAB, np.int32),
                                  lengths=LENS))
    with pytest.raises(ValueError, match="out of range"):
        ttr.train_one_batch(bad)


@pytest.mark.parametrize("width", [1, 7], ids=["threshold", "argmax"])
def test_classification_error_matches_jax(width):
    """Both branches of classification_error (a 1-wide score against the
    threshold, else the argmax), on a ragged sequence: equal counts."""
    from paddle_tpu.config.schema import EvaluatorConfig as JEval
    from paddle_tpu.trainer.evaluators import _cls_err_batch as jbatch
    from paddle_tpu_torch.config.schema import EvaluatorConfig
    from paddle_tpu_torch.trainer.evaluators import evaluator_registry
    rng = np.random.default_rng(width)
    pred = rng.random((3, 5, width)).astype(np.float32)
    lbl = rng.integers(0, max(width, 2), (3, 5)).astype(np.int32)
    lens = np.array([5, 2, 4], np.int32)
    kw = dict(name="e", input_layer_names=["out", "lbl"])
    want = jbatch(JEval(**kw), {
        "out": JArgument(value=jnp.asarray(pred), lengths=jnp.asarray(lens)),
        "lbl": JArgument(ids=jnp.asarray(lbl), lengths=jnp.asarray(lens))},
        {})
    got = evaluator_registry["classification_error"][0](EvaluatorConfig(**kw), {
        "out": Argument(value=torch.from_numpy(pred),
                        lengths=torch.from_numpy(lens)),
        "lbl": Argument(ids=torch.from_numpy(lbl),
                        lengths=torch.from_numpy(lens))}, {})
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


def test_weighted_cross_entropy_matches_jax():
    """multi-class-cross-entropy with its optional weight input and a coeff:
    the recorded per-sample cost (coeff x weight x -sum log p), rtol 1e-6
    (float32 log and sum)."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.graph.context import ForwardContext as JContext
    from paddle_tpu.graph.layers_cost import multi_class_cross_entropy as jce
    from paddle_tpu_torch.config.schema import LayerConfig, LayerInput
    from paddle_tpu_torch.graph.context import ForwardContext
    from paddle_tpu_torch.graph.layers_cost import multi_class_cross_entropy
    rng = np.random.default_rng(0)
    p = rng.random((3, 4, 6)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    p[0, 0, :] = 0.0                      # log(max(p, 1e-10)) at p = 0
    lbl = rng.integers(0, 6, (3, 4)).astype(np.int32)
    lens = np.array([4, 1, 3], np.int32)
    w = rng.random((3, 1)).astype(np.float32)
    spec = dict(name="c", type="multi-class-cross-entropy", coeff=0.5)
    jctx = JContext(model=None, params={}, mode="train")
    jctx.outputs.update(
        out=JArgument(value=jnp.asarray(p), lengths=jnp.asarray(lens)),
        lbl=JArgument(ids=jnp.asarray(lbl), lengths=jnp.asarray(lens)),
        w=JArgument(value=jnp.asarray(w)))
    jce(jctx, JLayer(inputs=[JInput("out"), JInput("lbl"), JInput("w")],
                     **spec))
    ctx = ForwardContext(model=None, params={}, mode="train")
    ctx.outputs.update(
        out=Argument(value=torch.from_numpy(p),
                     lengths=torch.from_numpy(lens)),
        lbl=Argument(ids=torch.from_numpy(lbl),
                     lengths=torch.from_numpy(lens)),
        w=Argument(value=torch.from_numpy(w)))
    multi_class_cross_entropy(ctx, LayerConfig(
        inputs=[LayerInput("out"), LayerInput("lbl"), LayerInput("w")],
        **spec))
    np.testing.assert_allclose(ctx.costs["c"].numpy(),
                               np.asarray(jctx.costs["c"]), rtol=1e-6)


def test_keep_last_prunes_old_passes(tmp_path):
    """save(keep_last=2) keeps the newest two committed passes (pass-init
    counts as the oldest)."""
    ttr = Trainer(_port_cfg(), device="cpu", seed=2)
    b = _tbatch(_batches(1)[0])
    ttr.save(str(tmp_path), keep_last=2)               # pass-init
    for _ in range(3):
        ttr.train_one_pass([b])
        ttr.save(str(tmp_path), keep_last=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pass-00001",
                                                          "pass-00002"]
