"""PyTorch port: every evaluator and printer of the JAX package, fed
identical outputs, the validation layers, and gradient_printer's probe.

Each evaluator set is built from the same evaluator configs on both sides
and fed the same two numpy-seeded batches of outputs (JAX arrays and
tensors): counts are held exactly, floats within 1e-12.  The AUC weights
are multiples of 1/4, so every histogram sum is exact in either order; with
arbitrary float32 weights the reference's float32 scatter-add rounds each
add and the port's float64 sums do not (trainer/evaluators.py), and the AUC
is held within 1e-6.  The printers' log lines and result file are compared
as text."""

import contextlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu.config.schema import EvaluatorConfig as JEval
from paddle_tpu.config.schema import ModelConfig as JModel
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.evaluators import EvaluatorSet as JSet
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.config.schema import EvaluatorConfig, ModelConfig
from paddle_tpu_torch.models import seq2seq_trainer_config
from paddle_tpu_torch.parameter import Argument, params_from_jax
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer.evaluators import EvaluatorSet

B, T = 12, 7


def _args(arrays: dict):
    """{name: dict(value=, ids=, lengths=)} -> (JAX outputs, port outputs)."""
    def side(make, conv):
        return {n: make(**{k: None if v is None else conv(v)
                           for k, v in a.items()})
                for n, a in arrays.items()}
    return (side(JArgument, jnp.asarray),
            side(Argument, lambda v: torch.from_numpy(np.array(v))))


def _outputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def probs(*shape):
        z = rng.normal(size=shape).astype(np.float32)
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lab_lens = rng.integers(0, T // 2 + 1, B).astype(np.int32)
    return {
        "p2": dict(value=probs(B, 2)),
        "p3": dict(value=probs(B, 3)),
        "p4": dict(value=probs(B, 4)),
        "p1": dict(value=rng.random((B, 1), np.float32)),
        "lbl2": dict(ids=rng.integers(0, 2, B).astype(np.int32)),
        "lbl4": dict(ids=rng.integers(0, 4, B).astype(np.int32)),
        "w": dict(value=(rng.integers(0, 9, (B, 1)) / 4).astype(np.float32)),
        "wf": dict(value=rng.random((B, 1), np.float32) * 3),
        "qid": dict(ids=rng.integers(0, 3, B).astype(np.int32)),
        "seq": dict(value=probs(B, T, 3), lengths=lens),
        "seqlbl": dict(ids=rng.integers(0, 3, (B, T)).astype(np.int32),
                       lengths=lens),
        "acts": dict(value=probs(B, T, 5), lengths=lens),
        "ctclbl": dict(ids=rng.integers(0, 4, (B, T)).astype(np.int32),
                       lengths=lab_lens),
        "score": dict(value=rng.normal(size=(B, T, 1)).astype(np.float32),
                      lengths=lens),
        "click": dict(value=rng.integers(0, 2, (B, T, 1)).astype(np.float32),
                      lengths=lens),
        "pv": dict(value=rng.integers(1, 3, (B, T, 1)).astype(np.float32),
                   lengths=lens),
        "tags": dict(ids=rng.integers(0, 5, (B, T)).astype(np.int32),
                     lengths=lens),
        "tagl": dict(ids=rng.integers(0, 5, (B, T)).astype(np.int32),
                     lengths=lens),
    }


# (evaluator type, its input layers, other config fields)
DEVICE = {
    "auc": ("auc", ["p2", "lbl2"], {}),
    "auc-weighted": ("last-column-auc", ["p3", "lbl2", "w"], {}),
    "pr-classes": ("precision_recall", ["p4", "lbl4"], {}),
    "pr-positive": ("precision_recall", ["p4", "lbl4"],
                    {"positive_label": 2}),
    "pr-threshold": ("precision_recall", ["p1", "lbl2"],
                     {"positive_label": 1, "classification_threshold": 0.4}),
}
HOST = {
    "seq_classification_error": ("seq_classification_error",
                                 ["seq", "seqlbl"], {}),
    "ctc_edit_distance": ("ctc_edit_distance", ["acts", "ctclbl"], {}),
    "pnpair": ("pnpair", ["p2", "lbl2", "qid"], {}),
    "pnpair-weighted": ("pnpair", ["p2", "lbl2", "qid", "wf"], {}),
    "rankauc": ("rankauc", ["score", "click"], {}),
    "rankauc-pv": ("rankauc", ["score", "click", "pv"], {}),
    "chunk": ("chunk", ["tags", "tagl"], {"chunk_scheme": "IOB",
                                          "num_chunk_types": 2}),
}


def _sets(cases):
    evals = [dict(name=n, type=t, input_layer_names=i, **kw)
             for n, (t, i, kw) in cases.items()]
    return (JSet(JModel(evaluators=[JEval(**e) for e in evals])),
            EvaluatorSet(ModelConfig(evaluators=[EvaluatorConfig(**e)
                                                 for e in evals])))


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, (int, np.integer)):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("case", sorted(DEVICE))
def test_device_evaluator_matches_jax(case):
    js, ts = _sets({case: DEVICE[case]})
    jacc, tacc = {}, {}
    for seed in (0, 1):
        jo, to = _args(_outputs(seed))
        jacc = js.accumulate(jacc, js.batch_partials(jo, {}))
        tacc = ts.accumulate(tacc, ts.batch_partials(to, {}))
    _same(ts.finalize(tacc), js.finalize(jacc))


def test_auc_with_float_weights_is_within_float32_rounding():
    """Weights that are not dyadic: the reference's float32 histogram sums
    round at each add, the port's float64 sums do not."""
    case = {"a": ("last-column-auc", ["p3", "lbl2", "wf"], {})}
    js, ts = _sets(case)
    jo, to = _args(_outputs(2))
    want = js.finalize(js.accumulate({}, js.batch_partials(jo, {})))["auc"]
    got = ts.finalize(ts.accumulate({}, ts.batch_partials(to, {})))["auc"]
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("case", sorted(HOST))
def test_host_evaluator_matches_jax(case):
    js, ts = _sets({case: HOST[case]})
    jst, tst = js.new_host_state(), ts.new_host_state()
    for seed in (0, 1):
        jo, to = _args(_outputs(seed))
        js.host_update(jst, jo)
        ts.host_update(tst, ts.host_outputs(to))
    _same(ts.finalize_host(tst), js.finalize_host(jst))


@contextlib.contextmanager
def _logged(name: str):
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    log = logging.getLogger(name)
    h = Keep()
    log.addHandler(h)
    try:
        yield lines
    finally:
        log.removeHandler(h)


PRINTERS = {
    "value_printer": ["p2", "w"],
    "max_id_printer": ["p4"],
    "classification_error_printer": ["p4", "lbl4"],
    "max_frame_printer": ["seq"],
    "seq_text_printer": ["tags"],
    "gradient_printer": ["p3"],
}


@pytest.mark.parametrize("kind", sorted(PRINTERS) + ["seq_text_file"])
def test_printer_logs_what_jax_logs(kind, tmp_path):
    """Each printer logs the same text for its first five batches (and
    nothing after); seq_text_printer with a dict file and a result file
    writes the same file."""
    kw = {}
    typ = kind
    if kind == "seq_text_file":
        typ = "seq_text_printer"
        (tmp_path / "dict.txt").write_text("a\nb\nc\nd\n")
        kw = dict(dict_file=str(tmp_path / "dict.txt"), delimited=True)
    inputs = PRINTERS[typ]
    batches = [_args(_outputs(s)) for s in range(7)]
    if typ == "gradient_printer":       # the trainer's probe outputs
        batches = [tuple({"__grad__" + k: v for k, v in o.items()}
                         for o in b) for b in batches]
    text = {}
    for side, Set, Eval, logger in (
            ("jax", JSet, JEval, "paddle_tpu.evaluator"),
            ("port", EvaluatorSet, EvaluatorConfig,
             "paddle_tpu_torch.evaluator")):
        if kind == "seq_text_file":
            kw["result_file"] = str(tmp_path / f"{side}.txt")
        Model = JModel if side == "jax" else ModelConfig
        es = Set(Model(evaluators=[Eval(name="pr", type=typ,
                                        input_layer_names=inputs, **kw)]))
        state = es.new_host_state()
        with _logged(logger) as lines:
            for jo, to in batches:
                es.host_update(state, jo if side == "jax"
                               else es.host_outputs(to))
        assert es.finalize_host(state) == {}
        text[side] = (lines if kind != "seq_text_file"
                      else (tmp_path / f"{side}.txt").read_text())
    assert text["port"] == text["jax"]
    if kind != "seq_text_file":
        assert len(text["port"]) == 5


VALIDATION = """
from paddle_tpu.dsl import *
settings(batch_size=16, learning_rate=0.1)
x = data_layer(name="x", size=8)
h = fc_layer(input=x, size=16, act=TanhActivation())
out = fc_layer(input=h, size=2, act=SoftmaxActivation(), name="out")
lbl = data_layer(name="label", size=2)
qid = data_layer(name="qid", size=64)
classification_cost(input=out, label=lbl)
if get_config_arg("validate", bool, True):
    auc_validation(input=out, label=lbl, name="val_auc")
    pnpair_validation(input=out, label=lbl, info=qid, name="val_pnpair")
"""


def test_validation_layers_host_their_evaluators(tmp_path):
    """auc-validation and pnpair-validation pass the score through without
    a gradient (training is as without them) and host the
    last-column-auc and pnpair evaluators: test() on the port equals the
    JAX evaluator set fed the port's own outputs."""
    path = tmp_path / "val.py"
    path.write_text(VALIDATION)
    jtr = JTrainer(jax_parse_config(str(path), ""), seed=11)
    start = params_from_jax({k: np.asarray(v) for k, v in jtr.params.items()},
                            device="cpu")
    ttr = Trainer(parse_config(str(path), ""), device="cpu", params=start)
    plain = Trainer(parse_config(str(path), "validate=0"), device="cpu",
                    params=start)
    assert [c.type for c in ttr.evaluators.host_configs] == ["pnpair"]
    assert [c.type for c in ttr.evaluators.configs] == [
        "classification_error", "last-column-auc"]
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        x = rng.standard_normal((16, 8)).astype(np.float32)
        batches.append({"x": Argument(value=x),
                        "label": Argument(ids=(x[:, 0] > 0).astype(np.int32)),
                        "qid": Argument(ids=rng.integers(0, 4, 16)
                                        .astype(np.int32))})
    for b in batches[:2]:
        ttr.train_one_batch(b)
        plain.train_one_batch(b)
    for n, p in plain.params.items():
        assert torch.equal(ttr.params[n], p), n
    stats = ttr.test(batches[2:])
    js = JSet(jtr.model)
    jacc, jst = {}, js.new_host_state()
    for b in batches[2:]:
        outputs, _, _ = ttr.executor.forward(ttr.params,
                                             ttr.prepare_batch(b))
        assert not outputs["val_auc"].value.requires_grad
        jo = {n: JArgument(value=None if a.value is None
                           else jnp.asarray(a.value.numpy()),
                           ids=None if a.ids is None
                           else jnp.asarray(a.ids.numpy()))
              for n, a in outputs.items()}
        jacc = js.accumulate(jacc, js.batch_partials(jo, {}))
        js.host_update(jst, jo)
    want = js.finalize(jacc)
    want.update(js.finalize_host(jst))
    for k, v in want.items():
        assert stats[k] == pytest.approx(v, abs=1e-12), k
    assert "val_auc.auc" in stats and "val_pnpair.pnpair" in stats


GRADIENT = """
from paddle_tpu.dsl import *
settings(batch_size=4, learning_rate=0.1,
         learning_method=MomentumOptimizer(momentum=0.0))
x = data_layer(name="x", size=8)
h = fc_layer(input=x, size=6, act=TanhActivation(), name="h")
out = fc_layer(input=h, size=1, act=LinearActivation(), name="out")
gradient_printer_evaluator(input=h)
gradient_printer_evaluator(input=out)
regression_cost(input=out, label=data_layer(name="y", size=1))
"""


def test_gradient_printer_probe_is_the_output_gradient(tmp_path):
    """The probes' gradients equal the JAX trainer's `__grad__` outputs and,
    for the square error 0.5 |o - y|^2 averaged over B rows, (o - y) / B;
    the printer logs them; a probe on a layer inside a recurrent group is
    refused as in the reference."""
    path = tmp_path / "grad.py"
    path.write_text(GRADIENT)
    jtr = JTrainer(jax_parse_config(str(path), ""), seed=0)
    ttr = Trainer(parse_config(str(path), ""), device="cpu",
                  params=params_from_jax(
                      {k: np.asarray(v) for k, v in jtr.params.items()},
                      device="cpu"))
    rng = np.random.default_rng(0)
    x = rng.random((4, 8), np.float32)
    y = rng.random((4, 1), np.float32)
    _, _, _, _, _, host_out = jtr._train_step_fn(
        jtr.params, jtr.opt_state, {},
        {"x": JArgument(value=x), "y": JArgument(value=y)},
        jax.random.PRNGKey(0))
    _, _, outputs = ttr.compute_gradients(ttr.prepare_batch(
        {"x": Argument(value=x), "y": Argument(value=y)}))
    for n in ("h", "out"):
        np.testing.assert_allclose(outputs["__grad__" + n].value.numpy(),
                                   np.asarray(host_out["__grad__" + n].value),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    o = outputs["out"].value.detach().numpy()
    np.testing.assert_allclose(outputs["__grad__out"].value.numpy(),
                               (o - y) / 4, rtol=1e-5, atol=1e-7)
    with _logged("paddle_tpu_torch.evaluator") as lines:
        ttr.train_one_pass([{"x": Argument(value=x), "y": Argument(value=y)}])
    assert len(lines) == 2 and all(ln.startswith("[") for ln in lines)

    cfg = seq2seq_trainer_config(dict_size=32, hidden_dim=16, batch_size=4)
    group = next(sm for sm in cfg.model_config.sub_models
                 if sm.is_recurrent_layer_group)
    inside = next(n for n in group.layer_names
                  if cfg.model_config.layers[0].name != n)
    cfg.model_config.evaluators.append(EvaluatorConfig(
        name="g", type="gradient_printer", input_layer_names=[inside]))
    with pytest.raises(NotImplementedError, match="recurrent group"):
        Trainer(cfg, device="cpu")
