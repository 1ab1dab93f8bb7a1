"""PyTorch port: the trainer's jobs and diagnostics against the JAX
package's Trainer and CLI on the CPU.

`check_gradient` (the verdicts on an MLP, the sentiment LSTM and the LM's
flash route, a wrong gradient flagged, kinks skipped, the float64 refine
run on the CPU), `diagnose_nonfinite`'s message and --detect_nan,
`param_stats`, the families of `metrics.jsonl`, and the CLI's jobs
`time` and `checkgrad` and its flags --detect_nan, --profile_dir and
--show_parameter_stats_period, each with its exit code and output."""

import contextlib
import json
import logging

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import trainer_main as jax_main
from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils.flags import FLAGS as JAX_FLAGS
from paddle_tpu_torch.__main__ import main
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.parameter import Argument, params_from_jax
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.utils.flags import FLAGS

MLP = """
from paddle_tpu.dsl import *
from paddle_tpu.dsl.activations import LogActivation
settings(batch_size=8, learning_rate=0.1,
         learning_method=MomentumOptimizer(momentum=0.9))
x = data_layer(name="x", size=12)
act = LogActivation() if get_config_arg("bad_log", bool, False) \\
    else TanhActivation()
h = fc_layer(input=x, size=16, act=act, name="hidden")
out = fc_layer(input=h, size=4, act=SoftmaxActivation(), name="out")
classification_cost(input=out, label=data_layer(name="y", size=4))
"""
SENTIMENT = ("demo/sentiment/trainer_config.py",
             "hid_dim=32,batch_size=4")
LM = ("demo/model_zoo/transformer_lm.py",
      "vocab=61,dim=32,layers=1,heads=2,batch_size=4,block_k_min=16")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    path = tmp_path_factory.mktemp("jobs") / "mlp.py"
    path.write_text(MLP)
    return str(path)


@contextlib.contextmanager
def logged(name: str):
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())
    log = logging.getLogger(name)
    h = Keep()
    log.addHandler(h)
    try:
        yield seen
    finally:
        log.removeHandler(h)


def _pair(path, args=""):
    jtr = JTrainer(jax_parse_config(path, args), seed=1)
    ttr = Trainer(parse_config(path, args), device="cpu",
                  params=params_from_jax(
                      {k: np.asarray(v) for k, v in jtr.params.items()},
                      device="cpu"))
    return jtr, ttr


def _mlp_batch(seed=0, B=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 12)).astype(np.float32)
    y = rng.integers(0, 4, B).astype(np.int32)
    return ({"x": JArgument(value=x), "y": JArgument(ids=y)},
            {"x": Argument(value=x), "y": Argument(ids=y)})


def _config_batch(path, args):
    """The first training batch of a config's own provider, each side's
    feeder (they give the same batches)."""
    jtr, ttr = _pair(path, args)
    return jtr, ttr, next(iter(jtr.train_batches())), \
        next(iter(ttr.train_batches()))


@pytest.mark.parametrize("config", ["mlp", "sentiment", "lm"])
def test_check_gradient_verdicts_match_jax(config, mlp):
    """The analytic gradient passes the central-difference check on both
    sides, parameter for parameter (the same entries sampled), each
    error under the CLI's bar; the LM's attention takes the flash route
    (its plain version on the CPU)."""
    if config == "mlp":
        jtr, ttr = _pair(mlp)
        jb, tb = _mlp_batch()
    else:
        jtr, ttr, jb, tb = _config_batch(*(SENTIMENT if config ==
                                           "sentiment" else LM))
    want = jtr.check_gradient(jb, max_entries=3)
    got = ttr.check_gradient(tb, max_entries=3)
    assert set(got) == set(want)
    assert max(got.values()) < 0.02, got
    assert {n: e < 0.02 for n, e in got.items()} == \
        {n: e < 0.02 for n, e in want.items()}


def test_a_wrong_gradient_is_flagged(mlp):
    """The noise-aware denominator does not make the check vacuous."""
    _, ttr = _pair(mlp)
    params = {"w": torch.tensor([0.5, -0.3], dtype=torch.float32)}

    def loss_fn(p):
        return float(torch.sum(p["w"] ** 2))
    good = {"w": torch.tensor([1.0, -0.6])}
    bad = {"w": torch.tensor([2.0, -0.6])}
    ttr._static = set()
    assert ttr._check_gradient_inner(loss_fn, good, 1e-3, 2,
                                     params)["w"] < 2e-2
    assert ttr._check_gradient_inner(loss_fn, bad, 1e-3, 2,
                                     params)["w"] > 0.3


def test_kinks_are_skipped_and_an_unadjudicated_flag_stands(mlp):
    _, ttr = _pair(mlp)
    ttr._static = set()

    def loss_fn(p):
        w = p["w"]
        return float(torch.abs(w[0]) + w[1] ** 2)
    params = {"w": torch.tensor([0.0, 0.5], dtype=torch.float64)}
    grads = {"w": torch.tensor([1.0, 1.0], dtype=torch.float64)}
    assert ttr._check_gradient_inner(loss_fn, grads, 1e-3, 2, params, None,
                                     detect_kinks=True)["w"] < 2e-2
    assert ttr._check_gradient_inner(loss_fn, grads, 1e-3, 2,
                                     params)["w"] > 0.3
    both = {"w": torch.tensor([0.0, 0.0], dtype=torch.float64)}
    assert "w" not in ttr._check_gradient_inner(
        lambda p: float(torch.sum(torch.abs(p["w"]))), grads, 1e-3, 2, both,
        None, detect_kinks=True)


def test_the_float64_refine_runs_on_the_cpu():
    """With a bar of 0 every parameter is flagged by the float32 screen and
    re-checked in float64 (the plain LSTM in float64), as on the JAX
    side's CPU backend: the refined errors are far below float32's."""
    _, ttr, _, tb = _config_batch(*SENTIMENT)
    passes = []
    inner = ttr._checkgrad_pass

    def spy(*a, **kw):
        passes.append(kw["f64"])
        return inner(*a, **kw)
    ttr._checkgrad_pass = spy
    with logged("paddle_tpu_torch.trainer") as lines:
        errors = ttr.check_gradient(tb, max_entries=2, refine_threshold=0.0)
    assert passes == [False, True]
    assert any("re-adjudicating" in ln for ln in lines)
    assert max(errors.values()) < 1e-4, errors


def test_diagnose_nonfinite_and_detect_nan_name_the_layer(mlp):
    """A log activation on negative inputs: the message is the JAX
    trainer's, word for word; under --detect_nan the step that made the
    loss raises with it, without the flag the pass's bulk check does."""
    jtr, ttr = _pair(mlp, "bad_log=1")
    jb, tb = _mlp_batch(1)
    want = jtr.diagnose_nonfinite(jb)
    assert ttr.diagnose_nonfinite(tb) == want
    assert "first non-finite output at layer 'hidden' (type=fc)" in want
    with pytest.raises(FloatingPointError, match="batches before the last"
                       ".*layer 'hidden'"):
        ttr.train_one_pass([tb])
    FLAGS.detect_nan = True
    try:
        with pytest.raises(FloatingPointError,
                           match=r"^non-finite loss nan; first non-finite "
                                 r"output at layer 'hidden'"):
            ttr.train_one_batch(tb)
    finally:
        FLAGS.detect_nan = False


def test_param_stats_match_jax(mlp):
    jtr, ttr = _pair(mlp)
    want, got = jtr.param_stats(), ttr.param_stats()
    assert got == want


def test_metrics_jsonl_has_the_jax_records_families(mlp, tmp_path):
    """Three batches, then append_metrics on each side: the records carry
    the registry snapshot with the same metric families (but the live
    device bytes, which the port reads on the card only), the same
    progress numbers and the trainer's compile sites."""
    jtr, ttr = _pair(mlp)
    batches = [_mlp_batch(s) for s in range(3)]
    recs = {}
    for side, tr, i in (("jax", jtr, 0), ("port", ttr, 1)):
        stats = tr.train_one_pass(
            iter([b[i] for b in batches]) if side == "jax"
            else [b[i] for b in batches])
        tr.test([b[i] for b in batches[:1]])
        path = tr.append_metrics(str(tmp_path / side), extra=stats)
        with open(path) as f:
            recs[side] = json.loads(f.readline())

    def families(rec):
        return {k.split("{")[0] for k in rec["metrics"]}
    # the port reads live bytes from the CUDA caching allocator, absent on
    # the CPU (obs/hbm.py); JAX's CPU backend has jax.live_arrays()
    on_card = {"hbm_live_array_bytes", "hbm_live_arrays"}
    assert families(recs["port"]) == families(recs["jax"]) - on_card
    assert on_card <= families(recs["jax"])
    m = recs["port"]["metrics"]
    for k in ("trainer_pass_id", "trainer_batches_total",
              "trainer_samples_total"):
        assert m[k] == recs["jax"]["metrics"][k], k
    for site in ("trainer.train_step", "trainer.eval_step"):
        assert f'jit_compiles_total{{site="{site}"}}' in m, site
    assert 'trainer_host_phase_count{phase="trainOneBatch"}' in m


def _jax_cli(argv) -> int:
    saved = JAX_FLAGS.as_dict()
    try:
        return jax_main.main(argv)
    finally:
        for k, v in saved.items():
            setattr(JAX_FLAGS, k, v)


def _poisoned_checkpoint(root) -> tuple[str, str]:
    """The LM's initial parameters with NaN in the first column of its
    token embedding, saved; and the embedding layer's name."""
    path, args = LM
    jtr = JTrainer(jax_parse_config(path, args), seed=1)
    jtr.params = dict(jtr.params)
    emb = jtr.params["_tok_embedding"]
    jtr.params["_tok_embedding"] = emb.at[:, 0].set(np.nan)
    layer = next(l.name for l in jtr.model.layers
                 if any(i.input_parameter_name == "_tok_embedding"
                        for i in l.inputs))
    return jtr.save(str(root / "poisoned")), layer


JOBS = {
    "time": (["--job=time"], 0, "benchmark:"),
    "checkgrad": (["--job=checkgrad"], 0, "checkgrad: "),
    # on the sentiment net: the JAX CLI's float64 refine of the LM stops
    # in its flash scan (ROADMAP.md, Queue 3)
    "checkgrad-fails": (["--job=checkgrad", "--checkgrad_bar=0"], 1,
                        "gradient check FAILED"),
    "detect_nan": (["--detect_nan", "--num_passes=1"], 1,
                   "first non-finite output at layer"),
    "profile_dir": (["--job=time", "--profile_dir=PROFILE"], 0,
                    "profiler trace written to"),
    "parameter_stats": (["--show_parameter_stats_period=4",
                         "--num_passes=1", "--save_dir=SAVE"], 0,
                        "param _tok_embedding shape="),
}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_cli_jobs(job, tmp_path):
    """Each job or flag exits as the JAX CLI does and logs its result:
    `time` its samples/s, `checkgrad` its worst error (exit 1 over
    --checkgrad_bar), --detect_nan from a checkpoint with a NaN in the
    token embedding the embedding layer's name (exit 1),
    --profile_dir a Chrome trace, --show_parameter_stats_period each
    parameter's statistics; the flags are put back after the run."""
    extra, rc_want, text = JOBS[job]
    extra = [a.replace("PROFILE", str(tmp_path / "prof"))
             .replace("SAVE", str(tmp_path / "save")) for a in extra]
    path, args = SENTIMENT if job == "checkgrad-fails" else LM
    argv = [f"--config={path}", f"--config_args={args}", *extra]
    if job == "detect_nan":
        init, layer = _poisoned_checkpoint(tmp_path)
        argv.append(f"--init_model_path={init}")
        text += f" {layer!r}"
    before = FLAGS.as_dict()
    with logged("paddle_tpu_torch") as lines:
        rc = main(["train", *argv, "--use_gpu=false"])
    assert FLAGS.as_dict() == before
    assert rc == rc_want and any(text in ln for ln in lines), lines[-5:]
    if job == "detect_nan":
        # the JAX CLI also sets jax_debug_nans, which stops at the first
        # NaN primitive (process-wide: put back after)
        try:
            with pytest.raises(FloatingPointError):
                _jax_cli(argv)
        finally:
            jax.config.update("jax_debug_nans", False)
    elif job != "profile_dir":
        assert _jax_cli(argv) == rc_want
    if job == "time":
        rate = [ln for ln in lines if ln.startswith("benchmark:")][0]
        assert float(rate.split()[1]) > 0
    if job == "profile_dir":
        with open(tmp_path / "prof" / "trace.json") as f:
            trace = json.load(f)
        assert any(ev.get("name", "").startswith("aten::")
                   for ev in trace["traceEvents"])
    if job == "parameter_stats":
        with open(tmp_path / "save" / "metrics.jsonl") as f:
            rec = json.loads(f.readline())
        assert rec["metrics"]["trainer_pass_id"] == 1.0
