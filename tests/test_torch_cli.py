"""PyTorch port: `python -m paddle_tpu_torch` against the JAX package's CLI
on the CPU (`--use_gpu=false`).

Both CLIs train one pass from one starting checkpoint (the JAX Trainer's
initial parameters, `--init_model_path`) on their own providers: the pass
statistics (cost within rtol 1e-5, as the Adam-step tests hold it), the
test statistics and the final parameters agree, and the port's run at
--steps_per_dispatch=4 equals its run at 1 bit for bit.  A checkpoint the
CLI saved, loaded by `--job=test --init_model_path`, gives exactly the
statistics of an in-process load.  Exit codes and refusals as documented
in paddle_tpu_torch/trainer_main.py (the jobs `time` and `checkgrad` and
the flags --detect_nan and --profile_dir: tests/test_torch_trainer_jobs.py)."""

import contextlib
import json
import logging

import numpy as np
import pytest
import torch

from paddle_tpu import trainer_main as jax_main
from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu.tools import dump_config as jax_dump_config
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils.flags import FLAGS as JAX_FLAGS
from paddle_tpu_torch.__main__ import main
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.utils.flags import FLAGS

# config -> (file, --config_args): the LM at its small defaults, the
# seq2seq at dict_size 32 (batches of 256: 16 a pass)
RUNS = {
    "lm": ("demo/model_zoo/transformer_lm.py", ""),
    "seq2seq": ("demo/seqToseq/seqToseq_net.py", "dict_size=32,batch_size=256"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU runs here are many small ops: one torch thread a process
    keeps them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def logged(name: str):
    """The log records the logger `name` writes within."""
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record)

    log = logging.getLogger(name)
    h = Keep()
    log.addHandler(h)
    try:
        yield seen
    finally:
        log.removeHandler(h)


def _jax_cli(argv) -> int:
    """The JAX package's trainer CLI, its process-global flags put back
    after the run."""
    saved = JAX_FLAGS.as_dict()
    try:
        return jax_main.main(argv)
    finally:
        for k, v in saved.items():
            setattr(JAX_FLAGS, k, v)


def _rows(save_dir) -> list:
    keep = ("pass_id", "cost", "classification_error", "batches", "samples")
    with open(f"{save_dir}/metrics.jsonl") as f:
        return [{k: r[k] for k in keep} for r in map(json.loads, f)]


def _test_stats(records) -> dict:
    """The statistics of the "test result: %s" record (logging keeps a
    lone dict argument as the record's args)."""
    return [r.args for r in records
            if r.getMessage().startswith("test result")][0]


def _runs(name: str, root) -> dict:
    """One config's runs: the JAX CLI, the port's CLI at k = 1 and at 4,
    one pass each from the JAX Trainer's initial parameters; then
    --job=test from the pass's checkpoint on each side."""
    path, args = RUNS[name]
    init = JTrainer(jax_parse_config(path, args), seed=1).save(
        str(root / "init"))
    common = [f"--config={path}", f"--config_args={args}",
              f"--init_model_path={init}", "--num_passes=1"]
    out = {"path": path, "args": args, "root": root, "last": "pass-00000"}
    assert _jax_cli(common + [f"--save_dir={root}/jax"]) == 0
    for k in (1, 4):
        assert main(["train", *common, f"--save_dir={root}/port{k}",
                     "--use_gpu=false", f"--steps_per_dispatch={k}"]) == 0
    if jax_parse_config(path, args).test_data_config is not None:
        test = [f"--config={path}", f"--config_args={args}", "--job=test",
                f"--init_model_path={root}/port1/{out['last']}"]
        with logged("paddle_tpu.main") as jrec:
            assert _jax_cli(test) == 0
        with logged("paddle_tpu_torch.main") as trec:
            assert main(["train", *test, "--use_gpu=false"]) == 0
        out["test"] = (_test_stats(jrec), _test_stats(trec))
    return out


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    return _runs("lm", tmp_path_factory.mktemp("lm"))


@pytest.fixture(scope="module")
def seq2seq_runs(tmp_path_factory):
    return _runs("seq2seq", tmp_path_factory.mktemp("seq2seq"))


@pytest.fixture(params=sorted(RUNS))
def runs(request):
    return request.getfixturevalue(f"{request.param}_runs")


def test_pass_statistics_and_parameters_equal_the_jax_cli(runs):
    want, got = _rows(runs["root"] / "jax"), _rows(runs["root"] / "port1")
    assert len(got) == len(want) >= 1
    for w, g in zip(want, got):
        assert (g["pass_id"], g["batches"], g["samples"]) == \
            (w["pass_id"], w["batches"], w["samples"])
        assert g["cost"] == pytest.approx(w["cost"], rel=1e-5)
        assert g["classification_error"] == pytest.approx(
            w["classification_error"], abs=1e-6)
    jp = ckpt.load_checkpoint(str(runs["root"] / "jax" / runs["last"]))
    tp = ckpt.load_checkpoint(str(runs["root"] / "port1" / runs["last"]))
    assert set(tp["params"]) == set(jp["params"])
    for n, v in jp["params"].items():
        np.testing.assert_allclose(tp["params"][n], v, rtol=0, atol=1e-5,
                                   err_msg=n)
    if "test" in runs:
        jt, tt = runs["test"]
        assert tt["cost"] == pytest.approx(jt["cost"], rel=1e-4)
        assert tt["classification_error"] == pytest.approx(
            jt["classification_error"], abs=1e-6)


def test_k4_cli_run_equals_k1_bit_for_bit(runs):
    assert _rows(runs["root"] / "port4") == _rows(runs["root"] / "port1")
    a = ckpt.load_checkpoint(str(runs["root"] / "port1" / runs["last"]))
    b = ckpt.load_checkpoint(str(runs["root"] / "port4" / runs["last"]))
    for part in ("params", "opt"):
        fa, fb = ckpt._flatten(a[part], ""), ckpt._flatten(b[part], "")
        assert fa.keys() == fb.keys()
        assert [n for n in fa if not np.array_equal(fa[n], fb[n])] == []


def test_saved_checkpoint_tests_as_an_in_process_load(seq2seq_runs):
    """--job=test --init_model_path=<the CLI's checkpoint>: the same
    statistics, exactly, as Trainer.load() of it and test() here, and the
    loaded parameters are the saved arrays bit for bit."""
    runs = seq2seq_runs
    path = str(runs["root"] / "port1" / runs["last"])
    tr = Trainer(parse_config(runs["path"], runs["args"]), device="cpu")
    tr.load(path)
    saved = ckpt.load_checkpoint(path)["params"]
    assert all(np.array_equal(tr.params[n].numpy(), saved[n])
               for n in saved)
    assert tr.test() == runs["test"][1]


def _rc(argv) -> tuple:
    with logged("paddle_tpu_torch.main") as rec:
        rc = main(argv)
    return rc, " ".join(r.getMessage() for r in rec)


LM = "--config=demo/model_zoo/transformer_lm.py"


# the sentiment provider's words through a forward LSTM, a GRU over it and
# a reversed LSTM, trained by momentum SGD: --prev_batch_state carries the
# forward layers' final states from batch to batch
CARRY_CONFIG = """
from paddle_tpu.dsl import *
define_py_data_sources2(train_list="demo/sentiment/train.list",
                        test_list="demo/sentiment/test.list",
                        module="demo.sentiment.sentiment_provider",
                        obj="process")
settings(batch_size=256, learning_rate=0.05,
         learning_method=MomentumOptimizer(momentum=0.9))
word = data_layer(name="word", size=2000)
emb = embedding_layer(input=word, size=16)
lstm = lstmemory(input=fc_layer(input=emb, size=64, act=LinearActivation()),
                 name="lstm")
gru = grumemory(input=fc_layer(input=lstm, size=48, act=LinearActivation()),
                name="gru")
rev = lstmemory(input=fc_layer(input=emb, size=64, act=LinearActivation()),
                reverse=True, name="rev")
prob = fc_layer(input=[last_seq(input=gru), first_seq(input=rev)], size=2,
                act=SoftmaxActivation())
classification_cost(input=prob, label=data_layer(name="label", size=2))
"""


def test_prev_batch_state_run_equals_the_jax_cli(tmp_path):
    """--prev_batch_state is accepted: a config of a forward LSTM, a GRU
    and a reversed LSTM over the sentiment provider's words trains one
    pass (8 batches of 256) from the JAX Trainer's initial parameters, the
    forward layers booted from the previous batch's final states, as the
    JAX CLI trains it: the pass and test costs within rtol 1e-4, the
    parameters and the carried states in the checkpoints within 1e-5; the
    reversed LSTM carries none."""
    path = str(tmp_path / "carry.py")
    with open(path, "w") as f:
        f.write(CARRY_CONFIG)
    init = JTrainer(jax_parse_config(path, ""), seed=1).save(
        str(tmp_path / "init"))
    common = [f"--config={path}", f"--init_model_path={init}",
              "--num_passes=1", "--prev_batch_state"]
    with logged("paddle_tpu.trainer") as jrec:
        assert _jax_cli(common + [f"--save_dir={tmp_path}/jax"]) == 0
    with logged("paddle_tpu_torch.trainer") as trec:
        assert main(["train", *common, f"--save_dir={tmp_path}/port",
                     "--use_gpu=false"]) == 0
    assert not FLAGS.prev_batch_state          # reset after the run
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(got) == len(want) == 1
    assert got[0]["cost"] == pytest.approx(want[0]["cost"], rel=1e-4)
    assert got[0]["batches"] == want[0]["batches"] == 8

    def test_cost(records):
        line = [r.getMessage() for r in records
                if "test:" in r.getMessage()][0]
        return float(line.split("cost=")[1].split()[0])
    assert test_cost(trec) == pytest.approx(test_cost(jrec), rel=1e-4)
    jp = ckpt.load_checkpoint(str(tmp_path / "jax" / "pass-00000"))
    tp = ckpt.load_checkpoint(str(tmp_path / "port" / "pass-00000"))
    for n, v in jp["params"].items():
        np.testing.assert_allclose(tp["params"][n], v, rtol=0, atol=1e-5,
                                   err_msg=n)
    assert set(tp["net"]) == set(jp["net"]) == {"lstm:h", "lstm:c", "gru:h"}
    for k, v in jp["net"].items():
        np.testing.assert_allclose(tp["net"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("argv,match", [
    (["train", LM, "--job=test", "--use_gpu=false"], "no test data"),
    (["train", LM, "--job=bogus"], "unknown --job"),
    (["train", LM, "--mesh_shape=data:2"], "--mesh_shape: not ported"),
    (["train", LM, "--coordinator_address=h:1", "--num_processes=2"],
     "--coordinator_address, --num_processes: not ported"),
    (["train", LM, "--use_tpu"], "unknown argument"),
    (["train", "--config=demo/no_such_config.py"], "failed to parse"),
    (["train", LM, "--config_args=heads=5"], "failed to parse"),
], ids=["test-without-source", "bogus-job", "mesh", "cluster",
        "unknown-flag", "missing-config", "bad-config"])
def test_cli_refusals_exit_2(argv, match):
    before = FLAGS.as_dict()
    rc, text = _rc(argv)
    assert rc == 2 and match in text, text
    if match not in ("unknown --job", "unknown argument", "failed to parse",
                     "no test data"):
        assert "ROADMAP.md" in text
    assert FLAGS.as_dict() == before


def test_commands_usage_and_version(capsys):
    assert main(["train"]) == 2                      # no --config
    assert main(["merge_model"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert main(["bogus"]) == 2
    assert main(["--help"]) == 0
    assert "dump_config" in capsys.readouterr().out
    assert main(["version"]) == 0
    out = capsys.readouterr().out
    assert torch.__version__ in out and "paddle_tpu_torch" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["train", LM])


def test_dump_config_equals_the_jax_tool(capsys):
    args = ["demo/sentiment/trainer_config.py", "net=bidi"]
    jax_dump_config.main(args)
    want = json.loads(capsys.readouterr().out)
    assert main(["dump_config", *args]) == 0
    assert json.loads(capsys.readouterr().out) == want
