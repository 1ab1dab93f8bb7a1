"""PyTorch port: the sequence-tagging and sparse-input configs against the
JAX package on the CPU, each from its own file at a small size —
demo/semantic_role_labeling/db_lstm.py (depth 2, hidden_dim 32, batch 8),
demo/sequence_tagging/linear_crf.py and rnn_crf.py (batch 8; sparse-row
features, the CRF, model averaging, the sum and chunk evaluators),
demo/quick_start/trainer_config.lr.py (a sparse bag of words) and .cnn.py
(the context projection), demo/recommendation/trainer_config.py (a
sparse genre row, the context projection, cos, square_error; emb_size
16, batch 8) and demo/introduction/trainer_config.py (square_error).

The batches are the config's own provider's, from the port's feeder (the
JAX feeder's batches exactly); both sides start from the same parameters
(`params_from_jax`) in float64 (the JAX side under enable_x64), the dense
feeds in float64.  Held: one TRAIN step's loss and every gradient; two
Trainer steps' losses, parameters and averaged parameters (SRL's dropout
masks drawn by JAX and fed to the port); test() on the averaged
parameters: its cost, and its evaluator results exactly (chunk counts,
`sum`); checkpoints both ways, averages and their count intact; the
fused dispatch at k = 4 against k = 1 bit for bit (averages and
evaluator results included); the CLI training rnn_crf.py from its file.

Limits: losses within rtol 1e-9 and each gradient, update and average
within 1e-8 of its max |value| — except SRL, whose LSTM recurrence runs
in float32 in the port (ops/rnn.py lstm_scan) and in float64 on the JAX
side: losses within rtol 1e-6, the rest within 1e-5 of the max |value|.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils.jax_compat import enable_x64
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.parameter import params_from_jax
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.trainer import make_feeder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRL = "demo/semantic_role_labeling/db_lstm.py"
RNN_CRF = "demo/sequence_tagging/rnn_crf.py"

# name -> (config file, --config_args)
CONFIGS = {
    "srl": (SRL, "depth=2,hidden_dim=32,batch_size=8"),
    "linear_crf": ("demo/sequence_tagging/linear_crf.py", "batch_size=8"),
    "rnn_crf": (RNN_CRF, "batch_size=8"),
    "qs_lr": ("demo/quick_start/trainer_config.lr.py", "batch_size=8"),
    "qs_cnn": ("demo/quick_start/trainer_config.cnn.py", "batch_size=8"),
    "recommendation": ("demo/recommendation/trainer_config.py",
                       "batch_size=8,emb_size=16"),
    "introduction": ("demo/introduction/trainer_config.py", ""),
}
# (loss rtol, share of max |value|)
LIMITS = {"srl": (1e-6, 1e-5)}
DEFAULT_LIMITS = (1e-9, 1e-8)
COUNT_KEYS = ("true_chunks", "result_chunks", "correct_chunks", "sum")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _share(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max(initial=0.0)
                 / max(np.abs(want).max(initial=0.0), 1e-300))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy() if torch.is_tensor(tree) \
        else np.array(tree)


def _f64(batch):
    """A feeder batch with its dense values in float64 (the parameters'
    dtype here)."""
    return {n: a.replace(value=None if a.value is None
                         else np.asarray(a.value, np.float64))
            for n, a in batch.items()}


def _jbatch(batch):
    def j(x):
        return None if x is None else jnp.asarray(x)
    return {n: JArgument(value=j(a.value), ids=j(a.ids),
                         lengths=j(a.lengths), sparse_vals=j(a.sparse_vals),
                         sparse_dim=a.sparse_dim) for n, a in batch.items()}


def _batches(cfg, n, train=True):
    feeder = make_feeder(cfg, cfg.data_config if train
                         else cfg.test_data_config, train, seed=1)
    out = []
    for b in feeder.batches():
        out.append(b)
        if len(out) == n:
            break
    return out


def _jax_masks(model, key, batch):
    """The keep-masks the JAX forward draws from `key`: one
    bernoulli(fold_in(key, k), 1 - p) per layer with dropout, k counting
    them in config order; SRL's are its LSTMs' [B, T, D] outputs."""
    masks, k = {}, 0
    for layer in model.layers:
        if layer.drop_rate > 0:
            B, T = batch["word_data"].ids.shape
            k += 1
            masks[layer.name] = torch.from_numpy(np.array(
                jax.random.bernoulli(jax.random.fold_in(key, k),
                                     1.0 - layer.drop_rate,
                                     (B, T, layer.size))))
    return masks


def _run(name, tmp):
    """Everything both sides compute for one config, in one pass (the JAX
    side compiles once)."""
    path, args = CONFIGS[name]
    out = {}
    jtr = JTrainer(jax_parse_config(path, args), seed=3)
    jtr.params = {k: jnp.asarray(np.asarray(v), jnp.float64)
                  for k, v in jtr.params.items()}
    jtr.opt_state = jax.tree.map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        jtr.opt_state)
    cfg = parse_config(path, args)
    ttr = Trainer(cfg, device="cpu", params=params_from_jax(
        {k: np.asarray(v) for k, v in jtr.params.items()}, device="cpu"))
    b0, b1, b2 = [_f64(b) for b in _batches(cfg, 3)]
    out["averaging"] = "average" in ttr.opt_state

    # one TRAIN step's loss and gradients
    key = jax.random.PRNGKey(5)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.executor.loss(p, b, {}, "train", key)[0]))
    jl, jg = vg(jtr.params, _jbatch(b0))
    loss, grads, _ = ttr.compute_gradients(
        ttr.prepare_batch(b0), dropout_masks=_jax_masks(ttr.model, key, b0))
    out["step"] = (float(jl), _np(jg), float(loss), _np(grads))

    # two Trainer steps, the masks of the key each JAX step uses
    out["init"] = _np(ttr.params)
    losses = []
    for b in (b1, b2):
        step_key = jax.random.split(jtr.rng)[1]
        losses.append((float(jtr.train_one_batch(_jbatch(b))), float(
            ttr.train_one_batch(b, dropout_masks=_jax_masks(
                ttr.model, step_key, b)))))
    out["losses"] = losses
    out["params"] = (_np(jtr.params), _np(ttr.params))
    out["average"] = (_np(jtr.opt_state.get("average", {})),
                      _np(ttr.opt_state.get("average", {})),
                      int(np.asarray(jtr.opt_state.get("average_count", 0))),
                      int(ttr.opt_state.get("average_count",
                                            torch.tensor(0))))

    # test() on the averaged parameters
    if cfg.test_data_config is not None:
        tb = [_f64(b) for b in _batches(cfg, 2, train=False)]
        before = _np(ttr.params)
        out["test"] = (jtr.test([_jbatch(b) for b in tb]), ttr.test(tb))
        after = _np(ttr.params)
        out["test_keeps_params"] = all(np.array_equal(before[n], after[n])
                                       for n in before)

    # checkpoints: the JAX save into another port Trainer, the port's save
    # into the JAX Trainer
    jdir = jtr.save(str(tmp / "jax"))
    port = Trainer(cfg, device="cpu", params={
        n: v.clone() for n, v in ttr.params.items()})
    port.load(jdir)
    out["jax_to_port"] = (_np(jtr.params), _np(jtr.opt_state),
                          _np(port.params), _np(port.opt_state))
    ttr.train_one_batch(b0, dropout_masks=_jax_masks(ttr.model, key, b0))
    tdir = ttr.save(str(tmp / "port"))
    jtr.load(tdir)
    out["port_to_jax"] = (_np(ttr.params), _np(ttr.opt_state),
                          _np(jtr.params), _np(jtr.opt_state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            with enable_x64():
                cache[name] = _run(name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


NAMES = sorted(CONFIGS)


@pytest.mark.parametrize("name", NAMES)
def test_one_step_loss_and_gradients_match_jax(runs, name):
    rtol, share = LIMITS.get(name, DEFAULT_LIMITS)
    jl, jg, tl, tg = runs(name)["step"]
    assert tl == pytest.approx(jl, rel=rtol)
    assert set(tg) == set(jg)
    for n, g in tg.items():
        assert _share(g, jg[n]) <= share, n


@pytest.mark.parametrize("name", NAMES)
def test_two_steps_parameters_and_averages_match_jax(runs, name):
    """Two Trainer steps: the losses, every parameter's update and, under
    model averaging (linear_crf, rnn_crf), every average's move and the
    count (2)."""
    rtol, share = LIMITS.get(name, DEFAULT_LIMITS)
    r = runs(name)
    for jl, tl in r["losses"]:
        assert tl == pytest.approx(jl, rel=rtol)
    p0 = r["init"]
    jp, tp = r["params"]
    for n in jp:
        assert _share(tp[n] - p0[n], jp[n] - p0[n]) <= share, n
    ja, ta, jc, tc = r["average"]
    assert set(ta) == set(ja)
    assert bool(ta) == r["averaging"] == (name in ("linear_crf", "rnn_crf"))
    assert tc == jc == (2 if ta else 0)
    for n in ja:
        assert _share(ta[n] - p0[n], ja[n] - p0[n]) <= share, n


@pytest.mark.parametrize("name", [n for n in NAMES if n != "introduction"])
def test_test_pass_matches_jax(runs, name):
    """test() on the averaged parameters (the training parameters left as
    they were): the cost, and every evaluator result — chunk counts and
    `sum` exactly."""
    rtol, share = LIMITS.get(name, DEFAULT_LIMITS)
    r = runs(name)
    want, got = r["test"]
    assert r["test_keeps_params"]
    assert set(got) == set(want)
    for k, v in want.items():
        if k.rsplit(".", 1)[-1] in COUNT_KEYS:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=rtol, abs=1e-12), k
    if name in ("srl", "linear_crf", "rnn_crf"):
        assert any(k.endswith("true_chunks") and v > 0
                   for k, v in got.items())


def _flat(tree, prefix=""):
    return ckpt._flatten(tree, prefix)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_carry_averages_both_ways(runs, name, direction):
    """A checkpoint either side saves loads on the other: parameters, the
    optimizer slots, the averages and their count, bit for bit."""
    sp, so, dp, do = runs(name)[direction]
    assert set(dp) == set(sp)
    for n in sp:
        np.testing.assert_array_equal(dp[n], sp[n], err_msg=n)
    fs, fd = _flat(so, "opt"), _flat(do, "opt")
    assert set(fs) == set(fd)
    if runs(name)["averaging"]:
        assert "opt|average_count" in fs
        assert any(k.startswith("opt|average|") for k in fs)
    for k in fs:
        np.testing.assert_array_equal(np.asarray(fd[k], np.float64),
                                      np.asarray(fs[k], np.float64),
                                      err_msg=k)


def _pass(tr, batches, k):
    stats = tr.train_one_pass(batches, steps_per_dispatch=k)
    return {n: (v.tolist() if isinstance(v, np.ndarray) else v)
            for n, v in stats.items()
            if n not in ("seconds", "samples_per_sec")}


@pytest.mark.parametrize("name", NAMES)
def test_fused_dispatch_equals_the_k1_loop(name):
    """train_one_pass(steps_per_dispatch=4) against the k = 1 loop from
    one seed, in float32, two passes of 5 batches (groups of up to 4
    consecutive batches of one shape): pass statistics (the chunk counts
    and `sum` included), parameters, optimizer slots, averages and their
    count bit for bit."""
    path, args = CONFIGS[name]
    cfg = parse_config(path, args)
    batches = _batches(cfg, 5)
    ref = Trainer(parse_config(path, args), device="cpu")
    tr = Trainer(parse_config(path, args), device="cpu")
    for _ in range(2):
        assert _pass(ref, batches, 1) == _pass(tr, batches, 4)
    for n, v in ref.params.items():
        assert torch.equal(v, tr.params[n]), n
    a, b = _flat(ref.opt_state, "opt"), _flat(tr.opt_state, "opt")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert 4 <= tr.n_fused_dispatches <= 2 * len(batches)
    if "average" in tr.opt_state:
        assert int(tr.opt_state["average_count"]) == 10


def test_cli_trains_rnn_crf_from_its_file(tmp_path):
    """`python -m paddle_tpu_torch train --config=demo/sequence_tagging/
    rnn_crf.py --use_gpu=false` in a subprocess from the repo root, on the
    config's own provider: one pass at batch 64 (16 batches) and the test
    pass exit 0; the pass row holds the chunk and sum evaluators' results,
    and the checkpoint the averages and their count (16 updates)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         f"--config={RNN_CRF}", "--use_gpu=false",
         "--config_args=batch_size=64", "--num_passes=1",
         f"--save_dir={tmp_path}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(tmp_path / "metrics.jsonl") as f:
        row = json.loads(f.readline())
    assert row["batches"] == 16 and np.isfinite(row["cost"])
    assert row["chunk_f1.true_chunks"] > 0 and "error.sum" in row
    data = ckpt.load_checkpoint(str(tmp_path / "pass-00000"))
    assert int(data["opt"]["average_count"]) == 16
    assert set(data["opt"]["average"]) == set(data["params"])
