"""PyTorch port: the trainer's fused dispatch (`train_one_pass(
steps_per_dispatch=k)`) on the CPU — against the port's own k = 1 loop
bit for bit, and against the JAX Trainer's fused dispatch at the same k.

Three models at a small size: the transformer LM (vocab 61, dim 32, 2
layers; block_k_min 16, so the flash route's plain version runs), the
stacked sentiment LSTM net (dropout 0.5 on every fc and lstmemory) and the
attention seq2seq (vocabulary 32, hidden 16).  Their batches alternate
between two padded lengths in runs of different sizes, so that a group
flushes both on a signature change and at k.  On the CPU the step runs
uncaptured (on the card each group is one replay of a CUDA graph of its
steps, tests/test_torch_cuda.py); what these tests hold is the grouping, the
order of updates, evaluator sums and losses, the device counters of the
updater and the dropout generator.  Against JAX: the pass cost within
rtol 1e-5 and the classification error within 1e-12, the tolerances of
tests/test_torch_train.py; the sentiment net fed the masks the JAX
Trainer draws for each step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.config.schema import OptimizationConfig as JOpt
from paddle_tpu.optim import schedulers as jsched
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.schema import OptimizationConfig
from paddle_tpu_torch.models import (seq2seq_trainer_config,
                                     stacked_lstm_net_config,
                                     transformer_lm_trainer_config)
from paddle_tpu_torch.optim import schedulers as tsched
from paddle_tpu_torch.parameter import Argument, params_from_jax
from paddle_tpu_torch.trainer import Trainer

B = 4
# padded lengths by batch: runs of 3, 2, 4 and 1, so k = 2 and k = 4 both
# flush on the signature changes and at k
PATTERN = (0, 0, 0, 1, 1, 0, 0, 0, 0, 1)


def _lens(T, rng):
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    return lens


def _lm_batches(n, seed, Ts=(24, 20), vocab=61):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = Ts[PATTERN[i % len(PATTERN)]]
        ids = rng.integers(2, vocab, (B, T + 1)).astype(np.int32)
        lens = _lens(T, rng)
        out.append({"tokens": (ids[:, :-1].copy(), lens),
                    "next_tokens": (ids[:, 1:].copy(), lens)})
    return out


def _sentiment_batches(n, seed, Ts=(9, 6), vocab=50):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = Ts[PATTERN[i % len(PATTERN)]]
        out.append({"word": (rng.integers(0, vocab, (B, T)).astype(np.int32),
                             _lens(T, rng)),
                    "label": (rng.integers(0, 2, B).astype(np.int32), None)})
    return out


def _seq2seq_batches(n, seed, Ts=(6, 4), vocab=32):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = Ts[PATTERN[i % len(PATTERN)]]
        src = rng.integers(3, vocab, (B, T)).astype(np.int32)
        lens = _lens(T, rng)
        trg = np.zeros((B, T + 1), np.int32)
        nxt = np.ones((B, T + 1), np.int32)
        for b in range(B):
            rev = src[b, :lens[b]][::-1]
            trg[b, 1:lens[b] + 1] = rev
            nxt[b, :lens[b]] = rev
        out.append({"source_language_word": (src, lens),
                    "target_language_word": (trg, lens + 1),
                    "target_language_next_word": (nxt, lens + 1)})
    return out


MODELS = {
    "lm": ("demo/model_zoo/transformer_lm.py",
           "vocab=61,dim=32,layers=2,heads=4,batch_size=4,block_k_min=16",
           lambda: transformer_lm_trainer_config(61, 32, 2, 4, batch_size=B,
                                                 block_k_min=16),
           _lm_batches),
    "sentiment": ("demo/sentiment/trainer_config.py",
                  "dict_dim=50,hid_dim=32,batch_size=4",
                  lambda: stacked_lstm_net_config(50, B, 32),
                  _sentiment_batches),
    "seq2seq": ("demo/seqToseq/seqToseq_net.py",
                "dict_size=32,hidden_dim=16,batch_size=4",
                lambda: seq2seq_trainer_config(32, 16, B),
                _seq2seq_batches),
}


def _tbatch(b):
    return {n: Argument(ids=ids, lengths=lens)
            for n, (ids, lens) in b.items()}


def _jbatch(b):
    return {n: JArgument(ids=jnp.asarray(ids),
                         lengths=None if lens is None else jnp.asarray(lens))
            for n, (ids, lens) in b.items()}


def _state(tr):
    """Everything a pass leaves behind, as host copies."""
    return ({n: p.clone() for n, p in tr.params.items()},
            {n: {k: v.clone() for k, v in sl.items()}
             for n, sl in tr.opt_state["slots"].items()},
            {k: tr.opt_state[k] for k in ("num_samples", "num_updates",
                                          "pass_id")},
            tr.dropout_rng.get_state().clone())


def _assert_same_state(a, b):
    pa, sa, ca, ga = a
    pb, sb, cb, gb = b
    assert sorted(pa) == sorted(pb)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        for k in sa.get(n, {}):
            assert torch.equal(sa[n][k], sb[n][k]), (n, k)
    assert ca == cb
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_fused_passes_equal_the_k1_loop(model, k):
    """Two passes of train_one_pass(steps_per_dispatch=k) against the same
    batches fed one train_one_batch at a time: equal pass statistics
    (cost, classification error, counts), parameters, optimizer slots and
    counters, and dropout generator state, bit for bit."""
    _, _, build, make = MODELS[model]
    batches = [_tbatch(b) for b in make(len(PATTERN), seed=3)]
    ref = Trainer(build(), device="cpu", seed=5)
    ref_stats = []
    for _ in range(2):
        losses = [ref.train_one_batch(b) for b in batches]
        stats = ref.evaluators.finalize(ref._acc)
        ref._acc = {}
        ref.opt_state = ref.updater.finish_pass(ref.opt_state)
        ref.pass_id += 1
        ref_stats.append((float(torch.stack(losses).numpy().sum())
                          / len(batches), stats))
    tr = Trainer(build(), device="cpu", seed=5)
    for want_cost, want_eval in ref_stats:
        got = tr.train_one_pass(batches, steps_per_dispatch=k)
        assert got["cost"] == want_cost
        assert {n: got[n] for n in want_eval} == want_eval
        assert (got["batches"], got["samples"]) == (len(batches),
                                                    B * len(batches))
    _assert_same_state(_state(ref), _state(tr))
    assert tr.pass_id == ref.pass_id == 2


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_fused_pass_matches_the_jax_fused_pass(model, k):
    """The port's fused pass against the JAX Trainer's at the same k from
    the same parameters: the pass cost within rtol 1e-5, the
    classification error within 1e-12, the counters equal.  The sentiment
    net's steps use the dropout masks the JAX Trainer draws for them."""
    path, args, build, make = MODELS[model]
    raw = make(5, seed=9)
    jtr = JTrainer(parse_config(path, args), seed=7)
    rng = np.random.default_rng(7)
    for name, v in jtr.params.items():
        if not np.asarray(v).any():
            jtr.params[name] = jnp.asarray(
                rng.standard_normal(v.shape).astype(np.float32) * 0.1)
    ttr = Trainer(build(), device="cpu", params=params_from_jax(
        {n: np.asarray(v) for n, v in jtr.params.items()}, device="cpu"))
    masks = None
    if any(l.drop_rate > 0 for l in ttr.model.layers):
        masks, key = [], jtr.rng
        for b in raw:
            key, sub = jax.random.split(key)
            masks.append(_jax_masks(ttr.model, sub, b["word"][0].shape))
    js = jtr.train_one_pass(iter([_jbatch(b) for b in raw]),
                            steps_per_dispatch=k)
    ts = ttr.train_one_pass([_tbatch(b) for b in raw], steps_per_dispatch=k,
                            dropout_masks=masks)
    assert ts["cost"] == pytest.approx(js["cost"], rel=1e-5)
    assert ts["classification_error"] == pytest.approx(
        js["classification_error"], abs=1e-12)
    assert (ts["batches"], ts["samples"]) == (js["batches"], js["samples"])
    for c in ("num_samples", "num_updates", "pass_id"):
        assert ttr.opt_state[c] == int(jtr.opt_state[c])
    assert ttr.n_fused_dispatches == jtr._n_fused_dispatches


def _jax_masks(model, key, word_shape):
    """The keep-masks the JAX forward draws from `key`: one
    bernoulli(fold_in(key, i), 1 - p) per layer with drop_rate > 0, i
    counting those layers in config order."""
    Bm, T = word_shape
    masks, i = {}, 0
    for layer in model.layers:
        if layer.drop_rate > 0:
            i += 1
            shape = ((Bm, T, layer.size) if layer.type == "lstmemory"
                     else (Bm, layer.size))
            masks[layer.name] = torch.from_numpy(np.array(
                jax.random.bernoulli(jax.random.fold_in(key, i),
                                     1.0 - layer.drop_rate, shape)))
    return masks


@pytest.mark.parametrize("n,k,groups", [(7, 3, 3), (8, 4, 2), (5, 1, 0),
                                        (1, 4, 1)])
def test_group_dispatch_count_is_ceil_n_over_k(n, k, groups):
    """n same-signature batches run in ceil(n/k) group dispatches (k = 1
    is the per-batch loop, no group); on the CPU no eager settling step."""
    tr = Trainer(MODELS["lm"][2](), device="cpu", seed=1)
    batches = [_tbatch(b) for b in _lm_batches(n, seed=2, Ts=(16, 16))]
    stats = tr.train_one_pass(batches, steps_per_dispatch=k)
    assert tr.n_fused_dispatches == groups
    assert tr.n_settle_steps == 0
    assert stats["batches"] == n and tr.opt_state["num_updates"] == n


def test_fused_dispatch_refuses_bad_k_and_bad_masks():
    tr = Trainer(MODELS["sentiment"][2](), device="cpu", seed=1)
    batches = [_tbatch(b) for b in _sentiment_batches(2, seed=1)]
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        tr.train_one_pass(batches, steps_per_dispatch=-1)
    name = next(l.name for l in tr.model.layers if l.drop_rate > 0)
    bad = [{name: torch.ones(1, 1, dtype=torch.bool)}] * 2
    with pytest.raises(ValueError, match="dropout mask"):
        tr.train_one_pass(batches, steps_per_dispatch=2, dropout_masks=bad)
    for k in (1, 2):
        with pytest.raises(ValueError, match="fewer entries"):
            tr.train_one_pass(batches, steps_per_dispatch=k,
                              dropout_masks=[{}])


def test_checkpoint_after_a_fused_pass_loads_in_jax(tmp_path):
    """A save() after a fused pass loads in the JAX Trainer: parameters and
    Adam slots equal, the counters 0-d int32 and equal."""
    tr = Trainer(MODELS["lm"][2](), device="cpu", seed=4)
    tr.train_one_pass([_tbatch(b) for b in _lm_batches(6, seed=5)],
                      steps_per_dispatch=4)
    d = tr.save(str(tmp_path))
    back = JTrainer(parse_config(*MODELS["lm"][:2]), seed=9)
    back.load(d)
    for n, v in tr.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[n]), v.numpy())
    for n, slots in tr.opt_state["slots"].items():
        for s, v in slots.items():
            np.testing.assert_array_equal(
                np.asarray(back.opt_state["slots"][n][s]), v.numpy())
    for c in ("num_samples", "num_updates", "pass_id"):
        assert np.asarray(back.opt_state[c]).dtype == np.int32
        assert int(back.opt_state[c]) == tr.opt_state[c]
    assert int(back.opt_state["num_updates"]) == 6


SCHEDULES = [("constant", 0.0, 0.0, ""), ("poly", 1e-3, 0.75, ""),
             ("caffe_poly", 3000.0, 2.0, ""), ("exp", 0.5, 400.0, ""),
             ("discexp", 0.5, 400.0, ""), ("linear", 2e-5, 1e-3, ""),
             ("manual", 0.0, 0.0, "100:1.0,500:0.5,1000:0.1"),
             ("pass_manual", 0.0, 0.0, "1:1.0,3:0.5,9:0.1")]


@pytest.mark.parametrize("sched,a,b,args", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_learning_rate_tensor_equals_the_host_form(sched, a, b, args):
    """The device form of every schedule, on 0-d counters, equals the host
    form bit for bit (and so stays within the host form's rtol 1e-6 of
    the JAX package's)."""
    kw = dict(learning_rate=0.1, learning_rate_decay_a=a,
              learning_rate_decay_b=b, learning_rate_schedule=sched,
              learning_rate_args=args)
    opt = OptimizationConfig(**kw)
    for x in list(range(0, 5000, 37)) + [77, 91, 500, 1000, 4999, 10 ** 6]:
        for pass_id in (0, 1, 3, 10):
            want = tsched.learning_rate_at(opt, x, pass_id)
            got = tsched.learning_rate_tensor(
                opt, torch.tensor(x), torch.tensor(pass_id))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert float(got) == want, (x, pass_id)
            assert want == pytest.approx(
                float(jsched.learning_rate_at(JOpt(**kw), x, pass_id)),
                rel=1e-6, abs=0)


def test_updates_write_in_place_and_counters_follow_the_host():
    """The k = 1 step writes the new parameters and Adam slots into their
    tensors (a captured step replays into the same addresses); the
    updater's device counters follow the host counters, also across the
    end of a pass and a checkpoint load."""
    tr = Trainer(MODELS["lm"][2](), device="cpu", seed=2)
    ptrs = {n: p.data_ptr() for n, p in tr.params.items()}
    slot_ptrs = {(n, k): v.data_ptr()
                 for n, sl in tr.opt_state["slots"].items()
                 for k, v in sl.items()}
    batches = [_tbatch(b) for b in _lm_batches(3, seed=1)]
    tr.train_one_pass(batches)
    counters = tr.updater._counters     # one tensor for the trainer's life
    assert {n: p.data_ptr() for n, p in tr.params.items()} == ptrs
    assert {(n, k): v.data_ptr() for n, sl in tr.opt_state["slots"].items()
            for k, v in sl.items()} == slot_ptrs
    assert tr.updater._counters.tolist() == [3 * B, 3, 0]
    tr.train_one_batch(batches[0])
    assert tr.updater._counters.tolist() == [4 * B, 4, 1]
    tr.opt_state = dict(tr.opt_state, num_samples=100, num_updates=7)
    tr.updater.load_counters(tr.opt_state, tr.device)
    assert tr.updater._counters.tolist() == [100, 7, 1]
    tr.train_one_pass(batches, steps_per_dispatch=2)
    assert tr.updater._counters is counters
    # the end of a pass moves the host's pass_id; the device copy follows
    # at the next step
    assert counters.tolist() == [100 + 3 * B, 10, 1]
    assert tr.opt_state["pass_id"] == 2
