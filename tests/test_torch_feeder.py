"""PyTorch port: the data provider and feeder against the JAX package's,
and the trainer's passes over them on the CPU.

The port's batches equal the JAX feeder's exactly — ids, values, lengths,
padding, bucket lengths and order — for every demo config with a data
source (training passes shuffled and bucketed, synchronous and
prefetched on a thread; test passes in order), for a ratio-mixed `multi`
source, and for nested-sequence and sparse slots.  A pass at
steps_per_dispatch=4 over the feeder's batches ends where the k = 1 pass
does, bit for bit."""

import importlib
import os
import textwrap
import types

import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.parameter import Argument
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer.trainer import make_feeder

# the modules by name: each data package exports a `provider` decorator
jax_feeder = importlib.import_module("paddle_tpu.data.feeder")
jax_provider = importlib.import_module("paddle_tpu.data.provider")
feeder = importlib.import_module("paddle_tpu_torch.data.feeder")
provider = importlib.import_module("paddle_tpu_torch.data.provider")

FIELDS = ("value", "ids", "lengths", "sub_lengths", "sparse_vals")

SOURCES = [
    ("demo/sentiment/trainer_config.py", ""),
    ("demo/sentiment/trainer_config.py", "batch_size=8"),
    ("demo/model_zoo/transformer_lm.py", ""),
    ("demo/seqToseq/seqToseq_net.py", ""),
    ("demo/distributed/mlp_dist.py", ""),
    ("demo/image_classification/vgg_16_cifar.py", ""),
    ("demo/introduction/trainer_config.py", ""),
    ("demo/mnist/mlp_mnist.py", ""),
    ("demo/quick_start/trainer_config.lstm.py", ""),
    ("demo/quick_start/trainer_config.lr.py", ""),
    ("demo/recommendation/trainer_config.py", ""),
    ("demo/semantic_role_labeling/db_lstm.py", ""),
    ("demo/sequence_tagging/linear_crf.py", ""),
]


def assert_same_batches(want: list, got: list) -> None:
    """Batch lists equal exactly: keys, every field's dtype, shape and
    values, sparse widths."""
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert list(g) == list(w), i
        for name in w:
            for f in FIELDS:
                a, b = getattr(w[name], f), getattr(g[name], f)
                assert (a is None) == (b is None), (i, name, f)
                if a is not None:
                    a = np.asarray(a)
                    assert b.dtype == a.dtype and b.shape == a.shape, \
                        (i, name, f)
                    np.testing.assert_array_equal(b, a, err_msg=f"{i} {name}")
            assert g[name].sparse_dim == w[name].sparse_dim


def _sides(path: str, args: str, seed: int = 1):
    """A JAX stand-in trainer and a port one for the data methods: the
    JAX Trainer's own `_feeder` and `train_batches` run on it, without
    building a model."""
    jcfg, cfg = jax_parse_config(path, args), parse_config(path, args)
    jside = types.SimpleNamespace(model=jcfg.model_config,
                                  opt=jcfg.opt_config, seed=seed,
                                  config=jcfg)
    jside._feeder = lambda d, train: JTrainer._feeder(jside, d, train)
    tside = types.SimpleNamespace(config=cfg)
    tside._feeder = lambda d, train: make_feeder(cfg, d, train, seed)
    return jside, tside


@pytest.mark.parametrize("path,args", SOURCES,
                         ids=[f"{p}[{a}]" for p, a in SOURCES])
def test_batches_equal_the_jax_feeder(path, args):
    """A training pass (shuffled, bucketed, the last short batch dropped)
    assembled synchronously and on the prefetch thread, and the test
    source's pass in order."""
    jside, tside = _sides(path, args)
    for async_load in (False, True):
        jside.config.data_config.async_load_data = async_load
        tside.config.data_config.async_load_data = async_load
        want = list(JTrainer.train_batches(jside))
        got = list(Trainer.train_batches(tside))
        assert want
        assert_same_batches(want, got)
        assert all(isinstance(a, Argument) for b in got for a in b.values())
    if jside.config.test_data_config is not None:
        assert_same_batches(
            list(jside._feeder(jside.config.test_data_config,
                               False).batches()),
            list(tside._feeder(tside.config.test_data_config,
                               False).batches()))


MULTI = """
    from paddle_tpu.dsl import *
    define_multi_py_data_sources2(
        train_sources=[
            {"files": "demo/sentiment/train.list",
             "module": "demo.sentiment.sentiment_provider", "obj": "process"},
            {"files": "demo/sentiment/test.list",
             "module": "demo.sentiment.sentiment_provider", "obj": "process"}],
        test_sources=[
            {"files": "demo/sentiment/test.list",
             "module": "demo.sentiment.sentiment_provider", "obj": "process"},
            {"files": "demo/sentiment/test.list",
             "module": "demo.sentiment.sentiment_provider", "obj": "process"}],
        ratios=[3, 1])
    settings(batch_size=16, learning_rate=1e-3)
    word = data_layer(name="word", size=2000)
    out = fc_layer(input=last_seq(embedding_layer(input=word, size=8)),
                   size=2, act=SoftmaxActivation())
    classification_cost(input=out, label=data_layer(name="label", size=2))
    """


def test_multi_source_batches_equal_the_jax_feeder(tmp_path):
    """define_multi_py_data_sources2: the ratio-mixed training stream and
    the concatenated test stream."""
    path = tmp_path / "multi.py"
    path.write_text(textwrap.dedent(MULTI))
    jside, tside = _sides(str(path), "", seed=5)
    assert tside.config.data_config.type == "multi"
    want = list(JTrainer.train_batches(jside))
    # rounds of 3 + 1 samples until the 256-sample source drains: 1024
    assert len(want) == 64
    assert_same_batches(want, list(Trainer.train_batches(tside)))
    assert_same_batches(
        list(jside._feeder(jside.config.test_data_config, False).batches()),
        list(tside._feeder(tside.config.test_data_config, False).batches()))


def _samples(rng, n: int):
    """Samples of every slot kind the feeder packs: dense, id, sparse
    binary and sparse value rows, as plain, sequence and nested
    sequence."""
    out = []
    for _ in range(n):
        def seq():
            return int(rng.integers(1, 6))
        def sparse_bin():
            return rng.choice(50, int(rng.integers(0, 5)),
                              replace=False).tolist()
        def sparse_val():
            return [(int(i), float(rng.random())) for i in
                    rng.choice(50, int(rng.integers(1, 4)), replace=False)]
        out.append([
            rng.random(3).tolist(), int(rng.integers(0, 7)), sparse_bin(),
            sparse_val(),
            [rng.random(3).tolist() for _ in range(seq())],
            rng.integers(0, 9, seq()).tolist(),
            [sparse_bin() for _ in range(seq())],
            [sparse_val() for _ in range(seq())],
            [rng.integers(0, 9, seq()).tolist() for _ in range(seq())],
            [[rng.random(3).tolist() for _ in range(seq())]
             for _ in range(seq())],
            [[sparse_bin() for _ in range(seq())] for _ in range(seq())],
        ])
    return out


SLOT_TYPES = [
    ("dense_vector", 3), ("integer_value", 7), ("sparse_binary_vector", 50),
    ("sparse_vector", 50), ("dense_vector_sequence", 3),
    ("integer_value_sequence", 9), ("sparse_binary_vector_sequence", 50),
    ("sparse_vector_sequence", 50), ("integer_value_sub_sequence", 9),
    ("dense_vector_sub_sequence", 3),
    ("sparse_binary_vector_sub_sequence", 50)]


def test_make_batch_packs_every_slot_kind_as_the_jax_feeder():
    samples = _samples(np.random.default_rng(0), 6)
    names = [f"s{i}" for i in range(len(SLOT_TYPES))]
    jtypes = [getattr(jax_provider, f)(d) for f, d in SLOT_TYPES]
    ttypes = [getattr(provider, f)(d) for f, d in SLOT_TYPES]
    want = jax_feeder.make_batch(samples, jtypes, names)
    got = feeder.make_batch(samples, ttypes, names)
    assert_same_batches([want], [got])
    with pytest.raises(ValueError, match="out of range"):
        feeder.make_batch([[[60]]], [provider.sparse_binary_vector(50)],
                          ["x"])


def test_device_double_buffer_runs_ahead_and_propagates_failures():
    seen = []

    def items():
        for i in range(5):
            seen.append(i)
            yield i
        raise KeyError("provider failed")

    buf = feeder.DeviceDoubleBuffer(items(), lambda x: x * 10)
    it = iter(buf)
    assert next(it) == 0
    got = [next(it) for _ in range(4)]
    assert got == [10, 20, 30, 40]
    with pytest.raises(KeyError, match="provider failed"):
        next(it)
    buf = feeder.DeviceDoubleBuffer(iter(range(100)), lambda x: x)
    assert next(iter(buf)) == 0
    buf.close()
    assert not buf._thread.is_alive()


def _state(tr: Trainer) -> dict:
    out = {f"p.{n}": p for n, p in tr.params.items()}
    out.update({f"s.{n}.{k}": v for n, sl in tr.opt_state["slots"].items()
                for k, v in sl.items()})
    return out


def _timeless(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if k not in ("seconds", "samples_per_sec")}


# (config, args, batches a pass): the LM, the sentiment net with its
# dropout (four padded lengths), the seq2seq (two)
KSTEP_CONFIGS = [
    ("demo/model_zoo/transformer_lm.py", "vocab=64,dim=32,layers=1,heads=2",
     16),
    ("demo/sentiment/trainer_config.py", "hid_dim=32,batch_size=256", 8),
    ("demo/seqToseq/seqToseq_net.py", "hidden_dim=16,batch_size=512", 8),
]


@pytest.fixture
def one_thread():
    """Many small ops: one torch thread keeps them from spinning against
    the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path,args,n", KSTEP_CONFIGS,
                         ids=["lm", "sentiment", "seq2seq"])
def test_k4_over_the_feeder_equals_k1_bit_for_bit(path, args, n, one_thread):
    """train_one_pass() without batches: a pass of the config's source,
    staged a group ahead on the double buffer's thread at
    steps_per_dispatch=4; statistics, parameters, optimizer slots,
    counters and the dropout generator as the k = 1 pass leaves them, and
    test() on the test source equal."""
    cfg = parse_config(path, args)
    one, four = (Trainer(cfg, seed=3, device="cpu") for _ in range(2))
    s1 = one.train_one_pass()
    s4 = four.train_one_pass(steps_per_dispatch=4)
    assert _timeless(s4) == _timeless(s1)
    assert s1["batches"] == n
    a, b = _state(one), _state(four)
    bad = [n for n in a if not torch.equal(a[n], b[n])]
    assert not bad, bad[:5]
    assert one.opt_state["num_updates"] == four.opt_state["num_updates"]
    assert torch.equal(one.rng, four.rng)
    assert n // 4 <= four.n_fused_dispatches < n
    if cfg.test_data_config is not None:
        assert one.test() == four.test()


def test_a_training_step_is_deterministic_on_the_cpu():
    """Two trainers from one seed take the same steps on batches of 128
    with the default torch threads: bit-identical parameters.  (The
    table projection's gradient through W[ids] accumulated in a
    thread-dependent order on the CPU; F.embedding's does not.)"""
    cfg = parse_config("demo/seqToseq/seqToseq_net.py", "batch_size=128")
    batches = list(make_feeder(cfg, cfg.data_config, True).batches())[:2]
    a, b = (Trainer(cfg, seed=2, device="cpu") for _ in range(2))
    for batch in batches:
        la, lb = a.train_one_batch(batch), b.train_one_batch(batch)
        assert torch.equal(la, lb)
    sa, sb = _state(a), _state(b)
    assert [n for n in sa if not torch.equal(sa[n], sb[n])] == []


def test_data_paths_that_refuse():
    lm = parse_config("demo/model_zoo/transformer_lm.py",
                      "vocab=64,dim=16,layers=1,heads=2")
    tr = Trainer(lm, device="cpu")
    with pytest.raises(ValueError, match="test data source"):
        tr.test()
    bare = parse_config("demo/model_zoo/transformer_lm.py",
                        "vocab=64,dim=16,layers=1,heads=2")
    bare.data_config = None
    with pytest.raises(ValueError, match="no data source"):
        Trainer(bare, device="cpu").train_one_pass()
    shards = parse_config("demo/model_zoo/transformer_lm.py",
                          "vocab=64,dim=16,layers=1,heads=2")
    shards.data_config.type = "ptsh"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(shards, device="cpu").train_one_pass()
    # a nested feed is taken whole: the feeder's packing of sub-sequences
    # is the JAX make_batch's, and prepare_batch moves it with its
    # sub_lengths; sub_lengths without the sub-sequence counts raise
    from paddle_tpu.data.feeder import make_batch as jmake_batch
    from paddle_tpu_torch.data.feeder import make_batch
    jprov = importlib.import_module("paddle_tpu.data.provider")
    tprov = importlib.import_module("paddle_tpu_torch.data.provider")
    docs = [([[1, 2, 3], [4]], [5, 6]), ([[7], [], [8, 9]], [1])]
    names = ["tokens", "next_tokens"]
    got = make_batch(docs, [tprov.integer_value_sub_sequence(64),
                            tprov.integer_value_sequence(64)], names)
    want = jmake_batch(docs, [jprov.integer_value_sub_sequence(64),
                              jprov.integer_value_sequence(64)], names)
    moved = tr.prepare_batch(got)
    for name in names:
        for field in ("ids", "lengths", "sub_lengths"):
            w = getattr(want[name], field)
            m = getattr(moved[name], field)
            assert (w is None) == (m is None), (name, field)
            if w is not None:
                np.testing.assert_array_equal(m.numpy(), np.asarray(w))
    assert moved["tokens"].ids.dtype == torch.int64
    with pytest.raises(ValueError, match="sub-sequence counts"):
        tr.prepare_batch({"tokens": Argument(
            ids=got["tokens"].ids, sub_lengths=got["tokens"].sub_lengths),
            "next_tokens": got["next_tokens"]})
    assert os.path.exists("demo/model_zoo/lm_train.list")
