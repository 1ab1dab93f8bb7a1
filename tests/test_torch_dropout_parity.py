"""Dropout masks, initial parameters and the trainer's key of the port
equal the JAX package's with nothing fed across: `Trainer(seed)` on both
sides draws its parameters from PRNGKey(seed) and its step keys by
splitting it, and dropout draws bernoulli(fold_in(step key, n), 1 - p)
with the port's threefry (utils/prng.py).

The stacked sentiment net (demo/sentiment, dict 50, hidden 32, batch 4)
on the CPU: the masks a TRAIN forward draws are bit-equal; the parameters
within 1e-6 where drawn uniform or zero and 2e-5 where normal (erfinv's
last bits); three batches' pass cost within 1e-4 relative; the key equal
after the pass and after test().  A model with a uniform parameter holds
the uniform draw too.
"""

import jax
import numpy as np
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.config.schema import ModelConfig as JModel
from paddle_tpu.config.schema import ParameterConfig as JParam
from paddle_tpu.graph.builder import GraphExecutor as JExecutor
from paddle_tpu.graph.context import TRAIN as JTRAIN
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.schema import ModelConfig, ParameterConfig
from paddle_tpu_torch.graph.context import TRAIN
from paddle_tpu_torch.parameter import init_params, params_from_jax
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.utils import prng
from test_torch_sentiment import (CONFIG, NETS, _batches, _jbatch,
                                  _tbatch)

SEED = 13


def _trainers():
    args, build = NETS["stacked"]
    return (JTrainer(parse_config(CONFIG, args), seed=SEED),
            Trainer(build(), device="cpu", seed=SEED))


def _strategy(pc) -> str:
    return "normal" if pc.initial_smart else pc.initial_strategy


def test_initial_parameters_equal_jax():
    jtr, ttr = _trainers()
    kinds = set()
    for pc in ttr.model.parameters:
        kind = _strategy(pc)
        kinds.add(kind)
        tol = 2e-5 if kind == "normal" else 1e-6
        np.testing.assert_allclose(ttr.params[pc.name].numpy(),
                                   np.asarray(jtr.params[pc.name]),
                                   rtol=0, atol=tol, err_msg=pc.name)
    assert "normal" in kinds
    # uniform and zero draws, exactly as JAX's executor draws them
    specs = [dict(name="u", dims=[6, 5], initial_strategy="uniform",
                  initial_mean=0.1, initial_std=0.3, initial_smart=False),
             dict(name="z", dims=[4], initial_strategy="zero",
                  initial_smart=False),
             dict(name="n", dims=[7, 3], initial_mean=-0.2, initial_std=0.5,
                  initial_smart=False)]
    jp = JExecutor(JModel(parameters=[JParam(**s) for s in specs])) \
        .init_params(jax.random.PRNGKey(4))
    tp = init_params(ModelConfig(parameters=[ParameterConfig(**s)
                                             for s in specs]),
                     seed=4, device="cpu")
    assert np.array_equal(tp["u"].numpy(), np.asarray(jp["u"]))
    assert np.array_equal(tp["z"].numpy(), np.asarray(jp["z"]))
    np.testing.assert_allclose(tp["n"].numpy(), np.asarray(jp["n"]),
                               rtol=0, atol=2e-5)


def test_dropout_masks_are_the_jax_draws(monkeypatch):
    """One TRAIN forward on each side with the trainer's first step key:
    every keep-mask, in draw order, bit-equal."""
    jtr, ttr = _trainers()
    b = _batches(1, seed=3)[0]
    key = jax.random.split(jax.random.PRNGKey(SEED))[1]
    jmasks, tmasks = [], []
    real_j, real_t = jax.random.bernoulli, prng.bernoulli

    def jrec(*a, **kw):
        m = real_j(*a, **kw)
        jmasks.append(np.asarray(m))
        return m

    def trec(*a, **kw):
        m = real_t(*a, **kw)
        tmasks.append(m.numpy())
        return m

    monkeypatch.setattr(jax.random, "bernoulli", jrec)
    monkeypatch.setattr(prng, "bernoulli", trec)
    jtr.executor.forward(jtr.params, _jbatch(b), {}, JTRAIN, key)
    params = params_from_jax({k: np.asarray(v) for k, v in
                              jtr.params.items()}, device="cpu")
    ttr.executor.forward(params, ttr.prepare_batch(_tbatch(b)), {}, TRAIN,
                         prng.split(prng.PRNGKey(SEED))[1])
    assert len(tmasks) == len(jmasks) > 0
    for t, j in zip(tmasks, jmasks):
        assert t.shape == j.shape and np.array_equal(t, j)
        assert 0 < t.mean() < 1


def test_training_losses_and_keys_follow_jax():
    """Three batches: the pass cost within 1e-4 relative, the key equal
    after the pass and after test()."""
    jtr, ttr = _trainers()
    bs = _batches(3, seed=5)
    js = jtr.train_one_pass(iter([_jbatch(b) for b in bs]))
    ts = ttr.train_one_pass([_tbatch(b) for b in bs])
    np.testing.assert_allclose(ts["cost"], js["cost"], rtol=1e-4)
    assert np.array_equal(ttr.rng.numpy(), np.asarray(jtr.rng))
    jt = jtr.test(iter([_jbatch(bs[0])]))
    tt = ttr.test([_tbatch(bs[0])])
    np.testing.assert_allclose(tt["cost"], jt["cost"], rtol=1e-4)
    assert np.array_equal(ttr.rng.numpy(), np.asarray(jtr.rng))
    assert not torch.equal(ttr.rng, prng.PRNGKey(SEED))
