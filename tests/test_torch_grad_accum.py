"""PyTorch port: gradient accumulation and pruning hooks through the
Trainer, against the JAX package's Trainer on the CPU.

One config file (an MLP with Momentum, a tanh hidden layer) parsed by both
packages; both trainers start from the JAX trainer's parameters and see the
same numpy batches.  Held within 1e-5: accumulation over unequal
micro-batches against the batches concatenated and against the JAX
trainer, the partial window dropped at the end of a pass, the fused pass
at k = 2 (and bit for bit against k = 1), pruning by ratio and by mask
file, and a JAX checkpoint taken mid-window resumed in the port."""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.parameter import Argument, params_from_jax
from paddle_tpu_torch.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)

CONFIG = """
from paddle_tpu.dsl import *
accum = get_config_arg("accum", int, 1)
bs = get_config_arg("bs", int, 8)
hook = get_config_arg("hook", str, "")
settings(batch_size=bs, learning_rate=0.1,
         learning_method=MomentumOptimizer(momentum=0.9),
         num_batches_per_send_parameter=accum)
hooks = {"": None,
         "ratio": [{"type": "pruning", "sparsity_ratio": 0.6}],
         "file": [{"type": "pruning", "mask_filename": "MASK"}]}[hook]
x = data_layer(name="x", size=12)
h = fc_layer(input=x, size=16, act=TanhActivation(),
             param_attr=ParamAttr(name="w_h", update_hooks=hooks))
out = fc_layer(input=h, size=3, act=SoftmaxActivation())
classification_cost(input=out, label=data_layer(name="y", size=3))
"""


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("accum")
    mask = (np.arange(12 * 16) % 4 != 1).astype(np.float32).reshape(12, 16)
    np.save(d / "mask.npy", mask)
    path = d / "mlp.py"
    path.write_text(CONFIG.replace("MASK", str(d / "mask.npy")))
    return str(path), mask


def _micro(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 12)).astype(np.float32),
             rng.integers(0, 3, n).astype(np.int32)) for n in sizes]


def _jbatch(x, y):
    return {"x": JArgument(value=x), "y": JArgument(ids=y)}


def _tbatch(x, y):
    return {"x": Argument(value=x), "y": Argument(ids=y)}


def _pair(path, args):
    jtr = JTrainer(jax_parse_config(path, args), seed=1)
    start = {k: np.asarray(v) for k, v in jtr.params.items()}
    ttr = Trainer(parse_config(path, args), device="cpu",
                  params=params_from_jax(start, device="cpu"))
    return jtr, ttr


def _same_params(ttr, want, what, **tol):
    for n, v in want.items():
        np.testing.assert_allclose(ttr.params[n].numpy(), np.asarray(v),
                                   **(tol or TOL), err_msg=f"{what}: {n}")


@pytest.mark.parametrize("sizes", [(8, 8, 8, 8, 8, 8), (8, 3, 5, 6, 2, 4)],
                         ids=["equal", "unequal"])
def test_accumulation_equals_the_concatenated_batches(config_file, sizes):
    """N = 3: each window's one update equals one step on its three
    micro-batches concatenated (sample-weighted, so also for unequal
    sizes), and the JAX trainer's; the counters move on apply steps
    only."""
    path, _ = config_file
    micro = _micro(sizes)
    jtr, ttr = _pair(path, "accum=3")
    cat = Trainer(parse_config(path, "accum=1"), device="cpu",
                  params={n: p.clone() for n, p in ttr.params.items()})
    for x, y in micro:
        jtr.train_one_batch(_jbatch(x, y))
        ttr.train_one_batch(_tbatch(x, y))
    for i in (0, 3):
        cat.train_one_batch(_tbatch(
            np.concatenate([m[0] for m in micro[i:i + 3]]),
            np.concatenate([m[1] for m in micro[i:i + 3]])))
    _same_params(ttr, {n: p.numpy() for n, p in cat.params.items()},
                 "accumulated vs concatenated")
    _same_params(ttr, jtr.params, "port vs JAX")
    st = ttr.opt_state
    assert (st["num_updates"], st["num_samples"]) == (2, sum(sizes))
    assert (st["grad_accum_count"], st["grad_accum_samples"]) == (0, 0)
    assert int(jtr.opt_state["num_updates"]) == 2


def test_a_partial_window_is_dropped_at_the_end_of_a_pass(config_file):
    """Four micro-batches at N = 3: the fourth's gradient is dropped when
    the pass ends (its sums zeroed in place), as in the JAX trainer; the
    next pass starts a fresh window."""
    path, _ = config_file
    micro = _micro((8, 8, 8, 8))
    jtr, ttr = _pair(path, "accum=3")
    acc = dict(ttr.opt_state["grad_accum"])
    for _ in range(2):
        jtr.train_one_pass(batches=iter([_jbatch(*m) for m in micro]))
        ttr.train_one_pass([_tbatch(*m) for m in micro])
        st = ttr.opt_state
        assert (st["grad_accum_count"], st["grad_accum_samples"]) == (0, 0)
        assert all(a is acc[n] and not a.any()
                   for n, a in st["grad_accum"].items())
        assert int(jtr.opt_state["grad_accum_count"]) == 0
    assert ttr.opt_state["num_updates"] == 2
    _same_params(ttr, jtr.params, "after two passes")


def test_fused_k2_equals_k1_and_the_jax_fused_pass(config_file):
    """N = 3 with steps_per_dispatch = 2 (windows straddle the groups):
    bit for bit the k = 1 pass, and the JAX trainer's fused pass within
    1e-5."""
    path, _ = config_file
    micro = _micro((8,) * 7, seed=3)
    jtr, k2 = _pair(path, "accum=3")
    k1 = Trainer(parse_config(path, "accum=3"), device="cpu",
                 params={n: p.clone() for n, p in k2.params.items()})
    jtr.train_one_pass(batches=iter([_jbatch(*m) for m in micro]),
                       steps_per_dispatch=2)
    s2 = k2.train_one_pass([_tbatch(*m) for m in micro],
                           steps_per_dispatch=2)
    s1 = k1.train_one_pass([_tbatch(*m) for m in micro])
    assert s2["cost"] == s1["cost"]
    for n, p in k1.params.items():
        assert torch.equal(k2.params[n], p), n
    _same_params(k2, jtr.params, "k = 2 vs JAX")


@pytest.mark.parametrize("hook", ["ratio", "file"])
def test_pruning_hooks_match_jax(config_file, hook):
    """A pruning hook on the hidden layer's weight, by ratio (the 60%
    smallest |w|) or from a .npy mask: the mask equals the JAX trainer's,
    pruned entries stay exactly zero through three steps, and the
    parameters agree."""
    path, mask = config_file
    jtr, ttr = _pair(path, f"hook={hook}")
    want = np.asarray(jtr.opt_state["masks"]["w_h"])
    got = ttr.opt_state["masks"]["w_h"].numpy()
    np.testing.assert_array_equal(got, want)
    if hook == "file":
        np.testing.assert_array_equal(got, mask)
    else:
        assert int((got == 0).sum()) == int(0.6 * got.size)
    for x, y in _micro((8, 8, 8), seed=4):
        jtr.train_one_batch(_jbatch(x, y))
        ttr.train_one_batch(_tbatch(x, y))
    w = ttr.params["w_h"].numpy()
    assert not w[got == 0].any()
    _same_params(ttr, jtr.params, f"pruned by {hook}")


def test_a_jax_checkpoint_taken_mid_window_resumes_in_the_port(
        config_file, tmp_path):
    """The JAX trainer (N = 3, pruning by ratio) trains two micro-batches
    and saves: the port loads the checkpoint with its window's sums, count
    and samples and the masks, and both sides then train the same four
    micro-batches to the same parameters."""
    path, _ = config_file
    args = "accum=3,hook=ratio"
    micro = _micro((8, 6, 8, 4, 8, 8), seed=5)
    jtr = JTrainer(jax_parse_config(path, args), seed=1)
    for m in micro[:2]:
        jtr.train_one_batch(_jbatch(*m))
    saved = jtr.save(str(tmp_path / "jax"))
    assert int(jtr.opt_state["grad_accum_count"]) == 2
    ttr = Trainer(parse_config(path, args), device="cpu", seed=9)
    ttr.load(saved)
    st = ttr.opt_state
    assert (st["grad_accum_count"], st["grad_accum_samples"]) == (2, 14)
    for n, a in jtr.opt_state["grad_accum"].items():
        np.testing.assert_array_equal(st["grad_accum"][n].numpy(),
                                      np.asarray(a), err_msg=n)
    np.testing.assert_array_equal(st["masks"]["w_h"].numpy(),
                                  np.asarray(jtr.opt_state["masks"]["w_h"]))
    for m in micro[2:]:
        jtr.train_one_batch(_jbatch(*m))
        ttr.train_one_batch(_tbatch(*m))
    assert ttr.opt_state["num_updates"] == int(
        jax.device_get(jtr.opt_state["num_updates"])) == 2
    _same_params(ttr, jtr.params, "resumed mid-window")
