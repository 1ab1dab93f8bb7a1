"""PyTorch port: carried recurrent state (--prev_batch_state) and the
nested configs under the Trainer, against the JAX package on the CPU.

- The chunk oracle (tests/test_inventory.py's): two consecutive chunks of
  T/2 with the flag end where one whole-T forward ends, for lstmemory,
  gated_recurrent and recurrent, on ragged rows (a row ending in the
  first chunk keeps its state through the second).
- The Trainer with the flag against the JAX Trainer over four batches, the
  third of another size (the carried state is then ignored, and the next
  batch ignores the third's): each loss, the parameters and `net_state`;
  `test()` reads the state and leaves it; a reversed layer carries none;
  checkpoints both ways keep the state.
- `steps_per_dispatch=4` against 1 on the CPU, bit for bit: a nested
  config, and a flag run whose batches change size.

Limits: float32 on both sides; losses within rtol 1e-4, parameters' moves
and states within 1e-4 of their max |value| (the JAX LSTM and GRU run
lax.scan, the port's their kernels' plain versions); the chunk oracle
within 1e-5 (atol 1e-6)."""

import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config as jparse
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils.flags import FLAGS as JFLAGS
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.parameter import Argument, params_from_jax
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.utils.flags import FLAGS

from test_torch_nested import NEST, _batch, _docs, _share, _t

# one recurrent layer of each kind behind a linear projection, and a
# reversed LSTM (which never carries its state) beside it
CARRY = """
from paddle_tpu.dsl import *
kind = get_config_arg("kind", str, "lstm")
H = 6
settings(batch_size=4, learning_rate=0.05,
         learning_method=MomentumOptimizer(momentum=0.9))
x = data_layer(name="x", size=5)
if kind == "lstm":
    rnn = lstmemory(input=fc_layer(input=x, size=4 * H,
                                   act=LinearActivation()), name="rnn")
elif kind == "gru":
    rnn = grumemory(input=fc_layer(input=x, size=3 * H,
                                   act=LinearActivation()), name="rnn")
else:
    rnn = recurrent_layer(input=fc_layer(input=x, size=H,
                                         act=LinearActivation()), name="rnn")
rev = lstmemory(input=fc_layer(input=x, size=4 * H, act=LinearActivation()),
                reverse=True, name="rev")
prob = fc_layer(input=[last_seq(input=rnn), first_seq(input=rev)], size=2,
                act=SoftmaxActivation())
classification_cost(input=prob, label=data_layer(name="label", size=2))
"""
KINDS = {"lstmemory": "lstm", "gated_recurrent": "gru",
         "recurrent": "rnn"}
LOSS_RTOL, SHARE = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def carry_flag():
    """--prev_batch_state on both sides for one test."""
    saved = FLAGS.prev_batch_state, JFLAGS.prev_batch_state
    FLAGS.prev_batch_state = JFLAGS.prev_batch_state = True
    yield
    FLAGS.prev_batch_state, JFLAGS.prev_batch_state = saved


@pytest.fixture(scope="module")
def carry_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("carry") / "carry.py"
    path.write_text(CARRY)
    return str(path)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy() if torch.is_tensor(tree) \
        else np.array(tree)


def _seq_batch(rng, B, T=6):
    x = rng.standard_normal((B, T, 5)).astype(np.float32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    y = rng.integers(0, 2, B).astype(np.int32)
    return {"x": Argument(value=x, lengths=lens), "label": Argument(ids=y)}


def _jb(batch):
    def j(a):
        return None if a is None else np.asarray(a)
    return {n: JArgument(value=j(a.value), ids=j(a.ids), lengths=j(a.lengths))
            for n, a in batch.items()}


@pytest.mark.parametrize("layer", sorted(KINDS))
def test_two_chunks_with_the_flag_equal_one_whole_forward(layer, carry_path,
                                                          carry_flag):
    """The chunk oracle: a [B, 8] sequence fed as two chunks of 4 steps
    under the flag, the second booted from the first's final state, ends
    in the state one 8-step forward ends in, and each row's last valid
    output is the same (rows of length 8, 5 and 3: the last ends inside
    the first chunk and carries its state through an empty second)."""
    cfg = parse_config(carry_path, f"kind={KINDS[layer]}")
    tr = Trainer(cfg, device="cpu")
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((3, 8, 5)).astype(np.float32))
    lens = torch.tensor([8, 5, 3], dtype=torch.int32)
    first = torch.minimum(lens, torch.tensor(4, dtype=torch.int32))
    second = lens - first
    y = Argument(ids=torch.zeros(3, dtype=torch.long))
    ex = tr.executor

    def fwd(xs, ln, state):
        return ex.forward(tr.params, {"x": Argument(value=xs, lengths=ln),
                                      "label": y}, state=state)

    out1, _, st1 = fwd(x[:, :4], first, {})
    out2, _, st2 = fwd(x[:, 4:], second, st1)
    full, _, stf = fwd(x, lens, {})
    assert set(st1) == set(stf) == ({"rnn:h", "rnn:c"} if layer ==
                                    "lstmemory" else {"rnn:h"})
    for key in stf:
        np.testing.assert_allclose(st2[key].numpy(), stf[key].numpy(),
                                   rtol=1e-5, atol=1e-6)
    for b, n in enumerate(lens.tolist()):
        got = (out2["rnn"].value[b, n - 5] if n > 4
               else out1["rnn"].value[b, n - 1])
        np.testing.assert_allclose(got.numpy(),
                                   full["rnn"].value[b, n - 1].numpy(),
                                   rtol=1e-5, atol=1e-6)
    # without the flag the second chunk starts from zeros
    FLAGS.prev_batch_state = False
    _, _, none = fwd(x[:, 4:], second, st1)
    assert none == {}


def _jax_and_port(path, args, seed=3):
    jtr = JTrainer(jparse(path, args), seed=seed)
    ttr = Trainer(parse_config(path, args), device="cpu",
                  params=params_from_jax({k: np.asarray(v) for k, v in
                                          jtr.params.items()}, device="cpu"))
    return jtr, ttr


@pytest.mark.parametrize("layer", sorted(KINDS))
def test_trainer_with_the_flag_matches_jax(layer, carry_path, carry_flag,
                                           tmp_path):
    """Four Trainer steps with --prev_batch_state, batches of 4, 4, 3 and 4
    rows: every loss, the parameters and the carried state against the
    JAX Trainer; the reversed LSTM carries nothing; test() reads the state
    (its cost as JAX's) and leaves it; a checkpoint carries it both
    ways."""
    jtr, ttr = _jax_and_port(carry_path, f"kind={KINDS[layer]}")
    rng = np.random.default_rng(5)
    batches = [_seq_batch(rng, B) for B in (4, 4, 3, 4)]
    p0 = _np(ttr.params)
    for i, b in enumerate(batches):
        jl = float(jtr.train_one_batch(_jb(b)))
        tl = float(ttr.train_one_batch(b))
        assert tl == pytest.approx(jl, rel=LOSS_RTOL), i
        want, got = _np(jtr.net_state), _np(ttr.net_state)
        assert set(got) == set(want)
        assert all(k.startswith("rnn:") for k in got)
        for k in want:
            assert got[k].shape[0] == b["x"].value.shape[0]
            assert _share(got[k], want[k]) <= SHARE, (i, k)
    jp, tp = _np(jtr.params), _np(ttr.params)
    for n in jp:
        assert _share(tp[n] - p0[n], jp[n] - p0[n]) <= SHARE, n

    before = _np(ttr.net_state)
    tb = [_seq_batch(np.random.default_rng(6), 4)]
    got, want = ttr.test(tb), jtr.test([_jb(b) for b in tb])
    assert got["cost"] == pytest.approx(want["cost"], rel=LOSS_RTOL)
    assert all(np.array_equal(v, _np(ttr.net_state)[k])
               for k, v in before.items())
    # the carried state shapes test(): without it the cost differs
    FLAGS.prev_batch_state = False
    assert ttr.test(tb)["cost"] != got["cost"]
    FLAGS.prev_batch_state = True

    saved = ttr.save(str(tmp_path / "port"))
    back = Trainer(parse_config(carry_path, f"kind={KINDS[layer]}"),
                   device="cpu")
    back.load(saved)
    jtr.load(saved)
    for k, v in before.items():
        assert np.array_equal(_np(back.net_state)[k], v)
        assert np.array_equal(np.asarray(jtr.net_state[k]), v)


@pytest.mark.parametrize("run", ["nested", "carry"])
def test_four_steps_per_dispatch_equal_one(run, carry_path, carry_flag):
    """steps_per_dispatch=4 against 1 on the CPU, bit for bit over two
    passes: the nested config (ragged sub-sequence counts, an empty
    sub-sequence) and a flag run whose batches change size (4 rows, then
    3, then 4 again)."""
    if run == "nested":
        batches = [_batch(_docs(s, 4), True) for s in range(6)]
        path, args = NEST, ""
    else:
        rng = np.random.default_rng(8)
        batches = [_seq_batch(rng, B) for B in (4, 4, 4, 4, 4, 3, 4, 4)]
        path, args = carry_path, "kind=lstm"
    runs = []
    for k in (1, 4):
        tr = Trainer(parse_config(path, args), device="cpu", seed=2)
        stats = [tr.train_one_pass(batches, steps_per_dispatch=k)["cost"]
                 for _ in range(2)]
        runs.append((stats, _np(tr.params), _np(tr.net_state),
                     tr.n_fused_dispatches))
    (c1, p1, s1, _), (c4, p4, s4, nd) = runs
    assert c1 == c4
    assert nd == (2 * 2 if run == "nested" else 2 * 4)
    for n in p1:
        assert np.array_equal(p1[n], p4[n]), n
    assert s1.keys() == s4.keys() and (run == "nested") == (not s1)
    for k in s1:
        assert np.array_equal(s1[k], s4[k]), k
