"""PyTorch port: nested sequences against the JAX package on the CPU — the
nested sequence ops (ops/sequence.py), the nested pooling layers with and
without agg_level='seq', expand / subseq / seqconcat / seqreshape /
lstm_step, the hierarchical recurrent groups of
tests/configs/sequence_nest_rnn*.py and of a hierarchical LSTM, sparse
in-links of a group (flat and nested) and nested feeds through the feeder
and `Trainer.prepare_batch`.

Inputs come from numpy with a seed.  Limits: the ops and layers in float32
within rtol 1e-5 (atol 1e-6), forward and the gradients of a random
cotangent; whole configs in float32 (the JAX group carries its memories in
float32 whatever the parameters' dtype): the loss within rtol 1e-4 and each
gradient within 1e-4 of its max |value|.  The port's nested configs against
their flat twins: the reference's hierarchical oracle, cost and every
gradient within rtol 1e-4, atol 1e-5 (tests/test_nested_rnn.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config as jparse
from paddle_tpu.data.feeder import make_batch as jmake_batch
from paddle_tpu.graph.builder import GraphExecutor as JExecutor
from paddle_tpu.graph.context import ForwardContext as JContext
from paddle_tpu.parameter.argument import Argument as JArgument
# the hierarchical LSTM's config text, which chip_smoke.py's [nested]
# phase runs at full width
from chip_smoke import HIER_LSTM
from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.config.schema import LayerConfig, LayerInput
from paddle_tpu_torch.data.feeder import make_batch
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.ops import sequence as tseq
from paddle_tpu_torch.parameter import Argument, params_from_jax
from paddle_tpu_torch.trainer import Trainer

# the provider modules (each package's `provider` name is the decorator)
jprov = importlib.import_module("paddle_tpu.data.provider")
tprov = importlib.import_module("paddle_tpu_torch.data.provider")

NEST = "tests/configs/sequence_nest_rnn.py"
FLAT = "tests/configs/sequence_rnn.py"
NEST_MULTI = "tests/configs/sequence_nest_rnn_multi_input.py"
FLAT_MULTI = "tests/configs/sequence_rnn_multi_input.py"
OP_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL, GRAD_SHARE = 1e-4, 1e-4

# a sparse sequence in-link of a flat group (tests/test_sparse_input.py's
# config) and a sparse nested in-link of a nested group
SPARSE_RG = """
from paddle_tpu.dsl import *
settings(batch_size=2, learning_rate=0.1)
feats = data_layer(name="feats", size=512)
def step(y):
    mem = memory(name="state", size=8)
    return fc_layer(input=[y, mem], size=8, act=TanhActivation(),
                    bias_attr=True, name="state")
out = recurrent_group(name="rg", step=step, input=feats)
rep = last_seq(input=out)
prob = fc_layer(size=2, input=rep, act=SoftmaxActivation(), bias_attr=True)
classification_cost(input=prob, label=data_layer(name="label", size=2))
"""
SPARSE_NESTED = """
from paddle_tpu.dsl import *
settings(batch_size=3, learning_rate=0.1)
feats = data_layer(name="feats", size=96)


def outer_step(x):
    outer_mem = memory(name="outer_state", size=6)

    def inner_step(y):
        mem = memory(name="inner_state", size=6, boot_layer=outer_mem)
        return fc_layer(input=[y, mem], size=6, act=TanhActivation(),
                        bias_attr=True, name="inner_state")

    inner = recurrent_group(name="inner", step=inner_step, input=x)
    last_seq(input=inner, name="outer_state")
    return inner


out = recurrent_group(name="outer", step=outer_step,
                      input=SubsequenceInput(feats))
prob = fc_layer(size=2, input=last_seq(input=out), act=SoftmaxActivation(),
                bias_attr=True)
classification_cost(input=prob, label=data_layer(name="label", size=2))
"""


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _share(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max(initial=0.0)
                 / max(np.abs(want).max(initial=0.0), 1e-30))


# -- the nested ops ----------------------------------------------------------

def _nested(case, seed=0):
    """x [B, S, T, D], lengths [B], sub_lengths [B, S]: 'ragged' has an
    empty sub-sequence inside a row's valid ones, a row of one
    sub-sequence, a row of none and ragged T; 'single' has S = 1; 'ties'
    repeats values, so that max pooling meets tied maxima."""
    rng = np.random.default_rng(seed)
    if case == "single":
        lengths = np.array([1, 1, 0], np.int32)
        sub = np.array([[4], [2], [0]], np.int32)
    else:
        lengths = np.array([3, 1, 2, 0], np.int32)
        sub = np.array([[3, 0, 2], [4, 0, 0], [1, 4, 0], [0, 0, 0]],
                       np.int32)
    B, S = sub.shape
    x = rng.standard_normal((B, S, 4, 5)).astype(np.float32)
    if case == "ties":
        x = np.round(x).astype(np.float32)
    return x, lengths, sub


NESTED_OPS = {
    "max": ("nested_pool_max", {}),
    "average": ("nested_pool_avg", {"strategy": "average"}),
    "sum": ("nested_pool_avg", {"strategy": "sum"}),
    "squarerootn": ("nested_pool_avg", {"strategy": "squarerootn"}),
    "last": ("nested_pool_last", {}),
    "first": ("nested_pool_first", {}),
    "max_per_sub": ("nested_pool_max_per_sub", {}),
    "average_per_sub": ("nested_pool_avg_per_sub", {"strategy": "average"}),
    "sum_per_sub": ("nested_pool_avg_per_sub", {"strategy": "sum"}),
    "squarerootn_per_sub": ("nested_pool_avg_per_sub",
                            {"strategy": "squarerootn"}),
    "first_per_sub": ("nested_pool_edge_per_sub", {"first": True}),
    "last_per_sub": ("nested_pool_edge_per_sub", {"first": False}),
}


def _vjp_both(jfn, tfn, inputs, seed=1):
    """jfn / tfn of the same float32 numpy inputs: their outputs and the
    gradients of a random cotangent of the output."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in inputs])
    ct = np.random.default_rng(seed).standard_normal(
        want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_(True) for a in inputs]
    got = tfn(*leaves)
    tgrads = torch.autograd.grad(got, leaves, _t(ct), allow_unused=True)
    tgrads = [torch.zeros_like(a) if g is None else g
              for g, a in zip(tgrads, leaves)]
    return ((got.detach().numpy(), np.asarray(want)),
            [(g.numpy(), np.asarray(j)) for g, j in zip(tgrads, jgrads)])


@pytest.mark.parametrize("case", ["ragged", "single", "ties"])
@pytest.mark.parametrize("op", sorted(NESTED_OPS))
def test_nested_ops_match_jax(op, case):
    """Each nested pooling op of ops/sequence.py and its gradient against
    paddle_tpu.ops.sequence: empty sub-sequences, rows without any, S = 1,
    ragged T and tied maxima (the gradient shared among the ties, as
    jnp.max shares it)."""
    from paddle_tpu.ops import sequence as jseq
    name, kw = NESTED_OPS[op]
    x, lengths, sub = _nested(case)
    (got, want), grads = _vjp_both(
        lambda a: getattr(jseq, name)(a, jnp.asarray(lengths),
                                      jnp.asarray(sub), **kw),
        lambda a: getattr(tseq, name)(a, _t(lengths), _t(sub), **kw), [x])
    np.testing.assert_allclose(got, want, **OP_TOL)
    for g, j in grads:
        np.testing.assert_allclose(g, j, **OP_TOL)


def test_nested_mask_matches_jax():
    from paddle_tpu.ops import sequence as jseq
    _, lengths, sub = _nested("ragged")
    got = tseq.nested_mask(_t(lengths), _t(sub), 4)
    want = jseq.nested_mask(jnp.asarray(lengths), jnp.asarray(sub), 4)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1, 1:].any() and not got[3].any()


def test_nested_pooling_equals_flat_pooling_of_the_tokens():
    """A row's valid tokens, concatenated, pooled flat: what the nested
    pools give over all of them (empty sub-sequences skipped)."""
    x, lengths, sub = _nested("ragged")
    for b in range(3):
        toks = np.stack([x[b, s, t] for s in range(lengths[b])
                         for t in range(sub[b, s])])
        args = (_t(x), _t(lengths), _t(sub))
        np.testing.assert_allclose(tseq.nested_pool_last(*args)[b].numpy(),
                                   toks[-1])
        np.testing.assert_allclose(tseq.nested_pool_first(*args)[b].numpy(),
                                   toks[0])
        np.testing.assert_allclose(tseq.nested_pool_max(*args)[b].numpy(),
                                   toks.max(0))
        np.testing.assert_allclose(tseq.nested_pool_avg(*args)[b].numpy(),
                                   toks.mean(0), rtol=1e-6)


def _flat_case(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 6, 5)).astype(np.float32)
    return x, np.array([6, 1, 3, 0], np.int32)


@pytest.mark.parametrize("op", ["expand", "seq_concat", "seq_reshape",
                                "sub_sequence", "sub_sequence_unbounded"])
def test_sequence_ops_match_jax(op):
    """expand_to_sequence, seq_concat, seq_reshape and sub_sequence (a
    slice clamped at the row's length and one past the padded end) and
    their gradients against paddle_tpu.ops.sequence, on ragged rows with
    a length-0 row."""
    from paddle_tpu.ops import sequence as jseq
    x, lens = _flat_case()
    jl, tl = jnp.asarray(lens), _t(lens)
    if op == "expand":
        v = x[:, 0]
        fns = (lambda a: jseq.expand_to_sequence(a, jl, 6),
               lambda a: tseq.expand_to_sequence(a, tl, 6))
        inputs = [v]
    elif op == "seq_concat":
        b = np.random.default_rng(3).standard_normal(
            (4, 3, 5)).astype(np.float32)
        lb = np.array([2, 3, 0, 1], np.int32)
        fns = (lambda a, c: jseq.seq_concat(a, jl, c, jnp.asarray(lb))[0],
               lambda a, c: tseq.seq_concat(a, tl, c, _t(lb))[0])
        inputs = [x, b]
        np.testing.assert_array_equal(
            tseq.seq_concat(_t(x), tl, _t(b), _t(lb))[1].numpy(), lens + lb)
    elif op == "seq_reshape":
        fns = (lambda a: jseq.seq_reshape(a[..., :4], jl, 8)[0],
               lambda a: tseq.seq_reshape(a[..., :4], tl, 8)[0])
        inputs = [x]
        np.testing.assert_array_equal(
            tseq.seq_reshape(_t(x[..., :4]), tl, 8)[1].numpy(), lens // 2)
    else:
        off = np.array([1, 0, 2, 0], np.int32)
        size = np.array([3, 4, 5, 2], np.int32)
        bound = None if op == "sub_sequence_unbounded" else lens
        fns = (lambda a: jseq.sub_sequence(
                   a, jnp.asarray(off), jnp.asarray(size),
                   None if bound is None else jl)[0],
               lambda a: tseq.sub_sequence(
                   a, _t(off), _t(size), None if bound is None else tl)[0])
        inputs = [x]
        want_len = np.asarray(jseq.sub_sequence(
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(size),
            None if bound is None else jl)[1])
        got_len = tseq.sub_sequence(_t(x), _t(off), _t(size),
                                    None if bound is None else tl)[1]
        np.testing.assert_array_equal(got_len.numpy(), want_len)
    (got, want), grads = _vjp_both(*fns, inputs)
    np.testing.assert_allclose(got, want, **OP_TOL)
    for g, j in grads:
        np.testing.assert_allclose(g, j, **OP_TOL)


# -- the layers --------------------------------------------------------------

def _layer_vjp(type_, inputs, feeds, params, extra=(), **spec):
    """One layer of the JAX registry and of the port on the same feeds
    (name -> dict of value / ids / lengths / sub_lengths numpy arrays) and
    parameters: (outputs, gradients) pairs as (port, JAX), the outputs
    being the layer's value and the values it publishes under `extra`
    names, the gradients of a random cotangent of them with respect to
    the float feeds and the parameters.  Also the two output Arguments."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.graph.registry import get_layer_fn as jget
    from paddle_tpu_torch.graph.registry import get_layer_fn
    jcfg = JLayer(type=type_, inputs=[JInput(*i) for i in inputs], **spec)
    cfg = LayerConfig(type=type_, inputs=[LayerInput(*i) for i in inputs],
                      **spec)
    fl = sorted(n for n, f in feeds.items() if f.get("value") is not None)
    pn = sorted(params)
    keep = {}

    def jfn(*leaves):
        ctx = JContext(model=None, params=dict(zip(pn, leaves[len(fl):])),
                       mode="test")
        for n, f in feeds.items():
            ctx.outputs[n] = JArgument(**{k: jnp.asarray(v)
                                          for k, v in f.items()})
        for n, v in zip(fl, leaves[:len(fl)]):
            ctx.outputs[n] = ctx.outputs[n].replace(value=v)
        out = jget(type_)(ctx, jcfg)
        keep["jax"] = out
        return jnp.concatenate([out.value.reshape(-1)] + [
            ctx.outputs[e].value.reshape(-1) for e in extra])

    def tfn(*leaves):
        ctx = ForwardContext(model=None, params=dict(zip(
            pn, leaves[len(fl):])), mode="test")
        for n, f in feeds.items():
            ctx.outputs[n] = Argument(**{k: _t(v) if k != "ids"
                                         else _t(v).long()
                                         for k, v in f.items()})
        for n, v in zip(fl, leaves[:len(fl)]):
            ctx.outputs[n] = ctx.outputs[n].replace(value=v)
        out = get_layer_fn(type_)(ctx, cfg)
        keep["port"] = out
        return torch.cat([out.value.reshape(-1)] + [
            ctx.outputs[e].value.reshape(-1) for e in extra])

    res = _vjp_both(jfn, tfn, [feeds[n]["value"] for n in fl]
                    + [params[n] for n in pn])
    return res, keep["port"], keep["jax"]


def _check_layer(res):
    (got, want), grads = res
    np.testing.assert_allclose(got, want, **OP_TOL)
    for g, j in grads:
        np.testing.assert_allclose(g, j, **OP_TOL)


@pytest.mark.parametrize("agg", ["", "seq"], ids=["all-tokens", "per-sub"])
@pytest.mark.parametrize("type_,fields", [
    ("max", {}), ("average", {"average_strategy": "average"}),
    ("average", {"average_strategy": "squarerootn"}),
    ("seqlastins", {}), ("seqlastins", {"select_first": True})],
    ids=["max", "average", "squarerootn", "last", "first"])
def test_nested_pooling_layers_match_jax(type_, fields, agg):
    """max / average / seqlastins on a nested input: over every valid token
    into [B, D], or with agg_level='seq' per sub-sequence into a [B, S, D]
    sequence of the input's sub-sequence counts; forward and gradients
    against the JAX layers."""
    x, lengths, sub = _nested("ragged", seed=4)
    res, port, want = _layer_vjp(
        type_, [("x",)], {"x": {"value": x, "lengths": lengths,
                                "sub_lengths": sub}}, {},
        name="p", size=5, trans_type=agg, **fields)
    _check_layer(res)
    if agg:
        assert port.value.shape == (4, 3, 5)
        np.testing.assert_array_equal(port.lengths.numpy(), lengths)
    else:
        assert port.value.shape == (4, 5) and port.lengths is None
    assert port.sub_lengths is None and want.sub_lengths is None


def test_per_sub_pooling_of_a_flat_sequence_raises_as_in_jax():
    """agg_level='seq' needs a nested input, on both sides."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.graph.registry import get_layer_fn as jget
    from paddle_tpu_torch.graph.registry import get_layer_fn
    x, lens = _flat_case()
    jctx = JContext(model=None, params={}, mode="test")
    jctx.outputs["x"] = JArgument(value=jnp.asarray(x),
                                  lengths=jnp.asarray(lens))
    ctx = ForwardContext(model=None, params={}, mode="test")
    ctx.outputs["x"] = Argument(value=_t(x), lengths=_t(lens))
    for type_ in ("max", "average", "seqlastins"):
        with pytest.raises(ValueError, match="NESTED"):
            jget(type_)(jctx, JLayer(name="p", type=type_, trans_type="seq",
                                     inputs=[JInput("x")]))
        with pytest.raises(ValueError, match="NESTED"):
            get_layer_fn(type_)(ctx, LayerConfig(
                name="p", type=type_, trans_type="seq",
                inputs=[LayerInput("x")]))


@pytest.mark.parametrize("which", ["expand", "expand-bias", "subseq",
                                   "subseq-bias", "seqconcat", "seqreshape"])
def test_sequence_layers_match_jax(which):
    """The expand, subseq, seqconcat and seqreshape layers (expand and
    subseq with and without their bias) against the JAX layers: values,
    lengths and the gradients of the inputs and the bias."""
    rng = np.random.default_rng(5)
    x, lens = _flat_case(6)
    feeds = {"x": {"value": x, "lengths": lens}}
    params, spec = {}, dict(name="l", size=5)
    if which.endswith("-bias"):
        params["b"] = rng.standard_normal((1, 5)).astype(np.float32)
        spec["bias_parameter_name"] = "b"
    base = which.split("-")[0]
    if base == "expand":
        feeds["v"] = {"value": x[:, 0]}
        inputs = [("v",), ("x",)]
    elif base == "subseq":
        feeds["off"] = {"ids": np.array([1, 0, 2, 0], np.int32)}
        feeds["sz"] = {"ids": np.array([3, 4, 5, 2], np.int32)}
        inputs = [("x",), ("off",), ("sz",)]
    elif base == "seqconcat":
        feeds["y"] = {"value": rng.standard_normal((4, 3, 5)).astype(
            np.float32), "lengths": np.array([2, 3, 0, 1], np.int32)}
        inputs = [("x",), ("y",)]
    else:
        feeds["x"]["value"] = x[..., :4]
        spec["size"] = 8
        inputs = [("x",)]
    res, port, want = _layer_vjp(base, inputs, feeds, params, **spec)
    _check_layer(res)
    np.testing.assert_array_equal(port.lengths.numpy(),
                                  np.asarray(want.lengths))


@pytest.mark.parametrize("bias", ["none", "4d", "7d-peepholes"])
def test_lstm_step_layer_matches_jax(bias):
    """lstm_step on a [B, 4D] input and the previous cell: the output and
    the new cell it publishes under state_name, and the gradients of the
    input, the cell and the bias (with peepholes from a 7D bias)."""
    rng = np.random.default_rng(7)
    D = 6
    feeds = {"x4": {"value": rng.standard_normal((3, 4 * D)).astype(
        np.float32)}, "c": {"value": rng.standard_normal((3, D)).astype(
            np.float32)}}
    params, spec = {}, dict(name="lstm", size=D, active_type="tanh",
                            attrs={"active_gate_type": "sigmoid",
                                   "active_state_type": "tanh",
                                   "state_name": "lstm_state"})
    if bias != "none":
        width = 7 * D if bias.startswith("7d") else 4 * D
        params["b"] = rng.standard_normal((1, width)).astype(np.float32)
        spec["bias_parameter_name"] = "b"
    res, port, _ = _layer_vjp("lstm_step", [("x4",), ("c",)], feeds, params,
                              extra=("lstm_state",), **spec)
    _check_layer(res)
    assert port.value.shape == (3, D) and port.lengths is None


# -- whole configs ------------------------------------------------------------

def _docs(seed, n, vocab=10, labels=3, empty=True):
    """n documents of 1-3 sub-sequences of 1-4 word ids (one sub-sequence
    empty when `empty`) with a label each."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        subs = [list(rng.integers(0, vocab, rng.integers(1, 5)))
                for _ in range(rng.integers(1, 4))]
        if empty and i == 1:
            subs.insert(1, [])
        docs.append((subs, int(rng.integers(0, labels))))
    return docs


def _batch(docs, nested, vocab=10, labels=3, maker=make_batch, prov=tprov):
    if nested:
        return maker(docs, [prov.integer_value_sub_sequence(vocab),
                            prov.integer_value(labels)], ["word", "label"])
    return maker([([w for s in d for w in s], y) for d, y in docs],
                 [prov.integer_value_sequence(vocab),
                  prov.integer_value(labels)], ["word", "label"])


def _tbatch(batch):
    def c(x, ids=False):
        if x is None:
            return None
        t = _t(x)
        return t.long() if ids else t
    return {n: Argument(value=c(a.value), ids=c(a.ids, True),
                        lengths=c(a.lengths), sub_lengths=c(a.sub_lengths),
                        sparse_vals=c(a.sparse_vals),
                        sparse_dim=a.sparse_dim) for n, a in batch.items()}


def _jbatch(batch):
    def j(x):
        return None if x is None else jnp.asarray(x)
    return {n: JArgument(value=j(a.value), ids=j(a.ids), lengths=j(a.lengths),
                         sub_lengths=j(a.sub_lengths),
                         sparse_vals=j(a.sparse_vals),
                         sparse_dim=a.sparse_dim) for n, a in batch.items()}


def _port_loss_grads(model, params, batch):
    ex = GraphExecutor(model)
    leaves = {n: v.detach().clone().requires_grad_(True)
              for n, v in params.items()}
    loss, (outputs, _, _) = ex.loss(leaves, _tbatch(batch), mode="train")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (float(loss.detach()), {n: g.numpy() for n, g in
                                   zip(leaves, grads)}, outputs)


def _jax_loss_grads(jcfg, batch, seed=7):
    ex = JExecutor(jcfg.model_config)
    params = ex.init_params(jax.random.PRNGKey(seed))
    loss, grads = jax.value_and_grad(
        lambda p: ex.loss(p, _jbatch(batch), None, "test")[0])(params)
    return (float(loss), {n: np.asarray(g) for n, g in grads.items()},
            {n: np.asarray(v) for n, v in params.items()})


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("path,args", [
    (NEST, ""), (NEST_MULTI, ""),
    ("hier_lstm", "dict_dim=10,lstm_dim=6")],
    ids=["nest_rnn", "nest_rnn_multi_input", "hier_lstm"])
def test_nested_config_matches_jax(path, args, tmp_path):
    """The two nested test configs and the hierarchical LSTM, parsed by the
    port's own parser from their files: the loss and every gradient of one
    batch (an empty sub-sequence, ragged sub-sequence counts) against the
    JAX GraphExecutor from the same parameters."""
    if path == "hier_lstm":
        path = _write(tmp_path, "hier_lstm.py", HIER_LSTM)
        labels = 2
    else:
        labels = 3
    batch = _batch(_docs(0, 4, labels=labels), True, labels=labels)
    jloss, jgrads, jparams = _jax_loss_grads(jparse(path, args), batch)
    cfg = parse_config(path, args)
    assert any(sm.parent for sm in cfg.model_config.sub_models) == (
        "hier" not in path)
    loss, grads, outputs = _port_loss_grads(
        cfg.model_config, params_from_jax(jparams, device="cpu"), batch)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        assert _share(g, jgrads[n]) <= GRAD_SHARE, n
    (sm,) = [s for s in cfg.model_config.sub_models if not s.parent]
    out = outputs[sm.output_layer_names[0]]
    assert out.lengths is not None
    nested_out = "hier" not in path
    assert (out.sub_lengths is not None) == nested_out
    if nested_out:
        assert out.value.dim() == 4


@pytest.mark.parametrize("nest,flat", [(NEST, FLAT),
                                       (NEST_MULTI, FLAT_MULTI)],
                         ids=["nest_rnn", "nest_rnn_multi_input"])
def test_nested_config_equals_its_flat_twin(nest, flat):
    """The reference's hierarchical oracle in the port: the nested RNN
    (the inner memory booted from the outer one) computes what the flat RNN
    computes on the concatenated words — the same cost and gradients,
    within rtol 1e-4, atol 1e-5, over documents without empty
    sub-sequences and the reference's rnn_data_provider data."""
    docs = _docs(1, 5, empty=False) + [
        ([[1, 3, 2], [4, 5, 2]], 0), ([[0, 2], [2, 5], [0, 1, 2]], 1)]
    ncfg, fcfg = parse_config(nest, ""), parse_config(flat, "")
    from paddle_tpu_torch.parameter import init_params
    np_ = init_params(ncfg.model_config, seed=7, device="cpu")
    fp = init_params(fcfg.model_config, seed=7, device="cpu")
    assert [tuple(v.shape) for v in np_.values()] == \
        [tuple(v.shape) for v in fp.values()]
    fp = dict(zip(fp, np_.values()))
    nl, ng, _ = _port_loss_grads(ncfg.model_config, np_,
                                 _batch(docs, True))
    fl, fg, _ = _port_loss_grads(fcfg.model_config, fp, _batch(docs, False))
    assert abs(nl - fl) < 1e-5
    for (nn, a), (fn, b) in zip(ng.items(), fg.items()):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{nn} vs {fn}")


def test_nested_group_plan_and_refusals():
    """A nested group is a ('scan', child) item of its parent's plan (the
    root plan holds the outer group only); its parent defers nothing; a
    reversed nested group and in-links of two nesting levels raise, as in
    the JAX package."""
    cfg = parse_config(NEST, "")
    ex = GraphExecutor(cfg.model_config)
    outer = ex._sub_by_name["outer"]
    inner = ex._sub_by_name["inner"]
    assert [i for k, i in ex._plan if k == "scan"] == [outer]
    assert ("scan", inner) in ex._sub_plan["outer"]
    assert ex._split_deferred(outer) is None
    batch = _tbatch(_batch(_docs(0, 2), True))
    ctx = ForwardContext(model=ex.model, params={}, mode="test")
    ctx.outputs.update(batch)
    ctx.outputs[outer.in_links[0]] = Argument(
        value=torch.zeros(2, 2, 4, 8), lengths=batch["word"].lengths,
        sub_lengths=batch["word"].sub_lengths[:, :2])
    outer.reversed = True
    try:
        with pytest.raises(ValueError, match="reverse=True"):
            ex._run_scan(ctx, outer)
    finally:
        outer.reversed = False
    multi = parse_config(NEST_MULTI, "")
    mex = GraphExecutor(multi.model_config)
    msm = mex._sub_by_name["outer"]
    ctx = ForwardContext(model=mex.model, params={}, mode="test")
    ctx.outputs[msm.in_links[0]] = Argument(
        ids=torch.zeros(2, 2, 4, dtype=torch.long),
        lengths=torch.tensor([2, 1]),
        sub_lengths=torch.ones(2, 2, dtype=torch.int32))
    ctx.outputs[msm.in_links[1]] = Argument(
        value=torch.zeros(2, 3, 8), lengths=torch.tensor([3, 1]))
    with pytest.raises(ValueError, match="nesting level"):
        mex._run_scan(ctx, msm)


def test_lstmemory_group_and_unit_run_lstm_step(tmp_path):
    """The DSL's lstmemory_group (an explicit group of lstm_step, its cell
    memory reading the cell the step publishes under state_name) and
    lstmemory_unit: loss and gradients against the JAX executor."""
    path = _write(tmp_path, "lstm_group.py", """
from paddle_tpu.dsl import *
settings(batch_size=3, learning_rate=0.1)
word = data_layer(name="word", size=10)
emb = embedding_layer(input=word, size=8)
proj = fc_layer(input=emb, size=24, act=LinearActivation(), bias_attr=False)
grp = lstmemory_group(input=proj, size=6, name="lg")
def unit_step(y):
    return lstmemory_unit(input=y, size=6, name="lu")
unit = recurrent_group(name="ug", step=unit_step, input=proj)
rep = fc_layer(input=[last_seq(input=grp), last_seq(input=unit)], size=3,
               act=SoftmaxActivation(), bias_attr=True)
classification_cost(input=rep, label=data_layer(name="label", size=3))
""")
    batch = _batch(_docs(2, 3, empty=False), False)
    jloss, jgrads, jparams = _jax_loss_grads(jparse(path, ""), batch)
    cfg = parse_config(path, "")
    assert sum(l.type == "lstm_step" for l in cfg.model_config.layers) == 2
    loss, grads, _ = _port_loss_grads(
        cfg.model_config, params_from_jax(jparams, device="cpu"), batch)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    for n, g in grads.items():
        assert _share(g, jgrads[n]) <= GRAD_SHARE, n


# -- sparse in-links -----------------------------------------------------------

def _sparse_docs(dim, nested):
    if nested:
        return [([[[1, 5], [7]], [[2, 3, dim - 1]]], 0),
                ([[[0]]], 1),
                ([[[4], [9, 10]], [], [[11], [12], [13, 14]]], 1)]
    return [([[1, 5], [7], [2, 3, 8]], 0), ([[0], [dim - 1, 4]], 1)]


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_sparse_in_link_of_a_group_matches_jax(nested, tmp_path):
    """A sparse_binary_vector_sequence in-link of a flat group, and a
    sparse sub-sequence in-link of a nested group (its inner group slicing
    the sparse rows again): the fc in the step gathers rows.  The loss and
    every gradient against the JAX executor, and the loss against the same
    config fed the dense multi-hot rows."""
    dim = 96 if nested else 512
    path = _write(tmp_path, "sparse_rg.py",
                  SPARSE_NESTED if nested else SPARSE_RG)
    slot = (tprov.sparse_binary_vector_sub_sequence if nested
            else tprov.sparse_binary_vector_sequence)
    jslot = (jprov.sparse_binary_vector_sub_sequence if nested
             else jprov.sparse_binary_vector_sequence)
    docs = _sparse_docs(dim, nested)
    batch = make_batch(docs, [slot(dim), tprov.integer_value(2)],
                       ["feats", "label"])
    jbatch = jmake_batch(docs, [jslot(dim), jprov.integer_value(2)],
                         ["feats", "label"])
    for name in ("ids", "sparse_vals", "lengths", "sub_lengths"):
        a, b = getattr(batch["feats"], name), getattr(jbatch["feats"], name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    jloss, jgrads, jparams = _jax_loss_grads(jparse(path, ""), batch, seed=0)
    cfg = parse_config(path, "")
    params = params_from_jax(jparams, device="cpu")
    loss, grads, _ = _port_loss_grads(cfg.model_config, params, batch)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    for n, g in grads.items():
        assert _share(g, jgrads[n]) <= GRAD_SHARE, n
    dense = dict(batch)
    dense["feats"] = Argument(
        value=_tbatch(batch)["feats"].to_dense().value.numpy(),
        lengths=batch["feats"].lengths, sub_lengths=batch["feats"].sub_lengths)
    dloss, _, _ = _port_loss_grads(cfg.model_config, params, dense)
    assert dloss == pytest.approx(loss, rel=1e-5)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "valued"])
def test_sparse_sub_sequence_slots_match_jax_and_dense(binary):
    """sparse_(binary_)vector_sub_sequence slots as [B, S, T, K] rows: the
    port's fc product over them equals the JAX one and the dense
    [B, S, T, dim] product, forward and weight gradient; to_dense keeps
    the nesting."""
    from paddle_tpu.graph.layers_core import _input_matmul as jmatmul
    from paddle_tpu_torch.graph.layers_core import _input_matmul
    dim = 96
    rng = np.random.default_rng(3)
    w = rng.standard_normal((dim, 3)).astype(np.float32)
    if binary:
        docs = [[[[1, 5], [7]], [[2, 3, 95]]], [[[0]]]]
        slot, jslot = (tprov.sparse_binary_vector_sub_sequence,
                       jprov.sparse_binary_vector_sub_sequence)
    else:
        docs = [[[[(1, 0.5)], [(7, -2.0), (8, 1.0)]]],
                [[[(0, 3.0)]], [[(90, 1.0)], [(91, -1.0)]]]]
        slot, jslot = (tprov.sparse_vector_sub_sequence,
                       jprov.sparse_vector_sub_sequence)
    arg = make_batch([(d, 0) for d in docs], [slot(dim),
                                              tprov.integer_value(2)],
                     ["feats", "label"])["feats"]
    targ = _tbatch({"f": arg})["f"]
    jarg = _jbatch({"f": arg})["f"]
    dense = targ.to_dense()
    assert dense.value.shape == tuple(arg.ids.shape[:3]) + (dim,)
    assert torch.equal(dense.sub_lengths, targ.sub_lengths)
    (got, want), grads = _vjp_both(lambda p: jmatmul(jarg, p),
                                   lambda p: _input_matmul(targ, p), [w])
    np.testing.assert_allclose(got, want, **OP_TOL)
    np.testing.assert_allclose(got, dense.value.numpy() @ w, **OP_TOL)
    np.testing.assert_allclose(grads[0][0], grads[0][1], **OP_TOL)


# -- feeds -----------------------------------------------------------------------

@pytest.mark.parametrize("slot", ["index", "dense", "sparse_binary",
                                  "sparse_valued"])
def test_nested_feeds_match_jax_make_batch(slot):
    """Each sub-sequence slot kind through the port's feeder equals the
    JAX make_batch, and `Trainer.prepare_batch` moves it whole (ids as
    int64, lengths and sub_lengths kept); a nested id out of range
    raises."""
    rng = np.random.default_rng(9)
    n_subs = [2, 1, 3]
    if slot == "index":
        samples = [[list(rng.integers(0, 10, rng.integers(1, 5)))
                    for _ in range(s)] for s in n_subs]
        kind = "integer_value_sub_sequence", (10,)
    elif slot == "dense":
        samples = [[rng.standard_normal((rng.integers(1, 5), 3)).tolist()
                    for _ in range(s)] for s in n_subs]
        kind = "dense_vector_sub_sequence", (3,)
    elif slot == "sparse_binary":
        samples = [[[list(rng.choice(20, 2, replace=False))
                     for _ in range(rng.integers(1, 4))]
                    for _ in range(s)] for s in n_subs]
        kind = "sparse_binary_vector_sub_sequence", (20,)
    else:
        samples = [[[[(int(c), float(rng.standard_normal())) for c in
                      rng.choice(20, 2, replace=False)]
                     for _ in range(rng.integers(1, 4))]
                    for _ in range(s)] for s in n_subs]
        kind = "sparse_vector_sub_sequence", (20,)
    types = [getattr(tprov, kind[0])(*kind[1]), tprov.integer_value(2)]
    jtypes = [getattr(jprov, kind[0])(*kind[1]), jprov.integer_value(2)]
    docs = [(s, 1) for s in samples]
    got = make_batch(docs, types, ["x", "label"])["x"]
    want = jmake_batch(docs, jtypes, ["x", "label"])["x"]
    for name in ("value", "ids", "lengths", "sub_lengths", "sparse_vals"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert got.sparse_dim == want.sparse_dim

    if slot != "index":
        return
    tr = Trainer(parse_config(NEST, ""), device="cpu")
    feed = {"word": got, "label": Argument(ids=np.ones(3, np.int32))}
    prepared = tr.prepare_batch(feed)["word"]
    assert prepared.ids.dtype == torch.int64
    assert torch.equal(prepared.sub_lengths, _t(got.sub_lengths))
    assert torch.equal(prepared.lengths, _t(got.lengths))
    bad = Argument(ids=got.ids + 10, lengths=got.lengths,
                   sub_lengths=got.sub_lengths)
    with pytest.raises(ValueError, match="out of range"):
        tr.prepare_batch({"word": bad, "label": feed["label"]})
    with pytest.raises(ValueError, match="sub-sequence counts"):
        tr.prepare_batch({"word": Argument(ids=got.ids,
                                           sub_lengths=got.sub_lengths),
                          "label": feed["label"]})
