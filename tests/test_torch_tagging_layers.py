"""PyTorch port: the pieces of the sequence-tagging and sparse-input path
against the JAX package's functions, forward and gradients, on the CPU in
float64 (the JAX side under enable_x64): the activations, the linear-chain
CRF (likelihood, its parts, Viterbi decoding) and its layers, the vanilla
RNN, the context projection, the sparse-row fc and full-matrix paths, the
other projections, cos, every cost type, maxid, the `sum`, `column_sum`
and `chunk` evaluators and model averaging.

Limits (float64): values and gradients within 1e-10 of their max |value|
(the two sides differ only in summation order); decoded paths, ids,
evaluator counts and `sum` results exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import schema as jschema
from paddle_tpu.graph.context import ForwardContext as JContext
from paddle_tpu.graph.registry import get_layer_fn as jget
from paddle_tpu.ops import activations as jact
from paddle_tpu.ops import crf as jcrf
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu.ops import sequence as jseq
from paddle_tpu.optim.updater import ParameterUpdater as JUpdater
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer import evaluators as jev
from paddle_tpu.utils.jax_compat import enable_x64
from paddle_tpu_torch.config import schema
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import get_layer_fn
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops import sequence as tseq
from paddle_tpu_torch.ops.activations import activation
from paddle_tpu_torch.optim.updater import ParameterUpdater
from paddle_tpu_torch.parameter import Argument, opt_state_from_jax
from paddle_tpu_torch.trainer import evaluators as tev

SHARE = 1e-10           # of each compared tensor's max |value|


@pytest.fixture(autouse=True)
def x64():
    with enable_x64():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= SHARE * scale + 1e-300, (what, err, scale)


def _grads_torch(fn, *args):
    """fn(*leaves) -> tensor; the gradient of sum(out * cot) by each
    leaf (cot a fixed pattern of out's shape)."""
    leaves = [_t(a).requires_grad_(True) for a in args]
    out = fn(*leaves)
    cot = torch.cos(torch.arange(out.numel(), dtype=out.dtype)
                    ).reshape(out.shape)
    grads = torch.autograd.grad((out * cot).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _grads_jax(fn, *args):
    leaves = [jnp.asarray(a) for a in args]
    out = fn(*leaves)
    cot = jnp.cos(jnp.arange(out.size, dtype=out.dtype)).reshape(out.shape)
    grads = jax.grad(lambda *xs: jnp.sum(fn(*xs) * cot),
                     argnums=tuple(range(len(leaves))))(*leaves)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _both(tfn, jfn, *args, what=""):
    """Forward and gradients of the two functions on the same inputs."""
    tv, tg = _grads_torch(tfn, *args)
    jv, jg = _grads_jax(jfn, *args)
    _close(tv, jv, what + " value")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, f"{what} grad {i}")


# -- activations --------------------------------------------------------------

@pytest.mark.parametrize("name", ["brelu", "stanh", "softrelu", "abs",
                                  "square", "exponential", "log",
                                  "sequence_softmax"])
def test_activation_matches_jax(name):
    """Values and gradients of each added activation over a range that
    meets its clips (brelu's 0 and 24, softrelu's +-40)."""
    rng = np.random.default_rng(1)
    if name == "sequence_softmax":
        x = rng.standard_normal((3, 6, 1))
        lens = np.array([6, 1, 4])
        mask = np.arange(6)[None, :] < lens[:, None]
        _both(lambda v: activation(name, v, _t(mask)),
              lambda v: jact.activation(name, v, jnp.asarray(mask)), x,
              what=name)
        got = activation(name, _t(x), _t(mask)).numpy()[..., 0]
        assert (got[~mask] == 0).all()
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)
        return
    if name == "log":
        x = rng.uniform(0.1, 5.0, (4, 7))
    else:
        x = np.concatenate([rng.uniform(-50, 50, (4, 6)),
                            rng.standard_normal((4, 6))], axis=1)
    _both(lambda v: activation(name, v), lambda v: jact.activation(name, v),
          x, what=name)


def test_activation_of_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        activation("swishy", torch.zeros(2))


# -- the linear-chain CRF -----------------------------------------------------

def _crf_case(kind: str, B=5, T=6, C=4, seed=0):
    """(x, labels, lengths, w): random scores with ragged lengths (a row of
    length 1, a full row, a row of T-1), all-equal scores (every path
    ties), or a batch of T = 1."""
    rng = np.random.default_rng(seed)
    if kind == "t1":
        T = 1
    x = rng.standard_normal((B, T, C))
    w = rng.standard_normal((C + 2, C)) * 0.5
    if kind == "ties":
        x = np.zeros_like(x)
        w = np.zeros_like(w)
    lens = np.array([T, 1, max(T - 1, 1), 3 if T >= 3 else 1, 2 if T >= 2
                     else 1][:B])
    labels = rng.integers(0, C, (B, T))
    labels[np.arange(T)[None, :] >= lens[:, None]] = 0     # the padding
    return x, labels, lens, w


@pytest.mark.parametrize("kind", ["ragged", "ties", "t1"])
@pytest.mark.parametrize("fn", ["crf_log_z", "crf_path_score", "crf_nll"])
def test_crf_likelihood_matches_jax(fn, kind):
    """crf_log_z, crf_path_score and crf_nll: values and the gradients by
    the emissions and by w."""
    x, labels, lens, w = _crf_case(kind)
    tf, jf = getattr(tcrf, fn), getattr(jcrf, fn)
    if fn == "crf_log_z":
        _both(lambda a, b: tf(a, _t(lens), b),
              lambda a, b: jf(a, jnp.asarray(lens), b), x, w, what=fn)
    else:
        _both(lambda a, b: tf(a, _t(labels), _t(lens), b),
              lambda a, b: jf(a, jnp.asarray(labels), jnp.asarray(lens), b),
              x, w, what=fn)


def test_crf_padded_labels_do_not_reach_the_score():
    x, labels, lens, w = _crf_case("ragged")
    other = labels.copy()
    pad = np.arange(labels.shape[1])[None, :] >= lens[:, None]
    other[pad] = 3
    a = tcrf.crf_nll(_t(x), _t(labels), _t(lens), _t(w))
    b = tcrf.crf_nll(_t(x), _t(other), _t(lens), _t(w))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["ragged", "ties", "t1", "near_ties"])
def test_crf_decode_paths_equal_jax_exactly(kind):
    """The Viterbi paths equal the JAX decoder's exactly: random scores,
    all-tie scores (the first maximal tag wins on both sides), T = 1, and
    scores on a coarse grid where many paths tie; past a row's length the
    path repeats its last tag."""
    x, _, lens, w = _crf_case(kind if kind != "near_ties" else "ragged",
                              B=5, T=7, C=5, seed=3)
    if kind == "near_ties":
        rng = np.random.default_rng(4)
        x = rng.integers(-1, 2, x.shape).astype(np.float64)
        w = rng.integers(-1, 2, w.shape).astype(np.float64)
    got = tcrf.crf_decode(_t(x), _t(lens), _t(w)).numpy()
    want = np.asarray(jcrf.crf_decode(jnp.asarray(x), jnp.asarray(lens),
                                      jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    for b, L in enumerate(lens):
        assert (got[b, L:] == got[b, L - 1]).all()
    if kind == "ties":
        assert (got == 0).all()


def _layer_cfgs(type_, inputs, **fields):
    """The same LayerConfig on both sides: inputs are (layer name, param
    name, projection fields or None)."""
    def make(mod):
        ins = [mod.LayerInput(n, p, mod.ProjectionConfig(**proj)
                              if proj else None) for n, p, proj in inputs]
        return mod.LayerConfig(name="L", type=type_, inputs=ins, **fields)
    return make(jschema), make(schema)


def _contexts(mode, params, **outputs):
    """A JAX and a port ForwardContext holding the same named inputs
    (dicts of Argument fields as numpy arrays) and parameters."""
    jctx = JContext(model=None, params={k: jnp.asarray(v)
                                        for k, v in params.items()},
                    mode=mode)
    ctx = ForwardContext(model=None, params={k: _t(v)
                                             for k, v in params.items()},
                         mode=mode)
    for name, fields in outputs.items():
        jctx.outputs[name] = JArgument(**{
            k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in fields.items()})
        ctx.outputs[name] = Argument(**{
            k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in fields.items()})
    return jctx, ctx


def _layer_both(type_, inputs, params, outputs, diff=(), mode="train",
                **fields):
    """One layer on both sides: its output and costs, and the gradients of
    sum(value * cot) + sum(costs) by the parameters and by the inputs
    named in `diff` (their `value`)."""
    jcfg, tcfg = _layer_cfgs(type_, inputs, **fields)
    names = sorted(params) + list(diff)

    def run_jax(*leaves):
        ps = dict(zip(sorted(params), leaves[:len(params)]))
        outs = {k: dict(v) for k, v in outputs.items()}
        for n, leaf in zip(diff, leaves[len(params):]):
            outs[n]["value"] = leaf
        jctx, _ = _contexts(mode, {}, **outs)
        jctx.params = ps
        out = jget(type_)(jctx, jcfg)
        return out, jctx.costs

    def run_torch(*leaves):
        ps = dict(zip(sorted(params), leaves[:len(params)]))
        outs = {k: dict(v) for k, v in outputs.items()}
        _, ctx = _contexts(mode, {}, **outs)
        for n, leaf in zip(diff, leaves[len(params):]):
            ctx.outputs[n] = ctx.outputs[n].replace(value=leaf)
        ctx.params = ps
        out = get_layer_fn(type_)(ctx, tcfg)
        return out, ctx.costs

    args = [params[n] for n in sorted(params)] + [outputs[n]["value"]
                                                  for n in diff]
    jleaves = [jnp.asarray(a) for a in args]
    jout, jcosts = run_jax(*jleaves)
    tleaves = [_t(a).requires_grad_(True) for a in args]
    tout, tcosts = run_torch(*tleaves)
    res = {"out": (tout, jout), "costs": (tcosts, jcosts)}
    if args:
        def jscal(*xs):
            o, c = run_jax(*xs)
            return _scalar_of(o, c, _JLib)
        jg = jax.grad(jscal, argnums=tuple(range(len(args))))(*jleaves)
        ts = _scalar_of(tout, tcosts, _TLib)
        if torch.is_tensor(ts) and ts.requires_grad:
            tg = torch.autograd.grad(ts, tleaves, allow_unused=True)
            res["grads"] = {n: (None if g is None else g.numpy(),
                                np.asarray(j))
                            for n, g, j in zip(names, tg, jg)}
    return res


class _TLib:
    is_floating_point = staticmethod(torch.is_floating_point)
    cos = staticmethod(torch.cos)

    @staticmethod
    def arange(n, dtype):
        return torch.arange(n, dtype=dtype)

    @staticmethod
    def size(v):
        return v.numel()


class _JLib:
    cos = staticmethod(jnp.cos)

    @staticmethod
    def is_floating_point(v):
        return jnp.issubdtype(v.dtype, jnp.floating)

    @staticmethod
    def arange(n, dtype):
        return jnp.arange(n, dtype=dtype)

    @staticmethod
    def size(v):
        return v.size


def _scalar_of(out, costs, lib):
    total = 0.0
    v = out.value
    if v is not None and lib.is_floating_point(v):
        n = lib.size(v)
        total = total + (v * lib.cos(lib.arange(n, v.dtype)).reshape(
            v.shape)).sum()
    for c in costs.values():
        total = total + c.sum()
    return total


def _check_layer(res, ids_exact=True):
    tout, jout = res["out"]
    for field in ("value", "ids", "lengths"):
        a, b = getattr(tout, field), getattr(jout, field)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        if field == "value":
            _close(a.detach().numpy(), b, field)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tc, jc = res["costs"]
    assert set(tc) == set(jc)
    for k in tc:
        _close(tc[k].detach().numpy(), jc[k], f"cost {k}")
    for n, (g, j) in res.get("grads", {}).items():
        if g is None:
            assert not np.abs(j).any(), n
            continue
        _close(g, j, f"grad {n}")


def _seq_arg(rng, B, T, D, lens=None):
    lens = np.array([T, 1, 3, 2][:B]) if lens is None else lens
    return {"value": rng.standard_normal((B, T, D)), "lengths": lens}


def _ids_arg(rng, B, T, C, lens):
    ids = rng.integers(0, C, (B, T))
    ids[np.arange(T)[None, :] >= lens[:, None]] = 0
    return {"ids": ids, "lengths": lens}


@pytest.mark.parametrize("case", ["label", "no_label", "weight", "ties"])
def test_crf_layers_match_jax(case):
    """The crf cost (coeff 0.5; with a per-sequence weight input) and
    crf_decoding with a label (its 0/1 error indicators) and without one
    (the path): costs, gradients and ids."""
    rng = np.random.default_rng(5)
    B, T, C = 4, 5, 6
    x = _seq_arg(rng, B, T, C)
    if case == "ties":
        x["value"] = np.zeros_like(x["value"])
    lbl = _ids_arg(rng, B, T, C, x["lengths"])
    w = rng.standard_normal((C + 2, C)) * (0 if case == "ties" else 0.3)
    outputs = {"x": x, "y": lbl}
    ins = [("x", "crfw", None), ("y", "", None)]
    if case == "weight":
        outputs["wt"] = {"value": rng.uniform(0.5, 2.0, (B, 1))}
        ins.append(("wt", "", None))
    if case != "no_label":
        res = _layer_both("crf", ins, {"crfw": w}, outputs, diff=("x",),
                          size=C, coeff=0.5)
        _check_layer(res)
    res = _layer_both("crf_decoding", ins[:1 if case == "no_label" else 2],
                      {"crfw": w}, outputs, size=C)
    _check_layer(res)


# -- the vanilla RNN ----------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_simple_rnn_scan_matches_jax(act, reverse):
    rng = np.random.default_rng(6)
    B, T, D = 4, 6, 5
    x = rng.standard_normal((B, T, D))
    lens = np.array([6, 1, 4, 0])
    w = rng.standard_normal((D, D)) * 0.4
    b = rng.standard_normal((D,)) * 0.1

    def tf(xx, ww, bb):
        return trnn.simple_rnn_scan(xx, _t(lens), ww, bb, active_type=act,
                                    reverse=reverse)[0]

    def jf(xx, ww, bb):
        return jrnn.simple_rnn_scan(xx, jnp.asarray(lens), ww, bb,
                                    active_type=act, reverse=reverse)[0]
    _both(tf, jf, x, w, b, what="rnn")
    _, hl = trnn.simple_rnn_scan(_t(x), _t(lens), _t(w), _t(b),
                                 active_type=act, reverse=reverse)
    _, jhl = jrnn.simple_rnn_scan(jnp.asarray(x), jnp.asarray(lens),
                                  jnp.asarray(w), jnp.asarray(b),
                                  active_type=act, reverse=reverse)
    _close(hl.numpy(), jhl, "last h")


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_recurrent_layer_matches_jax(reverse):
    rng = np.random.default_rng(7)
    B, T, D = 4, 5, 3
    res = _layer_both("recurrent", [("x", "w", None)],
                      {"w": rng.standard_normal((D, D)) * 0.5,
                       "b": rng.standard_normal((1, D))},
                      {"x": _seq_arg(rng, B, T, D)}, diff=("x",), size=D,
                      active_type="relu", reversed=reverse,
                      bias_parameter_name="b")
    _check_layer(res)


# -- projections --------------------------------------------------------------

@pytest.mark.parametrize("padding", [False, True], ids=["zeros", "trained"])
@pytest.mark.parametrize("start,length", [(-1, 3), (-2, 5), (0, 2), (-3, 3)])
def test_context_projection_matches_jax(start, length, padding):
    """The sliding window with negative and zero starts at ragged lengths
    (a T = 1 row, rows shorter than the window, a length-0 row), with
    zeros or trainable padding rows outside each row's valid prefix."""
    rng = np.random.default_rng(8)
    B, T, D = 5, 6, 3
    x = rng.standard_normal((B, T, D))
    lens = np.array([6, 1, 2, 4, 0])
    up, down = max(0, -start), max(0, start + length - 1)
    pad = rng.standard_normal((up + down, D))
    args = (x, pad) if padding else (x,)

    def tf(xx, *p):
        return tseq.context_projection(xx, _t(lens), start, length,
                                       p[0] if p else None)

    def jf(xx, *p):
        return jseq.context_projection(xx, jnp.asarray(lens), start, length,
                                       p[0] if p else None)
    _both(tf, jf, *args, what="context")
    # through the mixed layer, the padding as the projection's parameter
    proj = dict(type="context", input_size=D, output_size=D * length,
                context_start=start, context_length=length,
                trainable_padding=padding)
    res = _layer_both("mixed", [("x", "pad" if padding else "", proj)],
                      {"pad": pad} if padding else {},
                      {"x": {"value": x, "lengths": lens}}, diff=("x",),
                      size=D * length)
    _check_layer(res)


def _sparse_arg(rng, lead, K, dim, binary):
    ids = rng.integers(0, dim, lead + (K,))
    vals = (np.ones(lead + (K,)) if binary
            else rng.standard_normal(lead + (K,)))
    vals[..., -1] = 0.0                     # a padding slot
    ids[..., -1] = 0
    return ids, vals


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "valued"])
@pytest.mark.parametrize("seq", [False, True], ids=["flat", "per_step"])
@pytest.mark.parametrize("layer", ["fc", "full_matrix"])
def test_sparse_rows_match_jax(layer, seq, binary):
    """fc and the mixed layer's full-matrix projection over sparse rows
    ([B, K] or [B, T, K] ids with binary or real values, id 0 / value 0
    padding slots, repeated ids): values and the weight's gradient; and
    to_dense against the JAX package's."""
    rng = np.random.default_rng(9)
    B, T, K, dim, out = 4, 3, 5, 11, 6
    lead = (B, T) if seq else (B,)
    ids, vals = _sparse_arg(rng, lead, K, dim, binary)
    ids[0, ..., 1] = ids[0, ..., 0]          # a repeated id
    arg = {"ids": ids, "sparse_vals": vals, "sparse_dim": dim}
    if seq:
        arg["lengths"] = np.array([3, 1, 2, 3])
    w = rng.standard_normal((dim, out))
    if layer == "fc":
        res = _layer_both("fc", [("x", "w", None)], {"w": w,
                                                      "b": np.ones((1, out))},
                          {"x": arg}, size=out, active_type="tanh",
                          bias_parameter_name="b")
    else:
        proj = dict(type="full_matrix", input_size=dim, output_size=out)
        res = _layer_both("mixed", [("x", "w", proj)], {"w": w}, {"x": arg},
                          size=out)
    _check_layer(res)
    dense = Argument(ids=_t(ids), sparse_vals=_t(vals),
                     sparse_dim=dim).to_dense().value.numpy()
    want = JArgument(ids=jnp.asarray(ids), sparse_vals=jnp.asarray(vals),
                     sparse_dim=dim).to_dense().value
    np.testing.assert_array_equal(dense, np.asarray(want))


def test_sparse_rows_refused_by_table_and_identity():
    ids, vals = _sparse_arg(np.random.default_rng(0), (2,), 3, 7, True)
    _, ctx = _contexts("test", {"w": np.ones((7, 2))}, x={
        "ids": ids, "sparse_vals": vals, "sparse_dim": 7})
    for t in ("table", "identity"):
        _, cfg = _layer_cfgs("mixed", [("x", "w", dict(type=t))], size=2)
        with pytest.raises(ValueError, match="sparse rows"):
            get_layer_fn("mixed")(ctx, cfg)


@pytest.mark.parametrize("proj", ["trans_full_matrix", "dot_mul", "scaling"])
def test_other_projections_match_jax(proj):
    rng = np.random.default_rng(10)
    B, T, D = 3, 4, 5
    w = {"trans_full_matrix": rng.standard_normal((D, D)),
         "dot_mul": rng.standard_normal((1, D)),
         "scaling": rng.standard_normal((1, 1))}[proj]
    res = _layer_both("mixed", [("x", "w", dict(type=proj, input_size=D,
                                                 output_size=D))],
                      {"w": w}, {"x": _seq_arg(rng, B, T, D, np.array(
                          [4, 2, 1]))}, diff=("x",), size=D)
    _check_layer(res)


def test_cos_matches_jax():
    rng = np.random.default_rng(11)
    a = {"value": rng.standard_normal((5, 7))}
    b = {"value": rng.standard_normal((5, 7))}
    res = _layer_both("cos", [("a", "", None), ("b", "", None)], {},
                      {"a": a, "b": b}, diff=("a", "b"), size=1,
                      attrs={"cos_scale": 5.0})
    _check_layer(res)
    b["value"][2] = 0.0                      # a zero norm: the 1e-8 floor
    tout, jout = _layer_both("cos", [("a", "", None), ("b", "", None)], {},
                             {"a": a, "b": b}, mode="test", size=1)["out"]
    _close(tout.value.numpy(), jout.value)
    assert tout.value[2, 0] == 0


@pytest.mark.parametrize("k", [1, 3])
def test_maxid_matches_jax(k):
    rng = np.random.default_rng(12)
    x = rng.integers(0, 3, (4, 6)).astype(np.float64)      # ties
    res = _layer_both("maxid", [("x", "", None)], {}, {"x": {"value": x}},
                      mode="test", size=6, beam_size=k)
    tout, jout = res["out"]
    if k == 1:
        np.testing.assert_array_equal(tout.ids.numpy(), np.asarray(jout.ids))
    else:
        _close(tout.value.numpy(), jout.value)


# -- cost layers --------------------------------------------------------------

def _cost_case(type_, seq, rng):
    """(inputs, outputs, fields) of one cost layer: the network output, the
    label, a weight input for the costs that take one."""
    B, T, C = 4, 5, 6
    lens = np.array([5, 1, 3, 2])

    def dense(width, positive=False, prob=False):
        shape = (B, T, width) if seq else (B, width)
        v = rng.uniform(0.05, 1.0, shape) if positive else \
            rng.standard_normal(shape)
        if prob:
            v = v / v.sum(-1, keepdims=True)
        out = {"value": v}
        if seq:
            out["lengths"] = lens
        return out

    def ids(hi):
        shape = (B, T) if seq else (B,)
        out = {"ids": rng.integers(0, hi, shape)}
        if seq:
            out["lengths"] = lens
        return out
    weight = {"value": rng.uniform(0.5, 2.0, (B, 1))}
    fields = {}
    if type_ == "multi_class_cross_entropy_with_selfnorm":
        out, lbl = dense(C, positive=True), ids(C)
        fields["softmax_selfnorm_alpha"] = 0.3
    elif type_ in ("soft_binary_class_cross_entropy",
                   "multi_binary_label_cross_entropy"):
        out = dense(C, positive=True)
        out["value"] = np.minimum(out["value"], 0.95)
        lbl = dense(C, positive=True)
        if type_ == "multi_binary_label_cross_entropy":
            lbl["value"] = (lbl["value"] > 0.5).astype(np.float64)
    elif type_ == "square_error":
        out, lbl = dense(C), dense(C)
    elif type_ == "rank-cost":
        out, lbl = dense(1), dense(1)
        third = {"value": rng.integers(0, 2, (B, 1)).astype(np.float64)}
        return ([("a", "", None), ("b", "", None), ("t", "", None)],
                {"a": out, "b": lbl, "t": third}, fields)
    elif type_ in ("huber_classification", "huber"):
        out = dense(1)
        out["value"] = out["value"] * 2.0
        lbl = ids(2)
    elif type_ == "sum_cost":
        return [("a", "", None)], {"a": dense(C)}, fields
    elif type_ == "lambda_cost":
        out, lbl = dense(1), dense(1)
        lbl["value"] = rng.integers(0, 4, lbl["value"].shape).astype(
            np.float64)
    inputs = [("a", "", None), ("b", "", None)]
    outputs = {"a": out, "b": lbl}
    if type_ not in ("lambda_cost",) and not seq:
        inputs.append(("w", "", None))
        outputs["w"] = weight
    return inputs, outputs, fields


COST_TYPES = ["multi_class_cross_entropy_with_selfnorm",
              "soft_binary_class_cross_entropy",
              "multi_binary_label_cross_entropy", "square_error",
              "rank-cost", "huber_classification", "huber", "sum_cost",
              "lambda_cost"]
_SEQ_COSTS = {"square_error", "sum_cost", "lambda_cost"}


COST_CASES = ([(t, False) for t in COST_TYPES if t != "lambda_cost"]
              + [(t, True) for t in COST_TYPES if t in _SEQ_COSTS])


@pytest.mark.parametrize("type_,seq", COST_CASES,
                         ids=[f"{t}-{'seq' if q else 'flat'}"
                              for t, q in COST_CASES])
def test_cost_layers_match_jax(type_, seq):
    """Each cost type's per-sample cost (coeff 0.7; times a weight input
    where the type takes one) and its gradient by the network output, on
    flat inputs and, for the types that reduce over time, on sequences
    (lambda_cost ranks the steps of a sequence: sequences only)."""
    rng = np.random.default_rng(COST_TYPES.index(type_))
    inputs, outputs, fields = _cost_case(type_, seq, rng)
    res = _layer_both(type_, inputs, {}, outputs, diff=("a",), size=1,
                      coeff=0.7, **fields)
    _check_layer(res)


# -- evaluators ---------------------------------------------------------------

def _ev_cfgs(type_, names, **fields):
    return (jschema.EvaluatorConfig(name="e", type=type_,
                                    input_layer_names=names, **fields),
            schema.EvaluatorConfig(name="e", type=type_,
                                   input_layer_names=names, **fields))


@pytest.mark.parametrize("case", ["ids_seq", "value_seq", "value_flat"])
@pytest.mark.parametrize("type_", ["sum", "column_sum"])
def test_sum_evaluators_match_jax(type_, case):
    """The sum and column_sum evaluators over two batches: their partials
    and final results equal the JAX package's exactly (integer data, or
    values summed in float32 on both sides)."""
    if type_ == "column_sum" and case == "ids_seq":
        case = "value_seq_wide"
    rng = np.random.default_rng(13)
    jcfg, tcfg = _ev_cfgs(type_, ["x"])
    jacc, tacc = {}, {}
    jset = jev.EvaluatorSet(jschema.ModelConfig(evaluators=[jcfg]))
    tset = tev.EvaluatorSet(schema.ModelConfig(evaluators=[tcfg]))
    for _ in range(2):
        lens = np.array([5, 1, 3, 0])
        if case == "ids_seq":
            x = {"ids": rng.integers(0, 2, (4, 5)), "lengths": lens}
        elif case.startswith("value_seq"):
            x = {"value": rng.integers(-3, 4, (4, 5, 3)).astype(np.float32),
                 "lengths": lens}
        else:
            x = {"value": rng.integers(-3, 4, (4, 3)).astype(np.float32)}
        jctx, ctx = _contexts("test", {}, x=x)
        jacc = jset.accumulate(jacc, jset.batch_partials(jctx.outputs, {}))
        tacc = tset.accumulate(tacc, tset.batch_partials(ctx.outputs, {}))
    want, got = jset.finalize(jacc), tset.finalize(tacc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def _tag_rows(rng, scheme, types, B=6, T=12):
    kinds = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    hi = types * kinds + 1
    lens = np.array([12, 1, 7, 0, 12, 5])[:B]
    return rng.integers(0, hi, (B, T)), lens


@pytest.mark.parametrize("excluded", [[], [1, 2]], ids=["all", "excluded"])
@pytest.mark.parametrize("scheme", ["IOB", "IOE", "IOBES", "plain"])
def test_chunk_evaluator_counts_equal_jax(scheme, excluded):
    """The chunk evaluator over three batches of random tag rows (every
    tag of the scheme, ragged lengths with a length-0 and a length-1 row;
    outputs and labels independent, then outputs equal to the labels):
    the chunk counts and F1 equal the JAX evaluator's exactly."""
    rng = np.random.default_rng(14)
    jcfg, tcfg = _ev_cfgs("chunk", ["out", "lbl"], chunk_scheme=scheme,
                          num_chunk_types=3, excluded_chunk_types=excluded)
    jset = jev.EvaluatorSet(jschema.ModelConfig(evaluators=[jcfg]))
    tset = tev.EvaluatorSet(schema.ModelConfig(evaluators=[tcfg]))
    assert tset.host_layer_names == ["out", "lbl"]
    js, ts = jset.new_host_state(), tset.new_host_state()
    for i in range(3):
        out, lens = _tag_rows(rng, scheme, 3)
        lbl = out.copy() if i == 2 else _tag_rows(rng, scheme, 3)[0]
        jctx, ctx = _contexts("test", {}, out={"ids": out, "lengths": lens},
                              lbl={"ids": lbl, "lengths": lens})
        jset.host_update(js, jctx.outputs)
        tset.host_update(ts, tset.host_outputs(ctx.outputs))
    want, got = jset.finalize_host(js), tset.finalize_host(ts)
    assert got == want and want["correct_chunks"] > 0


def test_unported_evaluators_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tev.EvaluatorSet(schema.ModelConfig(evaluators=[
            schema.EvaluatorConfig(name="a", type="precision_recall",
                                   input_layer_names=["x", "y"])]))


# -- model averaging ----------------------------------------------------------

@pytest.mark.parametrize("max_window", [0, 3], ids=["running", "window"])
def test_model_averaging_matches_jax(max_window):
    """Seven momentum updates with averaging (average_window 0.5, and a
    max_average_window of 3 that restarts the window twice): parameters,
    averages (a static parameter's too) and the count after each update;
    the count an int32 tensor, updated in place."""
    specs = [dict(name="w", size=6, dims=[2, 3]),
             dict(name="b", size=3, dims=[1, 3], learning_rate=0.5),
             dict(name="s", size=2, dims=[1, 2], is_static=True)]
    kw = dict(learning_method="momentum", learning_rate=0.1, momentum=0.9,
              average_window=0.5, max_average_window=max_window)
    ju = JUpdater(jschema.ModelConfig(parameters=[
        jschema.ParameterConfig(**s) for s in specs]),
        jschema.OptimizationConfig(**kw))
    tu = ParameterUpdater(schema.ModelConfig(parameters=[
        schema.ParameterConfig(**s) for s in specs]),
        schema.OptimizationConfig(**kw))
    rng = np.random.default_rng(15)
    params = {s["name"]: rng.standard_normal(s["dims"]) for s in specs}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = ju.init_state(jp), tu.init_state(tp)
    count = ts["average_count"]
    assert count.dtype == torch.int32 and int(count) == 0
    for _ in range(7):
        grads = {k: rng.standard_normal(v.shape) for k, v in params.items()
                 if k != "s"}
        jp, js = ju.step(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                         js, 4)
        tp, ts = tu.step(tp, {k: _t(v) for k, v in grads.items()}, ts, 4)
        assert int(ts["average_count"]) == int(js["average_count"])
        for k in params:
            _close(tp[k].numpy(), jp[k], k)
            _close(ts["average"][k].numpy(), js["average"][k], f"avg {k}")
    assert ts["average_count"] is count
    assert int(count) == (7 if not max_window else 1)
    assert tu.averaged_params(tp, ts) is ts["average"]
    # the JAX state carried across resumes the same averages
    carried = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert carried["average_count"].dtype == torch.int32
    assert int(carried["average_count"]) == int(count)
    for k in params:
        np.testing.assert_array_equal(carried["average"][k].numpy(),
                                      np.asarray(js["average"][k],
                                                 np.float32))


def test_crf_decoding_hands_the_chunk_evaluator_error_indicators():
    """A finding in the reference, followed exactly: with a label input,
    crf_decoding's ids are the 0/1 error indicators, so a chunk evaluator
    on it (db_lstm.py, linear_crf.py, rnn_crf.py) segments indicators, not
    the decoded tags.  Both sides count the same chunks from them; the
    decoded path itself would give other counts."""
    rng = np.random.default_rng(16)
    B, T, C = 6, 9, 7                    # IOB over 3 chunk types + O
    lens = np.array([9, 4, 1, 7, 9, 2])
    x = {"value": rng.standard_normal((B, T, C)) * 2.0, "lengths": lens}
    lbl = _ids_arg(rng, B, T, C, lens)
    w = rng.standard_normal((C + 2, C))
    ins = [("x", "crfw", None), ("y", "", None)]
    jctx, ctx = _contexts("test", {"crfw": w}, x=x, y=lbl)
    jcfg, tcfg = _layer_cfgs("crf_decoding", ins, size=C)
    jdec, tdec = jget("crf_decoding")(jctx, jcfg), get_layer_fn(
        "crf_decoding")(ctx, tcfg)
    np.testing.assert_array_equal(tdec.ids.numpy(), np.asarray(jdec.ids))
    assert set(np.unique(tdec.ids.numpy())) <= {0, 1}
    jctx.outputs["dec"], ctx.outputs["dec"] = jdec, tdec
    jev_cfg, tev_cfg = _ev_cfgs("chunk", ["dec", "y"], chunk_scheme="IOB",
                                num_chunk_types=3)
    jset = jev.EvaluatorSet(jschema.ModelConfig(evaluators=[jev_cfg]))
    tset = tev.EvaluatorSet(schema.ModelConfig(evaluators=[tev_cfg]))
    js, ts = jset.new_host_state(), tset.new_host_state()
    jset.host_update(js, jctx.outputs)
    tset.host_update(ts, tset.host_outputs(ctx.outputs))
    got = tset.finalize_host(ts)
    assert got == jset.finalize_host(js)
    # the decoded path (crf_decoding without a label) chunked instead
    path = get_layer_fn("crf_decoding")(ctx, _layer_cfgs(
        "crf_decoding", ins[:1], size=C)[1])
    ctx.outputs["dec"] = path
    ps = tset.new_host_state()
    tset.host_update(ps, tset.host_outputs(ctx.outputs))
    assert tset.finalize_host(ps)["result_chunks"] != got["result_chunks"]


# -- row lookups --------------------------------------------------------------

def test_lookup_rows_matches_the_gather_and_repeats_bit_for_bit():
    """lookup_rows(ids, w) is w[ids], its gradient the per-row sum of the
    output gradient (against JAX's gather), and two backward calls on
    4,800 ids into a 2-row table (SRL's predicate mark) give the same bits
    on the CPU."""
    from paddle_tpu_torch.ops.table import lookup_rows
    rng = np.random.default_rng(17)
    ids = rng.integers(0, 2, (150, 32))
    w = rng.standard_normal((2, 5))
    _both(lambda t: lookup_rows(_t(ids), t), lambda t: t[jnp.asarray(ids)],
          w, what="lookup")
    grad = _t(rng.standard_normal((150, 32, 5)))

    def run():
        leaf = _t(w).requires_grad_(True)
        return torch.autograd.grad(lookup_rows(_t(ids), leaf), leaf,
                                   grad)[0]
    assert torch.equal(run(), run())


def test_prepare_batch_takes_sparse_rows_and_refuses_nested_feeds():
    """Trainer.prepare_batch moves sparse rows to the device as int64 ids
    with their values, range-checks the ids against the rows' width, and
    takes a nested feed with its sub_lengths, as the JAX Trainer takes
    it (its ids range-checked like a flat feed's)."""
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.trainer import Trainer
    tr = Trainer(parse_config("demo/sequence_tagging/linear_crf.py",
                              "batch_size=2"), device="cpu")
    lens = np.array([3, 2], np.int32)
    ids = np.zeros((2, 3), np.int32)
    feats = np.array([[[5, 0], [7, 9], [0, 0]], [[1, 2], [3, 0], [0, 0]]],
                     np.int32)
    vals = (feats > 0).astype(np.float32)

    def batch(f):
        return {"features": Argument(ids=f, sparse_vals=vals,
                                     sparse_dim=1024, lengths=lens),
                "word": Argument(ids=ids, lengths=lens),
                "pos": Argument(ids=ids, lengths=lens),
                "chunk": Argument(ids=ids, lengths=lens)}
    got = tr.prepare_batch(batch(feats))["features"]
    assert got.ids.dtype == torch.int64 and got.sparse_dim == 1024
    assert torch.equal(got.sparse_vals, _t(vals))
    with pytest.raises(ValueError, match="sparse row width 1024"):
        tr.prepare_batch(batch(feats + 1020))
    nested = batch(feats)
    sub = np.array([[2, 1], [3, 0]], np.int32)
    nested["word"] = Argument(ids=np.zeros((2, 2, 3), np.int32),
                              lengths=lens - 1, sub_lengths=sub)
    got = tr.prepare_batch(nested)["word"]
    assert torch.equal(got.sub_lengths, _t(sub))
    assert torch.equal(got.lengths, _t(lens - 1))
    assert got.ids.shape == (2, 2, 3) and got.ids.dtype == torch.int64
    nested["word"] = nested["word"].replace(
        ids=np.full((2, 2, 3), 10 ** 6, np.int32))
    with pytest.raises(ValueError, match="out of range"):
        tr.prepare_batch(nested)
