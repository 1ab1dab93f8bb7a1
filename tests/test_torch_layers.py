"""PyTorch port: layers and the full-sequence forward against the JAX
package, at small widths in float32 (only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.ops import attention as jattn
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer
from paddle_tpu_torch.config.schema import LayerConfig, LayerInput
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.layers_misc import layer_norm_layer
from paddle_tpu_torch.models import transformer_lm_config
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops.activations import activation
from paddle_tpu_torch.parameter import Argument, params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module", params=["", ",kv_heads=2"],
                ids=["mha", "gqa"])
def lm(request):
    extra = request.param
    cfg = parse_config("demo/model_zoo/transformer_lm.py",
                       "vocab=61,dim=32,layers=2,heads=4,batch_size=4"
                       + extra)
    tr = Trainer(cfg, seed=7)
    kw = {"kv_heads": 2} if extra else {}
    ex = GraphExecutor(transformer_lm_config(61, 32, 2, 4, **kw))
    params = params_from_jax({k: np.asarray(v) for k, v in tr.params.items()},
                             device="cpu")
    return tr, ex, params


def test_forward_matches_jax_executor(lm):
    """TEST-mode full-sequence forward (dense attention, ragged lengths):
    the port's lm_head output equals the JAX executor's."""
    tr, ex, params = lm
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 61, (3, 10)).astype(np.int32)
    lens = np.array([10, 7, 3], np.int32)
    out, costs, _ = ex.forward(params, {"tokens": Argument(
        ids=_t(ids).long(), lengths=_t(lens))})
    want, _, _ = tr.executor.forward(tr.params, {"tokens": JArgument(
        ids=jnp.asarray(ids), lengths=jnp.asarray(lens))}, None, "test")
    got = out["lm_head"].value.numpy()
    np.testing.assert_allclose(got, np.asarray(want["lm_head"].value), **TOL)
    assert costs == {}
    assert "__classification_cost_0__" not in out      # no labels fed


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(activation("gelu", _t(x)).numpy(),
                               np.asarray(jax.nn.gelu(x, approximate=True)),
                               **TOL)


def test_softmax_runs_in_float32_and_keeps_dtype():
    x = torch.randn(4, 33, generator=torch.Generator().manual_seed(1))
    y = activation("softmax", x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(jax.nn.softmax(jnp.asarray(x.numpy()).astype(
            jnp.bfloat16).astype(jnp.float32)).astype(jnp.bfloat16)
            .astype(jnp.float32)), atol=4e-3)


def test_layer_norm_matches_jax():
    """Population variance, rsqrt(var + 1e-6), [1, D] scale/bias."""
    from paddle_tpu.config.schema import LayerConfig as JLayerConfig
    from paddle_tpu.config.schema import LayerInput as JLayerInput
    from paddle_tpu.graph.context import ForwardContext as JContext
    from paddle_tpu.graph.layers_misc import layer_norm_layer as jln
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, (2, 5, 16)).astype(np.float32)
    w = rng.normal(1.0, 0.1, (1, 16)).astype(np.float32)
    b = rng.normal(0.0, 0.1, (1, 16)).astype(np.float32)
    lens = np.array([5, 2], np.int32)
    tcfg = LayerConfig(name="ln", type="layer_norm", size=16,
                       inputs=[LayerInput("x", "w")], bias_parameter_name="b")
    ctx = ForwardContext(model=None, params={"w": _t(w), "b": _t(b)})
    ctx.outputs["x"] = Argument(value=_t(x), lengths=_t(lens))
    got = layer_norm_layer(ctx, tcfg)
    jcfg = JLayerConfig(name="ln", type="layer_norm", size=16,
                        inputs=[JLayerInput("x", "w")],
                        bias_parameter_name="b")
    jctx = JContext(model=None, params={"w": jnp.asarray(w),
                                        "b": jnp.asarray(b)}, mode="test")
    jctx.outputs["x"] = JArgument(value=jnp.asarray(x),
                                  lengths=jnp.asarray(lens))
    want = jln(jctx, jcfg)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               **TOL)
    assert torch.equal(got.lengths, _t(lens))


@pytest.mark.parametrize("pos_shape", ["global", "per_row"])
def test_rope_matches_jax(pos_shape):
    """Rotate-half layout; float32 angles from [T] or [B, T] positions."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 2, 8)).astype(np.float32)
    pos = (np.arange(7) + 40 if pos_shape == "global"
           else rng.integers(0, 500, (3, 7))).astype(np.int32)
    np.testing.assert_allclose(
        tattn.rope(_t(x), _t(pos), 500.0).numpy(),
        np.asarray(jattn.rope(jnp.asarray(x), jnp.asarray(pos), 500.0)),
        **TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_dense_attention_matches_jax(window):
    """Causal, key/query validity, grouped kv heads, fully masked rows."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 6, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 6, 2, 8)).astype(np.float32)
    valid = np.arange(6)[None, :] < np.array([6, 3])[:, None]
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), _t(valid),
                                      _t(valid), causal=True, window=window)
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        jnp.asarray(valid), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_paths_raise():
    """Blockwise attention, the context-parallel paths (ring, ulysses) and
    the dense per-request KV cache of lm_generate are queued in
    ROADMAP.md: they raise.  The flash route (auto at >= block_k_min keys,
    or pinned) and TRAIN mode run (tests/test_torch_train.py holds them
    against the JAX package), and so does a recurrent group nested in a
    group: tests/configs/sequence_nest_rnn.py's TEST forward gives the JAX
    executor's costs (within 1e-5) on rows with an empty sub-sequence."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parameter import init_params
    model = transformer_lm_config(61, 32, 1, 4, block_k_min=8)
    params = init_params(model, seed=0, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    feed = {"tokens": Argument(ids=ids, lengths=torch.tensor([8]))}
    fa.counts.reset()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out, _, _ = GraphExecutor(model).forward(leaves, feed, mode="train")
    assert out["lm_head"].value.shape == (1, 8, 61)
    assert out["lm_head"].value.requires_grad and fa.counts.plain == 1
    for impl in ("blockwise", "ring", "ulysses"):
        ex = GraphExecutor(transformer_lm_config(61, 32, 1, 4,
                                                 attn_impl=impl))
        with pytest.raises(NotImplementedError, match="not ported"):
            ex.forward(params, feed)
    with pytest.raises(NotImplementedError, match="lm_generate"):
        GraphExecutor(model).forward(params, feed, state={
            "blk0_attn": {"k": torch.zeros(1, 8, 4, 8),
                          "v": torch.zeros(1, 8, 4, 8),
                          "pos": torch.zeros(1, dtype=torch.int32)}})
    from paddle_tpu.graph.builder import GraphExecutor as JExecutor
    from paddle_tpu_torch.config.schema import TrainerConfig
    jcfg = parse_config("tests/configs/sequence_nest_rnn.py", "")
    nested = TrainerConfig.from_json(jcfg.to_json()).model_config
    assert any(sm.parent for sm in nested.sub_models)
    jex = JExecutor(jcfg.model_config)
    jparams = jex.init_params(jax.random.PRNGKey(3))
    ids = np.random.default_rng(4).integers(0, 10, (2, 3, 4)).astype(
        np.int32)
    lens = np.array([2, 3], np.int32)
    sub = np.array([[3, 2, 0], [2, 0, 4]], np.int32)
    label = np.array([0, 2], np.int32)
    _, want, _ = jex.forward(jparams, {
        "word": JArgument(ids=jnp.asarray(ids), lengths=jnp.asarray(lens),
                          sub_lengths=jnp.asarray(sub)),
        "label": JArgument(ids=jnp.asarray(label))}, None, "test")
    _, got, _ = GraphExecutor(nested).forward(
        params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                        device="cpu"),
        {"word": Argument(ids=_t(ids).long(), lengths=_t(lens),
                          sub_lengths=_t(sub)),
         "label": Argument(ids=_t(label).long())})
    assert set(got) == set(want)
    for name, c in got.items():
        np.testing.assert_allclose(c.numpy(), np.asarray(want[name]), **TOL)


def test_bfloat16_compute_dtype_casts_params_and_keeps_norms_fp32():
    """compute_dtype='bfloat16': float params cast, the forward runs, the
    probabilities come back in bfloat16 and stay close to float32."""
    model = transformer_lm_config(61, 32, 2, 4)
    from paddle_tpu_torch.parameter import init_params
    params = init_params(model, seed=0, device="cpu")
    ids = torch.randint(0, 61, (2, 9), generator=torch.Generator()
                        .manual_seed(0))
    feed = {"tokens": Argument(ids=ids, lengths=torch.tensor([9, 5]))}
    lo = GraphExecutor(model, "bfloat16")
    p16, _ = lo.prepare(params, feed)
    assert all(v.dtype == torch.bfloat16 for v in p16.values())
    got = lo.forward(params, feed)[0]["lm_head"].value
    want = GraphExecutor(model).forward(params, feed)[0]["lm_head"].value
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-3)


# -- sequence pooling, mixed projections, concat, dropout ---------------------

def _seq(seed=0, B=4, T=6, D=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.array([T, 1, 3, 0], np.int32)[:B]
    return x, lens


@pytest.mark.parametrize("name,kw", [
    ("seq_pool_max", {}), ("seq_pool_avg", {"strategy": "average"}),
    ("seq_pool_avg", {"strategy": "sum"}),
    ("seq_pool_avg", {"strategy": "squarerootn"}),
    ("seq_pool_first", {}), ("seq_pool_last", {})],
    ids=["max", "average", "sum", "squarerootn", "first", "last"])
def test_sequence_pools_match_jax(name, kw):
    """ops/sequence.py pools on a ragged batch (a full row, a single-step
    row, a length-0 row) against paddle_tpu.ops.sequence; exact for the
    selections, 1e-6 for the sums."""
    from paddle_tpu.ops import sequence as jseq
    from paddle_tpu_torch.ops import sequence as tseq
    x, lens = _seq()
    got = getattr(tseq, name)(_t(x), _t(lens), **kw)
    want = getattr(jseq, name)(jnp.asarray(x), jnp.asarray(lens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sequence_pool_rejects_unknown_strategy():
    from paddle_tpu_torch.ops import sequence as tseq
    x, lens = _seq()
    with pytest.raises(ValueError, match="average_strategy"):
        tseq.seq_pool_avg(_t(x), _t(lens), "median")


def _both_contexts(mode, **outputs):
    """The same named outputs (numpy value, lengths) in a JAX and a port
    ForwardContext."""
    from paddle_tpu.graph.context import ForwardContext as JContext
    jctx = JContext(model=None, params={}, mode=mode)
    ctx = ForwardContext(model=None, params={}, mode=mode)
    for name, (value, lens) in outputs.items():
        jctx.outputs[name] = JArgument(
            value=jnp.asarray(value),
            lengths=None if lens is None else jnp.asarray(lens))
        ctx.outputs[name] = Argument(
            value=_t(value), lengths=None if lens is None else _t(lens))
    return jctx, ctx


@pytest.mark.parametrize("type_,fields", [
    ("max", {}), ("average", {"average_strategy": "sum"}),
    ("seqlastins", {}), ("seqlastins", {"select_first": True})],
    ids=["max", "average-sum", "last", "first"])
def test_pooling_layers_match_jax(type_, fields):
    """The max / average / seqlastins layers on a ragged sequence equal the
    JAX layers and give a non-sequence [B, D] output."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.graph.registry import get_layer_fn as jget
    from paddle_tpu_torch.graph.registry import get_layer_fn
    x, lens = _seq(1)
    jctx, ctx = _both_contexts("test", x=(x, lens))
    spec = dict(name="p", type=type_, size=5, **fields)
    want = jget(type_)(jctx, JLayer(inputs=[JInput("x")], **spec))
    got = get_layer_fn(type_)(ctx, LayerConfig(inputs=[LayerInput("x")],
                                               **spec))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-6, atol=1e-6)
    assert got.lengths is None and want.lengths is None


def test_pooling_layers_refuse_what_is_not_ported():
    """Per-sub-sequence pooling (agg_level='seq') of a flat sequence raises
    on both sides (it needs a nested input); of a nested input it gives the
    JAX layer's [B, S, D] sequence; a non-sequence input raises."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.graph.registry import get_layer_fn as jget
    from paddle_tpu_torch.graph.registry import get_layer_fn
    x, lens = _seq(1)
    jctx, ctx = _both_contexts("test", x=(x, lens), flat=(x[:, 0], None))
    spec = dict(name="p", type="max", trans_type="seq")
    with pytest.raises(ValueError, match="NESTED"):
        get_layer_fn("max")(ctx, LayerConfig(inputs=[LayerInput("x")],
                                             **spec))
    with pytest.raises(ValueError, match="NESTED"):
        jget("max")(jctx, JLayer(inputs=[JInput("x")], **spec))
    nested = x.reshape(4, 2, 3, 5)
    sub = np.array([[3, 1], [1, 0], [2, 3], [0, 0]], np.int32)
    n_sub = np.array([2, 1, 2, 0], np.int32)
    jctx.outputs["n"] = JArgument(value=jnp.asarray(nested),
                                  lengths=jnp.asarray(n_sub),
                                  sub_lengths=jnp.asarray(sub))
    ctx.outputs["n"] = Argument(value=_t(nested), lengths=_t(n_sub),
                                sub_lengths=_t(sub))
    want = jget("max")(jctx, JLayer(inputs=[JInput("n")], **spec))
    got = get_layer_fn("max")(ctx, LayerConfig(inputs=[LayerInput("n")],
                                               **spec))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               **TOL)
    assert torch.equal(got.lengths, _t(n_sub))
    with pytest.raises(ValueError, match="sequence input"):
        get_layer_fn("average")(ctx, LayerConfig(
            name="p", type="average", inputs=[LayerInput("flat")]))


def test_mixed_projections_and_concat_match_jax():
    """mixed with a full-matrix ('fc') and an identity projection plus a
    bias, and concat, against the JAX layers (1e-6: one float32 matmul)."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.config.schema import ProjectionConfig as JProj
    from paddle_tpu.graph.registry import get_layer_fn as jget
    from paddle_tpu_torch.config.schema import ProjectionConfig
    from paddle_tpu_torch.graph.registry import get_layer_fn
    rng = np.random.default_rng(2)
    x, lens = _seq(2)
    y = rng.standard_normal((4, 6, 7)).astype(np.float32)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    b = rng.standard_normal((1, 7)).astype(np.float32)
    jctx, ctx = _both_contexts("test", x=(x, lens), y=(y, lens))
    jctx.params.update(w=jnp.asarray(w), b=jnp.asarray(b))
    ctx.params.update(w=_t(w), b=_t(b))
    spec = dict(name="m", type="mixed", size=7, bias_parameter_name="b",
                active_type="tanh")
    want = jget("mixed")(jctx, JLayer(inputs=[
        JInput("x", "w", JProj(type="fc", input_size=5, output_size=7)),
        JInput("y", "", JProj(type="identity", input_size=7,
                              output_size=7))], **spec))
    got = get_layer_fn("mixed")(ctx, LayerConfig(inputs=[
        LayerInput("x", "w", ProjectionConfig(type="fc", input_size=5,
                                              output_size=7)),
        LayerInput("y", "", ProjectionConfig(type="identity", input_size=7,
                                             output_size=7))], **spec))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(got.lengths, _t(lens))
    with pytest.raises(NotImplementedError, match="nonesuch"):
        get_layer_fn("mixed")(ctx, LayerConfig(inputs=[LayerInput(
            "x", "w", ProjectionConfig(type="nonesuch"))], **spec))
    cspec = dict(name="c", type="concat", size=12)
    cwant = jget("concat")(jctx, JLayer(inputs=[JInput("x"), JInput("y")],
                                        **cspec))
    cgot = get_layer_fn("concat")(ctx, LayerConfig(
        inputs=[LayerInput("x"), LayerInput("y")], **cspec))
    np.testing.assert_array_equal(cgot.value.numpy(), np.asarray(cwant.value))
    assert torch.equal(cgot.lengths, _t(lens))


def _dropout_layer(p=0.5):
    return LayerConfig(name="d", type="addto", size=64, drop_rate=p,
                       inputs=[LayerInput("x")])


def _dropout_ctx(mode, seed=None, masks=None, shape=(64, 64)):
    ctx = ForwardContext(model=None, params={}, mode=mode,
                         dropout_masks=masks or {})
    if seed is not None:
        ctx.rng = torch.Generator().manual_seed(seed)
    ctx.outputs["x"] = Argument(value=torch.ones(shape))
    return ctx


def test_dropout_test_mode_scales_by_the_keep_rate():
    """Classic (non-inverted) dropout: TEST multiplies by 1 - p and draws
    nothing, as the JAX layer does."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.graph.registry import get_layer_fn as jget
    from paddle_tpu_torch.graph.registry import get_layer_fn
    out = get_layer_fn("addto")(_dropout_ctx("test"), _dropout_layer(0.3))
    jctx, _ = _both_contexts("test", x=(np.ones((64, 64), np.float32), None))
    want = jget("addto")(jctx, JLayer(name="d", type="addto", size=64,
                                      drop_rate=0.3, inputs=[JInput("x")]))
    np.testing.assert_allclose(out.value.numpy(), np.asarray(want.value),
                               rtol=1e-7)
    assert float(out.value[0, 0]) == pytest.approx(0.7)


@pytest.mark.parametrize("p", [0.5, 0.2], ids=["p0.5", "p0.2"])
def test_dropout_train_mask_statistics_and_seed(p):
    """TRAIN multiplies by a 0/1 keep-mask (no rescaling) whose keep rate
    is within 3 sigma of 1 - p; the same generator seed gives the same
    mask, another seed another; successive layers draw different masks."""
    from paddle_tpu_torch.graph.registry import get_layer_fn
    addto = get_layer_fn("addto")
    a = addto(_dropout_ctx("train", seed=5), _dropout_layer(p)).value
    assert set(a.unique().tolist()) == {0.0, 1.0}
    n = a.numel()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(a.mean()) - (1 - p)) < 3 * sigma
    again = addto(_dropout_ctx("train", seed=5), _dropout_layer(p)).value
    other = addto(_dropout_ctx("train", seed=6), _dropout_layer(p)).value
    assert torch.equal(a, again) and not torch.equal(a, other)
    ctx = _dropout_ctx("train", seed=5)
    first = addto(ctx, _dropout_layer(p)).value
    second = addto(ctx, _dropout_layer(p)).value
    assert torch.equal(first, a) and not torch.equal(second, first)


def test_dropout_mask_injection_and_its_errors():
    """A mask in dropout_masks replaces the draw (no generator needed);
    without either a TRAIN forward raises, and a mask of the wrong shape
    raises."""
    from paddle_tpu_torch.graph.registry import get_layer_fn
    addto = get_layer_fn("addto")
    mask = torch.zeros(64, 64, dtype=torch.bool)
    mask[::2] = True
    out = addto(_dropout_ctx("train", masks={"d": mask}), _dropout_layer())
    assert torch.equal(out.value, mask.float())
    with pytest.raises(ValueError, match="needs an rng"):
        addto(_dropout_ctx("train"), _dropout_layer())
    with pytest.raises(ValueError, match="dropout mask"):
        addto(_dropout_ctx("train", masks={"d": mask[:3]}), _dropout_layer())
    # a layer without dropout needs neither
    plain = addto(_dropout_ctx("train"), _dropout_layer(0.0))
    assert torch.equal(plain.value, torch.ones(64, 64))


# -- the seq2seq's layers: gated_recurrent, gru_step, additive_attention_step

def _layer_pair(type_, inputs, **spec):
    """The same layer config for the JAX registry and the port's: inputs
    are (layer name, parameter name) pairs."""
    from paddle_tpu.config.schema import LayerConfig as JLayer
    from paddle_tpu.config.schema import LayerInput as JInput
    from paddle_tpu.graph.registry import get_layer_fn as jget
    from paddle_tpu_torch.graph.registry import get_layer_fn
    jcfg = JLayer(type=type_, inputs=[JInput(*i) for i in inputs], **spec)
    cfg = LayerConfig(type=type_, inputs=[LayerInput(*i) for i in inputs],
                      **spec)
    return (lambda ctx: jget(type_)(ctx, jcfg),
            lambda ctx: get_layer_fn(type_)(ctx, cfg))


def _add_params(jctx, ctx, **params):
    for name, a in params.items():
        jctx.params[name] = jnp.asarray(a)
        ctx.params[name] = _t(a)


@pytest.mark.parametrize("reverse,act,bias", [
    (False, "tanh", True), (True, "tanh", True), (False, "relu", False),
    (True, "sigmoid", True)], ids=["fwd-tanh", "rev-tanh", "fwd-relu-nobias",
                                   "rev-sigmoid"])
def test_gated_recurrent_layer_matches_jax(reverse, act, bias):
    """gated_recurrent on a ragged [B, T, 3D] input (a full row, a length-1
    row, a length-0 row): the one [D, 3D] weight split into its gate and
    candidate columns, the bias added, the direction; the hidden sequence
    within 1e-5 of the JAX layer's, with the input's lengths."""
    rng = np.random.default_rng(7)
    D = 6
    x = rng.standard_normal((4, 5, 3 * D)).astype(np.float32)
    lens = np.array([5, 1, 3, 0], np.int32)
    jctx, ctx = _both_contexts("test", x=(x, lens))
    _add_params(jctx, ctx,
                w=(rng.standard_normal((D, 3 * D)) * 0.5).astype(np.float32),
                b=(rng.standard_normal((1, 3 * D)) * 0.3).astype(np.float32))
    jrun, run = _layer_pair("gated_recurrent", [("x", "w")], name="g",
                            size=D, active_type=act, reversed=reverse,
                            bias_parameter_name="b" if bias else "",
                            attrs={"active_gate_type": "sigmoid"})
    want, got = jrun(jctx), run(ctx)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               **TOL)
    assert torch.equal(got.lengths, _t(lens))
    assert got.value.shape == (4, 5, D)


def test_gated_recurrent_refuses_prev_batch_state():
    """--prev_batch_state: handed a carried state of its batch size, the
    layer boots from it and hands on its final state, as the JAX layer
    does (within 1e-5); a state of another batch size is ignored, and
    without the flag the state is neither read nor written."""
    from paddle_tpu.utils.flags import FLAGS as JFLAGS
    from paddle_tpu_torch.utils.flags import FLAGS
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32) * 0.5
    h0 = rng.standard_normal((2, 4)).astype(np.float32)
    jrun, run = _layer_pair("gated_recurrent", [("x", "w")], name="g",
                            size=4, active_type="tanh",
                            attrs={"active_gate_type": "sigmoid"})
    saved = FLAGS.prev_batch_state, JFLAGS.prev_batch_state
    FLAGS.prev_batch_state = JFLAGS.prev_batch_state = True
    try:
        outs = []
        for carried in (h0, h0[:1]):
            jctx, ctx = _both_contexts("test",
                                       x=(x, np.array([3, 2], np.int32)))
            _add_params(jctx, ctx, w=w)
            jctx.state_in["g:h"] = jnp.asarray(carried)
            ctx.state_in["g:h"] = _t(carried)
            want, got = jrun(jctx), run(ctx)
            np.testing.assert_allclose(got.value.numpy(),
                                       np.asarray(want.value), **TOL)
            np.testing.assert_allclose(ctx.state_out["g:h"].numpy(),
                                       np.asarray(jctx.state_out["g:h"]),
                                       **TOL)
            outs.append(got.value)
        assert not torch.equal(outs[0], outs[1])
        FLAGS.prev_batch_state = False
        _, ctx = _both_contexts("test", x=(x, np.array([3, 2], np.int32)))
        ctx.params["w"] = _t(w)
        ctx.state_in["g:h"] = _t(h0)
        assert torch.equal(run(ctx).value, outs[1])
        assert ctx.state_out == {}
    finally:
        FLAGS.prev_batch_state, JFLAGS.prev_batch_state = saved


@pytest.mark.parametrize("act,bias", [("tanh", True), ("relu", False)],
                         ids=["tanh-bias", "relu-nobias"])
def test_gru_step_layer_matches_jax(act, bias):
    """gru_step: one step on [B, 3D] and the previous hidden [B, D] with
    its own [D, 3D] weight, within 1e-5 of the JAX layer."""
    rng = np.random.default_rng(9)
    D = 5
    jctx, ctx = _both_contexts(
        "test", x=(rng.standard_normal((3, 3 * D)).astype(np.float32), None),
        h=(rng.standard_normal((3, D)).astype(np.float32), None))
    _add_params(jctx, ctx,
                w=(rng.standard_normal((D, 3 * D)) * 0.5).astype(np.float32),
                b=(rng.standard_normal((1, 3 * D)) * 0.3).astype(np.float32))
    jrun, run = _layer_pair("gru_step", [("x", "w"), ("h", "")], name="s",
                            size=D, active_type=act,
                            bias_parameter_name="b" if bias else "",
                            attrs={"active_gate_type": "sigmoid"})
    np.testing.assert_allclose(run(ctx).value.numpy(),
                               np.asarray(jrun(jctx).value), **TOL)


@pytest.mark.parametrize("impl,keys", [
    ("auto", "proj"), ("auto", "seq"), ("dense", "proj"), ("dense", "seq"),
    ("auto", "none")], ids=["kernel-proj-lengths", "kernel-seq-lengths",
                            "dense-proj-lengths", "dense-seq-lengths",
                            "kernel-no-lengths"])
def test_additive_attention_layer_matches_jax(impl, keys, monkeypatch):
    """additive_attention_step with the keys' lengths taken from
    encoded_proj, else from encoded_sequence (all keys when neither is a
    sequence).  'auto' is the kernel route (its plain version here; the
    JAX layer's Pallas kernel in interpret mode), a length-0 row giving a
    zero context; attn_impl='dense' is the dense formula on both sides,
    that row averaging all keys.  Within 1e-5."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(10)
    B, T, Ds, D, Dv = 4, 6, 5, 7, 9
    lens = np.array([6, 2, 0, 4], np.int32) if keys != "none" else None
    proj = rng.standard_normal((B, T, D)).astype(np.float32)
    seq = rng.standard_normal((B, T, Dv)).astype(np.float32)
    jctx, ctx = _both_contexts(
        "test", dec=(rng.standard_normal((B, Ds)).astype(np.float32), None),
        proj=(proj, lens if keys == "proj" else None),
        seq=(seq, lens if keys == "seq" else None))
    _add_params(jctx, ctx,
                w=(rng.standard_normal((Ds, D)) * 0.4).astype(np.float32),
                v=rng.standard_normal((D, 1)).astype(np.float32))
    jrun, run = _layer_pair("additive_attention_step",
                            [("dec", "w"), ("proj", "v"), ("seq", "")],
                            name="attention", size=Dv,
                            attrs={"attn_impl": impl})
    got, want = run(ctx).value.numpy(), np.asarray(jrun(jctx).value)
    np.testing.assert_allclose(got, want, **TOL)
    assert got.shape == (B, Dv)
    if keys != "none":
        if impl == "auto":
            assert not got[2].any()
        else:
            np.testing.assert_allclose(got[2], seq[2].mean(0), **TOL)
