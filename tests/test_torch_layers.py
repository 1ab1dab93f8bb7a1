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
from paddle_tpu_torch.config.schema import (LayerConfig, LayerInput,
                                            SubModelConfig)
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
    """Blockwise attention, the context-parallel paths (ring, ulysses), the
    dense per-request KV cache of lm_generate and recurrent sub-models are
    queued in ROADMAP.md: they raise.  The flash route (auto at >=
    block_k_min keys, or pinned) and TRAIN mode run (tests/
    test_torch_train.py holds them against the JAX package)."""
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
    rnn = transformer_lm_config(61, 32, 1, 4)
    rnn.sub_models.append(SubModelConfig(name="g",
                                         is_recurrent_layer_group=True))
    with pytest.raises(NotImplementedError):
        GraphExecutor(rnn)


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
