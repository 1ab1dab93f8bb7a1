"""PyTorch port: the image layers (graph/layers_conv.py and the mixed
layer's conv projection and operator) against the JAX package's layer
functions on the CPU, forward and gradients, at small sizes in float32.

Each case builds one layer config, converts it to the JAX package's schema
(the same fields), and runs both layer functions on the same seeded inputs
and parameters.  Both outputs are taken as flat C-major rows; a random
cotangent gives the gradients of every parameter and input.  Limits, in
float32 where only the summation order differs: the forward within 1e-5 of
the reference's max |value|, each gradient within 1e-4 of the reference
gradient's max |value|, batch-norm state within 1e-5 of its max.

The inputs are continuous random normals, so no pool window holds tied
maxima: the port's F.max_pool2d sends a tie's cotangent to one element, the
JAX package's reduce-window max to one chosen its own way, and the
reshape-reductions of both fast paths share it among the ties.  The models
feed ties only as ReLU zeros, whose cotangent dies in the ReLU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.graph.builder  # noqa: F401  (registers the JAX layers)
from paddle_tpu.config.schema import ConvConfig as JConvConfig
from paddle_tpu.config.schema import LayerConfig as JLayerConfig
from paddle_tpu.graph.context import ForwardContext as JContext
from paddle_tpu.graph.layers_conv import conv2d_forward_nhwc
from paddle_tpu.graph.registry import get_layer_fn as jget
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu_torch.config.schema import (ConvConfig, LayerConfig,
                                            LayerInput, NormConfig,
                                            OperatorConfig, PoolConfig,
                                            ProjectionConfig)
from paddle_tpu_torch.graph.builder import GraphExecutor  # noqa: F401
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.layers_conv import conv2d_forward_image
from paddle_tpu_torch.graph.registry import get_layer_fn
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.utils.geometry import conv_output_size

B = 3
FWD_TOL = 1e-5      # share of the reference output's max |value|
GRAD_TOL = 1e-4     # share of each reference gradient's max |value|
STATE_TOL = 1e-5    # share of each reference statistic's max |value|


class Img:
    """A feed that arrives as an image: [B, C, H, W] (the JAX side gets
    it as [B, H, W, C])."""

    def __init__(self, value):
        self.value = value


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + 1e-7,
                               err_msg=what)


def _run_both(cfg, feeds, params, mode="train", state=None, seed=0):
    """cfg through the JAX layer function and the port's, in `mode`, on
    the feeds (flat rows, or Img) and parameters: both outputs as flat
    rows, the gradients of <output, cotangent> for every parameter and
    feed, and both new states."""
    rng = np.random.default_rng(seed + 100)
    jcfg = JLayerConfig.from_dict(cfg.to_dict())
    images = {n for n, v in feeds.items() if isinstance(v, Img)}
    arrays = {n: (v.value if isinstance(v, Img) else v)
              for n, v in feeds.items()}

    def jax_fn(p, xs):
        ctx = JContext(model=None, params=p, mode=mode,
                       rng=jax.random.PRNGKey(0),
                       state_in={k: {s: jnp.asarray(a) for s, a in v.items()}
                                 for k, v in (state or {}).items()})
        for n, v in xs.items():
            if n in images:
                ctx.outputs[n] = JArgument(value=jnp.transpose(v, (0, 2, 3, 1)),
                                           nhwc=True)
            else:
                ctx.outputs[n] = JArgument(value=v)
        out = jget(jcfg.type)(ctx, jcfg).flatten_image()
        return out.value, ctx.state_out

    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jxs = {n: jnp.asarray(v) for n, v in arrays.items()}
    want, vjp, jstate = jax.vjp(jax_fn, jp, jxs, has_aux=True)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(cot))

    tp = {n: torch.from_numpy(v.copy()).requires_grad_(True)
          for n, v in params.items()}
    txs = {n: torch.from_numpy(v.copy()).requires_grad_(True)
           for n, v in arrays.items()}
    ctx = ForwardContext(model=None, params=tp, mode=mode,
                         state_in={k: {s: torch.from_numpy(np.array(a))
                                       for s, a in v.items()}
                                   for k, v in (state or {}).items()})
    for n, v in txs.items():
        ctx.outputs[n] = Argument(value=v, image=n in images)
    out = get_layer_fn(cfg.type)(ctx, cfg).flatten_image()
    leaves = list(tp.values()) + list(txs.values())
    grads = torch.autograd.grad(out.value, leaves, torch.from_numpy(cot),
                                allow_unused=True)
    got_g = dict(zip([f"param {n}" for n in tp] + [f"input {n}" for n in txs],
                     grads))
    want_g = {f"param {n}": jgp[n] for n in tp}
    want_g.update({f"input {n}": jgx[n] for n in txs})
    return (out.value.detach().numpy(), np.asarray(want), got_g, want_g,
            ctx.state_out, jstate)


def _check(cfg, feeds, params, mode="train", state=None):
    got, want, got_g, want_g, tstate, jstate = _run_both(cfg, feeds, params,
                                                         mode, state)
    _close(got, want, FWD_TOL, "forward")
    assert float(np.abs(want).max()) > 0
    for what, w in want_g.items():
        g = got_g[what]
        assert g is not None, what
        _close(g.numpy(), w, GRAD_TOL, what)
    assert set(tstate) == set(jstate)
    for name, st in jstate.items():
        for k, v in st.items():
            _close(tstate[name][k].detach().numpy(), v, STATE_TOL,
                   f"state {name}.{k}")
    return tstate


# -- convolutions -----------------------------------------------------------

def _conv_geom(C, img, fs, stride, pad, groups=1, img_y=0, fs_y=0,
               trans=False, output=0):
    iy, fy = img_y or img, fs_y or fs
    if trans:
        ox = oy = output or (img - 1) * stride - 2 * pad + fs
    else:
        ox = conv_output_size(img, fs, stride, pad)
        oy = conv_output_size(iy, fy, stride, pad)
    return ConvConfig(filter_size=fs, filter_size_y=fs_y, channels=C,
                      stride=stride, padding=pad, groups=groups,
                      img_size=img, img_size_y=img_y, output_x=ox,
                      output_y=oy)


def _conv_case(rng, C, F, img, fs, stride, pad, groups=1, shared=True,
               type_="exconv", img_y=0, fs_y=0, output=0):
    trans = type_ == "exconvt"
    conv = _conv_geom(C, img, fs, stride, pad, groups, img_y, fs_y, trans,
                      output)
    oy, ox = conv.output_y, conv.output_x
    cfg = LayerConfig(name="c", type=type_, size=F * oy * ox,
                      active_type="tanh", num_filters=F, conv=conv,
                      shared_biases=shared, bias_parameter_name="b",
                      inputs=[LayerInput("x", "w")])
    fy = fs_y or fs
    params = {"w": _normal(rng, F, C // groups * fs * fy, scale=0.3),
              "b": _normal(rng, 1, F if shared else F * oy * ox, scale=0.1)}
    feeds = {"x": _normal(rng, B, C * (img_y or img) * img)}
    return cfg, feeds, params


CONV_CASES = {
    "stride1-same-pad": dict(C=3, F=4, img=6, fs=3, stride=1, pad=1),
    "stride2-asymmetric-pad": dict(C=3, F=4, img=8, fs=3, stride=2, pad=1),
    "stride2-cropping-pad": dict(C=2, F=3, img=7, fs=2, stride=2, pad=0),
    "groups2": dict(C=4, F=6, img=5, fs=3, stride=1, pad=1, groups=2),
    "per-position-bias": dict(C=2, F=3, img=5, fs=3, stride=2, pad=1,
                              shared=False),
    "non-square": dict(C=2, F=3, img=7, img_y=5, fs=3, fs_y=2, stride=1,
                       pad=0),
    "cudnn_conv": dict(C=3, F=2, img=6, fs=3, stride=2, pad=1,
                       type_="cudnn_conv"),
    "transposed-stride2": dict(C=3, F=3, img=4, fs=3, stride=2, pad=1,
                               type_="exconvt"),
    "transposed-pad-beyond-filter": dict(C=2, F=2, img=5, fs=3, stride=1,
                                         pad=3, type_="exconvt", output=9),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_layers_match_jax(case):
    rng = np.random.default_rng(len(case))
    _check(*_conv_case(rng, **CONV_CASES[case]))


def test_conv_layer_sums_its_inputs_convs():
    """A conv layer of two inputs, each with its own geometry (the
    projection's conv), sums their conv outputs."""
    rng = np.random.default_rng(7)
    a = _conv_geom(2, 6, 3, 1, 1)
    b = _conv_geom(3, 9, 3, 2, 2)
    assert (a.output_x, a.output_y) == (b.output_x, b.output_y) == (6, 6)
    cfg = LayerConfig(
        name="c", type="exconv", size=4 * 36, active_type="", num_filters=4,
        conv=a, shared_biases=True, bias_parameter_name="b",
        inputs=[LayerInput("x", "w0", ProjectionConfig(type="conv", conv=a)),
                LayerInput("y", "w1", ProjectionConfig(type="conv", conv=b))])
    params = {"w0": _normal(rng, 4, 18, scale=0.3),
              "w1": _normal(rng, 4, 27, scale=0.3),
              "b": _normal(rng, 1, 4)}
    _check(cfg, {"x": _normal(rng, B, 72), "y": _normal(rng, B, 243)},
           params)


@pytest.mark.parametrize("stride,groups", [(2, 1), (2, 2), (1, 2)])
def test_transposed_conv_function_matches_jax(stride, groups):
    """conv2d_forward_image(transpose=True) against the JAX package's
    conv2d_forward_nhwc: the adjoint of the forward conv the kernel
    describes (F channels in, C/groups out) — with groups > 1 the JAX
    function takes no groups, and neither does the port."""
    rng = np.random.default_rng(stride * 10 + groups)
    C = F = 4
    conv = _conv_geom(C, 5, 3, stride, 1, groups, trans=True)
    w = _normal(rng, F, C // groups * 9, scale=0.3)
    x = _normal(rng, B, F, 5, 5)
    jconv = JConvConfig.from_dict(conv.to_dict())
    want = conv2d_forward_nhwc(jnp.asarray(x.transpose(0, 2, 3, 1)),
                               jnp.asarray(w), jconv, F, transpose=True)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    got = conv2d_forward_image(torch.from_numpy(x), torch.from_numpy(w),
                               conv, F, transpose=True)
    assert want.shape == (B, C // groups, conv.output_y, conv.output_x)
    _close(got.numpy(), want, FWD_TOL, "transposed conv")


def test_mixed_layer_conv_projection_matches_jax():
    rng = np.random.default_rng(11)
    conv = _conv_geom(2, 6, 3, 2, 1)
    size = 3 * conv.output_x * conv.output_y
    cfg = LayerConfig(
        name="m", type="mixed", size=size, active_type="tanh",
        bias_parameter_name="b",
        inputs=[LayerInput("x", "w", ProjectionConfig(
            type="conv", input_size=72, output_size=size, conv=conv,
            num_filters=3))])
    _check(cfg, {"x": _normal(rng, B, 72)},
           {"w": _normal(rng, 3, 18, scale=0.3), "b": _normal(rng, 1, size)})


def test_mixed_layer_conv_operator_matches_jax():
    """The conv operator: each sample convolved with its own filter, taken
    from a layer output; both operands get gradients."""
    rng = np.random.default_rng(12)
    conv = _conv_geom(2, 5, 3, 1, 1)
    size = 3 * conv.output_x * conv.output_y
    cfg = LayerConfig(
        name="m", type="mixed", size=size, active_type="",
        inputs=[LayerInput("img"), LayerInput("filt")],
        operators=[OperatorConfig(type="conv", input_indices=[0, 1],
                                  output_size=size, conv=conv,
                                  num_filters=3)])
    _check(cfg, {"img": _normal(rng, B, 50),
                 "filt": _normal(rng, B, 3 * 2 * 9, scale=0.3)}, {})


def test_mixed_layer_dot_mul_operator_matches_jax():
    """The operators run beside the projections: scale * a * b added to a
    full-matrix projection of a."""
    rng = np.random.default_rng(17)
    cfg = LayerConfig(
        name="m", type="mixed", size=6, active_type="tanh",
        inputs=[LayerInput("a", "w", ProjectionConfig(
            type="fc", input_size=6, output_size=6)), LayerInput("b")],
        operators=[OperatorConfig(type="dot_mul", input_indices=[0, 1],
                                  output_size=6, dotmul_scale=0.5)])
    _check(cfg, {"a": _normal(rng, B, 6), "b": _normal(rng, B, 6)},
           {"w": _normal(rng, 6, 6, scale=0.4)})


# -- pooling ----------------------------------------------------------------

def _pool_case(rng, ptype, img, size, stride, pad=0, C=3, type_="pool",
               img_y=0, size_y=0, stride_y=0):
    iy = img_y or img
    ox = conv_output_size(img, size, stride, pad, caffe_mode=False)
    oy = conv_output_size(iy, size_y or size, stride_y or stride, pad,
                          caffe_mode=False)
    pool = PoolConfig(pool_type=f"{ptype}-projection", channels=C,
                      size_x=size, size_y=size_y, stride=stride,
                      stride_y=stride_y, padding=pad, img_size=img,
                      img_size_y=img_y, output_x=ox, output_y=oy)
    cfg = LayerConfig(name="p", type=type_, size=C * ox * oy, pool=pool,
                      inputs=[LayerInput("x")])
    return cfg, {"x": _normal(rng, B, C * iy * img)}, {}


POOL_CASES = {
    "tiles-2x2": dict(img=8, size=2, stride=2),
    "tiles-4x4": dict(img=8, size=4, stride=4),
    "overlapping-padded": dict(img=6, size=3, stride=2, pad=1),
    "clipped-window-7-to-4": dict(img=7, size=2, stride=2),
    "window-larger-than-image": dict(img=2, size=8, stride=8),
    "non-square": dict(img=9, img_y=6, size=3, size_y=2, stride=3,
                       stride_y=2),
    "cudnn_pool": dict(img=5, size=3, stride=2, type_="cudnn_pool"),
}


@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_layers_match_jax(case, ptype):
    """Ceil-mode pools: tiling windows and a window over the whole image
    (small_vgg's 8x8 pool over a 2x2 map) take the reshape paths, the
    rest explicit padding — -inf for max, a divisor clipped to the image
    for average (MNIST's 7 -> 4 step)."""
    rng = np.random.default_rng(len(case))
    _check(*_pool_case(rng, ptype, **POOL_CASES[case]))


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_flat_row_pool_function_matches_jax(ptype):
    """pool2d_forward, the flat-row wrapper: [B, C*H*W] rows in and out,
    against the JAX package's at a clipped ceil-mode window."""
    from paddle_tpu.config.schema import PoolConfig as JPoolConfig
    from paddle_tpu.graph.layers_conv import pool2d_forward as jpool
    from paddle_tpu_torch.graph.layers_conv import pool2d_forward
    rng = np.random.default_rng(18)
    cfg, feeds, _ = _pool_case(rng, ptype, img=7, size=3, stride=2, C=2)
    want = jpool(jnp.asarray(feeds["x"]),
                 JPoolConfig.from_dict(cfg.pool.to_dict()))
    got = pool2d_forward(torch.from_numpy(feeds["x"]), cfg.pool)
    _close(got.numpy(), want, FWD_TOL, "pool2d_forward")


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_spp_layer_matches_jax(ptype):
    rng = np.random.default_rng(3)
    C, img, levels = 2, 6, 3
    pool = PoolConfig(pool_type=f"{ptype}-projection", channels=C,
                      img_size=img, img_size_y=img)
    cfg = LayerConfig(name="s", type="spp", size=C * (1 + 4 + 16), pool=pool,
                      inputs=[LayerInput("x")],
                      attrs={"pyramid_height": levels})
    _check(cfg, {"x": _normal(rng, B, C * img * img)}, {})


@pytest.mark.parametrize("image", [False, True], ids=["rows", "image"])
def test_maxout_layer_matches_jax(image):
    """Max over groups of consecutive channels, on rows and on an image
    (which stays an image)."""
    rng = np.random.default_rng(4)
    C, H, W, groups = 6, 2, 3, 3
    x = _normal(rng, B, C, H, W)
    cfg = LayerConfig(name="mo", type="maxout", size=C // groups * H * W,
                      inputs=[LayerInput("x")],
                      attrs={"groups": groups, "channels": C})
    _check(cfg, {"x": Img(x) if image else x.reshape(B, -1)}, {})


def test_image_input_of_another_geometry_goes_through_the_rows():
    """get_image_input's re-geometry case: a [4, 3, 6] image read by a
    layer that splits the same 72 values as [2, 6, 6] takes them in the
    flat C-major order, as the JAX package does."""
    rng = np.random.default_rng(5)
    cfg, _, _ = _pool_case(rng, "max", img=6, size=2, stride=2, C=2)
    _check(cfg, {"x": Img(_normal(rng, B, 4, 3, 6))}, {})


def test_image_input_of_the_same_geometry_stays_an_image():
    rng = np.random.default_rng(6)
    cfg, _, params = _conv_case(rng, C=3, F=2, img=4, fs=3, stride=1, pad=1)
    _check(cfg, {"x": Img(_normal(rng, B, 3, 4, 4))}, params)


# -- normalization ----------------------------------------------------------

def test_cmrnorm_layer_matches_jax():
    rng = np.random.default_rng(8)
    C, img = 7, 4
    norm = NormConfig(channels=C, size=5, scale=0.0128 / 5, pow=0.75,
                      img_size=img, img_size_y=img, output_x=img,
                      output_y=img)
    cfg = LayerConfig(name="n", type="norm", size=C * img * img, norm=norm,
                      inputs=[LayerInput("x")])
    _check(cfg, {"x": _normal(rng, B, C * img * img, scale=3.0)}, {})


def _bn_case(rng, image, type_="batch_norm", use_global_stats=None):
    C, img = (3, 4) if image else (5, 0)
    conv = ConvConfig(channels=C, img_size=img, img_size_y=img) if image \
        else None
    cfg = LayerConfig(name="bn", type=type_, size=C * max(img, 1) ** 2,
                      active_type="relu", conv=conv,
                      use_global_stats=use_global_stats,
                      moving_average_fraction=0.8, bias_parameter_name="b",
                      inputs=[LayerInput("x", "w")])
    params = {"w": 1.0 + _normal(rng, 1, C, scale=0.2),
              "b": _normal(rng, 1, C, scale=0.2)}
    feeds = {"x": 2.0 + _normal(rng, 4, C * max(img, 1) ** 2, scale=1.5)}
    state = {"bn": {"mean": _normal(rng, C), "var": 0.5 + rng.random(C)
                    .astype(np.float32), "count": np.float32(3.0)}}
    return cfg, feeds, params, state


@pytest.mark.parametrize("given_state", [False, True],
                         ids=["fresh-state", "given-state"])
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("kind", ["image", "rows", "cudnn_batch_norm"])
def test_batch_norm_matches_jax(kind, mode, given_state):
    """Image batch norm (per channel over N, H, W) and row batch norm (per
    feature): TRAIN normalizes by the batch and moves the state (fraction
    0.8 here; the biased batch variance), TEST normalizes by the moving
    statistics (mean 0, variance 1 when none are given) and hands them
    on."""
    rng = np.random.default_rng(9)
    cfg, feeds, params, state = _bn_case(
        rng, kind != "rows",
        "cudnn_batch_norm" if kind == "cudnn_batch_norm" else "batch_norm")
    out = _check(cfg, feeds, params, mode, state if given_state else None)
    count = float(out["bn"]["count"])
    assert count == (3.0 if given_state else 0.0) + (mode == "train")


def test_batch_norm_explicit_stats_modes():
    """use_global_stats=False normalizes by the batch in TEST too; a frozen
    batch norm (True) given no state registers none, and given state
    hands it on unchanged."""
    rng = np.random.default_rng(10)
    cfg, feeds, params, state = _bn_case(rng, True, use_global_stats=False)
    out = _check(cfg, feeds, params, "test")
    assert float(out["bn"]["count"]) == 1.0
    cfg, feeds, params, state = _bn_case(rng, True, use_global_stats=True)
    assert _check(cfg, feeds, params, "train") == {}
    out = _check(cfg, feeds, params, "train", state)
    assert float(out["bn"]["count"]) == 3.0


@pytest.mark.parametrize("strategy", ["z-score", "min-max",
                                      "decimal-scaling"])
def test_data_norm_layer_matches_jax(strategy):
    rng = np.random.default_rng(13)
    D = 5
    x = _normal(rng, 40, D, scale=3.0) + 1.0
    stats = np.stack([x.min(0), x.max(0), x.sum(0), (x * x).sum(0),
                      np.full(D, 40.0, np.float32)]).astype(np.float32)
    cfg = LayerConfig(name="d", type="data_norm", size=D,
                      inputs=[LayerInput("x", "w")],
                      attrs={"data_norm_strategy": strategy})
    _check(cfg, {"x": x[:B].copy()}, {"w": stats})


def test_sum_to_one_norm_layer_matches_jax():
    rng = np.random.default_rng(14)
    cfg = LayerConfig(name="s", type="sum_to_one_norm", size=6,
                      inputs=[LayerInput("x")])
    _check(cfg, {"x": 0.5 + rng.random((B, 6)).astype(np.float32)}, {})


# -- resampling and patches -------------------------------------------------

@pytest.mark.parametrize("shape", [((4, 5), (7, 9)), ((8, 8), (3, 5)),
                                   ((6, 4), (3, 7))],
                         ids=["upsample", "downsample", "mixed"])
def test_bilinear_interp_layer_matches_jax(shape):
    """Both directions: jax.image.resize antialiases when it shrinks, as
    the port's F.interpolate(antialias=True) does."""
    rng = np.random.default_rng(15)
    (ih, iw), (oh, ow) = shape
    C = 2
    cfg = LayerConfig(name="bi", type="bilinear_interp", size=C * oh * ow,
                      inputs=[LayerInput("x")],
                      attrs={"channels": C, "img_size_y": ih,
                             "img_size_x": iw, "out_size_y": oh,
                             "out_size_x": ow})
    _check(cfg, {"x": _normal(rng, B, C * ih * iw)}, {})


def test_block_expand_layer_matches_jax():
    """im2col into a sequence: one step per block position, each C-major
    block; every row's length is the number of positions."""
    rng = np.random.default_rng(16)
    C, ih, iw = 2, 5, 6
    attrs = {"channels": C, "img_size_y": ih, "img_size_x": iw,
             "block_y": 3, "block_x": 2, "stride_y": 2, "stride_x": 1,
             "padding_y": 1, "padding_x": 0}
    cfg = LayerConfig(name="be", type="blockexpand", size=C * 6,
                      inputs=[LayerInput("x")], attrs=attrs)
    _check(cfg, {"x": _normal(rng, B, C * ih * iw)}, {})
    ctx = ForwardContext(model=None, params={})
    ctx.outputs["x"] = Argument(value=torch.zeros(B, C * ih * iw))
    out = get_layer_fn("blockexpand")(ctx, cfg)
    assert out.value.shape == (B, 15, 12)
    assert out.lengths.tolist() == [15] * B
