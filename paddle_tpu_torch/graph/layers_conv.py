"""Convolution, pooling and normalization layers — the port's counterpart
of paddle_tpu/graph/layers_conv.py.

Images travel between image layers as [B, C, H, W] tensors (`Argument.image`;
channels_last memory on the card, the layout Hopper's cuDNN kernels take)
and become the reference's flat C-major [B, C*H*W] rows only at the row
boundary (ForwardContext.get_input flattens lazily, get_image_input unpacks
once).  The JAX package keeps [B, H, W, C]; its `*_nhwc` functions are the
`*_image` functions here.  Convolutions go to `F.conv2d` /
`F.conv_transpose2d` and pooling to `F.max_pool2d` / `F.avg_pool2d`, or to
reshape-reductions where the JAX package has a fast path; batch norm to
`F.batch_norm`.  They run on cuDNN and ATen: the JAX package leaves this
work to XLA and reaches no Pallas kernel here.

Geometry is the JAX package's: padding is explicit, (lo, hi) per spatial
axis, the high side taking the remainder of the configured output size
(possibly negative, which crops; `_pad_amounts`), and pooling windows are
ceil-mode (`caffe_mode=False`).  Max pooling pads with -inf; average
pooling divides by the part of the window inside the image.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.config.schema import (ConvConfig, LayerConfig,
                                            OperatorConfig, PoolConfig,
                                            ProjectionConfig)
from paddle_tpu_torch.graph.common import finish_layer
from paddle_tpu_torch.graph.context import ForwardContext
from paddle_tpu_torch.graph.registry import register_layer
from paddle_tpu_torch.parameter.argument import Argument, image_layout
from paddle_tpu_torch.utils.dtypes import promote_compute
from paddle_tpu_torch.utils.geometry import conv_output_size

BN_EPS = 1e-5


def _geom(c: ConvConfig):
    fy = c.filter_size_y or c.filter_size
    sy = c.stride_y or c.stride
    py = c.padding_y if c.padding_y else c.padding
    iy = c.img_size_y or c.img_size
    return c.filter_size, fy, c.stride, sy, c.padding, py, c.img_size, iy


def _pad_amounts(img: int, filt: int, stride: int, pad: int,
                 out: int) -> tuple[int, int]:
    """Explicit (lo, hi) padding that gives the configured output size:
    `pad` before, the remainder after (negative crops)."""
    total = (out - 1) * stride + filt - img
    return pad, total - pad


def _pad_image(x: torch.Tensor, pad_y: tuple[int, int],
               pad_x: tuple[int, int], value: float = 0.0) -> torch.Tensor:
    """Pad (or, where negative, crop) the spatial axes of [B, C, H, W]."""
    if pad_y == (0, 0) and pad_x == (0, 0):
        return x
    return F.pad(x, (pad_x[0], pad_x[1], pad_y[0], pad_y[1]), value=value)


def _conv_pads(conv: ConvConfig):
    """(lo, hi) padding of the y and x axes for the configured output."""
    fx, fy, sx, sy, px, py, ix, iy = _geom(conv)
    oy = conv.output_y or conv_output_size(iy, fy, sy, py, conv.caffe_mode)
    ox = conv.output_x or conv_output_size(ix, fx, sx, px, conv.caffe_mode)
    return _pad_amounts(iy, fy, sy, py, oy), _pad_amounts(ix, fx, sx, px, ox)


def _conv2d(x: torch.Tensor, w4: torch.Tensor, stride: tuple[int, int],
            pad_y: tuple[int, int], pad_x: tuple[int, int],
            groups: int = 1) -> torch.Tensor:
    """F.conv2d with (lo, hi) padding: cuDNN's own symmetric padding where
    lo == hi >= 0, an explicit pad or crop otherwise."""
    if pad_y[0] == pad_y[1] >= 0 and pad_x[0] == pad_x[1] >= 0:
        return F.conv2d(x, w4, stride=stride, padding=(pad_y[0], pad_x[0]),
                        groups=groups)
    return F.conv2d(_pad_image(x, pad_y, pad_x), w4, stride=stride,
                    groups=groups)


def conv2d_forward_image(x: torch.Tensor, w: torch.Tensor, conv: ConvConfig,
                         num_filters: int,
                         transpose: bool = False) -> torch.Tensor:
    """x [B, C, H, W] -> [B, num_filters, OH, OW].

    w is the reference's [num_filters, C/groups * fh * fw] parameter, which
    viewed as (F, C/g, fh, fw) is torch's OIHW weight as it stands.  The
    transposed form is the JAX package's `lax.conv_transpose(...,
    transpose_kernel=True)` of that kernel: the adjoint of the forward conv
    it describes (F channels in, C/g out, no groups), its (p, p) padding
    applied to the stride-dilated input, then cropped to output_y,
    output_x."""
    fx, fy, sx, sy, px, py, ix, iy = _geom(conv)
    g = conv.groups
    w4 = w.reshape(num_filters, conv.channels // g, fy, fx)
    if not transpose:
        pad_y, pad_x = _conv_pads(conv)
        return _conv2d(x, w4, (sy, sx), pad_y, pad_x, g)
    # torch's padding P trims the full (k - 1)-padded adjoint by P a side:
    # JAX's p a side is P = k - 1 - p; a p beyond k - 1 adds zero borders
    cy, cx = fy - 1 - py, fx - 1 - px
    y = F.conv_transpose2d(x, w4, stride=(sy, sx),
                           padding=(max(cy, 0), max(cx, 0)))
    y = _pad_image(y, (max(-cy, 0),) * 2, (max(-cx, 0),) * 2)
    return y[:, :, :conv.output_y, :conv.output_x]


def conv2d_forward(x_flat: torch.Tensor, w: torch.Tensor, conv: ConvConfig,
                   num_filters: int, transpose: bool = False) -> torch.Tensor:
    """Flat-row wrapper: [B, C*H*W] -> [B, num_filters*OH*OW] (the conv
    projection of a mixed layer, which lives in row space)."""
    _, _, _, _, _, _, ix, iy = _geom(conv)
    B = x_flat.shape[0]
    x = image_layout(x_flat.reshape(B, conv.channels, iy, ix))
    y = conv2d_forward_image(x, w, conv, num_filters, transpose=transpose)
    return y.reshape(B, -1)


def _add_conv_bias_image(acc: torch.Tensor, b: Optional[torch.Tensor],
                         cfg: LayerConfig) -> torch.Tensor:
    """Per-channel (shared) or per-position bias on [B, F, OH, OW]; the DSL
    stores it as a [1, k] row, per-position biases flat C-major."""
    if b is None:
        return acc
    if cfg.shared_biases:
        return acc + b.reshape(1, -1, 1, 1)
    return acc + b.reshape((1,) + tuple(acc.shape[1:]))


def _conv_like_layer(ctx: ForwardContext, cfg: LayerConfig,
                     transpose: bool) -> Argument:
    acc = None
    for i, inp in enumerate(cfg.inputs):
        conv = inp.proj.conv if (inp.proj and inp.proj.conv) else cfg.conv
        iy = conv.img_size_y or conv.img_size
        arg = ctx.get_image_input(cfg, i, conv.channels, iy, conv.img_size)
        y = conv2d_forward_image(arg.value, ctx.param_of(cfg, i), conv,
                                 cfg.num_filters, transpose=transpose)
        acc = y if acc is None else acc + y
    acc = _add_conv_bias_image(acc, ctx.bias_of(cfg), cfg)
    return finish_layer(ctx, cfg, acc, image=True)


@register_layer("exconv", "cudnn_conv")
def conv_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Convolution; several inputs sum their conv outputs."""
    return _conv_like_layer(ctx, cfg, transpose=False)


@register_layer("exconvt")
def conv_trans_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Transposed convolution."""
    return _conv_like_layer(ctx, cfg, transpose=True)


def conv_projection_forward(proj: ProjectionConfig, arg: Argument,
                            w: torch.Tensor) -> torch.Tensor:
    """Conv as a projection inside a mixed layer (flat rows in and out)."""
    return conv2d_forward(arg.value, w, proj.conv, proj.num_filters)


def conv_operator_forward(op: OperatorConfig, img: Argument,
                          filt: Argument) -> torch.Tensor:
    """Conv with the filter supplied by a layer output, one filter per
    sample: one grouped conv with the batch as its groups."""
    conv = op.conv
    fx, fy, sx, sy, px, py, ix, iy = _geom(conv)
    B, C, Fn = img.value.shape[0], conv.channels, op.num_filters
    x = img.value.reshape(1, B * C, iy, ix)
    w = filt.value.reshape(B * Fn, C, fy, fx)
    pad_y, pad_x = _conv_pads(conv)
    y = _conv2d(x, w, (sy, sx), pad_y, pad_x, groups=B)
    return y.reshape(B, -1)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool_geom(p: PoolConfig):
    ky = p.size_y or p.size_x
    sy = p.stride_y or p.stride
    py = p.padding_y if p.padding_y else p.padding
    iy = p.img_size_y or p.img_size
    return p.size_x, ky, p.stride, sy, p.padding, py, p.img_size, iy


def _pool_plan(pool: PoolConfig):
    kx, ky, sx, sy, px, py, ix, iy = _pool_geom(pool)
    oy = pool.output_y or conv_output_size(iy, ky, sy, py, caffe_mode=False)
    ox = pool.output_x or conv_output_size(ix, kx, sx, px, caffe_mode=False)
    return ((ky, kx), (sy, sx), (oy, ox), _pad_amounts(iy, ky, sy, py, oy),
            _pad_amounts(ix, kx, sx, px, ox))


def pool2d_window(x: torch.Tensor, pool: PoolConfig) -> torch.Tensor:
    """Generic [B, C, H, W] pooling over explicitly padded windows — the
    semantics the fast paths of pool2d_forward_image match (the JAX
    package's pool2d_reduce_window)."""
    k, s, _, pad_y, pad_x = _pool_plan(pool)
    if pool.pool_type.startswith("max"):
        return F.max_pool2d(_pad_image(x, pad_y, pad_x, float("-inf")), k, s)
    # average over the part of the window inside the image
    total = F.avg_pool2d(_pad_image(x, pad_y, pad_x), k, s,
                         divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    cnt = F.avg_pool2d(_pad_image(ones, pad_y, pad_x), k, s,
                       divisor_override=1)
    return total / torch.clamp(cnt, min=1.0)


def pool2d_forward_image(x: torch.Tensor, pool: PoolConfig) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, OH, OW] max or average pooling.  Windows
    that tile the image (VGG's 2x2 / stride 2) and a window over the whole
    image reduce a reshaped view, as the JAX package's fast paths do (their
    max shares the cotangent among tied maxima as jnp.max does); the rest
    go through pool2d_window."""
    (ky, kx), (sy, sx), (oy, ox), pad_y, pad_x = _pool_plan(pool)
    is_max = pool.pool_type.startswith("max")
    B, C, iy, ix = x.shape
    if (sy == ky and sx == kx and pad_y == (0, 0) and pad_x == (0, 0)
            and oy * ky == iy and ox * kx == ix):
        r = x.reshape(B, C, oy, ky, ox, kx)
        out = r.amax(dim=(3, 5)) if is_max else r.mean(dim=(3, 5))
        return image_layout(out)
    if oy == 1 and ox == 1 and ky >= iy and kx >= ix and pad_y[0] == 0 \
            and pad_x[0] == 0:
        # the window covers the image: global pooling (the average's
        # divisor is the clipped window, the image)
        if is_max:
            return image_layout(x.amax(dim=(2, 3), keepdim=True))
        return image_layout(x.mean(dim=(2, 3), keepdim=True))
    return pool2d_window(x, pool)


def pool2d_forward(x_flat: torch.Tensor, pool: PoolConfig) -> torch.Tensor:
    """Flat-row wrapper: [B, C*H*W] -> [B, C*OH*OW]."""
    _, _, _, _, _, _, ix, iy = _pool_geom(pool)
    B = x_flat.shape[0]
    x = image_layout(x_flat.reshape(B, pool.channels, iy, ix))
    return pool2d_forward_image(x, pool).reshape(B, -1)


@register_layer("pool", "cudnn_pool")
def pool_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    p = cfg.pool
    x = ctx.get_image_input(cfg, 0, p.channels, p.img_size_y or p.img_size,
                            p.img_size)
    return finish_layer(ctx, cfg, pool2d_forward_image(x.value, p),
                        image=True)


@register_layer("spp")
def spp_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Spatial pyramid pooling: pool into 2^l x 2^l bins at levels
    l = 0 .. pyramid_height - 1, the levels' flat rows concatenated."""
    p = cfg.pool
    ix, iy = p.img_size, (p.img_size_y or p.img_size)
    x = ctx.get_image_input(cfg, 0, p.channels, iy, ix)
    B = x.value.shape[0]
    parts = []
    for lvl in range(cfg.attrs.get("pyramid_height", 1)):
        n = 2 ** lvl
        kx, ky = -(-ix // n), -(-iy // n)
        sub = dataclasses.replace(
            p, size_x=kx, size_y=ky, stride=kx, stride_y=ky, padding=0,
            padding_y=0, output_x=n, output_y=n)
        parts.append(pool2d_forward_image(x.value, sub).reshape(B, -1))
    return finish_layer(ctx, cfg, torch.cat(parts, dim=-1))


@register_layer("maxout")
def maxout_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Max over groups of consecutive channels: output channel o is the
    max over input channels o*g .. o*g + g - 1."""
    x = ctx.get_raw_input(cfg, 0)
    groups = cfg.attrs["groups"]
    C = cfg.conv.channels if cfg.conv else cfg.attrs["channels"]
    if x.image:
        B, _, H, W = x.value.shape
        out = x.value.reshape(B, C // groups, groups, H, W).amax(dim=2)
        return finish_layer(ctx, cfg, image_layout(out), image=True)
    B, D = x.value.shape
    out = x.value.reshape(B, C // groups, groups, D // C).amax(dim=2)
    return finish_layer(ctx, cfg, out.reshape(B, -1), like=x)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@register_layer("norm")
def norm_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Cross-channel local response normalization (cmrnorm):
    y = x * (1 + scale * sum over a window of channels of x^2)^(-pow)."""
    n = cfg.norm
    C = n.channels
    x = ctx.get_image_input(cfg, 0, C, n.img_size_y or n.img_size,
                            n.img_size)
    v = x.value
    half = n.size // 2
    padded = F.pad(v * v, (0, 0, 0, 0, half, n.size - 1 - half))
    wsum = sum(padded[:, i:i + C] for i in range(n.size))
    y = v * torch.pow(1.0 + n.scale * wsum, -n.pow)
    return finish_layer(ctx, cfg, y, image=True)


@register_layer("batch_norm", "cudnn_batch_norm")
def batch_norm_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Batch normalization; the moving mean and variance are layer state
    (ctx.state_in / state_out by layer name), not parameters.

    Image inputs normalize per channel over (N, H, W), rows per feature.
    In TRAIN (unless use_global_stats) the batch's statistics normalize and
    the state moves to f * state + (1 - f) * batch statistic, f =
    moving_average_fraction, of the biased batch variance (F.batch_norm's
    own running update, unbiased and with momentum 1 - f, is not used);
    otherwise the moving statistics normalize.  The state starts at mean 0,
    variance 1, count 0, in the statistics' dtype.  Statistics and
    normalization are in at least float32, the output in the input's
    dtype.  An explicitly frozen batch
    norm (use_global_stats True) given no state registers none."""
    img = cfg.conv is not None and cfg.conv.img_size > 0
    if img:
        c = cfg.conv
        x = ctx.get_image_input(cfg, 0, c.channels, c.img_size_y or c.img_size,
                                c.img_size)
        dims: tuple[int, ...] = (0, 2, 3)
    else:
        x = ctx.get_input(cfg, 0)
        dims = (0,)
    v = x.value
    v32 = promote_compute(v)
    C = v.shape[1]
    scale = ctx.param_of(cfg, 0).reshape(-1).to(v32.dtype)
    bias = ctx.bias_of(cfg)
    if bias is not None:
        bias = bias.reshape(-1).to(v32.dtype)

    given = ctx.state_in.get(cfg.name)
    state = given
    if state is None:
        kw = dict(dtype=v32.dtype, device=v.device)
        state = {"mean": torch.zeros(C, **kw), "var": torch.ones(C, **kw),
                 "count": torch.zeros((), **kw)}
    use_global = cfg.use_global_stats
    if use_global is None:
        use_global = not ctx.is_training

    if use_global:
        out = F.batch_norm(v32, state["mean"].to(v32.dtype),
                           state["var"].to(v32.dtype), scale, bias,
                           training=False, eps=BN_EPS)
        if not (cfg.use_global_stats is True and given is None):
            ctx.state_out[cfg.name] = state
    else:
        out = F.batch_norm(v32, None, None, scale, bias, training=True,
                           eps=BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(v32.detach(), dim=dims, correction=0)
            f = cfg.moving_average_fraction
            ctx.state_out[cfg.name] = {
                "mean": f * state["mean"] + (1 - f) * mean,
                "var": f * state["var"] + (1 - f) * var,
                "count": state["count"] + 1}
    return finish_layer(ctx, cfg, out.to(v.dtype), like=x, image=img)


@register_layer("data_norm")
def data_norm_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Input normalization from precomputed statistics: the [5, D]
    parameter's rows are min, max, sum, sum of squares and count; strategy
    z-score (default), min-max or decimal-scaling."""
    x = ctx.get_input(cfg, 0)
    w = ctx.param_of(cfg, 0)
    strategy = cfg.attrs.get("data_norm_strategy", "z-score")
    dmin, dmax, dsum, dsq, dcnt = (w[i] for i in range(5))
    cnt = torch.clamp(dcnt, min=1.0)
    mean = dsum / cnt
    std = torch.sqrt(torch.clamp(dsq / cnt - mean * mean, min=1e-8))
    if strategy == "min-max":
        out = (x.value - dmin) / torch.clamp(dmax - dmin, min=1e-8)
    elif strategy == "decimal-scaling":
        top = torch.clamp(torch.maximum(dmax.abs(), dmin.abs()), min=1e-8)
        out = x.value / torch.pow(10.0, torch.ceil(torch.log10(top)))
    else:
        out = (x.value - mean) / std
    return finish_layer(ctx, cfg, out, like=x)


@register_layer("sum_to_one_norm")
def sum_to_one_norm_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Each row divided by its sum (rows summing to ~0 are left as they
    are)."""
    x = ctx.get_input(cfg, 0)
    s = x.value.sum(dim=-1, keepdim=True)
    s = torch.where(s.abs() > 1e-12, s, torch.ones_like(s))
    return finish_layer(ctx, cfg, x.value / s, like=x)


# ---------------------------------------------------------------------------
# resampling and patches
# ---------------------------------------------------------------------------

@register_layer("bilinear_interp")
def bilinear_interp_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """Bilinear resize to (out_size_y, out_size_x), half-pixel centres, with
    the JAX package's antialiasing (jax.image.resize's triangle kernel
    widened by the scale) where it shrinks."""
    a = cfg.attrs
    x = ctx.get_image_input(cfg, 0, a["channels"], a["img_size_y"],
                            a["img_size_x"])
    out = F.interpolate(x.value, size=(a["out_size_y"], a["out_size_x"]),
                        mode="bilinear", align_corners=False, antialias=True)
    return finish_layer(ctx, cfg, image_layout(out), image=True)


@register_layer("blockexpand")
def block_expand_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """im2col into a sequence: one time step per block position, each the
    block's C*block_y*block_x values, C-major."""
    a = cfg.attrs
    x = ctx.get_image_input(cfg, 0, a["channels"], a["img_size_y"],
                            a["img_size_x"])
    patches = F.unfold(x.value, (a["block_y"], a["block_x"]),
                       padding=(a.get("padding_y", 0), a.get("padding_x", 0)),
                       stride=(a.get("stride_y", 1), a.get("stride_x", 1)))
    seq = patches.transpose(1, 2)                       # [B, T, D]
    B, T = seq.shape[:2]
    lengths = torch.full((B,), T, dtype=torch.int32, device=seq.device)
    return finish_layer(ctx, cfg, seq, lengths=lengths)
