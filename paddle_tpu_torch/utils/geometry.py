"""Convolution and pooling output sizes, shared by the config DSL's size
inference (dsl/layers.py) and the layers that compute them — the port's
copy of paddle_tpu/graph/layers_conv.py conv_output_size."""

from __future__ import annotations


def conv_output_size(img: int, filt: int, stride: int, pad: int,
                     caffe_mode: bool = True) -> int:
    """(ref: paddle/math/MathUtils.cpp outputSize)."""
    if caffe_mode:
        return (img + 2 * pad - filt) // stride + 1
    return (img - filt + 2 * pad + stride - 1) // stride + 1
