"""Layer registry: LayerConfig.type string -> implementation function.

A layer implementation is a function (ctx, cfg) -> Argument on tensors,
as in paddle_tpu/graph/registry.py.  The port implements the layers the
transformer LM, the sentiment LSTM nets, the attention seq2seq, the image
classifiers (small_vgg on CIFAR-10 and MNIST, ResNet), the SRL and
sequence-tagging nets (the vanilla RNN, the CRF and its decoder) and the
recommendation, introduction and quick_start configs run: layers_core,
layers_misc, layers_seq, layers_attn, layers_cost and layers_conv (every
image layer type and every cost type of the JAX package).  All the JAX
package's cost and validation types are known by name so that the serving
engine can tell the model's output layer from its training head.
"""

from __future__ import annotations

from typing import Callable

LayerFn = Callable[..., "Argument"]  # noqa: F821

layer_registry: dict[str, LayerFn] = {}

# the JAX package's cost and validation layer types; the port implements
# the costs of layers_cost.py and crf (layers_seq.py); ctc, nce, hsigmoid
# and the validation layers are queued in ROADMAP.md
cost_layer_types = frozenset({
    "multi-class-cross-entropy", "multi_class_cross_entropy_with_selfnorm",
    "soft_binary_class_cross_entropy", "multi_binary_label_cross_entropy",
    "square_error", "rank-cost", "huber_classification", "huber",
    "sum_cost", "lambda_cost", "crf", "ctc", "nce", "hsigmoid"})
validation_layer_types = frozenset({"auc-validation", "pnpair-validation"})


def register_layer(*type_names: str):
    def deco(fn: LayerFn) -> LayerFn:
        for name in type_names:
            if name in layer_registry:
                raise ValueError(f"duplicate layer type {name!r}")
            layer_registry[name] = fn
        return fn
    return deco


def get_layer_fn(type_name: str) -> LayerFn:
    try:
        return layer_registry[type_name]
    except KeyError:
        raise NotImplementedError(
            f"layer type {type_name!r} is not ported yet (ROADMAP.md, "
            f"PyTorch/CUDA port queue); ported: "
            f"{sorted(layer_registry)}") from None
