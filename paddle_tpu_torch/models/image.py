"""The image classification configs: the port's parses of
demo/image_classification/vgg_16_cifar.py, demo/mnist/vgg_16_mnist.py and
demo/model_zoo/resnet.py.

VGG (small_vgg): four conv groups [64 x 2, 128 x 2, 256 x 3, 512 x 3] of
3x3 convs, each conv followed by batch norm (relu) and each group by a 2x2
/ stride 2 max pool, an 8x8 / stride 8 max pool over the last 2x2 map,
dropout 0.5, fc 512 + batch norm (relu, dropout 0.5), fc(10, softmax);
momentum 0.9, learning rate 0.1 / 128, L2 5e-4 * 128, batch 128.  CIFAR-10
takes 3 x 32 x 32 images (slot "image"), MNIST 1 x 28 x 28 (slot "pixel");
their providers fall back to synthetic data without a dataset on disk.

ResNet: a 7x7 / stride 2 conv + batch norm, a 3x3 / stride 2 max pool,
bottleneck blocks (1x1, 3x3, 1x1 convs each with batch norm; projection
shortcuts at each stage's entry, identity ones after; relu after the sum)
in four stages, an average pool over the last map, fc(num_classes,
softmax); `layer_num` 50, 101 or 152 at 224 x 224 and 1000 classes by
default, batch 64, momentum 0.9, the `discexp` learning-rate schedule.
"""

from __future__ import annotations

from paddle_tpu_torch.config.schema import TrainerConfig
from paddle_tpu_torch.models.demos import parse_demo

CIFAR = "image_classification/vgg_16_cifar.py"
MNIST = "mnist/vgg_16_mnist.py"
RESNET = "model_zoo/resnet.py"


def vgg_16_cifar_config(batch_size: int = 128, compute_dtype: str = "",
                        is_predict: bool = False) -> TrainerConfig:
    """demo/image_classification/vgg_16_cifar.py."""
    return parse_demo(CIFAR, batch_size=batch_size,
                      compute_dtype=compute_dtype, is_predict=is_predict)


def vgg_16_mnist_config(batch_size: int = 128,
                        compute_dtype: str = "") -> TrainerConfig:
    """demo/mnist/vgg_16_mnist.py."""
    return parse_demo(MNIST, batch_size=batch_size,
                      compute_dtype=compute_dtype)


def resnet_config(layer_num: int = 50, image_size: int = 224,
                  num_classes: int = 1000, batch_size: int = 64,
                  is_predict: bool = False) -> TrainerConfig:
    """demo/model_zoo/resnet.py."""
    return parse_demo(RESNET, layer_num=layer_num, image_size=image_size,
                      num_classes=num_classes, batch_size=batch_size,
                      is_predict=is_predict)
