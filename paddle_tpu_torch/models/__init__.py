from paddle_tpu_torch.models.transformer_lm import (  # noqa: F401
    transformer_lm_config,
    transformer_lm_trainer_config,
)
from paddle_tpu_torch.models.sentiment import (  # noqa: F401
    bidirectional_lstm_net_config,
    stacked_lstm_net_config,
)
from paddle_tpu_torch.models.seq2seq import (  # noqa: F401
    seq2seq_trainer_config,
)
from paddle_tpu_torch.models.image import (  # noqa: F401
    resnet_config,
    vgg_16_cifar_config,
    vgg_16_mnist_config,
)
