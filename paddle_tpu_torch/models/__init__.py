from paddle_tpu_torch.models.transformer_lm import (  # noqa: F401
    transformer_lm_config,
    transformer_lm_trainer_config,
)
