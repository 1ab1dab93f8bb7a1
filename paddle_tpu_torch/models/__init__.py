from paddle_tpu_torch.models.transformer_lm import transformer_lm_config  # noqa: F401
