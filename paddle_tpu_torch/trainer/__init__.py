"""The Trainer, its checkpoints and evaluators."""

from paddle_tpu_torch.trainer.trainer import Trainer  # noqa: F401
