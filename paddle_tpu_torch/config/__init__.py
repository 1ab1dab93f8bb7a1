from paddle_tpu_torch.config.schema import (  # noqa: F401
    LayerConfig,
    LayerInput,
    ModelConfig,
    OptimizationConfig,
    ParameterConfig,
    ProjectionConfig,
    TrainerConfig,
)
