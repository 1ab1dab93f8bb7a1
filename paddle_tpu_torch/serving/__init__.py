from paddle_tpu_torch.serving.engine import (  # noqa: F401
    PhiloxNoise,
    Request,
    ServingEngine,
)
from paddle_tpu_torch.serving.paged_kv import PagedKVCache  # noqa: F401
