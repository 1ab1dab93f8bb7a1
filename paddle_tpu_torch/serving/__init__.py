from paddle_tpu_torch.serving.drafter import (  # noqa: F401
    ModelDrafter,
    NgramDrafter,
    clamp_proposal,
)
from paddle_tpu_torch.serving.engine import (  # noqa: F401
    Request,
    ServingEngine,
)
from paddle_tpu_torch.serving.paged_kv import PagedKVCache  # noqa: F401
from paddle_tpu_torch.serving.prefix_tree import PrefixTree  # noqa: F401
