from paddle_tpu_torch.graph.builder import GraphExecutor  # noqa: F401
from paddle_tpu_torch.graph.context import TEST  # noqa: F401
