from paddle_tpu_torch.data.provider import (  # noqa: F401
    CacheType,
    dense_vector,
    dense_vector_sequence,
    integer_value,
    integer_value_sequence,
    provider,
    sparse_binary_vector,
    sparse_binary_vector_sequence,
    sparse_vector,
)
from paddle_tpu_torch.data.feeder import DataFeeder  # noqa: F401
