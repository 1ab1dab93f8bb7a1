"""Mixed-precision dtype policy helpers (compute_dtype='bfloat16') — the
port's own copy of paddle_tpu/utils/dtypes.py (promote_compute,
LOW_PRECISION)."""

from __future__ import annotations

import torch

LOW_PRECISION = (torch.bfloat16, torch.float16)


def promote_compute(x: torch.Tensor) -> torch.Tensor:
    """Promote low-precision compute dtypes to float32 for numerically
    sensitive ops (softmax/log/statistics/loss accumulation); float32 and
    float64 pass through unchanged."""
    if x.dtype in LOW_PRECISION:
        return x.float()
    return x
