"""Argument — the inter-layer data record.

The port's counterpart of paddle_tpu/parameter/argument.py: sequences are
padded dense [B, T, ...] tensors plus a [B] `lengths` vector.  The serving
slice carries dense values, integer ids and lengths only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass
class Argument:
    # dense value: [B, D] for plain data, [B, T, D] for sequences
    value: Optional[torch.Tensor] = None
    # integer ids: [B] or [B, T]
    ids: Optional[torch.Tensor] = None
    # [B] valid lengths; None => not a sequence
    lengths: Optional[torch.Tensor] = None

    @property
    def is_sequence(self) -> bool:
        return self.lengths is not None

    @property
    def data(self) -> torch.Tensor:
        """The primary payload: value if present else ids."""
        if self.value is not None:
            return self.value
        if self.ids is None:
            raise ValueError("empty Argument")
        return self.ids

    @property
    def max_len(self) -> int:
        if not self.is_sequence:
            raise ValueError("max_len of a non-sequence Argument")
        return self.data.shape[1]

    def mask(self, dtype=torch.bool) -> Optional[torch.Tensor]:
        """[B, T] validity mask for sequence arguments."""
        if self.lengths is None:
            return None
        t = torch.arange(self.max_len, device=self.lengths.device)
        return (t[None, :] < self.lengths[:, None]).to(dtype)

    def replace(self, **kw: Any) -> "Argument":
        return dataclasses.replace(self, **kw)
