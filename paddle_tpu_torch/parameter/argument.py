"""Argument — the inter-layer data record.

The port's counterpart of paddle_tpu/parameter/argument.py: sequences are
padded dense [B, T, ...] tensors plus a [B] `lengths` vector.  The data
feeder (data/feeder.py) also fills the nested-sequence and sparse-row
fields, as the JAX package's does.  Sparse rows ([B, K] or [B, T, K]
column ids in `ids`, their values in `sparse_vals`) feed the fc layer and
the full-matrix projections, which gather the touched weight rows;
`to_dense` materializes them.  Nested sequences are [B, S, T, ...] with
`lengths` [B] (the sub-sequences of each row) and `sub_lengths` [B, S]
(the tokens of each sub-sequence); layers pass sub_lengths on with their
output, and a recurrent group over a nested in-link loops over S.

Images travel between image layers as [B, C, H, W] tensors (`image`
True; in `torch.channels_last` memory on the card, cuDNN's preferred
layout, where the JAX package keeps [B, H, W, C]) and become the flat
C-major [B, C*H*W] rows of the reference only at the row boundary
(`flatten_image`, which ForwardContext.get_input calls).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch


def image_layout(v: torch.Tensor) -> torch.Tensor:
    """A [B, C, H, W] image in the executor's memory layout: channels_last
    on the card, as it stands elsewhere."""
    if v.is_cuda:
        return v.contiguous(memory_format=torch.channels_last)
    return v


@dataclass
class Argument:
    # dense value: [B, D] for plain data, [B, T, D] for sequences
    value: Optional[torch.Tensor] = None
    # integer ids: [B] or [B, T]
    ids: Optional[torch.Tensor] = None
    # [B] valid lengths; None => not a sequence
    lengths: Optional[torch.Tensor] = None
    # nested sequences: [B, S] per-subsequence lengths
    sub_lengths: Optional[torch.Tensor] = None
    # sparse rows: `ids` holds [..., K] column ids, `sparse_vals` their
    # [..., K] values (1/0 validity for binary slots), sparse_dim the width
    sparse_vals: Optional[torch.Tensor] = None
    sparse_dim: int = 0
    # True => value is a [B, C, H, W] image; False => flat rows
    image: bool = False

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

    def to_dense(self) -> "Argument":
        """Sparse rows as a dense [..., sparse_dim] value (the identity for
        other arguments): each row's values added at its column ids, a
        padding slot's value 0 at id 0 adding nothing.  Memory goes as
        sparse_dim; the training path never calls it."""
        if not self.sparse_dim:
            return self
        lead = tuple(self.ids.shape[:-1])
        K = self.ids.shape[-1]
        ids = self.ids.reshape(-1, K).long()
        vals = self.sparse_vals.reshape(-1, K)
        dense = torch.zeros(ids.shape[0], self.sparse_dim, dtype=vals.dtype,
                            device=vals.device)
        dense.scatter_add_(1, ids, vals)
        return Argument(value=dense.reshape(lead + (self.sparse_dim,)),
                        lengths=self.lengths, sub_lengths=self.sub_lengths)

    def flatten_image(self) -> "Argument":
        """An image as the reference's flat C-major [B, C*H*W] rows (the
        identity for other arguments); a channels_last value is copied into
        row order."""
        if not self.image:
            return self
        return self.replace(value=self.value.reshape(self.value.shape[0], -1),
                            image=False)
