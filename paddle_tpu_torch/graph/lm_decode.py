"""Autoregressive decoding helpers for sequence-in / logits-out models
(the transformer LM family) — the counterpart of
paddle_tpu/graph/lm_decode.py, so far the part the serving engine uses:
the input / logits layer names, whether the logits are probabilities, and
the greedy draft rollout of a batched speculative drafter
(serving/drafter.py `ModelDrafter`).  `lm_generate`, `lm_beam_generate`
and the dense per-request KV cache are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.graph.context import TEST
from paddle_tpu_torch.graph.registry import (cost_layer_types,
                                             validation_layer_types)
from paddle_tpu_torch.parameter.argument import Argument


def _resolve_io_names(model, input_name: Optional[str] = None,
                      logits_name: Optional[str] = None) -> tuple[str, str]:
    """Default input = the first data layer; default logits = the last
    layer that is not data, a cost or a validation layer."""
    if input_name is None:
        input_name = model.input_layer_names[0]
    if logits_name is None:
        skip = cost_layer_types | validation_layer_types | {"data"}
        logits_name = [l.name for l in model.layers
                       if l.type not in skip][-1]
    return input_name, logits_name


def _is_probs(model, logits_name: str) -> bool:
    """Whether the logits layer emits probabilities (softmax activation),
    sampled through log; raw-activation layers sample directly."""
    for l in model.layers:
        if l.name == logits_name:
            return l.active_type in ("softmax", "sequence_softmax")
    return False


def build_draft_roll(executor, *, input_name: Optional[str] = None,
                     logits_name: Optional[str] = None):
    """The greedy k-token rollout of a batched drafter:
    `roll(params, buf, lens, k) -> [B, k]` int32 proposals, where `buf` is
    a [B, W] windowed-context buffer of token ids (row b's last valid
    token at `lens[b] - 1`, at least k columns of slack on the right).

    k whole-window forwards (no KV cache to thread): each reads the logits
    at each row's last valid position, takes the shared greedy pick
    (serving/sampler.py `greedy_next`, the drafters' and the sampler's one
    tie rule), writes it after the row's tokens and advances `lens`
    (capped at W).  Causal masking makes the slack on the right inert.
    The verify step re-scores every proposal, so nothing here can change
    an emitted token."""
    from paddle_tpu_torch.serving.sampler import greedy_next

    input_name, logits_name = _resolve_io_names(executor.model, input_name,
                                                logits_name)

    def roll(params, buf: torch.Tensor, lens: torch.Tensor,
             k: int) -> torch.Tensor:
        B, W = buf.shape
        buf = buf.clone()
        lens = lens.clone()
        rows = torch.arange(B, device=buf.device)
        picks = []
        for _ in range(int(k)):
            feed = {input_name: Argument(ids=buf, lengths=lens)}
            outputs, _, _ = executor.forward(params, feed, None, TEST)
            logits = outputs[logits_name].value            # [B, W, V]
            nxt = greedy_next(logits[rows, lens.clamp(1, W) - 1])
            buf[rows, lens.clamp(0, W - 1)] = nxt.to(buf.dtype)
            lens = torch.clamp(lens + 1, max=W)
            picks.append(nxt)
        return torch.stack(picks, dim=1)

    return roll
