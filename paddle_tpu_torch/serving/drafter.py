"""Draft-token proposers for speculative decoding — the counterpart of
paddle_tpu/serving/drafter.py.

The serving engine's verify step (serving/engine.py `_run_spec_step`)
scores a slot's next token and up to k drafted ones in one ragged forward
and keeps the leading run the target agrees with, so a drafter changes
how many steps the tokens take, never the tokens.  Two interfaces, both
used by the engine:

    propose(ctx, k, eos_id=-1) -> up to k int32 tokens continuing `ctx`
        (the slot's prompt + generated tokens, newest last), deterministic
        in ctx.  The clamp contract is the drafter's: never more than k
        tokens and none past the first `eos_id` (`clamp_proposal`); the
        engine asserts it instead of truncating.
    propose_batch(ctx [S, W], lens [S], k, eos_ids [S]) -> [S, k] int32
        (optional): every slot's proposals in one call, row s cut just
        after its first eos_ids[s] and padded with -1.

`NgramDrafter` (the engine's default) is prompt lookup in numpy;
`ModelDrafter` rolls a draft LM greedily over a window of each slot's
context, all slots in one batch (graph/lm_decode.py `build_draft_roll`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.graph.lm_decode import build_draft_roll
from paddle_tpu_torch.obs.compile_watch import get_compile_watch


def clamp_proposal(d, k: int, eos_id: int = -1) -> np.ndarray:
    """At most `k` tokens, cut just after the first `eos_id` (a drafted eos
    may be accepted and retire the slot; tokens past it could never be
    banked, and scoring them would skew the accept rate)."""
    d = np.asarray(d, np.int32).reshape(-1)[:max(0, int(k))]
    if eos_id >= 0 and d.size:
        hit = np.flatnonzero(d == eos_id)
        if hit.size:
            d = d[:int(hit[0]) + 1]
    return d


class NgramDrafter:
    """Prompt lookup: propose the continuation of the most recent earlier
    occurrence of the context's trailing n-gram, trying n = max_ngram down
    to min_ngram (the first n with a hit wins).  `window` bounds the
    searched context to its most recent tokens; the engine reads it to
    hand over only that tail."""

    kind = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 window: int = 256):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}, {max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.window = int(window)

    def propose(self, ctx, k: int, eos_id: int = -1) -> np.ndarray:
        ctx = np.asarray(ctx, np.int32).reshape(-1)[-self.window:]
        n_ctx = ctx.size
        if k <= 0 or n_ctx < 2:
            return np.zeros(0, np.int32)
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1,
                       -1):
            pat = ctx[n_ctx - n:]
            # windows over ctx[:-1]: every start whose continuation has at
            # least one token to propose
            wins = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.flatnonzero((wins == pat[None, :]).all(axis=1))
            if hits.size:
                start = int(hits[-1]) + n              # most recent match
                return clamp_proposal(ctx[start:start + k], k, eos_id)
        return np.zeros(0, np.int32)


class ModelDrafter:
    """Greedy k-token proposals of a draft LM for every decoding slot in
    one batched rollout: k whole-window forwards of the [S, W + k] buffer
    of the slots' most recent `window` tokens (`build_draft_roll`), eager,
    on the drafter's device (the card unless `device="cpu"`).  It holds
    the executor and its own cast copy of the params it is given.

    `ModelDrafter(executor, params)` drafts with a separate LM;
    `from_target` with the target itself over the window
    (self-speculation); `distilled_init` with a fresh small transformer
    whose embedding and tied head are sliced from the target's."""

    kind = "model"

    def __init__(self, executor, params: dict, window: int = 64,
                 input_name: Optional[str] = None,
                 logits_name: Optional[str] = None,
                 device: DeviceLike = None):
        if int(window) < 2:
            raise ValueError(f"draft window {window} must hold an n-gram")
        self.device = resolve_device(device)
        self.executor = executor
        self.params, _ = executor.prepare(
            {n: torch.as_tensor(v).to(self.device) for n, v in params.items()},
            {})
        self.window = int(window)
        self._roll = build_draft_roll(executor, input_name=input_name,
                                      logits_name=logits_name)

    @classmethod
    def from_target(cls, executor, params: dict, window: int = 64,
                    device: DeviceLike = None) -> "ModelDrafter":
        """Self-speculation: the target drafts for itself over a truncated
        window."""
        return cls(executor, params, window=window, device=device)

    @classmethod
    def distilled_init(cls, executor, params: dict, dim: int = 32,
                       layers: int = 1, heads: int = 2, window: int = 64,
                       seed: int = 0, embedding_name: str = "_tok_embedding",
                       head_name: Optional[str] = None,
                       device: DeviceLike = None) -> "ModelDrafter":
        """A fresh transformer LM of width `dim` (the port's parse of
        demo/model_zoo/transformer_lm.py, a Trainer's initial parameters
        from `seed`) whose token embedding is the first `dim` columns of
        the target's and whose LM head, where it is [dim, vocab], is that
        slice's transpose (weight tying).  `executor`/`params` are the
        target's; vocab is read off its embedding."""
        from paddle_tpu_torch.models import transformer_lm_trainer_config
        from paddle_tpu_torch.trainer import Trainer

        del executor
        emb = torch.as_tensor(params[embedding_name]).detach().float().cpu()
        vocab, tdim = emb.shape
        dim = min(int(dim), int(tdim))
        cfg = transformer_lm_trainer_config(vocab, dim, int(layers),
                                            int(heads), batch_size=1)
        tr = Trainer(cfg, seed=seed, device=device)
        draft = dict(tr.params)
        draft[embedding_name] = emb[:, :dim].clone()
        if head_name is None:
            head_name = next((n for n in draft if n.startswith("_lm_head")),
                             None)
        if head_name is not None and \
                tuple(draft[head_name].shape) == (dim, vocab):
            draft[head_name] = emb[:, :dim].T.contiguous()
        return cls(tr.executor, draft, window=window, device=tr.device)

    def propose_batch(self, ctx: np.ndarray, lens: np.ndarray, k: int,
                      eos_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """[S, W] windowed contexts + [S] valid lengths -> [S, k] greedy
        proposals, row s cut just after its first eos_ids[s] and padded
        with -1 (never a vocabulary id)."""
        S, W = int(ctx.shape[0]), int(ctx.shape[1])
        k = int(k)
        if k <= 0:
            return np.zeros((S, 0), np.int32)
        buf = np.zeros((S, W + k), np.int64)
        buf[:, :W] = ctx
        lens = np.clip(np.asarray(lens, np.int32), 1, W)
        with get_compile_watch().observe("serving.draft_step", buf, k):
            out = self._roll(self.params,
                             torch.from_numpy(buf).to(self.device),
                             torch.from_numpy(lens).to(self.device), k)
        out = out.cpu().numpy()
        if eos_ids is not None:
            eos = np.asarray(eos_ids, np.int32)[:, None]
            hit = (out == eos) & (eos >= 0)
            past = np.zeros((S, k), bool)
            past[:, 1:] = np.cumsum(hit[:, :-1], axis=1) > 0
            out = np.where(past, -1, out)
        return out.astype(np.int32)

    def propose(self, ctx, k: int, eos_id: int = -1) -> np.ndarray:
        """One context through the batched rollout."""
        ctx = np.asarray(ctx, np.int32).reshape(-1)[-self.window:]
        if k <= 0 or ctx.size == 0:
            return np.zeros(0, np.int32)
        row = np.zeros((1, self.window), np.int32)
        row[0, :ctx.size] = ctx
        out = self.propose_batch(row, np.array([ctx.size]), int(k))
        return clamp_proposal(out[0], k, eos_id)
