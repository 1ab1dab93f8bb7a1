"""Sequence generation: beam search over a generator sub-model — the port's
counterpart of paddle_tpu/graph/generator.py.

The beam is flattened into the batch ([B*K] rows through the decoder step),
each step expands every beam over the vocabulary and keeps the top K of the
K*V candidates per source row, memory carries are re-gathered by beam
parent, and finished beams are frozen with masks.  Where the JAX side
compiles the search into one `lax.scan`, here it is an eager loop under
`torch.no_grad` that runs all `max_length` steps, as that scan does, and
backtracks the parents at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from paddle_tpu_torch.config.schema import SubModelConfig
from paddle_tpu_torch.graph.context import GEN, ForwardContext
from paddle_tpu_torch.parameter.argument import Argument

_NEG_INF = -1e9


@dataclasses.dataclass
class BeamSearchControls:
    """Hooks into the search, plain callables run at each step:

    - adjust_logp(step, tokens, logp) -> logp': reshape the next-token
      log-probabilities [B, K, V] before the candidates are expanded (ban
      words, force prefixes); `tokens` are the previous step's [B, K].
    - stop_path(step, tokens, scores) -> [B, K] bool: force-finish paths
      (frozen as if they had emitted EOS).
    - norm_path(scores, lengths) -> scores': the final path-score
      normalisation, replacing the default.
    - on_step(step): called with the step's index (statistics)."""

    adjust_logp: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                   torch.Tensor]] = None
    stop_path: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                 torch.Tensor]] = None
    norm_path: Optional[Callable[[torch.Tensor, torch.Tensor],
                                 torch.Tensor]] = None
    on_step: Optional[Callable[[int], Any]] = None


def _tile_beam(x: torch.Tensor, K: int) -> torch.Tensor:
    """[B, ...] -> [B*K, ...], each row repeated K times."""
    return torch.repeat_interleave(x, K, dim=0)


def _gather_beam(x: torch.Tensor, parent: torch.Tensor, B: int,
                 K: int) -> torch.Tensor:
    """Re-select beam rows after the top-k: x [B*K, ...], parent [B, K] in
    [0, K)."""
    xs = x.reshape((B, K) + x.shape[1:])
    idx = parent.reshape((B, K) + (1,) * (x.dim() - 1)).expand(xs.shape)
    return torch.gather(xs, 1, idx).reshape(x.shape)


class SequenceGenerator:
    """Runs a generator sub-model: gen(params, feed) -> (ids, scores).
    `feed` supplies the root graph's inputs (the encoder side); the root
    layers run first, then the search."""

    def __init__(self, executor, sm: SubModelConfig,
                 beam_size: Optional[int] = None,
                 max_length: Optional[int] = None,
                 controls: Optional[BeamSearchControls] = None):
        if sm.generator is None:
            raise ValueError(f"sub-model {sm.name!r} has no generator")
        self.executor = executor
        self.sm = sm
        self.gen = sm.generator
        self.beam_size = beam_size or self.gen.beam_size or 1
        self.max_length = max_length or self.gen.max_num_frames
        self.controls = controls or BeamSearchControls()

    @torch.no_grad()
    def __call__(self, params: dict[str, torch.Tensor],
                 feed: dict[str, Argument]):
        """(ids [B, K, L] int32, EOS after a path's first EOS; scores
        [B, K]), beams best-first; K = beam_size, L = max_length."""
        ex, sm, gen = self.executor, self.sm, self.gen
        K, L = self.beam_size, self.max_length
        ctl = self.controls
        dev = next(iter(params.values())).device

        def on_dev(x, dtype=None):
            return (None if x is None
                    else torch.as_tensor(x, device=dev).to(dtype))

        feed = {n: Argument(on_dev(a.value), on_dev(a.ids, torch.long),
                            on_dev(a.lengths))
                for n, a in feed.items()}

        # the root graph (the encoder) up to the group boundary
        ctx = ForwardContext(model=ex.model, params=params, mode=GEN)
        ctx.outputs.update(feed)
        ex.run_layers(ctx, skip_sub=sm)
        B = next(iter(feed.values())).data.shape[0]

        # static (encoder) inputs tiled K-fold into the flattened beam batch
        static_feeds = {}
        for outer, inner in zip(sm.static_links, sm.static_link_layers):
            arg = ctx.outputs[outer]
            static_feeds[inner] = Argument(*(
                None if x is None else _tile_beam(x, K)
                for x in (arg.value, arg.ids, arg.lengths)))

        # memory carries, tiled (the token memory is the beam state)
        id_mem = gen.id_memory_layer_name
        mems = {m.layer_name: m for m in sm.memories
                if m.layer_name != id_mem}
        carries = {}
        for name, mem in mems.items():
            boot = (ctx.outputs[mem.boot_layer_name].data
                    if mem.boot_layer_name
                    else torch.zeros(B, mem.size, device=dev))
            carries[name] = _tile_beam(boot, K)

        tokens = torch.full((B, K), gen.bos_id, dtype=torch.long, device=dev)
        scores = torch.full((B, K), _NEG_INF, device=dev)
        scores[:, 0] = 0.0
        finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
        toks, parents = [], []
        for t in range(L):
            if ctl.on_step is not None:
                ctl.on_step(t)
            sub = ctx.sub_context()
            sub.outputs.update(static_feeds)
            sub.outputs[id_mem] = Argument(ids=tokens.reshape(B * K))
            for name, c in carries.items():
                sub.outputs[name] = Argument(value=c)
            ex.run_group_layers(sm, sub)
            probs = sub.outputs[gen.prob_layer_name].data.reshape(B, K, -1)
            V = probs.shape[-1]
            logp = torch.log(torch.clamp(probs.float(), min=1e-12))
            if ctl.adjust_logp is not None:
                logp = ctl.adjust_logp(t, tokens, logp)
            if ctl.stop_path is not None:
                finished = finished | ctl.stop_path(t, tokens, scores)
            # a finished beam may only emit EOS, at no cost
            eos_only = torch.full((V,), _NEG_INF, device=dev)
            eos_only[gen.eos_id] = 0.0
            step_logp = torch.where(finished[..., None], eos_only, logp)
            total = (scores[..., None] + step_logp).reshape(B, K * V)
            scores, flat_idx = torch.topk(total, K, dim=1)
            parent = flat_idx // V
            tokens = flat_idx % V
            fin = torch.gather(finished, 1, parent)
            for name, mem in mems.items():
                out = _gather_beam(sub.outputs[mem.link_name].data, parent,
                                   B, K)
                prev = _gather_beam(carries[name], parent, B, K)
                carries[name] = torch.where(
                    fin.reshape((B * K,) + (1,) * (out.dim() - 1)), prev,
                    out)
            finished = fin | (tokens == gen.eos_id)
            toks.append(tokens)
            parents.append(parent)

        # backtrack the parents from the last step
        nxt = torch.arange(K, device=dev).expand(B, K)
        seq = [None] * L
        for t in range(L - 1, -1, -1):
            seq[t] = torch.gather(toks[t], 1, nxt)
            nxt = torch.gather(parents[t], 1, nxt)
        seqs = torch.stack(seq, dim=2)                   # [B, K, L]
        # everything after a path's first EOS is EOS
        eos_seen = torch.cumsum((seqs == gen.eos_id).long(), dim=-1)
        seqs = torch.where(eos_seen > 1, gen.eos_id, seqs)
        lengths = (eos_seen == 0).sum(-1).float() + 1.0
        if ctl.norm_path is not None:
            scores = ctl.norm_path(scores, lengths)
        elif not gen.log_prob:
            scores = scores / lengths
        return seqs.to(torch.int32), scores


def generate(executor, params: dict[str, torch.Tensor],
             feed: dict[str, Argument], beam_size: Optional[int] = None,
             max_length: Optional[int] = None,
             controls: Optional[BeamSearchControls] = None):
    """Find the model's generator sub-model and run the search: (ids
    [B, K, L], scores [B, K]).  The JAX side caches its generators to save a
    compile; building one here only stores its settings, so each call builds
    its own."""
    gens = [sm for sm in executor.model.sub_models if sm.generator is not None]
    if not gens:
        raise ValueError("model has no generator sub-model")
    return SequenceGenerator(executor, gens[0], beam_size, max_length,
                             controls)(params, feed)
