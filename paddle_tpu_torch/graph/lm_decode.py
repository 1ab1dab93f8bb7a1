"""Autoregressive decoding for sequence-in / logits-out models (the
transformer LM family) — the counterpart of paddle_tpu/graph/lm_decode.py.

`lm_generate` decodes a batch of prompts in one of two modes:
  * whole-prefix re-forward (default): each step runs the full forward on
    the padded [B, P + max_new] token buffer (masked by each row's running
    length) and samples from the last valid position;
  * `use_cache=True`: one forward over the padded prompts fills per-layer
    dense KV caches (`init_kv_caches`, the prefill: flash attention, K4,
    for prompts of at least `block_k_min` tokens), then each step runs the
    stack on ONE new token per row against the caches
    (ops/attention.py `cached_attention_step`), threading them through the
    executor's state.
`lm_beam_generate` runs beam search on the cached path: the caches are
filled once per source row, tiled to B * beam and reordered by each
beam's parent at every step.

Both loops run eagerly on the device of the parameters' copy (the card
unless `device="cpu"`); an `early_exit_chunk` makes the host check
between chunks of steps whether every row has stopped.  Sampling keeps
serving/sampler.py's rules (the engine's sampler is the one
implementation): step i's randomness is the [B, V] Gumbel noise
gumbel(keys[i], (B, V)) for keys = split(rng, max_new), the draw of the
JAX package's `jax.random.categorical(keys[i], scaled)` (utils/prng.py),
unless a `noise` hook gives it.  `build_draft_roll` is the greedy draft
rollout of a batched speculative drafter (serving/drafter.py
`ModelDrafter`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.graph.context import TEST
from paddle_tpu_torch.graph.registry import (cost_layer_types,
                                             validation_layer_types)
from paddle_tpu_torch.obs.compile_watch import get_compile_watch
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.parameter.init import torch_dtype
from paddle_tpu_torch.utils import prng

# noise(i) -> [B, V] float32 Gumbel noise of decode step i
StepNoise = Callable[[int], torch.Tensor]


def nucleus_filter(scaled: torch.Tensor, top_p) -> torch.Tensor:
    """Top-p cut on [B, V] scores: keep the smallest probability-sorted
    prefix whose cumulative mass reaches top_p (the first token at the
    threshold stays), -inf elsewhere; the kept set is scattered back from
    the sorted order, so ties at the cutoff never widen it.  The order is
    a stable ascending sort flipped (ties index-descending), as
    argsort(...)[:, ::-1] gives it.  `top_p` is a float (outside (0, 1):
    no cut) or a [B] tensor (every row cut; the caller picks the rows)."""
    if not torch.is_tensor(top_p):
        if not 0.0 < top_p < 1.0:
            return scaled
    else:
        top_p = top_p[:, None]
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)
    srt = torch.gather(scaled, 1, order)
    probs = torch.softmax(srt, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p
    return torch.full_like(scaled, float("-inf")).scatter(
        1, order, torch.where(keep, srt, float("-inf")))


def pick_next(last: torch.Tensor, noise: Optional[torch.Tensor],
              temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
              is_probs: bool = False) -> torch.Tensor:
    """One sampling decision on [B, V] next-token scores with one set of
    knobs -> [B] int32: serving/sampler.py `pick_next_per_slot` with the
    knobs on every row, so a batch decode and the serving engine sample
    alike.  `noise` [B, V] is needed when temperature > 0."""
    from paddle_tpu_torch.serving.sampler import pick_next_per_slot

    B, dev = last.shape[0], last.device
    return pick_next_per_slot(
        last, noise,
        torch.full((B,), float(temperature), dtype=torch.float32,
                   device=dev),
        torch.full((B,), int(top_k), dtype=torch.int64, device=dev),
        torch.full((B,), float(top_p), dtype=torch.float32, device=dev),
        is_probs=is_probs, any_sampling=temperature > 0.0)


def _chunked_scan(step, carry, steps: range, chunk: int, done_of):
    """carry = step(carry, i) for i in `steps`, in runs of `chunk` steps
    with a host check between runs: once done_of(carry) holds for every
    row the rest is skipped (done rows are frozen, so the skipped steps
    would change nothing).  chunk <= 0 runs every step unchecked."""
    n = len(steps)
    if chunk <= 0 or chunk >= n:
        chunk = max(n, 1)
    for start in range(0, n, chunk):
        for i in steps[start:start + chunk]:
            carry = step(carry, i)
        if start + chunk < n and bool(done_of(carry).all()):
            break
    return carry


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


def init_kv_caches(executor, batch: int, total: int, device) -> dict:
    """Zeroed dense KV caches of every multi_head_attention layer for
    `total` positions, in the executor's compute dtype (float32 without
    one).  Passed as `state` to executor.forward they switch every causal
    attention layer to its cached path (graph/layers_attn.py
    `_cached_step`)."""
    dtype = torch_dtype(executor.compute_dtype) if executor.compute_dtype \
        else torch.float32
    state: dict = {}
    for l in executor.model.layers:
        if l.type != "multi_head_attention":
            continue
        heads = int(l.attrs["num_heads"])
        h_kv = int(l.attrs.get("num_kv_heads", 0) or heads)
        shape = (batch, total, h_kv, int(l.size) // heads)
        state[l.name] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if not state:
        raise ValueError("model has no multi_head_attention layers to cache")
    return state


def _prefill(executor, params, input_name, logits_name, prompt_ids,
             prompt_lengths, total):
    """Fresh KV caches filled by one forward over the padded prompts:
    (state, the logits at each row's last valid position [B, V])."""
    B = prompt_ids.shape[0]
    state = init_kv_caches(executor, B, total, prompt_ids.device)
    outputs, _, state = executor.forward(
        params, {input_name: Argument(ids=prompt_ids,
                                      lengths=prompt_lengths)},
        state, TEST)
    logits = outputs[logits_name].value
    rows = torch.arange(B, device=logits.device)
    return state, logits[rows, prompt_lengths.long() - 1]


def _decode_inputs(executor, params, prompt_ids, prompt_lengths, device):
    """The entry points' common set-up: the device, the params on it
    (cast once to the compute dtype), the prompts as int64 and their
    lengths as int32 there."""
    dev = resolve_device(device)
    params, _ = executor.prepare(
        {n: torch.as_tensor(v).to(dev) for n, v in params.items()}, {})
    ids = torch.as_tensor(prompt_ids).to(dev, torch.int64)
    B, P = ids.shape
    lengths = (torch.full((B,), P, dtype=torch.int32, device=dev)
               if prompt_lengths is None else
               torch.as_tensor(prompt_lengths).to(dev, torch.int32))
    return dev, params, ids, lengths


def lm_generate(executor, params: dict, prompt_ids, prompt_lengths=None,
                max_new: int = 32, *, input_name: Optional[str] = None,
                logits_name: Optional[str] = None, temperature: float = 0.0,
                top_k: int = 0, top_p: float = 0.0, eos_id: int = -1,
                rng=None, seed: int = 0, noise: Optional[StepNoise] = None,
                use_cache: bool = False, early_exit_chunk: int = 0,
                device: DeviceLike = None):
    """Returns (tokens [B, P + max_new] int32, lengths [B] int32): the
    prompts ([B, P] ids, row b's first prompt_lengths[b] valid, default
    all P) plus up to max_new sampled tokens per row; a row stops growing
    at eos_id or at the buffer's end.  temperature 0 is greedy argmax;
    top_k / top_p (which need temperature > 0) cut the support.  Step i
    samples with noise(i) [B, V], by default gumbel(split(rng,
    max_new)[i], (B, V)) with the key `rng` (default PRNGKey(seed), seed
    0).
    `use_cache` decodes against the per-layer KV caches (module
    docstring); `early_exit_chunk` > 0 checks between chunks of that many
    steps whether every row has stopped.  Runs on `device` (the card
    unless "cpu")."""
    input_name, logits_name = _resolve_io_names(executor.model, input_name,
                                                logits_name)
    dev, params, prompt_ids, lengths = _decode_inputs(
        executor, params, prompt_ids, prompt_lengths, device)
    B, P = prompt_ids.shape
    total = P + max_new
    buf = torch.zeros((B, total), dtype=torch.int64, device=dev)
    buf[:, :P] = prompt_ids
    # only knob values that would change sampling are refused (the
    # sampler's effective ranges: top_k > 0, top_p in (0, 1))
    if temperature <= 0.0 and (top_k > 0 or 0.0 < top_p < 1.0):
        raise ValueError(
            f"top_k={top_k}/top_p={top_p} need temperature > 0 — "
            f"temperature=0 means greedy argmax, which would silently "
            f"ignore them")
    if max_new == 0:
        return buf.to(torch.int32), lengths
    vocab = int(executor.model.layer(logits_name).size)
    if noise is None:
        keys = prng.split(prng.PRNGKey(seed) if rng is None else rng,
                          max_new).to(dev)

        def noise(i):
            return prng.gumbel(keys[i], (B, vocab))
    is_probs = _is_probs(executor.model, logits_name)
    rows = torch.arange(B, device=dev)

    def sample(last, i):
        return pick_next(last, noise(i) if temperature > 0.0 else None,
                         temperature, top_k, top_p, is_probs).to(torch.int64)

    def advance(buf, lengths, done, nxt):
        # a stopped row keeps its buffer and length
        at = lengths.long().clamp(0, total - 1)
        buf[rows, at] = torch.where(done, buf[rows, at], nxt)
        lengths = torch.where(done, lengths,
                              torch.clamp(lengths + 1, max=total))
        done = done | (nxt == eos_id) | (lengths >= total)
        return buf, lengths, done

    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    # the reference's compile site: a call with a new (model, B, P,
    # max_new, path, knobs) key records a compile event timed over the
    # whole call (obs/compile_watch.py)
    cw = get_compile_watch().watch(
        "lm_decode.generate",
        (id(executor), B, P, int(max_new), bool(use_cache),
         int(early_exit_chunk), float(temperature), int(top_k),
         float(top_p), int(eos_id)))
    if use_cache:
        with cw:
            state, last = _prefill(executor, params, input_name,
                                   logits_name, prompt_ids, lengths, total)
            buf, lengths, done = advance(buf, lengths, done,
                                         sample(last, 0))
            ones = torch.ones((B,), dtype=torch.int32, device=dev)

            def step_cached(carry, i):
                buf, lengths, done, state = carry
                tok = buf[rows, (lengths.long() - 1).clamp(0, total - 1)]
                outputs, _, state = executor.forward(
                    params, {input_name: Argument(ids=tok[:, None],
                                                  lengths=ones)}, state,
                    TEST)
                nxt = sample(outputs[logits_name].value[:, 0, :], i)
                return advance(buf, lengths, done, nxt) + (state,)

            buf, lengths, _, _ = _chunked_scan(
                step_cached, (buf, lengths, done, state), range(1, max_new),
                early_exit_chunk, done_of=lambda c: c[2])
        return buf.to(torch.int32), lengths

    def step(carry, i):
        buf, lengths, done = carry
        outputs, _, _ = executor.forward(
            params, {input_name: Argument(ids=buf, lengths=lengths)}, None,
            TEST)
        logits = outputs[logits_name].value              # [B, total, V]
        nxt = sample(logits[rows, lengths.long() - 1], i)
        return advance(buf, lengths, done, nxt)

    with cw:
        buf, lengths, _ = _chunked_scan(step, (buf, lengths, done),
                                        range(max_new), early_exit_chunk,
                                        done_of=lambda c: c[2])
    return buf.to(torch.int32), lengths


def _is_probs(model, logits_name: str) -> bool:
    """Whether the logits layer emits probabilities (softmax activation),
    sampled through log; raw-activation layers sample directly."""
    for l in model.layers:
        if l.name == logits_name:
            return l.active_type in ("softmax", "sequence_softmax")
    return False


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: the k largest, ties by ascending
    index (a stable descending sort; torch.topk promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def lm_beam_generate(executor, params: dict, prompt_ids, prompt_lengths=None,
                     beam_size: int = 4, max_new: int = 32, *,
                     input_name: Optional[str] = None,
                     logits_name: Optional[str] = None, eos_id: int = -1,
                     device: DeviceLike = None):
    """Beam search on the KV-cache path: the caches are filled once per
    source row, tiled to B * beam_size and reordered by each beam's parent
    at every step.  A beam's score is the sum of its tokens' log
    probabilities; a beam that emitted eos_id is frozen (its only
    continuation is eos at log probability 0).  Candidates rank by score,
    ties by ascending flat index (beam * V + token), as lax.top_k ranks
    them.  Returns (tokens [B, beam, P + max_new] int32, lengths [B, beam]
    int32, scores [B, beam] float32), beams best-first per row."""
    input_name, logits_name = _resolve_io_names(executor.model, input_name,
                                                logits_name)
    dev, params, prompt_ids, lengths = _decode_inputs(
        executor, params, prompt_ids, prompt_lengths, device)
    B, P = prompt_ids.shape
    K = int(beam_size)
    total = P + max_new
    is_probs = _is_probs(executor.model, logits_name)

    def logprobs_of(raw):                              # [N, V] -> log p
        raw = raw.float()
        if is_probs:
            return torch.log(raw.clamp_min(1e-30))
        return torch.log_softmax(raw, dim=-1)

    buf = torch.zeros((B, K, total), dtype=torch.int64, device=dev)
    buf[:, :, :P] = prompt_ids[:, None, :]
    lengths = lengths[:, None].repeat(1, K)            # [B, K]
    if max_new == 0:
        return (buf.to(torch.int32), lengths,
                torch.zeros((B, K), dtype=torch.float32, device=dev))

    state, last = _prefill(executor, params, input_name, logits_name,
                           prompt_ids, lengths[:, 0].contiguous(), total)
    lp0 = logprobs_of(last)                            # [B, V]
    V = lp0.shape[-1]
    state = {name: {n: x.repeat_interleave(K, dim=0) for n, x in st.items()}
             for name, st in state.items()}
    # the first expansion: the K best tokens of the last prompt position
    # seed the beams (every beam shares the prompt)
    scores, tok0 = _top_k(lp0, K)                      # [B, K]
    bi = torch.arange(B, device=dev)[:, None]
    ki = torch.arange(K, device=dev)[None, :]
    buf[bi, ki, lengths.long()] = tok0
    lengths = lengths + 1
    done = tok0 == eos_id
    frozen = torch.full((V,), float("-inf"), device=dev)
    frozen[max(eos_id, 0)] = 0.0
    ones = torch.ones((B * K,), dtype=torch.int32, device=dev)
    flat_rows = torch.arange(B * K, device=dev)
    for _ in range(max_new - 1):
        tok = buf.reshape(B * K, total)[
            flat_rows, (lengths.reshape(-1).long() - 1).clamp(0, total - 1)]
        outputs, _, state = executor.forward(
            params, {input_name: Argument(ids=tok[:, None], lengths=ones)},
            state, TEST)
        lp = logprobs_of(outputs[logits_name].value[:, 0, :]) \
            .reshape(B, K, V)
        lp = torch.where(done[:, :, None], frozen, lp)
        scores, flat = _top_k((scores[:, :, None] + lp).reshape(B, K * V), K)
        parent, tok_new = flat // V, flat % V          # [B, K]
        # reorder the beams by parent: buffers, lengths, done, caches
        buf = torch.gather(buf, 1, parent[:, :, None].expand(B, K, total))
        lengths = torch.gather(lengths, 1, parent)
        done = torch.gather(done, 1, parent)
        src = (bi * K + parent).reshape(-1)
        state = {name: {n: x.index_select(0, src) for n, x in st.items()}
                 for name, st in state.items()}
        at = lengths.long().clamp(0, total - 1)
        buf[bi, ki, at] = torch.where(done, buf[bi, ki, at], tok_new)
        lengths = torch.where(done, lengths,
                              torch.clamp(lengths + 1, max=total))
        done = done | (tok_new == eos_id)
    # the top-k keeps each row's beams sorted best-first
    return buf.to(torch.int32), lengths, scores


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
