"""Per-slot sampling for the serving step — the counterpart of
paddle_tpu/serving/sampler.py.

Knobs ride [S] tensors; each sampling slot's randomness arrives as a row
of Gumbel noise, so row s returns argmax(filtered_scores[s] / temp +
noise[s]) — what `jax.random.categorical(key, scores[None])` computes
with the noise gumbel(key, (1, V)), which `slot_noise` draws for [S] keys
at once.  Fed the same noise, the two samplers pick the same tokens; the
tie order of the filters is kept:
  * top-k ranks by value descending, ties by index ascending (lax.top_k);
  * the nucleus cut orders by a stable ascending sort flipped, so ties
    come out index-descending (argsort(...)[:, ::-1];
    graph/lm_decode.py `nucleus_filter`);
  * greedy is argmax, first maximal index.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.graph.lm_decode import nucleus_filter
from paddle_tpu_torch.utils import prng


def slot_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[..., 2] per-slot keys -> [..., vocab] float32 Gumbel noise, row s
    gumbel(keys[s], (vocab,)): bit for bit the JAX sampler's per-slot draw
    gumbel(keys[s], (1, vocab))[0] (bits count over the flat index)."""
    return prng.gumbel(keys, (vocab,))


def greedy_next(last: torch.Tensor) -> torch.Tensor:
    """[..., V] scores -> [...] int32: the first maximal index."""
    return torch.argmax(last, dim=-1).to(torch.int32)


def pick_next_per_slot(last: torch.Tensor, noise: Optional[torch.Tensor],
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor,
                       is_probs: bool = False,
                       any_sampling: Optional[bool] = None) -> torch.Tensor:
    """[S, V] scores + [S, V] Gumbel noise + per-slot knobs [S] -> [S] int32.

    Slots with temperature <= 0 decode greedily and ignore their noise row
    (`noise` may be None when every slot is greedy); top_k <= 0 keeps the
    full support; top_p outside (0, 1) disables the nucleus cut.
    `is_probs`: the scores are probabilities, sampled through
    log(max(p, 1e-30)) in float32.  `any_sampling` says whether some slot
    samples, as the host knows it; None reads it from `temperature` (a
    host read, which a CUDA graph cannot hold).  The tokens are the same
    either way."""
    S, V = last.shape
    last = torch.log(torch.clamp_min(last.float(), 1e-30)) if is_probs \
        else last.float()
    greedy = greedy_next(last)
    sampling = temperature > 0.0
    if any_sampling is None:
        any_sampling = bool(sampling.any())
    if not any_sampling:
        return greedy
    if noise is None:
        raise ValueError("sampling slots need Gumbel noise")
    neg_inf = float("-inf")
    t_safe = torch.where(sampling, temperature, torch.ones_like(temperature))
    scaled = last / t_safe[:, None].float()

    vals, idxs = torch.sort(scaled, dim=-1, descending=True, stable=True)
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    keep = torch.arange(V, device=last.device)[None, :] < k_eff[:, None]
    filtered = torch.full_like(scaled, float("-inf")).scatter(
        1, idxs, torch.where(keep, vals, neg_inf))
    scaled = torch.where((top_k > 0)[:, None], filtered, scaled)

    nuc = nucleus_filter(scaled, top_p)
    apply_p = (top_p > 0.0) & (top_p < 1.0)
    scaled = torch.where(apply_p[:, None], nuc, scaled)

    sampled = torch.argmax(scaled + noise.float(), dim=-1).to(torch.int32)
    return torch.where(sampling, sampled, greedy)


def pick_next_chain(last: torch.Tensor, noise: Optional[torch.Tensor],
                    temperature: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor, is_probs: bool = False,
                    any_sampling: Optional[bool] = None) -> torch.Tensor:
    """[S, K, V] chain scores + [S, K, V] Gumbel noise + per-slot knobs [S]
    -> [S, K] int32: the speculative verify step's picks.  Position (s, i)
    holds the scores at the slot's generation gen[s] + i and its noise is
    that generation's, so entry (s, i) is the token `pick_next_per_slot`
    would give slot s at generation gen[s] + i.  Rows are independent, so
    the chain is flattened and sampled as S * K slots."""
    S, K, V = last.shape
    flat = pick_next_per_slot(
        last.reshape(S * K, V),
        None if noise is None else noise.reshape(S * K, V),
        temperature.repeat_interleave(K), top_k.repeat_interleave(K),
        top_p.repeat_interleave(K), is_probs=is_probs,
        any_sampling=any_sampling)
    return flat.reshape(S, K)
