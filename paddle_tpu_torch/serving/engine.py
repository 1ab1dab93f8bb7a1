"""Continuous-batching LM serving engine — the counterpart of
paddle_tpu/serving/engine.py's `ServingEngine` and `Request`.

A fixed set of S decode SLOTS, each holding at most one in-flight request;
KV context lives in the paged pool (serving/paged_kv.py) behind per-slot
page tables.  Scheduling is a host loop over numpy metadata: admit from
the FIFO queue into free slots, run one step over all slots, retire
finished slots, repeat.

Prompts prefill in CHUNKS inside the regular step: a step with any slot
mid-prefill is a MIXED step, where each decoding slot's one row and up to
`prefill_chunk` prompt rows per filling slot pack into one ragged
[max_step_tokens] row list (padding rows address the all-zero table row
S).  A slot whose final chunk ran samples its token 0 from the last prompt
position; until then it emits nothing.  Steps with only decoding slots run
the [S, 1] decode step.  Every attention layer of either step reads
through the ragged paged-attention kernel (ops/paged_attention.py).

Randomness: token g of a request samples with Gumbel noise drawn by the
engine's `noise` source for (request, g) — by default from a torch
Generator on the engine's device (Philox on CUDA) seeded from
(request.seed, g).  Like the JAX engine's per-request key schedule (key g
samples token g), the draw does not depend on the step or slot a token
lands in; the draws themselves differ from JAX's threefry keys.  Greedy
requests use no noise.

Multi-step decode (`decode_steps=k > 1`, the reference's scanned step):
a step with every live slot decoding and none filling runs a WINDOW of k
decode bodies on the device — per-slot token, position, generation count
and run mask live in device tensors, a slot dropping out of the run mask
at its eos or max_new exactly where `_bank_token` would retire it — and
the host reads the [k, S] token block once and banks each slot's column up
to its own end.  Every slot first gets pages for its whole window; a mixed
step, or a window whose pages cannot be grown, runs the k = 1 step.  On
the card the window is a CUDA graph captured once per (k, all-greedy or
sampling) after the variant's first window ran eagerly; the noise for
tokens gen .. gen + k - 1 of each sampling slot is drawn by `noise` into a
fixed [k, S, V] buffer before the replay, the same noise k = 1 draws.
Tokens are identical to k = 1.

Not ported yet (ROADMAP.md): preemption of an overcommitted pool, prefix
cache and copy-on-write, the host spill tier, speculative decode (and with
it `decode_mode`), tensor parallelism, tracing, checkpoint/restore, and
the legacy whole-prompt prefill (`prefill_chunk=None`).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.graph.context import TEST
from paddle_tpu_torch.graph.registry import (cost_layer_types,
                                             validation_layer_types)
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.serving.paged_kv import PagedKVCache
from paddle_tpu_torch.serving.sampler import pick_next_per_slot
from paddle_tpu_torch.utils.cuda_graphs import StepGraph, new_pool

# noise(request, g, vocab, device) -> [vocab] float32 Gumbel noise for
# the request's token g
NoiseFn = Callable[["Request", int, int, torch.device], torch.Tensor]


class Request:
    """One generation request: prompt, length, sampling knobs, and the
    seed of its noise (the JAX engine's `rng` key)."""

    def __init__(self, req_id, prompt_ids, max_new: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: int = -1, seed: int = 0):
        self.req_id = req_id
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = int(eos_id)
        self.seed = int(seed)
        if self.prompt_ids.size < 1:
            raise ValueError(f"request {req_id!r}: empty prompt")
        if self.temperature <= 0.0 and (self.top_k > 0 or
                                        0.0 < self.top_p < 1.0):
            raise ValueError(
                f"top_k={self.top_k}/top_p={self.top_p} need temperature "
                f"> 0 — temperature=0 means greedy argmax, which would "
                f"silently ignore them")


def _mix_seed(seed: int, g: int) -> int:
    """A 64-bit generator seed from (request seed, token index), every bit
    depending on both (the CPU generator reads only the low 32 bits)."""
    mask = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + (int(g) + 1) * 0xBF58476D1CE4E5B9) \
        & mask
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & mask
    return x ^ (x >> 29)


class PhiloxNoise:
    """The default noise source: Gumbel noise for token g of a request,
    drawn from a torch.Generator on the device (Philox on CUDA) seeded
    from (request.seed, g), in the form -log(-log(u)) with u uniform in
    [tiny, 1), as jax.random.gumbel draws it."""

    def __call__(self, req: Request, g: int, vocab: int,
                 device: torch.device) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(_mix_seed(req.seed, g))
        u = torch.rand(vocab, generator=gen, device=device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))


class _Slot:
    """Host state of one occupied slot.  `gen == 0` is PREFILL mode (`pos`
    = prompt tokens committed so far); `gen >= 1` is DECODE mode (token 0
    was sampled from the last prompt position; the slot advances one token
    per step)."""

    __slots__ = ("req", "pos", "gen", "last_tok", "generated", "admit_seq")

    def __init__(self, req: Request, admit_seq: int):
        self.req = req
        self.pos = 0              # tokens resident in the paged cache
        self.gen = 0              # tokens emitted so far
        self.last_tok = -1        # emitted but not yet in the cache
        self.generated: list[int] = []
        self.admit_seq = admit_seq


def _resolve_io_names(model):
    """Input = the first data layer; logits = the last layer that is not
    data, a cost or a validation layer."""
    skip = cost_layer_types | validation_layer_types | {"data"}
    return (model.input_layer_names[0],
            [l.name for l in model.layers if l.type not in skip][-1])


class ServingEngine:
    """Slot scheduler + paged KV + the decode and mixed steps.

    >>> eng = ServingEngine(executor, params, num_slots=4)
    >>> results = eng.run([Request("a", prompt, max_new=16, eos_id=2)])
    >>> results["a"]              # np.int32 prompt + generated tokens
    """

    def __init__(self, executor, params: dict[str, torch.Tensor],
                 num_slots: int = 4, page_size: int = 16,
                 max_context: int = 256, prefill_chunk: Optional[int] = -1,
                 max_step_tokens: Optional[int] = None,
                 noise: Optional[NoiseFn] = None, device: DeviceLike = None,
                 decode_steps: int = 1):
        self.device = resolve_device(device)
        self.executor = executor
        self.input_name, self.logits_name = _resolve_io_names(executor.model)
        logits_cfg = executor.model.layer(self.logits_name)
        self.vocab = int(logits_cfg.size)
        self._probs = logits_cfg.active_type in ("softmax",
                                                 "sequence_softmax")
        # cast once: the per-step prepare() is then a no-op
        self.params, _ = executor.prepare(
            {k: v.to(self.device) for k, v in params.items()}, {})
        pages_per_slot = -(-int(max_context) // int(page_size))
        self.kv = PagedKVCache(executor, num_slots, page_size,
                               pages_per_slot, self.device)
        self.noise: NoiseFn = noise if noise is not None else PhiloxNoise()
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[_Slot]] = [None] * num_slots
        # finished-but-uncollected outputs; run() pops what it completed
        self.results: dict = {}
        self.n_decode_steps = 0             # every step, decode or mixed
        self.n_mixed_steps = 0
        self.n_prefill_chunks = 0
        self.tokens_generated = 0
        self._admit_seq = 0
        self._table_version = -1
        # the device page table [S+1, pages_per_slot], one buffer for the
        # engine's life (a captured window reads it)
        self._d_table = torch.zeros(
            (num_slots + 1, self.kv.pages_per_slot), dtype=torch.int32,
            device=self.device)
        self.n_scan_flushes = 0             # multi-step windows run
        self.n_scan_steps = 0               # decode bodies in them (k each)
        self.set_decode_steps(decode_steps)
        # the device state and graphs of the windows, by k
        self._windows: dict[int, _Window] = {}
        self._pool = new_pool(self.device)
        if prefill_chunk is None:
            raise NotImplementedError(
                "prefill_chunk=None (whole-prompt prefill through the dense "
                "KV cache and the flash kernel) is not ported yet "
                "(ROADMAP.md)")
        chunk = 4 * self.kv.page_size if prefill_chunk == -1 \
            else int(prefill_chunk)
        if chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive, got {chunk}")
        self.prefill_chunk = min(chunk, self.kv.capacity_tokens)
        mst = self.prefill_chunk + num_slots if max_step_tokens is None \
            else int(max_step_tokens)
        if mst <= num_slots:
            raise ValueError(
                f"max_step_tokens {mst} must exceed num_slots {num_slots}: "
                f"every decoding slot takes one row per step, and prefill "
                f"chunks need at least one row to make progress")
        self.max_step_tokens = mst

    # -- public API -------------------------------------------------------
    def validate(self, req: Request) -> None:
        """Raise ValueError if `req` can never be served by this engine."""
        if req.max_new < 0:
            raise ValueError(
                f"request {req.req_id!r}: max_new {req.max_new} is negative")
        p = req.prompt_ids.size
        cap = self.kv.capacity_tokens
        if req.max_new and p + req.max_new > cap:
            raise ValueError(
                f"request {req.req_id!r}: prompt {p} + max_new "
                f"{req.max_new} exceeds the {cap}-token slot capacity "
                f"(pages_per_slot * page_size) — raise max_context")
        if int(req.prompt_ids.min()) < 0 or \
                int(req.prompt_ids.max()) >= self.vocab:
            raise ValueError(f"request {req.req_id!r}: prompt ids outside "
                             f"the vocabulary [0, {self.vocab})")

    def add_request(self, req: Request) -> None:
        """Enqueue; admission happens inside step()/run()."""
        self.validate(req)
        if req.max_new == 0:
            self.results[req.req_id] = req.prompt_ids.copy()
            return
        self.queue.append(req)

    def set_decode_steps(self, decode_steps: int) -> None:
        """Multi-step decode: up to `decode_steps` tokens per slot in one
        window whenever the engine is pure-decode (1 = off).  Tokens are
        the same either way.  Only on an idle engine (a live slot's host
        state must be at a window boundary)."""
        if any(sl is not None for sl in self.slots) or self.queue:
            raise RuntimeError("set_decode_steps requires an idle engine")
        decode_steps = int(decode_steps)
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1 (1 = multi-step "
                             f"off), got {decode_steps}")
        self.decode_steps = decode_steps

    def step(self) -> bool:
        """One scheduler iteration: admit -> one step over all slots ->
        retire.  Returns False when idle (nothing in flight or queued)."""
        self._admit_from_queue()
        live = [s for s, sl in enumerate(self.slots) if sl is not None]
        if not live:
            return False
        decoding = [s for s in live if self.slots[s].gen > 0]
        filling = [s for s in live if self.slots[s].gen == 0]
        for s in decoding:
            if not self.kv.try_grow(s, self.slots[s].pos + 1):
                # the pool holds every slot's whole context, so this is a
                # broken invariant, not page pressure
                raise RuntimeError(f"slot {s}: page pool exhausted")
        if filling:
            # an admission never waits behind a window: mixed load runs the
            # k = 1 mixed step
            self._run_mixed_step(decoding, filling)
        elif self.decode_steps > 1 and self._scan_window_ok(
                decoding, self.decode_steps):
            self._run_scan_step(decoding, self.decode_steps)
        else:
            self._run_decode_step(decoding)
        return True

    def run(self, requests=()) -> dict:
        """Add `requests`, drive step() to completion, and pop
        {req_id: np.int32 prompt + generated tokens} for everything that
        completed during this call."""
        done_before = set(self.results)
        for r in requests:
            self.add_request(r)
        while self.step():
            pass
        return {k: self.results.pop(k) for k in list(self.results)
                if k not in done_before}

    # -- scheduling -------------------------------------------------------
    def _admit_from_queue(self) -> None:
        """FIFO admission into free slots.  Chunk-granular: the slot enters
        prefill mode with its whole prompt's pages reserved, and the prompt
        commits in chunk rows inside the next mixed steps."""
        for s in range(len(self.slots)):
            if not self.queue:
                return
            if self.slots[s] is not None:
                continue
            req = self.queue[0]
            if not self.kv.try_grow(s, req.prompt_ids.size):
                self.kv.release(s)
                return
            self.queue.popleft()
            self._admit_seq += 1
            self.slots[s] = _Slot(req, self._admit_seq)

    def _sync_table(self) -> torch.Tensor:
        """The device page table [S+1, pages_per_slot] — row S is the
        all-zero row padding rows address — copied into its one buffer
        only when a host table write moved kv.version."""
        if self.kv.version != self._table_version:
            self._d_table[:-1].copy_(torch.from_numpy(self.kv.table))
            self._table_version = self.kv.version
        return self._d_table

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, last: torch.Tensor, emitting: list[int]) -> np.ndarray:
        """Sample one token per slot from `last` [S, V]; only the emitting
        slots' knobs (and noise) are used, the other rows are discarded."""
        S = len(self.slots)
        temp = np.zeros(S, np.float32)
        top_k = np.zeros(S, np.int64)
        top_p = np.zeros(S, np.float32)
        noise = None
        for s in emitting:
            req = self.slots[s].req
            temp[s], top_k[s], top_p[s] = req.temperature, req.top_k, \
                req.top_p
        sampling = [s for s in emitting if temp[s] > 0.0]
        if sampling:
            noise = torch.zeros((S, self.vocab), dtype=torch.float32,
                                device=self.device)
            for s in sampling:
                sl = self.slots[s]
                noise[s] = self.noise(sl.req, sl.gen, self.vocab,
                                      self.device)
        nxt = pick_next_per_slot(last, noise, self._to_device(temp),
                                 self._to_device(top_k),
                                 self._to_device(top_p), is_probs=self._probs,
                                 any_sampling=bool(sampling))
        return nxt.cpu().numpy()

    def _run_decode_step(self, runnable) -> None:
        """The [S, 1] decode step: every slot feeds its last token at its
        position (empty slots feed token 0 at position 0 of trash page 0)."""
        S = len(self.slots)
        toks = np.zeros((S, 1), np.int64)
        pos = np.zeros(S, np.int32)
        for s in runnable:
            toks[s, 0] = self.slots[s].last_tok
            pos[s] = self.slots[s].pos
        table = self._sync_table()[:S]
        d_pos = self._to_device(pos)
        state = {name: {"k_pages": p["k"], "v_pages": p["v"],
                        "page_table": table, "pos": d_pos}
                 for name, p in self.kv.pools.items()}
        feed = {self.input_name: Argument(
            ids=self._to_device(toks),
            lengths=torch.ones(S, dtype=torch.int32, device=self.device))}
        outputs, _, _ = self.executor.forward(self.params, feed, state, TEST)
        nxt = self._sample(outputs[self.logits_name].value[:, 0, :],
                           runnable)
        self.n_decode_steps += 1
        for s in runnable:
            self._bank_token(s, int(nxt[s]))

    def _scan_window_ok(self, runnable, k: int) -> bool:
        """Pages for one window: every runnable slot gets pages up to pos +
        min(k, tokens it may still emit).  False (the caller runs the k = 1
        step) when the free list runs dry; pages taken stay with the
        slot."""
        ok = True
        for s in runnable:
            sl = self.slots[s]
            if not self.kv.try_grow(s, sl.pos + min(k, sl.req.max_new
                                                    - sl.gen)):
                ok = False
        return ok

    def _run_scan_step(self, runnable, k: int) -> None:
        """One window of k decode bodies (module docstring): stage the
        slots' state and noise, run or replay the window, read the [k, S]
        token block once, bank each slot's column up to its eos/max_new."""
        S = len(self.slots)
        win = self._windows.get(k)
        if win is None:
            win = self._windows[k] = _Window(self, k)
        ints = np.zeros((7, S), np.int64)       # tok pos gen run eos max topk
        floats = np.zeros((2, S), np.float32)   # temperature, top_p
        sampling = []
        for s in runnable:
            sl, req = self.slots[s], self.slots[s].req
            ints[:, s] = (sl.last_tok, sl.pos, sl.gen, 1, req.eos_id,
                          req.max_new, req.top_k)
            floats[:, s] = (req.temperature, req.top_p)
            if req.temperature > 0.0:
                sampling.append(s)
        self._sync_table()
        win.ints.copy_(torch.from_numpy(ints))
        win.floats.copy_(torch.from_numpy(floats))
        for s in sampling:
            sl = self.slots[s]
            for i in range(min(k, sl.req.max_new - sl.gen)):
                win.noise[i, s] = self.noise(sl.req, sl.gen + i, self.vocab,
                                             self.device)
        sampled = bool(sampling)
        if self.device.type != "cuda" or sampled not in win.graphs:
            # the CPU's mode, and a variant's first window on the card,
            # after which the variant is captured
            win.body(sampled)
            if self.device.type == "cuda":
                win.graphs[sampled] = None
        else:
            if win.graphs[sampled] is None:
                graph = win.graphs[sampled] = StepGraph(self._pool)
                graph.capture(lambda: win.body(sampled))
            win.graphs[sampled].replay()
        blk = win.block.cpu().numpy()                   # [k, S]
        self.n_decode_steps += 1
        self.n_scan_flushes += 1
        self.n_scan_steps += k
        for s in runnable:
            sl = self.slots[s]
            burst = []
            for i in range(k):
                t = int(blk[i, s])
                burst.append(t)
                if t == sl.req.eos_id or sl.gen + len(burst) >= \
                        sl.req.max_new:
                    break                # the run mask froze here too
            for t in burst:
                self._bank_token(s, t)

    def _run_mixed_step(self, runnable, filling) -> None:
        """One mixed prefill/decode step: each decoding slot's row first,
        then up to `prefill_chunk` prompt rows per filling slot (admission
        order) within the `max_step_tokens` budget; padding rows fill the
        rest.  Decoding slots bank a token; a slot whose final chunk ran
        emits token 0."""
        S = len(self.slots)
        T = self.max_step_tokens
        row_ids = np.zeros(T, np.int64)
        row_slot = np.full(T, S, np.int32)     # S = the all-zero table row
        row_pos = np.zeros(T, np.int32)
        sample_row = np.zeros(S, np.int64)
        r = 0
        for s in runnable:
            sl = self.slots[s]
            row_ids[r], row_slot[r], row_pos[r] = sl.last_tok, s, sl.pos
            sample_row[s] = r
            r += 1
        advanced = []                          # (slot, rows, final)
        budget = T - r
        for s in sorted(filling, key=lambda s: self.slots[s].admit_seq):
            if budget <= 0:
                break
            sl = self.slots[s]
            p = sl.req.prompt_ids.size
            n = min(p - sl.pos, self.prefill_chunk, budget)
            row_ids[r:r + n] = sl.req.prompt_ids[sl.pos:sl.pos + n]
            row_slot[r:r + n] = s
            row_pos[r:r + n] = np.arange(sl.pos, sl.pos + n)
            final = sl.pos + n == p
            if final:
                sample_row[s] = r + n - 1
            advanced.append((s, n, final))
            self.n_prefill_chunks += 1
            budget -= n
            r += n
        table = self._sync_table()
        d_slot, d_pos = self._to_device(row_slot), self._to_device(row_pos)
        state = {name: {"k_pages": p["k"], "v_pages": p["v"],
                        "page_table": table, "row_slot": d_slot,
                        "row_pos": d_pos}
                 for name, p in self.kv.pools.items()}
        feed = {self.input_name: Argument(
            ids=self._to_device(row_ids[None, :]),
            lengths=torch.full((1,), T, dtype=torch.int32,
                               device=self.device))}
        outputs, _, _ = self.executor.forward(self.params, feed, state, TEST)
        logits = outputs[self.logits_name].value[0]            # [T, V]
        emitting = list(runnable) + [s for s, _, final in advanced if final]
        nxt = self._sample(logits[self._to_device(sample_row)], emitting)
        self.n_decode_steps += 1
        self.n_mixed_steps += 1
        for s in runnable:
            self._bank_token(s, int(nxt[s]))
        for s, n, final in advanced:
            self.slots[s].pos += n
            if final:
                self._emit_first(s, int(nxt[s]))

    def _bank_token(self, s: int, tok: int) -> None:
        """Record one decoded token of slot `s`; retire on eos/max_new."""
        sl = self.slots[s]
        sl.generated.append(tok)
        sl.pos += 1
        sl.gen += 1
        sl.last_tok = tok
        self.tokens_generated += 1
        if tok == sl.req.eos_id or sl.gen >= sl.req.max_new:
            self._retire(s)

    def _emit_first(self, s: int, tok0: int) -> None:
        """Final-chunk emission: the whole prompt is committed and `tok0`
        came from its last position.  The slot flips to decode mode."""
        sl = self.slots[s]
        sl.gen = 1
        sl.last_tok = tok0
        sl.generated = [tok0]
        self.tokens_generated += 1
        if tok0 == sl.req.eos_id or sl.req.max_new == 1:
            self._retire(s)

    def _retire(self, s: int) -> None:
        sl = self.slots[s]
        self.results[sl.req.req_id] = np.concatenate(
            [sl.req.prompt_ids, np.asarray(sl.generated, np.int32)])
        self.kv.release(s)
        self.slots[s] = None


class _Window:
    """The device state of one engine's windows of k bodies, and their
    graphs: per-slot integers (last token, position, generation count,
    run mask, eos id, max_new, top_k) and floats (temperature, top_p)
    staged by the host at a window's start, the noise of the sampling
    slots' k tokens, and the [k, S] token block the window writes."""

    def __init__(self, eng: ServingEngine, k: int):
        S, dev = len(eng.slots), eng.device
        self.eng, self.k = eng, k
        # all-greedy / sampling -> its graph on the card (None: ran eagerly
        # once, captured at the next window)
        self.graphs: dict[bool, Optional[StepGraph]] = {}
        self.ints = torch.zeros((7, S), dtype=torch.int64, device=dev)
        self.floats = torch.zeros((2, S), dtype=torch.float32, device=dev)
        self.noise = torch.zeros((k, S, eng.vocab), dtype=torch.float32,
                                 device=dev)
        self.block = torch.zeros((k, S), dtype=torch.int32, device=dev)
        self.ones = torch.ones(S, dtype=torch.int32, device=dev)

    def body(self, sampling: bool) -> None:
        """k decode steps on the device, no host read: each the k = 1 decode
        step's forward and sampler over all S slots, then the running slots
        advance and a slot leaves the run mask at its eos or max_new.  A
        stopped slot recomputes its frozen row; its K/V write lands one
        position past its last token (in its own pages or the trash page),
        where nothing reads it."""
        eng = self.eng
        S = self.ints.shape[1]
        tok, pos, gen, run, eos, max_new, top_k = self.ints
        temp, top_p = self.floats
        table = eng._d_table[:S]
        for i in range(self.k):
            state = {name: {"k_pages": p["k"], "v_pages": p["v"],
                            "page_table": table, "pos": pos}
                     for name, p in eng.kv.pools.items()}
            feed = {eng.input_name: Argument(ids=tok[:, None],
                                             lengths=self.ones)}
            outputs, _, _ = eng.executor.forward(eng.params, feed, state,
                                                 TEST)
            nxt = pick_next_per_slot(
                outputs[eng.logits_name].value[:, 0, :],
                self.noise[i] if sampling else None, temp, top_k, top_p,
                is_probs=eng._probs, any_sampling=sampling)
            self.block[i].copy_(nxt)
            nxt = nxt.to(torch.int64)
            on = run.bool()
            pos.add_(run)
            gen.add_(run)
            tok.copy_(torch.where(on, nxt, tok))
            run.copy_((on & (nxt != eos) & (gen < max_new)).to(torch.int64))
