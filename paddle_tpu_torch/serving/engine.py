"""Continuous-batching LM serving engine — the counterpart of
paddle_tpu/serving/engine.py's `ServingEngine` and `Request`, in the
reference's default configuration: prefix cache on, the pool
overcommittable.

A fixed set of S decode SLOTS, each holding at most one in-flight request;
KV context lives in the paged pool (serving/paged_kv.py) behind per-slot
page tables.  Scheduling is a host loop over numpy metadata: sweep
deadlines, admit from the FIFO queue into free slots, run one step over
all slots, retire finished slots, repeat.

Prompts prefill in CHUNKS inside the regular step: a step with any slot
mid-prefill is a MIXED step, where each decoding slot's one row and up to
`prefill_chunk` prompt rows per filling slot pack into one ragged
[max_step_tokens] row list (padding rows address the all-zero table row
S).  A slot whose final chunk ran samples its token 0 from the last prompt
position; until then it emits nothing.  Steps with only decoding slots run
the [S, 1] decode step.  Every attention layer of either step reads
through the ragged paged-attention kernel (ops/paged_attention.py).

`prefill_chunk=None` is the reference's whole-prompt prefill, the
baseline of its chunked-prefill A/B: an admission runs the whole prompt
through the model at once (`_admit`), padded to its length bucket
(`bucket_for`, the feeder's buckets page-aligned) on a fresh dense KV
cache (graph/lm_decode.py `init_kv_caches`: flash attention, K4, for a
bucket of at least `block_k_min` tokens), writes its K/V into the slot's
pages and emits token 0 at once; a prefix hit seeds the dense cache from
its matched pages and runs only the suffix (the cache's "cont" path).
Steps then only decode (or verify, S * (spec_k + 1) rows).

Prefix cache (`prefix_cache=True`, serving/prefix_tree.py): a retiring,
preempted or cancelled slot donates its fully committed pages to a radix
index keyed on token-id runs; an admission walks it (up to the prompt's
last token but one), maps the matched pages read-only, reserves the
suffix's pages, copies a partially matched boundary page (copy-on-write)
and starts its chunk cursor past the match.  All of it is host-side table
state: a remap only changes `_d_table`'s contents, so no CUDA graph is
captured anew.

Overcommitted pool (`num_pages` below 1 + S * pages_per_slot): a decoding
slot that cannot get its next page (after the index's LRU eviction) is
PAUSED — left out of the step, its row staged at its own position, whose
page is unmapped, so its write lands in trash page 0 — and resumes once a
page frees.  When no decoding slot can run, the youngest slot is
PREEMPTED: it donates its committed pages, releases the rest and goes
back to the queue front; its replay prefix-hits its own donation and
draws the same noise (token g of a request always samples with the noise
of its key g), so preemption never shows in the tokens.  Preemption
happens only between steps, so also only at a window boundary.

Requests end by eos ("stop"), max_new ("length"), `cancel` ("cancelled")
or their `deadline` on the engine's `clock` ("deadline"); `results` and
`finish_reasons` hold them until run() pops them, and the `on_token` /
`on_finish` hooks see every token and every end.  `checkpoint_state` /
`restore_state` freeze an engine between steps (queued, decoding and
mid-chunk requests) and resume it on a fresh engine of the same
configuration bit for bit.

Randomness: token g of a request samples with the Gumbel noise
gumbel(key_g, (V,)) of its key g = split(request.rng, max_new)[g] (g
clipped to max_new - 1), as the JAX engine samples it (utils/prng.py,
threefry), so a sampled request gets the JAX package's tokens.  Each
slot's request key is staged into a fixed [S, 2] device buffer at
admission; every step, window body and verify step derives key g and its
noise row on the device from that buffer and the generation count, so a
captured window draws inside its graph.  The draw does not depend on the
step or slot a token lands in.  Greedy requests use no noise.  A `noise`
hook (noise(request, g, vocab, device) -> [vocab]) replaces the draw, for
tests that feed other noise.

Multi-step decode (`decode_steps=k > 1`, the reference's scanned step):
a step with every live slot decoding and none filling runs a WINDOW of k
decode bodies on the device — per-slot token, position, generation count
and run mask live in device tensors, a slot dropping out of the run mask
at its eos or max_new exactly where `_bank_token` would retire it — and
the host reads the [k, S] token block once and banks each slot's column up
to its own end.  Every running slot first gets pages for its whole
window; a mixed step, or a window whose pages cannot be grown, runs the
k = 1 step.  On the card the window is a CUDA graph captured once per (k,
all-greedy or sampling) after the variant's first window ran eagerly; a
sampling window draws the noise of its k bodies in one draw inside the
graph, from the staged keys and the generation counts, the same noise
k = 1 draws.  Tokens are identical to k = 1.

Speculative decode (`spec_k > 0`, the reference's verify step): between
steps a DRAFTER (serving/drafter.py: prompt lookup by default, or a draft
LM's batched greedy rollout) proposes up to k tokens per decoding slot,
and one ragged forward scores each slot's CHAIN — its base row at `pos`
plus its drafts at pos+1.. in its own pages — beside any prompt chunks.
Chain position i samples with the noise of generation gen + i, so it is
the token the sequential engine would emit there; the slot commits the
leading run of drafts the target agrees with plus one sampled token,
and `kv.uncommit_tail` hands back the pages the rejected tail grew.
Speculation changes how many steps the tokens take, never the tokens.
`spec_dynamic=True` steers each slot's depth by an EWMA of its accept
rate.  `decode_mode` "auto" lets a draft-free pure-decode step take the
window; "static" keeps windows off while speculation is on.

Host spill tier (`spill_bytes_budget` > 0, `set_spill_budget`): a cold
cached page the prefix index would destroy under page pressure is copied
to host memory instead (serving/paged_kv.py, prefix_tree.py), and an
admission that hits a spilled run restores its pages into fresh device
pages — written in place, so captured windows stay valid — before it maps
them like any cached prefix.  `export_prefix` / `import_prefix` carry a
cached prefix's pages to another engine in the reference's wire layout;
the importer's next admission of that prompt is a prefix hit.  A restored
or imported page is an ordinary page to the paged-attention kernel, so
tokens do not depend on where a page has been.

Observability (obs/): every request's lifecycle runs through phases
queued -> prefill -> decode (-> preempt -> queued -> prefill -> replay)
-> done on the `tracer`'s lane `req:<id>`, and each step is a span on the
`engine` lane (`decode_step`, `scan_step`, `draft_step`) — recorded only
while the tracer is enabled, on host clocks, with no tensor read.  The
per-phase wall times are kept always and land in `finish_timing`.  The
flight recorder (obs/flight.py) gets the state transitions, the step
histograms (`step_tokens_hist`, `decode_gap_hist`, `draft_ms_hist`,
`spec_k_hist`) the per-step host numbers, and the compile watch
(obs/compile_watch.py) each site's new shape signatures and graph
captures, under the reference's site names.

Refused with NotImplementedError (ROADMAP.md): tensor parallelism
(`mesh`).
"""

from __future__ import annotations

import inspect
import os
import pickle
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.data.feeder import _bucket_len
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.graph.context import TEST
from paddle_tpu_torch.graph.lm_decode import (_is_probs, _resolve_io_names,
                                              init_kv_caches, pick_next)
from paddle_tpu_torch.obs.compile_watch import (get_compile_watch,
                                                signature_of)
from paddle_tpu_torch.obs.flight import get_flight_recorder
from paddle_tpu_torch.obs.metrics import Histogram
from paddle_tpu_torch.obs.trace import get_tracer
from paddle_tpu_torch.ops.paged_attention import split_plan
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.serving.drafter import NgramDrafter
from paddle_tpu_torch.serving.paged_kv import PagedKVCache
from paddle_tpu_torch.serving.prefix_tree import PrefixTree
from paddle_tpu_torch.serving.sampler import (pick_next_chain,
                                              pick_next_per_slot,
                                              slot_noise)
from paddle_tpu_torch.utils import prng
from paddle_tpu_torch.utils.cuda_graphs import StepGraph, new_pool

# noise(request, g, vocab, device) -> [vocab] float32 Gumbel noise for
# the request's token g: a test hook in place of the key's draw
NoiseFn = Callable[["Request", int, int, torch.device], torch.Tensor]

# engine counters a checkpoint carries
_COUNTERS = ("_admit_seq", "n_decode_steps", "n_mixed_steps",
             "n_prefill_chunks", "tokens_generated", "n_preemptions",
             "n_cancelled", "n_expired", "n_prefix_hits", "n_prefix_misses",
             "prefill_tokens_saved", "n_scan_flushes", "n_scan_steps",
             "n_spec_steps", "n_spec_chains", "n_spec_drafted",
             "n_spec_accepted", "n_spec_tokens", "n_draft_steps",
             "occupancy_sum", "n_restore_hits", "restore_tokens_saved")

# dynamic speculation (ServingEngine._dyn_k): the weight of a chain's accept
# rate in its slot's running estimate (adapts within ~4 chains without
# thrashing on one unlucky draft), and how often a slot whose depth decayed
# to 0 re-probes with one draft
_EWMA_ALPHA = 0.25
_PROBE_EVERY = 16


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"Queue 1)")


class Request:
    """One generation request: prompt, length, sampling knobs, the
    threefry key `rng` of its noise (a [2] key, as the JAX engine's; `seed`
    spells PRNGKey(seed); neither means PRNGKey(0)), an optional
    `deadline` on the engine's clock and an inbound trace context
    (`{"trace_id", "parent"}`, carried as attrs of the request's spans)."""

    def __init__(self, req_id, prompt_ids, max_new: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: int = -1, rng=None,
                 deadline: Optional[float] = None,
                 trace: Optional[dict] = None,
                 seed: Optional[int] = None):
        self.req_id = req_id
        self.trace = dict(trace) if trace else None
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = int(eos_id)
        if rng is not None:
            self.rng = prng.as_key(rng, device="cpu")
        else:
            self.rng = prng.PRNGKey(0 if seed is None else seed)
        self.deadline = None if deadline is None else float(deadline)
        # the tokens it had emitted when it was last preempted: the replay
        # re-emits them, and a cancel or deadline before it catches up
        # still reports them (they were streamed already)
        self._preempted_gen: Optional[list] = None
        if self.prompt_ids.size < 1:
            raise ValueError(f"request {req_id!r}: empty prompt")
        if self.temperature <= 0.0 and (self.top_k > 0 or
                                        0.0 < self.top_p < 1.0):
            raise ValueError(
                f"top_k={self.top_k}/top_p={self.top_p} need temperature "
                f"> 0 — temperature=0 means greedy argmax, which would "
                f"silently ignore them")

    def snapshot(self) -> dict:
        return {"req_id": self.req_id, "prompt_ids": self.prompt_ids.copy(),
                "max_new": self.max_new, "temperature": self.temperature,
                "top_k": self.top_k, "top_p": self.top_p,
                "eos_id": self.eos_id,
                "rng": self.rng.numpy().astype(np.uint32),
                "deadline": self.deadline, "trace": self.trace,
                "preempted_gen": (None if self._preempted_gen is None
                                  else list(self._preempted_gen))}

    @classmethod
    def from_snapshot(cls, d: dict) -> "Request":
        r = cls(d["req_id"], d["prompt_ids"], max_new=d["max_new"],
                temperature=d["temperature"], top_k=d["top_k"],
                top_p=d["top_p"], eos_id=d["eos_id"], rng=d.get("rng"),
                seed=d.get("seed"), deadline=d["deadline"],
                trace=d.get("trace"))
        r._preempted_gen = (None if d["preempted_gen"] is None
                            else list(d["preempted_gen"]))
        return r


class _Slot:
    """Host state of one occupied slot.  `gen == 0` is PREFILL mode (`pos`
    = prompt tokens committed so far, cached prefix included); `gen >= 1`
    is DECODE mode (token 0 was sampled from the last prompt position; the
    slot advances one token per step)."""

    __slots__ = ("req", "pos", "gen", "last_tok", "generated", "admit_seq",
                 "replay_until", "accept_ewma", "probe_tick")

    def __init__(self, req: Request, admit_seq: int, pos: int = 0):
        self.req = req
        self.pos = pos            # tokens resident in the paged cache
        self.gen = 0              # tokens emitted so far
        self.last_tok = -1        # emitted but not yet in the cache
        self.generated: list[int] = []
        self.admit_seq = admit_seq  # preemption takes the youngest
        # generations below this re-emit tokens a preemption took back: the
        # trace's `replay` phase, flipping to `decode` at the first fresh
        # one (0: never preempted, or caught up)
        self.replay_until = 0
        # dynamic speculation: the EWMA of this slot's per-chain accept rate
        # (None until a chain with drafts verified) and the windows since
        # its last re-probe at depth 0
        self.accept_ewma: Optional[float] = None
        self.probe_tick = 0


class ServingEngine:
    """Slot scheduler + paged KV + prefix index + the decode and mixed
    steps.

    >>> eng = ServingEngine(executor, params, num_slots=4)
    >>> results = eng.run([Request("a", prompt, max_new=16, eos_id=2)])
    >>> results["a"]              # np.int32 prompt + generated tokens
    """

    def __init__(self, executor, params: dict[str, torch.Tensor],
                 num_slots: int = 4, page_size: int = 16,
                 max_context: int = 256, num_pages: Optional[int] = None,
                 prefix_cache: bool = True, prefill_chunk: Optional[int] = -1,
                 max_step_tokens: Optional[int] = None,
                 noise: Optional[NoiseFn] = None, device: DeviceLike = None,
                 decode_steps: int = 1, spill_bytes_budget: int = 0,
                 spec_k: int = 0, drafter=None, spec_dynamic: bool = False,
                 decode_mode: str = "auto", mesh=None, tracer=None):
        if mesh is not None:
            raise _not_ported("tensor-parallel decode (mesh)")
        self.device = resolve_device(device)
        self.executor = executor
        self.input_name, self.logits_name = _resolve_io_names(executor.model)
        self.vocab = int(executor.model.layer(self.logits_name).size)
        self._probs = _is_probs(executor.model, self.logits_name)
        # cast once: the per-step prepare() is then a no-op
        self.params, _ = executor.prepare(
            {k: v.to(self.device) for k, v in params.items()}, {})
        pages_per_slot = -(-int(max_context) // int(page_size))
        self.kv = PagedKVCache(executor, num_slots, page_size,
                               pages_per_slot, self.device, num_pages,
                               spill_bytes_budget=spill_bytes_budget)
        self.prefix: Optional[PrefixTree] = None
        self.set_prefix_cache(prefix_cache)
        self.noise: Optional[NoiseFn] = noise
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[_Slot]] = [None] * num_slots
        # finished-but-uncollected outputs and why each ended ("stop",
        # "length", "cancelled", "deadline"); run() pops what it completed
        self.results: dict = {}
        self.finish_reasons: dict = {}
        # on_token(req_id, token, index) for every emitted token (a replay
        # after a preemption emits its tokens again from index 0);
        # on_finish(req_id, tokens, reason) once per request
        self.on_token = None
        self.on_finish = None
        # the deadline clock (tests inject lambda: eng.n_decode_steps)
        self.clock = time.monotonic
        # request-lifecycle spans, recorded only while tracer.enabled (each
        # engine may have its own ring); at most one phase open per request
        self.tracer = tracer if tracer is not None else get_tracer()
        self._obs_open: dict = {}       # req_id -> open span
        self._req_trace: dict = {}      # req_id -> inbound trace context
        # per-request phase wall times, kept always (a few clock reads per
        # lifecycle transition): the open phase, the per-phase sums and
        # counts, folded into finish_timing[req_id] at the finish
        self._req_phase: dict = {}
        self._req_attr: dict = {}
        self.finish_timing: dict = {}
        self.flight = get_flight_recorder()
        self.occupancy_sum = 0.0            # sum of live / S over steps
        # hits whose prefix needed a restore from the host tier, and the
        # prompt tokens of those hits served from restored pages
        self.n_restore_hits = 0
        self.restore_tokens_saved = 0
        # import_prefix calls and the pages they brought
        self.n_kv_mounts = 0
        self.kv_pages_mounted = 0
        self.n_decode_steps = 0             # every step, decode or mixed
        self.n_mixed_steps = 0
        self.n_prefill_chunks = 0
        self.tokens_generated = 0
        self.n_preemptions = 0
        self.n_cancelled = 0
        self.n_expired = 0
        self.n_prefix_hits = 0
        self.n_prefix_misses = 0
        self.prefill_tokens_saved = 0
        self._admit_seq = 0
        self._table_version = -1
        # the device page table [S+1, pages_per_slot], one buffer for the
        # engine's life (a captured window reads it)
        self._d_table = torch.zeros(
            (num_slots + 1, self.kv.pages_per_slot), dtype=torch.int32,
            device=self.device)
        # each slot's request key, staged at admission (a captured window
        # reads it), and the eager steps' noise draws by chain length K
        # (`_draw_noise`: the generations' buffer, the graph, its output)
        self._d_keys = torch.zeros((num_slots, 2), dtype=torch.int64,
                                   device=self.device)
        self._noise_draws: dict[int, tuple] = {}
        self.n_scan_flushes = 0             # multi-step windows run
        self.n_scan_steps = 0               # decode bodies in them (k each)
        # tokens banked for one slot of a window arrive in a burst of
        # cur_burst (1 outside a window): the server's on_token divides an
        # inter-token gap by it and streams it as a token frame's `burst`
        self.cur_burst = 1
        self.tp = 1                         # model-axis shards (no mesh)
        self.n_spec_steps = 0               # verify steps run
        self.n_spec_chains = 0              # chains verified (slot, step)
        self.n_spec_drafted = 0             # draft tokens scored
        self.n_spec_accepted = 0            # draft tokens accepted
        self.n_spec_tokens = 0              # tokens banked through chains:
                                            # accepted + chains unless an
                                            # eos cut a chain
        self.n_draft_steps = 0              # draft passes that proposed
        # the device state and graphs of the windows, by k
        self._windows: dict[int, _Window] = {}
        self._pool = new_pool(self.device)
        self.splits = 0
        self.spec_k = 0
        self.drafter = None
        self.spec_dynamic = False
        self._drafter_takes_eos = False
        self.set_chunking(4 * self.kv.page_size if prefill_chunk == -1
                          else prefill_chunk, max_step_tokens)
        self.set_speculation(spec_k, drafter, dynamic=spec_dynamic)
        self.set_decode_steps(decode_steps)
        self.set_decode_mode(decode_mode)
        # per-step host numbers (the reference's buckets): rows a step
        # scheduled, the gap between steps that advanced decode rows, ms a
        # draft pass, and the draft depth chosen per slot and step
        self.step_tokens_hist = Histogram(
            "serving_step_tokens", "", (), threading.Lock(),
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048))
        self.decode_gap_hist = Histogram(
            "serving_decode_gap_ms", "", (), threading.Lock(),
            buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                     2500, 5000))
        self.draft_ms_hist = Histogram(
            "serving_draft_ms", "", (), threading.Lock(),
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                     250))
        self.spec_k_hist = Histogram(
            "serving_spec_k_effective", "", (), threading.Lock(),
            buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
        self._t_prev_decode: Optional[float] = None

    # -- lifecycle tracing ------------------------------------------------
    def _tr_on(self) -> bool:
        t = self.tracer
        return t is not None and t.enabled

    def _trace_attrs(self, req_id, attrs: dict) -> dict:
        """Span attrs with the request's inbound trace context merged in."""
        tc = self._req_trace.get(req_id)
        if tc:
            attrs = dict(attrs)
            attrs.setdefault("trace_id", tc.get("trace_id"))
            if tc.get("parent"):
                attrs.setdefault("parent", tc["parent"])
        return attrs

    def _tr_begin(self, req_id, phase: str, **attrs) -> None:
        """Open the request's next phase (queued, prefill, decode, replay);
        the previous one was closed by _tr_end.  The phase clock runs
        always; the span records only while the tracer is enabled."""
        now = time.perf_counter()
        self._req_phase[req_id] = (phase, now)
        if self._tr_on():
            self._obs_open[req_id] = [
                phase, f"req:{req_id}", now,
                self._trace_attrs(req_id, attrs) or None]

    def _tr_end(self, req_id, **attrs) -> None:
        now = time.perf_counter()
        ph = self._req_phase.pop(req_id, None)
        if ph is not None:
            a = self._req_attr.setdefault(req_id, {})
            a[ph[0]] = a.get(ph[0], 0.0) + (now - ph[1])
        h = self._obs_open.pop(req_id, None)
        if h is not None:
            name, track, t0, sattrs = h
            if attrs:
                sattrs = dict(sattrs or (), **attrs)
            self.tracer.add(name, t0, now - t0, track=track, attrs=sattrs)

    def _tr_instant(self, req_id, name: str, **attrs) -> None:
        if self._tr_on():
            self.tracer.instant(name, track=f"req:{req_id}",
                                **self._trace_attrs(req_id, attrs))

    def _bump_attr(self, req_id, key: str, by: int = 1) -> None:
        """An occurrence count of the timing breakdown (preempts, chunks,
        drafted and accepted drafts)."""
        a = self._req_attr.setdefault(req_id, {})
        a[key] = a.get(key, 0) + by

    def _finish_timing(self, req_id) -> dict:
        """The request's `timing` breakdown: wall ms per phase (contiguous,
        so total_ms is the engine-side request time) and the nonzero
        occurrence counts."""
        self._req_phase.pop(req_id, None)
        a = self._req_attr.pop(req_id, {})
        ms = {k: round(a.get(p, 0.0) * 1e3, 3) for k, p in
              (("queue_ms", "queued"), ("prefill_ms", "prefill"),
               ("decode_ms", "decode"), ("replay_ms", "replay"))}
        ms["total_ms"] = round(sum(ms.values()), 3)
        for k, src in (("prefill_chunks", "chunks"),
                       ("preempts", "preempts"),
                       ("spec_drafted", "spec_drafted"),
                       ("spec_accepted", "spec_accepted")):
            if a.get(src):
                ms[k] = int(a[src])
        return ms

    def _engine_span(self, name: str, t0: float, **attrs) -> None:
        """One span on the `engine` lane from t0 to now (tracer enabled)."""
        self.tracer.add(name, t0, time.perf_counter() - t0, track="engine",
                        attrs=attrs)

    def _note_step_metrics(self, n_tokens: int, decoded: bool) -> None:
        """The step's scheduled rows, and the gap since the last step that
        advanced decode rows."""
        self.step_tokens_hist.observe(float(n_tokens))
        if decoded:
            now = time.perf_counter()
            if self._t_prev_decode is not None:
                self.decode_gap_hist.observe(
                    (now - self._t_prev_decode) * 1e3)
            self._t_prev_decode = now

    # -- public API -------------------------------------------------------
    def validate(self, req: Request) -> None:
        """Raise ValueError if `req` can never be served by this engine."""
        if req.max_new < 0:
            raise ValueError(
                f"request {req.req_id!r}: max_new {req.max_new} is negative")
        if req.max_new == 0:
            return                       # answered with the prompt as is
        p = req.prompt_ids.size
        cap = self.kv.capacity_tokens
        if p + req.max_new > cap:
            raise ValueError(
                f"request {req.req_id!r}: prompt {p} + max_new "
                f"{req.max_new} exceeds the {cap}-token slot capacity "
                f"(pages_per_slot * page_size) — raise max_context")
        # the completion bound: the last decode step writes position
        # p + max_new - 2, so a request that never meets eos needs pages
        # for p + max_new - 1 tokens; a smaller pool would preempt and
        # replay it forever once it is alone
        need = self.kv.pages_for(max(p + req.max_new - 1, p))
        if need > self.kv.num_pages - 1:
            raise ValueError(
                f"request {req.req_id!r} needs up to {need} pages to "
                f"complete but the pool holds {self.kv.num_pages - 1} — "
                f"raise num_pages")
        if int(req.prompt_ids.min()) < 0 or \
                int(req.prompt_ids.max()) >= self.vocab:
            raise ValueError(f"request {req.req_id!r}: prompt ids outside "
                             f"the vocabulary [0, {self.vocab})")

    def add_request(self, req: Request) -> None:
        """Enqueue; admission happens inside step()/run()."""
        self.validate(req)
        if req.trace:
            self._req_trace[req.req_id] = req.trace
        if req.max_new == 0:
            self._finish(req.req_id, req.prompt_ids.copy(), "length")
            return
        self._tr_begin(req.req_id, "queued",
                       prompt_len=int(req.prompt_ids.size),
                       max_new=req.max_new)
        self.flight.record("queued", req=str(req.req_id),
                           prompt_len=int(req.prompt_ids.size),
                           max_new=req.max_new)
        self.queue.append(req)

    def cancel(self, request_id, reason: str = "cancelled") -> bool:
        """End a queued or in-flight request now: its slot and pages return
        to the pool (its committed pages donated to the prefix index), and
        its tokens so far land in `results` with `reason`.  False when the
        id is unknown or already finished."""
        for i, r in enumerate(self.queue):
            if r.req_id == request_id:
                del self.queue[i]
                self._count_abort(reason)
                stash = r._preempted_gen or []
                # the preemption took these back on the promise of a
                # replay; they were emitted, so count them again
                self.tokens_generated += len(stash)
                self._finish(request_id, np.concatenate(
                    [r.prompt_ids, np.asarray(stash, np.int32)]), reason)
                return True
        for s, sl in enumerate(self.slots):
            if sl is not None and sl.req.req_id == request_id:
                gen = sl.generated
                stash = sl.req._preempted_gen or []
                if len(stash) > len(gen):
                    # mid-replay: report what was already emitted (the
                    # replay is a prefix of it) and count the rest again
                    self.tokens_generated += len(stash) - len(gen)
                    gen = stash
                toks = np.concatenate([sl.req.prompt_ids,
                                       np.asarray(gen, np.int32)])
                self._donate(s)
                self.kv.release(s)
                self.slots[s] = None
                self._count_abort(reason)
                self._finish(request_id, toks, reason)
                return True
        return False

    def set_decode_steps(self, decode_steps: int) -> None:
        """Multi-step decode: up to `decode_steps` tokens per slot in one
        window whenever the engine is pure-decode (1 = off).  Tokens are
        the same either way.  Only on an idle engine (a live slot's host
        state must be at a window boundary)."""
        self._require_idle("set_decode_steps")
        decode_steps = int(decode_steps)
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1 (1 = multi-step "
                             f"off), got {decode_steps}")
        self.decode_steps = decode_steps

    def set_chunking(self, prefill_chunk: Optional[int],
                     max_step_tokens: Optional[int] = None) -> None:
        """Prompts commit in chunks of up to `prefill_chunk` rows inside
        steps of at most `max_step_tokens` rows (default
        `_default_budget`: one chunk plus a full chain per slot); None
        prefills each prompt whole at admission (module docstring;
        max_step_tokens is then 0).  Only on an idle engine (a live slot
        may be mid-chunk)."""
        self._require_idle("set_chunking")
        if prefill_chunk is None:
            self.prefill_chunk = None
            self._set_budget(0)
            return
        prefill_chunk = int(prefill_chunk)
        if prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive, got "
                             f"{prefill_chunk}")
        prefill_chunk = min(prefill_chunk, self.kv.capacity_tokens)
        S = len(self.slots)
        self._mst_explicit = max_step_tokens is not None
        mst = self._default_budget(prefill_chunk) \
            if max_step_tokens is None else int(max_step_tokens)
        if mst <= S:
            raise ValueError(
                f"max_step_tokens {mst} must exceed num_slots {S}: every "
                f"decoding slot takes one row per step, and prefill chunks "
                f"need at least one row to make progress")
        self.prefill_chunk = prefill_chunk
        self._set_budget(mst)

    def _default_budget(self, prefill_chunk: int) -> int:
        """One chunk of prefill headroom plus a full chain per slot: chunk
        + S with speculation off, chunk + S * (spec_k + 1) with it on."""
        return prefill_chunk + len(self.slots) * (self.spec_k + 1)

    def _set_budget(self, mst: int) -> None:
        """The step's row budget and, from it, the engine's one
        paged-attention split count: a row's result depends on the count,
        so every launch of the engine takes the same one, or a token's bits
        would depend on which step type carried it — on the schedule, which
        the prefix cache, preemption and speculation change.  It is the
        plan of the engine's largest launch: the budget launch, or without
        chunking the verify step's S * (spec_k + 1) rows (S rows with
        speculation off) — the other launches are the cheaper ones to move
        off theirs.  Window graphs captured at another count are
        dropped."""
        self.max_step_tokens = mst
        S = len(self.slots)
        rows = mst if self.prefill_chunk is not None else \
            S * (self.spec_k + 1)
        splits = split_plan(rows, S + 1, self.kv.pages_per_slot,
                            self.kv.page_size)[0]
        if splits != self.splits:
            self._windows.clear()
        self.splits = splits

    def set_speculation(self, spec_k: int, drafter=None,
                        dynamic: Optional[bool] = None) -> None:
        """Speculative decode with up to `spec_k` drafts per decoding slot
        and step (0 = off), drafted by `drafter` (anything with
        `.propose(ctx, k)`; `propose_batch` is used where it exists), by
        default the prompt-lookup `NgramDrafter`.  `dynamic` turns the
        per-slot accept-rate depth policy on or off (None keeps it).  A
        defaulted budget follows the depth.  Tokens are the same either
        way.  Only on an idle engine."""
        self._require_idle("set_speculation")
        spec_k = int(spec_k)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0 (0 = speculation off), "
                             f"got {spec_k}")
        self.spec_k = spec_k
        if dynamic is not None:
            self.spec_dynamic = bool(dynamic)
        if self.prefill_chunk is None:
            self._set_budget(0)             # the split count follows spec_k
        elif not self._mst_explicit:
            self._set_budget(self._default_budget(self.prefill_chunk))
        if drafter is not None:
            self.drafter = drafter
        elif self.drafter is None and spec_k > 0:
            self.drafter = NgramDrafter()
        # drafters whose propose takes no eos_id get no eos clamp request
        self._drafter_takes_eos = False
        if self.drafter is not None and \
                not hasattr(self.drafter, "propose_batch"):
            try:
                self._drafter_takes_eos = "eos_id" in \
                    inspect.signature(self.drafter.propose).parameters
            except (TypeError, ValueError):
                self._drafter_takes_eos = False

    @property
    def drafter_kind(self) -> Optional[str]:
        """The drafter's declared kind ("ngram", "model", ...) or None."""
        return getattr(self.drafter, "kind", None) \
            if self.drafter is not None else None

    @property
    def spec_accept_rate(self) -> float:
        """Accepted / drafted over the engine's life (0.0 before any draft
        was scored)."""
        return (self.n_spec_accepted / self.n_spec_drafted
                if self.n_spec_drafted else 0.0)

    def set_decode_mode(self, mode: str) -> None:
        """The step dispatch policy: "auto" lets a draft-free pure-decode
        step run a window while speculation is on; "static" keeps windows
        off whenever spec_k > 0.  Tokens are the same either way.  Only on
        an idle engine."""
        self._require_idle("set_decode_mode")
        if mode not in ("auto", "static"):
            raise ValueError(f"decode_mode must be 'auto' or 'static', got "
                             f"{mode!r}")
        self.decode_mode = mode

    def set_prefix_cache(self, enabled: bool) -> None:
        """Attach a fresh empty prefix index, or detach and empty it: every
        node's page drops its retention (pages live slots map stay with
        them), and spilled nodes drain the host tier."""
        if enabled == (self.prefix is not None):
            return
        if enabled:
            self.prefix = PrefixTree(self.kv)
            self.kv.on_page_pressure = self.prefix.evict_for
            return
        stack = list(self.prefix.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.host_id is not None:
                self.kv.drop_host_page(node.host_id, reason="drain")
                node.host_id = None
            else:
                self.kv.uncache_page(node.page)
        self.prefix = None
        self.kv.on_page_pressure = None

    def set_spill_budget(self, spill_bytes_budget: int) -> None:
        """The host tier's byte budget (0 = off).  Shrinking it below what
        the tier holds drops least recently used HOST leaves until it
        fits; device state is never touched.  Only on an idle engine."""
        self._require_idle("set_spill_budget")
        self.kv.spill_bytes_budget = int(spill_bytes_budget or 0)
        while self.prefix is not None and \
                self.kv.host_bytes > self.kv.spill_bytes_budget:
            leaves = self.prefix._host_leaves()
            assert leaves, "host tier non-empty but no HOST leaf found"
            self.prefix._drop_host_node(
                min(leaves, key=lambda n: n.last_use))

    def reset_prefix_cache(self) -> None:
        """Cold start of an idle engine's allocator: every mapping and all
        prefix retention dropped, the host tier drained, the free list in
        canonical order, the index empty — page placement afterwards
        equals a fresh engine's."""
        self._require_idle("reset_prefix_cache")
        self.kv.reset()
        if self.prefix is not None:
            self.prefix.clear()

    def export_prefix(self, tokens):
        """The longest DEVICE-resident whole-page cached prefix of
        `tokens`, serialized for another engine: (covered tokens, meta,
        payload), or None when nothing is cached.  Between steps only."""
        if self.prefix is None:
            return None
        toks = np.asarray(tokens, np.int32).reshape(-1)
        pages, _ = self.prefix.match(toks)
        if not pages:
            return None
        n_tok = len(pages) * self.kv.page_size
        meta, payload = self.kv.export_pages(pages)
        return toks[:n_tok], meta, payload

    def import_prefix(self, tokens, meta: dict, payload: bytes) -> int:
        """Mount an export_prefix blob into the prefix index: take fresh
        pages, write the payload into them in place, adopt and insert them,
        so the next admission of the prompt is a prefix hit.  Raises
        ValueError, the allocator rolled back exactly, on a malformed blob
        or a dry pool; returns the nodes added.  Between steps only."""
        if self.prefix is None:
            raise ValueError("kv import: prefix cache is disabled")
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n = int(meta.get("n_pages", 0))
        ps = self.kv.page_size
        if n <= 0 or toks.size != n * ps:
            raise ValueError(
                f"kv import: {toks.size} tokens do not cover "
                f"{n} pages x {ps}")
        pages = self.kv.take_pages(n)
        if pages is None:
            raise ValueError(
                f"kv import: pool cannot cover {n} fresh pages")
        try:
            self.kv.import_pages(meta, payload, pages)
        except (ValueError, AssertionError):
            self.kv.untake_pages(pages)
            raise
        self.kv.adopt_restored(pages)
        added = self.prefix.insert(toks, pages, adopted=True)
        self.n_kv_mounts += 1
        self.kv_pages_mounted += n
        self.flight.record("kv_recv", pages=n, mounted=added)
        return added

    def step(self) -> bool:
        """One scheduler iteration: sweep deadlines -> admit -> one step
        over all slots -> retire.  Returns False when idle (nothing in
        flight and nothing admittable)."""
        self._sweep_deadlines()
        self._admit_from_queue()
        live = [s for s, sl in enumerate(self.slots) if sl is not None]
        if not live:
            self._t_prev_decode = None      # idle: no gap to charge
            return False
        while True:
            # decoding slots need their next page; filling slots had their
            # prompt's pages reserved at admission
            decoding = [s for s in live if self.slots[s].gen > 0]
            filling = [s for s in live if self.slots[s].gen == 0]
            runnable = [s for s in decoding
                        if self.kv.try_grow(s, self.slots[s].pos + 1)]
            # chunk-only steps count as progress only while nothing
            # decodes: page-starved decoders must not wait behind a
            # filler's remaining chunks
            if runnable or (filling and not decoding):
                break
            # wedged: preempt the youngest slot (usually the filler holding
            # its reserved pages)
            victim = max(live, key=lambda s: self.slots[s].admit_seq)
            self._preempt(victim)
            live.remove(victim)
            if not live:
                return True            # pages freed; the next step admits
        if self.spec_k > 0:
            # drafts, or prompt chunks, go to the verify step; a draft-free
            # pure-decode step takes the window ("auto") or the k = 1 step
            drafts = self._propose_drafts(runnable)
            if drafts or filling:
                self._run_spec_step(live, runnable, filling, drafts)
                return True
        elif filling:
            # an admission never waits behind a window: mixed load runs the
            # k = 1 mixed step
            self._run_mixed_step(live, runnable, filling)
            return True
        if self.decode_steps > 1 and (self.spec_k == 0 or
                                      self.decode_mode == "auto") \
                and self._scan_window_ok(runnable, self.decode_steps):
            self._run_scan_step(live, runnable, self.decode_steps)
        else:
            self._run_decode_step(live, runnable)
        return True

    def run(self, requests=()) -> dict:
        """Add `requests`, drive step() to completion, and pop
        {req_id: np.int32 prompt + generated tokens} (and their finish
        reasons) for everything that completed during this call."""
        done_before = set(self.results)
        for r in requests:
            self.add_request(r)
        while self.step():
            pass
        out = {k: self.results.pop(k) for k in list(self.results)
               if k not in done_before}
        for k in out:
            self.finish_reasons.pop(k, None)
            self.finish_timing.pop(k, None)
        return out

    # -- checkpoints ------------------------------------------------------
    def _config(self) -> dict:
        """What a checkpoint must match (decode_steps, decode_mode and the
        drafter are left out: a snapshot resumes under any of them)."""
        kv = self.kv
        some = next(iter(kv.pools.values()))["k"]
        return {"num_slots": len(self.slots), "page_size": kv.page_size,
                "pages_per_slot": kv.pages_per_slot,
                "num_pages": kv.num_pages,
                "prefill_chunk": self.prefill_chunk,
                "max_step_tokens": self.max_step_tokens,
                "spec_k": self.spec_k,
                "prefix_cache": self.prefix is not None,
                "spill_bytes_budget": kv.spill_bytes_budget,
                "layer_specs": dict(kv.layer_specs),
                "dtype": str(some.dtype)}

    def checkpoint_state(self) -> dict:
        """The whole serving state between steps, as one picklable dict:
        the pools as host copies, the allocator (table, refcounts, cached
        marks, free-list order), the host tier's pages, the prefix index
        with its LRU clock and host nodes, the slots, the queue (each
        request with its preempted stash), the counters and the
        uncollected results.  A fresh engine of the same
        configuration restored from it finishes bit for bit what this one
        would (a window is atomic inside step(), so there is no mid-window
        state)."""
        kv = self.kv
        return {
            "config": self._config(),
            "pools": {name: {p: t.detach().to("cpu", copy=True)
                             for p, t in pool.items()}
                      for name, pool in kv.pools.items()},
            "kv": {"table": kv.table.copy(), "free": list(kv._free),
                   "n_pages": kv._n_pages.copy(), "ref": kv._ref.copy(),
                   "cached": kv._cached.copy(), "n_cow": kv.n_cow,
                   # the host tier goes into the snapshot (a migrated
                   # engine keeps its whole cache); generations re-stamp
                   # on restore
                   "host": {hid: {"nbytes": e["nbytes"],
                                  "flat": e["flat"].clone()}
                            for hid, e in kv._host.items()},
                   "next_hid": kv._next_hid,
                   "spill_counters": (kv.n_spilled, kv.n_restored,
                                      kv.n_host_evicted,
                                      kv._host_drained)},
            "slots": [None if sl is None else
                      {"req": sl.req.snapshot(), "pos": sl.pos,
                       "gen": sl.gen, "last_tok": sl.last_tok,
                       "generated": list(sl.generated),
                       "admit_seq": sl.admit_seq,
                       "replay_until": sl.replay_until,
                       # a restored slot keeps its learned draft depth
                       "accept_ewma": sl.accept_ewma,
                       "probe_tick": sl.probe_tick}
                      for sl in self.slots],
            "queue": [r.snapshot() for r in self.queue],
            "prefix": None if self.prefix is None else self.prefix.snapshot(),
            "counters": {k: getattr(self, k) for k in _COUNTERS},
            "results": {k: np.asarray(v).copy()
                        for k, v in self.results.items()},
            "finish_reasons": dict(self.finish_reasons),
        }

    def restore_state(self, snap: dict) -> None:
        """Resume a `checkpoint_state()` snapshot on this engine, which
        must be idle and of the same configuration (ValueError otherwise:
        a mismatch would corrupt the page accounting).  The pools are
        written in place, so window graphs stay valid.  Host-tier entries
        take this engine's generation; each live request's current phase
        reopens now (the donor's clock does not carry over)."""
        mine = self._config()
        if snap["config"] != mine:
            diff = {k: (snap["config"].get(k), mine[k]) for k in mine
                    if snap["config"].get(k) != mine[k]}
            raise ValueError(f"restore_state: engine configuration mismatch "
                             f"(snapshot vs this engine): {diff}")
        if any(sl is not None for sl in self.slots) or self.queue:
            raise ValueError("restore_state requires an idle engine — it "
                             "replaces every slot and queue entry")
        kv = self.kv
        for name, pool in kv.pools.items():
            for p, t in pool.items():
                t.copy_(snap["pools"][name][p])
        kv.table[:, :] = snap["kv"]["table"]
        kv._free = list(snap["kv"]["free"])
        kv._n_pages[:] = snap["kv"]["n_pages"]
        kv._ref[:] = snap["kv"]["ref"]
        kv._cached[:] = snap["kv"]["cached"]
        kv.n_cow = snap["kv"]["n_cow"]
        if self.prefix is not None:
            self.prefix.clear()             # drains the old tree's entries
        kv._host_drained += len(kv._host)
        kv._host = {int(hid): {"gen": kv._host_gen,
                               "nbytes": int(e["nbytes"]),
                               "flat": e["flat"].clone()}
                    for hid, e in snap["kv"]["host"].items()}
        kv._host_bytes = sum(e["nbytes"] for e in kv._host.values())
        kv._next_hid = int(snap["kv"]["next_hid"])
        (kv.n_spilled, kv.n_restored, kv.n_host_evicted,
         kv._host_drained) = snap["kv"]["spill_counters"]
        kv.version += 1
        self.slots = [None] * len(self.slots)
        for s, d in enumerate(snap["slots"]):
            if d is None:
                continue
            sl = self._occupy(s, _Slot(Request.from_snapshot(d["req"]),
                                       d["admit_seq"], d["pos"]))
            sl.gen, sl.last_tok = d["gen"], d["last_tok"]
            sl.generated = list(d["generated"])
            sl.replay_until = d["replay_until"]
            sl.accept_ewma, sl.probe_tick = d["accept_ewma"], d["probe_tick"]
        self.queue = deque(Request.from_snapshot(d) for d in snap["queue"])
        if self.prefix is not None:
            self.prefix.restore(snap["prefix"])
        for k, v in snap["counters"].items():
            setattr(self, k, v)
        self.results = {k: np.asarray(v).copy()
                        for k, v in snap["results"].items()}
        self.finish_reasons = dict(snap["finish_reasons"])
        self._t_prev_decode = None
        now = time.perf_counter()
        self._req_phase, self._req_attr, self._req_trace = {}, {}, {}
        for r in self.queue:
            self._req_phase[r.req_id] = ("queued", now)
            if r.trace:
                self._req_trace[r.req_id] = r.trace
        for sl in self.slots:
            if sl is None:
                continue
            phase = ("prefill" if sl.gen == 0 else
                     "replay" if sl.replay_until and
                     sl.gen < sl.replay_until else "decode")
            self._req_phase[sl.req.req_id] = (phase, now)
            if sl.req.trace:
                self._req_trace[sl.req.req_id] = sl.req.trace
        kv.check()
        self.flight.record("restore", slots=sum(
            1 for sl in self.slots if sl is not None),
            queued=len(self.queue))

    def save_state(self, path: str) -> None:
        """checkpoint_state() to `path`, written to a temporary file,
        synced and renamed over it, so a crash leaves the previous file
        whole."""
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.checkpoint_state(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load_state(self, path: str) -> None:
        """restore_state() from a file save_state() wrote."""
        with open(path, "rb") as f:
            self.restore_state(pickle.load(f))

    # -- scheduling -------------------------------------------------------
    def _require_idle(self, what: str) -> None:
        if any(sl is not None for sl in self.slots) or self.queue:
            raise RuntimeError(f"{what} requires an idle engine")

    def _count_abort(self, reason: str) -> None:
        if reason == "deadline":
            self.n_expired += 1
        else:
            self.n_cancelled += 1

    def _sweep_deadlines(self) -> None:
        """Expire every queued or in-flight request whose deadline passed
        on the engine clock — before admission, so an expired request
        never takes a slot and its pages serve this step's admissions."""
        now = self.clock()
        expired = [r.req_id for r in self.queue
                   if r.deadline is not None and r.deadline <= now]
        expired += [sl.req.req_id for sl in self.slots
                    if sl is not None and sl.req.deadline is not None
                    and sl.req.deadline <= now]
        for rid in expired:
            self.cancel(rid, reason="deadline")

    def _admit_from_queue(self) -> None:
        """FIFO admission into free slots; a page-starved queue head waits
        (its reservation already rolled the slot back to empty)."""
        for s in range(len(self.slots)):
            if not self.queue:
                return
            if self.slots[s] is not None:
                continue
            req = self.queue[0]
            res = self._reserve(s, req)
            if res is None:
                return
            self.queue.popleft()
            if self.prefill_chunk is None:
                self._admit(s, req, *res)
            else:
                self._admit_chunked(s, req, *res)

    def bucket_for(self, prompt_len: int) -> int:
        """The whole-prompt prefill's padded length for a prompt: the
        feeder's bucket (data/feeder.py `_bucket_len`) rounded up to whole
        pages, at most the slot capacity — one prefill shape per bucket."""
        ps = self.kv.page_size
        return min(-(-_bucket_len(int(prompt_len)) // ps) * ps,
                   self.kv.capacity_tokens)

    def _reserve(self, s: int, req: Request) -> Optional[tuple[int, int]]:
        """Map the cached prefix of `req`'s prompt into empty slot `s` and
        reserve pages for the whole prompt; returns (matched tokens C,
        mapped pages), or None when the pool is dry (the slot rolled back
        to empty).

        The walk stops at the prompt's last token but one: token 0 needs
        the last prompt position's logits.  A partially matched boundary
        page is copied only after the suffix's pages are secured, so a
        starved retry pays no copy.  A reservation that cannot complete
        with the prefix mapped rolls back and tries cold: the unmapped
        prefix pages drop to refcount 0, and the cold attempt's eviction
        may take them.

        A matched path that ends in spilled (HOST) runs is restored first
        (`_restore_spilled`); a restore that cannot complete rolls back
        and the admission goes cold."""
        p = req.prompt_ids.size
        if self.prefix is not None:
            nodes, partial = self.prefix.match_nodes(req.prompt_ids[:p - 1])
            path = list(nodes) + ([partial[0]] if partial is not None
                                  else [])
            host_tail = [nd for nd in path if nd.host_id is not None]
            if host_tail and not self._restore_spilled(req, path, host_tail):
                path, partial = [], None        # rolled back: admit cold
            if path:
                mapped = [nd.page for nd in path]
                self.kv.map_shared(s, mapped)
                C = len(nodes) * self.kv.page_size + \
                    (partial[1] if partial is not None else 0)
                ok = self.kv.try_grow(s, p)
                if ok and partial is not None:
                    cow = self.kv.ensure_writable(s, len(mapped) - 1)
                    ok = cow is not None
                    if cow:
                        self.flight.record("prefix_cow",
                                           req=str(req.req_id),
                                           page=int(mapped[-1]),
                                           matched_in_page=int(partial[1]))
                if ok:
                    if host_tail:
                        # the tokens of C served from restored pages: all
                        # but the device-resident whole runs
                        self.n_restore_hits += 1
                        dev_full = sum(1 for nd in nodes
                                       if nd not in host_tail)
                        self.restore_tokens_saved += \
                            C - dev_full * self.kv.page_size
                    return C, len(mapped)
                self.kv.release(s)
        if self.kv.try_grow(s, p):
            return 0, 0
        self.kv.release(s)
        return None

    def _restore_spilled(self, req: Request, path, host_tail) -> bool:
        """Bring a matched path's spilled tail back to the device: take
        fresh pages with spilling inhibited (so the host entries being
        restored stay put under the allocation's own pressure evictions),
        scatter the host copies into them in place, re-mark them cached
        and promote their nodes.  False after a full rollback: an entry of
        a dead generation (its subtree dropped), a dry pool, or a matched
        device node the allocation evicted."""
        kv, tree = self.kv, self.prefix
        if not all(kv.host_entry_live(nd.host_id) for nd in host_tail):
            tree.drop_host_subtree(host_tail[0])
            return False
        dev_nodes = [nd for nd in path if nd.host_id is None]
        tree._spill_inhibit = True
        try:
            pages = kv.take_pages(len(host_tail))
        finally:
            tree._spill_inhibit = False
        if pages is None:
            return False
        if any(nd.page <= 0 or nd.host_id is not None
               for nd in dev_nodes) or \
                not all(kv.host_entry_live(nd.host_id)
                        for nd in host_tail):
            kv.untake_pages(pages)
            return False
        kv.restore_pages([nd.host_id for nd in host_tail], pages)
        kv.adopt_restored(pages)
        tree.promote(host_tail, pages)
        self.flight.record("restore", req=str(req.req_id),
                           pages=len(pages),
                           host_pages=kv.host_page_count)
        return True

    def _count_prefix(self, req: Request, C: int, n_pp: int, p: int) -> None:
        """An admission's prefix-index hit (C matched tokens over n_pp
        pages) or miss."""
        if self.prefix is None:
            return
        if C > 0:
            self.n_prefix_hits += 1
            self.prefill_tokens_saved += C
            self._tr_instant(req.req_id, "prefix_hit", n_pages=n_pp,
                             tokens=C)
            self.flight.record("prefix_hit", req=str(req.req_id),
                               pages=n_pp, tokens=C, suffix=p - C)
        else:
            self.n_prefix_misses += 1
            self.flight.record("prefix_miss", req=str(req.req_id),
                               prompt_len=int(p))

    def _admit_chunked(self, s: int, req: Request, C: int,
                       n_pp: int) -> None:
        """The slot enters prefill mode with its prompt's pages reserved
        and its chunk cursor at C, past the cached prefix; the prompt
        commits in chunk rows inside the next mixed steps."""
        self._tr_end(req.req_id)                       # queued ends here
        p = req.prompt_ids.size
        self._count_prefix(req, C, n_pp, p)
        self._admit_seq += 1
        self._occupy(s, _Slot(req, self._admit_seq, pos=C))
        self._tr_begin(req.req_id, "prefill",
                       chunk=int(self.prefill_chunk), prompt_len=p,
                       prefix_tokens=C)
        self.flight.record("admit", req=str(req.req_id), slot=s,
                           prompt_len=p, chunk=int(self.prefill_chunk),
                           prefix_tokens=C,
                           pages=int(self.kv.pages_for(p)))

    def _admit(self, s: int, req: Request, C: int, n_pp: int) -> None:
        """The whole-prompt admission: prefill the prompt — on a prefix hit
        only its suffix past the C tokens mapped across the slot's first
        n_pp pages — at a bucket length, write its K/V into the slot's
        pages, sample token 0 from the last prompt position with
        generation 0's noise and emit it (`_emit_first`)."""
        self._tr_end(req.req_id)                       # queued ends here
        p = req.prompt_ids.size
        self._count_prefix(req, C, n_pp, p)
        if C > 0:
            ps = self.kv.page_size
            Lb = min(-(-_bucket_len(p - C) // ps) * ps,
                     self.kv.capacity_tokens - C)
            self._tr_begin(req.req_id, "prefill", bucket=Lb,
                           prefix_tokens=C)
            last, kv_new = self._prefill_suffix(s, req.prompt_ids[C:], Lb,
                                                C, n_pp)
        else:
            Lb = self.bucket_for(p)
            self._tr_begin(req.req_id, "prefill", bucket=Lb)
            last, kv_new = self._prefill_prompt(req.prompt_ids, Lb)
        noise = None
        if req.temperature > 0.0 and self.noise is not None:
            noise = self.noise(req, 0, self.vocab, self.device)[None]
        elif req.temperature > 0.0:
            # generation 0 of the slot's key, staged here ahead of _occupy
            self._d_keys[s].copy_(req.rng)
            noise = self._draw_noise(
                np.zeros((len(self.slots), 1), np.int64))[s]
        tok0 = int(pick_next(last, noise, req.temperature, req.top_k,
                             req.top_p, is_probs=self._probs)[0])
        self._pack(s, kv_new, C, p)
        self._admit_seq += 1
        self._occupy(s, _Slot(req, self._admit_seq, pos=p))
        self.flight.record("admit", req=str(req.req_id), slot=s,
                           bucket=Lb, prompt_len=p,
                           pages=int(self.kv.pages_for(p)))
        self._emit_first(s, tok0)

    def _prefill_prompt(self, prompt: np.ndarray, Lb: int):
        """The prompt padded to Lb tokens through the model on a fresh
        [1, Lb] dense cache: (the last prompt position's logits [1, V],
        {layer: (k, v) [1, Lb, H_kv, D]})."""
        n = prompt.size
        ids = np.zeros((1, Lb), np.int64)
        ids[0, :n] = prompt
        with get_compile_watch().observe("serving.prefill", ids):
            state = init_kv_caches(self.executor, 1, Lb, self.device)
            return self._prefill_forward(ids, n, state, 0)

    def _prefill_suffix(self, s: int, suffix: np.ndarray, Lb: int, C: int,
                        n_pp: int):
        """A prefix hit's suffix padded to Lb tokens, continued from
        position C of a dense cache seeded with the slot's first n_pp
        pages (positions C..n_pp * page_size - 1 of it hold the boundary
        page's tokens past the match: the suffix's writes replace them
        before any read, and causality keeps the queries off the rest):
        (the last suffix position's logits [1, V], {layer: (k, v) of
        positions C..C + Lb - 1})."""
        n = suffix.size
        ids = np.zeros((1, Lb), np.int64)
        ids[0, :n] = suffix
        Cpad = n_pp * self.kv.page_size
        ctx_pages = self.kv.table[s, :n_pp].astype(np.int64)
        with get_compile_watch().observe("serving.prefix_prefill",
                                         ctx_pages, ids):
            ctx_pages = self._to_device(ctx_pages)
            state = init_kv_caches(self.executor, 1, Cpad + Lb, self.device)
            for name, st in state.items():
                pool = self.kv.pools[name]
                for part in ("k", "v"):
                    st[part][0, :Cpad] = pool[part][ctx_pages].reshape(
                        Cpad, *pool[part].shape[2:])
                st["pos"].fill_(C)
                st["cont"] = True
            return self._prefill_forward(ids, n, state, C)

    def _prefill_forward(self, ids: np.ndarray, n: int, state: dict,
                         start: int):
        """One eager forward of the padded tokens `ids` [1, Lb] (n valid)
        on the dense caches `state`; returns the logits at position n - 1
        and each layer's K/V at cache positions start..start + Lb - 1."""
        Lb = ids.shape[1]
        feed = {self.input_name: Argument(
            ids=self._to_device(ids),
            lengths=torch.full((1,), n, dtype=torch.int32,
                               device=self.device))}
        outputs, _, state = self.executor.forward(self.params, feed, state,
                                                  TEST)
        last = outputs[self.logits_name].value[:, n - 1]
        return last, {name: (st["k"][0, start:start + Lb],
                             st["v"][0, start:start + Lb])
                      for name, st in state.items()}

    def _pack(self, s: int, kv_new: dict, C: int, p: int) -> None:
        """Write a prefill's K/V (cache positions C.. of its prompt, padding
        included) into slot `s`'s pages: every position from C up to the
        end of the prompt's last page (padded tokens past the prompt land
        in that page's tail, overwritten before any read), the positions
        in pages the slot does not map dropped (the reference sends them to
        trash page 0)."""
        ps = self.kv.page_size
        Lb = next(iter(kv_new.values()))[0].shape[0]
        t = np.arange(C, min(C + Lb, self.kv.pages_for(p) * ps))
        self._writable(s, int(t[0]), int(t[-1]))
        # the reference's sites: a cold prompt's pack (by bucket) and a
        # prefix hit's offset pack of its suffix (by suffix bucket)
        with get_compile_watch().observe(
                "serving.prefix_pack" if C > 0 else "serving.pack", Lb):
            phys = self._to_device(self.kv.table[s, t // ps].astype(
                np.int64))
            off = self._to_device((t % ps).astype(np.int64))
            for name, (k, v) in kv_new.items():
                pool = self.kv.pools[name]
                pool["k"].index_put_((phys, off),
                                     k[:t.size].to(pool["k"].dtype))
                pool["v"].index_put_((phys, off),
                                     v[:t.size].to(pool["v"].dtype))

    def _preempt(self, s: int) -> None:
        """Requeue slot `s`'s request at the queue front: its committed
        pages go to the prefix index (its replay hits them), the rest
        free; its tokens are taken back until the replay emits them
        again."""
        sl = self.slots[s]
        rid = sl.req.req_id
        self._tr_end(rid, tokens=sl.gen)          # decode/replay ends here
        self._tr_instant(rid, "preempt")
        self._tr_begin(rid, "queued", requeued=True)
        self.queue.appendleft(sl.req)
        if len(sl.generated) >= len(sl.req._preempted_gen or []):
            sl.req._preempted_gen = list(sl.generated)
        self.tokens_generated -= sl.gen
        self._bump_attr(rid, "preempts")
        self.n_preemptions += 1
        self.flight.record("preempt", req=str(rid), slot=s, tokens=sl.gen,
                           free_pages=int(self.kv.free_page_count))
        self._donate(s)
        self.kv.release(s)
        self.slots[s] = None

    def _donate(self, s: int) -> None:
        """Offer slot `s`'s whole pages strictly below `pos` (every
        position in them committed) to the prefix index; the boundary page
        stays private and frees with the release that follows."""
        if self.prefix is None:
            return
        sl = self.slots[s]
        full = int(sl.pos) // self.kv.page_size
        if full <= 0:
            return
        seq = np.concatenate([sl.req.prompt_ids,
                              np.asarray(sl.generated, np.int32)])
        self.prefix.insert(seq[:full * self.kv.page_size],
                           [int(self.kv.table[s, j]) for j in range(full)])

    def _writable(self, s: int, first: int, last: int) -> None:
        """Tripwire: the pages holding positions first..last of slot `s`
        are private (admission's copy-on-write guarantees it; a refcount
        fault would otherwise corrupt a cached prefix)."""
        ps = self.kv.page_size
        for j in range(first // ps, last // ps + 1):
            assert self.kv.page_writable(int(self.kv.table[s, j])), \
                f"slot {s} would write shared page {int(self.kv.table[s, j])}"

    def _sync_table(self) -> torch.Tensor:
        """The device page table [S+1, pages_per_slot] — row S is the
        all-zero row padding rows address — copied into its one buffer
        only when a host table write moved kv.version."""
        if self.kv.version != self._table_version:
            self._d_table[:-1].copy_(self._host(self.kv.table),
                                     non_blocking=True)
            self._table_version = self.kv.version
        return self._d_table

    def _host(self, a) -> torch.Tensor:
        """A host array (or CPU tensor) as the source of a copy to the
        engine's device that does not wait for the stream: on the card a
        pinned copy of it (the caching host allocator keeps the block until
        the transfer has run, and the transfer is ordered on the stream
        like the kernels), elsewhere the array itself."""
        t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return self._host(a).to(self.device, non_blocking=True)

    def _draw_noise(self, gens: np.ndarray) -> torch.Tensor:
        """[S, K] generation counts -> the [S, K, V] Gumbel noise of each
        slot's key of those generations, drawn on the device from the
        staged keys.  On the card one replay of a graph per K (the draw is
        ~280 small kernels, which eager launches would pay on the host every
        sampling step); the result is the graph's and is overwritten by its
        next replay."""
        if self.device.type != "cuda":
            return slot_noise(prng.fold_in(self._d_keys[:, None],
                                           self._to_device(gens)), self.vocab)
        K = gens.shape[1]
        draw = self._noise_draws.get(K)
        if draw is None:
            buf = torch.zeros(gens.shape, dtype=torch.int64,
                              device=self.device)
            graph = StepGraph(new_pool(self.device))
            out = graph.capture(lambda: slot_noise(
                prng.fold_in(self._d_keys[:, None], buf), self.vocab))
            draw = self._noise_draws[K] = (buf, graph, out)
        buf, graph, out = draw
        buf.copy_(self._host(gens), non_blocking=True)
        graph.replay()
        return out

    def _occupy(self, s: int, slot: _Slot) -> _Slot:
        """Slot `s` takes `slot`; its request key goes into the device key
        buffer."""
        self.slots[s] = slot
        self._d_keys[s].copy_(slot.req.rng)
        return slot

    def _sample(self, scores: torch.Tensor, emitting: list[int],
                depth: Optional[dict] = None) -> np.ndarray:
        """Sample each slot's chain of scores [S, K, V] -> [S, K] tokens;
        only the emitting slots' knobs (and noise) are used, the other rows
        are discarded.  Chain position i of a sampling slot samples with
        the noise of its generation gen + i (clipped to max_new - 1, as the
        JAX verify step clips it), drawn on the device from the staged
        keys; a `noise` hook's rows are filled for i up to `depth[s]` (0
        without it), later positions are never read."""
        S, K, V = scores.shape
        temp = np.zeros(S, np.float32)
        top_k = np.zeros(S, np.int64)
        top_p = np.zeros(S, np.float32)
        noise = None
        for s in emitting:
            req = self.slots[s].req
            temp[s], top_k[s], top_p[s] = req.temperature, req.top_k, \
                req.top_p
        sampling = [s for s in emitting if temp[s] > 0.0]
        if sampling and self.noise is not None:
            noise = torch.zeros((S, K, V), dtype=torch.float32,
                                device=self.device)
            for s in sampling:
                sl = self.slots[s]
                for i in range((depth or {}).get(s, 0) + 1):
                    noise[s, i] = self.noise(sl.req, sl.gen + i, V,
                                             self.device)
        elif sampling:
            gens = np.zeros((S, K), np.int64)
            for s in sampling:
                sl = self.slots[s]
                gens[s] = np.minimum(sl.gen + np.arange(K),
                                     sl.req.max_new - 1)
            noise = self._draw_noise(gens)
        nxt = pick_next_chain(scores, noise, self._to_device(temp),
                              self._to_device(top_k), self._to_device(top_p),
                              is_probs=self._probs,
                              any_sampling=bool(sampling))
        return nxt.cpu().numpy()

    def _run_decode_step(self, live, runnable) -> None:
        """The [S, 1] decode step over the running slots.  Every live slot
        feeds its last token at its own position: a paused slot's page
        there is unmapped, so its write lands in trash page 0 (as do empty
        slots' writes at position 0 of their all-zero table rows)."""
        traced = self._tr_on()
        t_step = time.perf_counter() if traced else 0.0
        S = len(self.slots)
        toks = np.zeros((S, 1), np.int64)
        pos = np.zeros(S, np.int32)
        for s, sl in enumerate(self.slots):
            if sl is not None:
                toks[s, 0], pos[s] = sl.last_tok, sl.pos
        for s in runnable:
            self._writable(s, pos[s], pos[s])
        table = self._sync_table()[:S]
        d_pos = self._to_device(pos)
        state = {name: {"k_pages": p["k"], "v_pages": p["v"],
                        "page_table": table, "pos": d_pos,
                        "splits": self.splits}
                 for name, p in self.kv.pools.items()}
        feed = {self.input_name: Argument(
            ids=self._to_device(toks),
            lengths=torch.ones(S, dtype=torch.int32, device=self.device))}
        with get_compile_watch().observe("serving.decode_step", toks, pos,
                                         self.splits):
            outputs, _, _ = self.executor.forward(self.params, feed, state,
                                                  TEST)
            nxt = self._sample(outputs[self.logits_name].value,
                               runnable)[:, 0]
        self.n_decode_steps += 1
        self.occupancy_sum += len(live) / S
        self._note_step_metrics(len(runnable), decoded=True)
        if traced:
            self._engine_span("decode_step", t_step, live=len(live),
                              step=self.n_decode_steps)
        for s in runnable:
            self._bank_token(s, int(nxt[s]))

    def _scan_window_ok(self, runnable, k: int) -> bool:
        """Pages for one window: every runnable slot gets pages up to pos +
        min(k, tokens it may still emit).  False (the caller runs the k = 1
        step) when the pool runs dry; pages taken stay with the slot."""
        ok = True
        for s in runnable:
            sl = self.slots[s]
            if not self.kv.try_grow(s, sl.pos + min(k, sl.req.max_new
                                                    - sl.gen)):
                ok = False
        return ok

    def _run_scan_step(self, live, runnable, k: int) -> None:
        """One window of k decode bodies (module docstring): stage the
        slots' state and noise, run or replay the window, read the [k, S]
        token block once, bank each running slot's column up to its
        eos/max_new.  A paused slot is staged at its own position with the
        run mask off, so its frozen writes land in trash page 0."""
        traced = self._tr_on()
        t_step = time.perf_counter() if traced else 0.0
        S = len(self.slots)
        win = self._windows.get(k)
        if win is None:
            win = self._windows[k] = _Window(self, k)
        ints = np.zeros((7, S), np.int64)       # tok pos gen run eos max topk
        floats = np.zeros((2, S), np.float32)   # temperature, top_p
        sampling = []
        for s, sl in enumerate(self.slots):
            if sl is None:
                continue
            req = sl.req
            run = s in runnable
            ints[:, s] = (sl.last_tok, sl.pos, sl.gen, run, req.eos_id,
                          req.max_new, req.top_k)
            floats[:, s] = (req.temperature, req.top_p)
            if run:
                self._writable(s, sl.pos, sl.pos + min(k, req.max_new
                                                       - sl.gen) - 1)
                if req.temperature > 0.0:
                    sampling.append(s)
        self._sync_table()
        win.ints.copy_(self._host(ints), non_blocking=True)
        win.floats.copy_(self._host(floats), non_blocking=True)
        if self.noise is not None:
            for s in sampling:
                sl = self.slots[s]
                for i in range(min(k, sl.req.max_new - sl.gen)):
                    win.noise[i, s] = self.noise(sl.req, sl.gen + i,
                                                 self.vocab, self.device)
        sampled = bool(sampling)
        cw = get_compile_watch()
        sig = (k, win.ints, self.splits)
        if self.device.type != "cuda" or sampled not in win.graphs:
            # the CPU's mode, and a variant's first window on the card,
            # after which the variant is captured
            with cw.observe("serving.scan_step", *sig):
                win.body(sampled)
            if self.device.type == "cuda":
                win.graphs[sampled] = None
        else:
            if win.graphs[sampled] is None:
                t0 = time.perf_counter()
                graph = win.graphs[sampled] = StepGraph(self._pool)
                graph.capture(lambda: win.body(sampled))
                cw.record("serving.scan_step", signature_of(sig, {}),
                          time.perf_counter() - t0, t0=t0)
            win.graphs[sampled].replay()
        blk = win.block.cpu().numpy()                   # [k, S]
        self.n_decode_steps += 1
        self.n_scan_flushes += 1
        self.n_scan_steps += k
        self.occupancy_sum += len(live) / S
        self._note_step_metrics(len(runnable), decoded=True)
        if traced:
            self._engine_span("scan_step", t_step, live=len(live), k=k,
                              step=self.n_decode_steps)
        # one event a window, never per token
        self.flight.record("scan_flush", k=k, slots=len(runnable))
        for s in runnable:
            sl = self.slots[s]
            burst = []
            for i in range(k):
                t = int(blk[i, s])
                burst.append(t)
                if t == sl.req.eos_id or sl.gen + len(burst) >= \
                        sl.req.max_new:
                    break                # the run mask froze here too
            self.cur_burst = len(burst)
            try:
                for t in burst:
                    self._bank_token(s, t)
            finally:
                self.cur_burst = 1

    def _run_mixed_step(self, live, runnable, filling) -> None:
        """One mixed prefill/decode step: each running decoding slot's row
        first, then up to `prefill_chunk` prompt rows per filling slot
        (admission order) within the `max_step_tokens` budget; padding
        rows fill the rest.  Decoding slots bank a token; a slot whose
        final chunk ran emits token 0.  Paused slots have no row."""
        traced = self._tr_on()
        t_step = time.perf_counter() if traced else 0.0
        S = len(self.slots)
        T = self.max_step_tokens
        row_ids = np.zeros(T, np.int64)
        row_slot = np.full(T, S, np.int32)     # S = the all-zero table row
        row_pos = np.zeros(T, np.int32)
        sample_row = np.zeros(S, np.int64)
        r = 0
        for s in runnable:
            sl = self.slots[s]
            self._writable(s, sl.pos, sl.pos)
            row_ids[r], row_slot[r], row_pos[r] = sl.last_tok, s, sl.pos
            sample_row[s] = r
            r += 1
        advanced, r = self._pack_chunk_rows(filling, row_ids, row_slot,
                                            row_pos, sample_row, r, T - r)
        with get_compile_watch().observe("serving.mixed_step", row_ids,
                                         self.splits):
            logits = self._ragged_forward(row_ids, row_slot, row_pos)
            emitting = list(runnable) + [s for s, _, final in advanced
                                         if final]
            nxt = self._sample(logits[self._to_device(sample_row)][:, None],
                               emitting)[:, 0]
        self.n_decode_steps += 1
        self.n_mixed_steps += 1
        self.occupancy_sum += len(live) / S
        self._note_step_metrics(r, decoded=bool(runnable))
        if traced:
            self._engine_span("decode_step", t_step, live=len(live),
                              step=self.n_decode_steps, mixed=True, rows=r,
                              decode_rows=len(runnable))
        for s in runnable:
            self._bank_token(s, int(nxt[s]))
        self._advance_chunks(advanced, lambda s: int(nxt[s]))

    def _chunk_rows_for(self, s: int, budget: int) -> int:
        """Rows slot `s`'s next prompt chunk takes under `budget`: the one
        formula the packing and the verify step's chunk reserve share."""
        sl = self.slots[s]
        return min(sl.req.prompt_ids.size - sl.pos, self.prefill_chunk,
                   budget)

    def _pack_chunk_rows(self, filling, row_ids, row_slot, row_pos,
                         sample_row, r: int, budget: int):
        """Pack up to `prefill_chunk` prompt rows per filling slot
        (admission order) from row `r`, at most `budget` rows in all —
        shared by the mixed and the verify step.  A slot whose final chunk
        lands gets `sample_row[s]` at its last prompt row.  Returns
        ([(slot, rows, final)], the next free row)."""
        advanced = []
        for s in sorted(filling, key=lambda s: self.slots[s].admit_seq):
            if budget <= 0:
                break
            sl = self.slots[s]
            n = self._chunk_rows_for(s, budget)
            self._writable(s, sl.pos, sl.pos + n - 1)
            row_ids[r:r + n] = sl.req.prompt_ids[sl.pos:sl.pos + n]
            row_slot[r:r + n] = s
            row_pos[r:r + n] = np.arange(sl.pos, sl.pos + n)
            final = sl.pos + n == sl.req.prompt_ids.size
            if final:
                sample_row[s] = r + n - 1
            advanced.append((s, n, final))
            self.n_prefill_chunks += 1
            self._bump_attr(sl.req.req_id, "chunks")
            self.flight.record("chunk_sched", req=str(sl.req.req_id),
                               slot=s, start=int(sl.pos), tokens=int(n),
                               final=final)
            budget -= n
            r += n
        return advanced, r

    def _advance_chunks(self, advanced, tok0_of) -> None:
        """After a mixed or verify step: move each chunked slot's cursor,
        and emit token 0 (`tok0_of(s)`) where the final chunk ran."""
        for s, n, final in advanced:
            self.slots[s].pos += n
            if final:
                self._emit_first(s, tok0_of(s))

    def _ragged_forward(self, row_ids, row_slot, row_pos) -> torch.Tensor:
        """The packed rows [T] through the model, every attention layer
        reading through the ragged paged-attention kernel at the engine's
        split count; returns the logits [T, V]."""
        table = self._sync_table()
        d_slot, d_pos = self._to_device(row_slot), self._to_device(row_pos)
        state = {name: {"k_pages": p["k"], "v_pages": p["v"],
                        "page_table": table, "row_slot": d_slot,
                        "row_pos": d_pos, "splits": self.splits}
                 for name, p in self.kv.pools.items()}
        feed = {self.input_name: Argument(
            ids=self._to_device(row_ids[None, :]),
            lengths=torch.full((1,), row_ids.size, dtype=torch.int32,
                               device=self.device))}
        outputs, _, _ = self.executor.forward(self.params, feed, state, TEST)
        return outputs[self.logits_name].value[0]

    # -- speculative decode -------------------------------------------------
    def _dyn_k(self, sl: _Slot) -> int:
        """Slot `sl`'s draft depth this step: spec_k, or with
        `spec_dynamic` its accept-rate EWMA times spec_k — one draft for a
        cold slot, 0 (plain decode) for a slot whose rate decayed, with a
        one-draft re-probe every `_PROBE_EVERY` steps, so a workload that
        turns repetitive climbs back."""
        if not self.spec_dynamic:
            return self.spec_k
        if sl.accept_ewma is None:
            return min(1, self.spec_k)
        k = int(round(sl.accept_ewma * self.spec_k))
        if k <= 0:
            sl.probe_tick += 1
            if sl.probe_tick >= _PROBE_EVERY:
                sl.probe_tick = 0
                return 1
            return 0
        return min(k, self.spec_k)

    def _draft_ctx(self, s: int, W: int) -> np.ndarray:
        """Slot `s`'s most recent W tokens of prompt + generated, newest
        last."""
        sl = self.slots[s]
        gen_tail = sl.generated[-W:]
        need = W - len(gen_tail)
        if need > 0:
            return np.concatenate([sl.req.prompt_ids[-need:],
                                   np.asarray(gen_tail, np.int32)])
        return np.asarray(gen_tail, np.int32)

    def _propose_drafts(self, runnable) -> dict:
        """{slot: draft tokens} for the decoding slots the drafter proposes
        for.  A slot's depth is capped so its chain emits no more tokens
        than it may (max_new - gen - 1 drafts) and writes no position past
        its capacity.  A drafter returning more than asked trips an
        assertion: the clamp is the drafter's contract, and truncating
        here would hide its fault as a low accept rate."""
        out = {}
        if not runnable:
            return out
        cap = self.kv.capacity_tokens
        W = int(getattr(self.drafter, "window", 0)) or cap
        want = {}
        for s in runnable:
            sl = self.slots[s]
            k = min(self._dyn_k(sl), sl.req.max_new - sl.gen - 1,
                    cap - 1 - sl.pos)
            self.spec_k_hist.observe(float(max(k, 0)))
            if k > 0:
                want[s] = k
        if not want:
            return out
        traced = self._tr_on()
        t0 = time.perf_counter()
        if hasattr(self.drafter, "propose_batch"):
            out = self._propose_batched(want, W)
        else:
            for s, k in want.items():
                ctx = self._draft_ctx(s, W)
                if self._drafter_takes_eos:
                    d = self.drafter.propose(
                        ctx, k, eos_id=self.slots[s].req.eos_id)
                else:
                    d = self.drafter.propose(ctx, k)
                d = np.asarray(d, np.int32).reshape(-1)
                assert d.size <= k, \
                    f"drafter returned {d.size} tokens for k={k}: the " \
                    f"clamp contract is the drafter's (serving/drafter.py)"
                if d.size:
                    out[s] = d
        dt = time.perf_counter() - t0
        self.draft_ms_hist.observe(dt * 1e3)
        if out:
            self.n_draft_steps += 1
            self.flight.record("draft_step", slots=len(out),
                               drafter=self.drafter_kind,
                               ms=round(dt * 1e3, 3))
            if traced:
                self.tracer.add("draft_step", t0, dt, track="engine",
                                attrs={"slots": len(out), "k": self.spec_k,
                                       "drafter": self.drafter_kind})
        return out

    def _propose_batched(self, want: dict, W: int) -> dict:
        """One `propose_batch` call at depth spec_k for every slot: the
        [S, W] context matrix (slots not drafting ride as length-1 zero
        rows), each drafting slot's row then cut to its own depth and at
        the -1 padding after its eos."""
        S = len(self.slots)
        ctx = np.zeros((S, W), np.int32)
        lens = np.ones(S, np.int32)
        eos = np.full(S, -1, np.int32)
        for s in want:
            c = self._draft_ctx(s, W)
            ctx[s, :c.size] = c[-W:]
            lens[s] = max(int(c.size), 1)
            eos[s] = self.slots[s].req.eos_id
        props = np.asarray(self.drafter.propose_batch(ctx, lens, self.spec_k,
                                                      eos_ids=eos))
        out = {}
        for s, k in want.items():
            row = np.asarray(props[s, :k], np.int32).reshape(-1)
            stop = np.flatnonzero(row < 0)
            if stop.size:
                row = row[:int(stop[0])]
            if row.size:
                out[s] = row
        return out

    def _run_spec_step(self, live, runnable, filling, drafts: dict) -> None:
        """One verify step: every running decoding slot packs a CHAIN — its
        base row at `pos` and up to k draft rows at pos+1.. — and filling
        slots their prompt chunks, in one ragged forward.  Budget order:
        the base rows first (every decoder advances), then the chunks'
        reserve (what the mixed step would schedule them), and drafts
        spend what is left.  A chain whose pages cannot grow without
        evicting a cached prefix verifies fewer drafts.  The forward writes
        every row's K/V before any row reads, so draft row i attends the
        context plus drafts before it, causally.

        Chain position i samples with the noise of generation gen + i;
        the slot accepts the leading run of drafts equal to their
        position's sample, commits it plus the next sample, hands back the
        pages the rejected tail grew (before banking, which may retire the
        slot) and banks the tokens, cut at an eos."""
        traced = self._tr_on()
        t_step = time.perf_counter() if traced else 0.0
        S = len(self.slots)
        K = self.spec_k
        T = self.max_step_tokens if self.prefill_chunk is not None \
            else S * (K + 1)
        ps = self.kv.page_size
        row_ids = np.zeros(T, np.int64)
        row_slot = np.full(T, S, np.int32)     # S = the all-zero table row
        row_pos = np.zeros(T, np.int32)
        first_row = np.zeros(S, np.int64)
        n_draft = np.zeros(S, np.int64)
        draft_toks = np.zeros((S, K), np.int64)
        budget = T - len(runnable)
        assert budget >= 0, "max_step_tokens below the decoding slots"
        for s in sorted(filling, key=lambda s: self.slots[s].admit_seq):
            if budget <= 0:
                break
            budget -= self._chunk_rows_for(s, budget)  # the chunks' reserve
        r = 0
        for s in runnable:
            sl = self.slots[s]
            d = drafts.get(s)
            nd = 0 if d is None else min(int(d.size), budget)
            if nd > 0 and not self.kv.try_grow(s, sl.pos + nd + 1,
                                               evict=False):
                # page-starved: verify what the slot's pages cover (pages
                # taken stay; the rollback returns what acceptance leaves
                # unjustified)
                nd = min(nd, max(0, int(self.kv._n_pages[s]) * ps
                                 - sl.pos - 1))
            self._writable(s, sl.pos, sl.pos + nd)
            row_ids[r], row_slot[r], row_pos[r] = sl.last_tok, s, sl.pos
            first_row[s] = r
            r += 1
            if nd > 0:
                row_ids[r:r + nd] = d[:nd]
                row_slot[r:r + nd] = s
                row_pos[r:r + nd] = np.arange(sl.pos + 1, sl.pos + 1 + nd)
                draft_toks[s, :nd] = d[:nd]
                n_draft[s] = nd
                self.n_spec_drafted += nd
                self.flight.record("spec_propose",
                                   req=str(sl.req.req_id), slot=s,
                                   k=int(nd), pos=int(sl.pos))
                budget -= nd
                r += nd
        # chunks take their reserve plus what the drafts left
        advanced, r = self._pack_chunk_rows(filling, row_ids, row_slot,
                                            row_pos, first_row, r, T - r)
        with get_compile_watch().observe("serving.spec_step", row_ids,
                                         draft_toks, self.splits):
            logits = self._ragged_forward(row_ids, row_slot, row_pos)
            idx = np.minimum(first_row[:, None] + np.arange(K + 1)[None, :],
                             T - 1)
            emitting = list(runnable) + [s for s, _, final in advanced
                                         if final]
            sampled = self._sample(logits[self._to_device(idx)], emitting,
                                   {s: int(n_draft[s]) for s in runnable})
        ok = (sampled[:, :K] == draft_toks) & \
            (np.arange(K)[None, :] < n_draft[:, None])
        acc = np.cumprod(ok, axis=1).sum(axis=1)
        self.n_decode_steps += 1
        self.n_spec_steps += 1
        if advanced:
            self.n_mixed_steps += 1
        self.occupancy_sum += len(live) / S
        self._note_step_metrics(r, decoded=bool(runnable))
        if traced:
            self._engine_span("decode_step", t_step, live=len(live),
                              step=self.n_decode_steps, spec=True, rows=r,
                              decode_rows=len(runnable))
        for s in runnable:
            sl = self.slots[s]
            a, nd = int(acc[s]), int(n_draft[s])
            self.n_spec_accepted += a
            self.n_spec_chains += 1
            if self.spec_dynamic and nd:
                # before banking may retire the slot; a draft-free chain
                # carries no signal
                rate = a / nd
                sl.accept_ewma = rate if sl.accept_ewma is None else \
                    (1.0 - _EWMA_ALPHA) * sl.accept_ewma + _EWMA_ALPHA * rate
            if nd:
                rid = str(sl.req.req_id)
                self._bump_attr(sl.req.req_id, "spec_drafted", nd)
                if a:
                    self._bump_attr(sl.req.req_id, "spec_accepted", a)
                    self.flight.record("spec_accept", req=rid, slot=s,
                                       accepted=a, drafted=nd)
                if nd > a:
                    self.flight.record("spec_reject", req=rid, slot=s,
                                       rejected=nd - a, drafted=nd)
            self.kv.uncommit_tail(s, sl.pos + a + 1)
            for i in range(a + 1):
                self._bank_token(s, int(sampled[s, i]))
                self.n_spec_tokens += 1
                if self.slots[s] is None:      # retired mid-chain (eos)
                    break
        self._advance_chunks(advanced, lambda s: int(sampled[s, 0]))

    def _bank_token(self, s: int, tok: int) -> None:
        """Record one decoded token of slot `s`; retire on eos/max_new.  The
        first fresh token after a preemption's replay flips the request's
        phase from replay to decode."""
        sl = self.slots[s]
        if sl.replay_until and sl.gen >= sl.replay_until:
            sl.replay_until = 0
            self._tr_end(sl.req.req_id)
            self._tr_begin(sl.req.req_id, "decode")
        sl.generated.append(tok)
        sl.pos += 1
        sl.gen += 1
        sl.last_tok = tok
        self.tokens_generated += 1
        if self.on_token is not None:
            self.on_token(sl.req.req_id, tok, sl.gen - 1)
        if tok == sl.req.eos_id or sl.gen >= sl.req.max_new:
            self._retire(s)

    def _emit_first(self, s: int, tok0: int) -> None:
        """Token 0's emission: the whole prompt is committed (its final
        chunk ran, or the whole-prompt admission prefilled it) and `tok0`
        came from its last position.  The slot flips to decode mode — the
        prefill phase ends, and decode begins, or replay where a
        preemption took tokens back."""
        sl = self.slots[s]
        req = sl.req
        sl.gen = 1
        sl.last_tok = tok0
        sl.generated = [tok0]
        self._tr_end(req.req_id)                  # prefill ends here
        stash = req._preempted_gen or []
        if stash:
            sl.replay_until = len(stash)
            self._tr_begin(req.req_id, "replay", replays=len(stash))
        else:
            self._tr_begin(req.req_id, "decode")
        self.tokens_generated += 1
        if self.on_token is not None:
            self.on_token(req.req_id, tok0, 0)
        if tok0 == req.eos_id or req.max_new == 1:
            self._retire(s)

    def _retire(self, s: int) -> None:
        sl = self.slots[s]
        toks = np.concatenate([sl.req.prompt_ids,
                               np.asarray(sl.generated, np.int32)])
        reason = "stop" if sl.last_tok == sl.req.eos_id else "length"
        self._donate(s)
        self.kv.release(s)
        self.slots[s] = None
        self._finish(sl.req.req_id, toks, reason)

    def _finish(self, req_id, toks: np.ndarray, reason: str) -> None:
        # close the open phase (queued for a waiter, decode or replay in a
        # slot) and mark the terminal event
        self._tr_end(req_id, reason=reason)
        self._tr_instant(req_id,
                         "done" if reason in ("stop", "length") else reason,
                         reason=reason, tokens=int(toks.size))
        self.flight.record("finish", req=str(req_id), reason=reason,
                           tokens=int(toks.size))
        self.finish_timing[req_id] = self._finish_timing(req_id)
        self._req_trace.pop(req_id, None)
        self.results[req_id] = toks
        self.finish_reasons[req_id] = reason
        if self.on_finish is not None:
            self.on_finish(req_id, toks, reason)


class _Window:
    """The device state of one engine's windows of k bodies, and their
    graphs: per-slot integers (last token, position, generation count,
    run mask, eos id, max_new, top_k) and floats (temperature, top_p)
    staged by the host at a window's start, and the [k, S] token block the
    window writes.  A sampling window draws its k bodies' noise from the
    engine's key buffer and the generation counts at its start; only a
    `noise` hook's rows come through the [k, S, V] `noise` buffer, filled
    by the host."""

    def __init__(self, eng: ServingEngine, k: int):
        S, dev = len(eng.slots), eng.device
        self.eng, self.k = eng, k
        # all-greedy / sampling -> its graph on the card (None: ran eagerly
        # once, captured at the next window)
        self.graphs: dict[bool, Optional[StepGraph]] = {}
        self.ints = torch.zeros((7, S), dtype=torch.int64, device=dev)
        self.floats = torch.zeros((2, S), dtype=torch.float32, device=dev)
        self.noise = None if eng.noise is None else torch.zeros(
            (k, S, eng.vocab), dtype=torch.float32, device=dev)
        self.block = torch.zeros((k, S), dtype=torch.int32, device=dev)
        self.ones = torch.ones(S, dtype=torch.int32, device=dev)

    def body(self, sampling: bool) -> None:
        """k decode steps on the device, no host read: each the k = 1 decode
        step's forward and sampler over all S slots, then the running slots
        advance and a slot leaves the run mask at its eos or max_new.  A
        stopped or paused slot recomputes its frozen row; its K/V write
        lands at its own position (one past a stopped slot's last token, in
        its own pages or the trash page; a paused slot's unmapped page, so
        the trash page), where nothing reads it."""
        eng = self.eng
        S = self.ints.shape[1]
        tok, pos, gen, run, eos, max_new, top_k = self.ints
        temp, top_p = self.floats
        table = eng._d_table[:S]
        noise = self.noise
        if sampling and noise is None:
            # every body's noise in one draw: a running slot's generation
            # at body i is gen + i (the others' rows are discarded)
            g = gen[:, None] + torch.arange(self.k, device=gen.device)
            noise = slot_noise(prng.fold_in(
                eng._d_keys[:, None], torch.minimum(g, max_new[:, None] - 1)),
                eng.vocab).transpose(0, 1)
        for i in range(self.k):
            state = {name: {"k_pages": p["k"], "v_pages": p["v"],
                            "page_table": table, "pos": pos,
                            "splits": eng.splits}
                     for name, p in eng.kv.pools.items()}
            feed = {eng.input_name: Argument(ids=tok[:, None],
                                             lengths=self.ones)}
            outputs, _, _ = eng.executor.forward(eng.params, feed, state,
                                                 TEST)
            nxt = pick_next_per_slot(
                outputs[eng.logits_name].value[:, 0, :],
                noise[i] if sampling else None, temp, top_k, top_p,
                is_probs=eng._probs, any_sampling=sampling)
            self.block[i].copy_(nxt)
            nxt = nxt.to(torch.int64)
            on = run.bool()
            pos.add_(run)
            gen.add_(run)
            tok.copy_(torch.where(on, nxt, tok))
            run.copy_((on & (nxt != eos) & (gen < max_new)).to(torch.int64))
