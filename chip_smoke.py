"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile every CUDA kernel of the serving path from the
               sources in this checkout (nvcc, sm_90a), one nvcc per source
               started together;
  3. kernel  — the ragged paged-attention kernel against its plain PyTorch
               version at decode and mixed-step shapes (GQA, page sizes 16
               and 8, lengths 1..768), float32 (atol 2e-5) and bfloat16
               (against the plain version in float32 on the same bfloat16
               inputs, atol 2e-2);
  4. serve   — the main path: the transformer LM at full width (vocab
               32000, dim 512, 8 layers, 8 heads, bfloat16, random weights
               from seed 1) serving 32 requests through ServingEngine; the
               kernel must launch once per attention layer per step and the
               plain version never; then a torch.profiler pass over 8 of
               the requests (device busy share, top kernels), and the
               kernel's time per launch, replayed at the launches the run
               made, beside the plain version's and the memory bound;
  5. routes  — float32, 2 layers at full width: the engine reading through
               the kernel against the engine reading through the page-table
               gather (attn_impl='dense'), lm_head rows at the first mixed
               and first decode step within atol 1e-5.
The line before the last is a JSON object with each kernel's numbers; the
last line is {"ok": true, "device": {...}}.  Exits non-zero without a
result when CUDA is not available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_FLUSH_BYTES = 64 << 20          # more than the 50 MB L2


def log(*a):
    print(*a, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | count "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)
    return smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import paged_attention as pa

    kernels = {"paged_attention": pa.kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        built = dict(zip(kernels, pool.map(lambda k: k.library(),
                                           kernels.values())))
    for name, lib in built.items():
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln]
        log(f"[build] {name}: nvcc {lib.build_seconds:.2f}s -> {lib.path.name}"
            f"; {len(regs)} instances, ptxas: "
            f"{'; '.join(sorted(set(regs))[:3])}")
    log(f"[build] all kernels {time.perf_counter() - t0:.2f}s")


def make_case(rng, *, rows: str, H: int, h_kv: int, D: int, ps: int,
              dtype, S: int = 16, max_ctx: int = 768, dev="cuda"):
    """Random pools + page tables.  'decode': one row per slot; 'mixed':
    a 64-row prompt chunk of slot 0, one decode row for slots 1..S-1, and
    padding rows up to 80 that address the all-zero table row S."""
    maxp = max_ctx // ps
    P = 1 + S * maxp
    k = torch.randn(P, ps, h_kv, D, generator=rng, device=dev).to(dtype)
    v = torch.randn(P, ps, h_kv, D, generator=rng, device=dev).to(dtype)
    lens = torch.randint(1, max_ctx + 1, (S,), generator=rng, device=dev)
    lens[0], lens[1] = 1, max_ctx                 # both ends of 1..768
    table = torch.zeros(S + 1, maxp, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=rng, device=dev).cpu() + 1
    for s in range(S):
        n = -(-int(lens[s]) // ps)
        table[s, :n] = perm[s * maxp:s * maxp + n]
    if rows == "decode":
        row_slot = torch.arange(S, dtype=torch.int32)
        lengths = lens.cpu().to(torch.int32)
    else:
        lens[0] = max(int(lens[0]), 64)
        n0 = -(-int(lens[0]) // ps)
        table[0, :n0] = perm[:n0]
        chunk = torch.arange(int(lens[0]) - 64, int(lens[0])) + 1
        row_slot = torch.cat([torch.zeros(64, dtype=torch.int32),
                              torch.arange(1, S, dtype=torch.int32),
                              torch.full((80 - 64 - (S - 1),), S,
                                         dtype=torch.int32)])
        lengths = torch.cat([chunk, lens[1:].cpu(),
                             torch.ones(80 - 64 - (S - 1), dtype=torch.long)
                             ]).to(torch.int32)
    R = row_slot.numel()
    q = torch.randn(R, H, D, generator=rng, device=dev).to(dtype)
    return (q, k, v, table.to(dev), lengths.to(dev), row_slot.to(dev))


def phase_kernel() -> float:
    from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                      paged_attention_plain)
    rng = torch.Generator(device="cuda")
    rng.manual_seed(0)
    worst = 0.0
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for rows in ("decode", "mixed"):
            for ps in (16, 8):
                for H, h_kv in ((8, 8), (8, 2)):
                    q, k, v, table, lengths, row_slot = make_case(
                        rng, rows=rows, H=H, h_kv=h_kv, D=64, ps=ps,
                        dtype=dtype)
                    got = paged_attention(q, k, v, table, lengths,
                                          row_slot=row_slot)
                    torch.cuda.synchronize()
                    want = paged_attention_plain(
                        q.float(), k.float(), v.float(), table, lengths,
                        row_slot=row_slot)
                    err = float((got.float() - want).abs().max())
                    ok = bool(torch.isfinite(got).all()) and err <= atol
                    log(f"[kernel] {str(dtype)[6:]:8s} {rows:6s} ps={ps:2d} "
                        f"H={H} H_kv={h_kv} R={q.shape[0]:2d} "
                        f"len={int(lengths.min())}..{int(lengths.max())} "
                        f"max_abs_err={err:.3e} (atol {atol:g}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"paged_attention kernel disagrees with its plain "
                            f"version: {err} > {atol}")
                    if dtype == torch.float32:
                        worst = max(worst, err)
    return worst


def launch_bytes_flops(args, elem: int) -> tuple[float, float]:
    """Bytes the call must move (live K/V pages read once, q read, out
    written, index arrays read) and the flops it does (QK and PV)."""
    q, k_pages, _, table, lengths, row_slot = args
    R, H, D = q.shape
    _, ps, h_kv, _ = k_pages.shape
    tbl = table.cpu().numpy()
    lens = lengths.cpu().numpy().astype(np.int64)
    rs = row_slot.cpu().numpy()
    pages = set()
    for r in range(R):
        pages.update(tbl[rs[r], :-(-int(lens[r]) // ps)].tolist())
    kv_bytes = 2 * len(pages) * ps * h_kv * D * elem
    index_bytes = 4 * (2 * R + tbl.shape[1] * len(set(rs.tolist())))
    nbytes = kv_bytes + 2 * q.numel() * elem + index_bytes
    flops = 4.0 * H * D * float(lens.sum())
    return nbytes, flops


def time_launches(fn, launches) -> float:
    """Mean ms of fn over the recorded launches, each timed with CUDA
    events after a write of more than the L2 cache, as a launch in the
    layer loop finds it (the other layers' pools pass through L2 between
    two launches on one layer's pools)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for q, k, v, table, lengths, row_slot in launches[:4]:      # warm-up
        fn(q, k, v, table, lengths, row_slot=row_slot)
    pairs = []
    for q, k, v, table, lengths, row_slot in launches:
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(q, k, v, table, lengths, row_slot=row_slot)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


def serve_requests(n: int, vocab: int, seed: int, lo: int, hi: int,
                   max_new: int, sampled_every: int = 0):
    from paddle_tpu_torch.serving import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = rng.integers(2, vocab, int(rng.integers(lo, hi + 1)))
        kw = {}
        if sampled_every and i % sampled_every == 0:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1000 + i)
        reqs.append(Request(i, p, max_new=max_new, **kw))
    return reqs


def phase_serve(smi: str, kernel_err: float) -> dict:
    import paddle_tpu_torch.ops.attention as attn_ops
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import ServingEngine

    vocab, layers = 32000, 8
    model = transformer_lm_config(vocab=vocab, dim=512, layers=layers,
                                  heads=8)
    ex = GraphExecutor(model, compute_dtype="bfloat16")
    params = init_params(model, seed=1)
    eng = ServingEngine(ex, params, num_slots=16, page_size=16,
                        max_context=768)
    assert (eng.prefill_chunk, eng.max_step_tokens) == (64, 80)
    # warm-up (library handles, allocator): not counted, not timed
    eng.run(serve_requests(4, vocab, seed=7, lo=8, hi=80, max_new=4,
                           sampled_every=2))
    steps0, mixed0, tokens0 = (eng.n_decode_steps, eng.n_mixed_steps,
                               eng.tokens_generated)
    reqs = serve_requests(32, vocab, seed=1, lo=32, hi=256, max_new=64,
                          sampled_every=4)
    want_len = {r.req_id: r.prompt_ids.size + r.max_new for r in reqs}

    # keep the arguments of layer 0's launches for the timing below; the
    # kernel wrapper itself (and its launch count) is untouched
    first = model.layers[3].name
    assert first == "blk0_attn"
    recorded = []
    wrapper = pa.paged_attention

    def recording(q, k_pages, v_pages, page_table, lengths, scale=None,
                  row_slot=None):
        out = wrapper(q, k_pages, v_pages, page_table, lengths, scale,
                      row_slot)
        if k_pages is eng.kv.pools[first]["k"]:
            rs = row_slot if row_slot is not None else torch.arange(
                q.shape[0], dtype=torch.int32, device=q.device)
            recorded.append((q.clone(), k_pages, v_pages, page_table.clone(),
                             lengths.clone(), rs.clone()))
        return out

    attn_ops.pa.paged_attention = recording
    try:
        torch.cuda.synchronize()
        pa.counts.reset()
        t0 = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain_calls = pa.counts.kernel, pa.counts.plain
    finally:
        attn_ops.pa.paged_attention = wrapper
    steps = eng.n_decode_steps - steps0
    tokens = eng.tokens_generated - tokens0
    log(f"[serve] {len(results)} requests, {steps} steps "
        f"({eng.n_mixed_steps - mixed0} mixed), {tokens} tokens in "
        f"{wall:.3f}s = {tokens / wall:.1f} tokens/s, "
        f"{wall / steps * 1e3:.2f} ms/step; kernel launches {launches} "
        f"(= {layers} x {steps}: {launches == layers * steps}), plain "
        f"calls {plain_calls} [{smi}]")
    if len(results) != len(reqs):
        raise AssertionError(f"{len(results)} of {len(reqs)} requests done")
    for rid, toks in results.items():
        if toks.size != want_len[rid]:          # no eos: every request runs
            raise AssertionError(f"request {rid}: {toks.size} tokens, "
                                 f"want {want_len[rid]}")
        if toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"request {rid}: token ids out of range")
    eng.kv.check()
    if eng.kv.free_page_count != eng.kv.num_pages - 1:
        raise AssertionError("pages still held after the workload")
    if launches != layers * steps or plain_calls != 0:
        raise AssertionError(
            f"main path did not run through the kernel: {launches} "
            f"launches for {steps} steps x {layers} layers, {plain_calls} "
            f"plain calls")

    profile_serving(eng, reqs, smi)
    kern_ms = time_launches(pa.paged_attention, recorded)
    plain_ms = time_launches(pa.paged_attention_plain, recorded)
    bound = [launch_bytes_flops(a, 2) for a in recorded]
    bytes_ms = float(np.mean([b for b, _ in bound])) / HBM_BYTES_PER_S * 1e3
    flops_ms = float(np.mean([f for _, f in bound])) / \
        PEAK_FLOPS[torch.bfloat16] * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    rows = [a[0].shape[0] for a in recorded]
    log(f"[serve] kernel at the run's {len(recorded)} layer-0 launches "
        f"(rows {min(rows)}..{max(rows)}): {kern_ms * 1e3:.2f} us/launch; "
        f"plain version {plain_ms * 1e3:.2f} us; bound "
        f"{bound_ms * 1e3:.3f} us ({bytes_ms * 1e3:.3f} bytes, "
        f"{flops_ms * 1e3:.4f} flops) = {bound_ms / kern_ms:.1%} of the "
        f"bound; no single PyTorch call computes paged attention, so no "
        f"library time [{smi}]")
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_paged.py:104",
            "launches": launches, "max_abs_err": kernel_err,
            "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def profile_serving(eng, reqs, smi: str) -> None:
    """The first 8 requests of the workload once more under torch.profiler
    (all 32 make the profiler's post-processing take minutes): the
    device's busy share of the wall time and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps0 = eng.n_decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs[:8])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.n_decode_steps - steps0

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    if not kernels:
        log(f"[profile] wall {wall_ms:.1f} ms (profiler on); device time "
            f"not measured: the profiler saw no CUDA events")
        return
    log(f"[profile] 8 requests: wall {wall_ms:.1f} ms over {steps} steps "
        f"(profiler on); device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, idle "
        f"{1 - busy_ms / wall_ms:.1%}; {n_launch} kernel launches = "
        f"{n_launch / steps:.0f}/step [{smi}]")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[profile]   {dev_us(e) / 1e3:8.2f} ms {e.count:6d}x "
            f"{dev_us(e) / busy_ms / 10:5.1f}%  {e.key[:90]}")


def phase_routes() -> None:
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import ServingEngine

    vocab = 32000
    seen = {}
    outs = {}
    for impl in ("auto", "dense"):
        model = transformer_lm_config(vocab=vocab, dim=512, layers=2,
                                      heads=8, attn_impl=impl)
        ex = GraphExecutor(model)
        params = init_params(model, seed=1)
        eng = ServingEngine(ex, params, num_slots=16, page_size=16,
                            max_context=768)
        S = len(eng.slots)
        steps = seen[impl] = {}
        forward = ex.forward

        def capture(params, feed, state, mode, steps=steps, forward=forward):
            outputs, costs, st = forward(params, feed, state, mode)
            cache = state["blk0_attn"]
            kind = "mixed" if "row_slot" in cache else "decode"
            if kind not in steps:
                live = (cache["row_slot"] < S) if kind == "mixed" else \
                    (cache["page_table"][:, 0] != 0)
                steps[kind] = outputs["lm_head"].value.reshape(
                    -1, vocab)[live].clone()
            return outputs, costs, st

        ex.forward = capture
        outs[impl] = eng.run(serve_requests(8, vocab, seed=2, lo=40,
                                            hi=200, max_new=16))
    for kind in ("mixed", "decode"):
        a, b = seen["auto"][kind], seen["dense"][kind]
        err = float((a - b).abs().max())
        log(f"[routes] first {kind} step: {a.shape[0]} live rows, kernel vs "
            f"gather lm_head max_abs_err {err:.3e} (atol 1e-5)")
        if a.shape != b.shape or not err <= 1e-5:
            raise AssertionError(f"kernel and gather routes disagree at the "
                                 f"first {kind} step: {err}")
    same = [np.mean(outs["auto"][i] == outs["dense"][i]) for i in outs["auto"]]
    log(f"[routes] token agreement kernel vs gather: {np.mean(same):.4f} "
        f"(random weights give near-ties; not a gate)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    err = phase_kernel()
    record = phase_serve(smi, err)
    phase_routes()
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
