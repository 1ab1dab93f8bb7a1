"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile every CUDA kernel of the serving and training paths
               (paged attention, flash attention for fp32 (three TF32
               passes) and for bf16, the fused LSTM, the fused GRU, the
               additive attention) from the sources in this checkout (nvcc,
               sm_90a), one nvcc per source started together; each flash
               kernel's (both dtypes), each fused-GRU kernel's and each
               fused-LSTM kernel's registers, shared memory and local memory
               (cudaFuncGetAttributes, so also when the library was already
               built; the GRU walk kernels' dynamic shared memory as
               gru_plan sizes it for the seq2seq encoder, the LSTM walk
               kernels' as lstm_plan sizes it for the sentiment net and for
               hidden 512; every instance of the paged-attention and the
               additive-attention kernels), none with local memory (spills);
  3. kernel  — the ragged paged-attention kernel against its plain PyTorch
               version at decode and mixed-step shapes (GQA, page sizes 16
               and 8, lengths 1..768), float32 (atol 2e-5) and bfloat16
               (against the plain version in float32 on the same bfloat16
               inputs, atol 2e-2); then an edge grid (k5_case): a prompt
               chunk beside another slot's chunk, padding rows, length-1
               rows, a row longer than
               a split beside splits without a live token, rep 1-8, D 32,
               33, 40, 64, 128, pages 2-48, contexts to 4096, decode rows
               with row_slot given and None; two identical launches
               bit-identical, a decode launch replayed from a CUDA graph
               equal to eager bit for bit;
  4. serve   — the serving path: the transformer LM at full width (vocab
               32000, dim 512, 8 layers, 8 heads, bfloat16, random weights
               from seed 1) serving 32 requests through ServingEngine; the
               kernel must launch once per attention layer per step and the
               plain version never; then a torch.profiler pass over 8 of
               the requests (device busy share, top kernels, the kernel's
               share), and the kernel's time per launch, replayed at the
               launches the run made, over all of them and apart for the
               decode and the mixed launches, each beside its memory bound
               and with the split count pinned to 1, 2, 4, 8 (measurement),
               each timed in K5_ROUNDS rounds (median and range), beside
               the plain version's; then the same 32 requests on an engine
               with decode_steps=KSTEP (4: windows of 4 decode steps, each
               a CUDA graph captured per all-greedy / sampling variant)
               and again at k = 1, in KSTEP_ROUNDS rounds of swapped order
               (kstep_serving): the same tokens as the k = 1 run, the
               plain version never; tokens/s, ms/step, windows, and a
               profiled run of 8 requests each (device ms/step, busy
               share, kernels and host launch calls a step), in which the
               card launched the kernel once per layer per forward (the
               profiler's kernel events; window bodies included) and the
               wrapper counted only the forwards outside the windows;
  5. routes  — float32, 2 layers at full width: the engine reading through
               the kernel against the engine reading through the page-table
               gather (attn_impl='dense'), lm_head rows at the first mixed
               and first decode step within atol 1e-5;
  6. flash   — the three flash-attention kernels (forward, backward dQ,
               backward dK/dV) against their plain versions at B=2,
               T=2048, H=8 (H_kv 8 and 2): causal and not, a ragged key
               mask with Tq != Tk, window 256, nonzero offsets; float32
               (flash_attention.cu, three TF32 passes; o, lse within 2e-5,
               gradients within 2e-5 of their max) and bfloat16
               (flash_attention_tc.cu; against the plain version in
               float32 on the same inputs: o per element within
               2^-7 |ref| + 1e-3, lse within 2e-5, gradients within 1e-2 of
               their max), each at D=64 and D=128; each case launches its
               dtype's three kernels once and nothing else; each dtype's
               three kernels launched twice at both head dims repeat bit
               for bit and, captured in a CUDA graph, replay bit for bit;
  7. train   — the training path: Trainer on the transformer LM at full
               width in bfloat16 (seed 1), batches [8, 2048] of a
               repeated-motif token stream, warm-up steps then timed steps;
               every loss finite, the last 3 below the first 3, each
               bf16 flash kernel launched once per layer per step
               and the fp32 kernels and plain versions never; a
               save() -> fresh Trainer.load() round trip
               exact; tokens/s, ms/step, a torch.profiler pass over two
               steps; then the flash kernels at the run's shape [8, 2048,
               8, 64] bf16 causal against their plain versions (the bf16
               limits above; their errors are the kernels line's), the o
               limit rejecting the kernel's o with one key tile dropped,
               and each kernel's time per launch beside its bound, its
               plain version's time and scaled_dot_product_attention's (a
               yardstick, never called by the port); and, as a measurement
               only, the forward with p as one bf16 term in P V (the TPU
               kernel's rounding): its time and its o error as a share of
               the limit; before the kernels' records, the k-step run
               (kstep_training, below);
  7b. train-fp32 — the same LM at the config's default precision
               (compute_dtype '' = float32) at full width, [8, 2048]
               batches, 3 warm-up and 5 timed steps: each fp32 flash kernel
               launched once per layer per step and nothing else of flash
               attention, the loss falls; tokens/s, ms/step, a profiled
               step (device busy share, the flash kernels' share); then the
               fp32 kernels at [8, 2048, 8, 64] causal against their plain
               versions and timed beside both bounds (three TF32 passes,
               and the CUDA cores' fp32 peak), the plain version's time and
               scaled_dot_product_attention's in fp32 (TF32 off); and
               the k-step run: two trainers from one seed, the k = 1 loop
               and train_one_pass(steps_per_dispatch=KSTEP), each group
               of KSTEP steps one replay of a CUDA graph of KSTEP steps
               after an eager first step, on the same [8, 2048] batches (a
               warm-up pass, then KSTEP_ROUNDS rounds of a timed and a
               profiled pass, the order swapped each round): parameters,
               Adam slots, counters, dropout generator, every loss and the
               pass statistics bit-identical after every pass; the counts
               set to 0 before each pass, no plain version called, and in
               the profiled pass the card (the profiler's kernel events)
               launched each kernel as k = 1 does, the wrappers counting
               them all at k = 1 and none at k = KSTEP; wall and device
               ms/step, busy share, kernels and host launch calls a step
               (so also in phases 7, 10 for both sentiment nets, and 14);
               for the stacked sentiment net and seq2seq also a run of
               batches of two padded lengths (kstep_alternating): graphs
               of both signatures in one memory pool, replayed out of
               capture order, bit-identical to k = 1 over two passes;
  8. train-routes — float32, 2 layers at full width, B=2, T=2048: one
               training step's loss and gradients through the fp32
               flash kernels (once per layer each) against the same step
               through dense attention (attn_impl='dense'): loss within
               1e-5 relative, every gradient within 1e-4 of its max; then
               those kernels at [2, 2048, 8, 64] fp32 causal against their
               plain versions and timed, as in phase 7;
  9. lstm    — the two fused-LSTM kernels (forward; backward) against their
               plain version in float32: forward/reverse x with/without
               peepholes x ragged (a length-0 row, a full row) / full
               lengths x tanh / relu cells, at [B, T, D] = [128, 100, 128],
               [5, 7, 32] (a partly filled group), [64, 20, 256],
               [32, 12, 512] (part of W read from L2) and [1000, 12, 128]
               (clusters in waves), each with the launch plan it took: hs,
               h_last, c_last, dx4, dW, dpeep, dh0, dc0 each within 1e-5 of
               its max (relu cases first move their inputs off relu's
               kink, where the derivative has two values); the limit
               rejecting a result with the freeze dropped for one row; two
               backward calls bit-identical; one forward + backward
               captured in a CUDA graph, replayed, equal to eager bit for
               bit;
 10. sentiment — the recurrent training path: Trainer on the stacked IMDB
               sentiment LSTM net at full width (vocabulary 30000, embedding
               128, three fc(512) + lstmemory(128, relu, peepholes,
               drop_rate 0.5) pairs, float32, seed 1), batches [128, 100]
               of a two-class word language, full lengths then ragged
               (10..100): warm-up steps then timed steps; every loss
               finite, the last 3 below the first 3, each LSTM kernel
               launched 3 times per step (once per lstmemory) and the plain
               version never; Trainer.test and the is_predict forward give
               finite probabilities that sum to 1; a save() -> fresh
               Trainer.load() round trip exact (dropout generator
               included); samples/s, ms/step, a torch.profiler pass over
               two steps (with the K3 kernels' share of the device time); a
               few steps of the bidirectional net (2 launches of each
               kernel per step); then each kernel's time per launch at the
               run's shape beside its bound, its plain version's time and a
               cuDNN LSTM's (torch.nn.LSTM: no peepholes, no length freeze,
               its own input projection; a yardstick, never called by the
               port; each K3 kernel must be faster); the launch plan and the
               four plans ranked first for the card, timed; the backward's
               walk, dW product and ordered sums apart; the forward without
               the gates; a single-row launch; one step's split into its
               parts (clock64() stamps);
 11. sentiment-routes — float32 at full width, dropout masks fed as ones:
               one training step's loss and gradients through the LSTM
               kernels against the same step through their plain version:
               loss within 1e-5 relative, every gradient within 1e-4 of its
               max;
 12. gru     — the two fused-GRU kernels (forward; backward) against their
               plain version in float32, fed the column slices of one
               [D, 3D] weight: forward/reverse x ragged (a length-0 row, a
               full row) / full lengths x tanh / relu candidates, at
               [B, T, D] = [64, 30, 512], [5, 7, 32], [256, 30, 512],
               [64, 30, 96], [1, 30, 512], and [1024, 30, 512] and
               [1500, 12, 256] (batches walked in slices of rows, as no
               single launch takes them): hs, h_last, dx3, dWg, dWc,
               dh0 each within 1e-5 of its max (relu cases moved off the
               kink first); the limit rejecting a result with one row's
               freeze dropped; two backward calls bit-identical; one
               forward + backward captured in a CUDA graph, replayed, equal
               to eager bit for bit;
 13. additive — the additive-attention kernel against its plain version at
               [B, T, D, Dv] = [64, 30, 512, 1024], [192, 30, 512, 1024],
               T = 1 and T = 300, and widths its cluster's slices do not
               divide (D 500 / Dv 1000, D 33 / Dv 2047, Dv 24), full and
               ragged lengths (with a length-0 row, whose context must be
               zero): float32 within 2e-5; bfloat16 against the plain
               version in float32 on the same inputs, per element within
               2^-7 |ref| + 1e-3; two launches bit-identical; a launch
               replayed from a CUDA graph bit-identical to eager;
 14. seq2seq — the attention seq2seq (demo/seqToseq/seqToseq_net.py) at
               full width: Trainer on vocabulary 30000, hidden 512, batch
               64, float32, seed 1, batches of the sequence-reversal
               language (30 source words, 31 decoder steps), warm-up steps
               then 12 timed steps at full and 12 at ragged (10..30) source
               lengths; every loss finite, the last 3 below the first 3,
               each step 2 GRU forward, 2 GRU backward and 31
               additive-attention launches and no plain version;
               Trainer.test, a save() -> fresh Trainer.load() round trip
               exact; samples/s, ms/step, a torch.profiler pass over two
               steps; then beam-search generation (beam 3, max_length 30)
               of 64 ragged sources on the trained parameters: ids in the
               vocabulary, beams best-first, 2 GRU forward and 30
               additive-attention launches per call, beam-decode tokens/s;
               then each kernel's time per launch at the run's shapes beside
               its bound (the additive kernel also at the beam shape and with
               its cluster size pinned), its plain version's time and, for
               the GRU, a cuDNN
               GRU's (torch.nn.GRU: r applied after the product; a
               yardstick, never called by the port; each GRU kernel must be
               faster); for the GRU also the launch plan, three plans
               timed, the backward's walk and dW product apart, a
               single-row launch, one step's split into its parts
               (clock64() stamps) and batches of 1,024 rows at hidden 512
               and 256, launched as gru_launches does and another way (one
               launch or slices of rows), beside the cuDNN GRU;
 15. seq2seq-routes — float32 at full width, batch 16: one training step's
               loss and gradients through the GRU and additive kernels
               against the same step through their plain versions: loss
               within 1e-5 relative, every gradient within 1e-4 of its max;
 16. cli     — the user's entry point, `python -m paddle_tpu_torch train`
               (its main() called in this process), on three demo config
               files and their own data providers (synthetic data, no
               download): demo/sentiment/trainer_config.py at its defaults
               (hid_dim 512, batch 128; K3), demo/seqToseq/seqToseq_net.py
               at dict_size 30000, hidden 512, batch 64 (K1, K2) and
               demo/model_zoo/transformer_lm.py at vocab 32000, dim 512, 8
               layers, 8 heads, attn_impl=flash, bfloat16 (K4's bf16
               kernels); first, a Trainer here steps once on a batch of
               each shape the config's feeder gives (and tests one of each
               test shape), keeping each kernel wrapper's inputs at each
               signature, and every kernel is held against its plain
               version on those inputs with its phase's limit (K3, K1 1e-5
               of max; K2 2e-5; K4 bf16 2^-7|ref| + 1e-3, gradients 1e-2
               of max); then each one pass (and the test pass of its test
               source) at --steps_per_dispatch=1 and at KSTEP, each run
               under torch.profiler: the card launched each kernel as the
               pass's batches say (held by the wrappers at k = 1, by the
               profiler's kernel events at KSTEP), no plain version; the
               two runs' pass statistics and checkpoints (parameters,
               optimizer state, dropout generator) bit-identical; samples/s
               of the pass, device busy share and ms per step, beside the
               feeder's host ms to assemble a batch; then, on the
               sentiment config, --job=test --init_model_path of the
               checkpoint the k = 1 run saved: the statistics of a
               Trainer.load() of it here, exactly.
The last three lines of the output are a JSON object with each kernel's
numbers, the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.  Exits non-zero without a result when CUDA
is not available.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time
import types
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# dense peaks: bf16 and fp32 (CUDA cores) by dtype; "tf32x3" is the rate of
# float32 work done as three TF32 passes (494.7 TFLOP/s TF32 / 3), the route
# of the float32 flash kernels
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              "tf32x3": 494.7e12 / 3}
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

    from paddle_tpu_torch.ops import additive_attention as aa
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import gru_fused as gf
    from paddle_tpu_torch.ops import lstm_fused as lf
    from paddle_tpu_torch.ops import paged_attention as pa

    kernels = {"paged_attention": pa.kernel, "flash_attention": fa.kernel,
               "flash_attention_tc": fa.kernel_tc, "lstm": lf.kernel,
               "gru": gf.kernel, "additive_attention": aa.kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        built = dict(zip(kernels, pool.map(lambda k: k.library(),
                                           kernels.values())))
    for name, lib in built.items():
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln]
        how = (f"nvcc {lib.build_seconds:.2f}s; {len(regs)} instances, "
               f"ptxas: {'; '.join(sorted(set(regs))[:3])}"
               if lib.build_seconds else "already built")
        log(f"[build] {name}: {lib.path.name}, {how}")
    log(f"[build] all kernels {time.perf_counter() - t0:.2f}s")
    # the runtime's own account of each flash instance (bf16 and fp32),
    # whether or not this run compiled the library
    local = {}
    for kern in (fa.kernel_tc, fa.kernel):
        for (kname, dm), (regs, lmem, smem) in kern.attributes().items():
            log(f"[build] {kname}<{dm}>: {regs} registers, {smem} bytes of "
                f"dynamic shared memory, {lmem} bytes of local memory per "
                f"thread")
            local[f"{kname}<{dm}>"] = lmem
    if any(local.values()):
        raise AssertionError(f"the flash kernels must run without local "
                             f"memory (spills): {local}")
    # the same for K1's four kernels, the walk kernels' dynamic shared
    # memory set for the seq2seq encoder's plan
    plan = gf.plan_for(S2S_BATCH, S2S_HIDDEN, torch.device("cuda"))
    attrs = gf.kernel_attributes(S2S_HIDDEN, plan)
    for kname, (regs, lmem, smem, dyn) in attrs.items():
        log(f"[build] {kname} (plan {plan.args()} at D={S2S_HIDDEN}): {regs} "
            f"registers, {smem} bytes of static and {dyn} of dynamic shared "
            f"memory, {lmem} bytes of local memory per thread")
    if (attrs["gru_fwd_kernel"][3], attrs["gru_bwd_kernel"][3]) != (
            plan.smem_fwd, plan.smem_bwd):
        raise AssertionError(f"gru_plan's shared memory {plan} differs from "
                             f"the kernels' {attrs}")
    if any(a[1] for a in attrs.values()):
        raise AssertionError(f"the fused-GRU kernels must run without local "
                             f"memory (spills): {attrs}")
    # and for K3's: the instances of the sentiment net's plan (W in
    # registers) and of hidden 512's (W in shared memory and L2)
    for B, D in ((128, 128), (32, 512)):
        plan = lf.plan_for(B, D, torch.device("cuda"))
        attrs = lf.kernel_attributes(D, plan)
        quads = (lf.fwd_quads(D, plan.units, plan.rows_pad),
                 lf.bwd_quads(D, plan.units, plan.rows_pad))
        for kname, (regs, lmem, smem, dyn) in attrs.items():
            log(f"[build] {kname} (plan {plan.args()} at B={B}, D={D}, W "
                f"k-quads in registers {quads}): {regs} registers, {smem} "
                f"bytes of static and {dyn} of dynamic shared memory, "
                f"{lmem} bytes of local memory per thread")
        if (attrs["lstm_fwd_kernel"][3], attrs["lstm_bwd_kernel"][3]) != (
                plan.smem_fwd, plan.smem_bwd):
            raise AssertionError(f"lstm_plan's shared memory {plan} differs "
                                 f"from the kernels' {attrs}")
        if any(a[1] for a in attrs.values()):
            raise AssertionError(f"the fused-LSTM kernels must run without "
                                 f"local memory (spills): {attrs}")
    # and for every instance of K5 (dtype x query heads x padded head dim)
    # and of K2 (dtype)
    k5 = pa.kernel_attributes()
    for a in k5:
        if a["nq"] in (1, 8) and a["head_dim_pad"] == 64:
            log(f"[build] paged_attention_kernel<{a['dtype']}, nq "
                f"{a['nq']}, D {a['head_dim_pad']}>: {a['registers']} "
                f"registers, {a['static_smem']} bytes of static and "
                f"{a['dynamic_smem']} of dynamic shared memory, "
                f"{a['local_bytes']} bytes of local memory per thread")
    log(f"[build] paged_attention_kernel: {len(k5)} instances, registers "
        f"{min(a['registers'] for a in k5)}..{max(a['registers'] for a in k5)}"
        f", local memory {sorted({a['local_bytes'] for a in k5})}")
    if any(a["local_bytes"] for a in k5):
        raise AssertionError(f"the paged-attention kernels must run without "
                             f"local memory (spills): {k5}")
    k2 = aa.kernel_attributes()
    for name, (regs, lmem, smem, dyn) in k2.items():
        log(f"[build] additive_attention_kernel<{name}>: {regs} registers, "
            f"{smem} bytes of static and up to {dyn} of dynamic shared "
            f"memory, {lmem} bytes of local memory per thread")
    if any(a[1] for a in k2.values()):
        raise AssertionError(f"the additive-attention kernels must run "
                             f"without local memory (spills): {k2}")


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


def k5_case(g, *, H: int, h_kv: int, D: int, ps: int, dtype,
            layout: str, ctx: int = 768, S: int = 6, dev="cuda"):
    """Random pools and page tables for S slots of up to `ctx` tokens.
    'decode': one row per slot (R = S).  'edge': the decode rows of slots
    2, 3, 4 (slot 2 of length 1; slot 3 at the full context, longer than
    one split, while the others leave their last splits without a live
    token), a 40-row prompt chunk of slot 0 from row 3, the 21-row chunk
    of slot 1 right after it, the decode rows of slots 5.., and 5 padding rows on the
    all-zero table row S (length 1)."""
    maxp = -(-ctx // ps)
    cap = maxp * ps
    P = 1 + S * maxp
    k = torch.randn(P, ps, h_kv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(P, ps, h_kv, D, generator=g, device=dev).to(dtype)
    lens = torch.randint(40, cap + 1, (S,), generator=g, device=dev).cpu()
    lens[2], lens[3] = 1, cap
    table = torch.zeros(S + 1, maxp, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=g, device=dev).cpu() + 1
    for s in range(S):
        n = -(-int(lens[s]) // ps)
        table[s, :n] = perm[s * maxp:s * maxp + n]
    if layout == "decode":
        slots, lengths = list(range(S)), lens.tolist()
    else:
        def chunk(s, n):
            return [s] * n, list(range(int(lens[s]) - n + 1,
                                       int(lens[s]) + 1))
        a_slot, a_len = chunk(0, 40)
        b_slot, b_len = chunk(1, 21)
        rest = list(range(5, S))
        slots = [2, 3, 4] + a_slot + b_slot + rest + [S] * 5
        lengths = ([int(lens[s]) for s in (2, 3, 4)] + a_len + b_len
                   + [int(lens[s]) for s in rest] + [1] * 5)
    row_slot = torch.tensor(slots, dtype=torch.int32, device=dev)
    q = torch.randn(len(slots), H, D, generator=g, device=dev).to(dtype)
    return (q, k, v, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev), row_slot)


K5_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def k5_error(args, **kw) -> float:
    """The kernel against its plain version in float32 on the same inputs
    (max abs error); raises on a non-finite output.  A row_slot of None:
    row r reads table row r."""
    from paddle_tpu_torch.ops import paged_attention as pa
    q, k, v, table, lengths, row_slot = args
    launch = pa._launch if kw else pa.paged_attention      # kw: pins
    got = launch(q, k, v, table, lengths, row_slot=row_slot, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q.float(), k.float(), v.float(), table,
                                    lengths, row_slot=row_slot)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("paged_attention kernel: non-finite output")
    return float((got.float() - want).abs().max())


# the [kernel] edge grid: (H, H_kv, D, page size, context) for each dtype
# and layout: rep 1, 2, 4, 8 at D 64 and page sizes 8, 16, 32, at D 32 and
# 128 (page size 16); contexts of 4096 (8 splits of 512; with pages of 2 a
# split spans more page indices than the kernel keeps on chip); rep 3 at
# D 40 (a padded head, pages of 48), and D 33 with pages of 5 (no 16-byte
# rows)
K5_EDGE = ([(8, h_kv, 64, ps, 768) for h_kv in (8, 4, 2, 1)
            for ps in (8, 16, 32)]
           + [(8, h_kv, D, 16, 768) for h_kv in (8, 4, 2, 1)
              for D in (32, 128)]
           + [(8, 8, 64, 16, 4096), (8, 4, 128, 32, 4096),
              (8, 8, 64, 2, 4096), (6, 2, 40, 48, 768), (3, 1, 33, 5, 770)])


def k5_repeat_and_graph() -> None:
    """Two identical launches at the serving run's mixed shape give the same
    bits; one decode launch captured in a CUDA graph replays equal to eager
    bit for bit."""
    from paddle_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    args = make_case(g, rows="mixed", H=8, h_kv=8, D=64, ps=16,
                     dtype=torch.bfloat16)
    q, k, v, table, lengths, row_slot = args
    one = pa.paged_attention(q, k, v, table, lengths, row_slot=row_slot)
    two = pa.paged_attention(q, k, v, table, lengths, row_slot=row_slot)
    torch.cuda.synchronize()
    same = torch.equal(one, two)
    q, k, v, table, lengths, _ = make_case(
        g, rows="decode", H=8, h_kv=8, D=64, ps=16, dtype=torch.bfloat16)
    table = table[:16].contiguous()
    eager = pa.paged_attention(q, k, v, table, lengths)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(q, k, v, table, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pa.paged_attention(q, k, v, table, lengths)
    graph.replay()
    torch.cuda.synchronize()
    replay = torch.equal(captured, eager)
    log(f"[kernel] two mixed launches bit-identical: {same}; a decode "
        f"launch replayed from a CUDA graph equal to eager bit for bit: "
        f"{replay}")
    if not (same and replay):
        raise AssertionError("paged_attention kernel: repeat or graph replay "
                             "differs")


def phase_kernel() -> float:
    from paddle_tpu_torch.ops import paged_attention as pa
    rng = torch.Generator(device="cuda")
    rng.manual_seed(0)
    worst = 0.0
    for dtype, atol in K5_ATOL.items():
        for rows in ("decode", "mixed"):
            for ps in (16, 8):
                for H, h_kv in ((8, 8), (8, 2)):
                    args = make_case(rng, rows=rows, H=H, h_kv=h_kv, D=64,
                                     ps=ps, dtype=dtype)
                    if rows == "decode":        # as the engine calls it
                        args = args[:5] + (None,)
                    err = k5_error(args)
                    lengths = args[4]
                    ok = err <= atol
                    log(f"[kernel] {str(dtype)[6:]:8s} {rows:6s} ps={ps:2d} "
                        f"H={H} H_kv={h_kv} R={args[0].shape[0]:2d} "
                        f"len={int(lengths.min())}..{int(lengths.max())} "
                        f"max_abs_err={err:.3e} (atol {atol:g}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"paged_attention kernel disagrees with its plain "
                            f"version: {err} > {atol}")
                    if dtype == torch.float32:
                        worst = max(worst, err)
    # the edge grid
    errs = {}
    for dtype, atol in K5_ATOL.items():
        for layout in ("decode", "edge"):
            for H, h_kv, D, ps, ctx in K5_EDGE:
                args = k5_case(rng, H=H, h_kv=h_kv, D=D, ps=ps, dtype=dtype,
                               layout=layout, ctx=ctx)
                err = k5_error(args)
                if layout == "decode":          # rows reading their own
                    err = max(err, k5_error(args[:5] + (None,)))
                R, maxp = args[0].shape[0], args[3].shape[1]
                name = (f"{str(dtype)[6:]} {layout} rep={H // h_kv} D={D} "
                        f"ps={ps} ctx={maxp * ps}")
                errs[name] = err
                if err > atol:
                    raise AssertionError(
                        f"paged_attention kernel disagrees with its plain "
                        f"version at {name} (R={R}, splits "
                        f"{pa.split_plan(R, args[3].shape[0], maxp, ps)})"
                        f": {err} > {atol}")
                if dtype == torch.float32:
                    worst = max(worst, err)
    for dtype in K5_ATOL:
        tag = str(dtype)[6:]
        mine = {n: e for n, e in errs.items() if n.startswith(tag)}
        top = max(mine, key=mine.get)
        log(f"[kernel] edge grid {tag}: {len(mine)} cases (decode and edge "
            f"layouts; rep 1-8; D 32, 33, 40, 64, 128; pages 2-48; contexts "
            f"to 4096) within atol {K5_ATOL[dtype]:g}; worst {mine[top]:.3e} "
            f"({top})")
    k5_repeat_and_graph()
    return worst


def launch_bytes_flops(args, elem: int) -> tuple[float, float]:
    """Bytes the call must move (live K/V pages read once, q read, out
    written, index arrays read) and the flops it does (QK and PV)."""
    q, k_pages, _, table, lengths, row_slot = args
    R, H, D = q.shape
    _, ps, h_kv, _ = k_pages.shape
    tbl = table.cpu().numpy()
    lens = lengths.cpu().numpy().astype(np.int64)
    rs = np.arange(R) if row_slot is None else row_slot.cpu().numpy()
    pages = set()
    for r in range(R):
        pages.update(tbl[rs[r], :-(-int(lens[r]) // ps)].tolist())
    kv_bytes = 2 * len(pages) * ps * h_kv * D * elem
    index_bytes = 4 * (2 * R + tbl.shape[1] * len(set(rs.tolist())))
    nbytes = kv_bytes + 2 * q.numel() * elem + index_bytes
    flops = 4.0 * H * D * float(lens.sum())
    return nbytes, flops


# ~50 ms of GPU clock cycles: the timed calls queue behind a sleep kernel
# this long, so the CUDA events around them read the device's time
SLEEP_CYCLES = 100_000_000


def time_launches(fn, launches) -> float:
    """Mean ms of fn over the recorded launches, each timed with CUDA
    events after a write of more than the L2 cache, as a launch in the
    layer loop finds it (the other layers' pools pass through L2 between
    two launches on one layer's pools).  Queued behind the same sleep as
    `time_call`."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for q, k, v, table, lengths, row_slot in launches[:4]:      # warm-up
        fn(q, k, v, table, lengths, row_slot=row_slot)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
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


def k5_pinned(splits: int):
    """K5's launch with the split count pinned; measurement only."""
    from paddle_tpu_torch.ops import paged_attention as pa

    def launch(q, k, v, table, lengths, row_slot=None):
        return pa._launch(q, k, v, table, lengths, row_slot=row_slot,
                          splits=splits)
    return launch


# rounds of the [serve] timing: each variant is timed once a round, the
# order reversed from round to round, so drift shows as spread
K5_ROUNDS = 3


def k5_serve_timings(parts: dict, smi: str) -> dict:
    """K5 at the serving run's recorded layer-0 launches, per part (all,
    decode, mixed): the plan's launch, the split count pinned to 1, 2, 4,
    8, and the decode launches (row_slot None, as the engine passes it)
    with an explicit row_slot of arange(R), the form the kernel's first
    version was timed in; each variant K5_ROUNDS times.  Logs the median and the range
    of each, and the bound; returns {part: (median ms of the plan's launch,
    bound ms, bytes ms, flops ms)}."""
    from paddle_tpu_torch.ops import paged_attention as pa
    out = {}
    for what, launches_of in parts.items():
        variants = {"plan": (pa.paged_attention, launches_of)}
        variants.update({f"splits {n}": (k5_pinned(n), launches_of)
                         for n in (1, 2, 4, 8)})
        if any(a[5] is None for a in launches_of):
            given = [a if a[5] is not None else a[:5] + (torch.arange(
                a[0].shape[0], dtype=torch.int32, device=a[0].device),)
                for a in launches_of]
            variants["row_slot given"] = (pa.paged_attention, given)
        runs = {name: [] for name in variants}
        order = list(variants)
        for k in range(K5_ROUNDS):
            for name in (order if k % 2 == 0 else order[::-1]):
                runs[name].append(time_launches(*variants[name]))
        med = {n: float(np.median(t)) for n, t in runs.items()}
        bound = [launch_bytes_flops(a, 2) for a in launches_of]
        bytes_ms = float(np.mean([b for b, _ in bound])) / HBM_BYTES_PER_S \
            * 1e3
        flops_ms = float(np.mean([f for _, f in bound])) / \
            PEAK_FLOPS[torch.bfloat16] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        out[what] = (med["plan"], bound_ms, bytes_ms, flops_ms)
        rows = sorted({a[0].shape[0] for a in launches_of})
        plans = sorted({(a[0].shape[0], a[3].shape[0],
                         pa.split_plan(a[0].shape[0], a[3].shape[0],
                                       a[3].shape[1], a[1].shape[1]))
                        for a in launches_of})
        log(f"[serve] kernel at the run's {len(launches_of)} layer-0 "
            f"{what} launches (rows {rows[0]}..{rows[-1]}; (rows, table "
            f"rows, (splits, tokens)) "
            + ", ".join(str(p) for p in plans)
            + f"): {med['plan'] * 1e3:.2f} us/launch; bound "
            f"{bound_ms * 1e3:.3f} us ({bytes_ms * 1e3:.3f} bytes, "
            f"{flops_ms * 1e3:.4f} flops) = {bound_ms / med['plan']:.1%} of "
            f"the bound [{smi}]")
        log(f"[serve]   {what}: median (min..max) of {K5_ROUNDS} rounds, "
            f"us/launch: "
            + "; ".join(f"{n} {med[n] * 1e3:.2f} ({min(t) * 1e3:.2f}.."
                        f"{max(t) * 1e3:.2f})" for n, t in runs.items()))
    return out


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
            recorded.append((q.clone(), k_pages, v_pages, page_table.clone(),
                             lengths.clone(),
                             None if row_slot is None else row_slot.clone()))
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

    def serve_eight():
        # the first 8 requests (all 32 make the profiler's post-processing
        # take minutes)
        steps0 = eng.n_decode_steps
        eng.run(reqs[:8])
        return eng.n_decode_steps - steps0

    profile_run(serve_eight, "8 requests", smi, family="paged_attention")

    # the same requests with multi-step decode (windows as CUDA graphs)
    engk = ServingEngine(ex, params, num_slots=16, page_size=16,
                         max_context=768, decode_steps=KSTEP)
    # warm-up: windows with a sampling slot, then all-greedy ones (each
    # variant's first window runs eagerly, its second is captured)
    engk.run(serve_requests(4, vocab, seed=7, lo=8, hi=80, max_new=12,
                            sampled_every=2))
    engk.run(serve_requests(2, vocab, seed=8, lo=8, hi=80, max_new=12))
    kstep_serving({1: eng, KSTEP: engk},
                  lambda: serve_requests(32, vocab, seed=1, lo=32, hi=256,
                                         max_new=64, sampled_every=4),
                  results, layers, smi)
    del engk
    # a decode launch has a row per table row, a mixed one more rows
    parts = {"all": recorded,
             "decode": [a for a in recorded if a[0].shape[0] <= a[3].shape[0]],
             "mixed": [a for a in recorded if a[0].shape[0] > a[3].shape[0]]}
    times = k5_serve_timings(parts, smi)
    kern_ms, bound_ms, bytes_ms, flops_ms = times["all"]
    plain_ms = time_launches(pa.paged_attention_plain, recorded)
    log(f"[serve] kernel over all {len(recorded)} layer-0 launches "
        f"{kern_ms * 1e3:.2f} us/launch (first version: 59.27, timed with "
        f"an explicit row_slot on its decode launches; these pass None, as "
        f"the engine does); plain version {plain_ms * 1e3:.2f} us; no "
        f"single PyTorch call computes paged attention, so no library time "
        f"[{smi}]")
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_paged.py:104",
            "launches": launches, "max_abs_err": kernel_err,
            "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def dev_us(e) -> float:
    """A profiler row's device time in µs (`device_rows`)."""
    return e.self_device_time_total


# host calls that start work on the card: kernel launches (runtime and
# driver API, cluster and cooperative forms) and CUDA graph launches
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                     "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")


# seconds spent by the profiler around the runs it profiles (starting,
# collecting, summing the events), logged at the end
PROFILER_SECONDS = [0.0]


def device_rows(prof) -> tuple[list, int]:
    """A finished torch.profiler session's device events summed by name,
    as `key_averages()` rows give them (`key`: the demangled name,
    `count`, `self_device_time_total` in µs), and its host launch calls:
    kernel launches plus graph launches, each API entry point counted by
    its name's prefix.  Summed from the profiler's raw events:
    `key_averages()` first builds a Python event tree, minutes over a long
    run's host operators."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name

    by_name: dict = {}
    calls = 0
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0, 0])
            row[0] += 1
            row[1] += e.duration_ns()
        elif e.name().startswith(HOST_LAUNCH_CALLS):
            calls += 1
    rows: dict = {}
    for name, (n, ns) in by_name.items():
        key = _rewrite_name(name, with_wildcard=True)
        row = rows.setdefault(key, types.SimpleNamespace(
            key=key, count=0, self_device_time_total=0.0))
        row.count += n
        row.self_device_time_total += ns / 1e3
    return list(rows.values()), calls


def profiled(run):
    """run() under torch.profiler (host operators and the card's
    activity): (what it returned, wall ms, the device events and the host
    launch calls as `device_rows` sums them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, calls = device_rows(prof)
    PROFILER_SECONDS[0] += time.perf_counter() - start - wall_ms / 1e3
    return out, wall_ms, kernels, calls


# each hand-written kernel's symbol (paddle_tpu_torch/csrc/*.cu) and the
# launch counter of its wrapper (module of paddle_tpu_torch.ops, attribute
# of its `counts`); the wrappers of the recurrent kernels also launch
# helper kernels (the weight-gradient sums), not listed
KERNEL_COUNTERS = {
    "paged_attention_kernel": ("paged_attention", "kernel"),
    "flash_fwd_kernel": ("flash_attention", "fwd"),
    "flash_bwd_dq_kernel": ("flash_attention", "bwd_dq"),
    "flash_bwd_dkv_kernel": ("flash_attention", "bwd_dkv"),
    "flash_fwd_tc_kernel": ("flash_attention", "fwd_tc"),
    "flash_bwd_dq_tc_kernel": ("flash_attention", "bwd_dq_tc"),
    "flash_bwd_dkv_tc_kernel": ("flash_attention", "bwd_dkv_tc"),
    "lstm_fwd_kernel": ("lstm_fused", "fwd"),
    "lstm_bwd_kernel": ("lstm_fused", "bwd"),
    "gru_fwd_kernel": ("gru_fused", "fwd"),
    "gru_bwd_kernel": ("gru_fused", "bwd"),
    "additive_attention_kernel": ("additive_attention", "kernel"),
}
COUNTED_OPS = ("paged_attention", "flash_attention", "lstm_fused",
               "gru_fused", "additive_attention")


def op_counts(module: str):
    import importlib
    return importlib.import_module(f"paddle_tpu_torch.ops.{module}").counts


def reset_counts() -> None:
    """Every kernel wrapper's launch counts and plain-version calls to 0."""
    for m in COUNTED_OPS:
        op_counts(m).reset()


def wrapper_counts(symbols) -> dict:
    """The wrappers' launch counts of the kernels `symbols`."""
    return {s: getattr(op_counts(KERNEL_COUNTERS[s][0]), KERNEL_COUNTERS[s][1])
            for s in symbols}


def plain_calls() -> dict:
    """The calls of every kernel's plain PyTorch version, by op."""
    return {m: op_counts(m).plain for m in COUNTED_OPS}


def device_launches(kernels, symbols) -> dict:
    """Launches on the card by kernel symbol, from the profiler's kernel
    events (a CUDA graph's replay shows each kernel it launched): the
    events whose name holds the symbol as a whole identifier."""
    out = {}
    for sym in symbols:
        pat = re.compile(rf"(?<!\w){sym}(?!\w)")
        out[sym] = sum(e.count for e in kernels if pat.search(e.key))
    return out


def check_launches(what: str, kernels, want: dict, replayed: bool,
                   wrappers: Optional[dict] = None) -> str:
    """Hold a profiled run against `want` ({symbol: launches}), the counts
    set to 0 before the run; no plain version may have run.  An eager run
    (`replayed` False) is held by the wrappers' counts, which move where a
    kernel launches; the profiler's kernel events are logged beside them,
    as they can list one launch fewer than were made (PERF.md §7).  A run
    with graph replays is held by the profiler's kernel events, the record
    of what a replay launched, and the wrappers must have counted
    `wrappers` (unless None): the launches made outside a replay, eagerly
    or into a capture.  Returns a line for the log."""
    on_card = device_launches(kernels, want)
    counted = wrapper_counts(want)
    plain = plain_calls()
    held = on_card if replayed else counted
    if (held != want or any(plain.values())
            or (replayed and wrappers is not None and counted != wrappers)):
        raise AssertionError(
            f"{what}: kernel launches listed by the profiler {on_card}, "
            f"counted by the wrappers {counted} (want {want} held by "
            f"{'the profiler' if replayed else 'the wrappers'}, wrappers "
            f"{wrappers}); plain calls {plain}")
    return (f"launches {({s: n for s, n in want.items() if n})} as the "
            f"path says, held by "
            f"{'the profiler' if replayed else 'the wrappers'}; of "
            f"{sum(want.values())} the profiler listed "
            f"{sum(on_card.values())}, the wrappers counted "
            f"{sum(counted.values())}; plain versions 0")


def kstep_serving(engines: dict, reqs_fn, want: dict, layers: int,
                  smi: str) -> dict:
    """The serving run's requests on the k = 1 engine and on the engine
    with decode_steps=KSTEP (its windows CUDA graphs), KSTEP_ROUNDS
    rounds, the order swapped each round: each run's tokens equal `want`
    (the k = 1 run's) and no plain version runs; tokens/s, ms/step and
    windows; then a profiled run over 8 requests: device ms/step, busy
    share, kernels and host launch calls per step, and the
    paged-attention kernel launched on the card once per layer per
    forward (decode and mixed steps, window bodies), the wrapper counting
    only the forwards outside the windows (each window a graph's
    replay)."""
    syms = ("paged_attention_kernel",)
    rows = {1: [], KSTEP: []}
    order = sorted(engines)

    def counters(eng):
        return (eng.n_decode_steps, eng.n_scan_flushes, eng.n_scan_steps,
                eng.tokens_generated)

    for r in range(KSTEP_ROUNDS):
        for k in (order if r % 2 == 0 else order[::-1]):
            eng = engines[k]
            n0 = counters(eng)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eng.run(reqs_fn())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps, flushes, bodies, tokens = (
                x - y for x, y in zip(counters(eng), n0))
            same = sorted(results) == sorted(want) and all(
                np.array_equal(results[i], want[i]) for i in want)
            if not same:
                raise AssertionError(f"[serve] decode_steps={k}: tokens "
                                     f"differ from the k = 1 run")
            if any(plain_calls().values()):
                raise AssertionError(f"[serve] decode_steps={k}: plain "
                                     f"calls {plain_calls()}")
            n0 = counters(eng)
            reset_counts()
            out, pwall, kernels, calls = profiled(
                lambda: eng.run(reqs_fn()[:8]))
            psteps, pflushes, pbodies, _ = (
                x - y for x, y in zip(counters(eng), n0))
            eager = psteps - pflushes
            line = check_launches(
                f"[serve] decode_steps={k}", kernels,
                {syms[0]: layers * (eager + pbodies)}, k > 1,
                {syms[0]: layers * eager})
            busy = sum(dev_us(e) for e in kernels) / 1e3
            n_kern = sum(e.count for e in kernels)
            rows[k].append(dict(tokens_s=tokens / wall,
                                ms_step=wall / steps * 1e3, steps=steps,
                                flushes=flushes, dev_ms=busy / psteps,
                                busy=busy / pwall, kernels=n_kern / psteps,
                                calls=calls / psteps))
            log(f"[serve] decode_steps={k} round {r + 1}: {len(results)} "
                f"requests, tokens as at k=1; {steps} steps ({flushes} "
                f"windows of {k}, {bodies} bodies), {tokens} tokens in "
                f"{wall:.3f}s = {tokens / wall:.1f} tokens/s, "
                f"{wall / steps * 1e3:.2f} ms/step; profiled 8 requests: "
                f"{psteps} steps ({pflushes} windows), device "
                f"{busy / psteps:.2f} ms/step, busy {busy / pwall:.1%} of "
                f"{pwall:.1f} ms, {n_kern / psteps:.0f} kernels and "
                f"{calls / psteps:.1f} host launch calls a step; {line} "
                f"[{smi}]")
    graphs = [g for g in engines[KSTEP]._windows[KSTEP].graphs.values()
              if g is not None]
    replays = sum(g.replays for g in graphs)
    log(f"[serve] decode_steps={KSTEP}: {len(graphs)} captured window "
        f"graph(s) (all-greedy / sampling), replayed {replays} times")
    if replays < 1:
        raise AssertionError("[serve] no window replayed from a CUDA graph")
    return rows


def profile_run(run, what: str, smi: str, family: str = "") -> None:
    """run() once more under torch.profiler (it returns the number of steps
    it made): the device's busy share of the wall time and the kernels that
    take it; with `family`, also the share of the kernels whose symbol
    contains it."""
    steps, wall_ms, kernels, _ = profiled(run)
    if not kernels:
        log(f"[profile] {what}: wall {wall_ms:.1f} ms (profiler on); device "
            f"time not measured: the profiler saw no CUDA events")
        return
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    log(f"[profile] {what}: wall {wall_ms:.1f} ms over {steps} steps "
        f"(profiler on); device busy {busy_ms:.1f} ms = "
        f"{busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}; "
        f"{n_launch} kernel launches = {n_launch / steps:.0f}/step [{smi}]")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[profile]   {dev_us(e) / 1e3:8.2f} ms {e.count:6d}x "
            f"{dev_us(e) / busy_ms / 10:5.1f}%  {e.key[:90]}")
    if family:
        fam = [e for e in kernels if family in e.key]
        fam_ms = sum(dev_us(e) for e in fam) / 1e3
        log(f"[profile]   kernels matching {family!r}: {fam_ms:.2f} ms in "
            f"{sum(e.count for e in fam)} launches = {fam_ms / busy_ms:.1%} "
            f"of the device time, {fam_ms / steps:.3f} ms/step")


# steps per dispatch (training) and decode steps per window (serving) of
# the k-step runs, each held bit for bit against its k = 1 run
KSTEP = 4
KSTEP_ROUNDS = 2        # k = 1 and k = KSTEP alternate their order per round


def pass_with_losses(tr, batches, k: int):
    """tr.train_one_pass(batches, steps_per_dispatch=k) keeping every
    step's loss: (pass statistics without the times, losses as a tensor)."""
    seen = []
    drain = tr._drain_losses

    def keep():
        if tr._loss_buf:
            seen.append(torch.stack(tr._loss_buf).float())
        return drain()

    tr._drain_losses = keep
    try:
        stats = tr.train_one_pass(batches, steps_per_dispatch=k)
    finally:
        del tr._drain_losses
    stats = {n: v for n, v in stats.items()
             if n not in ("seconds", "samples_per_sec")}
    return stats, torch.cat(seen)


def training_state_differs(a, b) -> list:
    """The names of the parts of two trainers' state that are not
    bit-identical: parameters, optimizer slots, counters, the dropout
    generator."""
    bad = [n for n, p in a.params.items() if not torch.equal(p, b.params[n])]
    bad += [f"{n}.{k}" for n, sl in a.opt_state["slots"].items()
            for k, v in sl.items()
            if not torch.equal(v, b.opt_state["slots"][n][k])]
    bad += [c for c in ("num_samples", "num_updates", "pass_id")
            if a.opt_state[c] != b.opt_state[c]]
    if not torch.equal(a.dropout_rng.get_state(), b.dropout_rng.get_state()):
        bad.append("dropout_rng")
    return bad


def kstep_training(tag: str, smi: str, make, batches: list, route,
                   unit: tuple, timed: int = 8,
                   profiled_steps: int = 4) -> dict:
    """Two trainers from one seed on the same batches, one through the
    k = 1 loop, one through the fused dispatch at KSTEP (a group of KSTEP
    steps one replay of a CUDA graph): a warm-up pass of 2 KSTEP batches
    (the fused trainer's first step runs eagerly, the rest of its group
    and the next group are captured and replayed), then KSTEP_ROUNDS
    rounds, each a timed pass of `timed` batches and a profiled pass of
    `profiled_steps` batches per mode, the two modes' order swapped each
    round.  After every pass both hold the same parameters, optimizer
    slots, counters and dropout generator, their losses and pass
    statistics are the same, bit for bit.  The counts are set to 0 before
    each pass: no plain version runs, and in the profiled pass the card
    launched each kernel as `route(batch)` ({symbol: launches}) says,
    summed over the batches, whatever the mode; the wrappers counted all
    of them at k = 1 and none at KSTEP (every step a replay).  Logs per
    mode and round: wall ms/step and `unit` per second, device ms/step
    and busy share, kernels on the device and host launch calls per step.
    Returns {k: [per-round figures]}."""
    per, what = unit
    t1, tk = make(), make()
    pairs = ((t1, 1), (tk, KSTEP))
    pos = 2 * KSTEP
    for tr, k in pairs:
        pass_with_losses(tr, batches[:pos], k)
    torch.cuda.synchronize()
    rows = {1: [], KSTEP: []}
    for r in range(KSTEP_ROUNDS):
        timed_b = batches[pos:pos + timed]
        prof_b = batches[pos + timed:pos + timed + profiled_steps]
        pos += timed + profiled_steps
        if len(prof_b) != profiled_steps:
            raise ValueError("kstep_training: too few batches")
        want = route_total(route, prof_b)
        results = {}
        for tr, k in (pairs if r % 2 == 0 else pairs[::-1]):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats, losses = pass_with_losses(tr, timed_b, k)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / timed
            if any(plain_calls().values()):
                raise AssertionError(f"{tag} k={k}: plain calls "
                                     f"{plain_calls()}")
            reset_counts()
            (st2, l2), pwall, kernels, calls = profiled(
                lambda: pass_with_losses(tr, prof_b, k))
            line = check_launches(f"{tag} k={k}", kernels, want, k > 1,
                                  {s: 0 for s in want})
            busy = sum(dev_us(e) for e in kernels) / 1e3
            n_kern = sum(e.count for e in kernels)
            results[k] = (stats, losses, st2, l2)
            rows[k].append(dict(wall_ms=wall, per_s=per * 1e3 / wall,
                                dev_ms=busy / profiled_steps,
                                busy=busy / pwall,
                                kernels=n_kern / profiled_steps,
                                calls=calls / profiled_steps))
            log(f"{tag} k={k} round {r + 1}: {wall:.2f} ms/step wall = "
                f"{per * 1e3 / wall:.1f} {what}/s over {timed} steps; "
                f"profiled {profiled_steps} steps: device "
                f"{busy / profiled_steps:.2f} ms/step, busy "
                f"{busy / pwall:.1%} of {pwall / profiled_steps:.2f} "
                f"ms/step, {n_kern / profiled_steps:.0f} kernels and "
                f"{calls / profiled_steps:.1f} host launch calls (kernel "
                f"and graph launches) a step; {line} [{smi}]")
        a, b = results[1], results[KSTEP]
        same_stats = a[0] == b[0] and a[2] == b[2]
        same_losses = torch.equal(a[1], b[1]) and torch.equal(a[3], b[3])
        differ = training_state_differs(t1, tk)
        log(f"{tag} round {r + 1}: k={KSTEP} against k=1: pass statistics "
            f"{'equal' if same_stats else 'DIFFER'}, losses "
            f"{'bit-identical' if same_losses else 'DIFFER'}, parameters, "
            f"slots, counters and dropout generator "
            f"{'bit-identical' if not differ else 'DIFFER: ' + str(differ[:5])}")
        if not (same_stats and same_losses and not differ):
            raise AssertionError(f"{tag}: steps_per_dispatch={KSTEP} is not "
                                 f"bit-identical to the k = 1 loop")
    log(f"{tag} k={KSTEP}: {tk.n_fused_dispatches} group dispatches, "
        f"{tk.n_settle_steps} eager first step(s), graphs by group size "
        f"{graph_replays(tk)}")
    if not any(n for n in graph_replays(tk).values()):
        raise AssertionError(f"{tag}: the fused dispatch replayed no graph")
    del t1, tk
    torch.cuda.empty_cache()
    return rows


def route_total(route, batches) -> dict:
    """route(batch) ({kernel symbol: launches a step}) summed over
    batches."""
    total: dict = {}
    for b in batches:
        for sym, n in route(b).items():
            total[sym] = total.get(sym, 0) + n
    return total


def graph_replays(tr) -> dict:
    """A trainer's captured graphs: {(signature number, group size):
    replays}, signatures numbered in the order they were first captured."""
    sigs: dict = {}
    out = {}
    for (sig, j), steps in tr._graphs.items():
        out[(sigs.setdefault(sig, len(sigs)), j)] = steps.graph.replays
    return out


# padded lengths by batch (long 0, short 1) of the runs with two batch
# signatures: runs of 3, 2, 4 and 1, so a group of KSTEP flushes both on a
# signature change and at KSTEP
ALTERNATE = (0, 0, 0, 1, 1, 0, 0, 0, 0, 1)


def kstep_alternating(tag: str, make, long_b: list, short_b: list,
                      route) -> dict:
    """Bucketed data: batch i from long_b or short_b as ALTERNATE says,
    two passes of a k = 1 trainer and a steps_per_dispatch=KSTEP one from
    one seed.  After each pass both hold the same state, losses and pass
    statistics, bit for bit.  The second pass is profiled: the card
    launched each kernel as `route` says, summed over the batches, and no
    plain version ran.  At KSTEP both signatures have graphs (one per
    group size met), all in the trainer's one memory pool, and a graph
    was replayed after one captured later than it (replays out of capture
    order).  Returns the fused trainer's {(signature, group size):
    replays}."""
    from paddle_tpu_torch.utils import cuda_graphs as cg
    batches = [(long_b, short_b)[p][i] for i, p in enumerate(ALTERNATE)]
    want = route_total(route, batches)
    t1, tk = make(), make()
    order = []
    replay = cg.StepGraph.replay

    def logged(graph):
        order.append(graph)
        replay(graph)

    cg.StepGraph.replay = logged
    try:
        for p in range(2):
            res = {}
            for tr, k in ((t1, 1), (tk, KSTEP)):
                if p == 0:
                    res[k] = pass_with_losses(tr, batches, k)
                    continue
                reset_counts()
                res[k], _, kernels, _ = profiled(
                    lambda: pass_with_losses(tr, batches, k))
                check_launches(f"{tag} alternating k={k}", kernels, want,
                               k > 1)
            differ = training_state_differs(t1, tk)
            same = (res[1][0] == res[KSTEP][0]
                    and torch.equal(res[1][1], res[KSTEP][1]))
            if differ or not same:
                raise AssertionError(
                    f"{tag} alternating pass {p + 1}: k={KSTEP} differs "
                    f"from k=1 (statistics and losses equal: {same}; state "
                    f"{differ[:5]})")
    finally:
        cg.StepGraph.replay = replay
    rank = {id(s.graph): i for i, s in enumerate(tk._graphs.values())}
    seq = [rank[id(g)] for g in order]
    out_of_order = any(x < max(seq[:i]) for i, x in enumerate(seq) if i)
    graphs = graph_replays(tk)
    pools = {s.graph.pool for s in tk._graphs.values()}
    log(f"{tag} alternating lengths, 2 passes of {len(batches)} batches: "
        f"k={KSTEP} bit-identical to k=1 after each; graphs (signature, "
        f"group size): replays {graphs}, {len(pools)} memory pool; replay "
        f"sequence by capture order {seq}; second pass launches on the "
        f"card {({s: n for s, n in want.items() if n})} as the route says, "
        f"plain versions 0")
    if len({s for s, _ in graphs}) < 2 or not out_of_order:
        raise AssertionError(f"{tag}: the alternating run did not replay "
                             f"graphs of two signatures out of capture "
                             f"order: {graphs}, {seq}")
    del t1, tk
    torch.cuda.empty_cache()
    return graphs


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

# (name, Tq, Tk, H_kv, causal, window, q_offset, k_offset, ragged keys)
FLASH_CASES = [("causal", 2048, 2048, 8, True, None, 0, 0, False),
               ("causal-gqa", 2048, 2048, 2, True, None, 0, 0, False),
               ("full", 2048, 2048, 8, False, None, 0, 0, False),
               ("full-gqa", 2048, 2048, 2, False, None, 0, 0, False),
               ("ragged", 1536, 2048, 2, False, None, 0, 0, True),
               ("window", 2048, 2048, 8, True, 256, 0, 0, False),
               ("offsets", 2048, 2048, 2, True, None, 1000, 300, True)]
# o: per element |err| <= rtol * |ref| + atol.  The bfloat16 kernels compute
# in float32 and round o to bfloat16, at most 2^-8 of |ref|; at 2048 keys a
# typical |o| is a few hundredths, so an absolute limit would be as large as
# the value.  Gradients: within GRAD_TOL of their max.  lse: within 2e-5.
O_LIMIT = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-3)}
GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def o_limit_share(got, want, dtype) -> float:
    """The largest |got - want| as a share of its per-element limit
    rtol * |want| + atol (at most 1 passes)."""
    rtol, atol = O_LIMIT[dtype]
    return float(((got.float() - want).abs()
                  / (rtol * want.abs() + atol)).max())


FLASH_COUNTS = ("fwd_tc", "bwd_dq_tc", "bwd_dkv_tc", "fwd", "bwd_dq",
                "bwd_dkv", "plain")


def flash_route(layers: int, dtype):
    """The flash kernels an LM training step launches on the card: dtype's
    three once per layer, the other dtype's none."""
    tc = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
          "flash_bwd_dkv_tc_kernel")
    f32 = tuple(s.replace("_tc", "") for s in tc)
    mine = tc if dtype == torch.bfloat16 else f32
    step = {s: (layers if s in mine else 0) for s in tc + f32}
    return lambda batch: step


def flash_counts() -> tuple:
    """The flash launch counts in FLASH_COUNTS order: the bf16 kernels, the
    fp32 ones, the plain versions."""
    from paddle_tpu_torch.ops import flash_attention as fa
    return tuple(getattr(fa.counts, n) for n in FLASH_COUNTS)


def flash_errors(q, k, v, kvm, do, dlse, **mask):
    """The three flash kernels on these inputs against their plain versions
    in float32 on the same inputs.  The backward is compared from the
    kernel's own o and lse, so each check isolates one kernel.  Returns the
    errors (with "ok"), the kernel's (o, lse) and the plain version's o.
    "ok" also needs one launch of each kernel of q's dtype's route
    (flash_attention_tc.cu for bf16, flash_attention.cu for fp32) and none
    of the other."""
    from paddle_tpu_torch.ops import flash_attention as fa
    c0 = flash_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, kvm, **mask)
    got = fa.flash_attention_bwd(q, k, v, kvm, o, lse, do, dlse, **mask)
    torch.cuda.synchronize()
    ran = tuple(b - a for a, b in zip(c0, flash_counts()))
    route = ((1, 1, 1, 0, 0, 0, 0) if q.dtype == torch.bfloat16
             else (0, 0, 0, 1, 1, 1, 0))
    f = [x.float() for x in (q, k, v)]
    want_o, want_lse = fa.flash_attention_plain(*f, kvm, **mask)
    want = fa.flash_attention_bwd_plain(*f, kvm, o.float(), lse, do.float(),
                                        dlse, **mask)
    fin = torch.isfinite(want_lse)
    e = {"o": float((o.float() - want_o).abs().max()),
         "o_share": o_limit_share(o, want_o, q.dtype),
         "lse": float((lse[fin] - want_lse[fin]).abs().max())}
    for n, a, b in zip(("dq", "dk", "dv"), got, want):
        e[n] = float((a.float() - b).abs().max())
        e[n + "_rel"] = e[n] / float(b.abs().max())
    e["ok"] = (ran == route and e["o_share"] <= 1 and e["lse"] <= 2e-5
               and max(e["dq_rel"], e["dk_rel"], e["dv_rel"])
               <= GRAD_TOL[q.dtype]
               and torch.equal(torch.isfinite(lse), fin)
               and all(bool(torch.isfinite(t).all()) for t in (o, *got)))
    return e, (o, lse), want_o


def flash_line(e: dict, dtype) -> str:
    rtol, atol = O_LIMIT[dtype]
    return (f"o {e['o']:.2e} = {e['o_share']:.3f} of its limit ({rtol:g}"
            f"|ref| + {atol:g}) lse {e['lse']:.2e} (2e-05) dq/dk/dv "
            f"{e['dq_rel']:.2e}/{e['dk_rel']:.2e}/{e['dv_rel']:.2e} of max "
            f"(tol {GRAD_TOL[dtype]:g}) {'ok' if e['ok'] else 'FAIL'}")


def flash_repeats(q, k, v, kvm, do, **mask) -> bool:
    """The three flash kernels of q's dtype, each launched twice on the same
    inputs: bit-identical outputs (one owner per dK/dV tile, no atomics)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    scale = q.shape[-1] ** -0.5
    o1, l1 = fa.flash_attention_fwd(q, k, v, kvm, **mask)
    o2, l2 = fa.flash_attention_fwd(q, k, v, kvm, **mask)
    kvm8 = kvm.to(torch.uint8)
    args = (q, k, v, kvm8, do, l1, fa.backward_delta(o1, do, None),
            mask.get("causal", False), scale, mask.get("q_offset", 0),
            mask.get("k_offset", 0), mask.get("window"))
    dq1, dq2 = fa.bwd_dq_kernel(*args), fa.bwd_dq_kernel(*args)
    g1, g2 = fa.bwd_dkv_kernel(*args), fa.bwd_dkv_kernel(*args)
    torch.cuda.synchronize()
    return (torch.equal(o1, o2) and torch.equal(l1, l2)
            and torch.equal(dq1, dq2)
            and all(torch.equal(a, b) for a, b in zip(g1, g2)))


def graph_replay_equal(run) -> bool:
    """run() (a tuple of tensors) once eagerly on a side stream, then
    captured in a torch.cuda.CUDAGraph and replayed: the replay's outputs
    equal the eager ones bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(captured, eager))
    del graph
    return same


def flash_graph_replay(q, k, v, kvm, do, **mask) -> bool:
    """The three flash kernels of q's dtype (forward, then dQ and dK/dV
    from its o and lse) replayed from a CUDA graph equal eager."""
    from paddle_tpu_torch.ops import flash_attention as fa
    scale = q.shape[-1] ** -0.5
    kvm8 = kvm.to(torch.uint8)

    def run():
        o, lse = fa.flash_attention_fwd(q, k, v, kvm, **mask)
        args = (q, k, v, kvm8, do, lse, fa.backward_delta(o, do, None),
                mask.get("causal", False), scale, mask.get("q_offset", 0),
                mask.get("k_offset", 0), mask.get("window"))
        return (o, lse, fa.bwd_dq_kernel(*args)) + tuple(
            fa.bwd_dkv_kernel(*args))
    return graph_replay_equal(run)


def phase_flash() -> None:
    """The three flash kernels against their plain versions at B=2 over the
    mask cases, with a random lse cotangent: float32 (flash_attention.cu,
    three TF32 passes) and bfloat16 (flash_attention_tc.cu), each at D=64
    and D=128; then each dtype's three kernels repeated bit for bit at
    both head dims (GQA, causal)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    B, H = 2, 8
    for dtype, D in ((torch.float32, 64), (torch.float32, 128),
                     (torch.bfloat16, 64), (torch.bfloat16, 128)):
        for name, Tq, Tk, h_kv, causal, window, qo, ko, ragged in \
                FLASH_CASES:
            q, do = (torch.randn(B, Tq, H, D, generator=g,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn(B, Tk, h_kv, D, generator=g,
                                device="cuda").to(dtype) for _ in range(2))
            kvm = torch.ones(B, Tk, dtype=torch.bool, device="cuda")
            if ragged:
                kvm[0, :100] = False
                kvm[1, Tk // 2:] = False
            dlse = 0.1 * torch.randn(B, H, Tq, generator=g, device="cuda")
            e, _, _ = flash_errors(q, k, v, kvm, do, dlse, causal=causal,
                                   q_offset=qo, k_offset=ko, window=window)
            log(f"[flash] {str(dtype)[6:]:8s} D={D:<3d} {name:10s} Tq={Tq} "
                f"Tk={Tk} H={H} H_kv={h_kv} {flash_line(e, dtype)}")
            if not e["ok"]:
                raise AssertionError(f"flash kernels disagree with their "
                                     f"plain versions or took another "
                                     f"route ({dtype}, D={D}, {name})")
        q, do = (torch.randn(B, 2048, H, D, generator=g,
                             device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(B, 2048, 2, D, generator=g,
                            device="cuda").to(dtype) for _ in range(2))
        kvm = torch.ones(B, 2048, dtype=torch.bool, device="cuda")
        same = flash_repeats(q, k, v, kvm, do, causal=True)
        replay = flash_graph_replay(q, k, v, kvm, do, causal=True)
        log(f"[flash] {str(dtype)[6:]:8s} D={D:<3d} fwd, dq, dk/dv launched "
            f"twice at [{B}, 2048, {H}, {D}] H_kv=2 causal: "
            f"{'bit-identical' if same else 'DIFFER'}; replayed from a CUDA "
            f"graph: {'equal to eager bit for bit' if replay else 'DIFFER'}")
        if not (same and replay):
            raise AssertionError(f"flash kernels do not repeat or replay "
                                 f"bit for bit ({dtype}, D={D})")


def lm_batches(n: int, B: int, T: int, vocab: int, seed: int,
               motifs: int = 8, short_last: int = 0):
    """Batches of the repeated-motif token language of
    demo/model_zoo/lm_provider.py (_synthetic: `motifs` motifs of 3..7
    tokens, sequences of T + 1 tokens starting at BOS = 1), as numpy; the
    last row of each batch is `short_last` tokens shorter."""
    from paddle_tpu_torch.parameter import Argument
    motif_rng = np.random.default_rng(7)
    table = [motif_rng.integers(2, vocab, motif_rng.integers(3, 8))
             for _ in range(motifs)]
    rng = np.random.default_rng(seed)
    lens = np.full(B, T, np.int32)
    lens[-1] = T - short_last
    out = []
    for _ in range(n):
        ids = np.empty((B, T + 1), np.int32)
        for r in range(B):
            seq = [1]
            while len(seq) < T + 1:
                seq.extend(table[int(rng.integers(0, motifs))].tolist())
            ids[r] = seq[:T + 1]
        out.append({"tokens": Argument(ids=ids[:, :-1], lengths=lens),
                    "next_tokens": Argument(ids=ids[:, 1:], lengths=lens)})
    return out


def time_call(fn, n: int) -> float:
    """Mean ms of fn() over n back-to-back calls, after one warm-up call.
    The calls are queued behind a ~50 ms sleep kernel, so the CUDA events
    around them time the device's work wherever the host keeps ahead of the
    card (a short kernel's wrapper takes longer on the host than the kernel
    on the card), and the host's time only where it cannot."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def phase_train(smi: str) -> list:
    import tempfile

    from paddle_tpu_torch.models import transformer_lm_trainer_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.trainer import Trainer

    vocab, layers, B, T = 32000, 8, 8, 2048
    warm, timed = 3, 8
    cfg = transformer_lm_trainer_config(vocab=vocab, dim=512, layers=layers,
                                        heads=8, batch_size=B,
                                        compute_dtype="bfloat16")
    tr = Trainer(cfg, seed=1)
    batches = lm_batches(warm + timed + 2, B, T, vocab, seed=1)
    train_lm_steps(tr, batches, warm, timed, (layers,) * 3 + (0,) * 4,
                   "[train]", smi)
    launches = {"flash_fwd_tc": fa.counts.fwd_tc,
                "flash_bwd_dq_tc": fa.counts.bwd_dq_tc,
                "flash_bwd_dkv_tc": fa.counts.bwd_dkv_tc}

    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        tr.save(d)
        fresh = Trainer(cfg, seed=1)
        fresh.load(d)
        same = all(torch.equal(fresh.params[n], p)
                   for n, p in tr.params.items())
        same &= all(torch.equal(fresh.opt_state["slots"][n][k], v)
                    for n, sl in tr.opt_state["slots"].items()
                    for k, v in sl.items())
        same &= all(fresh.opt_state[k] == tr.opt_state[k]
                    for k in ("num_samples", "num_updates", "pass_id"))
        log(f"[train] checkpoint save -> fresh Trainer.load in "
            f"{time.perf_counter() - t1:.1f}s: parameters, Adam slots and "
            f"counters {'identical' if same else 'DIFFER'}")
        del fresh
    if not same:
        raise AssertionError("checkpoint round trip changed the state")

    def train_two():
        for b in batches[warm + timed:]:
            tr.train_one_batch(b)
        return 2

    profile_run(train_two, "2 training steps", smi)
    del tr
    torch.cuda.empty_cache()
    kstep_training("[train]", smi, lambda: Trainer(cfg, seed=1),
                   lm_batches(32, B, T, vocab, seed=3),
                   flash_route(layers, torch.bfloat16), (B * T, "tokens"))
    return flash_records(launches, B, T, torch.bfloat16, smi, "[train]")


def train_lm_steps(tr, batches, warm: int, timed: int, route: tuple,
                   tag: str, smi: str) -> None:
    """A warm-up pass over batches[:warm] (allocator, library handles; its
    cost is the mean loss of those steps), then `timed` steps with the
    flash counts reset before them: logs tokens/s and ms/step; fails on a
    non-finite loss, on a loss that did not fall (the last 3 against the
    warm-up's mean) and on a step whose flash launches (FLASH_COUNTS
    order) are not `route`."""
    from paddle_tpu_torch.ops import flash_attention as fa
    B, T = batches[0]["tokens"].ids.shape
    first = tr.train_one_pass(batches[:warm])["cost"]
    torch.cuda.synchronize()
    per_step, losses = [], []
    fa.counts.reset()
    t0 = time.perf_counter()
    for b in batches[warm:warm + timed]:
        c0 = flash_counts()
        losses.append(tr.train_one_batch(b))
        per_step.append(tuple(x - y for x, y in zip(flash_counts(), c0)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    log(f"{tag} {timed} steps of [{B}, {T}] in {wall:.3f}s = "
        f"{timed * B * T / wall:.1f} tokens/s, "
        f"{wall / timed * 1e3:.2f} ms/step; mean loss of the first {warm} "
        f"(warm-up) steps {first:.4f}, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; flash launches a step "
        f"{dict(zip(FLASH_COUNTS, per_step[0]))} [{smi}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not np.mean(losses[-3:]) < first:
        raise AssertionError(f"loss did not fall: first {warm} mean "
                             f"{first}, last 3 {losses[-3:]}")
    if any(c != route for c in per_step):
        raise AssertionError(f"the training path did not run through its "
                             f"flash kernels once per layer per step, and "
                             f"nothing else: {per_step}")


def phase_train_fp32(smi: str) -> list:
    """The LM at the config's default precision: demo/model_zoo/
    transformer_lm.py leaves compute_dtype '' (= the float32 dtype), so
    `python -m paddle_tpu train` trains it in float32.  Full width (vocab
    32000, dim 512, 8 layers, 8 heads), [8, 2048] batches, Adam lr 3e-4,
    clipping 1.0; warm-up steps, then timed steps, each launching the
    float32 flash kernels once per layer and nothing else of flash
    attention; the loss falls; tokens/s, ms/step, a profiled step; then the
    kernels' records at [8, 2048, 8, 64] fp32."""
    from paddle_tpu_torch.models import transformer_lm_trainer_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.trainer import Trainer

    vocab, layers, B, T = 32000, 8, 8, 2048
    warm, timed = 3, 5
    cfg = transformer_lm_trainer_config(vocab=vocab, dim=512, layers=layers,
                                        heads=8, batch_size=B)
    if cfg.opt_config.compute_dtype != "":
        raise AssertionError("the LM config's default precision changed")
    tr = Trainer(cfg, seed=1)
    batches = lm_batches(warm + timed + 1, B, T, vocab, seed=1)
    train_lm_steps(tr, batches, warm, timed, (0,) * 3 + (layers,) * 3 + (0,),
                   "[train-fp32]", smi)
    launches = {"flash_fwd": fa.counts.fwd, "flash_bwd_dq": fa.counts.bwd_dq,
                "flash_bwd_dkv": fa.counts.bwd_dkv}

    def train_one():
        tr.train_one_batch(batches[-1])
        return 1

    profile_run(train_one, "1 float32 training step", smi, family="flash_")
    del tr
    torch.cuda.empty_cache()
    kstep_training("[train-fp32]", smi, lambda: Trainer(cfg, seed=1),
                   lm_batches(32, B, T, vocab, seed=3),
                   flash_route(layers, torch.float32), (B * T, "tokens"))
    return flash_records(launches, B, T, torch.float32, smi, "[train-fp32]")


def flash_records(launches: dict, B: int, T: int, dtype, smi: str,
                  tag: str) -> list:
    """Each flash kernel of dtype's route at a training run's shapes
    ([B, T, 8, 64], causal, all keys valid, no lse cotangent): checked
    against its plain version in float32 on the same inputs, then timed
    beside its bound, its plain version and the library call:
    scaled_dot_product_attention's forward for the forward kernel, its
    backward for the two backward kernels together (float32 with TF32 off,
    as main() sets it).  The bound of the float32 kernels is their route's,
    three TF32 passes (PEAK_FLOPS["tf32x3"]); the CUDA cores' float32 bound
    is logged beside it.  Their records' names carry the shape, as two
    runs time them.  For bf16 (the LM training run's route) also shows
    that the o limit rejects a faulty forward: the kernel's o with one key
    tile (keys 1024..1087) masked out, and measures what the forward's
    second bf16 term of p costs: the one-term forward's time and o error
    (printed, not gated; it is on no path)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa
    H, D = 8, 64
    tc = dtype == torch.bfloat16
    suffix, what = ("_tc", "bf16") if tc else ("", "fp32")
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    kvm = torch.ones(B, T, dtype=torch.uint8, device="cuda")
    scale = D ** -0.5
    e, (o, lse), want_o = flash_errors(q, k, v, kvm, do, None, causal=True)
    log(f"{tag} flash kernels vs plain at [{B}, {T}, {H}, {D}] {what} "
        f"causal: {flash_line(e, dtype)}")
    if not e["ok"]:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at a training run's shape ({what})")
    if tc:
        dropped = kvm.clone()
        dropped[:, 1024:1088] = 0
        bad, _ = fa.flash_attention_fwd(q, k, v, dropped, True)
        bad_share = o_limit_share(bad, want_o, dtype)
        bad_abs = float((bad.float() - want_o).abs().max())
        log(f"[train] faulty forward (key tile 1024..1087 dropped): o "
            f"{bad_abs:.2e} = {bad_share:.3f} of its limit: "
            f"{'rejected' if bad_share > 1 else 'NOT rejected'}")
        if not bad_share > 1:
            raise AssertionError("the o limit does not reject a dropped key "
                                 "tile")
        del bad, dropped
        one_term = one_term_forward(q, k, v, kvm, scale)
        o1 = one_term()
        one_share = o_limit_share(o1, want_o, dtype)
        one_ms = time_call(one_term, 10)
        two_ms = time_call(lambda: fa.flash_attention_fwd(q, k, v, kvm, True),
                           10)
        log(f"[train] forward with one-term bf16 p (the TPU kernel's "
            f"rounding, measurement only): {one_ms * 1e3:.1f} us/launch "
            f"against {two_ms * 1e3:.1f} us with two terms; o "
            f"{float((o1.float() - want_o).abs().max()):.2e} = "
            f"{one_share:.3f} of its limit [{smi}]")
        del o1
    del want_o
    names = [f"flash_{k}{suffix}" for k in ("fwd", "bwd_dq", "bwd_dkv")]
    err = dict(zip(names, (max(e["o"], e["lse"]), e["dq"],
                           max(e["dk"], e["dv"]))))
    delta = fa.backward_delta(o, do, None)
    bwd = (q, k, v, kvm, do, lse, delta, True, scale, 0, 0, None)
    ms = dict(zip(names, (
        time_call(lambda: fa.flash_attention_fwd(q, k, v, kvm, True), 10),
        time_call(lambda: fa.bwd_dq_kernel(*bwd), 10),
        time_call(lambda: fa.bwd_dkv_kernel(*bwd), 10))))
    plain_fwd = time_call(lambda: fa.flash_attention_plain(q, k, v, kvm,
                                                           True), 3)
    plain_bwd = time_call(lambda: fa.flash_attention_bwd_plain(
        q, k, v, kvm, o, lse, do, None, True), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = time_call(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 10)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_bwd = time_call(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    # the work this run's inputs need: unmasked (q, k) pairs of the causal
    # mask; per pair 2 D flops per product: forward QK^T and PV (2), dQ
    # recomputes S and dP and forms dQ (3), dK/dV recompute S and dP and
    # form dV and dK (4)
    pairs = B * H * T * (T + 1) / 2
    elem = q.element_size()
    bthd, bht = B * T * H * D * elem, B * H * T * 4
    work = (4 * bthd + B * T + bht, 4 * D * pairs), \
        (5 * bthd + B * T + 2 * bht, 6 * D * pairs), \
        (6 * bthd + B * T + 2 * bht, 8 * D * pairs)
    source = f"paddle_tpu_torch/csrc/flash_attention{suffix}.cu"
    shape = "" if tc else f" [{B}, {T}, {H}, {D}]"
    records = []
    for i, (name, src_line) in enumerate(zip(names, (113, 239, 278))):
        nbytes, flops = work[i]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dtype if tc else "tf32x3"] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        plain_ms = plain_fwd if i == 0 else plain_bwd
        lib_ms = lib_fwd if i == 0 else lib_bwd
        cores = ("" if tc else f"; the CUDA cores' fp32 bound "
                 f"{flops / PEAK_FLOPS[torch.float32] * 1e6:.1f} us")
        log(f"{tag} {name} at [{B}, {T}, {H}, {D}] {what} causal: "
            f"{ms[name] * 1e3:.1f} us/launch; bound {bound_ms * 1e3:.1f} us "
            f"({'operations' if flops_ms >= bytes_ms else 'bytes'}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB{cores}) = "
            f"{bound_ms / ms[name]:.1%} of the bound; plain version "
            f"{plain_ms * 1e3:.1f} us{'' if i == 0 else ' (whole backward)'}"
            f"; scaled_dot_product_attention "
            f"{'forward' if i == 0 else 'backward'} {lib_ms * 1e3:.1f} us "
            f"[{smi}]")
        records.append({
            "name": name + shape, "route": "cuda", "source": source,
            "replaces": f"paddle_tpu/ops/pallas_attention.py:{src_line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms})
    return records


def one_term_forward(q, k, v, kvm, scale):
    """A launcher of the tensor-core forward with p rounded to one bf16 term
    in P V (flash_fwd_one_term_launch, D <= 64, causal): what the second
    term costs.  Not counted: no path runs it."""
    from paddle_tpu_torch.ops import flash_attention as fa
    lib = fa.kernel_tc.library().lib
    lib.flash_fwd_one_term_launch.argtypes = lib.flash_fwd_launch.argtypes
    lib.flash_fwd_one_term_launch.restype = ctypes.c_int
    B, Tq, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)

    def run():
        rc = lib.flash_fwd_one_term_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, Tq, k.shape[1], H, k.shape[2],
            D, float(scale), 1, -1, 0, 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"one-term forward failed: CUDA error {rc}")
        return o
    return run


def phase_train_routes(smi: str) -> list:
    """float32 training through the flash route (the float32 kernels)
    against the dense route; returns those kernels' records at this run's
    shape with the launches it made."""
    from paddle_tpu_torch.models import transformer_lm_trainer_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.trainer import Trainer

    vocab = 32000
    batch = lm_batches(1, 2, 2048, vocab, seed=3)[0]
    params = None
    got = {}
    for impl in ("auto", "dense"):
        cfg = transformer_lm_trainer_config(vocab=vocab, dim=512, layers=2,
                                            heads=8, batch_size=2,
                                            attn_impl=impl)
        if params is None:
            params = init_params(cfg.model_config, seed=1)
        tr = Trainer(cfg, params=params)
        fa.counts.reset()
        loss, grads, _ = tr.compute_gradients(tr.prepare_batch(batch))
        torch.cuda.synchronize()
        got[impl] = (float(loss), grads, flash_counts())
    (la, ga, ca), (ld, gd, cd) = got["auto"], got["dense"]
    rel_loss = abs(la - ld) / abs(ld)
    worst, worst_name = 0.0, ""
    for n, g in gd.items():
        e = float((ga[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if e > worst:
            worst, worst_name = e, n
    log(f"[train-routes] fp32, 2 layers, [2, 2048]: loss flash {la:.6f} vs "
        f"dense {ld:.6f} (rel {rel_loss:.2e}, tol 1e-5); worst gradient "
        f"{worst:.2e} of its max ({worst_name}; tol 1e-4); flash launches "
        f"{ca}, dense {cd}")
    if ca != (0, 0, 0, 2, 2, 2, 0) or cd != (0,) * 7:
        raise AssertionError(f"routes did not take their paths: {ca}, {cd}")
    if not (rel_loss <= 1e-5 and worst <= 1e-4 and set(ga) == set(gd)):
        raise AssertionError("flash and dense training routes disagree")
    del got, ga, gd, params, tr
    torch.cuda.empty_cache()
    launches = {"flash_fwd": ca[3], "flash_bwd_dq": ca[4],
                "flash_bwd_dkv": ca[5]}
    return flash_records(launches, 2, 2048, torch.float32, smi,
                         "[train-routes]")


# -- the fused LSTM (K3) and the sentiment path --------------------------------

LSTM_TOL = 1e-5                    # float32: share of each tensor's max
LSTM_NAMES = ("hs", "h_last", "c_last", "dx4", "dw", "dpeep", "dh0", "dc0")
RELU_KINK_MARGIN = 1e-4


def lstm_inputs(g, B: int, T: int, D: int, peep: bool, ragged: bool):
    """Random float32 inputs of the LSTM op on the card: (x4, lengths, w,
    peeps, h0, c0) and cotangents for (hs, h_last, c_last).  Ragged lengths
    hold a length-0 row and a full row."""
    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x4, w = r(B, T, 4 * D), r(D, 4 * D) * D ** -0.5
    peeps = r(3, D) * 0.2 if peep else torch.zeros(3, D, device="cuda")
    h0, c0 = r(B, D) * 0.5, r(B, D) * 0.5
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    if ragged:
        lens = torch.randint(max(1, T // 10), T + 1, (B,), generator=g,
                             device="cuda").to(torch.int32)
        lens[0], lens[-1] = 0, T
    return (x4, lens, w, peeps, h0, c0), (r(B, T, D), r(B, D), r(B, D))


def move_off_relu_kink(inputs, reverse: bool, **acts):
    """relu'(0) has two values, and the kernel and the plain version sum
    h.W in different orders, so a cell pre-activation within rounding of 0
    may fall on either side and change a whole row's gradient.  Nudge x4
    until no cell pre-activation of a valid step lies within
    RELU_KINK_MARGIN of 0 (the plain version says where they are)."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    x4, lens, w, peeps, h0, c0 = inputs
    B, T, D4 = x4.shape
    D = D4 // 4
    x4 = x4.clone()
    valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
    for _ in range(20):
        hs, _, _ = lf.lstm_fused_plain(x4, lens, w, peeps, h0, c0,
                                       reverse=reverse, **acts)
        h_prev = (torch.cat([hs[:, 1:], h0[:, None]], dim=1) if reverse
                  else torch.cat([h0[:, None], hs[:, :-1]], dim=1))
        ga = x4[..., :D] + h_prev @ w[:, :D]
        near = (ga.abs() < RELU_KINK_MARGIN) & valid[..., None]
        if not bool(near.any()):
            return (x4, lens, w, peeps, h0, c0)
        x4[..., :D] += near * (4 * RELU_KINK_MARGIN)
    raise AssertionError("could not move the LSTM inputs off relu's kink")


def lstm_compare(inputs, cot, reverse: bool, kernel_lens=None, **acts):
    """Forward and backward of the LSTM kernels against autograd of the
    plain version on the same inputs: {name: (max abs err, err / max|ref|)}
    over LSTM_NAMES.  `kernel_lens` hands the kernels other lengths than
    the plain version (to show that the limit rejects a fault)."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    x4, lens, w, peeps, h0, c0 = inputs

    def run(fn, lengths):
        leaves = [t.clone().requires_grad_(True)
                  for t in (x4, w, peeps, h0, c0)]
        out = fn(leaves[0], lengths, *leaves[1:], reverse=reverse, **acts)
        grads = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(out, cot)), leaves)
        return [o.detach() for o in out] + list(grads)

    got = run(lf.lstm_fused, lens if kernel_lens is None else kernel_lens)
    torch.cuda.synchronize()
    want = run(lf.lstm_fused_plain, lens)
    errs = {}
    for name, a, b in zip(LSTM_NAMES, got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"lstm kernels: non-finite {name}")
        e = float((a - b).abs().max())
        errs[name] = (e, e / max(float(b.abs().max()), 1e-30))
    return errs


# [B, T, D]: the sentiment net's, a small odd one (a partly filled group),
# hidden 256, hidden 512 (beyond what a cluster holds: part of W read from
# L2 every step) and a batch of 1,000 rows (clusters in several waves)
LSTM_SHAPES = ((128, 100, 128), (5, 7, 32), (64, 20, 256), (32, 12, 512),
               (1000, 12, 128))


def lstm_plan_text(B: int, D: int) -> str:
    """The launch plan the kernels take for B rows at hidden size D."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    p = lf.plan_for(B, D, torch.device("cuda"))
    return (f"plan {p.args()} (clusters, CTAs a cluster, rows a group, units "
            f"a CTA, W rows resident fwd / bwd), W k-quads in registers "
            f"{lf.fwd_quads(D, p.units, p.rows_pad)} / "
            f"{lf.bwd_quads(D, p.units, p.rows_pad)}, "
            f"{p.smem_fwd} / {p.smem_bwd} bytes of shared memory")


def phase_lstm() -> None:
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    gates = dict(gate_active_type="sigmoid", state_active_type="tanh")
    worst = 0.0
    for B, T, D in LSTM_SHAPES:
        log(f"[lstm] [{B}, {T}, {D}]: {lstm_plan_text(B, D)}")
        for reverse in (False, True):
            for peep in (False, True):
                for ragged in (False, True):
                    for act in ("tanh", "relu"):
                        acts = dict(active_type=act, **gates)
                        inputs, cot = lstm_inputs(g, B, T, D, peep, ragged)
                        if act == "relu":
                            inputs = move_off_relu_kink(inputs, reverse,
                                                        **acts)
                        errs = lstm_compare(inputs, cot, reverse, **acts)
                        rel = max(r for _, r in errs.values())
                        worst = max(worst, rel)
                        ok = rel <= LSTM_TOL
                        log(f"[lstm] B={B} T={T} D={D} "
                            f"{'rev' if reverse else 'fwd'} "
                            f"{'peep' if peep else 'nopeep':6s} "
                            f"{'ragged' if ragged else 'full':6s} {act:4s} "
                            f"worst {rel:.2e} of max "
                            f"({max(errs, key=lambda n: errs[n][1])}; tol "
                            f"{LSTM_TOL:g}) {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(
                                f"lstm kernels disagree with their plain "
                                f"version: {errs}")
    # a faulty result: the freeze dropped for one row (the kernels are told
    # the row is full)
    inputs, cot = lstm_inputs(g, 128, 100, 128, True, True)
    bad_lens = inputs[1].clone()
    bad_lens[1] = 100
    acts = dict(active_type="tanh", **gates)
    errs = lstm_compare(inputs, cot, False, kernel_lens=bad_lens, **acts)
    over = {n: r / LSTM_TOL for n, (_, r) in errs.items()}
    log(f"[lstm] faulty result (row 1 of length {int(inputs[1][1])} run "
        f"unfrozen): hs {over['hs']:.3g}x, dx4 {over['dx4']:.3g}x, dw "
        f"{over['dw']:.3g}x the limit: "
        f"{'rejected' if min(over['hs'], over['dx4']) > 1 else 'NOT rejected'}"
        f"; worst passing case {worst:.2e} of max")
    if not min(over["hs"], over["dx4"]) > 1:
        raise AssertionError("the lstm limit does not reject a dropped "
                             "freeze")
    lstm_repeat_and_graph(g)


def lstm_repeat_and_graph(g) -> None:
    """At the sentiment shape [128, 100, 128] (ragged, peepholes, relu
    cell): two forward + backward calls give bit-identical hs, dx4, dW,
    dpeep, dh0, dc0 (no atomics in any sum); one forward + backward
    captured in a torch.cuda.CUDAGraph (the cluster launches included),
    replayed, equals the eager result bit for bit."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    acts = dict(active_type="relu", gate_active_type="sigmoid",
                state_active_type="tanh")
    inputs, cot = lstm_inputs(g, 128, 100, 128, True, True)
    x4, lens, w, peeps, h0, c0 = inputs
    leaves = [t.clone().requires_grad_(True) for t in (x4, w, peeps, h0, c0)]

    def step():
        out = lf.lstm_fused(leaves[0], lens, *leaves[1:], **acts)
        loss = sum((o * c).sum() for o, c in zip(out, cot))
        return (out[0].detach(),) + torch.autograd.grad(loss, leaves)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the capture
        first, second = step(), step()
    torch.cuda.current_stream().wait_stream(side)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    log(f"[lstm] two forward + backward calls at [128, 100, 128]: hs, dx4, "
        f"dw, dpeep, dh0, dc0 bit-identical {same}")
    if not all(same):
        raise AssertionError("the lstm kernels are not deterministic")
    c0_ = (lf.counts.fwd, lf.counts.bwd)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(captured, first)]
    log(f"[lstm] forward + backward captured in a CUDA graph "
        f"({lf.counts.fwd - c0_[0]} + {lf.counts.bwd - c0_[1]} launches "
        f"captured), replayed: equal to eager bit for bit {same}")
    if not all(same):
        raise AssertionError("the CUDA-graph replay of the lstm kernels "
                             "differs from eager")
    del graph


def sentiment_batches(n: int, B: int, T: int, vocab: int, seed: int,
                      ragged: bool = False):
    """Batches in the shape of bench.py's bench_sentiment (ids [B, T] +
    lengths, a label per row), with the two-class word language of
    demo/sentiment/sentiment_provider.py (_synthetic: class 0 draws its
    words from the lower 60% of the vocabulary, class 1 from the upper 60%)
    so that the loss can fall; `ragged` draws lengths from 10..T."""
    from paddle_tpu_torch.parameter import Argument
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = rng.integers(0, 2, B).astype(np.int32)
        lo = np.where(label == 0, 0, int(0.4 * vocab))[:, None]
        ids = (lo + rng.integers(0, int(0.6 * vocab), (B, T))).astype(
            np.int32)
        lens = (rng.integers(10, T + 1, B).astype(np.int32) if ragged
                else np.full(B, T, np.int32))
        out.append({"word": Argument(ids=ids, lengths=lens),
                    "label": Argument(ids=label)})
    return out


def phase_sentiment(smi: str) -> list:
    import tempfile

    from paddle_tpu_torch.graph import TEST, GraphExecutor
    from paddle_tpu_torch.models import (bidirectional_lstm_net_config,
                                         stacked_lstm_net_config)
    from paddle_tpu_torch.ops import lstm_fused as lf
    from paddle_tpu_torch.trainer import Trainer

    vocab, B, T, n_lstm = 30000, 128, 100, 3
    warm, timed = 3, 12
    cfg = stacked_lstm_net_config(vocab, batch_size=B)
    tr = Trainer(cfg, seed=1)
    full = sentiment_batches(warm + timed + 2, B, T, vocab, seed=0)
    ragged = sentiment_batches(timed, B, T, vocab, seed=1, ragged=True)
    first = tr.train_one_pass(full[:warm])["cost"]
    torch.cuda.synchronize()

    def timed_steps(batches):
        per_step, losses = [], []
        t0 = time.perf_counter()
        for b in batches:
            c0 = (lf.counts.fwd, lf.counts.bwd, lf.counts.plain)
            losses.append(tr.train_one_batch(b))
            per_step.append((lf.counts.fwd - c0[0], lf.counts.bwd - c0[1],
                             lf.counts.plain - c0[2]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, [float(x) for x in losses], per_step

    lf.counts.reset()
    wall_f, loss_f, steps_f = timed_steps(full[warm:warm + timed])
    wall_r, loss_r, steps_r = timed_steps(ragged)
    launches = {"lstm_fwd": lf.counts.fwd, "lstm_bwd": lf.counts.bwd}
    plain_calls = lf.counts.plain
    for what, wall, losses in (("full lengths", wall_f, loss_f),
                               ("lengths 10..100", wall_r, loss_r)):
        log(f"[sentiment] {timed} steps of [{B}, {T}] ({what}) in "
            f"{wall:.3f}s = {timed * B / wall:.1f} samples/s, "
            f"{wall / timed * 1e3:.2f} ms/step; losses "
            f"{' '.join(f'{x:.4f}' for x in losses)} [{smi}]")
    log(f"[sentiment] mean loss of the first {warm} (warm-up) steps "
        f"{first:.4f}; kernel launches {launches} (= {n_lstm} x "
        f"{2 * timed} steps), plain calls {plain_calls}")
    losses = loss_f + loss_r
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not np.mean(losses[-3:]) < first:
        raise AssertionError(f"loss did not fall: first {warm} mean {first}, "
                             f"last 3 {losses[-3:]}")
    if any(c != (n_lstm, n_lstm, 0) for c in steps_f + steps_r):
        raise AssertionError(f"main path did not run through the LSTM "
                             f"kernels once per lstmemory per step: "
                             f"{steps_f + steps_r}")

    # forward-only: Trainer.test, and the is_predict config's forward
    held_out = sentiment_batches(2, B, T, vocab, seed=2, ragged=True)
    stats = tr.test(held_out)
    predict = GraphExecutor(stacked_lstm_net_config(
        vocab, is_predict=True).model_config)
    feed = tr.prepare_batch(held_out[0])
    feed.pop("label")
    out, _, _ = predict.forward(tr.params, feed, mode=TEST)
    probs = out[predict.model.output_layer_names[0]].value
    sums_to_1 = float((probs.sum(-1) - 1).abs().max())
    log(f"[sentiment] test(): cost {stats['cost']:.4f}, classification "
        f"error {stats['classification_error']:.4f} on 2 held-out ragged "
        f"batches; is_predict forward: probabilities {tuple(probs.shape)}, "
        f"|sum - 1| <= {sums_to_1:.1e}")
    if not (np.isfinite(stats["cost"]) and probs.shape == (B, 2)
            and bool(torch.isfinite(probs).all()) and sums_to_1 <= 1e-5
            and lf.counts.plain == 0):
        raise AssertionError("the forward-only paths failed")

    with tempfile.TemporaryDirectory() as d:
        tr.save(d)
        fresh = Trainer(cfg, seed=2)
        fresh.load(d)
        same = all(torch.equal(fresh.params[n], p)
                   for n, p in tr.params.items())
        same &= all(torch.equal(fresh.opt_state["slots"][n][k], v)
                    for n, sl in tr.opt_state["slots"].items()
                    for k, v in sl.items())
        same &= all(fresh.opt_state[k] == tr.opt_state[k]
                    for k in ("num_samples", "num_updates", "pass_id"))
        same &= torch.equal(fresh.dropout_rng.get_state(),
                            tr.dropout_rng.get_state())
        log(f"[sentiment] checkpoint save -> fresh Trainer.load: "
            f"parameters, Adam slots, counters and the dropout generator "
            f"{'identical' if same else 'DIFFER'}")
        del fresh
    if not same:
        raise AssertionError("checkpoint round trip changed the state")

    def train_two():
        for b in full[warm + timed:]:
            tr.train_one_batch(b)
        return 2

    profile_run(train_two, "2 sentiment training steps", smi,
                family="lstm_")
    del tr
    torch.cuda.empty_cache()

    def lstm_route(n):
        return lambda batch: {"lstm_fwd_kernel": n, "lstm_bwd_kernel": n}

    kstep_training("[sentiment]", smi, lambda: Trainer(cfg, seed=1),
                   sentiment_batches(32, B, T, vocab, seed=5, ragged=True),
                   lstm_route(n_lstm), (B, "samples"))
    kstep_alternating("[sentiment]", lambda: Trainer(cfg, seed=1),
                      sentiment_batches(10, B, T, vocab, seed=7,
                                        ragged=True),
                      sentiment_batches(10, B, 80, vocab, seed=8,
                                        ragged=True),
                      lstm_route(n_lstm))
    bicfg = bidirectional_lstm_net_config(vocab, batch_size=B)
    kstep_training("[sentiment-bidi]", smi, lambda: Trainer(bicfg, seed=1),
                   sentiment_batches(24, B, T, vocab, seed=6, ragged=True),
                   lstm_route(2), (B, "samples"), timed=4)

    # the bidirectional net: a forward and a reversed lstmemory per step
    bi = Trainer(bidirectional_lstm_net_config(vocab, batch_size=B), seed=1)
    lf.counts.reset()
    bi_losses = [float(bi.train_one_batch(b)) for b in ragged[:4]]
    bi_counts = (lf.counts.fwd, lf.counts.bwd, lf.counts.plain)
    torch.cuda.synchronize()
    log(f"[sentiment] bidirectional net, 4 ragged steps: losses "
        f"{' '.join(f'{x:.4f}' for x in bi_losses)}; launches (fwd, bwd, "
        f"plain) {bi_counts}")
    if bi_counts != (8, 8, 0) or not all(np.isfinite(bi_losses)):
        raise AssertionError("the bidirectional net did not run 2 launches "
                             "of each LSTM kernel per step")
    del bi
    torch.cuda.empty_cache()
    return lstm_records(launches, B, T, smi)


# the parts of one K3 step that lstm_phase_stamps splits (csrc/lstm.cu)
LSTM_FWD_PARTS = ("product", "elementwise", "DSMEM push", "hs/cs writes",
                  "exchange wait")
LSTM_BWD_PARTS = ("elementwise", "product + sends", "dx4 writes",
                  "exchange wait", "ordered sum")


def lstm_phase_split(args, plan) -> str:
    """lstm_phase_stamps at the given inputs: the mean cycles of each part
    of a step over the steps CTA 0 computed, forward and backward walk."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    st_f, st_b = lf.lstm_phase_stamps(*args, plan=plan)
    parts = []
    for what, st, names in (("forward", st_f, LSTM_FWD_PARTS),
                            ("walk", st_b, LSTM_BWD_PARTS)):
        st = st[(st != 0).all(dim=1)].double()
        d = (st[:, 1:] - st[:, :-1]).mean(0).tolist()
        total = sum(d)
        parts.append(f"{what} {total:.0f} cycles/step: " + ", ".join(
            f"{n} {c:.0f} ({c / total:.0%})" for n, c in zip(names, d)))
    return "; ".join(parts)


def lstm_records(launches: dict, B: int, T: int, smi: str) -> list:
    """Each LSTM kernel at the sentiment run's shape (B x T x 128, relu
    cell, peepholes, full lengths): checked against the plain version, then
    timed beside its bound, the plain version's time and a cuDNN LSTM of the
    same sizes (torch.nn.LSTM fed x4: it has no peepholes and no length
    freeze and adds its own [4D, 4D] input projection, work K3 does not do;
    a yardstick, never called by the port; each K3 kernel must be faster).
    The forward is timed as training runs it (saving the gates) and as
    test() runs it; the backward's walk, dW product and ordered sums apart
    (torch.profiler); then the four plans ranked first for the card, a
    single-row launch and the per-part split of one step (clock64()
    stamps, lstm_phase_stamps)."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    D = 128
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    names = ("relu", "sigmoid", "tanh")
    acts = dict(active_type="relu", gate_active_type="sigmoid",
                state_active_type="tanh")
    inputs, cot = lstm_inputs(g, B, T, D, True, False)
    inputs = move_off_relu_kink(inputs, False, **acts)
    errs = lstm_compare(inputs, cot, False, **acts)
    rel = max(r for _, r in errs.values())
    log(f"[sentiment] lstm kernels vs plain at [{B}, {T}, {D}] relu, "
        f"peepholes: worst {rel:.2e} of max (tol {LSTM_TOL:g})")
    if not rel <= LSTM_TOL:
        raise AssertionError(f"lstm kernels disagree with their plain "
                             f"version at the run's shape: {errs}")
    err = {"lstm_fwd": max(errs[n][0] for n in LSTM_NAMES[:3]),
           "lstm_bwd": max(errs[n][0] for n in LSTM_NAMES[3:])}
    x4, lens, w, peeps, h0, c0 = inputs
    dev = x4.device
    plan = lf.plan_for(B, D, dev)
    hs, cs, gates = lf.lstm_fwd_kernel(x4, lens, w, peeps, h0, c0, names,
                                       False, save_gates=True)

    def fwd(p=None, save=True):
        return lf.lstm_fwd_kernel(x4, lens, w, peeps, h0, c0, names, False,
                                  save_gates=save, plan=p)

    def bwd(p=None):
        return lf.lstm_bwd_kernel(lens, w, peeps, h0, c0, hs, cs, gates,
                                  *cot, names, False, plan=p)

    ms = {"lstm_fwd": time_call(fwd, 20), "lstm_bwd": time_call(bwd, 20)}
    test_ms = time_call(lambda: fwd(save=False), 20)
    split = kernel_device_ms(bwd, 10, ("lstm_bwd_kernel", "lstm_dw_kernel",
                                       "lstm_reduce_kernel"))
    plans = {}
    for p in lf.ranked_plans(B, D, dev)[:4]:
        plans[p.args()] = (time_call(lambda: fwd(p), 20),
                           time_call(lambda: bwd(p), 20))
    one_plan = lf.plan_for(1, D, dev)
    one_row = time_call(lambda: lf.lstm_fwd_kernel(
        x4[:1], lens[:1], w, peeps, h0[:1], c0[:1], names, False), 20)
    phases = lstm_phase_split((x4, lens, w, peeps, h0, c0, *cot, names,
                               False), plan)
    leaves = [t.clone().requires_grad_(True) for t in (x4, w, peeps, h0, c0)]

    def plain_fwd():
        return lf.lstm_fused_plain(leaves[0], lens, *leaves[1:], **acts)

    plain = {"lstm_fwd": time_call(plain_fwd, 3)}
    out = plain_fwd()
    loss = sum((o * c).sum() for o, c in zip(out, cot))
    plain["lstm_bwd"] = time_call(lambda: torch.autograd.grad(
        loss, leaves, retain_graph=True), 3)
    del out, loss
    cudnn = torch.nn.LSTM(4 * D, D, batch_first=True).cuda()
    xin = x4.clone().requires_grad_(True)
    with torch.no_grad():
        lib = {"lstm_fwd": time_call(lambda: cudnn(xin), 10)}
    y, _ = cudnn(xin)
    lib["lstm_bwd"] = time_call(lambda: torch.autograd.grad(
        y, [xin, *cudnn.parameters()], cot[0], retain_graph=True), 10)
    del y
    # the work this run's inputs need: every valid step is one [D] x [D, 4D]
    # product per row in the forward and two in the backward (dx4 W^T from
    # the saved gates, h_prev^T dx4); bytes: x4 of the valid steps and the
    # small operands read, hs and cs of every step and the gates of the
    # valid steps written (forward); the gates of the valid steps, cs, hs
    # and the cotangents read, dx4 and the small gradients written
    # (backward).  The earlier design's count, beside it: three products a
    # valid step in the backward (the gates recomputed), no gates in the
    # forward's bytes
    valid = float(lens.sum())
    step, small = 4.0 * D * 4, 4.0 * (D * 4 * D + 3 * D + 2 * B * D + B)
    work = {"lstm_fwd": (2 * valid * step + small + 2 * B * T * D * 4,
                         2.0 * valid * D * 4 * D),
            "lstm_bwd": (valid * step + 3 * B * T * D * 4 + B * T * step
                         + 2 * small, 4.0 * valid * D * 4 * D)}
    old_bwd_ms = max(
        (valid * (step + 2 * D * 4) + B * T * D * 4 + B * T * step
         + 2 * small) / HBM_BYTES_PER_S,
        6.0 * valid * D * 4 * D / PEAK_FLOPS[torch.float32]) * 1e3
    log(f"[sentiment] lstm {lstm_plan_text(B, D)}; plans ranked for this "
        f"card, timed (fwd saving the gates, bwd): " + ", ".join(
            f"{k}: {f * 1e3:.1f} / {b_ * 1e3:.1f} us"
            for k, (f, b_) in plans.items()) + f" [{smi}]")
    log(f"[sentiment] lstm backward {ms['lstm_bwd'] * 1e3:.1f} us: "
        + ", ".join(f"{k} {v * 1e3:.1f} us" if v is not None
                    else f"{k} not measured (no device time)"
                    for k, v in split.items())
        + f" per call (torch.profiler over 10 calls); forward without the "
        f"gates (test, is_predict) {test_ms * 1e3:.1f} us [{smi}]")
    log(f"[sentiment] a single-row launch of the lstm forward kernel (plan "
        f"{one_plan.args()}): {one_row * 1e3:.1f} us = "
        f"{one_row * 1e3 / T:.2f} us/step [{smi}]")
    log(f"[sentiment] one lstm step at [{B}, {T}, {D}], CTA 0: {phases}")
    records = []
    for name, src_line in (("lstm_fwd", 66), ("lstm_bwd", 99)):
        nbytes, flops = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        old = (f"; the recomputing design's count (three products) "
               f"{old_bwd_ms * 1e3:.1f} us" if name == "lstm_bwd" else "")
        log(f"[sentiment] {name} at [{B}, {T}, {D}] float32: "
            f"{ms[name] * 1e3:.1f} us/launch = {ms[name] * 1e3 / T:.2f} "
            f"us/step; bound {bound_ms * 1e3:.1f} us "
            f"({'operations' if flops_ms >= bytes_ms else 'bytes'}; "
            f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s float32, "
            f"{nbytes / 1e6:.1f} MB{old}) = {bound_ms / ms[name]:.1%} of the "
            f"bound; plain version {plain[name] * 1e3:.1f} us; cuDNN LSTM "
            f"{'forward' if name == 'lstm_fwd' else 'backward'} (with its "
            f"own [{4 * D}, {4 * D}] input projection, which K3 does not "
            f"do) {lib[name] * 1e3:.1f} us = {lib[name] / ms[name]:.2f}x "
            f"the kernel's time [{smi}]")
        if not ms[name] < lib[name]:
            raise AssertionError(f"{name} is not faster than the cuDNN LSTM "
                                 f"at [{B}, {T}, {D}]: {ms[name]} ms against "
                                 f"{lib[name]} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lstm.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{src_line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain[name], "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": lib[name]})
    return records


def phase_sentiment_routes() -> None:
    from paddle_tpu_torch.models import stacked_lstm_net_config
    from paddle_tpu_torch.ops import lstm_fused as lf
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.trainer import Trainer

    vocab, B, T = 30000, 128, 100
    cfg = stacked_lstm_net_config(vocab, batch_size=B)
    params = init_params(cfg.model_config, seed=1)
    # the demo starts the lstm -> fc edges and the biases at zero; wake them
    # so that every gradient path carries signal
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    for name, p in params.items():
        if not bool(p.any()):
            params[name] = 0.05 * torch.randn(p.shape, generator=g,
                                              device="cuda")
    batch = sentiment_batches(1, B, T, vocab, seed=5, ragged=True)[0]
    ones = {l.name: torch.ones(B, T, l.size, device="cuda")
            for l in cfg.model_config.layers if l.drop_rate > 0}
    got = {}
    kernel_route = lf.lstm_fused
    for route in ("kernel", "plain"):
        tr = Trainer(cfg, params=params)
        lf.counts.reset()
        # the layer reaches the op through the module attribute: hand it
        # the plain version for the comparison run
        lf.lstm_fused = (lf.lstm_fused_plain if route == "plain"
                         else kernel_route)
        try:
            loss, grads, _ = tr.compute_gradients(tr.prepare_batch(batch),
                                                  dropout_masks=ones)
        finally:
            lf.lstm_fused = kernel_route
        torch.cuda.synchronize()
        got[route] = (float(loss), grads,
                      (lf.counts.fwd, lf.counts.bwd, lf.counts.plain))
    (lk, gk, ck), (lp, gp, cp) = got["kernel"], got["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    worst, worst_name = 0.0, ""
    for n, ref in gp.items():
        e = float((gk[n] - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1e-30)
        if e > worst:
            worst, worst_name = e, n
    log(f"[sentiment-routes] fp32, full width, [{B}, {T}] ragged, dropout "
        f"masks of ones: loss kernel {lk:.6f} vs plain {lp:.6f} (rel "
        f"{rel_loss:.2e}, tol 1e-5); worst gradient {worst:.2e} of its max "
        f"({worst_name}; tol 1e-4); launches (fwd, bwd, plain) kernel "
        f"{ck}, plain {cp}")
    if ck != (3, 3, 0) or cp != (0, 0, 3):
        raise AssertionError(f"routes did not take their paths: {ck}, {cp}")
    if not (rel_loss <= 1e-5 and worst <= 1e-4 and set(gk) == set(gp)):
        raise AssertionError("the LSTM kernel and plain training routes "
                             "disagree")


# -- the fused GRU (K1), the additive attention (K2) and the seq2seq path ----

GRU_TOL = 1e-5                     # float32: share of each tensor's max
GRU_NAMES = ("hs", "h_last", "dx3", "dwg", "dwc", "dh0")
# [B, T, D]: the seq2seq encoder's, a small odd one, four batch groups of
# 64 rows, a hidden size of three 32-column tiles, a single row, and two
# batches no single launch takes (walked in slices of rows)
GRU_SHAPES = ((64, 30, 512), (5, 7, 32), (256, 30, 512), (64, 30, 96),
              (1, 30, 512), (1024, 30, 512), (1500, 12, 256))


def gru_inputs(g, B: int, T: int, D: int, ragged: bool):
    """Random float32 inputs of the GRU op on the card: (x3, lengths, w
    [D, 3D] — the layer's one parameter, sliced into the gate and candidate
    weights as the layer does —, h0) and cotangents for (hs, h_last).
    Ragged lengths hold a length-0 row and a full row."""
    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x3, w, h0 = r(B, T, 3 * D), r(D, 3 * D) * D ** -0.5, r(B, D) * 0.5
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    if ragged:
        lens = torch.randint(max(1, T // 10), T + 1, (B,), generator=g,
                             device="cuda").to(torch.int32)
        lens[0], lens[-1] = 0, T
    return (x3, lens, w, h0), (r(B, T, D), r(B, D))


def gru_move_off_relu_kink(inputs, reverse: bool, **acts):
    """The GRU's relu candidate: nudge x3's candidate columns until no
    candidate pre-activation of a valid step lies within RELU_KINK_MARGIN
    of 0 (see move_off_relu_kink)."""
    from paddle_tpu_torch.ops import gru_fused as gf
    x3, lens, w, h0 = inputs
    B, T, D3 = x3.shape
    D = D3 // 3
    x3 = x3.clone()
    valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
    for _ in range(20):
        hs, _ = gf.gru_fused_plain(x3, lens, w[:, :2 * D], w[:, 2 * D:], h0,
                                   reverse=reverse, **acts)
        h_prev = (torch.cat([hs[:, 1:], h0[:, None]], dim=1) if reverse
                  else torch.cat([h0[:, None], hs[:, :-1]], dim=1))
        r = torch.sigmoid(x3[..., D:2 * D] + h_prev @ w[:, D:2 * D])
        zc = x3[..., 2 * D:] + (r * h_prev) @ w[:, 2 * D:]
        near = (zc.abs() < RELU_KINK_MARGIN) & valid[..., None]
        if not bool(near.any()):
            return (x3, lens, w, h0)
        x3[..., 2 * D:] += near * (4 * RELU_KINK_MARGIN)
    raise AssertionError("could not move the GRU inputs off relu's kink")


def gru_compare(inputs, cot, reverse: bool, kernel_lens=None, **acts):
    """Forward and backward of the GRU kernels against autograd of the
    plain version on the same inputs: {name: (max abs err, err / max|ref|)}
    over GRU_NAMES.  `kernel_lens` hands the kernels other lengths than the
    plain version (to show that the limit rejects a fault)."""
    from paddle_tpu_torch.ops import gru_fused as gf
    x3, lens, w, h0 = inputs
    D = w.shape[0]

    def run(fn, lengths):
        leaves = [t.clone().requires_grad_(True) for t in (x3, w, h0)]
        xl, wl, hl = leaves
        out = fn(xl, lengths, wl[:, :2 * D], wl[:, 2 * D:], hl,
                 reverse=reverse, **acts)
        dx, dw, dh0 = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(out, cot)), leaves)
        return [o.detach() for o in out] + [dx, dw[:, :2 * D], dw[:, 2 * D:],
                                            dh0]

    got = run(gf.gru_fused, lens if kernel_lens is None else kernel_lens)
    torch.cuda.synchronize()
    want = run(gf.gru_fused_plain, lens)
    errs = {}
    for name, a, b in zip(GRU_NAMES, got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"gru kernels: non-finite {name}")
        e = float((a - b).abs().max())
        errs[name] = (e, e / max(float(b.abs().max()), 1e-30))
    return errs


def phase_gru() -> None:
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    worst = 0.0
    for B, T, D in GRU_SHAPES:
        for reverse in (False, True):
            for ragged in (False, True):
                for act in ("tanh", "relu"):
                    acts = dict(active_type=act, gate_active_type="sigmoid")
                    inputs, cot = gru_inputs(g, B, T, D, ragged)
                    if act == "relu":
                        inputs = gru_move_off_relu_kink(inputs, reverse,
                                                        **acts)
                    errs = gru_compare(inputs, cot, reverse, **acts)
                    rel = max(r for _, r in errs.values())
                    worst = max(worst, rel)
                    ok = rel <= GRU_TOL
                    log(f"[gru] B={B} T={T} D={D} "
                        f"{'rev' if reverse else 'fwd'} "
                        f"{'ragged' if ragged else 'full':6s} {act:4s} "
                        f"worst {rel:.2e} of max "
                        f"({max(errs, key=lambda n: errs[n][1])}; tol "
                        f"{GRU_TOL:g}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"gru kernels disagree with "
                                             f"their plain version: {errs}")
    # a faulty result: the freeze dropped for one row (the kernels are told
    # the row is full)
    inputs, cot = gru_inputs(g, 64, 30, 512, True)
    bad_lens = inputs[1].clone()
    bad_lens[0] = 30
    errs = gru_compare(inputs, cot, False, kernel_lens=bad_lens,
                       active_type="tanh", gate_active_type="sigmoid")
    over = {n: r / GRU_TOL for n, (_, r) in errs.items()}
    log(f"[gru] faulty result (row 0 of length {int(inputs[1][0])} run "
        f"unfrozen): hs {over['hs']:.3g}x, dx3 {over['dx3']:.3g}x, dwg "
        f"{over['dwg']:.3g}x the limit: "
        f"{'rejected' if min(over['hs'], over['dx3']) > 1 else 'NOT rejected'}"
        f"; worst passing case {worst:.2e} of max")
    if not min(over["hs"], over["dx3"]) > 1:
        raise AssertionError("the gru limit does not reject a dropped freeze")
    gru_repeat_and_graph(g)


def gru_repeat_and_graph(g) -> None:
    """At the seq2seq shape [64, 30, 512] (ragged, tanh): two backward
    calls give bit-identical dx3, dWg, dWc, dh0 (no atomics in any sum); one
    forward + backward captured in a torch.cuda.CUDAGraph (the cooperative
    launches and their zeroed barrier counters included), replayed, equals
    the eager result bit for bit."""
    from paddle_tpu_torch.ops import gru_fused as gf
    B, T, D = S2S_BATCH, S2S_SRC, S2S_HIDDEN
    (x3, lens, w, h0), cot = gru_inputs(g, B, T, D, True)
    leaves = [t.clone().requires_grad_(True) for t in (x3, w, h0)]

    def step():
        xl, wl, hl = leaves
        hs, hl_ = gf.gru_fused(xl, lens, wl[:, :2 * D], wl[:, 2 * D:], hl)
        loss = (hs * cot[0]).sum() + (hl_ * cot[1]).sum()
        return (hs.detach(),) + torch.autograd.grad(loss, leaves)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the capture
        first, second = step(), step()
    torch.cuda.current_stream().wait_stream(side)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    log(f"[gru] two forward + backward calls at [{B}, {T}, {D}]: hs, dx3, "
        f"dw, dh0 bit-identical {same}")
    if not all(same):
        raise AssertionError("the gru kernels are not deterministic")
    c0 = (gf.counts.fwd, gf.counts.bwd)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(captured, first)]
    log(f"[gru] forward + backward captured in a CUDA graph "
        f"({gf.counts.fwd - c0[0]} + {gf.counts.bwd - c0[1]} launches "
        f"captured), replayed: equal to eager bit for bit {same}")
    if not all(same):
        raise AssertionError("the CUDA-graph replay of the gru kernels "
                             "differs from eager")
    del graph


# K2: float32 within ADD_TOL_F32; bfloat16 inputs against the plain version
# in float32 on the same inputs, per element within 2^-7 |ref| + 1e-3 (the
# context is rounded to bfloat16 once, at most 2^-8 of its value)
ADD_TOL_F32 = 2e-5
ADD_LIMIT_BF16 = (2.0 ** -7, 1e-3)


def additive_inputs(g, B: int, T: int, D: int, Dv: int, ragged: bool,
                    dtype=torch.float32):
    """u [B, D], v [D] float32, enc_proj [B, T, D] and enc_seq [B, T, Dv]
    in `dtype`, lengths int32 (ragged: random, with a length-0 row and a
    full row)."""
    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    if ragged:
        lens = torch.randint(1, T + 1, (B,), generator=g,
                             device="cuda").to(torch.int32)
        lens[0], lens[-1] = 0, T
    return (r(B, D), r(D) * D ** -0.5, r(B, T, D).to(dtype),
            r(B, T, Dv).to(dtype), lens)


def additive_error(args) -> tuple[float, float]:
    """The kernel against the plain version in float32 on the same inputs:
    (max abs err, the largest share of the bfloat16 per-element limit)."""
    from paddle_tpu_torch.ops import additive_attention as aa
    u, v, proj, seq, lens = args
    got = aa.additive_attention_kernel(u, v, proj, seq, lens)
    torch.cuda.synchronize()
    want = aa.additive_attention_plain(u, v, proj.float(), seq.float(), lens)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("additive attention kernel: non-finite output")
    diff = (got.float() - want).abs()
    rtol, atol = ADD_LIMIT_BF16
    return float(diff.max()), float((diff / (rtol * want.abs() + atol)).max())


# [additive] cases: (B, T, D, Dv, ragged) — the decoder's training and
# beam shapes, T = 1, T = 300 (tiles of 32 keys, the last partial), and
# widths that the cluster's slices do not divide: D 500 and Dv 1000 (the
# last CTA's slices shorter), D 33 and Dv 2047 (no 16-byte rows), Dv 24 (CTAs
# without a Dv slice)
ADD_CASES = ((64, 30, 512, 1024, False), (64, 30, 512, 1024, True),
             (192, 30, 512, 1024, False), (192, 30, 512, 1024, True),
             (64, 1, 512, 1024, False), (8, 300, 512, 1024, True),
             (64, 45, 500, 1000, True), (7, 65, 33, 2047, True),
             (3, 33, 40, 24, True))


def phase_additive() -> None:
    from paddle_tpu_torch.ops import additive_attention as aa
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    for B, T, D, Dv, ragged in ADD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = additive_inputs(g, B, T, D, Dv, ragged, dtype)
            err, share = additive_error(args)
            if dtype == torch.float32:
                ok = err <= ADD_TOL_F32
                limit = f"atol {ADD_TOL_F32:g}"
            else:
                ok = share <= 1
                limit = f"{share:.3f} of 2^-7|ref| + 1e-3"
            lens = args[4]
            out = aa.additive_attention_kernel(*args)
            empty_zero = bool((out[lens == 0] == 0).all())
            log(f"[additive] {str(dtype)[6:]:8s} B={B} T={T} D={D} Dv={Dv} "
                f"({aa.additive_plan(B, Dv, aa._sm_count(out.device))} "
                f"CTAs a row) len={int(lens.min())}..{int(lens.max())} "
                f"max_abs_err {err:.3e} ({limit}); rows without a key "
                f"zero: {empty_zero} {'ok' if ok else 'FAIL'}")
            if not (ok and empty_zero):
                raise AssertionError(f"additive attention kernel disagrees "
                                     f"with its plain version ({dtype}, "
                                     f"B={B}, T={T}, D={D}, Dv={Dv})")
    args = additive_inputs(g, 64, 30, 512, 1024, True)
    one = aa.additive_attention_kernel(*args)
    two = aa.additive_attention_kernel(*args)
    torch.cuda.synchronize()
    replay = graph_replay_equal(lambda: (aa.additive_attention_kernel(*args),))
    log(f"[additive] two launches bit-identical: {torch.equal(one, two)}; "
        f"a launch replayed from a CUDA graph equal to eager bit for bit: "
        f"{replay}")
    if not (torch.equal(one, two) and replay):
        raise AssertionError("additive attention kernel: repeat or graph "
                             "replay differs")


S2S_VOCAB, S2S_HIDDEN, S2S_BATCH, S2S_SRC = 30000, 512, 64, 30
# nats per token that the last 3 training steps must lie below the warm-up:
# a model whose parameters never move stays at ln V
LOSS_DROP = 1.0


def seq2seq_batches(n: int, B: int, T: int, seed: int, ragged: bool = False):
    """Batches of the sequence-reversal language of
    demo/seqToseq/seq_provider.py (`_synthetic`) at its real width: source
    words from ids 3..1002, the target [BOS] + the reversed source, the
    next words the reversed source + [EOS]; T source words (the decoder
    runs T + 1 steps), lengths 10..T when `ragged`.  As numpy."""
    from paddle_tpu_torch.parameter import Argument
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        src = rng.integers(3, 1003, (B, T)).astype(np.int32)
        lens = (rng.integers(10, T + 1, B).astype(np.int32) if ragged
                else np.full(B, T, np.int32))
        trg = np.zeros((B, T + 1), np.int32)
        nxt = np.ones((B, T + 1), np.int32)
        for b in range(B):
            rev = src[b, :lens[b]][::-1]
            trg[b, 1:lens[b] + 1] = rev
            nxt[b, :lens[b]] = rev
        out.append({"source_language_word": Argument(ids=src, lengths=lens),
                    "target_language_word": Argument(ids=trg,
                                                     lengths=lens + 1),
                    "target_language_next_word": Argument(ids=nxt,
                                                          lengths=lens + 1)})
    return out


def seq2seq_route(batch) -> dict:
    """The kernels a seq2seq training step launches on the card: the
    encoder's two GRUs forward and backward, the additive attention once
    per decoder step (T + 1 of them)."""
    T = batch["source_language_word"].ids.shape[1]
    return {"gru_fwd_kernel": 2, "gru_bwd_kernel": 2,
            "additive_attention_kernel": T + 1}


def seq2seq_counts():
    from paddle_tpu_torch.ops import additive_attention as aa
    from paddle_tpu_torch.ops import gru_fused as gf
    return (gf.counts.fwd, gf.counts.bwd, gf.counts.plain, aa.counts.kernel,
            aa.counts.plain, aa.counts.recompute)


def phase_seq2seq(smi: str) -> list:
    import tempfile

    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.graph.generator import generate
    from paddle_tpu_torch.models import seq2seq_trainer_config
    from paddle_tpu_torch.ops import additive_attention as aa
    from paddle_tpu_torch.ops import gru_fused as gf
    from paddle_tpu_torch.parameter import Argument
    from paddle_tpu_torch.trainer import Trainer

    V, H, B, T = S2S_VOCAB, S2S_HIDDEN, S2S_BATCH, S2S_SRC
    warm, timed = 3, 12
    cfg = seq2seq_trainer_config(V, H, B)
    tr = Trainer(cfg, seed=1)
    full = seq2seq_batches(warm + timed + 2, B, T, seed=0)
    ragged = seq2seq_batches(timed, B, T, seed=1, ragged=True)
    first = tr.train_one_pass(full[:warm])["cost"]
    torch.cuda.synchronize()

    def per_token(loss, batch):
        # the cost sums -log p over a sequence's tokens and the loss is its
        # batch mean: per token, an untrained model reads ln V at any length
        lens = batch["target_language_next_word"].lengths
        return float(loss) * len(lens) / float(lens.sum())

    def timed_steps(batches):
        per_step, losses = [], []
        t0 = time.perf_counter()
        for b in batches:
            c0 = seq2seq_counts()
            losses.append(tr.train_one_batch(b))
            per_step.append(tuple(x - y for x, y in zip(seq2seq_counts(),
                                                        c0)))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                [per_token(x, b) for x, b in zip(losses, batches)], per_step)

    gf.counts.reset()
    aa.counts.reset()
    wall_f, loss_f, steps_f = timed_steps(full[warm:warm + timed])
    wall_r, loss_r, steps_r = timed_steps(ragged)
    launches = {"gru_fwd": gf.counts.fwd, "gru_bwd": gf.counts.bwd,
                "additive_attention": aa.counts.kernel}
    for what, wall, losses in (("full lengths", wall_f, loss_f),
                               ("source lengths 10..30", wall_r, loss_r)):
        log(f"[seq2seq] {timed} steps of [{B}, {T}] -> [{B}, {T + 1}] "
            f"({what}) in {wall:.3f}s = {timed * B / wall:.1f} samples/s, "
            f"{wall / timed * 1e3:.2f} ms/step; losses per token "
            f"{' '.join(f'{x:.4f}' for x in losses)} [{smi}]")
    first /= T + 1          # the warm-up batches are full length
    log(f"[seq2seq] mean loss per token of the first {warm} (warm-up) steps "
        f"{first:.4f} (untrained: ln {V} = {np.log(V):.4f}); launches "
        f"{launches} over {2 * timed} steps; per step "
        f"(gru fwd, gru bwd, gru plain, additive kernel, additive plain, "
        f"additive backward recompute) {sorted(set(steps_f + steps_r))}")
    losses = loss_f + loss_r
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not np.mean(losses[-3:]) < first - LOSS_DROP:
        raise AssertionError(f"loss per token did not fall by {LOSS_DROP}: "
                             f"first {warm} mean {first}, last 3 "
                             f"{losses[-3:]}")
    if any(c != (2, 2, 0, T + 1, 0, T + 1) for c in steps_f + steps_r):
        raise AssertionError(f"main path did not run 2 + 2 GRU launches and "
                             f"one additive-attention launch per decoder "
                             f"step: {steps_f + steps_r}")

    held_out = seq2seq_batches(2, B, T, seed=2, ragged=True)
    c0 = seq2seq_counts()
    stats = tr.test(held_out)
    test_counts = tuple(x - y for x, y in zip(seq2seq_counts(), c0))
    log(f"[seq2seq] test(): cost {stats['cost']:.4f}, classification error "
        f"{stats['classification_error']:.4f} on 2 held-out ragged batches; "
        f"launches {test_counts}")
    if not (np.isfinite(stats["cost"])
            and test_counts == (4, 0, 0, 2 * (T + 1), 0, 0)):
        raise AssertionError("Trainer.test failed on the seq2seq")

    with tempfile.TemporaryDirectory() as d:
        tr.save(d)
        fresh = Trainer(cfg, seed=2)
        fresh.load(d)
        same = all(torch.equal(fresh.params[n], p)
                   for n, p in tr.params.items())
        same &= all(torch.equal(fresh.opt_state["slots"][n][k], v)
                    for n, sl in tr.opt_state["slots"].items()
                    for k, v in sl.items())
        same &= all(fresh.opt_state[k] == tr.opt_state[k]
                    for k in ("num_samples", "num_updates", "pass_id"))
        log(f"[seq2seq] checkpoint save -> fresh Trainer.load: parameters, "
            f"Adam slots and counters {'identical' if same else 'DIFFER'}")
        del fresh
    if not same:
        raise AssertionError("checkpoint round trip changed the state")

    def train_two():
        for b in full[warm + timed:]:
            tr.train_one_batch(b)
        return 2

    profile_run(train_two, "2 seq2seq training steps", smi,
                family="additive_attention")
    kstep_training("[seq2seq]", smi, lambda: Trainer(cfg, seed=1),
                   seq2seq_batches(32, B, T, seed=4, ragged=True),
                   seq2seq_route, (B, "samples"))
    kstep_alternating("[seq2seq]", lambda: Trainer(cfg, seed=1),
                      seq2seq_batches(10, B, T, seed=5, ragged=True),
                      seq2seq_batches(10, B, 24, seed=6, ragged=True),
                      seq2seq_route)

    # beam-search generation on the trained parameters
    K, L = 3, 30
    gex = GraphExecutor(seq2seq_trainer_config(
        V, H, is_generating=True, beam_size=K, max_length=L).model_config)
    src = seq2seq_batches(1, B, T, seed=3, ragged=True)[0][
        "source_language_word"]
    feed = {"source_language_word": Argument(
        ids=torch.as_tensor(src.ids, device="cuda").long(),
        lengths=torch.as_tensor(src.lengths, device="cuda"))}
    c0 = seq2seq_counts()
    ids, scores = generate(gex, tr.params, feed)
    torch.cuda.synchronize()
    gen_counts = tuple(x - y for x, y in zip(seq2seq_counts(), c0))
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        ids, scores = generate(gex, tr.params, feed)
        ids.cpu()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    sorted_ok = bool((scores[:, :-1] >= scores[:, 1:]).all())
    in_vocab = bool(((ids >= 0) & (ids < V)).all())
    reversed_ok = float(np.mean([
        np.array_equal(ids[b, 0, :int(src.lengths[b])].cpu().numpy(),
                       src.ids[b, :src.lengths[b]][::-1])
        for b in range(B)]))
    log(f"[seq2seq] generate: {B} sources of lengths "
        f"{int(src.lengths.min())}..{int(src.lengths.max())}, beam {K}, "
        f"max_length {L}: ids {tuple(ids.shape)} in the vocabulary "
        f"{in_vocab}, beams best-first {sorted_ok}; launches (gru fwd, gru "
        f"bwd, gru plain, additive kernel, additive plain, recompute) "
        f"{gen_counts}; median of 10 calls {med * 1e3:.2f} ms = "
        f"{B * L / med:.1f} beam-decode tokens/s (bench.py's count: B x "
        f"max_length); best beam = reversed source for {reversed_ok:.2%} of "
        f"the rows (not a gate) [{smi}]")
    if not (in_vocab and sorted_ok and tuple(ids.shape) == (B, K, L)
            and bool(torch.isfinite(scores).all())
            and gen_counts == (2, 0, 0, L, 0, 0)):
        raise AssertionError("beam-search generation failed")
    del tr
    torch.cuda.empty_cache()
    return gru_records(launches, smi) + additive_records(launches, smi)


def kernel_device_ms(fn, n: int, names: tuple) -> dict:
    """Mean device ms per call of fn() over n calls, by kernel: {name: ms}
    for each name, summed over the CUDA kernels whose symbol contains it
    (torch.profiler); None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        us = sum(float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA
                 and name in e.key)
        out[name] = us / 1e3 / n if us else None
    return out


# the parts of one K1 step that gru_phase_stamps splits (csrc/gru.cu)
GRU_FWD_PARTS = ("stage h", "h Wg", "u, r", "barrier 1", "stage r h",
                 "(r h) Wc", "c, h", "barrier 2")
GRU_BWD_PARTS = ("dzu, dzc", "dzc Wc^T", "barrier A", "sum A, dzr",
                 "dz Wg^T", "barrier B", "sum B, dh")


def gru_phase_split(args, plan) -> str:
    """gru_phase_stamps at the given inputs: the mean cycles of each part of
    a step over the steps CTA 0 computed, forward and backward walk."""
    from paddle_tpu_torch.ops import gru_fused as gf
    st_f, st_b = gf.gru_phase_stamps(*args, plan=plan)
    parts = []
    for what, st, names in (("forward", st_f, GRU_FWD_PARTS),
                            ("walk", st_b, GRU_BWD_PARTS)):
        st = st[(st != 0).all(dim=1)].double()
        d = (st[:, 1:] - st[:, :-1]).mean(0).tolist()
        total = sum(d)
        parts.append(f"{what} {total:.0f} cycles/step: " + ", ".join(
            f"{n} {c:.0f} ({c / total:.0%})" for n, c in zip(names, d)))
    return "; ".join(parts)


GRU_PLANS_TIMED = ((16, 16), (32, 8), (64, 4))     # (rows, units)


# batches of 1,024 rows: (B, D, rows and units a CTA of the plan of another
# way to launch them): at D = 512 no single launch takes the batch and
# gru_launches walks it in 16 slices of 64 rows, against 3 slices of 344
# rows (the cost model's runner-up); at D = 256 one launch takes it, against
# 2 slices of 512 rows
GRU_SLICED = ((1024, 512, 342, 16), (1024, 256, 512, None))


def gru_sliced_timings(g, T: int, names) -> list:
    """The batches of GRU_SLICED at T steps (tanh, full lengths): the
    forward (saving the gates) and the backward as gru_launches runs them,
    beside the other way to launch them and the cuDNN GRU's times; one
    line of text each."""
    from paddle_tpu_torch.ops import gru_fused as gf
    lines = []
    for B, D, alt_rows, alt_units in GRU_SLICED:
        (x3, lens, w, h0), cot = gru_inputs(g, B, T, D, False)
        wg, wc = w[:, :2 * D], w[:, 2 * D:]
        limits = gf.kernel.device_limits(x3.device)
        hs, gates = gf.gru_fwd_kernel(x3, lens, wg, wc, h0, names, False,
                                      save_gates=True)

        def times(p=None):
            return (time_call(lambda: gf.gru_fwd_kernel(
                        x3, lens, wg, wc, h0, names, False, save_gates=True,
                        plan=p), 5) * 1e3,
                    time_call(lambda: gf.gru_bwd_kernel(
                        lens, wg, wc, h0, hs, gates, *cot, names, False,
                        plan=p), 5) * 1e3)

        def launches_text(launches):
            return (f"{len(launches)} launch(es) of plan "
                    f"{launches[0][2].args()}")

        alt = gf.gru_plan(alt_rows, D, *limits, units=alt_units)
        picked = launches_text(gf.gru_launches(B, D, *limits))
        text = (f"at [{B}, {T}, {D}]: {picked}: fwd %.1f us, bwd %.1f us"
                % times())
        text += (f"; {launches_text(gf._slices(B, D, alt, *limits))}: fwd "
                 f"%.1f us, bwd %.1f us" % times(alt))
        cudnn = torch.nn.GRU(3 * D, D, batch_first=True).cuda()
        xin = x3.clone().requires_grad_(True)
        with torch.no_grad():
            c_fwd = time_call(lambda: cudnn(xin), 5) * 1e3
        y, _ = cudnn(xin)
        c_bwd = time_call(lambda: torch.autograd.grad(
            y, [xin, *cudnn.parameters()], cot[0], retain_graph=True),
            5) * 1e3
        lines.append(text + f"; cuDNN GRU fwd {c_fwd:.1f} us, bwd "
                     f"{c_bwd:.1f} us")
        del y, cudnn, xin, hs, gates
    return lines


def gru_records(launches: dict, smi: str) -> list:
    """Each GRU kernel at the seq2seq encoder's shape [64, 30, 512] (tanh
    candidate, full lengths, the weight slices of one [512, 1536]
    parameter): checked against the plain version, then timed beside its
    bound, the plain version's time and a cuDNN GRU's (torch.nn.GRU fed
    x3: it applies r after the product, r (h W_hn), and adds its own
    [1536, 1536] input projection — the same work, not the same function;
    a yardstick, never called by the port).  The forward is timed as
    training runs it (saving the gates) and as decode runs it; the
    backward's walk and weight-gradient product apart (torch.profiler);
    then the launch plans of GRU_PLANS_TIMED, a single-row launch, the
    per-part split of one step (clock64() stamps, gru_phase_stamps) and
    the batches of GRU_SLICED (gru_sliced_timings)."""
    from paddle_tpu_torch.ops import gru_fused as gf
    B, T, D = S2S_BATCH, S2S_SRC, S2S_HIDDEN
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    acts = dict(active_type="tanh", gate_active_type="sigmoid")
    names = ("tanh", "sigmoid")
    inputs, cot = gru_inputs(g, B, T, D, False)
    errs = gru_compare(inputs, cot, False, **acts)
    rel = max(r for _, r in errs.values())
    log(f"[seq2seq] gru kernels vs plain at [{B}, {T}, {D}] tanh: worst "
        f"{rel:.2e} of max (tol {GRU_TOL:g})")
    if not rel <= GRU_TOL:
        raise AssertionError(f"gru kernels disagree with their plain version "
                             f"at the run's shape: {errs}")
    err = {"gru_fwd": max(errs[n][0] for n in GRU_NAMES[:2]),
           "gru_bwd": max(errs[n][0] for n in GRU_NAMES[2:])}
    x3, lens, w, h0 = inputs
    wg, wc = w[:, :2 * D], w[:, 2 * D:]
    plan = gf.plan_for(B, D, x3.device)
    hs, gates = gf.gru_fwd_kernel(x3, lens, wg, wc, h0, names, False,
                                  save_gates=True)

    def fwd(p=None, save=True):
        return gf.gru_fwd_kernel(x3, lens, wg, wc, h0, names, False,
                                 save_gates=save, plan=p)

    def bwd(p=None):
        return gf.gru_bwd_kernel(lens, wg, wc, h0, hs, gates, *cot, names,
                                 False, plan=p)

    ms = {"gru_fwd": time_call(fwd, 20), "gru_bwd": time_call(bwd, 20)}
    decode_ms = time_call(lambda: fwd(save=False), 20)
    split = kernel_device_ms(bwd, 10, ("gru_bwd_kernel", "gru_dw_kernel",
                                       "gru_reduce_kernel"))
    plans = {}
    for rows, units in GRU_PLANS_TIMED:
        p = gf.gru_plan(B, D, *gf.kernel.device_limits(x3.device),
                        rows=rows, units=units)
        plans[(rows, units)] = (time_call(lambda: fwd(p), 20),
                                time_call(lambda: bwd(p), 20))
    one_plan = gf.plan_for(1, D, x3.device)
    one_row = time_call(lambda: gf.gru_fwd_kernel(
        x3[:1], lens[:1], wg, wc, h0[:1], names, False), 20)
    phases = gru_phase_split((x3, lens, wg, wc, h0, *cot, names, False),
                             plan)
    leaves = [t.clone().requires_grad_(True) for t in (x3, w, h0)]

    def plain_fwd():
        xl, wl, hl = leaves
        return gf.gru_fused_plain(xl, lens, wl[:, :2 * D], wl[:, 2 * D:], hl,
                                  **acts)

    plain = {"gru_fwd": time_call(plain_fwd, 3)}
    out = plain_fwd()
    loss = sum((o * c).sum() for o, c in zip(out, cot))
    plain["gru_bwd"] = time_call(lambda: torch.autograd.grad(
        loss, leaves, retain_graph=True), 3)
    del out, loss
    cudnn = torch.nn.GRU(3 * D, D, batch_first=True).cuda()
    xin = x3.clone().requires_grad_(True)
    with torch.no_grad():
        lib = {"gru_fwd": time_call(lambda: cudnn(xin), 10)}
    y, _ = cudnn(xin)
    lib["gru_bwd"] = time_call(lambda: torch.autograd.grad(
        y, [xin, *cudnn.parameters()], cot[0], retain_graph=True), 10)
    del y
    # the work this run's inputs need: every valid step is one [D] x [D, 3D]
    # product per row in the forward (h Wg, then (r h) Wc) and two in the
    # backward (dx3's products with W^T, the weight gradients); bytes: x3
    # of the valid steps and the weights read, the saved gates of the valid
    # steps and hs of every step written (forward); the gates of the valid
    # steps, hs and the cotangents read, dx3 and the gradients written
    # (backward)
    valid = float(lens.sum())
    step, small = 3.0 * D * 4, 4.0 * (3 * D * D + 2 * B * D + B)
    work = {"gru_fwd": (2 * valid * step + B * T * D * 4 + small,
                        2.0 * valid * D * 3 * D),
            "gru_bwd": (valid * step + B * T * (step + 2 * D * 4)
                        + 2 * small, 4.0 * valid * D * 3 * D)}
    log(f"[seq2seq] gru plan {plan.args()} (groups, CTAs a group, rows a "
        f"group, units a CTA, rows staged at once) = {plan.grid} CTAs, "
        f"{plan.smem_fwd} / {plan.smem_bwd} bytes of shared memory; plans "
        f"timed (rows, units): " + ", ".join(
            f"{k}: fwd {f * 1e3:.1f} us, bwd {b_ * 1e3:.1f} us"
            for k, (f, b_) in plans.items()) + f" [{smi}]")
    log(f"[seq2seq] gru backward {ms['gru_bwd'] * 1e3:.1f} us: walk "
        + ", ".join(f"{k} {v * 1e3:.1f} us" if v is not None
                    else f"{k} not measured (no device time)"
                    for k, v in split.items())
        + f" per call (torch.profiler over 10 calls); forward without the "
        f"gates (decode) {decode_ms * 1e3:.1f} us [{smi}]")
    log(f"[seq2seq] a single-row launch of the gru forward kernel (plan "
        f"{one_plan.args()}): {one_row * 1e3:.1f} us = "
        f"{one_row * 1e3 / T:.2f} us/step [{smi}]")
    log(f"[seq2seq] one gru step at [{B}, {T}, {D}], CTA 0: {phases}")
    for line in gru_sliced_timings(g, T, names):
        log(f"[seq2seq] gru {line} [{smi}]")
    records = []
    for name, src_line in (("gru_fwd", 300), ("gru_bwd", 326)):
        nbytes, flops = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        log(f"[seq2seq] {name} at [{B}, {T}, {D}] float32: "
            f"{ms[name] * 1e3:.1f} us/launch = {ms[name] * 1e3 / T:.2f} "
            f"us/step; bound {bound_ms * 1e3:.1f} us "
            f"({'operations' if flops_ms >= bytes_ms else 'bytes'}; "
            f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s float32, "
            f"{nbytes / 1e6:.1f} MB) = {bound_ms / ms[name]:.1%} of the "
            f"bound; plain version {plain[name] * 1e3:.1f} us; cuDNN GRU "
            f"{'forward' if name == 'gru_fwd' else 'backward'} "
            f"{lib[name] * 1e3:.1f} us = {lib[name] / ms[name]:.2f}x the "
            f"kernel's time [{smi}]")
        if not ms[name] < lib[name]:
            raise AssertionError(f"{name} is not faster than the cuDNN GRU "
                                 f"at [{B}, {T}, {D}]: {ms[name]} ms against "
                                 f"{lib[name]} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gru.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{src_line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain[name], "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": lib[name]})
    return records


def additive_bound_ms(B: int, T: int, D: int, Dv: int) -> tuple[float, str]:
    """The least time for one step at full lengths: u, v, enc_proj and
    enc_seq read once, the context written (float32), against ~(4 D + 2 Dv)
    flops per key."""
    nbytes = 4.0 * (B * D + D + B * T * (D + Dv) + B + B * Dv)
    flops = float(B * T * (4 * D + 2 * Dv))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def additive_records(launches: dict, smi: str) -> list:
    """The additive-attention kernel at the decoder's training shape
    [64, 30, 512, 1024] and the beam search's [192, 30, 512, 1024], float32,
    full lengths: checked against its plain version, then timed on the
    device beside its bound and the plain version's time (no single PyTorch
    call computes the step, so no library time).  The record is the
    training shape's."""
    from paddle_tpu_torch.ops import additive_attention as aa
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    rec = None
    for B in (S2S_BATCH, 3 * S2S_BATCH):
        args = additive_inputs(g, B, S2S_SRC, S2S_HIDDEN, 2 * S2S_HIDDEN,
                               False)
        err, _ = additive_error(args)
        if not err <= ADD_TOL_F32:
            raise AssertionError(f"additive attention kernel disagrees with "
                                 f"its plain version at B={B}: {err}")
        ms = time_call(lambda: aa.additive_attention_kernel(*args), 20)
        plain_ms = time_call(lambda: aa.additive_attention_plain(*args), 10)
        bound_ms, bound_by = additive_bound_ms(B, S2S_SRC, S2S_HIDDEN,
                                               2 * S2S_HIDDEN)
        ctas = {c: time_call(
            lambda: aa._launch(*args, ctas=c), 20)
            for c in (1, 2, 4, 8) if -(-2 * S2S_HIDDEN // c) <= aa.MAX_SLICE}
        log(f"[seq2seq] additive_attention at [{B}, {S2S_SRC}, {S2S_HIDDEN}, "
            f"{2 * S2S_HIDDEN}] float32: {ms * 1e3:.2f} us/launch "
            f"({aa.additive_plan(B, 2 * S2S_HIDDEN, aa._sm_count(args[0].device))}"
            f" CTAs a row; pinned "
            + ", ".join(f"{c}: {t * 1e3:.2f}" for c, t in ctas.items())
            + f" us); bound {bound_ms * 1e3:.2f} us ({bound_by}) = "
            f"{bound_ms / ms:.1%} of the bound; plain version "
            f"{plain_ms * 1e3:.1f} us; max_abs_err {err:.2e}; no single "
            f"PyTorch call computes the step [{smi}]")
        if rec is None:
            rec = {"name": "additive_attention", "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/additive_attention.cu",
                   "replaces": "paddle_tpu/ops/pallas_additive.py:68",
                   "launches": launches["additive_attention"],
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
    return [rec]


def phase_seq2seq_routes() -> None:
    """fp32 at full width, batch 16: one training step through K1 and K2
    against the same step through their plain versions (the op modules'
    attributes swapped for the comparison run)."""
    from paddle_tpu_torch.models import seq2seq_trainer_config
    from paddle_tpu_torch.ops import additive_attention as aa
    from paddle_tpu_torch.ops import gru_fused as gf
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.trainer import Trainer

    B, T = 16, S2S_SRC
    cfg = seq2seq_trainer_config(S2S_VOCAB, S2S_HIDDEN, B)
    params = init_params(cfg.model_config, seed=1)
    # the demo starts the biases at zero; wake them so that every gradient
    # path carries signal
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    for name, p in params.items():
        if not bool(p.any()):
            params[name] = 0.05 * torch.randn(p.shape, generator=g,
                                              device="cuda")
    batch = seq2seq_batches(1, B, T, seed=6, ragged=True)[0]
    got = {}
    kernels = (gf.gru_fused, aa.additive_attention_kernel)
    for route in ("kernel", "plain"):
        tr = Trainer(cfg, params=params)
        gf.counts.reset()
        aa.counts.reset()
        if route == "plain":
            gf.gru_fused = gf.gru_fused_plain
            aa.additive_attention_kernel = aa.additive_attention_plain
        try:
            loss, grads, _ = tr.compute_gradients(tr.prepare_batch(batch))
        finally:
            gf.gru_fused, aa.additive_attention_kernel = kernels
        torch.cuda.synchronize()
        got[route] = (float(loss), grads, seq2seq_counts()[:5])
    (lk, gk, ck), (lp, gp, cp) = got["kernel"], got["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    worst, worst_name = 0.0, ""
    for n, ref in gp.items():
        e = float((gk[n] - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1e-30)
        if e > worst:
            worst, worst_name = e, n
    log(f"[seq2seq-routes] fp32, full width, [{B}, {T}] ragged: loss kernel "
        f"{lk:.6f} vs plain {lp:.6f} (rel {rel_loss:.2e}, tol 1e-5); worst "
        f"gradient {worst:.2e} of its max ({worst_name}; tol 1e-4); launches "
        f"(gru fwd, gru bwd, gru plain, additive kernel, additive plain) "
        f"kernel {ck}, plain {cp}")
    if ck != (2, 2, 0, T + 1, 0) or cp != (0, 0, 2, 0, T + 1):
        raise AssertionError(f"routes did not take their paths: {ck}, {cp}")
    if not (rel_loss <= 1e-5 and worst <= 1e-4 and set(gk) == set(gp)):
        raise AssertionError("the GRU/additive kernel and plain training "
                             "routes disagree")


@contextlib.contextmanager
def logged(name: str):
    """The log records the logger `name` writes within."""
    import logging
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record)

    keep = Keep()
    logging.getLogger(name).addHandler(keep)
    try:
        yield seen
    finally:
        logging.getLogger(name).removeHandler(keep)


def _lstm_train(batch) -> dict:
    return {"lstm_fwd_kernel": 3, "lstm_bwd_kernel": 3}


def _lstm_test(batch) -> dict:
    return {"lstm_fwd_kernel": 3}


def _s2s_train(batch) -> dict:
    """A seq2seq step on the feeder's batches: the encoder's GRUs, the
    additive attention once per decoder step (the target's padded
    length)."""
    T = batch["target_language_word"].ids.shape[1]
    return {"gru_fwd_kernel": 2, "gru_bwd_kernel": 2,
            "additive_attention_kernel": T}


def _s2s_test(batch) -> dict:
    T = batch["target_language_word"].ids.shape[1]
    return {"gru_fwd_kernel": 2, "additive_attention_kernel": T}


# the [cli] runs: (tag, config file, --config_args, the kernels a training
# step launches, those a test batch launches)
CLI_RUNS = (
    ("sentiment", "demo/sentiment/trainer_config.py", "", _lstm_train,
     _lstm_test),
    ("seq2seq", "demo/seqToseq/seqToseq_net.py",
     "dict_size=30000,hidden_dim=512,batch_size=64", _s2s_train, _s2s_test),
    ("lm", "demo/model_zoo/transformer_lm.py",
     "vocab=32000,dim=512,layers=8,heads=8,attn_impl=flash,"
     "compute_dtype=bfloat16", flash_route(8, torch.bfloat16), None),
)


def checkpoint_differs(a: str, b: str) -> list:
    """The arrays of two checkpoints (parameters, optimizer state, dropout
    generator) that are not bit-identical, by name."""
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    da, db = ckpt.load_checkpoint(a), ckpt.load_checkpoint(b)
    bad = []
    for part in ("params", "opt", "dropout_rng"):
        fa = ckpt._flatten(da.get(part), part)
        fb = ckpt._flatten(db.get(part), part)
        bad += sorted(fa.keys() ^ fb.keys())
        bad += [n for n in fa.keys() & fb.keys()
                if not np.array_equal(fa[n], fb[n])]
    return bad


# the kernel wrappers the config's layers call, as the layers look them up
# (module, attribute)
CLI_WRAPPERS = (("paddle_tpu_torch.ops.lstm_fused", "lstm_fused"),
                ("paddle_tpu_torch.ops.gru_fused", "gru_fused"),
                ("paddle_tpu_torch.ops.additive_attention",
                 "additive_attention"),
                ("paddle_tpu_torch.graph.layers_attn", "flash_attention"))


def signature(x):
    """A call argument as it selects a kernel's shape: a tensor by its
    shape and dtype, anything else as it is."""
    if torch.is_tensor(x):
        return tuple(x.shape), x.dtype
    return x


@contextlib.contextmanager
def recorded_inputs():
    """Within: each wrapper of CLI_WRAPPERS keeps a copy of its arguments
    at the first call of each signature (its tensors' shapes and dtypes,
    its other arguments), then runs as it would.  Yields {(attribute,
    signature): (args, kwargs)}."""
    import importlib

    def copy(x):
        return x.detach().clone() if torch.is_tensor(x) else x

    seen: dict = {}
    originals = []
    for module, attr in CLI_WRAPPERS:
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        originals.append((mod, attr, fn))

        def keep(*args, _fn=fn, _attr=attr, **kw):
            key = (_attr, tuple(signature(a) for a in args),
                   tuple((n, signature(v)) for n, v in sorted(kw.items())))
            if key not in seen:
                seen[key] = (tuple(copy(a) for a in args),
                             {n: copy(v) for n, v in kw.items()})
            return _fn(*args, **kw)
        setattr(mod, attr, keep)
    try:
        yield seen
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


def one_of_each_shape(batches: list) -> list:
    """The first batch of each shape (every slot's), in the order seen."""
    first: dict = {}
    for b in batches:
        key = tuple((n, tuple(a.data.shape)) for n, a in sorted(b.items()))
        first.setdefault(key, b)
    return list(first.values())


def cli_check_lstm(g, args, kw) -> tuple:
    x4, lens, w, peeps, h0, c0 = args
    B, T, D4 = x4.shape
    D, reverse = D4 // 4, kw.get("reverse", False)
    acts = {n: kw.get(n, d) for n, d in (
        ("active_type", "tanh"), ("gate_active_type", "sigmoid"),
        ("state_active_type", "tanh"))}
    inputs = (x4, lens.to(torch.int32), w, peeps, h0, c0)
    if acts["active_type"] == "relu":
        inputs = move_off_relu_kink(inputs, reverse, **acts)
    cot = tuple(torch.randn(*s, generator=g, device="cuda")
                for s in ((B, T, D), (B, D), (B, D)))
    errs = lstm_compare(inputs, cot, reverse, **acts)
    rel = max(r for _, r in errs.values())
    return (f"[{B}, {T}, {D}] {'rev' if reverse else 'fwd'} "
            f"{acts['active_type']}",
            f"worst {rel:.2e} of max (tol {LSTM_TOL:g})", rel <= LSTM_TOL)


def cli_check_gru(g, args, kw) -> tuple:
    x3, lens, w_gate, w_cand, h0 = args
    B, T, D3 = x3.shape
    D, reverse = D3 // 3, kw.get("reverse", False)
    acts = {n: kw.get(n, d) for n, d in (("active_type", "tanh"),
                                         ("gate_active_type", "sigmoid"))}
    inputs = (x3, lens.to(torch.int32), torch.cat([w_gate, w_cand], 1), h0)
    if acts["active_type"] == "relu":
        inputs = gru_move_off_relu_kink(inputs, reverse, **acts)
    cot = tuple(torch.randn(*s, generator=g, device="cuda")
                for s in ((B, T, D), (B, D)))
    errs = gru_compare(inputs, cot, reverse, **acts)
    rel = max(r for _, r in errs.values())
    return (f"[{B}, {T}, {D}] {'rev' if reverse else 'fwd'} "
            f"{acts['active_type']}",
            f"worst {rel:.2e} of max (tol {GRU_TOL:g})", rel <= GRU_TOL)


def cli_check_additive(g, args, kw) -> tuple:
    dec, w, v, proj, seq, lens = args
    u = torch.matmul(dec.float(), w.float())    # as the autograd function
    err, share = additive_error((u, v.float().contiguous(), proj.contiguous(),
                                 seq.contiguous(), lens.to(torch.int32)))
    B, T, D = proj.shape
    if seq.dtype == torch.float32:
        text, ok = f"max_abs_err {err:.3e} (atol {ADD_TOL_F32:g})", \
            err <= ADD_TOL_F32
    else:
        text, ok = f"{share:.3f} of 2^-7|ref| + 1e-3", share <= 1
    return (f"[{B}, {T}, {D}, {seq.shape[2]}] {str(seq.dtype)[6:]} "
            f"len={int(lens.min())}..{int(lens.max())}", text, ok)


def cli_check_flash(g, args, kw) -> tuple:
    q, k, v = args
    B, Tq, H, _ = q.shape
    kvm = kw.get("k_valid")
    kvm = (torch.ones(B, k.shape[1], dtype=torch.bool, device="cuda")
           if kvm is None else kvm.bool())
    do = torch.randn(*q.shape, generator=g, device="cuda").to(q.dtype)
    dlse = 0.1 * torch.randn(B, H, Tq, generator=g, device="cuda")
    mask = dict(causal=bool(kw.get("causal", False)), window=kw.get("window"))
    e, _, _ = flash_errors(q, k, v, kvm, do, dlse, **mask)
    return (f"{list(q.shape)} H_kv={k.shape[2]} {str(q.dtype)[6:]} "
            f"causal={mask['causal']} window={mask['window']}",
            flash_line(e, q.dtype), e["ok"])


CLI_CHECKS = {"lstm_fused": cli_check_lstm, "gru_fused": cli_check_gru,
              "additive_attention": cli_check_additive,
              "flash_attention": cli_check_flash}


def cli_kernel_checks(tag: str, cfg, train_b: list, test_b: list,
                      want: dict) -> int:
    """A Trainer here steps once on the first batch of each shape of
    `train_b` (and tests one of each shape of `test_b`), keeping each
    kernel wrapper's inputs at each signature; then each kernel against
    its plain version on those inputs, with its phase's limit.  Every
    kernel of `want` ({symbol: launches}) must have been held.  Raises on
    a disagreement; returns the number of checks."""
    from paddle_tpu_torch.trainer import Trainer

    tr = Trainer(cfg, seed=1)
    with recorded_inputs() as calls:
        tr.train_one_pass(one_of_each_shape(train_b), steps_per_dispatch=1)
        if test_b:
            tr.test(one_of_each_shape(test_b))
    del tr
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    for (attr, _, _), (args, kw) in calls.items():
        shape, text, ok = CLI_CHECKS[attr](g, args, kw)
        log(f"[cli] {tag}: {attr} at the CLI's {shape} against its plain "
            f"version: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[cli] {tag}: {attr} disagrees with its "
                                 f"plain version at {shape}")
    held = {attr for attr, _, _ in calls}
    needed = {KERNEL_COUNTERS[sym][0] for sym, n in want.items() if n}
    if not needed <= held:
        raise AssertionError(f"[cli] {tag}: {sorted(needed - held)} not "
                             f"called by the steps")
    return len(calls)


def cli_pair(tag: str, path: str, args: str, train_route, test_route,
             out: str, smi: str = "") -> dict:
    """`python -m paddle_tpu_torch train --config=path --config_args=args
    --num_passes=1` in this process at --steps_per_dispatch=1 and KSTEP,
    each under torch.profiler, the counts set to 0 before it: exit 0, the
    kernels launched as the pass's training batches (`train_route`) and
    test batches (`test_route`) say, held by the wrappers at k = 1 and by
    the profiler at KSTEP, no plain version; the two runs' pass
    statistics and checkpoints bit-identical.  The batches are the
    feeder's, assembled here once more (make_feeder, as the trainer
    does) and timed: the host ms per batch; before the runs, every kernel
    is held against its plain version at their shapes
    (cli_kernel_checks).  Returns the runs' figures."""
    from paddle_tpu_torch.__main__ import main as cli
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.trainer.trainer import make_feeder

    cfg = parse_config(path, args)
    t0 = time.perf_counter()
    feeder = make_feeder(cfg, cfg.data_config, True)
    t1 = time.perf_counter()
    train_b = list(feeder.batches())
    host_ms = (time.perf_counter() - t1) * 1e3 / len(train_b)
    log(f"[cli] {tag}: the feeder: {(t1 - t0) * 1e3:.1f} host ms to load "
        f"and initialize the provider, {host_ms:.3f} host ms per batch "
        f"over {len(train_b)} batches")
    test_b = (list(make_feeder(cfg, cfg.test_data_config, False).batches())
              if cfg.test_data_config is not None else [])
    want = route_total(train_route, train_b)
    for sym, n in route_total(test_route, test_b).items():
        want[sym] = want.get(sym, 0) + n
    n = cli_kernel_checks(tag, cfg, train_b, test_b, want)
    log(f"[cli] {tag}: {n} kernel checks at the CLI's shapes passed")
    runs = {}
    for k in (1, KSTEP):
        save = os.path.join(out, f"k{k}")

        def train():
            return cli(["train", f"--config={path}", f"--config_args={args}",
                        "--num_passes=1", f"--save_dir={save}",
                        f"--steps_per_dispatch={k}", "--log_period=100000"])

        reset_counts()
        rc, wall, kernels, _ = profiled(train)
        busy = sum(dev_us(e) for e in kernels) / 1e3
        if rc != 0:
            raise AssertionError(f"[cli] {tag} k={k}: exit code {rc}")
        line = check_launches(f"[cli] {tag} k={k}", kernels, want, k > 1)
        with open(os.path.join(save, "metrics.jsonl")) as f:
            row = json.loads(f.readline())
        runs[k] = dict(row=row, save=save, wall_ms=wall, busy=busy / wall)
        log(f"[cli] {tag} k={k}: {row['batches']} batches, "
            f"{row['samples']} samples, cost {row['cost']:.5g}; "
            f"{row['samples_per_sec']:.1f} samples/s over the pass (the "
            f"provider's load, the first step of each shape and the "
            f"captures included); the whole call (parse, init, pass, test "
            f"pass of {len(test_b)} batches, checkpoint) {wall / 1e3:.2f} "
            f"s, device busy {busy:.1f} ms = {busy / wall:.1%}; {line} "
            f"[{smi}]")
    stats = [{n: v for n, v in runs[k]["row"].items()
              if n not in ("ts", "seconds", "samples_per_sec")}
             for k in (1, KSTEP)]
    differ = checkpoint_differs(
        os.path.join(runs[1]["save"], "pass-00000"),
        os.path.join(runs[KSTEP]["save"], "pass-00000"))
    log(f"[cli] {tag}: k={KSTEP} against k=1: pass statistics "
        f"{'equal' if stats[0] == stats[1] else 'DIFFER'}, checkpoints "
        f"{'bit-identical' if not differ else 'DIFFER: ' + str(differ[:5])}")
    if stats[0] != stats[1] or differ:
        raise AssertionError(f"[cli] {tag}: --steps_per_dispatch={KSTEP} is "
                             f"not bit-identical to 1")
    return dict(runs=runs, host_ms=host_ms, cfg=cfg,
                steady=cli_steady_pass(tag, cfg, runs[KSTEP]["save"],
                                       route_total(train_route, train_b),
                                       len(train_b), smi))


def cli_steady_pass(tag: str, cfg, save: str, want: dict, n: int,
                    smi: str) -> dict:
    """The path past its first passes: a Trainer here on the checkpoint of
    the KSTEP run, two passes of the config's source at KSTEP (the first
    runs each shape's first batch eagerly, so its groups differ from
    every later pass's: the second captures those), then a third under
    the profiler, every group a replay: the card launching the kernels
    the batches say, device ms and wall ms per step, busy share,
    samples/s."""
    from paddle_tpu_torch.trainer import Trainer

    tr = Trainer(cfg, seed=1)
    tr.load(os.path.join(save, "pass-00000"))
    for _ in range(2):
        tr.train_one_pass(steps_per_dispatch=KSTEP)
    reset_counts()
    stats, wall, kernels, calls = profiled(
        lambda: tr.train_one_pass(steps_per_dispatch=KSTEP))
    line = check_launches(f"[cli] {tag} steady pass", kernels, want, True,
                          {sym: 0 for sym in want})
    busy = sum(dev_us(e) for e in kernels) / 1e3
    out = dict(dev_ms=busy / n, wall_ms=wall / n, busy=busy / wall,
               per_s=stats["samples_per_sec"], calls=calls / n)
    log(f"[cli] {tag} steady pass (k={KSTEP}, graphs captured, the "
        f"feeder on its thread): {out['wall_ms']:.2f} ms/step wall, "
        f"{out['dev_ms']:.3f} device ms/step, busy {out['busy']:.1%}, "
        f"{out['per_s']:.1f} samples/s, {out['calls']:.1f} host launch "
        f"calls a step; {line} [{smi}]")
    del tr
    return out


def cli_test_round_trip(tag: str, path: str, args: str, save: str,
                        cfg) -> dict:
    """--job=test --init_model_path=<save>/pass-00000: exit 0, and the
    statistics it logs are those of a Trainer here that load()s the
    checkpoint (its parameters the saved arrays bit for bit) and test()s,
    exactly."""
    from paddle_tpu_torch.__main__ import main as cli
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    ck = os.path.join(save, "pass-00000")
    with logged("paddle_tpu_torch.main") as rec:
        rc = cli(["train", f"--config={path}", f"--config_args={args}",
                  "--job=test", f"--init_model_path={ck}"])
    if rc != 0:
        raise AssertionError(f"[cli] {tag} --job=test: exit code {rc}")
    got = [r.args for r in rec if r.getMessage().startswith("test result")]
    tr = Trainer(cfg, seed=1)
    tr.load(ck)
    saved = ckpt.load_checkpoint(ck)["params"]
    same = all(np.array_equal(tr.params[n].cpu().numpy(), saved[n])
               for n in saved)
    want = tr.test()
    log(f"[cli] {tag} --job=test --init_model_path: {got[0] if got else None}"
        f"; loaded parameters {'equal' if same else 'DIFFER from'} the "
        f"saved arrays; an in-process load + test() "
        f"{'gives the same statistics' if got and got[0] == want else 'DIFFERS: ' + str(want)}")
    if not (got and got[0] == want and same):
        raise AssertionError(f"[cli] {tag}: the checkpoint does not round "
                             f"trip through --init_model_path")
    del tr
    return want


def phase_cli(smi: str) -> None:
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        for tag, path, args, train_route, test_route in CLI_RUNS:
            out = os.path.join(root, tag)
            res = cli_pair(tag, path, args, train_route, test_route, out,
                           smi)
            if tag == "sentiment":
                cli_test_round_trip(tag, path, args, res["runs"][1]["save"],
                                    res["cfg"])
            r1, rk, st = res["runs"][1], res["runs"][KSTEP], res["steady"]
            log(f"[cli] {tag}: the feeder {res['host_ms']:.3f} host ms to "
                f"assemble a batch against {st['dev_ms']:.3f} device and "
                f"{st['wall_ms']:.2f} wall ms per step of the steady pass "
                f"(busy {st['busy']:.1%}); the CLI's one pass at k=1 / "
                f"k={KSTEP}: {r1['row']['samples_per_sec']:.1f} / "
                f"{rk['row']['samples_per_sec']:.1f} samples/s, the whole "
                f"call {r1['wall_ms'] / 1e3:.2f} / {rk['wall_ms'] / 1e3:.2f}"
                f" s [{smi}]")
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if argv:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = {}

    def phase(name: str, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - start
        return out

    smi = phase("device", phase_device)
    phase("build", phase_build)
    err = phase("kernel", phase_kernel)
    record = phase("serve", phase_serve, smi, err)
    phase("routes", phase_routes)
    phase("flash", phase_flash)
    flash = phase("train", phase_train, smi)
    flash += phase("train-fp32", phase_train_fp32, smi)
    flash += phase("train-routes", phase_train_routes, smi)
    phase("lstm", phase_lstm)
    lstm = phase("sentiment", phase_sentiment, smi)
    phase("sentiment-routes", phase_sentiment_routes)
    phase("gru", phase_gru)
    phase("additive", phase_additive)
    seq2seq = phase("seq2seq", phase_seq2seq, smi)
    phase("seq2seq-routes", phase_seq2seq_routes)
    phase("cli", phase_cli, smi)
    log(f"[done] {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{n} {t:.1f}" for n, t in seconds.items())
        + f"; the profiler around its runs {PROFILER_SECONDS[0]:.1f}")
    print(json.dumps({"kernels": [record] + flash + lstm + seq2seq}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
