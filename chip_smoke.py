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
               with row_slot given and None; rows whose table rows map
               the same physical pages (k5_shared_case: a shared prefix, a
               copy-on-write copy, two identical table rows); two
               identical launches bit-identical, a decode launch replayed
               from a CUDA graph equal to eager bit for bit;
  4. serve   — the serving path: the transformer LM at full width (vocab
               32000, dim 512, SERVE_LAYERS = 2 layers (the demo
               config's default; 8 until the time limit forced the cut),
               8 heads, bfloat16, random weights
               from seed 1) serving 32 requests through ServingEngine; the
               kernel must launch once per attention layer per step and the
               plain version never; then a torch.profiler pass over 8 of
               the requests (device busy share, top kernels, the kernel's
               share), and the kernel's time per launch, replayed at the
               launches the run made, over all of them and apart for the
               decode and the mixed launches, each beside its memory bound,
               at the engine's one split count (ServingEngine.splits: every
               launch of an engine takes it, so a token's bits do not
               depend on the step type that carried it), at the wrapper's
               per-shape plan and with the split count pinned to 1, 2, 4, 8
               (measurement),
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
               wrapper counted only the forwards outside the windows; the
               engines of this phase keep the prefix cache off
               (prefix_cache=False), as before it was ported;
  4b. serve-prefix — the reference engine's default serving at the same
               width: the repo's prefix-skew workload (PREFIX_WORKLOAD: 64
               requests, 8 prefixes of 128 tokens drawn with Zipf exponent
               1.0, suffixes of 16-64 tokens, max_new 64, every fourth
               sampled) (1) with the prefix cache on and off, two rounds
               in swapped order from a cold cache (hits, prefill tokens
               saved, copy-on-write copies, tokens/s, ms/step) and a
               profiled run of 8 requests each way; (2) on a pool of
               PREFIX_PAGES - 1 = 128 real pages (preemptions replayed,
               check_reclaimed before and after reset_prefix_cache); (3)
               at decode_steps=KSTEP, cache on, its windows replayed from
               CUDA graphs (K5's launches in them read from the profiler
               over 8 requests); (4)
               with three cancels at step 30 and deadlines at step 60 on
               the step clock; (5) checkpoint_state taken mid-flight
               (timed), save_state / load_state onto a fresh engine
               (timed).  Every run's tokens equal the first cache-off
               run's (an ended request's a prefix of them), K5 launches
               once per attention layer per step and the plain version
               never;
  4c. serve-spec — speculative decode at the same width: the repo's
               repetitive workload (SPEC_WORKLOAD: 64 requests whose
               prompts of 32-256 tokens tile a motif of 4-12 tokens, 64
               new tokens each, eos off, greedy) on one engine with the
               budget pinned to SPEC_BUDGET = 144 rows (chunk 64 + 16 slots
               x (SPEC_K + 1)), from a cold cache each run: (1) spec off,
               then spec_k=4 with the n-gram drafter, K5's layer-0 launch
               in a verify step with drafts held against its plain version,
               and both on an engine with the defaulted budget (80 rows
               off, 144 on); (2) the target drafting for itself over 64
               tokens (ModelDrafter.from_target), on the first
               SPEC_MODEL_REQUESTS = 8 requests; (3) dynamic depth; (4)
               the target drafting at dynamic depth with decode_steps=KSTEP
               under decode_mode "auto" (windows where no slot drafts) and
               "static" (no window), on 8 requests;
               (5) every fourth request sampled ([serve-prefix]'s knobs),
               spec off and on; (6) spec on over PREFIX_PAGES - 1 = 128
               real pages (preemptions, check_reclaimed); (7) a
               checkpoint mid-flight with spec on, restored on a fresh
               engine.  Every arm's tokens equal its spec-off run's, every
               chain banks its accepted drafts and one sampled token (spec
               tokens = accepted + chains), K5 launches once per layer per
               eager step, verify steps included, the plain version never;
               each arm logs steps (verify, mixed, windows), tokens/s, the
               accept rate, draft ms a pass, and (1)'s two arms and (4)'s
               "auto" (its windows held by the profiler) a profiled run of
               8 of their requests (2 in (4): SPEC_MODEL_PROFILED; device
               ms/step, busy share, kernels and host launch calls a step,
               K5 on the card as the route says; the other arms are eager,
               held by the wrappers, and not profiled, for the time
               limit);
  4d. decode — the dense decode path at the same width (bfloat16 unless
               said, random weights from seed 1), at tools/bench_lm.py's
               decode defaults (batch 32, 64 new tokens; one warm call,
               then DECODE_REPS = 2 timed, one for the re-forward and
               fp32 arms, whose warm call a teacher-forced forward of
               their shape made, decode tokens/s = 32 x 64 / median; each
               arm's profiled call makes DECODE_PROFILE_NEW = 8 new
               tokens):
               (1) lm_generate(use_cache=True) at contexts 512, 1024 and
               4096 (prompt = context - 64) and once on ragged prompts of
               2,049-4,032 tokens: the prefill runs K4's bf16 forward once
               per layer (prompts of >= 2048 tokens), held against its
               plain version on the path's recorded inputs within
               [flash]'s o limit; (2) use_cache=False (re-forward) at 512
               and 1024; (3) float32 (TF32 off) at 1024, both modes; (4)
               lm_beam_generate, batch 8, beam 4, prompt 448: beam 1 equals
               greedy cached decoding, scores best-first; every greedy run's
               tokens held by GREEDY_MARGIN (each token's teacher-forced
               probability within 5% (bf16) / 1e-4 (fp32) of its
               position's best, a whole-sequence forward over the run's
               tokens), the launches of every call held (K4 as the prompt
               length says, K5 never, no plain version), a profiled call
               each; (5) ServingEngine(prefill_chunk=None) on bench.py
               bench_serving_chunked's heavy-tail workload (HEAVY: 64
               requests, prompts 32-703, 16 slots, pages of 16, context
               768) beside the same engine chunked (chunk 64): steps,
               tokens/s, first-token p50/p99, K5 once per layer per step,
               both held by the teacher-forced margin, a profiled run of
               HEAVY_PROFILED = 4 whole-prompt requests; then on 24 of
               them decode_steps=KSTEP
               windows, spec_k=SPEC_K and a checkpoint restored mid-flight
               on a fresh engine, each with the straight run's tokens;
               then 8 requests at context 4096 (HEAVY_LONG) whose
               whole-prompt buckets of >= 2048 tokens launch K4 once per
               layer, held against its plain version on the recorded
               [1, bucket] inputs; K4 timed at the prefill's
               [32, 4032, 8, 64] (the kernels line's record);
  4e. serve-spill — the rest of the engine at the same width, on
               bench.py bench_serving_spill's configuration (SPILL_ENGINE:
               4 slots, pages of 16, context 768, 96 pages, below the
               working set; SPILL_BUDGET 64 MiB of host tier) and the
               prefix-skew workload greedy: (1) an engine with the prefix
               cache off, then one engine with the spill tier off and on
               (set_spill_budget, reset_prefix_cache before each arm): the
               tokens equal request for request, the on arm spills and
               restores pages and hits more often, restored tokens within
               restored pages x 16, each engine site's signature count
               unchanged between the arms, K5 once per layer per step and
               the plain version never; hit rates, tokens saved, tokens/s,
               first-token p50, ms a spilled and a restored page, and the
               D2H / H2D rates of pageable and pinned memory (measurement
               only); K5 held against its plain version on the first
               launch that read a restored page and timed over the on
               arm's layer-0 launches (the kernels line's record);
               (2) the on arm at decode_steps=KSTEP: windows replayed from
               CUDA graphs beside restores, the k = 1 tokens; (3) a cached
               prefix exported and imported into a second engine (its
               pools' addresses unchanged), whose admission of the prompt
               hits with the cold run's tokens, ms a page each way; (4)
               SPILL_TRACED requests with the tracer on and off, two
               rounds: the tokens equal, ms/step each way, every request
               lane queued -> prefill -> decode -> done, the Chrome trace
               written and read back, a flight bundle dumped and read
               back;
  4f. serve-fleet — the RPC front end and the fleet at the same width
               (FLEET_MODEL, FLEET_ENGINE: 16 slots, pages of 16, context
               768, chunk 64): four replica subprocesses (python -m
               paddle_tpu_torch.tools.serve, each printing SERVE_JSON; two
               role both, one prefill, one decode) start first, on the one
               card.  (1) a ServingServer in this process over TCP: the 32
               requests of [serve] through ServingClient, streamed, FLEET_CONC
               = 8 in flight, at decode_steps 1 and KSTEP, beside the same
               closed loop on a second engine of the configuration driven
               directly: the tokens equal request for request, streamed
               indexes consecutive, bursts <= k (some > 1 at k = KSTEP),
               stats consistent, every metric family with # HELP and #
               TYPE, the allocator's memory gauges; K5 once per layer per
               eager step, launched on the pump thread only, the plain
               version never; tokens/s, ms/step and first-token p50 / p99
               both ways; then on one server (max_queue 0, the step clock)
               a 17th request refused queue_full, a cancel after the third
               token, a deadline FLEET_DEADLINE steps out, a drain with
               requests in flight (a late one refused draining, the rest
               the direct run's tokens); K5's first recorded pump-thread
               launch held against its plain version (bf16, 2e-2) and
               timed (the kernels line's record); (2) the prefix-skew
               workload (every fourth sampled) through FleetRouter(policy=
               "affinity") over the two role-both replicas: tokens equal
               the single engine's, hit rate, placements, no shed or
               retry; (3) bench_serving_disagg's workload (the same
               prompts, greedy) through a router over the prefill and the
               decode replica: every prompt prefills, kv_pushes its pages
               and decodes on the other, pages shipped, no push failure or
               fallback, tokens equal; ms a pushed page from
               FLEET_PUSH_PROBE prefill_only requests; (4) a replica
               SIGKILLed while one request streams and two have streamed
               nothing: those two finish on the survivor with the single
               engine's tokens, the streamed one gets the 'already
               streamed' error; SIGTERM drains each survivor, exit 0;
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
  8b. train-jobs — the training features of the reference's trainer:
               (a) gradient accumulation on the LM at full width, N = 4
               micro-batches of [2, 2048] after a warm-up window, in
               float32 and bf16: the mean gradient the window's update
               consumes (`ParameterUpdater.window_mean`) against one
               step's gradient on the four concatenated (fp32 within 1e-4
               of each parameter's largest; bf16 within 2^-6, as each
               micro-gradient is rounded to bf16 before the float32 sum),
               K4's three kernels of the dtype 8 a micro-step each, one
               update a window; then the kernels at [2, 2048, 8, 64]
               against their plain versions and timed, as in phase 7;
               N = 3 at k = 4 against k = 1 over two passes of 12 bf16
               micro-steps, bit for bit (losses, statistics, parameters,
               slots, counters, the window's sums), ms per micro-step
               beside the plain step's; (b) demo/sentiment/
               trainer_config.py with auc (weighted), precision_recall,
               pnpair (weighted), an auc-validation layer and a gradient
               printer appended, 8 steps of [128, 100] (K3 3 + 3 a step):
               the results equal the CPU evaluators' on the outputs the
               card's steps handed the host, k = 4 equals k = 1 bit for
               bit, the AUC evaluator's device time; K3 at [128, 100, 128]
               against its plain version and timed; (c) the CLI in
               subprocesses: --job=checkgrad on the sentiment config (K3)
               and on the LM (vocab 32000, dim 512, 2 layers, fp32, K4's
               float32 kernels), exit 0, the wrappers counting the
               launches; --detect_nan from a checkpoint with NaN in the
               embedding, exit 1 naming the embedding layer; two passes at
               k = 4 with --show_parameter_stats_period=2 and --save_dir
               (the stats logged; metrics.jsonl's registry snapshot with
               trainer.train_step and trainer.fused_step among its compile
               sites and the device-memory gauges); --job=time with
               --profile_dir (samples/s; lstm_fwd_kernel in the trace);
  9. lstm    — the two fused-LSTM kernels (forward; backward) against their
               plain version in float32: forward/reverse x with/without
               peepholes x ragged (a length-0 row, a full row) / full
               lengths x tanh / relu cells, at [B, T, D] = [128, 100, 128],
               [5, 7, 32] (a partly filled group), [64, 20, 256],
               [32, 12, 512] (part of W read from L2), [1000, 12, 128]
               (clusters in waves) and [150, 32, 32] (SRL's: 150 rows at
               the smallest hidden size the kernels take), each with the
               launch plan it took: hs,
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
               source) at --steps_per_dispatch=1 and at KSTEP (the KSTEP
               run under torch.profiler; the k = 1 run timed alone): the
               card launched each kernel as the
               pass's batches say (held by the wrappers at k = 1, by the
               profiler's kernel events at KSTEP), no plain version; the
               two runs' pass statistics and checkpoints (parameters,
               optimizer state, dropout generator) bit-identical; samples/s
               of the pass, device busy share and ms per step, beside the
               feeder's host ms to assemble a batch; then, on the
               sentiment config, --job=test --init_model_path of the
               checkpoint the k = 1 run saved: the statistics of a
               Trainer.load() of it here, exactly;
 17. image   — the image path, no hand-written kernel on it (cuDNN and
               ATen convolutions, pools and batch norm): the CLI on
               demo/image_classification/vgg_16_cifar.py (batch 128,
               fp32, and compute_dtype=bfloat16), demo/mnist/vgg_16_mnist.py
               (batch 128) and demo/model_zoo/resnet.py at its defaults
               (ResNet-50, 224 x 224, 1000 classes, batch 64, discexp),
               each on its provider's synthetic data, TF32 off: one pass
               at --steps_per_dispatch=1 and at KSTEP (the KSTEP run under
               the profiler), no hand-written kernel and no plain version;
               the two runs'
               statistics and checkpoints bit-identical, batch norm's
               moving mean, variance and count included, each count the
               pass's steps; --job=test --init_model_path of the k = 1
               checkpoint equal to an in-process load (parameters and
               moving statistics the saved arrays) + test(); then steady
               passes over the first STEADY_BATCHES = 16 of the feeder's
               batches at k = 1 and KSTEP:
               wall and device ms/step, busy share, samples/s, kernels
               and host launch calls a step, the top device operations,
               peak memory;
 18. tagging — the sequence-tagging and sparse-input path: the CLI on
               demo/semantic_role_labeling/db_lstm.py at its defaults
               (depth 8, hidden_dim 128, batch 150; K3 once per lstmemory
               a step, forward and backward), demo/sequence_tagging/
               linear_crf.py and rnn_crf.py (batch 16, model averaging,
               the CRF, sparse-row features, the chunk and sum
               evaluators), demo/quick_start/trainer_config.lr.py and .cnn.py,
               demo/recommendation/trainer_config.py and
               demo/introduction/trainer_config.py, each as in phase 16
               (kernels held at the CLI's shapes, k = 1 against KSTEP bit
               for bit, averages and evaluator results included, launches
               as the route says, no plain version, the steady pass with
               its top device operations), then --job=test of the k = 1
               checkpoint on the averaged parameters equal to an
               in-process load + test() (every config with a test
               source), then steady passes at k = 1 and KSTEP over the
               first STEADY_BATCHES of the feeder's batches; then K3 at SRL's [150, 32, 32] against its plain
               version and timed beside its bound, the plain version and a
               cuDNN LSTM; the table gradient's repeats (F.embedding
               against ops/table.py lookup_rows, which must repeat bit for
               bit) and the fp32 step product of rnn_crf's RNN timed.
 19. nested  — nested sequences and carried recurrent state: (a) the
               nested test configs (tests/configs/sequence_nest_rnn.py
               and _multi_input.py) from their files at their own widths
               on the reference's documents, then copies at vocabulary
               30000, word_dim 128, hidden_dim 512, two labels on batches
               of 128 documents of 1-8 sub-sequences of 4-32 words (seed
               1): cost and every gradient within rtol 1e-4, atol 1e-5 of
               their flat twins' (the reference's hierarchical oracle);
               the nested RNN and its flat twin through kstep_training
               (k = 4 bit-identical to k = 1; no hand-written kernel on
               this path); (b) a hierarchical LSTM (HIER_LSTM: an outer
               group over the sub-sequences, fc(512) -> lstmemory(128) ->
               last_seq a step, an fc memory): K3 held against its plain
               version at the outer steps' shapes, then kstep_training,
               the card launching K3's forward and backward once per
               outer step; (c) the --prev_batch_state chunk oracle: two
               chunks of T/2 with the carried state end where one
               T-step forward ends (final states, each row's last valid
               output, within 1e-5 of the largest), an lstmemory at
               [128, 100] hidden 128 (K3) and a gated_recurrent at
               [64, 30] hidden 512 (K1), ragged rows; the second chunk's
               kernel call, booted from the carried state, against the
               plain version; (d) demo/sentiment/trainer_config.py with
               --prev_batch_state at its defaults: K3 calls booted from
               the carried states (non-zero h0, c0) against the plain
               version, the CLI pair as in phase 16 with the flag,
               --job=test of its checkpoint, and two passes ending in a
               batch of 100 rows at k = 1 and 4, bit-identical after each
               (the carried state included).
 20. rng     — the port's threefry (utils/prng.py): Random123's known
               answers on the card; 64 keys' bits, split, fold_in,
               uniform and bernoulli at [8, 32000] on the card bit for bit
               the CPU's, normal and gumbel within 2e-5 / 2e-6; 16 sampled
               requests at DECODE_MODEL's width giving the same tokens at
               k = 1, in windows of KSTEP and with speculation on (K5 once
               per layer per step at k = 1), and the kernels and µs a
               window's in-graph noise adds; the sentiment net trained
               with dropout, k = KSTEP graph groups bit-identical to k = 1
               and one step's keep-masks equal to the CPU's draws;
 21. zoo     — the 25 layer types ported last in five models (ZOO_SIZES:
               nce and hsigmoid over a 30000-word dictionary at batch 32,
               the combination layers, ctc over 200-256 frames, moe at
               width 512 over 4096 tokens, mdlstm over a 28x28 grid):
               GraphExecutor.loss and its backward on the card against
               the CPU, float32, within 1e-4, ids exact.
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


def k5_shared_case(g, *, dtype, H: int = 8, h_kv: int = 8, D: int = 64,
                   ps: int = 16, dev="cuda"):
    """Rows whose table rows map the same physical pages, as the prefix
    cache leaves them: slots 0-2 share an 8-page prefix (slot 1 beside it
    a copy of slot 0's boundary page, as copy-on-write makes it), slot 3
    maps slot 0's whole table, slot 4 chunks a 64-token suffix after the
    shared prefix; decode rows of slots 0-3, the chunk, 3 padding rows."""
    S, maxp = 5, 16
    P = 1 + 3 * maxp
    k = torch.randn(P, ps, h_kv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(P, ps, h_kv, D, generator=g, device=dev).to(dtype)
    table = torch.zeros(S + 1, maxp, dtype=torch.int32)
    shared = torch.arange(1, 9, dtype=torch.int32)          # the prefix
    own = iter(range(9, P))
    lens = [8 * ps + 40, 8 * ps + 7, 8 * ps, 8 * ps + 40, 8 * ps + 64]
    for s in (0, 1, 2, 4):
        table[s, :8] = shared
        for j in range(8, -(-lens[s] // ps)):
            table[s, j] = next(own)
    k[table[1, 8]] = k[table[0, 8]]                      # a COW'd copy
    v[table[1, 8]] = v[table[0, 8]]
    table[3] = table[0]
    slots = [0, 1, 2, 3] + [4] * 64 + [S] * 3
    lengths = lens[:4] + list(range(8 * ps + 1, 8 * ps + 65)) + [1] * 3
    q = torch.randn(len(slots), H, D, generator=g, device=dev).to(dtype)
    return (q, k, v, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(slots, dtype=torch.int32, device=dev))


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
    # rows reading shared physical pages (the prefix cache)
    for dtype, atol in K5_ATOL.items():
        for H, h_kv in ((8, 8), (8, 2)):
            err = k5_error(k5_shared_case(rng, dtype=dtype, H=H, h_kv=h_kv))
            log(f"[kernel] {str(dtype)[6:]:8s} shared pages H={H} "
                f"H_kv={h_kv}: 4 decode rows on one 8-page prefix (two on "
                f"the same table), a 64-row chunk after it: max_abs_err "
                f"{err:.3e} (atol {atol:g}) {'ok' if err <= atol else 'FAIL'}")
            if err > atol:
                raise AssertionError(f"paged_attention kernel disagrees with "
                                     f"its plain version on shared pages: "
                                     f"{err} > {atol}")
            if dtype == torch.float32:
                worst = max(worst, err)
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


def k5_serve_timings(parts: dict, smi: str, splits: int) -> dict:
    """K5 at the serving run's recorded layer-0 launches, per part (all,
    decode, mixed): the wrapper's shape plan, the split count pinned to 1,
    2, 4, 8 (`splits` of them the engine's launches), and the decode
    launches (row_slot None, as the engine passes it) with an explicit
    row_slot of arange(R), the form the kernel's first version was timed
    in; each variant K5_ROUNDS times.  Logs the median and the range of
    each, and the bound; returns {part: (median ms of the engine's
    launches, bound ms, bytes ms, flops ms)}."""
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
        mine = med[f"splits {splits}"]
        out[what] = (mine, bound_ms, bytes_ms, flops_ms)
        rows = sorted({a[0].shape[0] for a in launches_of})
        plans = sorted({(a[0].shape[0], a[3].shape[0],
                         pa.split_plan(a[0].shape[0], a[3].shape[0],
                                       a[3].shape[1], a[1].shape[1]))
                        for a in launches_of})
        log(f"[serve] kernel at the run's {len(launches_of)} layer-0 "
            f"{what} launches (rows {rows[0]}..{rows[-1]}; (rows, table "
            f"rows, (splits, tokens)) "
            + ", ".join(str(p) for p in plans)
            + f"): {mine * 1e3:.2f} us/launch at the engine's "
            f"{splits} split(s); bound "
            f"{bound_ms * 1e3:.3f} us ({bytes_ms * 1e3:.3f} bytes, "
            f"{flops_ms * 1e3:.4f} flops) = {bound_ms / mine:.1%} of "
            f"the bound [{smi}]")
        log(f"[serve]   {what}: median (min..max) of {K5_ROUNDS} rounds, "
            f"us/launch: "
            + "; ".join(f"{n} {med[n] * 1e3:.2f} ({min(t) * 1e3:.2f}.."
                        f"{max(t) * 1e3:.2f})" for n, t in runs.items()))
    return out


# depth of the serving phases' LM ([serve] through [serve-fleet] and
# [decode]): the demo config's own default (demo/model_zoo/
# transformer_lm.py, `layers` 2); its documented serving command runs 8,
# which no longer fit the script's time limit (the serving path is
# host-bound, so its time follows the layers a step runs)
SERVE_LAYERS = 2


def phase_serve(smi: str, kernel_err: float) -> dict:
    import paddle_tpu_torch.ops.attention as attn_ops
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import ServingEngine

    vocab, layers = 32000, SERVE_LAYERS
    model = transformer_lm_config(vocab=vocab, dim=512, layers=layers,
                                  heads=8)
    ex = GraphExecutor(model, compute_dtype="bfloat16")
    params = init_params(model, seed=1)
    eng = ServingEngine(ex, params, num_slots=16, page_size=16,
                        max_context=768, prefix_cache=False)
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
                  row_slot=None, splits=None):
        if splits != eng.splits:
            raise AssertionError(f"[serve] a launch with {splits} splits, "
                                 f"the engine's are {eng.splits}")
        out = wrapper(q, k_pages, v_pages, page_table, lengths, scale,
                      row_slot, splits)
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
                         max_context=768, decode_steps=KSTEP,
                         prefix_cache=False)
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
    times = k5_serve_timings(parts, smi, eng.splits)
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
            if PAD_KERNEL.search(e.name()):
                continue                    # profiled()'s pads
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


# spin kernels launched before and after every profiled run: the tracer
# has dropped a kernel record at a session's start (a replay-held check
# then failed: PERF.md §7); with the pads there, the records at a
# session's edges are theirs.  device_rows leaves them out, profiled()
# takes their launch calls off
PROFILE_PADS = (64, 1024)
PAD_KERNEL = re.compile(r"(?<!\w)spin_kernel(?!\w)")


def spin_pad(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def profiled(run):
    """run() under torch.profiler (host operators and the card's
    activity), between PROFILE_PADS spin kernels: (what it returned, wall
    ms, the device events and the host launch calls as `device_rows` sums
    them, the pads left out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spin_pad(PROFILE_PADS[0])
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        spin_pad(PROFILE_PADS[1])
    kernels, calls = device_rows(prof)
    PROFILER_SECONDS[0] += time.perf_counter() - start - wall_ms / 1e3
    return out, wall_ms, kernels, calls - sum(PROFILE_PADS)


def timed_run(run):
    """run() on the host's clock, the card synchronized before and after:
    (what it returned, wall ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def cli_run(run, k: int):
    """A CLI call at --steps_per_dispatch=k: under the profiler at k > 1
    (a replay's launches are read from its kernel events), else timed
    alone (the wrappers hold an eager run, and profiling a whole eager
    pass costs more than the call; the steady passes read the device at
    k = 1).  Returns (exit code, wall ms, the kernel events or None)."""
    if k == 1:
        rc, wall = timed_run(run)
        return rc, wall, None
    rc, wall, kernels, _ = profiled(run)
    return rc, wall, kernels


def busy_text(kernels, wall: float) -> tuple:
    """(device busy ms or None, its log text) of a cli_run."""
    if kernels is None:
        return None, "device time not profiled (k = 1)"
    busy = sum(dev_us(e) for e in kernels) / 1e3
    return busy, f"device busy {busy:.1f} ms = {busy / wall:.1%}"


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
    as they can list one launch fewer than were made (PERF.md §7), or,
    `kernels` None, the run was not profiled.  A run
    with graph replays is held by the profiler's kernel events, the record
    of what a replay launched, and the wrappers must have counted
    `wrappers` (unless None): the launches made outside a replay, eagerly
    or into a capture.  Returns a line for the log."""
    if replayed and kernels is None:
        raise ValueError(f"{what}: a run with replays is held by the "
                         f"profiler's kernel events")
    on_card = None if kernels is None else device_launches(kernels, want)
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
            f"{sum(want.values())} "
            + ("(not profiled)" if on_card is None else
               f"the profiler listed {sum(on_card.values())},")
            + f" the wrappers counted {sum(counted.values())}; plain "
            f"versions 0")


def kstep_serving(engines: dict, reqs_fn, want: dict, layers: int,
                  smi: str) -> dict:
    """The serving run's requests on the k = 1 engine and on the engine
    with decode_steps=KSTEP (its windows CUDA graphs), KSTEP_ROUNDS
    rounds, the order swapped each round: each run's tokens equal `want`
    (the k = 1 run's) and no plain version runs; tokens/s, ms/step and
    windows; in the last round a profiled run over 8 requests each:
    device ms/step, busy
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
            if r < KSTEP_ROUNDS - 1:
                log(f"[serve] decode_steps={k} round {r + 1}: "
                    f"{len(results)} requests, tokens as at k=1; {steps} "
                    f"steps ({flushes} windows of {k}, {bodies} bodies), "
                    f"{tokens} tokens in {wall:.3f}s = {tokens / wall:.1f} "
                    f"tokens/s, {wall / steps * 1e3:.2f} ms/step [{smi}]")
                continue
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
    bit-identical: parameters, optimizer slots, counters, the gradient
    accumulation window's sums, the threefry key, the model averages and
    their count, the layer state (batch norm's moving mean, variance and
    count)."""
    bad = [n for n, p in a.params.items() if not torch.equal(p, b.params[n])]
    bad += [f"{n}.{k}" for n, sl in a.opt_state["slots"].items()
            for k, v in sl.items()
            if not torch.equal(v, b.opt_state["slots"][n][k])]
    bad += [c for c in ("num_samples", "num_updates", "pass_id",
                        "grad_accum_count", "grad_accum_samples")
            if a.opt_state.get(c) != b.opt_state.get(c)]
    acc_a, acc_b = (t.opt_state.get("grad_accum", {}) for t in (a, b))
    bad += [f"grad_accum.{n}" for n, v in acc_a.items()
            if n not in acc_b or not torch.equal(v, acc_b[n])]
    if not torch.equal(a.rng, b.rng):
        bad.append("rng")
    avg_a, avg_b = a.opt_state.get("average"), b.opt_state.get("average")
    if (avg_a is None) != (avg_b is None):
        bad.append("average")
    elif avg_a is not None:
        bad += [f"average.{n}" for n, v in avg_a.items()
                if not torch.equal(v, avg_b[n])]
        if not torch.equal(a.opt_state["average_count"],
                           b.opt_state["average_count"]):
            bad.append("average_count")
    if a.net_state.keys() != b.net_state.keys():
        bad.append("net_state layers")
    mine = dict(state_leaves(b.net_state, "net"))
    bad += [n for n, v in state_leaves(a.net_state, "net")
            if n in mine and not torch.equal(v, mine[n])]
    return bad


def state_leaves(tree, prefix: str) -> list:
    """(name, tensor) of each leaf of a layer-state tree: batch norm's
    statistics by layer and statistic, a carried recurrent state
    (--prev_batch_state) by its `<layer>:h` / `<layer>:c` key."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in state_leaves(tree[k], f"{prefix}.{k}")]
    return [(prefix, tree)]


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


# the repo's prefix-skew serving workload (tools/bench_serving.py
# make_prefix_prompts as bench.py bench_serving_prefix sizes it): 64
# requests, 8 shared prefixes of 128 tokens drawn with Zipf exponent 1.0,
# unique suffixes of 16-64 tokens, 64 new tokens each
PREFIX_WORKLOAD = dict(n=64, prefix_pool=8, prefix_len=128, prefix_skew=1.0,
                       suffix_lo=16, suffix_hi=64, max_new=64)
PREFIX_PAGES = 129      # [serve-prefix] run 2: 128 real pages, overcommitted


def make_prefix_prompts(n: int, prefix_pool: int, prefix_len: int,
                        prefix_skew: float, suffix_lo: int, suffix_hi: int,
                        vocab: int, pool_seed: int = 0, seed: int = 0):
    """Prompts of the prefix-skew workload: each draws one of
    `prefix_pool` shared prefixes (rank k with probability proportional to
    1 / (k + 1)^prefix_skew; the pool seeded by `pool_seed` alone) and
    appends a unique suffix of suffix_lo..suffix_hi tokens."""
    pool_rng = np.random.default_rng(pool_seed)
    prefixes = [pool_rng.integers(2, vocab, prefix_len).astype(np.int32)
                for _ in range(prefix_pool)]
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, prefix_pool + 1, dtype=np.float64) ** prefix_skew
    w /= w.sum()
    prompts = []
    for _ in range(n):
        k = int(rng.choice(prefix_pool, p=w))
        s = int(rng.integers(suffix_lo, suffix_hi + 1))
        prompts.append(np.concatenate(
            [prefixes[k], rng.integers(2, vocab, s).astype(np.int32)]))
    return prompts


def prefix_requests(vocab: int, n: Optional[int] = None):
    """The workload's requests (the first `n`), every fourth sampled."""
    from paddle_tpu_torch.serving import Request
    w = dict(PREFIX_WORKLOAD)
    prompts = make_prefix_prompts(w.pop("n"), vocab=vocab, **{
        k: w[k] for k in ("prefix_pool", "prefix_len", "prefix_skew",
                          "suffix_lo", "suffix_hi")})
    return [Request(i, p, max_new=w["max_new"],
                    **(dict(temperature=0.8, top_k=50, top_p=0.9,
                            seed=1000 + i) if i % 4 == 0 else {}))
            for i, p in enumerate(prompts[:n])]


ENGINE_COUNTERS = ("n_decode_steps", "n_mixed_steps", "n_prefill_chunks",
                   "tokens_generated", "n_prefix_hits", "n_prefix_misses",
                   "prefill_tokens_saved", "n_preemptions", "n_cancelled",
                   "n_expired", "n_scan_flushes", "n_scan_steps")


def engine_counters(eng) -> dict:
    return {c: getattr(eng, c) for c in ENGINE_COUNTERS} | {
        "n_cow": eng.kv.n_cow}


def counter_moves(eng, before: dict) -> dict:
    return {c: v - before[c] for c, v in engine_counters(eng).items()}


def same_tokens(what: str, got: dict, want: dict) -> None:
    bad = [i for i in want if i in got and not np.array_equal(got[i],
                                                               want[i])]
    if bad or not set(got) <= set(want):
        raise AssertionError(f"{what}: tokens differ from the cache-off run "
                             f"for requests {bad[:8]}")


def check_k5_eager(what: str, layers: int, steps: int) -> int:
    """An eager run's K5 launches, counted since reset_counts(): once per
    attention layer per step, no plain version."""
    from paddle_tpu_torch.ops import paged_attention as pa
    if pa.counts.kernel != layers * steps or any(plain_calls().values()):
        raise AssertionError(f"{what}: {pa.counts.kernel} K5 launches for "
                             f"{steps} steps x {layers} layers, plain calls "
                             f"{plain_calls()}")
    return pa.counts.kernel


def prefix_run(eng, reqs, layers: int, what: str, smi: str):
    """Serve `reqs` on `eng` from a cold cache, timed; K5 held to one launch
    per layer per step and every request to its full length.  Returns
    (results, counter moves, wall s)."""
    eng.reset_prefix_cache()
    before = engine_counters(eng)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = counter_moves(eng, before)
    launches = check_k5_eager(what, layers, d["n_decode_steps"])
    want_len = {r.req_id: r.prompt_ids.size + r.max_new for r in reqs}
    if {i: t.size for i, t in res.items()} != want_len:
        raise AssertionError(f"{what}: requests missing or cut short")
    seen = d["n_prefix_hits"] + d["n_prefix_misses"]
    log(f"[serve-prefix] {what}: {len(res)} requests, "
        f"{d['n_decode_steps']} steps ({d['n_mixed_steps']} mixed, "
        f"{d['n_prefill_chunks']} chunks), {d['tokens_generated']} tokens in "
        f"{wall:.3f}s = {d['tokens_generated'] / wall:.1f} tokens/s, "
        f"{wall / d['n_decode_steps'] * 1e3:.2f} ms/step; prefix hits "
        f"{d['n_prefix_hits']} of {seen} admissions"
        + (f" ({d['n_prefix_hits'] / seen:.1%})" if seen else "")
        + f", prefill tokens saved {d['prefill_tokens_saved']}, n_cow "
        f"{d['n_cow']}, preemptions {d['n_preemptions']}; K5 launches "
        f"{launches} = {layers} x {d['n_decode_steps']}, plain 0 [{smi}]")
    return res, d, wall


def prefix_on_off(c) -> None:
    """[serve-prefix] 1: the workload with the cache on and off, two rounds
    in swapped order, from a cold cache each; then a profiled run of 8
    requests each way (the cache warm from the last round).  The first
    run's tokens become c.want, which every later run must equal."""
    engines = {on: c.engine(prefix_cache=on) for on in (True, False)}
    for eng in engines.values():            # warm-up: not counted
        eng.run(serve_requests(4, c.vocab, seed=7, lo=8, hi=80, max_new=4,
                               sampled_every=2))
    want = None
    rows = {True: [], False: []}
    for r in range(2):
        for on in ((False, True) if r == 0 else (True, False)):
            res, d, wall = prefix_run(
                engines[on], prefix_requests(c.vocab), c.layers,
                f"cache {'on' if on else 'off'} round {r + 1}", c.smi)
            if want is None:
                want = res
            same_tokens(f"[serve-prefix] cache {'on' if on else 'off'}",
                        res, want)
            rows[on].append((d, wall))
    if rows[True][0][0]["n_prefix_hits"] <= 0 or \
            rows[False][0][0]["n_prefix_hits"]:
        raise AssertionError("[serve-prefix] no prefix hit with the cache "
                             "on, or one with it off")

    def rates(on, f):
        return " / ".join(f(d, w) for d, w in rows[on])

    tok_s = lambda d, w: f"{d['tokens_generated'] / w:.1f}"  # noqa: E731
    ms = lambda d, w: f"{w / d['n_decode_steps'] * 1e3:.2f}"  # noqa: E731
    log(f"[serve-prefix] cache on against off: tokens equal request for "
        f"request in all four runs; tokens/s on {rates(True, tok_s)}, off "
        f"{rates(False, tok_s)}; ms/step on {rates(True, ms)}, off "
        f"{rates(False, ms)} [{c.smi}]")
    for on in (True, False):
        eng = engines[on]
        before = engine_counters(eng)
        reset_counts()
        out, pwall, kernels, calls = profiled(
            lambda: eng.run(prefix_requests(c.vocab, 8)))
        d = counter_moves(eng, before)
        steps = d["n_decode_steps"]
        same_tokens("[serve-prefix] profiled", out, want)
        line = check_launches(
            f"[serve-prefix] cache {'on' if on else 'off'}", kernels,
            {"paged_attention_kernel": c.layers * steps}, False)
        busy = sum(dev_us(e) for e in kernels) / 1e3
        k5 = sum(dev_us(e) for e in kernels
                 if "paged_attention" in e.key) / 1e3
        log(f"[serve-prefix] profiled 8 requests, cache "
            f"{'on' if on else 'off'} (warm): {steps} steps, prefix hits "
            f"{d['n_prefix_hits']}, n_cow {d['n_cow']}, device "
            f"{busy / steps:.2f} ms/step, busy {busy / pwall:.1%} of "
            f"{pwall:.1f} ms, K5 {k5 / max(busy, 1e-9):.1%} of the device "
            f"time, {sum(e.count for e in kernels) / steps:.0f} kernels and "
            f"{calls / steps:.1f} host launch calls a step; {line} "
            f"[{c.smi}]")
    c.eng, c.want = engines[True], want


def prefix_overcommit(c) -> None:
    """[serve-prefix] 2: the workload on a pool of PREFIX_PAGES - 1 real
    pages, half of what 16 slots of the longest request need."""
    over = c.engine(prefix_cache=True, num_pages=PREFIX_PAGES)
    res, d, _ = prefix_run(over, prefix_requests(c.vocab), c.layers,
                           f"num_pages={PREFIX_PAGES}", c.smi)
    same_tokens("[serve-prefix] overcommitted", res, c.want)
    if d["n_preemptions"] <= 0:
        raise AssertionError("[serve-prefix] the overcommitted pool never "
                             "preempted")
    over.kv.check_reclaimed()
    over.reset_prefix_cache()
    over.kv.check_reclaimed()
    log(f"[serve-prefix] overcommitted: tokens equal, "
        f"{d['n_preemptions']} preemptions replayed, check_reclaimed holds "
        f"before and after reset_prefix_cache [{c.smi}]")


def prefix_windows(c) -> None:
    """[serve-prefix] 3: the workload at decode_steps=KSTEP, cache on, its
    windows replayed from CUDA graphs (both variants captured by a
    warm-up): timed, the wrapper counting K5 once per layer per step
    outside the windows; then 8 requests profiled, K5's launches inside
    the replays read from the profiler, as kstep_serving reads them."""
    engk = c.engine(prefix_cache=True, decode_steps=KSTEP)
    engk.run(serve_requests(4, c.vocab, seed=7, lo=8, hi=80, max_new=12,
                            sampled_every=2))
    engk.run(serve_requests(2, c.vocab, seed=8, lo=8, hi=80, max_new=12))
    engk.reset_prefix_cache()
    before = engine_counters(engk)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engk.run(prefix_requests(c.vocab))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = counter_moves(engk, before)
    same_tokens(f"[serve-prefix] decode_steps={KSTEP}", res, c.want)
    check_k5_eager(f"[serve-prefix] decode_steps={KSTEP}, outside the "
                   f"windows", c.layers,
                   d["n_decode_steps"] - d["n_scan_flushes"])
    before = engine_counters(engk)
    reset_counts()
    out, pwall, kernels, calls = profiled(
        lambda: engk.run(prefix_requests(c.vocab, 8)))
    p = counter_moves(engk, before)
    same_tokens(f"[serve-prefix] decode_steps={KSTEP} profiled", out,
                c.want)
    eager = p["n_decode_steps"] - p["n_scan_flushes"]
    line = check_launches(
        f"[serve-prefix] decode_steps={KSTEP}", kernels,
        {"paged_attention_kernel": c.layers * (eager + p["n_scan_steps"])},
        True, {"paged_attention_kernel": c.layers * eager})
    replays = sum(g.replays for g in engk._windows[KSTEP].graphs.values()
                  if g is not None)
    busy = sum(dev_us(e) for e in kernels) / 1e3
    log(f"[serve-prefix] decode_steps={KSTEP}, cache on: tokens equal; "
        f"{d['n_decode_steps']} steps ({d['n_scan_flushes']} windows), "
        f"{d['tokens_generated'] / wall:.1f} tokens/s, "
        f"{wall / d['n_decode_steps'] * 1e3:.2f} ms/step, prefix hits "
        f"{d['n_prefix_hits']}; profiled 8 requests (cache warm): "
        f"{p['n_decode_steps']} steps ({p['n_scan_flushes']} windows), "
        f"device {busy / p['n_decode_steps']:.2f} ms/step, busy "
        f"{busy / pwall:.1%}, {calls / p['n_decode_steps']:.1f} host launch "
        f"calls a step; window graphs replayed {replays} times; {line} "
        f"[{c.smi}]")
    if replays < 1:
        raise AssertionError("[serve-prefix] no window replayed")


PREFIX_CANCEL = (5, 6, 50)      # cancelled at step 30
PREFIX_DEADLINE = 60.0          # for every eighth request from the fourth


def prefix_cancel(c) -> None:
    """[serve-prefix] 4: cancels and deadlines mid-flight on the clock
    lambda: steps since the run began, cache on: the survivors' tokens
    equal the uninterrupted run's, an ended request's are a prefix of
    its uninterrupted run's."""
    eng = c.eng
    eng.reset_prefix_cache()
    base = eng.n_decode_steps
    eng.clock = lambda: eng.n_decode_steps - base
    reqs = prefix_requests(c.vocab)
    for r in reqs[3::8]:
        r.deadline = PREFIX_DEADLINE
    before = engine_counters(eng)
    reset_counts()
    for r in reqs:
        eng.add_request(r)
    while eng.step():
        if eng.n_decode_steps - base == 30:
            for i in PREFIX_CANCEL:
                if not eng.cancel(i):
                    raise AssertionError(f"[serve-prefix] cancel({i}): "
                                         f"unknown or finished")
    eng.clock = time.monotonic
    d = counter_moves(eng, before)
    check_k5_eager("[serve-prefix] cancel and deadlines", c.layers,
                   d["n_decode_steps"])
    res, why = eng.results, eng.finish_reasons
    for i, toks in res.items():
        if not np.array_equal(toks, c.want[i][:toks.size]) or (
                why[i] == "length" and toks.size != c.want[i].size):
            raise AssertionError(f"[serve-prefix] request {i} ({why[i]}) "
                                 f"is not its uninterrupted run's prefix")
    cancelled = sorted(i for i, w in why.items() if w == "cancelled")
    expired = sorted(i for i, w in why.items() if w == "deadline")
    if (cancelled != list(PREFIX_CANCEL) or not expired
            or (d["n_cancelled"], d["n_expired"]) != (len(cancelled),
                                                      len(expired))
            or len(res) != len(reqs)):
        raise AssertionError(f"[serve-prefix] cancel/deadline accounting: "
                             f"{why}, counters {d}")
    eng.kv.check_reclaimed()
    log(f"[serve-prefix] cancel and deadlines: {len(cancelled)} cancelled "
        f"at step 30, {len(expired)} of {len(reqs[3::8])} with deadline "
        f"{PREFIX_DEADLINE:g} expired; the others' tokens equal the "
        f"uninterrupted run, the ended ones' a prefix of it; "
        f"{d['n_decode_steps']} steps [{c.smi}]")
    eng.results.clear()
    eng.finish_reasons.clear()


def mid_flight(eng) -> bool:
    """A slot decoding, a slot part way through its prompt, a request
    queued."""
    live = [sl for sl in eng.slots if sl is not None]
    return (bool(eng.queue) and any(sl.gen >= 1 for sl in live)
            and any(sl.gen == 0 and 0 < sl.pos < sl.req.prompt_ids.size
                    for sl in live))


def prefix_checkpoint(c) -> None:
    """[serve-prefix] 5: checkpoint_state mid-flight (timed: the pools
    copied to the host), save_state to a file and load_state onto a fresh
    engine (each timed), which finishes with the uninterrupted tokens."""
    import tempfile

    eng = c.eng
    eng.reset_prefix_cache()
    for r in prefix_requests(c.vocab):
        eng.add_request(r)
    while not mid_flight(eng):
        if not eng.step():
            raise AssertionError("[serve-prefix] never reached a mid-flight "
                                 "state to checkpoint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = eng.checkpoint_state()
    ckpt_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "engine.pkl")
        t0 = time.perf_counter()
        eng.save_state(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        res_a = eng.run()
        fresh = c.engine(prefix_cache=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_state(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    before = engine_counters(fresh)
    reset_counts()
    res_b = fresh.run()
    d = counter_moves(fresh, before)
    check_k5_eager("[serve-prefix] restored", c.layers, d["n_decode_steps"])
    done = dict(snap["results"])
    same_tokens("[serve-prefix] uninterrupted", res_a, c.want)
    same_tokens("[serve-prefix] restored", res_b | done, c.want)
    if sorted(res_b | done) != sorted(c.want) or \
            sorted(res_a) != sorted(res_b):
        raise AssertionError("[serve-prefix] the restored engine did not "
                             "finish every request")
    fresh.kv.check_reclaimed()
    slots = [x for x in snap["slots"] if x is not None]
    log(f"[serve-prefix] checkpoint with {len(slots)} slots live "
        f"({sum(x['gen'] == 0 for x in slots)} mid-prompt) and "
        f"{len(snap['queue'])} queued: checkpoint_state "
        f"{ckpt_s * 1e3:.1f} ms (pools {fresh.kv.pool_bytes / 1e6:.1f} MB "
        f"to the host), save_state {save_s * 1e3:.1f} ms "
        f"({size / 1e6:.1f} MB file), load_state {load_s * 1e3:.1f} ms; the "
        f"fresh engine finished {len(res_b)} requests with the "
        f"uninterrupted tokens [{c.smi}]")


def phase_serve_prefix(smi: str) -> None:
    """The reference engine's default serving on the card (module
    docstring, phase 4b): the prefix-skew workload at [serve]'s width,
    (1) cache on against off, (2) an overcommitted pool, (3) windows,
    (4) cancels and deadlines, (5) a checkpoint restored mid-flight."""
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import ServingEngine

    vocab, layers = 32000, SERVE_LAYERS
    model = transformer_lm_config(vocab=vocab, dim=512, layers=layers,
                                  heads=8)
    ex = GraphExecutor(model, compute_dtype="bfloat16")
    params = init_params(model, seed=1)

    def engine(**kw):
        return ServingEngine(ex, params, num_slots=16, page_size=16,
                             max_context=768, **kw)

    # eng: the cache-on engine of (1), reused by (4) and (5); want: (1)'s
    # tokens
    c = types.SimpleNamespace(vocab=vocab, layers=layers, smi=smi,
                              engine=engine, eng=None, want=None)
    for n, fn in enumerate((prefix_on_off, prefix_overcommit, prefix_windows,
                            prefix_cancel, prefix_checkpoint), 1):
        start = time.perf_counter()
        fn(c)
        log(f"[serve-prefix] ({n}) {fn.__name__}: "
            f"{time.perf_counter() - start:.1f} s [{smi}]")
        torch.cuda.empty_cache()


# the repo's speculative-decode workload (tools/bench_serving.py
# make_repetitive_requests at bench.py bench_serving_spec's sizes): 64
# requests whose prompts of 32-256 tokens tile a random motif of 4-12
# tokens, 64 new tokens each, eos off, greedy; depth 4 over a budget
# pinned to one chunk plus a full chain per slot (measure_spec's pin)
SPEC_WORKLOAD = dict(n=64, prompt_lo=32, prompt_hi=256, max_new=64)
SPEC_K = 4
SPEC_BUDGET = 64 + 16 * (SPEC_K + 1)
# requests of the arms where the target drafts for itself (its k draft
# forwards a pass make them the phase's slowest), and of (4) "auto"'s
# profiled pass (~3,600 kernels a step at 8 layers for the profiler to
# sum); 8 and 2 since [train-jobs] joined the script (16 and 4 before)
SPEC_MODEL_REQUESTS = 8
SPEC_MODEL_PROFILED = 2
SPEC_COUNTERS = ("n_spec_steps", "n_spec_chains", "n_spec_drafted",
                 "n_spec_accepted", "n_spec_tokens", "n_draft_steps")


def make_repetitive_requests(n: int, prompt_lo: int, prompt_hi: int,
                             max_new: int, vocab: int, seed: int = 0,
                             motif_lo: int = 4, motif_hi: int = 12,
                             sampled_every: int = 0):
    """Locally repetitive prompts: each tiles a random motif of
    motif_lo..motif_hi tokens to prompt_lo..prompt_hi tokens; eos off;
    every `sampled_every`-th request (from the first) samples with
    [serve-prefix]'s knobs, the others are greedy."""
    from paddle_tpu_torch.serving import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        m = int(rng.integers(motif_lo, motif_hi + 1))
        p = int(rng.integers(prompt_lo, prompt_hi + 1))
        motif = rng.integers(2, vocab, m).astype(np.int32)
        kw = {}
        if sampled_every and i % sampled_every == 0:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1000 + i)
        reqs.append(Request(f"s{seed}_{i}", np.tile(motif, -(-p // m))[:p],
                            max_new=max_new, **kw))
    return reqs


def spec_counters(eng) -> dict:
    return engine_counters(eng) | {c: getattr(eng, c) for c in SPEC_COUNTERS}


def spec_moves(eng, before: dict) -> dict:
    return {c: v - before[c] for c, v in spec_counters(eng).items()}


class SpecProbe:
    """Measurement on one [serve-spec] engine, outside the port: the
    wrapper's K5 launches inside verify steps, each draft pass that
    proposed timed, and, while `armed`, layer 0's K5 arguments in the first
    verify step with drafts (for the comparison with the plain version)."""

    def __init__(self, eng):
        from paddle_tpu_torch.ops import paged_attention as pa
        self.eng, self.verify_launches, self.draft_s = eng, 0, []
        self.armed, self.capture, self.recorded = False, False, None
        run_spec, propose = eng._run_spec_step, eng._propose_drafts

        def spec_step(*args):              # (live, runnable, filling, drafts)
            k0 = pa.counts.kernel
            self.capture = self.armed and bool(args[-1]) and \
                self.recorded is None
            try:
                run_spec(*args)
            finally:
                self.capture = False
            self.verify_launches += pa.counts.kernel - k0

        def timed(runnable):
            t0 = time.perf_counter()
            out = propose(runnable)
            if out:
                self.draft_s.append(time.perf_counter() - t0)
            return out

        eng._run_spec_step, eng._propose_drafts = spec_step, timed

    @contextlib.contextmanager
    def recording(self, layer0: str):
        """Arm the recording of layer `layer0`'s launch in a verify step."""
        import paddle_tpu_torch.ops.attention as attn_ops
        wrapper = attn_ops.pa.paged_attention

        def record(q, k_pages, v_pages, page_table, lengths, scale=None,
                   row_slot=None, splits=None):
            if self.capture and k_pages is self.eng.kv.pools[layer0]["k"]:
                self.recorded = (q.clone(), k_pages.clone(), v_pages.clone(),
                                 page_table.clone(), lengths.clone(),
                                 row_slot.clone())
                self.capture = False
            return wrapper(q, k_pages, v_pages, page_table, lengths, scale,
                           row_slot, splits)

        attn_ops.pa.paged_attention, self.armed = record, True
        try:
            yield
        finally:
            attn_ops.pa.paged_attention, self.armed = wrapper, False


def spec_run(c, eng, reqs, what: str, want: Optional[dict]):
    """Serve `reqs` on `eng` from a cold prefix cache, timed: every request
    runs to its full length, its tokens equal `want`'s (when given), K5
    launches once per attention layer per eager step (verify steps
    included: counted inside them too), no plain version, and with eos
    off every chain banks its accepted drafts and one sampled token.
    Logs the arm's numbers; returns (results, counter moves)."""
    probe = c.probes[id(eng)]
    eng.reset_prefix_cache()
    before = spec_counters(eng)
    v0, n0 = probe.verify_launches, len(probe.draft_s)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = spec_moves(eng, before)
    eager = d["n_decode_steps"] - d["n_scan_flushes"]
    launches = check_k5_eager(f"[serve-spec] {what}", c.layers, eager)
    verify = probe.verify_launches - v0
    draft = probe.draft_s[n0:]
    if verify != c.layers * d["n_spec_steps"]:
        raise AssertionError(f"[serve-spec] {what}: {verify} K5 launches in "
                             f"{d['n_spec_steps']} verify steps")
    if {r.req_id: r.prompt_ids.size + r.max_new for r in reqs} != \
            {i: t.size for i, t in res.items()}:
        raise AssertionError(f"[serve-spec] {what}: requests missing or "
                             f"cut short")
    if d["n_spec_tokens"] != d["n_spec_accepted"] + d["n_spec_chains"]:
        raise AssertionError(f"[serve-spec] {what}: spec tokens "
                             f"{d['n_spec_tokens']} != accepted + chains")
    if want is not None:
        same_tokens(f"[serve-spec] {what}", res, want)
    rate = d["n_spec_accepted"] / max(d["n_spec_drafted"], 1)
    log(f"[serve-spec] {what}: {len(res)} requests"
        + (", tokens equal spec off's" if want is not None else "")
        + f"; {d['n_decode_steps']} steps ({d['n_spec_steps']} verify, "
        f"{d['n_mixed_steps']} mixed, {d['n_scan_flushes']} windows), "
        f"{d['tokens_generated']} tokens in {wall:.3f}s = "
        f"{d['tokens_generated'] / wall:.1f} tokens/s, "
        f"{wall / d['n_decode_steps'] * 1e3:.2f} ms/step; accept rate "
        f"{rate:.4f}: drafted {d['n_spec_drafted']}, accepted "
        f"{d['n_spec_accepted']}, chains {d['n_spec_chains']}, spec tokens "
        f"{d['n_spec_tokens']} = accepted + chains; {len(draft)} draft "
        f"passes, "
        + (f"{np.mean(draft) * 1e3:.3f} ms a pass" if draft else "none")
        + f"; K5 launches {launches} = {c.layers} x {eager} eager steps, "
        f"{verify} of them in the verify steps, plain 0; preemptions "
        f"{d['n_preemptions']} [{c.smi}]")
    return res, d


def spec_profile(c, eng, reqs, what: str, want: dict) -> None:
    """`reqs` once more under the profiler, from a cold cache: device
    ms/step, busy share, kernels and host launch calls a step; K5 launched
    on the card once per layer per forward (window bodies included), the
    wrapper counting the eager ones."""
    eng.reset_prefix_cache()
    before = spec_counters(eng)
    reset_counts()
    out, pwall, kernels, calls = profiled(lambda: eng.run(reqs))
    p = spec_moves(eng, before)
    same_tokens(f"[serve-spec] {what} profiled", out, want)
    steps = p["n_decode_steps"]
    eager = steps - p["n_scan_flushes"]
    sym = "paged_attention_kernel"
    line = check_launches(f"[serve-spec] {what}", kernels,
                          {sym: c.layers * (eager + p["n_scan_steps"])},
                          p["n_scan_flushes"] > 0, {sym: c.layers * eager})
    busy = sum(dev_us(e) for e in kernels) / 1e3
    log(f"[serve-spec] {what}, profiled {len(reqs)} requests: {steps} steps "
        f"({p['n_spec_steps']} verify, {p['n_scan_flushes']} windows), "
        f"device {busy / steps:.2f} ms/step, busy {busy / pwall:.1%} of "
        f"{pwall:.1f} ms, {sum(e.count for e in kernels) / steps:.0f} "
        f"kernels and {calls / steps:.1f} host launch calls a step; {line} "
        f"[{c.smi}]")


def spec_requests(c, sampled: int = 0, n: Optional[int] = None) -> list:
    """The workload's requests (the first `n`)."""
    return make_repetitive_requests(vocab=c.vocab, seed=1,
                                    sampled_every=sampled,
                                    **SPEC_WORKLOAD)[:n]


def spec_arm(c, eng, what: str, want: Optional[dict], sampled: int = 0,
             n: Optional[int] = None, profiled_n: int = 8):
    """One arm: the workload (its first `n` requests) timed, then
    `profiled_n` of its requests profiled (none at 0)."""
    res, d = spec_run(c, eng, spec_requests(c, sampled, n), what, want)
    if profiled_n:
        spec_profile(c, eng, spec_requests(c, sampled)[:profiled_n], what,
                     res)
    return res, d


def spec_k5(c, probe) -> None:
    """K5 against its plain version on the recorded verify step's rows."""
    from paddle_tpu_torch.ops import paged_attention as pa
    if probe.recorded is None:
        raise AssertionError("[serve-spec] no verify step with drafts was "
                             "recorded")
    q, _, _, _, lengths, row_slot = probe.recorded
    err = k5_error(probe.recorded, splits=probe.eng.splits)
    real = int((row_slot < len(probe.eng.slots)).sum())
    log(f"[serve-spec] K5 on a verify step's layer-0 rows ({q.shape[0]} "
        f"rows, {real} real, lengths up to {int(lengths.max())}, the "
        f"engine's {probe.eng.splits} split(s)) against its plain version "
        f"in float32: max abs err {err:.3e} (limit "
        f"{K5_ATOL[torch.bfloat16]:g}); plain calls {pa.counts.plain} "
        f"[{c.smi}]")
    if not err <= K5_ATOL[torch.bfloat16]:
        raise AssertionError(f"[serve-spec] K5 on a verify step: {err}")


def spec_checkpoint(c, eng) -> None:
    """checkpoint_state mid-flight with speculation on; a fresh engine
    restored from it finishes with spec off's tokens."""
    for r in spec_requests(c):
        eng.add_request(r)
    while not mid_flight(eng):
        if not eng.step():
            raise AssertionError("[serve-spec] never reached a mid-flight "
                                 "state to checkpoint")
    snap = eng.checkpoint_state()
    res_a = eng.run()
    fresh = c.engine(spec_k=SPEC_K)
    fresh.restore_state(snap)
    before = spec_counters(fresh)
    reset_counts()
    res_b = fresh.run()
    d = spec_moves(fresh, before)
    check_k5_eager("[serve-spec] restored", c.layers, d["n_decode_steps"])
    done = dict(snap["results"])
    same_tokens("[serve-spec] uninterrupted", res_a, c.want)
    same_tokens("[serve-spec] restored", res_b | done, c.want)
    if sorted(res_b | done) != sorted(c.want):
        raise AssertionError("[serve-spec] the restored engine did not "
                             "finish every request")
    fresh.kv.check_reclaimed()
    slots = [x for x in snap["slots"] if x is not None]
    log(f"[serve-spec] checkpoint with speculation on, {len(slots)} slots "
        f"live ({sum(x['gen'] == 0 for x in slots)} mid-prompt), "
        f"{len(snap['queue'])} queued: the fresh engine finished "
        f"{len(res_b)} requests with spec off's tokens in "
        f"{d['n_decode_steps']} steps ({d['n_spec_steps']} verify) "
        f"[{c.smi}]")


def phase_serve_spec(smi: str) -> None:
    """Speculative decode on the card (module docstring, phase 4c): the
    repetitive workload at [serve]'s width on one engine with the budget
    pinned to SPEC_BUDGET, (1) spec off, then spec_k=SPEC_K with the
    n-gram drafter (K5 held on a verify step's rows), both again in the
    other order; on an engine with the defaulted budget, spec off and on;
    (2) the target as its own model drafter, (3) dynamic depth, (4) the
    model drafter at dynamic depth with decode_steps=KSTEP under
    decode_mode "auto" (windows where no slot drafts) and "static" (none),
    (5) every fourth request sampled, spec off and on, (6) an
    overcommitted pool, (7) a checkpoint mid-flight restored on a fresh
    engine.  Every arm's tokens equal spec off's."""
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import (ModelDrafter, NgramDrafter,
                                          ServingEngine)

    vocab, layers = 32000, SERVE_LAYERS
    model = transformer_lm_config(vocab=vocab, dim=512, layers=layers,
                                  heads=8)
    ex = GraphExecutor(model, compute_dtype="bfloat16")
    params = init_params(model, seed=1)
    c = types.SimpleNamespace(vocab=vocab, layers=layers, smi=smi, want=None,
                              probes={})

    def engine(budget: Optional[int] = SPEC_BUDGET, **kw):
        eng = ServingEngine(ex, params, num_slots=16, page_size=16,
                            max_context=768, max_step_tokens=budget, **kw)
        c.probes[id(eng)] = SpecProbe(eng)
        return eng

    c.engine = engine
    eng = engine()
    assert (eng.prefill_chunk, eng.max_step_tokens) == (64, SPEC_BUDGET)
    for k in (0, SPEC_K, 0):                # warm-up: not counted
        eng.set_speculation(k)
        eng.run(make_repetitive_requests(n=4, prompt_lo=8, prompt_hi=80,
                                         max_new=8, vocab=vocab, seed=0))
    start = time.perf_counter()
    c.want, _ = spec_arm(c, eng, "(1) spec off", None)
    ngram = NgramDrafter()
    eng.set_speculation(SPEC_K, ngram)
    probe = c.probes[id(eng)]
    with probe.recording(model.layers[3].name):
        spec_arm(c, eng, f"(1) spec_k={SPEC_K}, n-gram drafter", c.want)
    spec_k5(c, probe)
    dflt = engine(budget=None)
    spec_run(c, dflt, spec_requests(c), f"(1) defaulted budget "
             f"{dflt.max_step_tokens}, spec off", c.want)
    dflt.set_speculation(SPEC_K)
    assert (dflt.max_step_tokens, dflt.splits) == (SPEC_BUDGET, eng.splits)
    spec_run(c, dflt, spec_requests(c), f"(1) defaulted budget "
             f"{dflt.max_step_tokens}, spec_k={SPEC_K}", c.want)
    del dflt
    model_drafter = ModelDrafter.from_target(ex, params, window=64)
    eng.set_speculation(SPEC_K, model_drafter)
    spec_arm(c, eng, f"(2) spec_k={SPEC_K}, the target drafting over 64 "
             f"tokens, {SPEC_MODEL_REQUESTS} requests", c.want,
             n=SPEC_MODEL_REQUESTS, profiled_n=0)
    eng.set_speculation(SPEC_K, ngram, dynamic=True)
    spec_arm(c, eng, f"(3) spec_k={SPEC_K}, n-gram, dynamic depth", c.want,
             profiled_n=0)
    # a window's first run is eager and its second captured: both before
    # the timed runs (greedy requests, the all-greedy variant)
    eng.set_speculation(0)
    eng.set_decode_steps(KSTEP)
    eng.run(make_repetitive_requests(n=2, prompt_lo=8, prompt_hi=80,
                                     max_new=12, vocab=vocab, seed=0))
    eng.set_speculation(SPEC_K, model_drafter, dynamic=True)
    for mode in ("auto", "static"):
        eng.set_decode_mode(mode)
        _, d = spec_arm(c, eng, f"(4) spec_k={SPEC_K}, the target drafting, "
                        f"dynamic depth, decode_steps={KSTEP}, decode_mode "
                        f"{mode}, {SPEC_MODEL_REQUESTS} requests", c.want,
                        n=SPEC_MODEL_REQUESTS,
                        profiled_n=SPEC_MODEL_PROFILED if mode == "auto"
                        else 0)
        if (d["n_scan_flushes"] > 0) != (mode == "auto"):
            raise AssertionError(f"[serve-spec] decode_mode {mode}: "
                                 f"{d['n_scan_flushes']} windows")
    eng.set_decode_steps(1)
    eng.set_decode_mode("auto")
    eng.set_speculation(0, ngram, dynamic=False)
    want_s, _ = spec_arm(c, eng, "(5) every fourth sampled, spec off", None,
                         sampled=4, profiled_n=0)
    eng.set_speculation(SPEC_K)
    spec_arm(c, eng, f"(5) every fourth sampled, spec_k={SPEC_K}", want_s,
             sampled=4, profiled_n=0)
    over = engine(num_pages=PREFIX_PAGES, spec_k=SPEC_K)
    _, d = spec_arm(c, over, f"(6) spec_k={SPEC_K} on {PREFIX_PAGES - 1} "
                    f"real pages", c.want, profiled_n=0)
    over.kv.check_reclaimed()
    if d["n_preemptions"] <= 0:
        raise AssertionError("[serve-spec] the overcommitted pool never "
                             "preempted")
    del over
    spec_checkpoint(c, eng)
    log(f"[serve-spec] all arms: {time.perf_counter() - start:.1f} s "
        f"[{smi}]")


# tools/bench_lm.py's decode defaults: batch 32, 64 new tokens; the
# contexts of its sweep (prompt = context - 64); reps after one warm call
DECODE_MODEL = dict(vocab=32000, dim=512, layers=SERVE_LAYERS, heads=8)
DECODE_B, DECODE_NEW = 32, 64
DECODE_CONTEXTS = (512, 1024, 4096)
DECODE_REFORWARD = (512, 1024)      # bench_lm skips re-forward above 2048
DECODE_RAGGED = (2049, 4032)        # the ragged call's prompt lengths
DECODE_FP32 = 1024                  # the float32 arm's context
DECODE_BEAM = (8, 4, 448)           # batch, beam, prompt
DECODE_REPS = 2
DECODE_PROFILE_NEW = 8              # new tokens of an arm's profiled call
# a greedy token's teacher-forced score: (max p - p[token]) / max p at its
# position of a whole-sequence forward over the run's tokens, at most this
# (decided before the first run: bf16 rounds p and the activations at
# 2^-8, a few roundings deep; float32 sums in another order only)
GREEDY_MARGIN = {torch.bfloat16: 0.05, torch.float32: 1e-4}
# bench.py bench_serving_chunked's heavy-tail workload (64 requests,
# prompts 32..703, 64 new tokens, 16 slots, pages of 16, context 768), and
# 8 requests at context 4096 whose prompt body sits at 2048 tokens, so
# whole-prompt buckets of 2048 and more run K4
HEAVY = dict(n=64, prompt_lo=32, prompt_hi=703, max_new=64)
HEAVY_LONG = dict(n=8, prompt_lo=2048, prompt_hi=4031, max_new=64)
LONG_CONTEXT = 4096
HEAVY_SUBSET = 24       # requests of the windows / spec / checkpoint runs
HEAVY_PROFILED = 4      # requests of the heavy-tail profiled pass


def make_heavytail_requests(n: int, prompt_lo: int, prompt_hi: int,
                            max_new: int, vocab: int, seed: int = 0,
                            eos_id: int = -1, tail_frac: float = 0.1):
    """tools/bench_serving.py's heavy-tail workload: most prompts drawn
    lognormal around prompt_lo, `tail_frac` of them from a Pareto tail
    reaching prompt_hi; lengths clipped to [2, prompt_hi]; greedy."""
    from paddle_tpu_torch.serving import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if rng.random() < tail_frac:
            p = prompt_lo * (1.0 + rng.pareto(1.1))
        else:
            p = rng.lognormal(np.log(max(prompt_lo, 2)), 0.5)
        p = int(np.clip(p, 2, prompt_hi))
        prompt = rng.integers(2, vocab, p).astype(np.int32)
        reqs.append(Request(f"h{seed}_{i}", prompt, max_new=max_new,
                            eos_id=eos_id))
    return reqs


def greedy_margin(ex, params, toks, start, stop) -> float:
    """The worst teacher-forced margin of a greedy run's tokens: one
    whole-sequence forward of `toks` [B, T] (row b valid to stop[b]); for
    each generated token (positions start[b]..stop[b] - 1) the share
    (max p - p[token]) / max p of the probabilities at the position before
    it (GREEDY_MARGIN)."""
    from paddle_tpu_torch.parameter import Argument
    dev = toks.device
    stop = torch.as_tensor(stop, device=dev).to(torch.int32)
    start = torch.as_tensor(start, device=dev).long()
    out, _, _ = ex.forward(params, {"tokens": Argument(
        ids=toks.long(), lengths=stop)})
    p = out["lm_head"].value[:, :-1]                     # [B, T-1, V]
    pmax = p.amax(dim=-1).float()
    ptok = torch.gather(p, 2, toks[:, 1:].long()[..., None])[..., 0].float()
    t = torch.arange(p.shape[1], device=dev)[None]
    gen = (t >= start[:, None] - 1) & (t < stop.long()[:, None] - 1)
    share = torch.where(gen, (pmax - ptok) / pmax, torch.zeros((), device=dev))
    del out, p
    return float(share.max())


def prefill_flash_check(args, kw, what: str, smi: str) -> float:
    """K4's forward on a cached prefill's recorded inputs against its plain
    version in float32 (four batch rows at a time: the plain version
    holds [rows, H, T, T] scores): o per element within [flash]'s limit of
    q's dtype, lse within 2e-5 where finite.  Returns the max abs error of
    o."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v = args
    kvm = kw["k_valid"]
    mask = dict(causal=bool(kw.get("causal", False)), window=kw.get("window"))
    o, lse = fa.flash_attention_fwd(q, k, v, kvm, **mask)
    errs, shares, lse_err = [], [], 0.0
    for b in range(0, q.shape[0], 4):
        sl = slice(b, b + 4)
        want_o, want_lse = fa.flash_attention_plain(
            q[sl].float(), k[sl].float(), v[sl].float(), kvm[sl], **mask)
        errs.append(float((o[sl].float() - want_o).abs().max()))
        shares.append(o_limit_share(o[sl], want_o, q.dtype))
        fin = torch.isfinite(want_lse)
        if not torch.equal(torch.isfinite(lse[sl]), fin):
            raise AssertionError(f"[decode] {what}: K4's lse is finite "
                                 f"where the plain version's is not")
        lse_err = max(lse_err, float((lse[sl][fin] - want_lse[fin])
                                     .abs().max()))
        del want_o, want_lse
    rtol, atol = O_LIMIT[q.dtype]
    n = kvm.sum(dim=1)
    log(f"[decode] {what}: K4 at the path's recorded {list(q.shape)} "
        f"{str(q.dtype)[6:]} causal={mask['causal']} window="
        f"{mask['window']} (valid keys {int(n.min())}..{int(n.max())}) "
        f"against its plain version: o {max(errs):.2e} = "
        f"{max(shares):.3f} of its limit ({rtol:g}|ref| + {atol:g}), lse "
        f"{lse_err:.2e} (2e-05) [{smi}]")
    if not (max(shares) <= 1 and lse_err <= 2e-5):
        raise AssertionError(f"[decode] {what}: K4 disagrees with its plain "
                             f"version on the path's inputs")
    return max(errs)


def flash_held(calls: dict, what: str, smi: str) -> list:
    """prefill_flash_check on each recorded flash_attention signature;
    the flash wrapper must have been called."""
    errs = [prefill_flash_check(args, kw, what, smi)
            for (attr, _, _), (args, kw) in calls.items()
            if attr == "flash_attention"]
    if not errs:
        raise AssertionError(f"[decode] {what}: no flash call recorded")
    return errs


def decode_launches(what: str, want_k4: int) -> str:
    """The counts since reset_counts(): K4's bf16 / fp32 forward as the
    path says, nothing else of flash attention, K5 never, no plain
    version."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    got = (fa.counts.fwd_tc + fa.counts.fwd, pa.counts.kernel)
    other = (fa.counts.bwd_dq_tc + fa.counts.bwd_dkv_tc + fa.counts.bwd_dq
             + fa.counts.bwd_dkv)
    if got != (want_k4, 0) or other or any(plain_calls().values()):
        raise AssertionError(f"[decode] {what}: K4 forward / K5 launches "
                             f"{got}, want ({want_k4}, 0); backward "
                             f"{other}; plain calls {plain_calls()}")
    return f"K4 forward launches {want_k4}, K5 0, plain versions 0"


def profiled_line(kernels, pwall: float, steps: int) -> str:
    busy = sum(dev_us(e) for e in kernels) / 1e3
    on_card = device_launches(kernels, ("flash_fwd_tc_kernel",
                                        "flash_fwd_kernel",
                                        "paged_attention_kernel"))
    return (f"device {busy:.1f} ms = {busy / steps:.3f} ms/step, busy "
            f"{busy / pwall:.1%} of {pwall:.1f} ms, "
            f"{sum(e.count for e in kernels) / steps:.0f} kernels a step; "
            f"on the card K4 {on_card['flash_fwd_tc_kernel']} (bf16) + "
            f"{on_card['flash_fwd_kernel']} (fp32), K5 "
            f"{on_card['paged_attention_kernel']}")


def decode_arm(c, ex, ids, lens, what: str, use_cache: bool,
               k4_per_call: int, limit_dtype, reps: int = DECODE_REPS,
               warm: bool = True):
    """lm_generate timed as tools/bench_lm.py's time_decode times it (one
    warm call unless `warm` is False, then `reps`; decode tokens/s = B *
    max_new / median), the launches held over all those calls, one
    profiled call of DECODE_PROFILE_NEW new tokens (the prefill and the
    first steps: its events are what the profiler has to sum), and the
    run's tokens held by the teacher-forced margin.  Returns the
    tokens."""
    from paddle_tpu_torch.graph.lm_decode import lm_generate

    def run(max_new: int = DECODE_NEW):
        return lm_generate(ex, c.params, ids, prompt_lengths=lens,
                           max_new=max_new, use_cache=use_cache)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    if warm:
        run()[0].cpu()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        toks, out_lens = run()
        toks.cpu()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line = decode_launches(what, k4_per_call * (reps + warm))
    reset_counts()
    steps = DECODE_PROFILE_NEW      # forwards of the call, in either mode
    _, pwall, kernels, _ = profiled(lambda: run(steps))
    decode_launches(what + " profiled", k4_per_call)
    B, P = ids.shape
    start = torch.as_tensor(P if lens is None else lens)
    start = start.expand(B) if start.dim() == 0 else start
    margin = greedy_margin(ex, c.params, toks, start, out_lens)
    lim = GREEDY_MARGIN[limit_dtype]
    med = float(np.median(times))
    log(f"[decode] {what}: B {B}, prompt {P}"
        + ("" if lens is None else f" (ragged {int(min(lens))}.."
           f"{int(max(lens))})")
        + f", {DECODE_NEW} new: {B * DECODE_NEW / med:.1f} decode tokens/s "
        f"(median of {reps}{'' if warm else ', no warm call'}: "
        f"{', '.join(f'{t:.3f}' for t in times)} s a call, {DECODE_NEW} "
        f"forwards each); {line}; peak device memory {peak:.1f} GiB; "
        f"profiled call of {steps} new tokens: "
        f"{profiled_line(kernels, pwall, steps)}; teacher-forced margin "
        f"{margin:.2e} (limit {lim:g}) [{c.smi}]")
    if not margin <= lim:
        raise AssertionError(f"[decode] {what}: a greedy token is "
                             f"{margin:.3g} below its position's best "
                             f"teacher-forced score (limit {lim:g})")
    return toks, out_lens


def heavy_engine(c, chunk, context: int = 768, **kw):
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(c.ex, c.params, num_slots=16, page_size=16,
                        max_context=context, prefill_chunk=chunk, **kw)
    eng.buckets = []
    prefill = eng._prefill_prompt

    def recorded(prompt, Lb):      # measurement: the cold prefills' buckets
        eng.buckets.append(Lb)
        return prefill(prompt, Lb)
    eng._prefill_prompt = recorded
    return eng


def heavy_run(c, eng, reqs, what: str, want=None):
    """Serve `reqs` from a cold cache, timed, with each request's
    first-token latency (on_token, from the run's start; all requests
    queued at once): every request to its full length, its tokens equal
    `want`'s where given, K5 once per layer per step, K4's forward 8 times
    per whole-prompt bucket of >= 2048 tokens, no plain version.  Returns
    (results, counter moves, wall s, first-token ms p50 / p99)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    eng.reset_prefix_cache()
    eng.buckets.clear()
    before = engine_counters(eng)
    first: dict = {}
    t0 = [0.0]

    def on_token(rid, tok, i):
        if i == 0 and rid not in first:
            first[rid] = time.perf_counter() - t0[0]
    eng.on_token = on_token
    reset_counts()
    torch.cuda.synchronize()
    t0[0] = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0[0]
    eng.on_token = None
    d = counter_moves(eng, before)
    eager = d["n_decode_steps"] - d["n_scan_flushes"]
    if d["n_scan_flushes"]:
        k5 = "windows replayed"
    else:
        k5 = check_k5_eager(f"[decode] {what}", c.layers, eager)
    long = sum(Lb >= c.block_k_min for Lb in eng.buckets)
    if fa.counts.fwd_tc != c.layers * long or any(plain_calls().values()):
        raise AssertionError(f"[decode] {what}: {fa.counts.fwd_tc} K4 "
                             f"launches for {long} prefills of >= "
                             f"{c.block_k_min} tokens; plain calls "
                             f"{plain_calls()}")
    if {r.req_id: r.prompt_ids.size + r.max_new for r in reqs} != \
            {i: t.size for i, t in res.items()}:
        raise AssertionError(f"[decode] {what}: requests missing or cut "
                             f"short")
    if want is not None:
        same_tokens(f"[decode] {what}", res, want)
    ft = np.percentile(list(first.values()), [50, 99]) * 1e3
    log(f"[decode] {what}: {len(res)} requests"
        + (", tokens equal the straight run's" if want is not None else "")
        + f"; {d['n_decode_steps']} steps ({d['n_mixed_steps']} mixed, "
        f"{d['n_prefill_chunks']} chunks, {d['n_scan_flushes']} windows), "
        f"{len(eng.buckets)} whole-prompt prefills (buckets "
        f"{sorted(set(eng.buckets))}), {d['tokens_generated']} tokens in "
        f"{wall:.3f}s = {d['tokens_generated'] / wall:.1f} tokens/s, "
        f"{wall / d['n_decode_steps'] * 1e3:.2f} ms/step; first token "
        f"p50 {ft[0]:.1f} ms, p99 {ft[1]:.1f} ms; K5 launches {k5}, K4 "
        f"forward {fa.counts.fwd_tc} = {c.layers} x {long} prefills of "
        f">= {c.block_k_min}, plain 0 [{c.smi}]")
    return res, d, wall, ft


def heavy_profile(c, eng, reqs, what: str, want: dict) -> None:
    """`reqs` once more under the profiler from a cold cache: K5 and K4 on
    the card as the wrappers counted them (eager steps), device ms/step,
    busy share."""
    eng.reset_prefix_cache()
    eng.buckets.clear()
    before = engine_counters(eng)
    reset_counts()
    out, pwall, kernels, _ = profiled(lambda: eng.run(reqs))
    d = counter_moves(eng, before)
    same_tokens(f"[decode] {what} profiled", out, want)
    long = sum(Lb >= c.block_k_min for Lb in eng.buckets)
    line = check_launches(
        f"[decode] {what}", kernels,
        {"paged_attention_kernel": c.layers * d["n_decode_steps"],
         "flash_fwd_tc_kernel": c.layers * long}, False)
    log(f"[decode] {what}, profiled {len(reqs)} requests: "
        f"{d['n_decode_steps']} steps, "
        f"{profiled_line(kernels, pwall, d['n_decode_steps'])}; {line} "
        f"[{c.smi}]")


def heavy_margin(c, res: dict, reqs, what: str) -> float:
    """greedy_margin over a serving run's requests, 16 at a time."""
    worst = 0.0
    for b in range(0, len(reqs), 16):
        part = reqs[b:b + 16]
        T = max(res[r.req_id].size for r in part)
        toks = torch.zeros((len(part), T), dtype=torch.int64,
                           device=c.params[next(iter(c.params))].device)
        for i, r in enumerate(part):
            toks[i, :res[r.req_id].size] = torch.from_numpy(
                res[r.req_id].astype(np.int64))
        worst = max(worst, greedy_margin(
            c.ex, c.params, toks, [r.prompt_ids.size for r in part],
            [res[r.req_id].size for r in part]))
    lim = GREEDY_MARGIN[torch.bfloat16]
    log(f"[decode] {what}: teacher-forced margin {worst:.2e} (limit "
        f"{lim:g})")
    if not worst <= lim:
        raise AssertionError(f"[decode] {what}: margin {worst:.3g}")
    return worst


def decode_flash_record(calls: dict, launches: int, err: float,
                        smi: str) -> dict:
    """K4's bf16 forward at the cached prefill's shape [32, 4032, 8, 64]
    (all prompts full, causal) from the path's recorded inputs: timed
    beside its bound, its plain version (four batch rows at a time, summed)
    and scaled_dot_product_attention's forward (a yardstick, never called
    by the port)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa
    (args, kw), = [v for (a, _, _), v in calls.items()
                   if a == "flash_attention"]
    q, k, v = args
    kvm = kw["k_valid"].to(torch.uint8)
    B, T, H, D = q.shape
    ms = time_call(lambda: fa.flash_attention_fwd(q, k, v, kvm, True), 10)

    def plain():
        for b in range(0, B, 4):
            fa.flash_attention_plain(q[b:b + 4], k[b:b + 4], v[b:b + 4],
                                     kvm[b:b + 4], True)
    plain_ms = time_call(plain, 1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = time_call(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)
    pairs = B * H * T * (T + 1) / 2
    nbytes = 4 * B * T * H * D * q.element_size() + B * T + B * H * T * 4
    flops = 4 * D * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log(f"[decode] flash_fwd_tc at the prefill's [{B}, {T}, {H}, {D}] bf16 "
        f"causal: {ms * 1e3:.1f} us/launch; bound {bound_ms * 1e3:.1f} us "
        f"({'operations' if flops_ms >= bytes_ms else 'bytes'}; "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) = "
        f"{bound_ms / ms:.1%} of the bound; plain version "
        f"{plain_ms * 1e3:.1f} us (four rows at a time); "
        f"scaled_dot_product_attention forward {lib_ms * 1e3:.1f} us "
        f"[{smi}]")
    return {"name": f"flash_fwd_tc [{B}, {T}, {H}, {D}]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_tc.cu",
            "replaces": "paddle_tpu/ops/pallas_attention.py:113",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms}


def prefill_call(P: int):
    """recorded_inputs' filter: flash calls of P query rows (a prefill's,
    not the teacher-forced forward's)."""
    return lambda attr, args, kw: args[0].shape[1] == P


def decode_lm_arms(c) -> dict:
    """Arms (1)-(4) of [decode]: lm_generate cached and re-forward, fp32,
    beam search.  Returns the K4 record."""
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.graph.lm_decode import (lm_beam_generate,
                                                  lm_generate)
    rng = np.random.default_rng(0)
    record = None
    for ctx in DECODE_CONTEXTS:
        ids = rng.integers(2, c.vocab, (DECODE_B, ctx - DECODE_NEW))
        k4 = c.layers if ctx - DECODE_NEW >= c.block_k_min else 0
        with recorded_inputs(prefill_call(ctx - DECODE_NEW)) as calls:
            toks, lens = decode_arm(c, c.ex, ids, None, f"(1) cached, "
                                    f"context {ctx}", True, k4,
                                    torch.bfloat16)
        if k4:
            err = max(flash_held(calls, f"(1) cached, context {ctx}",
                                 c.smi))
            record = decode_flash_record(calls, k4, err, c.smi)
        if ctx in DECODE_REFORWARD:
            # the cached arm's teacher-forced forward ran the re-forward's
            # [B, ctx] shapes: no warm call
            again, _ = decode_arm(c, c.ex, ids, None, f"(2) re-forward, "
                                  f"context {ctx}", False, 0, torch.bfloat16,
                                  reps=1, warm=False)
            same = (again == toks).all(dim=1).float().mean()
            log(f"[decode] context {ctx}: {float(same):.1%} of the rows "
                f"decode the same tokens cached and re-forward (bf16; each "
                f"held by its teacher-forced margin)")
    lo, hi = DECODE_RAGGED
    ids = rng.integers(2, c.vocab, (DECODE_B, hi))
    lens = np.sort(rng.integers(lo, hi + 1, DECODE_B))
    lens[-1] = hi
    with recorded_inputs(prefill_call(hi)) as calls:
        decode_arm(c, c.ex, ids, lens, "(1) cached, ragged prompts",
                   True, c.layers, torch.bfloat16, reps=1)
    flash_held(calls, "(1) cached, ragged prompts", c.smi)
    # (3) float32 (TF32 off)
    ex32 = GraphExecutor(c.model)
    ids = rng.integers(2, c.vocab, (DECODE_B, DECODE_FP32 - DECODE_NEW))
    cached, _ = decode_arm(c, ex32, ids, None, f"(3) fp32 cached, context "
                           f"{DECODE_FP32}", True, 0, torch.float32, reps=1)
    # the cached arm's teacher-forced forward ran the re-forward's shapes
    reforward, _ = decode_arm(c, ex32, ids, None, f"(3) fp32 re-forward, "
                              f"context {DECODE_FP32}", False, 0,
                              torch.float32, reps=1, warm=False)
    same = float((cached == reforward).all(dim=1).float().mean())
    log(f"[decode] (3) fp32: {same:.1%} of the rows decode the same tokens "
        f"cached and re-forward; both held within the fp32 margin "
        f"{GREEDY_MARGIN[torch.float32]:g} [{c.smi}]")
    # (4) beam search: B 8, beam 4, prompt 448, 64 new
    Bb, Kb, Pb = DECODE_BEAM
    ids = rng.integers(2, c.vocab, (Bb, Pb))

    def beam(K, max_new=DECODE_NEW):
        return lm_beam_generate(c.ex, c.params, ids, beam_size=K,
                                max_new=max_new)
    reset_counts()
    beam(Kb)[0].cpu()
    times = []
    for _ in range(DECODE_REPS):
        t0 = time.perf_counter()
        toks, blens, scores = beam(Kb)
        toks.cpu()
        times.append(time.perf_counter() - t0)
    line = decode_launches("(4) beam", 0)
    (_, pwall, kernels, _) = profiled(lambda: beam(Kb, DECODE_PROFILE_NEW))
    one = beam(1)[0][:, 0]
    greedy = lm_generate(c.ex, c.params, ids, max_new=DECODE_NEW,
                         use_cache=True)[0]
    if not torch.equal(one, greedy):
        raise AssertionError("[decode] (4) beam 1 differs from greedy "
                             "cached decoding")
    sc = scores.cpu()
    if not (bool(torch.isfinite(sc).all())
            and bool((sc[:, 1:] <= sc[:, :-1]).all())):
        raise AssertionError("[decode] (4) beam scores not finite and "
                             "best-first")
    med = float(np.median(times))
    log(f"[decode] (4) beam: B {Bb}, beam {Kb}, prompt {Pb}, {DECODE_NEW} "
        f"new: {Bb * Kb * DECODE_NEW / med:.1f} beam tokens/s "
        f"({Bb * DECODE_NEW / med:.1f} best-beam tokens/s; median of "
        f"{DECODE_REPS}: "
        f"{', '.join(f'{t:.3f}' for t in times)} s a call, {DECODE_NEW} "
        f"forwards each); {line}; profiled call of {DECODE_PROFILE_NEW} new "
        f"tokens: {profiled_line(kernels, pwall, DECODE_PROFILE_NEW)}; "
        f"beam 1 equals "
        f"greedy cached decoding; scores best-first [{c.smi}]")
    return record


def decode_engine_arms(c) -> None:
    """Arm (5) of [decode]: ServingEngine(prefill_chunk=None) beside the
    chunked engine on the heavy-tail workload, then its windows,
    speculation and a restored checkpoint against the straight run (same
    arithmetic: tokens equal), then 8 requests at context 4096."""
    eng = heavy_engine(c, None)
    for chunk in (64, None):                   # warm-up: not counted
        eng.set_chunking(chunk)
        eng.run(make_heavytail_requests(n=4, prompt_lo=32, prompt_hi=200,
                                        max_new=8, vocab=c.vocab, seed=0))
    reqs = lambda: make_heavytail_requests(vocab=c.vocab, seed=1,  # noqa
                                           **HEAVY)
    want, d, _, _ = heavy_run(c, eng, reqs(), "(5) whole-prompt prefill "
                              "(prefill_chunk=None)")
    eng.set_chunking(64)
    chunked, dc, _, _ = heavy_run(c, eng, reqs(), f"(5) chunked prefill "
                                  f"(chunk 64, budget "
                                  f"{eng.max_step_tokens})")
    same = np.mean([np.array_equal(want[i], chunked[i]) for i in want])
    log(f"[decode] (5) {same:.1%} of the requests decode the same tokens "
        f"whole-prompt and chunked (bf16; each held by its teacher-forced "
        f"margin)")
    heavy_margin(c, want, reqs(), "(5) whole-prompt")
    heavy_margin(c, chunked, reqs(), "(5) chunked")
    eng.set_chunking(None)
    heavy_profile(c, eng, reqs()[:HEAVY_PROFILED], "(5) whole-prompt", want)
    sub = reqs()[:HEAVY_SUBSET]
    eng.set_decode_steps(KSTEP)
    heavy_run(c, eng, sub, f"(5) whole-prompt, decode_steps={KSTEP}", want)
    eng.set_decode_steps(1)
    eng.set_speculation(SPEC_K)
    _, d, _, _ = heavy_run(c, eng, sub, f"(5) whole-prompt, "
                           f"spec_k={SPEC_K}", want)
    log(f"[decode] (5) spec_k={SPEC_K}: {d['n_decode_steps']} steps, rows "
        f"{len(eng.slots) * (SPEC_K + 1)} a verify step, the engine's "
        f"{eng.splits} K5 split(s)")
    eng.set_speculation(0)
    for r in sub:
        eng.add_request(r)
    while not (eng.queue and any(sl is not None and sl.gen > 1
                                 for sl in eng.slots)):
        if not eng.step():
            raise AssertionError("[decode] never reached a mid-flight state")
    snap = eng.checkpoint_state()
    same_tokens("[decode] (5) uninterrupted", eng.run(), want)
    fresh = heavy_engine(c, None)
    fresh.restore_state(snap)
    reset_counts()
    steps0 = fresh.n_decode_steps
    res = fresh.run() | dict(snap["results"])
    check_k5_eager("[decode] restored", c.layers,
                   fresh.n_decode_steps - steps0)
    same_tokens("[decode] (5) restored checkpoint", res, want)
    if sorted(res) != sorted(r.req_id for r in sub):
        raise AssertionError("[decode] the restored engine did not finish "
                             "every request")
    fresh.kv.check_reclaimed()
    log(f"[decode] (5) checkpoint mid-flight ({sum(sl is not None for sl in snap['slots'])} "
        f"slots live, {len(snap['queue'])} queued) restored on a fresh "
        f"engine: its tokens equal the straight run's [{c.smi}]")
    del fresh, eng
    # 8 requests at context 4096: whole-prompt buckets of >= 2048 run K4
    long = heavy_engine(c, None, context=LONG_CONTEXT)
    lreqs = lambda: make_heavytail_requests(vocab=c.vocab, seed=2,  # noqa
                                            **HEAVY_LONG)
    with recorded_inputs() as calls:
        res, _, _, _ = heavy_run(c, long, lreqs(), f"(5) whole-prompt, "
                                 f"context {LONG_CONTEXT}")
    if not any(Lb >= c.block_k_min for Lb in long.buckets):
        raise AssertionError(f"[decode] no whole-prompt bucket of >= "
                             f"{c.block_k_min} tokens at context "
                             f"{LONG_CONTEXT}")
    flash_held(calls, "(5) whole-prompt bucket prefill", c.smi)
    heavy_margin(c, res, lreqs(), f"(5) context {LONG_CONTEXT}")
    heavy_profile(c, long, lreqs(), f"(5) whole-prompt, context "
                  f"{LONG_CONTEXT}", res)


def phase_decode(smi: str) -> list:
    """The dense decode path at [serve]'s width (module docstring, phase
    4d); returns K4's record at the cached prefill's shape."""
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.parameter import init_params
    model = transformer_lm_config(**DECODE_MODEL)
    c = types.SimpleNamespace(vocab=DECODE_MODEL["vocab"],
                              layers=DECODE_MODEL["layers"], smi=smi,
                              model=model, params=init_params(model, seed=1),
                              ex=GraphExecutor(model,
                                               compute_dtype="bfloat16"),
                              block_k_min=int(DECODE_MODEL.get(
                                  "block_k_min", 0) or 2048))
    start = time.perf_counter()
    record = decode_lm_arms(c)
    lm_s = time.perf_counter() - start
    decode_engine_arms(c)
    log(f"[decode] all arms: {time.perf_counter() - start:.1f} s "
        f"(lm_generate and beam {lm_s:.1f} s) [{smi}]")
    return [record]


# [serve-spill]: bench.py bench_serving_spill's configuration at [serve]'s
# width: 4 slots, pages of 16, context 768, a pool of 96 pages (below the
# prefix-skew workload's working set) and a 64 MiB host tier; the
# workload is tools/bench_serving.py's prefix skew, greedy (its
# make_prefix_requests)
SPILL_ENGINE = dict(num_slots=4, page_size=16, max_context=768,
                    num_pages=96)
SPILL_BUDGET = 64 << 20
SPILL_TRACED = 8                # requests of the tracing on/off runs


def spill_requests(vocab: int, n: Optional[int] = None) -> list:
    from paddle_tpu_torch.serving import Request
    w = dict(PREFIX_WORKLOAD)
    prompts = make_prefix_prompts(w.pop("n"), vocab=vocab, **{
        k: w[k] for k in ("prefix_pool", "prefix_len", "prefix_skew",
                          "suffix_lo", "suffix_hi")})
    return [Request(i, p, max_new=w["max_new"])
            for i, p in enumerate(prompts[:n])]


def spill_timers(eng) -> dict:
    """Wrap the engine's allocator's spill and restore (measurement only:
    the engine calls them through these instance attributes) to sum their
    wall time, the card synchronized around each restore, and to keep the
    restored pages; returns the running sums."""
    kv = eng.kv
    t = {"spill_s": 0.0, "spilled": 0, "restore_s": 0.0, "restored": 0,
         "pages": set()}
    spill, restore = kv.spill_page, kv.restore_pages

    def timed_spill(page):
        t0 = time.perf_counter()
        hid = spill(page)
        if hid is not None:
            t["spill_s"] += time.perf_counter() - t0
            t["spilled"] += 1
        return hid

    def timed_restore(hids, pages):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(hids, pages)
        torch.cuda.synchronize()
        t["restore_s"] += time.perf_counter() - t0
        t["restored"] += len(pages)
        t["pages"].update(int(p) for p in pages)

    kv.spill_page, kv.restore_pages = timed_spill, timed_restore
    return t


def copy_rates() -> str:
    """Device-to-host and host-to-device rates of 64 pages' worth of bytes
    (16 MiB) to and from pageable and pinned host memory (measurement
    only: the engine's tier copies to pageable memory, one page a copy)."""
    n = 64 * 262144
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    out = []
    for kind in ("pageable", "pinned"):
        host = torch.empty(n, dtype=torch.uint8,
                           pin_memory=kind == "pinned")
        for what, fn in (("D2H", lambda: host.copy_(dev)),
                         ("H2D", lambda: dev.copy_(host))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            rate = 5 * n / (time.perf_counter() - t0) / 1e9
            out.append(f"{what} {kind} {rate:.2f} GB/s")
    return ", ".join(out)


def spill_arm(c, eng, what: str, reqs, record: bool = False):
    """Serve `reqs` on `eng` from a cold cache, timed: (results, counter
    moves, wall s, first-token p50 ms, spill/restore sums, recorded
    layer-0 K5 launches)."""
    import paddle_tpu_torch.ops.attention as attn_ops
    from paddle_tpu_torch.ops import paged_attention as pa
    eng.reset_prefix_cache()
    before = engine_counters(eng) | {
        a: getattr(eng, a) for a in ("n_restore_hits",
                                     "restore_tokens_saved")}
    kv0 = (eng.kv.n_spilled, eng.kv.n_restored)
    timers = spill_timers(eng)
    first, recorded = {}, []
    wrapper = pa.paged_attention
    layer0 = next(iter(eng.kv.pools))

    def recording(q, k_pages, v_pages, page_table, lengths, scale=None,
                  row_slot=None, splits=None):
        out = wrapper(q, k_pages, v_pages, page_table, lengths, scale,
                      row_slot, splits)
        if k_pages is eng.kv.pools[layer0]["k"]:
            # the first launch whose slots map a restored page (read off
            # the host table: no sync) keeps layer 0's pools as it read
            # them
            fresh = not recorded or recorded[0][6] is None
            fresh = fresh and bool(timers["pages"].intersection(
                eng.kv.table.ravel().tolist()))
            recorded.append((q.clone(), k_pages, v_pages, page_table.clone(),
                             lengths.clone(),
                             None if row_slot is None else row_slot.clone(),
                             (k_pages.clone(), v_pages.clone())
                             if fresh else None))
            if fresh:                       # the probe goes first
                recorded.insert(0, recorded.pop())
        return out

    eng.on_token = lambda rid, tok, i: first.setdefault(
        rid, time.perf_counter()) if i == 0 else None
    if record:
        attn_ops.pa.paged_attention = recording
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attn_ops.pa.paged_attention = wrapper
        eng.on_token = None
        del eng.kv.spill_page, eng.kv.restore_pages
    d = {k: v - before[k] for k, v in (engine_counters(eng) | {
        a: getattr(eng, a) for a in ("n_restore_hits",
                                     "restore_tokens_saved")}).items()}
    d["spilled"] = eng.kv.n_spilled - kv0[0]
    d["restored"] = eng.kv.n_restored - kv0[1]
    eager = d["n_decode_steps"] - d["n_scan_flushes"]
    check_k5_eager(f"[serve-spill] {what}", c.layers, eager)
    want_len = {r.req_id: r.prompt_ids.size + r.max_new for r in reqs}
    if {i: t.size for i, t in res.items()} != want_len:
        raise AssertionError(f"[serve-spill] {what}: requests missing or "
                             f"cut short")
    seen = d["n_prefix_hits"] + d["n_prefix_misses"]
    d["hit_rate"] = d["n_prefix_hits"] / seen if seen else 0.0
    p50 = float(np.median([first[r.req_id] - t0 for r in reqs])) * 1e3
    log(f"[serve-spill] {what}: {len(res)} requests, {d['n_decode_steps']} "
        f"steps ({d['n_mixed_steps']} mixed, {d['n_scan_flushes']} "
        f"windows), {d['tokens_generated'] / wall:.1f} tokens/s, "
        f"{wall / d['n_decode_steps'] * 1e3:.2f} ms/step, first token p50 "
        f"{p50:.1f} ms; prefix hits {d['n_prefix_hits']} of {seen} "
        f"({d['hit_rate']:.1%}), prefill tokens saved "
        f"{d['prefill_tokens_saved']}; pages spilled {d['spilled']}, "
        f"restored {d['restored']} in {d['n_restore_hits']} restore hits "
        f"saving {d['restore_tokens_saved']} tokens; K5 launches "
        f"{c.layers} x {eager} eager steps, plain 0 [{c.smi}]")
    return res, d, wall, p50, timers, recorded


def site_signatures() -> dict:
    from paddle_tpu_torch.obs import get_compile_watch
    return {s: st["signatures"] for s, st in
            get_compile_watch().snapshot().items()
            if s.startswith("serving.") and s != "serving.spill_restore"}


def spill_on_off(c) -> None:
    """[serve-spill] 1: the workload on one engine, spill tier off, then
    on (set_spill_budget; reset_prefix_cache before each), and on an
    engine with the prefix cache off: tokens equal request for request;
    the on arm spills and restores pages and hits more often than the off
    arm; restored tokens within restored pages x 16; the engine sites'
    signature counts unchanged between the arms; K5 once per layer per
    step, the plain version never.  K5 at the on arm's recorded layer-0
    launches: its error on the first launch reading a restored page, its
    time, the plain version's and the bound (the kernels line's
    record)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    cold = c.engine(prefix_cache=False)
    cold.run(serve_requests(4, c.vocab, seed=7, lo=8, hi=80, max_new=4))
    c.want, _, _, _, _, _ = spill_arm(c, cold, "cache off",
                                      spill_requests(c.vocab))
    del cold
    eng = c.eng = c.engine(prefix_cache=True)
    eng.run(serve_requests(4, c.vocab, seed=7, lo=8, hi=80, max_new=4))
    arms = {}
    for label, budget in (("off", 0), ("on", SPILL_BUDGET)):
        eng.set_spill_budget(budget)
        sig0 = site_signatures()
        arms[label] = spill_arm(c, eng, f"spill {label}",
                                spill_requests(c.vocab), record=True)
        same_tokens(f"[serve-spill] spill {label}", arms[label][0], c.want)
        if label == "on" and site_signatures() != sig0:
            raise AssertionError(f"[serve-spill] the engine sites' "
                                 f"signatures moved between the arms: "
                                 f"{sig0} -> {site_signatures()}")
        eng.kv.check()
    (_, off, off_wall, off_p50, _, _), (_, on, on_wall, on_p50, t,
                                        recorded) = arms["off"], arms["on"]
    if not (on["spilled"] > 0 and on["restored"] > 0
            and on["hit_rate"] > off["hit_rate"]
            and 0 < on["restore_tokens_saved"]
            <= on["restored"] * eng.kv.page_size):
        raise AssertionError(f"[serve-spill] the on arm: {on}; off {off}")
    log(f"[serve-spill] spill on against off: tokens equal request for "
        f"request (and the cache-off run's); hit rate {on['hit_rate']:.1%} "
        f"against {off['hit_rate']:.1%}, prefill tokens saved "
        f"{on['prefill_tokens_saved']} against "
        f"{off['prefill_tokens_saved']}, tokens/s "
        f"{on['tokens_generated'] / on_wall:.1f} against "
        f"{off['tokens_generated'] / off_wall:.1f}, first token p50 "
        f"{on_p50:.1f} ms against {off_p50:.1f} ms; spill "
        f"{t['spill_s'] / t['spilled'] * 1e3:.3f} ms/page over "
        f"{t['spilled']} pages, restore "
        f"{t['restore_s'] / t['restored'] * 1e3:.3f} ms/page over "
        f"{t['restored']} pages ({eng.kv.page_nbytes} B a page); the "
        f"sites' signatures unchanged {site_signatures()} [{c.smi}]")
    log(f"[serve-spill] copy rates of 16 MiB: {copy_rates()} [{c.smi}]")
    probe = recorded[0] if recorded and recorded[0][6] is not None else None
    if probe is None:
        raise AssertionError("[serve-spill] no recorded launch read a "
                             "restored page")
    q, _, _, table, lengths, row_slot, (k0, v0) = probe
    err = k5_error((q, k0, v0, table, lengths, row_slot), splits=eng.splits)
    if not err <= K5_ATOL[torch.bfloat16]:
        raise AssertionError(f"[serve-spill] K5 over restored pages: {err}")
    launches = [r[:6] for r in recorded[:512]]
    kern_ms = time_launches(pa.paged_attention, launches)
    plain_ms = time_launches(pa.paged_attention_plain, launches)
    bound = [launch_bytes_flops(a, 2) for a in launches]
    bytes_ms = float(np.mean([b for b, _ in bound])) / HBM_BYTES_PER_S * 1e3
    flops_ms = float(np.mean([f for _, f in bound])) / \
        PEAK_FLOPS[torch.bfloat16] * 1e3
    log(f"[serve-spill] K5 on a launch reading restored pages ({q.shape[0]} "
        f"rows, the engine's {eng.splits} split(s)) against its plain "
        f"version in float32: max abs err {err:.3e} (limit "
        f"{K5_ATOL[torch.bfloat16]:g}); over {len(launches)} of the on "
        f"arm's layer-0 launches {kern_ms * 1e3:.2f} us/launch, plain "
        f"{plain_ms * 1e3:.2f} us, bound "
        f"{max(bytes_ms, flops_ms) * 1e3:.3f} us [{c.smi}]")
    c.record = {"name": "paged_attention [serve-spill]", "route": "cuda",
                "source": "paddle_tpu_torch/csrc/paged_attention.cu",
                "replaces": "paddle_tpu/ops/pallas_paged.py:104",
                "launches": c.layers * (on["n_decode_steps"]
                                        - on["n_scan_flushes"]),
                "max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, flops_ms),
                "bound_by": "bytes" if bytes_ms >= flops_ms
                else "operations", "library_ms": None}


def spill_windows(c) -> None:
    """[serve-spill] 2: the on arm at decode_steps=KSTEP (both window
    variants captured by a warm-up): the same tokens as k = 1, windows
    replayed from CUDA graphs over the restored pages."""
    eng = c.eng
    eng.set_decode_steps(KSTEP)
    eng.run(serve_requests(4, c.vocab, seed=7, lo=8, hi=80, max_new=12,
                           sampled_every=2))
    eng.run(serve_requests(2, c.vocab, seed=8, lo=8, hi=80, max_new=12))
    replays0 = sum(g.replays for g in eng._windows[KSTEP].graphs.values()
                   if g is not None)
    res, d, _, _, _, _ = spill_arm(c, eng, f"spill on, decode_steps={KSTEP}",
                                   spill_requests(c.vocab))
    same_tokens(f"[serve-spill] decode_steps={KSTEP}", res, c.want)
    replays = sum(g.replays for g in eng._windows[KSTEP].graphs.values()
                  if g is not None) - replays0
    if replays < 1 or d["restored"] < 1:
        raise AssertionError(f"[serve-spill] decode_steps={KSTEP}: "
                             f"{replays} replays, {d['restored']} pages "
                             f"restored")
    log(f"[serve-spill] decode_steps={KSTEP}: tokens equal k = 1; "
        f"{replays} window replays beside {d['restored']} restored pages "
        f"[{c.smi}]")
    eng.set_decode_steps(1)


def spill_transfer(c) -> None:
    """[serve-spill] 3: a cached prefix exported from the engine and
    imported into a second engine of the same weights: the next admission
    of its prompt is a prefix hit with the cold run's tokens."""
    eng = c.eng
    eng.reset_prefix_cache()
    reqs = spill_requests(c.vocab)
    eng.run(reqs[:8])
    for r in reversed(reqs[:8]):
        exp = eng.export_prefix(r.prompt_ids)
        if exp is not None and exp[1]["n_pages"] >= 8:
            break
    else:
        raise AssertionError("[serve-spill] nothing to export")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = eng.export_prefix(r.prompt_ids)           # timed: the second call
    export_s = time.perf_counter() - t0
    toks, meta, payload = exp
    other = c.engine(prefix_cache=True)
    ptrs = {(n, p): t.data_ptr() for n, pool in other.kv.pools.items()
            for p, t in pool.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    added = other.import_prefix(toks, meta, payload)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    if ptrs != {(n, p): t.data_ptr() for n, pool in other.kv.pools.items()
                for p, t in pool.items()}:
        raise AssertionError("[serve-spill] an import moved a pool")
    reset_counts()
    again = next(x for x in spill_requests(c.vocab) if x.req_id == r.req_id)
    res = other.run([again])
    check_k5_eager("[serve-spill] imported", c.layers, other.n_decode_steps)
    same_tokens("[serve-spill] imported", res, c.want)
    if other.n_prefix_hits != 1 or \
            other.prefill_tokens_saved < toks.size - eng.kv.page_size:
        raise AssertionError("[serve-spill] the imported prefix was not hit")
    n = meta["n_pages"]
    log(f"[serve-spill] export of request {r.req_id}'s {n}-page prefix "
        f"({len(payload)} B, dtype {meta['layers'][0]['dtype']}) "
        f"{export_s / n * 1e3:.3f} ms/page, import {import_s / n * 1e3:.3f} "
        f"ms/page ({added} nodes); the importer's admission hit "
        f"{other.prefill_tokens_saved} tokens with the cold run's tokens "
        f"[{c.smi}]")
    del other


def spill_tracing(c) -> None:
    """[serve-spill] 4: SPILL_TRACED requests with the tracer on and off,
    two rounds: equal tokens, ms/step each way, every request lane's
    phases in order, the Chrome trace written and read back; a flight
    bundle dumped and read back."""
    import tempfile

    from paddle_tpu_torch.obs import (Tracer, get_flight_recorder,
                                      load_bundle, spans_to_chrome)
    eng = c.eng
    tracer = Tracer(capacity=1 << 18)
    eng.tracer = tracer
    flight = get_flight_recorder()
    flight.clear()
    flight.enabled = True
    ms = {True: [], False: []}
    try:
        for rnd in range(2):
            for on in ((False, True) if rnd == 0 else (True, False)):
                tracer.clear()
                tracer.enabled = on
                eng.reset_prefix_cache()
                steps0 = eng.n_decode_steps
                reqs = spill_requests(c.vocab, SPILL_TRACED)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = eng.run(reqs)
                torch.cuda.synchronize()
                ms[on].append((time.perf_counter() - t0) * 1e3
                              / (eng.n_decode_steps - steps0))
                same_tokens(f"[serve-spill] tracer {on}", res, c.want)
                if on:
                    spans = tracer.snapshot()
                elif tracer.recorded:
                    raise AssertionError("[serve-spill] a disabled tracer "
                                         "recorded spans")
        for r in reqs:
            ph = [s["name"] for s in spans if s["track"] == f"req:{r.req_id}"
                  and not s.get("instant")]
            ends = [s["name"] for s in spans
                    if s["track"] == f"req:{r.req_id}" and s.get("instant")]
            if ph[:2] != ["queued", "prefill"] or ph[2] not in (
                    "decode", "replay") or ends[-1] != "done":
                raise AssertionError(f"[serve-spill] request {r.req_id}'s "
                                     f"phases {ph} {ends}")
        steps = [s for s in spans if s["track"] == "engine"]
        with tempfile.TemporaryDirectory() as root:
            path = os.path.join(root, "trace.json")
            with open(path, "w") as f:
                json.dump(spans_to_chrome(spans), f)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            bundle = load_bundle(flight.dump(root, "serve-spill",
                                             spans=spans))
        kinds = {e["kind"] for e in bundle["events"]}
        if not {"queued", "admit", "finish"} <= kinds or \
                len(events) < len(spans):
            raise AssertionError(f"[serve-spill] trace {len(events)} "
                                 f"events, bundle kinds {kinds}")
    finally:
        flight.enabled = False
        flight.clear()
        tracer.enabled = False
    log(f"[serve-spill] tracing: {SPILL_TRACED} requests, ms/step tracer on "
        f"{' / '.join(f'{x:.2f}' for x in ms[True])}, off "
        f"{' / '.join(f'{x:.2f}' for x in ms[False])}; tokens equal; "
        f"{len(spans)} spans ({len(steps)} on the engine lane), every "
        f"request lane queued -> prefill -> decode -> done; Chrome trace of "
        f"{len(events)} events read back; a flight bundle of "
        f"{len(bundle['events'])} events ({len(kinds)} kinds) read back "
        f"[{c.smi}]")


def phase_serve_spill(smi: str) -> list:
    """The rest of the engine on the card (module docstring, phase 4e):
    bench_serving_spill's configuration at [serve]'s width, (1) the spill
    tier off and on, (2) windows over restored pages, (3) a prefix export
    / import, (4) tracing on and off; returns K5's record at the spill-on
    arm's launches."""
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import ServingEngine

    vocab, layers = 32000, SERVE_LAYERS
    model = transformer_lm_config(vocab=vocab, dim=512, layers=layers,
                                  heads=8)
    ex = GraphExecutor(model, compute_dtype="bfloat16")
    params = init_params(model, seed=1)

    def engine(**kw):
        return ServingEngine(ex, params, **SPILL_ENGINE, **kw)

    c = types.SimpleNamespace(vocab=vocab, layers=layers, smi=smi,
                              engine=engine, eng=None, want=None,
                              record=None)
    for n, fn in enumerate((spill_on_off, spill_windows, spill_transfer,
                            spill_tracing), 1):
        start = time.perf_counter()
        fn(c)
        log(f"[serve-spill] ({n}) {fn.__name__}: "
            f"{time.perf_counter() - start:.1f} s [{smi}]")
    c.eng = None
    torch.cuda.empty_cache()
    return [c.record]


# [serve-fleet]: the RPC front end and the fleet at [serve]'s width
FLEET_MODEL = dict(vocab=32000, dim=512, layers=SERVE_LAYERS, heads=8)
FLEET_DTYPE = "bfloat16"
FLEET_ENGINE = dict(num_slots=16, page_size=16, max_context=768)
FLEET_CONC = 8              # requests each client keeps in flight
FLEET_DEADLINE = 20.0       # steps on the step clock, arm (1)'s deadline
FLEET_PUSH_PROBE = 8        # prefill_only requests timing a kv_push
FLEET_KILL_NEW = 256        # tokens of the request streaming at the kill
REPLICA_BOOT_S = 240.0      # a replica subprocess's SERVE_JSON, at most


def fleet_model():
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.parameter import init_params
    model = transformer_lm_config(**FLEET_MODEL)
    return (GraphExecutor(model, compute_dtype=FLEET_DTYPE),
            init_params(model, seed=1))


def replica_cmd(role: str) -> list:
    """`python -m paddle_tpu_torch.tools.serve` at the fleet's
    configuration: the demo LM config at FLEET_MODEL's width in FLEET_DTYPE,
    weights from seed 1 (Trainer -> init_params, as fleet_model's)."""
    m = FLEET_MODEL
    e = FLEET_ENGINE
    return [sys.executable, "-m", "paddle_tpu_torch.tools.serve",
            "--config", "demo/model_zoo/transformer_lm.py", "--config-args",
            f"vocab={m['vocab']},dim={m['dim']},layers={m['layers']},"
            f"heads={m['heads']},compute_dtype={FLEET_DTYPE}",
            "--slots", str(e["num_slots"]),
            "--page-size", str(e["page_size"]),
            "--max-context", str(e["max_context"]), "--max-queue", "64",
            "--seed", "1", "--port", "0", "--role", role]


class ReplicaProcs:
    """Replica subprocesses started together; `wait()` reads each one's
    SERVE_JSON line.  Their stderr goes to temporary files, printed when
    a replica fails.  `close()` ends every one still running."""

    def __init__(self, roles):
        import tempfile
        self.roles = list(roles)
        self.logs = [tempfile.TemporaryFile(mode="w+") for _ in self.roles]
        self.procs = [subprocess.Popen(
            replica_cmd(role), stdout=subprocess.PIPE, stderr=log_f,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
            for role, log_f in zip(self.roles, self.logs)]
        self.addrs = [None] * len(self.procs)
        self.t0 = time.perf_counter()

    def wait(self) -> list:
        import threading
        lines = [None] * len(self.procs)

        def read(i):
            lines[i] = self.procs[i].stdout.readline()

        readers = [threading.Thread(target=read, args=(i,), daemon=True)
                   for i in range(len(self.procs))]
        for t in readers:
            t.start()
        for t in readers:
            t.join(max(1.0, REPLICA_BOOT_S - (time.perf_counter()
                                              - self.t0)))
        for i, line in enumerate(lines):
            if not line or not line.startswith("SERVE_JSON:"):
                raise AssertionError(
                    f"[serve-fleet] replica {i} ({self.roles[i]}) gave no "
                    f"SERVE_JSON line (exit {self.procs[i].poll()}): "
                    f"{self.stderr(i)}")
            a = json.loads(line[len("SERVE_JSON:"):])
            if a["pid"] != self.procs[i].pid:
                raise AssertionError(f"[serve-fleet] SERVE_JSON {a}")
            self.addrs[i] = (a["host"], a["port"])
        return self.addrs

    def stderr(self, i: int) -> str:
        self.logs[i].seek(0)
        return self.logs[i].read()[-2000:]

    def index_of(self, port: int) -> int:
        return next(i for i, a in enumerate(self.addrs)
                    if a is not None and a[1] == port)

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            if p.stdout is not None:
                p.stdout.close()
        for f in self.logs:
            f.close()


def request_kw(r) -> dict:
    """A Request's generate knobs, as a client sends them (the wire's seed
    is the key's low word: PRNGKey(seed) = [0, seed mod 2**32])."""
    kw = dict(max_new=r.max_new)
    if r.temperature > 0.0:
        if int(r.rng[0]) != 0:
            raise ValueError(f"request {r.req_id}: a key no seed spells")
        kw.update(temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
                  seed=int(r.rng[1]))
    return kw


def closed_loop(host: str, port: int, reqs, conc: int = FLEET_CONC) -> dict:
    """`reqs` through one ServingClient with `conc` in flight (a new one
    submitted as one finishes), streamed: {"tokens": {req_id: np.int32
    prompt + generated}, "reasons", "frames": {req_id: [(index, token,
    burst)]}, "first": {req_id: s submit -> token 0}, "wall": s,
    "generated": tokens}."""
    from paddle_tpu_torch.serving.client import ServingClient
    todo = list(reqs)
    live, t_sub = {}, {}
    out = {"tokens": {}, "reasons": {}, "frames": {}, "first": {}}
    with ServingClient(host, port, timeout=600) as c:
        def submit(r):
            cid = c.submit(r.prompt_ids.tolist(), req_id=f"r{r.req_id}",
                           **request_kw(r))
            live[cid] = r.req_id
            t_sub[r.req_id] = time.perf_counter()

        t0 = time.perf_counter()
        while todo and len(live) < conc:
            submit(todo.pop(0))
        while live:
            msg = c.recv()
            rid = live.get(msg.get("id"))
            if rid is None:
                raise AssertionError(f"[serve-fleet] a frame for no live "
                                     f"request: {msg}")
            if msg["type"] == "token":
                out["frames"].setdefault(rid, []).append(
                    (msg["index"], msg["token"], msg.get("burst")))
                if msg["index"] == 0:
                    out["first"][rid] = time.perf_counter() - t_sub[rid]
            elif msg["type"] == "done":
                out["tokens"][rid] = np.asarray(msg["tokens"], np.int32)
                out["reasons"][rid] = msg["reason"]
                del live[msg["id"]]
                if todo:
                    submit(todo.pop(0))
            else:
                raise AssertionError(f"[serve-fleet] request {rid}: {msg}")
        out["wall"] = time.perf_counter() - t0
    out["generated"] = sum(out["tokens"][r.req_id].size - r.prompt_ids.size
                           for r in reqs)
    return out


def direct_closed_loop(eng, reqs, conc: int = FLEET_CONC) -> dict:
    """The same closed loop on the engine in-process (no front end):
    {"tokens", "first", "wall", "generated", "steps"}."""
    todo = list(reqs)
    t_sub, first, done = {}, {}, {}

    def add(r):
        t_sub[r.req_id] = time.perf_counter()
        eng.add_request(r)

    def on_finish(rid, toks, why):
        done[rid] = np.asarray(toks, np.int32)

    eng.on_token = lambda rid, tok, i: first.setdefault(
        rid, time.perf_counter() - t_sub[rid]) if i == 0 else None
    eng.on_finish = on_finish
    steps0 = eng.n_decode_steps
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while todo and len(t_sub) - len(done) < conc:
            add(todo.pop(0))
        while eng.step():
            # a finished request's successor joins between steps, as a
            # client's next submit reaches the server's pump
            while todo and len(t_sub) - len(done) < conc:
                add(todo.pop(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng.on_token = eng.on_finish = None
    eng.results.clear()
    eng.finish_reasons.clear()
    eng.finish_timing.clear()
    return {"tokens": done, "first": first, "wall": wall,
            "steps": eng.n_decode_steps - steps0,
            "generated": sum(done[r.req_id].size - r.prompt_ids.size
                             for r in reqs)}


def fleet_same(what: str, got: dict, want: dict, prefix_ok=()) -> None:
    """Every request's tokens equal the direct run's (those in
    `prefix_ok`, which ended early, a prefix of them)."""
    if set(got) != set(want):
        raise AssertionError(f"[serve-fleet] {what}: requests "
                             f"{sorted(set(got) ^ set(want))[:8]} missing")
    bad = [i for i in want if not (
        np.array_equal(got[i], want[i]) if i not in prefix_ok
        else np.array_equal(got[i], want[i][:got[i].size]))]
    if bad:
        raise AssertionError(f"[serve-fleet] {what}: tokens differ from "
                             f"the direct engine's for requests {bad[:8]}")


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(list(xs)) * 1e3, q))


def rate_line(run: dict, steps: Optional[int] = None) -> str:
    s = (f"{run['generated'] / run['wall']:.1f} tokens/s, first token p50 "
         f"{pct(run['first'].values(), 50):.1f} / p99 "
         f"{pct(run['first'].values(), 99):.1f} ms")
    if steps:
        s += f", {run['wall'] / steps * 1e3:.2f} ms/step ({steps} steps)"
    return s


def metric_families(text: str) -> dict:
    """{family: (has # HELP, has # TYPE)} of a Prometheus text."""
    fams = {}
    for ln in text.splitlines():
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            name = ln.split()[2]
            h, t = fams.get(name, (False, False))
            fams[name] = (h or ln.startswith("# HELP"),
                          t or ln.startswith("# TYPE"))
    return fams


def metric_value(text: str, name: str) -> Optional[float]:
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    return None


def memory_gauges(text: str) -> dict:
    """The allocator's gauges of a metrics frame, each required > 0."""
    mem = {n: metric_value(text, n) for n in (
        "hbm_bytes_in_use", "hbm_bytes_limit", "hbm_live_arrays",
        "hbm_kv_pool_bytes")}
    if not all(v and v > 0 for v in mem.values()):
        raise AssertionError(f"[serve-fleet] memory gauges {mem}")
    return mem


def window_replays(eng, k: int) -> int:
    return sum(g.replays for g in eng._windows[k].graphs.values()
               if g is not None)


def fleet_tcp(c) -> None:
    """[serve-fleet] 1: one ServingServer over TCP in this process, k = 1
    then KSTEP, each beside the same closed loop on a second engine of the
    configuration driven directly; K5 on the pump thread; then cancel,
    deadline, overload and drain."""
    import threading

    import paddle_tpu_torch.ops.attention as attn_ops
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.server import ServingServer
    direct = c.direct = ServingEngine(c.ex, c.params, **FLEET_ENGINE)
    eng = c.srv_eng = ServingEngine(c.ex, c.params, **FLEET_ENGINE)

    def reqs():
        return serve_requests(32, c.vocab, seed=1, lo=32, hi=256,
                              max_new=64, sampled_every=4)

    def warm():
        # windows with a sampling slot, then all-greedy ones: each
        # variant's first window runs eagerly, its second is captured
        return [serve_requests(4, c.vocab, seed=7, lo=8, hi=80, max_new=12,
                               sampled_every=2),
                serve_requests(2, c.vocab, seed=8, lo=8, hi=80, max_new=12)]

    layer0 = next(iter(eng.kv.pools))
    wrapper = pa.paged_attention
    recorded, threads, keep = [], set(), [False]

    def recording(q, k_pages, v_pages, page_table, lengths, scale=None,
                  row_slot=None, splits=None):
        threads.add(threading.current_thread().name)
        out = wrapper(q, k_pages, v_pages, page_table, lengths, scale,
                      row_slot, splits)
        if keep[0] and k_pages is eng.kv.pools[layer0]["k"] and \
                len(recorded) < 512:
            recorded.append((q.clone(), k_pages, v_pages, page_table.clone(),
                             lengths.clone(),
                             None if row_slot is None else row_slot.clone(),
                             None if recorded else
                             (k_pages.clone(), v_pages.clone())))
        return out

    for k in (1, KSTEP):
        for e in (direct, eng):
            e.set_decode_steps(k)
            e.reset_prefix_cache()
        for w in warm():
            direct.run(w)
        direct.reset_prefix_cache()
        srv = ServingServer(eng, max_queue=32)
        host, port = srv.start_background()
        try:
            for w in warm():                   # window captures (pump)
                closed_loop(host, port, w)
            eng.reset_prefix_cache()           # idle between the loops
            c.settle()                         # the replicas bound, idle
            want = direct_closed_loop(direct, reqs())
            before = engine_counters(eng)
            reset_counts()
            threads.clear()
            keep[0] = k == 1
            attn_ops.pa.paged_attention = recording
            try:
                got = closed_loop(host, port, reqs())
            finally:
                attn_ops.pa.paged_attention = wrapper
            d = counter_moves(eng, before)
            eager = d["n_decode_steps"] - d["n_scan_flushes"]
            launches = check_k5_eager(f"[serve-fleet] TCP k = {k}", c.layers,
                                      eager)
            if threads != {"serving-engine-pump"}:
                raise AssertionError(f"[serve-fleet] K5 launched on threads "
                                     f"{threads}, not the pump alone")
            with ServingClient(host, port) as cl:
                stats, text = cl.stats(), cl.metrics()
        finally:
            srv.stop_background(drain=True)
        fleet_same(f"TCP k = {k}", got["tokens"], want["tokens"])
        if set(got["reasons"].values()) != {"length"}:
            raise AssertionError(f"[serve-fleet] reasons {got['reasons']}")
        bursts = [b for fr in got["frames"].values() for _, _, b in fr]
        for rid, fr in got["frames"].items():
            if [i for i, _, _ in fr] != list(range(len(fr))) or \
                    [t for _, t, _ in fr] != \
                    got["tokens"][rid][-len(fr):].tolist():
                raise AssertionError(f"[serve-fleet] request {rid}'s "
                                     f"streamed frames {fr[:6]}...")
        if not (1 <= min(bursts) and max(bursts) <= k
                and (max(bursts) > 1) == (k > 1)):
            raise AssertionError(f"[serve-fleet] bursts {min(bursts)}.."
                                 f"{max(bursts)} at k = {k}")
        fams = metric_families(text)
        if not stats["consistent"] or not all(
                h and t for h, t in fams.values()):
            raise AssertionError(f"[serve-fleet] stats consistent "
                                 f"{stats['consistent']}; families without "
                                 f"HELP/TYPE: "
                                 f"{[f for f, v in fams.items() if not all(v)]}")
        mem = memory_gauges(text)
        if k > 1 and not window_replays(eng, k):
            raise AssertionError("[serve-fleet] no window replayed on the "
                                 "pump thread")
        log(f"[serve-fleet] (1) TCP k = {k}: 32 requests at concurrency "
            f"{FLEET_CONC} through ServingServer, tokens equal the direct "
            f"engine's request for request; "
            f"{rate_line(got, d['n_decode_steps'])}; direct "
            f"{rate_line(want, want['steps'])}; bursts {min(bursts)}.."
            f"{max(bursts)} ({sum(b > 1 for b in bursts)} tokens in bursts "
            f"> 1); K5 {launches} = {c.layers} x {eager} eager steps, on the "
            f"pump thread, plain 0; stats consistent, {len(fams)} metric "
            f"families with HELP and TYPE; allocator "
            f"{mem['hbm_bytes_in_use'] / 2 ** 20:.1f} MiB in use of "
            f"{mem['hbm_bytes_limit'] / 2 ** 30:.1f} GiB, pools "
            f"{mem['hbm_kv_pool_bytes'] / 2 ** 20:.1f} MiB [{c.smi}]")
        if k == 1:
            c.want1, c.launches1 = want["tokens"], launches
    c.recorded = recorded
    fleet_disturb(c)


def fleet_disturb(c) -> None:
    """Arm (1)'s cancel, deadline, overload and drain on one server (k =
    1, max_queue 0, the step clock): 16 requests fill the slots, a 17th
    is refused queue_full; one is cancelled after its third token, one
    expires FLEET_DEADLINE steps after admission; a drain started with
    requests in flight refuses a late one (draining) and finishes the
    rest with the direct run's tokens."""
    import asyncio

    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.server import ServingServer
    eng = c.srv_eng
    eng.set_decode_steps(1)
    eng.reset_prefix_cache()
    eng.clock = lambda: float(eng.n_decode_steps)
    reqs = serve_requests(32, c.vocab, seed=1, lo=32, hi=256, max_new=64,
                          sampled_every=4)
    srv = ServingServer(eng, max_queue=0)
    host, port = srv.start_background(start_pump=False)
    cancel_id, dead_id = "r5", "r6"
    try:
        with ServingClient(host, port, timeout=600) as cl:
            for r in reqs[:17]:
                cl.submit(r.prompt_ids.tolist(), req_id=f"r{r.req_id}",
                          timeout_s=FLEET_DEADLINE if f"r{r.req_id}" ==
                          dead_id else None, **request_kw(r))
            if not cl.ping():               # every generate answered
                raise AssertionError("[serve-fleet] no pong")
            over = [m for m in cl._pending if m["type"] == "overload"]
            cl._pending = [m for m in cl._pending
                           if m["type"] != "overload"]
            if [(m["id"], m["reason"]) for m in over] != \
                    [("r16", "queue_full")]:
                raise AssertionError(f"[serve-fleet] overload frames {over}")
            srv.start_pump()
            done, streamed = {}, {}
            drain = None
            while sum(i != "late" for i in done) < 16 or (
                    drain is not None and "late" not in done):
                m = cl.recv()
                if m["type"] == "token":
                    streamed[m["id"]] = m["index"]
                    if m["id"] == cancel_id and m["index"] == 2:
                        cl.cancel(cancel_id)
                elif m["type"] == "done":
                    done[m["id"]] = (np.asarray(m["tokens"], np.int32),
                                     m["reason"])
                elif m["type"] == "overload" and m["id"] == "late":
                    done["late"] = (None, m["reason"])
                else:
                    raise AssertionError(f"[serve-fleet] frame {m}")
                if drain is None and {cancel_id, dead_id} <= set(done):
                    drain = asyncio.run_coroutine_threadsafe(srv.drain(),
                                                             srv._loop)
                    # FIFO on the loop: after drain()'s first step
                    if not asyncio.run_coroutine_threadsafe(
                            _draining(srv), srv._loop).result(30):
                        raise AssertionError("[serve-fleet] not draining")
                    inflight = srv._inflight
                    cl.submit(reqs[17].prompt_ids.tolist(), req_id="late",
                              max_new=4)
        if drain is None:
            raise AssertionError("[serve-fleet] the drain never started")
        drain.result(120)
        srv._bg_thread.join(60)
    finally:
        if srv._loop is not None and srv._loop.is_running():
            srv.stop_background(drain=False)
    reasons = {i: why for i, (_, why) in done.items()}
    if reasons.pop(cancel_id) != "cancelled" or \
            reasons.pop(dead_id) != "deadline" or \
            reasons.pop("late") != "draining" or \
            set(reasons.values()) != {"length"}:
        raise AssertionError(f"[serve-fleet] reasons {done}")
    got = {int(i[1:]): t for i, (t, _) in done.items() if t is not None}
    fleet_same("cancel / deadline / drain", got,
               {r.req_id: c.want1[r.req_id] for r in reqs[:16]},
               prefix_ok=(int(cancel_id[1:]), int(dead_id[1:])))
    if srv._pump_error is not None or srv.pump_alive():
        raise AssertionError("[serve-fleet] the pump did not stop cleanly")
    log(f"[serve-fleet] (1) cancel, deadline, overload, drain: r16 "
        f"refused queue_full at 16 in flight (max_queue 0); {cancel_id} "
        f"cancelled after token {streamed.get(cancel_id)} with "
        f"{got[int(cancel_id[1:])].size - reqs[5].prompt_ids.size} tokens, "
        f"{dead_id} expired {FLEET_DEADLINE:g} steps after admission with "
        f"{got[int(dead_id[1:])].size - reqs[6].prompt_ids.size}, both a "
        f"prefix of the direct run's; drain began with {inflight} in "
        f"flight, refused 'late' (draining), finished the rest with the "
        f"direct run's tokens, stopped the pump [{c.smi}]")


async def _draining(srv) -> bool:
    return srv._draining


def fleet_k5_record(c) -> dict:
    """K5 at arm (1)'s recorded layer-0 launches (k = 1, pump thread): the
    first held against its plain version (float32 on the same bf16
    inputs, the pools as it read them), all timed beside the plain
    version and the bound."""
    from paddle_tpu_torch.ops import paged_attention as pa
    if not c.recorded or c.recorded[0][6] is None:
        raise AssertionError("[serve-fleet] no K5 launch recorded")
    q, _, _, table, lengths, row_slot, (k0, v0) = c.recorded[0]
    err = k5_error((q, k0, v0, table, lengths, row_slot),
                   splits=c.srv_eng.splits)
    if not err <= K5_ATOL[torch.bfloat16]:
        raise AssertionError(f"[serve-fleet] K5 against its plain version: "
                             f"{err}")
    launches = [r[:6] for r in c.recorded]
    kern_ms = time_launches(pa.paged_attention, launches)
    plain_ms = time_launches(pa.paged_attention_plain, launches)
    bound = [launch_bytes_flops(a, 2) for a in launches]
    bytes_ms = float(np.mean([b for b, _ in bound])) / HBM_BYTES_PER_S * 1e3
    flops_ms = float(np.mean([f for _, f in bound])) / \
        PEAK_FLOPS[torch.bfloat16] * 1e3
    log(f"[serve-fleet] K5 on the pump thread's first layer-0 launch "
        f"({q.shape[0]} rows, {c.srv_eng.splits} split(s)) against its "
        f"plain version in float32: max abs err {err:.3e} (limit "
        f"{K5_ATOL[torch.bfloat16]:g}); over {len(launches)} recorded "
        f"launches {kern_ms * 1e3:.2f} us/launch, plain "
        f"{plain_ms * 1e3:.2f} us, bound "
        f"{max(bytes_ms, flops_ms) * 1e3:.3f} us [{c.smi}]")
    del c.recorded
    return {"name": "paged_attention [serve-fleet]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_paged.py:104",
            "launches": c.launches1, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def replica_stats(addr) -> tuple:
    from paddle_tpu_torch.serving.client import ServingClient
    with ServingClient(*addr) as cl:
        return cl.stats(), cl.metrics()


def fleet_router(addrs, **kw):
    from paddle_tpu_torch.fleet import FleetRouter
    rt = FleetRouter(port=0, replicas=addrs, poll_interval_s=0.5,
                     heartbeat_misses=100, **kw)
    rt.start_background()
    return rt


def replicas_on_card(what: str, addrs) -> str:
    """Each replica's metrics read the card's allocator (its engine ran
    there) and counted decode steps."""
    out = []
    for a in addrs:
        _, text = replica_stats(a)
        used = metric_value(text, "hbm_bytes_in_use")
        steps = metric_value(text, "serving_decode_steps_total")
        if not (used and used > 0 and steps and steps > 0):
            raise AssertionError(f"[serve-fleet] {what}: replica {a}: "
                                 f"hbm_bytes_in_use {used}, steps {steps}")
        out.append(f"{used / 2 ** 20:.0f} MiB / {steps:.0f} steps")
    return ", ".join(out)


def fleet_affinity(c) -> None:
    """[serve-fleet] 2: the prefix-skew workload (every fourth sampled)
    through FleetRouter(policy="affinity") over two replica subprocesses
    on the card: tokens equal the single-engine run's; the aggregate
    prefix hit rate, sheds and retries (0), tokens/s, first token."""
    addrs = c.addrs[:2]
    direct = c.direct
    direct.set_decode_steps(1)
    direct.reset_prefix_cache()
    want = direct_closed_loop(direct, prefix_requests(c.vocab))
    rt = c.rt = fleet_router(addrs, policy="affinity")
    closed_loop(rt.host, rt.port, serve_requests(
        4, c.vocab, seed=7, lo=8, hi=80, max_new=12, sampled_every=2))
    before = [replica_stats(a)[0] for a in addrs]
    got = closed_loop(rt.host, rt.port, prefix_requests(c.vocab))
    after = [replica_stats(a)[0] for a in addrs]
    fleet_same("affinity", got["tokens"], want["tokens"])
    st = rt._stats_msg()
    hits = sum(a["prefix_hits"] - b["prefix_hits"]
               for a, b in zip(after, before))
    seen = hits + sum(a["prefix_misses"] - b["prefix_misses"]
                      for a, b in zip(after, before))
    routed = [r.routed_total for r in rt.table]
    if st["sheds"] or st["retries"] or min(routed) == 0:
        raise AssertionError(f"[serve-fleet] affinity: sheds {st['sheds']}, "
                             f"retries {st['retries']}, routed {routed}")
    log(f"[serve-fleet] (2) affinity router over 2 replica processes: 64 "
        f"prefix-skew requests at concurrency {FLEET_CONC}, tokens equal "
        f"the single engine's; {rate_line(got)}; single engine "
        f"{rate_line(want, want['steps'])}; prefix hits {hits} of {seen} "
        f"admissions ({hits / max(seen, 1):.1%}); routed {routed} (with 4 "
        f"warm-up requests), placements {st['placements']}, sheds "
        f"{st['sheds']:g}, retries {st['retries']:g}; replicas on the card: "
        f"{replicas_on_card('affinity', addrs)} [{c.smi}]")


def fleet_disagg(c) -> None:
    """[serve-fleet] 3: bench_serving_disagg's workload (the prefix-skew
    prompts, greedy) through a router over a prefill-role and a
    decode-role replica: every prompt prefills on one, kv_pushes its
    committed pages, decodes on the other; pages shipped, no push failure
    or fallback, tokens equal the single engine's; then FLEET_PUSH_PROBE
    prefill_only requests straight to the prefill replica time a push."""
    from paddle_tpu_torch.serving import Request
    from paddle_tpu_torch.serving.client import ServingClient
    addrs = c.addrs[2:4]

    def reqs():
        return [Request(r.req_id, r.prompt_ids, max_new=r.max_new)
                for r in prefix_requests(c.vocab)]

    direct = c.direct
    direct.reset_prefix_cache()
    want = direct_closed_loop(direct, reqs())
    rt = fleet_router(addrs)
    try:
        closed_loop(rt.host, rt.port, serve_requests(      # both legs warm
            4, c.vocab, seed=7, lo=16, hi=80, max_new=12))
        st0 = rt._stats_msg()
        got = closed_loop(rt.host, rt.port, reqs())
        st = rt._stats_msg()
    finally:
        rt.stop_background(drain=True)
    fleet_same("disagg", got["tokens"], want["tokens"])
    n = len(got["tokens"])
    st = {k: st[k] - st0[k] for k in ("kv_pushes", "kv_pages_shipped",
                                      "kv_push_failures", "kv_fallbacks")}
    if not (st["kv_pushes"] == n and st["kv_pages_shipped"] > 0
            and st["kv_push_failures"] == 0 and st["kv_fallbacks"] == 0):
        raise AssertionError(f"[serve-fleet] disagg ledger: {st}")
    push_ms, pages = [], []
    with ServingClient(*addrs[0]) as cl:
        for r in reqs()[:FLEET_PUSH_PROBE]:
            t0 = time.perf_counter()
            rid = cl.submit(r.prompt_ids.tolist(), max_new=1,
                            prefill_only=True,
                            push_to={"host": addrs[1][0],
                                     "port": addrs[1][1]})
            m = cl._route(lambda m: m.get("id") == rid)
            wall = time.perf_counter() - t0
            if m["type"] != "done" or not m.get("push_ok"):
                raise AssertionError(f"[serve-fleet] push probe: {m}")
            push_ms.append(wall * 1e3 - m["timing"]["request_ms"])
            pages.append(m["pushed_pages"])
    per_page = sum(push_ms) / sum(pages)
    log(f"[serve-fleet] (3) disaggregated: {n} requests at concurrency "
        f"{FLEET_CONC}, each prefilled on the prefill replica and decoded "
        f"on the decode replica, tokens equal the single engine's; "
        f"{rate_line(got)}; kv_pushes {st['kv_pushes']:g}, pages shipped "
        f"{st['kv_pages_shipped']:g}, push failures "
        f"{st['kv_push_failures']:g}, fallbacks {st['kv_fallbacks']:g}; a "
        f"push (client wall less the prefill's request_ms) "
        f"{per_page:.3f} ms a page over {sum(pages)} pages in "
        f"{len(pages)} prefill_only requests ({c.direct.kv.page_nbytes} B "
        f"a page); replicas on the card: "
        f"{replicas_on_card('disagg', addrs)} [{c.smi}]")


def fleet_failures(c) -> None:
    """[serve-fleet] 4: through arm (2)'s router, three requests sharing
    a prefix (co-located by affinity); after the first streamed a token
    its replica is SIGKILLed: the two that streamed nothing finish on the
    survivor with the single engine's tokens, the streamed one gets the
    'already streamed' error.  SIGTERM on the survivor drains it and it
    exits 0."""
    import signal

    from paddle_tpu_torch.serving import Request
    from paddle_tpu_torch.serving.client import ServerError, ServingClient
    rt = c.rt
    base = prefix_requests(c.vocab)[1]
    prefix = base.prompt_ids[:128]
    rng = np.random.default_rng(5)
    reqs = [Request(i, np.concatenate([prefix, rng.integers(
        2, c.vocab, 24).astype(np.int32)]), max_new=n)
        for i, n in enumerate((FLEET_KILL_NEW, 64, 32))]
    c.direct.reset_prefix_cache()
    want = c.direct.run(reqs)
    with ServingClient(rt.host, rt.port, timeout=600) as cl:
        ra = cl.submit(reqs[0].prompt_ids.tolist(), max_new=FLEET_KILL_NEW)
        m = cl.recv()
        while m.get("type") != "token":
            m = cl.recv()
        cl._pending.append(m)
        rb = cl.submit(reqs[1].prompt_ids.tolist(), max_new=64, stream=False)
        rc = cl.submit(reqs[2].prompt_ids.tolist(), max_new=32, stream=False)
        if not cl.ping():                # both placed before the pong
            raise AssertionError("[serve-fleet] no pong from the router")
        victim = next((r for r in rt.table if len(r.pending) == 3), None)
        if victim is None:
            raise AssertionError(f"[serve-fleet] kill: not co-located: "
                                 f"{[len(r.pending) for r in rt.table]}")
        vi = c.procs.index_of(victim.port)
        c.procs.procs[vi].send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        out = cl.collect([rb, rc])
        retried_s = time.perf_counter() - t_kill
        try:
            cl.collect([ra])
            raise AssertionError("[serve-fleet] the streamed request was "
                                 "not failed")
        except ServerError as e:
            if "already streamed" not in str(e):
                raise
            err = str(e)
        st = cl.stats()
    for rid, r in ((rb, reqs[1]), (rc, reqs[2])):
        if out[rid]["reason"] != "length" or not np.array_equal(
                np.asarray(out[rid]["tokens"], np.int32), want[r.req_id]):
            raise AssertionError(f"[serve-fleet] retried {rid}: "
                                 f"{out[rid]['reason']}, tokens differ")
    if st["retries"] < 2 or st["replicas_registered"] != 1:
        raise AssertionError(f"[serve-fleet] after the kill: {st}")
    survivor = rt.table.get(st["replicas"][0]["replica"])
    si = c.procs.index_of(survivor.port)
    rt.stop_background(drain=True)
    c.procs.procs[si].send_signal(signal.SIGTERM)
    rc_term = c.procs.procs[si].wait(timeout=120)
    rc_kill = c.procs.procs[vi].wait(timeout=60)
    if rc_term != 0 or rc_kill != -signal.SIGKILL:
        raise AssertionError(f"[serve-fleet] SIGTERM exit {rc_term}, "
                             f"SIGKILL exit {rc_kill}: "
                             f"{c.procs.stderr(si)}")
    log(f"[serve-fleet] (4) replica {victim.rid} SIGKILLed mid-stream: the "
        f"2 requests that had streamed nothing finished on {survivor.rid} "
        f"with the single engine's tokens {retried_s:.2f} s after the kill "
        f"(router retries {st['retries']:g}); the streamed one got "
        f"'{err[:60]}...'; SIGTERM drained {survivor.rid}, exit 0 [{c.smi}]")


def phase_serve_fleet(smi: str) -> list:
    """The RPC front end and the fleet on the card (module docstring,
    phase 4f); returns K5's record at the server's pump-thread launches."""
    vocab, layers = FLEET_MODEL["vocab"], FLEET_MODEL["layers"]
    import signal
    procs = ReplicaProcs(["both", "both", "prefill", "decode"])
    try:
        ex, params = fleet_model()
        c = types.SimpleNamespace(vocab=vocab, layers=layers, smi=smi,
                                  ex=ex, params=params, procs=procs,
                                  addrs=None)

        def settle():
            # the timed runs start once the replicas are up and idle
            if c.addrs is None:
                start = time.perf_counter()
                c.addrs = procs.wait()
                log(f"[serve-fleet] 4 replica processes bound "
                    f"{time.perf_counter() - procs.t0:.1f} s after their "
                    f"start (waited {time.perf_counter() - start:.1f} s "
                    f"of it)")

        c.settle = settle
        start = time.perf_counter()
        fleet_tcp(c)
        record = fleet_k5_record(c)
        log(f"[serve-fleet] (1) fleet_tcp: "
            f"{time.perf_counter() - start:.1f} s [{smi}]")
        for n, fn in enumerate((fleet_affinity, fleet_disagg,
                                fleet_failures), 2):
            start = time.perf_counter()
            fn(c)
            log(f"[serve-fleet] ({n}) {fn.__name__}: "
                f"{time.perf_counter() - start:.1f} s [{smi}]")
        for i in (2, 3):
            procs.procs[i].send_signal(signal.SIGTERM)
            if procs.procs[i].wait(timeout=120) != 0:
                raise AssertionError(f"[serve-fleet] replica {i} exit "
                                     f"{procs.procs[i].returncode}: "
                                     f"{procs.stderr(i)}")
    finally:
        procs.close()
    c.direct = c.srv_eng = None
    torch.cuda.empty_cache()
    return [record]


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


# -- the training features of slice 20: accumulation, evaluators, jobs --------

ACCUM_N = 4                    # (a)'s window: four [2, 2048] micro-batches
ACCUM_LIMIT = {"": 1e-4, "bfloat16": 2.0 ** -6}
ACCUM_KSTEP_N = 3              # windows straddling the k = 4 groups
SENT_EVAL_STEPS = 8
SENT_EVAL_CONFIG = "demo/sentiment/trainer_config.py"
# the sentiment net of [sentiment] with the new evaluators appended to its
# config's text: the net's output bound to `output`, then a label, a weight
# and a query id, the cost, and AUC (weighted), precision/recall, pnpair
# (weighted), an auc-validation layer and a gradient printer
SENT_EVAL_APPEND = """
label = data_layer("label", 2)
weight = data_layer("weight", 1)
qid = data_layer("qid", 16)
outputs(classification_cost(input=output, label=label))
auc_evaluator(input=output, label=label, weight=weight, name="auc")
precision_recall_evaluator(input=output, label=label, name="pr")
pnpair_evaluator(input=output, label=label, info=qid, weight=weight,
                 name="pnpair")
auc_validation(input=output, label=label, name="val_auc")
gradient_printer_evaluator(input=output, name="grad")
"""
# a CLI run in a subprocess: its flags as argv, then one line of the
# wrappers' launch counts on stdout
CLI_DRIVER = """
import json, sys
from paddle_tpu_torch.trainer_main import main
from paddle_tpu_torch.ops import flash_attention as fa, lstm_fused as lf
rc = main(sys.argv[1:])
print("COUNTS " + json.dumps({
    "lstm_fwd": lf.counts.fwd, "lstm_bwd": lf.counts.bwd,
    "lstm_plain": lf.counts.plain, "flash_fwd": fa.counts.fwd,
    "flash_bwd_dq": fa.counts.bwd_dq, "flash_bwd_dkv": fa.counts.bwd_dkv,
    "flash_tc": fa.counts.fwd_tc + fa.counts.bwd_dq_tc + fa.counts.bwd_dkv_tc,
    "flash_plain": fa.counts.plain}), flush=True)
sys.exit(rc)
"""
LM_CHECKGRAD_ARGS = ("vocab=32000,dim=512,layers=2,heads=8,batch_size=2,"
                     "block_k_min=16")


def accum_window(dtype: str, smi: str) -> tuple:
    """(a) N = 4 micro-batches of [2, 2048] at full width in `dtype` ('' =
    the config's float32), after a warm-up window: the mean gradient the
    second window's update consumes against one step's gradient on its
    four concatenated (at the parameters the warm-up left), within
    ACCUM_LIMIT of each parameter's largest; K4's three kernels 8 per
    micro-step each, counted by the wrappers, nothing else of flash
    attention; one update, after the fourth.  Returns ({kernel: launches}
    of the timed window, its ms per micro-step)."""
    from paddle_tpu_torch.models import transformer_lm_trainer_config
    from paddle_tpu_torch.trainer import Trainer
    layers, B, T = 8, 2, 2048
    warm, cat = lm_batches(2, ACCUM_N * B, T, 32000, seed=11)

    def split(batch):
        return [{k: a.replace(ids=a.ids[i * B:(i + 1) * B],
                              lengths=a.lengths[i * B:(i + 1) * B])
                 for k, a in batch.items()} for i in range(ACCUM_N)]
    micro = split(cat)
    cfg = transformer_lm_trainer_config(vocab=32000, dim=512, layers=layers,
                                        heads=8, batch_size=B,
                                        compute_dtype=dtype)
    cfg.opt_config.num_batches_per_send_parameter = ACCUM_N
    tr = Trainer(cfg, seed=1)
    for b in split(warm):
        tr.train_one_batch(b)
    start = {n: p.clone() for n, p in tr.params.items()}
    consumed = {}
    window_mean = tr.updater.window_mean

    def keep(summed, n):
        consumed["mean"] = window_mean(summed, n)
        return consumed["mean"]
    tr.updater.window_mean = keep
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = []
    for b in micro:
        c0 = flash_counts()
        tr.train_one_batch(b)
        steps.append(tuple(x - y for x, y in zip(flash_counts(), c0)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / ACCUM_N
    route = (layers,) * 3 + (0,) * 4 if dtype else (0,) * 3 + (layers,) * 3 \
        + (0,)
    counts = dict(zip(FLASH_COUNTS, map(sum, zip(*steps))))
    moved = [n for n, p in tr.params.items() if not torch.equal(p, start[n])]
    cfg1 = transformer_lm_trainer_config(vocab=32000, dim=512, layers=layers,
                                         heads=8, batch_size=ACCUM_N * B,
                                         compute_dtype=dtype)
    ref = Trainer(cfg1, params=start)
    _, grads, _ = ref.compute_gradients(ref.prepare_batch(cat))
    worst, worst_name = 0.0, ""
    for n, g in grads.items():
        e = float((consumed["mean"][n] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        if e > worst:
            worst, worst_name = e, n
    what = dtype or "float32"
    log(f"[train-jobs] (a) {what}: N={ACCUM_N} micro-batches of [{B}, {T}] "
        f"at full width, after a warm-up window {ms:.2f} ms per micro-step "
        f"(wall, eager); the window's mean "
        f"gradient against one step on the [{ACCUM_N * B}, {T}] "
        f"concatenation: worst {worst:.2e} of a parameter's largest "
        f"({worst_name}; limit {ACCUM_LIMIT[dtype]:.2e}); flash launches "
        f"per micro-step {dict(zip(FLASH_COUNTS, steps[0]))}; updates "
        f"{tr.opt_state['num_updates']} (one a window), parameters moved by "
        f"the second {len(moved)} of "
        f"{len(start)} [{smi}]")
    if any(s != route for s in steps):
        raise AssertionError(f"(a) {what}: flash launches {steps}, want "
                             f"{route} a micro-step")
    if not (worst <= ACCUM_LIMIT[dtype] and set(consumed["mean"]) >= set(
            grads) and tr.opt_state["num_updates"] == 2 and moved):
        raise AssertionError(f"(a) {what}: the accumulated update is not "
                             f"the concatenated batch's")
    del tr, ref, grads, consumed, start
    torch.cuda.empty_cache()
    suffix = "_tc" if dtype else ""
    return {f"flash_{k}{suffix}": counts[k + suffix]
            for k in ("fwd", "bwd_dq", "bwd_dkv")}, ms


def accum_kstep(smi: str) -> dict:
    """(a) N = 3 at k = 4 against k = 1 over 12 bf16 micro-batches of
    [2, 2048] (windows straddle the groups), then a second pass of 12 each:
    losses, statistics, parameters, slots, counters, the window's sums bit
    for bit; ms per micro-step of the second pass at k = 1 and 4 and of
    the plain (N = 1) step."""
    from paddle_tpu_torch.models import transformer_lm_trainer_config
    from paddle_tpu_torch.trainer import Trainer

    def make(n):
        cfg = transformer_lm_trainer_config(vocab=32000, dim=512, layers=8,
                                            heads=8, batch_size=2,
                                            compute_dtype="bfloat16")
        cfg.opt_config.num_batches_per_send_parameter = n
        return Trainer(cfg, seed=1)
    batches = lm_batches(24, 2, 2048, 32000, seed=12)
    t1, tk, plain = make(ACCUM_KSTEP_N), make(ACCUM_KSTEP_N), make(1)
    ms, same = {}, True
    for half in (batches[:12], batches[12:]):
        got = {}
        for name, tr, k in (("k=1", t1, 1), (f"k={KSTEP}", tk, KSTEP),
                            ("plain", plain, 1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = pass_with_losses(tr, half, k)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3 / len(half)
        (s1, l1), (sk, lk) = got["k=1"], got[f"k={KSTEP}"]
        differ = training_state_differs(t1, tk)
        same &= s1 == sk and torch.equal(l1, lk) and not differ
    log(f"[train-jobs] (a) N={ACCUM_KSTEP_N}, bf16 [2, 2048]: k={KSTEP} "
        f"against k=1 over two passes of 12 micro-steps: "
        f"{'bit-identical' if same else 'DIFFER: ' + str(differ[:5])} "
        f"(losses, statistics, parameters, slots, counters, window sums; "
        f"{tk.n_fused_dispatches} group dispatches, graphs by group size "
        f"{graph_replays(tk)}); the second pass {ms['k=1']:.2f} ms per "
        f"micro-step at k=1, {ms[f'k={KSTEP}']:.2f} at k={KSTEP}, the "
        f"plain step (N=1) {ms['plain']:.2f} [{smi}]")
    if not same or not any(graph_replays(tk).values()):
        raise AssertionError(f"(a) accumulation at k={KSTEP} is not "
                             f"bit-identical to k=1")
    del t1, tk, plain
    torch.cuda.empty_cache()
    return ms


def sentiment_eval_config(root: str):
    """demo/sentiment/trainer_config.py with SENT_EVAL_APPEND appended and
    the net's output bound to `output` (parsed with is_predict=1, the net
    without its own head, and dict_dim=30000 as [sentiment]): returns its
    path."""
    with open(SENT_EVAL_CONFIG) as f:
        text = f.read()
    call = "    stacked_lstm_net(dict_dim,"
    if text.count(call) != 1:
        raise AssertionError("the sentiment config's text changed")
    text = text.replace(call, "    output = stacked_lstm_net(dict_dim,")
    text = text.replace('os.path.dirname(os.path.abspath(__file__))',
                        repr(os.path.abspath("demo/sentiment")))
    path = os.path.join(root, "sentiment_eval.py")
    with open(path, "w") as f:
        f.write(text + SENT_EVAL_APPEND)
    return path


def sentiment_eval_batches(n: int, seed: int) -> list:
    """[sentiment]'s [128, 100] batches with a weight in [0.5, 2) and a
    query id of 16 per row."""
    from paddle_tpu_torch.parameter import Argument
    rng = np.random.default_rng(seed)
    out = []
    for b in sentiment_batches(n, 128, 100, 30000, seed=seed):
        B = b["word"].ids.shape[0]
        b["weight"] = Argument(value=rng.uniform(0.5, 2.0, (B, 1))
                               .astype(np.float32))
        b["qid"] = Argument(ids=rng.integers(0, 16, B).astype(np.int32))
        out.append(b)
    return out


def sentiment_evaluators(smi: str, root: str) -> tuple:
    """(b) The sentiment net at [128, 100] (K3) with the new evaluators:
    the pass's results on the card equal the CPU evaluators' on the same
    fetched outputs (the card's outputs each step, read back), and k = 4
    equals k = 1 bit for bit (results, parameters, slots); the AUC
    evaluator's device time per step.  Returns ({kernel: launches} of the
    k = 1 pass, the AUC's ms per step)."""
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.parameter import Argument
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer.evaluators import (EvaluatorSet,
                                                     evaluator_registry)
    cfg = parse_config(sentiment_eval_config(root),
                       "dict_dim=30000,is_predict=1")
    batches = sentiment_eval_batches(SENT_EVAL_STEPS, seed=21)
    t1, tk = Trainer(cfg, seed=1), Trainer(cfg, seed=1)
    fetched = []
    update = t1.evaluators.host_update

    def keep(state, outputs):
        fetched.append({n: Argument(value=None if a.value is None
                                    else a.value.cpu(),
                                    ids=None if a.ids is None
                                    else a.ids.cpu())
                        for n, a in outputs.items()})
        return update(state, outputs)
    t1.evaluators.host_update = keep
    reset_counts()
    s1, l1 = pass_with_losses(t1, batches, 1)
    torch.cuda.synchronize()
    launches = {"lstm_fwd": op_counts("lstm_fused").fwd,
                "lstm_bwd": op_counts("lstm_fused").bwd}
    plain = plain_calls()
    sk, lk = pass_with_losses(tk, batches, KSTEP)
    differ = training_state_differs(t1, tk)
    cpu = EvaluatorSet(cfg.model_config)
    acc, host = {}, cpu.new_host_state()
    for outputs in fetched:
        acc = cpu.accumulate(acc, cpu.batch_partials(outputs, {}))
        cpu.host_update(host, outputs)
    want = cpu.finalize(acc)
    want.update(cpu.finalize_host(host))
    got = {k: v for k, v in s1.items() if k in want}
    results = sorted(k for k in want if k != "classification_error")
    log(f"[train-jobs] (b) sentiment [128, 100] with auc (weighted), "
        f"precision_recall, pnpair (weighted), auc-validation and a "
        f"gradient printer, {SENT_EVAL_STEPS} steps: on the card "
        + ", ".join(f"{k}={s1[k]:.6f}" for k in results)
        + f"; the CPU evaluators on the fetched outputs "
        f"{'equal' if got == want else 'DIFFER: ' + str(want)}; k={KSTEP} "
        f"against k=1: statistics {'equal' if sk == s1 else 'DIFFER'}, "
        f"losses {'bit-identical' if torch.equal(l1, lk) else 'DIFFER'}, "
        f"state {'DIFFER: ' + str(differ[:4]) if differ else 'bit-identical'}"
        f"; lstm launches {launches}, plain calls {plain}")
    if not (got == want and sk == s1 and torch.equal(l1, lk) and not differ
            and len(want) >= 10 and not any(plain.values())
            and launches["lstm_fwd"] == 3 * SENT_EVAL_STEPS
            and launches["lstm_bwd"] == 3 * SENT_EVAL_STEPS):
        raise AssertionError("(b) the evaluators on the card disagree with "
                             "the CPU's or k=4 with k=1")
    auc_cfg = next(c for c in t1.evaluators.configs if c.name == "auc")
    outputs = {n: Argument(value=None if a.value is None else a.value.cuda(),
                           ids=None if a.ids is None else a.ids.cuda())
               for n, a in fetched[0].items()}
    auc_ms = time_call(lambda: evaluator_registry["auc"][0](
        auc_cfg, outputs, {}), 50)
    log(f"[train-jobs] (b) the AUC evaluator's histograms at [128, 2] with "
        f"weights: {auc_ms * 1e3:.1f} us per step on the card [{smi}]")
    del t1, tk
    torch.cuda.empty_cache()
    return launches, auc_ms


def cli_procs(runs: dict, root: str) -> dict:
    """Each run ({tag: argv}) of the port's CLI in a subprocess of its
    own, started together; waits for all: {tag: (exit code, stdout,
    stderr, seconds, the wrappers' counts)}."""
    procs = {}
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    for tag, argv in runs.items():
        out = open(os.path.join(root, f"{tag}.out"), "w+")
        err = open(os.path.join(root, f"{tag}.err"), "w+")
        p = subprocess.Popen([sys.executable, "-c", CLI_DRIVER, *argv],
                             stdout=out, stderr=err, env=env)
        procs[tag] = (p, out, err, time.perf_counter())
    res = {}
    try:
        for tag, (p, out, err, t0) in procs.items():
            rc = p.wait(timeout=600)
            dt = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
            counts = [json.loads(ln[7:]) for ln in stdout.splitlines()
                      if ln.startswith("COUNTS ")]
            res[tag] = (rc, stdout, stderr, dt, counts[0] if counts else {})
    finally:
        for p, out, err, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
    return res


def cli_expect(tag: str, res: tuple, rc: int, text: str) -> str:
    """The run's exit code is rc and its log holds `text`; returns the
    first log line holding it."""
    code, _, err, _, _ = res
    lines = [ln for ln in err.splitlines() if text in ln]
    if code != rc or not lines:
        found = "found" if lines else "not in the log"
        raise AssertionError(f"[train-jobs] (c) {tag}: exit {code} (want "
                             f"{rc}), {text!r} {found}:\n{err[-3000:]}")
    return lines[0]


def poisoned_sentiment(root: str) -> tuple:
    """demo/sentiment/trainer_config.py's starting parameters (seed 1) with
    NaN in the first column of the word embedding, saved: (the pass
    directory, the embedding layer's name)."""
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.trainer import Trainer
    tr = Trainer(parse_config(SENT_EVAL_CONFIG, ""), seed=1)
    layer = next(l for l in tr.model.layers if l.inputs
                 and l.inputs[0].input_parameter_name)
    name = layer.inputs[0].input_parameter_name
    tr.params[name][:, 0] = float("nan")
    path = tr.save(os.path.join(root, "poisoned"))
    del tr
    return path, layer.name


def cli_jobs(smi: str, root: str) -> dict:
    """(c) The CLI in subprocesses: --job=checkgrad on the sentiment config
    (K3) and on the LM at full width, 2 layers, fp32 (K4's float32
    kernels), both exit 0 and their wrappers count those launches;
    --detect_nan from a checkpoint whose embedding holds NaN: exit 1 and
    the embedding layer named; two train passes at k = 4 with
    --show_parameter_stats_period=2 and --save_dir: the stats logged,
    metrics.jsonl with the registry snapshot, trainer.train_step and
    trainer.fused_step among its compile sites, the device-memory gauges;
    then alone --job=time with --profile_dir: samples/s, and the trace
    names lstm_fwd_kernel.  Returns the figures PERF.md reads."""
    poisoned, emb = poisoned_sentiment(root)
    sent = f"--config={SENT_EVAL_CONFIG}"
    save = os.path.join(root, "save")
    runs = cli_procs({
        "checkgrad-sentiment": [sent, "--job=checkgrad"],
        "checkgrad-lm": ["--config=demo/model_zoo/transformer_lm.py",
                         f"--config_args={LM_CHECKGRAD_ARGS}",
                         "--job=checkgrad"],
        "detect_nan": [sent, "--detect_nan", f"--init_model_path={poisoned}",
                       "--num_passes=1"],
        "train": [sent, "--num_passes=2", f"--save_dir={save}",
                  f"--steps_per_dispatch={KSTEP}",
                  "--show_parameter_stats_period=2"]}, root)
    out = {}
    for tag in ("checkgrad-sentiment", "checkgrad-lm"):
        line = cli_expect(tag, runs[tag], 0, "checkgrad: ")
        counts = runs[tag][4]
        worst = float(line.split("max_rel_err=")[1])
        out[tag] = (worst, runs[tag][3])
        log(f"[train-jobs] (c) --job={tag}: exit 0 in {runs[tag][3]:.1f} s; "
            f"{line.split('] ')[-1]}; wrapper counts {counts} [{smi}]")
        kern = (("lstm_fwd", "lstm_bwd") if tag.endswith("sentiment")
                else ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        if not (all(counts.get(k) for k in kern) and not counts.get(
                "lstm_plain") and not counts.get("flash_plain")
                and not counts.get("flash_tc")):
            raise AssertionError(f"(c) {tag} did not run through its "
                                 f"kernels: {counts}")
    line = cli_expect("detect_nan", runs["detect_nan"], 1,
                      f"first non-finite output at layer {emb!r}")
    log(f"[train-jobs] (c) --detect_nan from a checkpoint with NaN in the "
        f"embedding: exit 1, {line.split('] ')[-1][:160]}")
    stats = [ln for ln in runs["train"][2].splitlines()
             if "param " in ln and "mean_abs=" in ln]
    cli_expect("train", runs["train"], 0, "pass 1 done")
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rec = [json.loads(ln) for ln in f][-1]
    m = rec.get("metrics", {})
    sites = sorted({k.split('"')[1] for k in m
                    if k.startswith("jit_compiles_total{")})
    log(f"[train-jobs] (c) train at k={KSTEP} with "
        f"--show_parameter_stats_period=2: {len(stats)} parameter stats "
        f"lines; metrics.jsonl: {len(m)} samples, compile sites {sites}, "
        f"hbm_live_array_bytes {m.get('hbm_live_array_bytes')}")
    if not (stats and {"trainer.train_step", "trainer.fused_step"} <= set(
            sites) and m.get("trainer_pass_id") == 2.0
            and "hbm_live_array_bytes" in m):
        raise AssertionError(f"(c) the train run's stats or metrics.jsonl "
                             f"fell short: {sorted(m)[:20]}")
    prof = os.path.join(root, "prof")
    timed = cli_procs({"time": [sent, "--job=time",
                                f"--profile_dir={prof}"]}, root)["time"]
    line = cli_expect("time", timed, 0, "benchmark: ")
    with open(os.path.join(prof, "trace.json")) as f:
        trace = f.read()
    named = bool(re.search(r"(?<!\w)lstm_fwd_kernel(?!\w)", trace))
    out["time"] = float(line.split("benchmark: ")[1].split()[0])
    log(f"[train-jobs] (c) --job=time --profile_dir: exit 0, "
        f"{line.split('] ')[-1]} (under the profiler); the trace "
        f"({len(trace) / 1e6:.1f} MB) {'names' if named else 'LACKS'} "
        f"lstm_fwd_kernel [{smi}]")
    if not named:
        raise AssertionError("(c) the profiler trace lacks lstm_fwd_kernel")
    return out


def k3_records(launches: dict, smi: str, tag: str) -> list:
    """The two LSTM kernels at the sentiment net's shape ([128, 100, 128],
    relu cell, peepholes) against their plain version, then timed beside
    their bound, the plain version and a cuDNN LSTM of the same sizes (as
    lstm_records, without its plans and phase split)."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    B, T, D = 128, 100, 128
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    names = ("relu", "sigmoid", "tanh")
    acts = dict(active_type="relu", gate_active_type="sigmoid",
                state_active_type="tanh")
    inputs, cot = lstm_inputs(g, B, T, D, True, False)
    inputs = move_off_relu_kink(inputs, False, **acts)
    errs = lstm_compare(inputs, cot, False, **acts)
    if not max(r for _, r in errs.values()) <= LSTM_TOL:
        raise AssertionError(f"{tag}: lstm kernels disagree: {errs}")
    err = {"lstm_fwd": max(errs[n][0] for n in LSTM_NAMES[:3]),
           "lstm_bwd": max(errs[n][0] for n in LSTM_NAMES[3:])}
    x4, lens, w, peeps, h0, c0 = inputs
    hs, cs, gates = lf.lstm_fwd_kernel(x4, lens, w, peeps, h0, c0, names,
                                       False, save_gates=True)
    ms = {"lstm_fwd": time_call(lambda: lf.lstm_fwd_kernel(
              x4, lens, w, peeps, h0, c0, names, False, save_gates=True), 20),
          "lstm_bwd": time_call(lambda: lf.lstm_bwd_kernel(
              lens, w, peeps, h0, c0, hs, cs, gates, *cot, names, False), 20)}
    leaves = [t.clone().requires_grad_(True) for t in (x4, w, peeps, h0, c0)]

    def plain_fwd():
        return lf.lstm_fused_plain(leaves[0], lens, *leaves[1:], **acts)
    plain = {"lstm_fwd": time_call(plain_fwd, 3)}
    y = plain_fwd()
    loss = sum((o * c).sum() for o, c in zip(y, cot))
    plain["lstm_bwd"] = time_call(lambda: torch.autograd.grad(
        loss, leaves, retain_graph=True), 3)
    cudnn = torch.nn.LSTM(4 * D, D, batch_first=True).cuda()
    xin = x4.clone().requires_grad_(True)
    with torch.no_grad():
        lib = {"lstm_fwd": time_call(lambda: cudnn(xin), 10)}
    yc, _ = cudnn(xin)
    lib["lstm_bwd"] = time_call(lambda: torch.autograd.grad(
        yc, [xin, *cudnn.parameters()], cot[0], retain_graph=True), 10)
    work = lstm_work(float(lens.sum()), B, T, D)
    records = []
    for name, src_line in (("lstm_fwd", 66), ("lstm_bwd", 99)):
        nbytes, flops = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        log(f"{tag} {name} at [{B}, {T}, {D}]: {ms[name] * 1e3:.1f} "
            f"us/launch, bound {bound_ms * 1e3:.1f} us, plain "
            f"{plain[name] * 1e3:.1f} us, cuDNN LSTM {lib[name] * 1e3:.1f} "
            f"us; error {err[name]:.2e}; launches {launches[name]} [{smi}]")
        records.append({
            "name": f"{name} [{B}, {T}, {D}] train-jobs", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lstm.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{src_line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain[name], "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": lib[name]})
    return records


def phase_train_jobs(smi: str) -> list:
    """The training features: (a) gradient accumulation on the LM at full
    width in float32 and bf16 (K4) and at k = 4; (b) the sentiment net
    (K3) with the new evaluators; (c) the CLI's jobs and flags in
    subprocesses.  Returns the K4 records at (a)'s shape (both dtypes,
    with (a)'s launches) and the K3 records with (b)'s."""
    import tempfile
    records = []
    for dtype in ("", "bfloat16"):
        launches, _ = accum_window(dtype, smi)
        recs = flash_records(launches, 2, 2048, torch.bfloat16 if dtype
                             else torch.float32, smi, "[train-jobs]")
        for r in recs:
            if not r["name"].endswith("]"):
                r["name"] += " [2, 2048, 8, 64]"
            r["name"] += f" accumulated, N={ACCUM_N}"
        records += recs
    accum_kstep(smi)
    with tempfile.TemporaryDirectory() as root:
        launches, _ = sentiment_evaluators(smi, root)
        records += k3_records(launches, smi, "[train-jobs]")
        torch.cuda.empty_cache()
        cli_jobs(smi, root)
    return records


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
# L2 every step), a batch of 1,000 rows (clusters in several waves) and the
# SRL net's (150 rows at the smallest hidden size the kernels take)
LSTM_SHAPES = ((128, 100, 128), (5, 7, 32), (64, 20, 256), (32, 12, 512),
               (1000, 12, 128), (150, 32, 32))


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
        same &= torch.equal(fresh.rng, tr.rng)
        log(f"[sentiment] checkpoint save -> fresh Trainer.load: "
            f"parameters, Adam slots, counters and the threefry key "
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


def lstm_work(valid: float, B: int, T: int, D: int) -> dict:
    """{kernel: (bytes, flops)} the LSTM kernels' work needs for B rows of
    T padded steps at hidden size D, `valid` of the steps within their
    rows' lengths: every valid step is one [D] x [D, 4D] product per row in
    the forward and two in the backward (dx4 W^T from the saved gates,
    h_prev^T dx4); bytes: x4 of the valid steps and the small operands
    read, hs and cs of every step and the gates of the valid steps written
    (forward); the gates of the valid steps, cs, hs and the cotangents
    read, dx4 and the small gradients written (backward)."""
    step, small = 4.0 * D * 4, 4.0 * (D * 4 * D + 3 * D + 2 * B * D + B)
    return {"lstm_fwd": (2 * valid * step + small + 2 * B * T * D * 4,
                         2.0 * valid * D * 4 * D),
            "lstm_bwd": (valid * step + 3 * B * T * D * 4 + B * T * step
                         + 2 * small, 4.0 * valid * D * 4 * D)}


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
    valid = float(lens.sum())
    step, small = 4.0 * D * 4, 4.0 * (D * 4 * D + 3 * D + 2 * B * D + B)
    work = lstm_work(valid, B, T, D)
    # the earlier design's count, beside it: three products a valid step
    # in the backward (the gates recomputed), no gates in the forward's
    # bytes
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
    """The arrays of two checkpoints (parameters, optimizer state, layer
    state, the threefry key) that are not bit-identical, by name."""
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    da, db = ckpt.load_checkpoint(a), ckpt.load_checkpoint(b)
    bad = []
    for part in ("params", "opt", "net", "rng"):
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
def recorded_inputs(when=None):
    """Within: each wrapper of CLI_WRAPPERS keeps a copy of its arguments
    at the first call of each signature (its tensors' shapes and dtypes,
    its other arguments) for which when(attribute, args, kwargs) holds
    (every call without `when`), then runs as it would.  Yields
    {(attribute, signature): (args, kwargs)}."""
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
            if key not in seen and (when is None or when(_attr, args, kw)):
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


def pass_statistics(row: dict) -> dict:
    """A metrics.jsonl row without its times and the registry snapshot (the
    host's phases, compile events and memory: not training results)."""
    return {n: v for n, v in row.items()
            if n not in ("ts", "seconds", "samples_per_sec", "metrics")}


def cli_pair(tag: str, path: str, args: str, train_route, test_route,
             out: str, smi: str = "", extra: tuple = ()) -> dict:
    """`python -m paddle_tpu_torch train --config=path --config_args=args
    --num_passes=1` (and the flags `extra`) in this process at
    --steps_per_dispatch=1 and KSTEP (cli_run: KSTEP under torch.profiler,
    k = 1 timed alone), the counts set to 0 before each: exit 0, the
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
                        f"--steps_per_dispatch={k}", "--log_period=100000",
                        *extra])

        reset_counts()
        rc, wall, kernels = cli_run(train, k)
        busy, busy_txt = busy_text(kernels, wall)
        if rc != 0:
            raise AssertionError(f"[cli] {tag} k={k}: exit code {rc}")
        line = check_launches(f"[cli] {tag} k={k}", kernels, want, k > 1)
        with open(os.path.join(save, "metrics.jsonl")) as f:
            row = json.loads(f.readline())
        runs[k] = dict(row=row, save=save, wall_ms=wall,
                       busy=None if busy is None else busy / wall,
                       counted=wrapper_counts(want))
        log(f"[cli] {tag} k={k}: {row['batches']} batches, "
            f"{row['samples']} samples, cost {row['cost']:.5g}; "
            f"{row['samples_per_sec']:.1f} samples/s over the pass (the "
            f"provider's load, the first step of each shape and the "
            f"captures included); the whole call (parse, init, pass, test "
            f"pass of {len(test_b)} batches, checkpoint) {wall / 1e3:.2f} "
            f"s, {busy_txt}; {line} [{smi}]")
    stats = [pass_statistics(runs[k]["row"]) for k in (1, KSTEP)]
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
    samples/s, the top device operations."""
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
    log(f"[cli] {tag} steady pass top device operations: "
        f"{top_ops(kernels)} [{smi}]")
    del tr
    return out


def cli_test_round_trip(tag: str, path: str, args: str, save: str,
                        cfg, extra: tuple = ()) -> dict:
    """--job=test --init_model_path=<save>/pass-00000 (and the flags
    `extra`): exit 0, and the statistics it logs are those of a Trainer
    here that load()s the checkpoint (its parameters and layer state the
    saved arrays bit for bit) and test()s, exactly."""
    from paddle_tpu_torch.__main__ import main as cli
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    ck = os.path.join(save, "pass-00000")
    with logged("paddle_tpu_torch.main") as rec:
        rc = cli(["train", f"--config={path}", f"--config_args={args}",
                  "--job=test", f"--init_model_path={ck}", *extra])
    if rc != 0:
        raise AssertionError(f"[cli] {tag} --job=test: exit code {rc}")
    got = [r.args for r in rec if r.getMessage().startswith("test result")]
    tr = Trainer(cfg, seed=1)
    tr.load(ck)
    data = ckpt.load_checkpoint(ck)
    saved, net = data["params"], data["net"]
    saved_net = dict(state_leaves(net, "net"))
    same = all(np.array_equal(tr.params[n].cpu().numpy(), saved[n])
               for n in saved) and tr.net_state.keys() == net.keys() and all(
        np.array_equal(v.cpu().numpy(), saved_net[n])
        for n, v in state_leaves(tr.net_state, "net"))
    want = tr.test()
    log(f"[cli] {tag} --job=test --init_model_path: {got[0] if got else None}"
        f"; loaded parameters{' and the moving statistics of ' + str(len(net)) + ' layers' if net else ''} {'equal' if same else 'DIFFER from'} the "
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


# the [image] runs: (tag, config file, --config_args); each at its
# defaults otherwise (VGG batch 128, ResNet-50 at 224 x 224, 1000 classes,
# batch 64), fp32 unless it says bfloat16
IMAGE_RUNS = (
    ("cifar", "demo/image_classification/vgg_16_cifar.py", ""),
    ("cifar-bf16", "demo/image_classification/vgg_16_cifar.py",
     "compute_dtype=bfloat16"),
    ("mnist", "demo/mnist/vgg_16_mnist.py", ""),
    ("resnet50", "demo/model_zoo/resnet.py", ""),
)
# no hand-written kernel lies on the image path: each must launch 0 times
NO_KERNELS = {sym: 0 for sym in KERNEL_COUNTERS}
# batches of the [image] and [tagging] steady passes at most (the first of
# the feeder's): enough for every group of KSTEP to be a replay, and few
# enough that the profiler's passes stay short
STEADY_BATCHES = 16


def image_batches(n: int, B: int, C: int, size: int, seed: int,
                  classes: int = 10) -> list:
    """n batches {"image": [B, C*size*size] rows, "label": [B] ids} of
    class templates plus noise (the demo providers' synthetic data)."""
    from paddle_tpu_torch.parameter import Argument

    rng = np.random.default_rng(seed)
    dim = C * size * size
    templates = rng.random((classes, dim), dtype=np.float32)
    out = []
    for _ in range(n):
        y = rng.integers(0, classes, B)
        x = 0.6 * templates[y] + 0.4 * rng.random((B, dim), dtype=np.float32)
        out.append({"image": Argument(value=x - 0.5),
                    "label": Argument(ids=y.astype(np.int32))})
    return out


def top_ops(kernels, n: int = 5) -> str:
    """The n device operations that take the most time: ms, launches,
    share of the device time, name."""
    busy = sum(dev_us(e) for e in kernels) or 1.0
    return "; ".join(
        f"{dev_us(e) / 1e3:.2f} ms {e.count}x {dev_us(e) / busy:.1%} "
        f"{e.key[:60]}"
        for e in sorted(kernels, key=dev_us, reverse=True)[:n])


def image_steady(tag: str, cfg, save: str, batches: list, smi: str) -> dict:
    """The path past its first passes, per k in (1, KSTEP): a Trainer here
    on the checkpoint the CLI's k = 1 run saved, passes over `batches`
    (the feeder's first STEADY_BATCHES, assembled beforehand, so the
    provider is not timed) until
    every group is a replay, then one under the profiler: wall and device
    ms/step, busy share, samples/s, the top device operations, and the
    peak memory of the trainer's passes (torch.cuda.max_memory_allocated
    from a reset before the trainer was built)."""
    from paddle_tpu_torch.trainer import Trainer

    out = {}
    for k in (1, KSTEP):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, seed=1)
        tr.load(os.path.join(save, "pass-00000"))
        for _ in range(1 if k == 1 else 2):
            tr.train_one_pass(batches, steps_per_dispatch=k)
        reset_counts()
        stats, wall, kernels, calls = profiled(
            lambda: tr.train_one_pass(batches, steps_per_dispatch=k))
        line = check_launches(f"[image] {tag} steady k={k}", kernels,
                              NO_KERNELS, k > 1, NO_KERNELS)
        n = len(batches)
        busy = sum(dev_us(e) for e in kernels) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[k] = dict(dev_ms=busy / n, wall_ms=wall / n, busy=busy / wall,
                      per_s=stats["samples_per_sec"], calls=calls / n,
                      kernels=sum(e.count for e in kernels) / n, peak=peak)
        o = out[k]
        log(f"[image] {tag} steady k={k} ({n} batches, "
            f"{'every group a replay' if k > 1 else 'eager'}): "
            f"{o['wall_ms']:.2f} ms/step wall, {o['dev_ms']:.3f} device "
            f"ms/step, busy {o['busy']:.1%}, {o['per_s']:.1f} samples/s, "
            f"{o['kernels']:.0f} kernels and {o['calls']:.1f} host launch "
            f"calls a step, peak memory {peak:.2f} GiB; {line} [{smi}]")
        log(f"[image] {tag} steady k={k} top device operations: "
            f"{top_ops(kernels)} [{smi}]")
        if k > 1 and not any(graph_replays(tr).values()):
            raise AssertionError(f"[image] {tag}: no graph replayed")
        if k > 1:
            # measurement only: the same replayed pass with cuDNN free to
            # pick its nondeterministic algorithms (captured anew)
            tr.cudnn_deterministic = False
            tr._graphs.clear()
            tr.train_one_pass(batches, steps_per_dispatch=k)
            _, wall, kernels, _ = profiled(
                lambda: tr.train_one_pass(batches, steps_per_dispatch=k))
            free = sum(dev_us(e) for e in kernels) / 1e3 / n
            o["free_dev_ms"] = free
            log(f"[image] {tag} steady k={k}, cuDNN not held to "
                f"deterministic algorithms (measurement only): {free:.3f} "
                f"device ms/step, {wall / n:.2f} wall; determinism costs "
                f"{o['dev_ms'] - free:+.3f} ms/step "
                f"({o['dev_ms'] / free - 1:+.1%}) [{smi}]")
        del tr
    return out


def image_pair(tag: str, path: str, args: str, out: str, smi: str) -> dict:
    """`python -m paddle_tpu_torch train --config=path --config_args=args
    --num_passes=1` in this process at --steps_per_dispatch=1 and KSTEP
    (cli_run), the counts set to 0 before each: exit 0, no
    hand-written kernel and no plain version; the two runs' pass
    statistics and checkpoints (parameters, momentum slots, every batch
    norm's moving mean, variance and count, dropout generator)
    bit-identical; then --job=test --init_model_path of the k = 1
    checkpoint (the moving statistics loaded and read) equal to an
    in-process load + test(), and the steady passes (image_steady)."""
    from paddle_tpu_torch.__main__ import main as cli
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.trainer.trainer import make_feeder

    start = time.perf_counter()
    cfg = parse_config(path, args)
    t0 = time.perf_counter()
    feeder = make_feeder(cfg, cfg.data_config, True)
    t1 = time.perf_counter()
    train_b = list(feeder.batches())
    host_ms = (time.perf_counter() - t1) * 1e3 / len(train_b)
    log(f"[image] {tag}: the feeder: {(t1 - t0) * 1e3:.1f} host ms to load "
        f"and initialize the provider, {host_ms:.3f} host ms per batch "
        f"over {len(train_b)} batches of {train_b[0]['label'].ids.shape[0]}")
    runs = {}
    for k in (1, KSTEP):
        save = os.path.join(out, f"k{k}")

        def train():
            return cli(["train", f"--config={path}", f"--config_args={args}",
                        "--num_passes=1", f"--save_dir={save}",
                        f"--steps_per_dispatch={k}", "--log_period=100000"])

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rc, wall, kernels = cli_run(train, k)
        if rc != 0:
            raise AssertionError(f"[image] {tag} k={k}: exit code {rc}")
        line = check_launches(f"[image] {tag} k={k}", kernels, NO_KERNELS,
                              k > 1, NO_KERNELS)
        busy, busy_txt = busy_text(kernels, wall)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(save, "metrics.jsonl")) as f:
            row = json.loads(f.readline())
        runs[k] = dict(row=row, save=save, wall_ms=wall,
                       busy=None if busy is None else busy / wall, peak=peak)
        log(f"[image] {tag} k={k}: {row['batches']} batches, "
            f"{row['samples']} samples, cost {row['cost']:.5g}, "
            f"classification_error {row.get('classification_error', 0):.4f}"
            f"; {row['samples_per_sec']:.1f} samples/s over the pass (the "
            f"provider, the first step and the captures included); the "
            f"whole call {wall / 1e3:.2f} s, {busy_txt}, peak memory "
            f"{peak:.2f} GiB; {line} [{smi}]")
    stats = [pass_statistics(runs[k]["row"]) for k in (1, KSTEP)]
    differ = checkpoint_differs(
        os.path.join(runs[1]["save"], "pass-00000"),
        os.path.join(runs[KSTEP]["save"], "pass-00000"))
    from paddle_tpu_torch.trainer import checkpoint as ckpt
    net = ckpt.load_checkpoint(os.path.join(runs[1]["save"],
                                            "pass-00000"))["net"]
    counts = {float(st["count"]) for st in net.values()}
    log(f"[image] {tag}: k={KSTEP} against k=1: pass statistics "
        f"{'equal' if stats[0] == stats[1] else 'DIFFER'}, checkpoints "
        f"(with the moving statistics of {len(net)} batch norms, counts "
        f"{sorted(counts)}) "
        f"{'bit-identical' if not differ else 'DIFFER: ' + str(differ[:5])}")
    if stats[0] != stats[1] or differ:
        raise AssertionError(f"[image] {tag}: --steps_per_dispatch={KSTEP} "
                             f"is not bit-identical to 1")
    if not net or counts != {float(len(train_b))}:
        raise AssertionError(f"[image] {tag}: the checkpoint's batch-norm "
                             f"counts {sorted(counts)} are not the pass's "
                             f"{len(train_b)} steps")
    cli_test_round_trip(tag, path, args, runs[1]["save"], cfg)
    steady_b = (train_b if len(train_b) >= 8 else train_b * 2)[
        :STEADY_BATCHES]
    steady = image_steady(tag, cfg, runs[1]["save"], steady_b, smi)
    return dict(runs=runs, steady=steady, host_ms=host_ms,
                seconds=time.perf_counter() - start)


def phase_image(smi: str) -> None:
    """The image path from the config files (module docstring, phase
    17)."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        for tag, path, args in IMAGE_RUNS:
            res = image_pair(tag, path, args, os.path.join(root, tag), smi)
            r1, rk = res["runs"][1], res["runs"][KSTEP]
            s1, sk = res["steady"][1], res["steady"][KSTEP]
            log(f"[image] {tag}: the CLI's pass at k=1 / k={KSTEP}: "
                f"{r1['row']['samples_per_sec']:.1f} / "
                f"{rk['row']['samples_per_sec']:.1f} samples/s; steady "
                f"{s1['per_s']:.1f} / {sk['per_s']:.1f} samples/s, device "
                f"{s1['dev_ms']:.3f} / {sk['dev_ms']:.3f} ms/step, busy "
                f"{s1['busy']:.1%} / {sk['busy']:.1%}, peak memory "
                f"{s1['peak']:.2f} / {sk['peak']:.2f} GiB; the feeder "
                f"{res['host_ms']:.3f} host ms a batch; "
                f"{res['seconds']:.1f} s [{smi}]")
            torch.cuda.empty_cache()


# -- the sequence-tagging and sparse-input configs -----------------------------

SRL_DEPTH = 8           # db_lstm.py's default: one lstmemory per level


def _srl_train(batch) -> dict:
    """An SRL step: each lstmemory's forward and backward kernel once."""
    return dict(NO_KERNELS, lstm_fwd_kernel=SRL_DEPTH,
                lstm_bwd_kernel=SRL_DEPTH)


def _srl_test(batch) -> dict:
    return dict(NO_KERNELS, lstm_fwd_kernel=SRL_DEPTH)


def _no_kernels(batch) -> dict:
    return dict(NO_KERNELS)


# the [tagging] runs: (tag, config file, --config_args, the kernels a
# training step launches, those a test batch launches), each config at its
# defaults (SRL: depth 8, hidden_dim 128 (LSTM hidden 32), batch 150)
TAGGING_RUNS = (
    ("srl", "demo/semantic_role_labeling/db_lstm.py", "", _srl_train,
     _srl_test),
    ("linear_crf", "demo/sequence_tagging/linear_crf.py", "", _no_kernels,
     _no_kernels),
    ("rnn_crf", "demo/sequence_tagging/rnn_crf.py", "", _no_kernels,
     _no_kernels),
    ("qs_lr", "demo/quick_start/trainer_config.lr.py", "", _no_kernels,
     _no_kernels),
    ("qs_cnn", "demo/quick_start/trainer_config.cnn.py", "", _no_kernels,
     _no_kernels),
    ("recommendation", "demo/recommendation/trainer_config.py", "",
     _no_kernels, _no_kernels),
    ("introduction", "demo/introduction/trainer_config.py", "", _no_kernels,
     None),
)
SRL_SHAPE = (150, 32, 32)           # [B, T, D]: batch 150, the longest bucket


def srl_lstm_records(launches: dict, smi: str) -> list:
    """Each LSTM kernel at SRL's shape (SRL_SHAPE, relu cell as levels 1-7
    run it, peepholes, ragged lengths as the provider's 5-29 in a bucket
    of 32): checked against the plain version, then timed beside its bound
    (lstm_work), the plain version's time and a cuDNN LSTM of the same
    sizes (a yardstick with its own input projection and no length freeze;
    not required to lose to K3 here).  `launches`: the SRL k = 1 run's
    wrapper counts."""
    from paddle_tpu_torch.ops import lstm_fused as lf
    B, T, D = SRL_SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    names = ("relu", "sigmoid", "tanh")
    acts = dict(active_type="relu", gate_active_type="sigmoid",
                state_active_type="tanh")
    inputs, cot = lstm_inputs(g, B, T, D, True, False)
    x4, lens, w, peeps, h0, c0 = inputs
    lens = torch.randint(5, 30, (B,), generator=g, device="cuda").to(
        torch.int32)
    inputs = move_off_relu_kink((x4, lens, w, peeps, h0, c0), False, **acts)
    errs = lstm_compare(inputs, cot, False, **acts)
    rel = max(r for _, r in errs.values())
    log(f"[tagging] lstm kernels vs plain at [{B}, {T}, {D}] relu, "
        f"peepholes, lengths 5-29: worst {rel:.2e} of max (tol "
        f"{LSTM_TOL:g}); {lstm_plan_text(B, D)}")
    if not rel <= LSTM_TOL:
        raise AssertionError(f"lstm kernels disagree with their plain "
                             f"version at SRL's shape: {errs}")
    err = {"lstm_fwd": max(errs[n][0] for n in LSTM_NAMES[:3]),
           "lstm_bwd": max(errs[n][0] for n in LSTM_NAMES[3:])}
    x4, lens, w, peeps, h0, c0 = inputs
    hs, cs, gates = lf.lstm_fwd_kernel(x4, lens, w, peeps, h0, c0, names,
                                       False, save_gates=True)
    ms = {"lstm_fwd": time_call(lambda: lf.lstm_fwd_kernel(
              x4, lens, w, peeps, h0, c0, names, False, save_gates=True),
              20),
          "lstm_bwd": time_call(lambda: lf.lstm_bwd_kernel(
              lens, w, peeps, h0, c0, hs, cs, gates, *cot, names, False),
              20)}
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
    work = lstm_work(float(lens.sum()), B, T, D)
    records = []
    for name, src_line, sym in (("lstm_fwd", 66, "lstm_fwd_kernel"),
                                ("lstm_bwd", 99, "lstm_bwd_kernel")):
        nbytes, flops = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        by = "operations" if flops_ms >= bytes_ms else "bytes"
        log(f"[tagging] {name} at SRL's [{B}, {T}, {D}] float32: "
            f"{ms[name] * 1e3:.1f} us/launch = {ms[name] * 1e3 / T:.2f} "
            f"us/step; bound {bound_ms * 1e3:.2f} us ({by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB) = "
            f"{bound_ms / ms[name]:.1%} of the bound; plain version "
            f"{plain[name] * 1e3:.1f} us; cuDNN LSTM {lib[name] * 1e3:.1f} "
            f"us = {lib[name] / ms[name]:.2f}x the kernel's time; "
            f"{launches[sym]} launches on SRL's k=1 CLI pass [{smi}]")
        records.append({
            "name": f"{name} [{B}, {T}, {D}]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lstm.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{src_line}",
            "launches": launches[sym], "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain[name], "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib[name]})
    return records


def tagging_steady(tag: str, cfg, save: str, batches: list, route,
                   smi: str) -> dict:
    """Past the first passes, over the feeder's batches assembled
    beforehand (so the provider is not timed), per k in (1, KSTEP): a
    Trainer here on the k = 1 run's checkpoint, passes until every group
    is a replay, then one under the profiler: wall and device ms/step,
    busy share, samples/s, kernels and host launch calls a step, and the
    host evaluators' ms a step (`EvaluatorSet.host_update`, timed around
    its calls), the card launching the kernels `route` says."""
    from paddle_tpu_torch.trainer import Trainer

    want = route_total(route, batches)
    n = len(batches)
    out = {}
    for k in (1, KSTEP):
        tr = Trainer(cfg, seed=1)
        tr.load(os.path.join(save, "pass-00000"))
        for _ in range(1 if k == 1 else 2):
            tr.train_one_pass(batches, steps_per_dispatch=k)
        spent = [0.0]
        update = tr.evaluators.host_update

        def timed_update(*a, **kw):
            t0 = time.perf_counter()
            update(*a, **kw)
            spent[0] += time.perf_counter() - t0
        tr.evaluators.host_update = timed_update
        reset_counts()
        stats, wall, kernels, calls = profiled(
            lambda: tr.train_one_pass(batches, steps_per_dispatch=k))
        line = check_launches(f"[tagging] {tag} steady k={k}", kernels,
                              want, k > 1,
                              {sym: 0 for sym in want} if k > 1 else None)
        busy = sum(dev_us(e) for e in kernels) / 1e3
        o = out[k] = dict(dev_ms=busy / n, wall_ms=wall / n,
                          busy=busy / wall, per_s=stats["samples_per_sec"],
                          calls=calls / n, host_eval_ms=spent[0] * 1e3 / n,
                          kernels=sum(e.count for e in kernels) / n)
        log(f"[tagging] {tag} steady k={k} ({n} batches assembled "
            f"beforehand, {'every group a replay' if k > 1 else 'eager'}):"
            f" {o['wall_ms']:.2f} ms/step wall, {o['dev_ms']:.3f} device "
            f"ms/step, busy {o['busy']:.1%}, {o['per_s']:.1f} samples/s, "
            f"{o['kernels']:.0f} kernels and {o['calls']:.1f} host launch "
            f"calls a step, host evaluators {o['host_eval_ms']:.3f} ms a "
            f"step; {line} [{smi}]")
        log(f"[tagging] {tag} steady k={k} top device operations: "
            f"{top_ops(kernels)} [{smi}]")
        if k > 1 and not any(graph_replays(tr).values()):
            raise AssertionError(f"[tagging] {tag}: no graph replayed")
        del tr
    return out


def tagging_table_and_product(smi: str) -> None:
    """Two measurements behind the tagging path's findings.  The table
    gradient: ten backward calls each of F.embedding and of ops/table.py
    lookup_rows on a 2-row table under 4,800 ids (SRL's predicate mark) and
    a 7-row table under 20,000: how many distinct results each gives (the
    port's must give one), and their times.  The vanilla RNN's step
    product [16, 128] . [128, 128] in float32 beside [320, 128] .
    [128, 128] (cuBLAS's pick for the first is slow)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.table import lookup_rows
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    for V, D, n in ((2, 5, 4800), (7, 256, 20000)):
        ids = torch.randint(0, V, (n,), device="cuda", generator=g)
        grad = torch.randn(n, D, device="cuda", generator=g)
        w = torch.randn(V, D, device="cuda", generator=g).requires_grad_(
            True)
        line = []
        for name, fn in (("F.embedding", F.embedding),
                         ("lookup_rows", lookup_rows)):
            def bwd(fn=fn):
                return torch.autograd.grad(fn(ids, w), w, grad)[0]
            outs = [bwd() for _ in range(10)]
            distinct = len({o.cpu().numpy().tobytes() for o in outs})
            line.append(f"{name} {distinct} distinct of 10, "
                        f"{time_call(bwd, 20) * 1e3:.1f} us")
            if name == "lookup_rows" and distinct != 1:
                raise AssertionError(f"[tagging] lookup_rows' backward "
                                     f"is not deterministic at {V} rows")
        log(f"[tagging] table gradient, {V} rows x {D} under {n} ids "
            f"(forward + backward): {'; '.join(line)} [{smi}]")
    times = []
    for m in (16, 320):
        a = torch.randn(m, 128, device="cuda", generator=g)
        b = torch.randn(128, 128, device="cuda", generator=g)
        times.append(f"[{m}, 128] . [128, 128] "
                     f"{time_call(lambda: a @ b, 200) * 1e3:.2f} us")
    log(f"[tagging] float32 products (TF32 off), as rnn_crf's recurrent "
        f"step runs them: {'; '.join(times)} [{smi}]")


def phase_tagging(smi: str) -> list:
    """The sequence-tagging and sparse-input configs from their files
    (module docstring, phase 18): each through cli_pair (its kernels held
    against their plain versions at the CLI's shapes, one pass at k = 1
    and one at KSTEP bit-identical, statistics, averages and evaluator
    results included, launches as the route says, the steady pass), then
    --job=test on the k = 1 checkpoint (the averaged parameters where the
    config averages) equal to an in-process load + test(), then steady
    passes over batches assembled beforehand (tagging_steady); then K3
    timed at SRL's shape; then tagging_table_and_product.  Returns K3's
    records at that shape."""
    import tempfile

    from paddle_tpu_torch.trainer.trainer import make_feeder

    records = []
    with tempfile.TemporaryDirectory() as root:
        for tag, path, args, train_route, test_route in TAGGING_RUNS:
            start = time.perf_counter()
            res = cli_pair(tag, path, args, train_route, test_route,
                           os.path.join(root, tag), smi)
            r1, rk, st = res["runs"][1], res["runs"][KSTEP], res["steady"]
            if res["cfg"].test_data_config is not None:
                got = cli_test_round_trip(tag, path, args, r1["save"],
                                          res["cfg"])
                evals = {k: v for k, v in got.items() if k != "cost"}
                which = ("averaged " if res["cfg"].opt_config.average_window
                         > 0 else "")
                log(f"[tagging] {tag} test pass on the {which}parameters: "
                    f"cost {got['cost']:.5g} {evals}")
            batches = list(make_feeder(res["cfg"], res["cfg"].data_config,
                                       True).batches())[:STEADY_BATCHES]
            steady = tagging_steady(tag, res["cfg"], r1["save"], batches,
                                    train_route, smi)
            if tag == "srl":
                records = srl_lstm_records(r1["counted"], smi)
            evals = {k: v for k, v in r1["row"].items()
                     if "chunk" in k or k.endswith("sum")
                     or k.endswith("error")}
            log(f"[tagging] {tag}: the CLI's pass at k=1 / k={KSTEP}: "
                f"{r1['row']['samples_per_sec']:.1f} / "
                f"{rk['row']['samples_per_sec']:.1f} samples/s, cost "
                f"{r1['row']['cost']:.5g}, {evals}; steady pass (k={KSTEP})"
                f" {st['per_s']:.1f} samples/s, {st['dev_ms']:.3f} device "
                f"ms/step, {st['wall_ms']:.2f} wall ms/step, busy "
                f"{st['busy']:.1%}; over batches assembled beforehand, "
                f"k=1 / k={KSTEP}: {steady[1]['dev_ms']:.3f} / "
                f"{steady[KSTEP]['dev_ms']:.3f} device ms/step, busy "
                f"{steady[1]['busy']:.1%} / {steady[KSTEP]['busy']:.1%}, "
                f"{steady[1]['per_s']:.1f} / {steady[KSTEP]['per_s']:.1f} "
                f"samples/s; the feeder {res['host_ms']:.3f} host ms "
                f"a batch; {time.perf_counter() - start:.1f} s [{smi}]")
            torch.cuda.empty_cache()
    tagging_table_and_product(smi)
    return records


# ---------------------------------------------------------------------------
# [nested]: nested sequences and carried recurrent state
# ---------------------------------------------------------------------------

# the nested test configs and their flat twins (tests/configs)
NEST_PAIRS = (("tests/configs/sequence_nest_rnn.py",
               "tests/configs/sequence_rnn.py"),
              ("tests/configs/sequence_nest_rnn_multi_input.py",
               "tests/configs/sequence_rnn_multi_input.py"))
# the configs' sizes at the nearest the repo offers to full width: the
# sentiment provider's vocabulary, its embedding, hidden 512, two classes
NEST_WIDTH = (("dict_dim = 10", "dict_dim = 30000"),
              ("word_dim = 8", "word_dim = 128"),
              ("hidden_dim = 8", "hidden_dim = 512"),
              ("label_dim = 3", "label_dim = 2"),
              ("settings(batch_size=2,", "settings(batch_size=128,"))
NEST_RTOL, NEST_ATOL = 1e-4, 1e-5   # the reference's hierarchical oracle
NEST_B, NEST_SUBS, NEST_TOKENS = 128, (1, 8), (4, 32)
# kstep_training's batches: a warm-up of 2 KSTEP, then two rounds of a
# timed and a profiled pass of KSTEP each (every group a replay of the
# warm-up's graph of KSTEP steps)
NEST_BATCHES = 6 * KSTEP
# the reference's rnn_data_provider documents (tests/test_nested_rnn.py)
NEST_DOCS = [([[1, 3, 2], [4, 5, 2]], 0), ([[0, 2], [2, 5], [0, 1, 2]], 1)]

# the hierarchical LSTM: an outer group over the sub-sequences of the
# embedded words, its step fc(4 lstm_dim, linear) -> lstmemory (K3, once
# per sub-sequence) -> last_seq, beside an fc memory over the
# sub-sequences (tests/test_torch_nested.py holds the same text against
# the JAX package)
HIER_LSTM = """
from paddle_tpu.dsl import *
dict_dim = get_config_arg("dict_dim", int, 30)
word_dim = get_config_arg("word_dim", int, 8)
lstm_dim = get_config_arg("lstm_dim", int, 8)
hidden_dim = get_config_arg("hidden_dim", int, 8)
settings(batch_size=get_config_arg("batch_size", int, 4),
         learning_rate=1e-3, learning_method=AdamOptimizer())
data = data_layer(name="word", size=dict_dim)
emb = embedding_layer(input=data, size=word_dim)


def outer_step(x):
    outer_mem = memory(name="outer_state", size=hidden_dim)
    proj = fc_layer(input=x, size=4 * lstm_dim, act=LinearActivation(),
                    bias_attr=False)
    lstm = lstmemory(input=proj)
    return fc_layer(input=[last_seq(input=lstm), outer_mem],
                    size=hidden_dim, act=TanhActivation(), bias_attr=True,
                    name="outer_state")


out = recurrent_group(name="outer", step=outer_step,
                      input=SubsequenceInput(emb))
prob = fc_layer(input=last_seq(input=out), size=2, act=SoftmaxActivation(),
                bias_attr=True)
classification_cost(input=prob, label=data_layer(name="label", size=2))
"""
HIER_ARGS = "dict_dim=30000,word_dim=128,lstm_dim=128,hidden_dim=512," \
            "batch_size=128"

# the chunk oracle's layers: an lstmemory (K3) at the sentiment net's
# width or a gated_recurrent (K1) at the seq2seq encoder's, each behind a
# linear projection of a dense input sequence
CHUNK = """
from paddle_tpu.dsl import *
kind = get_config_arg("kind", str, "lstm")
hidden = get_config_arg("hidden", int, 128)
settings(batch_size=get_config_arg("batch_size", int, 128),
         learning_rate=1e-3)
x = data_layer(name="x", size=64)
if kind == "lstm":
    rnn = lstmemory(input=fc_layer(input=x, size=4 * hidden,
                                   act=LinearActivation()), name="rnn")
else:
    rnn = grumemory(input=fc_layer(input=x, size=3 * hidden,
                                   act=LinearActivation()), name="rnn")
prob = fc_layer(input=last_seq(input=rnn), size=2, act=SoftmaxActivation())
classification_cost(input=prob, label=data_layer(name="label", size=2))
"""
# (kind, hidden, B, T, the kernel wrapper, its forward kernel symbol)
CHUNK_RUNS = (("lstm", 128, 128, 100, "lstm_fused", "lstm_fwd_kernel"),
              ("gru", 512, 64, 30, "gru_fused", "gru_fwd_kernel"))


@contextlib.contextmanager
def carried_state(on: bool = True):
    """--prev_batch_state set in this process within (the CLI sets it from
    its own arguments for its runs and puts it back after)."""
    from paddle_tpu_torch.utils.flags import FLAGS
    saved = FLAGS.prev_batch_state
    FLAGS.prev_batch_state = on
    try:
        yield
    finally:
        FLAGS.prev_batch_state = saved


def nest_docs(rng, n: int, vocab: int) -> list:
    """n documents of NEST_SUBS sub-sequences of NEST_TOKENS word ids
    each, with a label of two classes."""
    return [([rng.integers(0, vocab, rng.integers(NEST_TOKENS[0],
                                                  NEST_TOKENS[1] + 1))
              .tolist() for _ in range(rng.integers(NEST_SUBS[0],
                                                    NEST_SUBS[1] + 1))],
             int(rng.integers(0, 2))) for _ in range(n)]


def nest_batches(docs: list, B: int, vocab: int, labels: int,
                 flat_len: Optional[int] = None):
    """The documents as nested and as flat batches of B (the feeder's
    make_batch; the flat ones padded to `flat_len` when given, else to
    their bucket): ([nested], [flat])."""
    import importlib
    from paddle_tpu_torch.data.feeder import make_batch
    prov = importlib.import_module("paddle_tpu_torch.data.provider")
    nested, flat = [], []
    for i in range(0, len(docs) - B + 1, B):
        part = docs[i:i + B]
        nested.append(make_batch(part, [prov.integer_value_sub_sequence(
            vocab), prov.integer_value(labels)], ["word", "label"]))
        flat.append(make_batch([([w for s in d for w in s], y)
                                for d, y in part],
                               [prov.integer_value_sequence(vocab),
                                prov.integer_value(labels)],
                               ["word", "label"], pad_len=flat_len))
    return nested, flat


def loss_and_grads(cfg, params: dict, batch) -> tuple:
    """One TRAIN forward of the config's graph on the card and its
    gradients: (loss, [gradient in the parameters' order])."""
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.parameter import Argument

    def card(x, ids=False):
        if x is None:
            return None
        t = torch.as_tensor(x, device="cuda")
        return t.long() if ids else t
    feed = {n: Argument(value=card(a.value), ids=card(a.ids, True),
                        lengths=card(a.lengths),
                        sub_lengths=card(a.sub_lengths))
            for n, a in batch.items()}
    leaves = {n: v.detach().clone().requires_grad_(True)
              for n, v in params.items()}
    loss, _ = GraphExecutor(cfg.model_config).loss(leaves, feed,
                                                   mode="train")
    return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))


def nested_equals_flat(tag: str, nest_cfg, flat_cfg, nested_b,
                       flat_b) -> str:
    """The reference's hierarchical oracle on the card: from the same
    parameters (the two configs declare the same shapes in the same order,
    under other names), the nested config's cost and every gradient on the
    nested batch within NEST_RTOL, NEST_ATOL of the flat config's on the
    concatenated words.  Returns a line for the log."""
    from paddle_tpu_torch.parameter import init_params
    params = init_params(nest_cfg.model_config, seed=1, device="cuda")
    fparams = init_params(flat_cfg.model_config, seed=1, device="cuda")
    if [tuple(v.shape) for v in params.values()] != \
            [tuple(v.shape) for v in fparams.values()]:
        raise AssertionError(f"[nested] {tag}: the nested and flat configs "
                             f"declare different parameters")
    fparams = dict(zip(fparams, params.values()))
    nl, ng = loss_and_grads(nest_cfg, params, nested_b)
    fl, fg = loss_and_grads(flat_cfg, fparams, flat_b)
    worst = max(float(((a - b).abs() - NEST_RTOL * b.abs()).max())
                for a, b in zip(ng, fg))
    loss_err = abs(float(nl) - float(fl))
    ok = (loss_err <= NEST_ATOL + NEST_RTOL * abs(float(fl))
          and worst <= NEST_ATOL and all(bool(torch.isfinite(g).all())
                                         for g in ng))
    line = (f"[nested] {tag}: nested cost {float(nl):.6f}, flat "
            f"{float(fl):.6f}; {len(ng)} gradients, worst |nested - flat| "
            f"- {NEST_RTOL:g} |flat| = {worst:.2e} (atol {NEST_ATOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
    log(line)
    if not ok:
        raise AssertionError(f"[nested] {tag}: nested differs from flat")
    return line


def full_width_copy(src: str, root: str) -> str:
    """A nested or flat test config at NEST_WIDTH, written under root."""
    with open(src) as f:
        text = f.read()
    for old, new in NEST_WIDTH:
        if text.count(old) != 1:
            raise AssertionError(f"[nested] {src}: {old!r} not found once")
        text = text.replace(old, new)
    path = os.path.join(root, os.path.basename(src))
    with open(path, "w") as f:
        f.write(text)
    return path


def nested_configs(smi: str, root: str) -> None:
    """(a) The nested test configs from their files at their own widths on
    the reference's documents, then copies at NEST_WIDTH on NEST_B
    documents of NEST_SUBS sub-sequences of NEST_TOKENS words (seed 1):
    nested equals flat; then the first pair at full width through
    kstep_training (k = KSTEP bit-identical to k = 1; no hand-written
    kernel on this path), its flat twin beside it."""
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.trainer import Trainer

    for nest, flat in NEST_PAIRS:
        nb, fb = nest_batches(NEST_DOCS, 2, 10, 3)
        nested_equals_flat(f"{os.path.basename(nest)} (own widths)",
                           parse_config(nest, ""), parse_config(flat, ""),
                           nb[0], fb[0])
    docs = nest_docs(np.random.default_rng(1), NEST_B * NEST_BATCHES, 30000)
    # the flat twin padded to one length, the most words a document has,
    # so that it has one signature, as the nested batches do
    nested_b, flat_b = nest_batches(docs, NEST_B, 30000, 2,
                                    NEST_SUBS[1] * NEST_TOKENS[1])
    shapes = sorted({tuple(b["word"].ids.shape) for b in nested_b})
    fshapes = sorted({tuple(b["word"].ids.shape) for b in flat_b})
    log(f"[nested] full width: {len(nested_b)} batches of {NEST_B} "
        f"documents, nested ids {shapes}, flat {fshapes}")
    cfgs = {}
    for nest, flat in NEST_PAIRS:
        ncfg = parse_config(full_width_copy(nest, root), "")
        fcfg = parse_config(full_width_copy(flat, root), "")
        cfgs[nest] = (ncfg, fcfg)
        nested_equals_flat(f"{os.path.basename(nest)} (full width)", ncfg,
                           fcfg, nested_b[0], flat_b[0])
    ncfg, fcfg = cfgs[NEST_PAIRS[0][0]]
    for tag, cfg, batches in (("nested", ncfg, nested_b),
                              ("flat", fcfg, flat_b)):
        kstep_training(f"[nested] {tag} rnn (hidden 512)", smi,
                       lambda cfg=cfg: Trainer(cfg, seed=1), batches,
                       lambda b: {}, (NEST_B, "documents"), timed=KSTEP,
                       profiled_steps=KSTEP)


def hier_lstm_route(batch) -> dict:
    """A training step of the hierarchical LSTM: K3 forward and backward
    once per outer step, one outer step per padded sub-sequence."""
    S = batch["word"].ids.shape[1]
    return {"lstm_fwd_kernel": S, "lstm_bwd_kernel": S}


def hierarchical_lstm(smi: str, root: str) -> None:
    """(b) The hierarchical LSTM at HIER_ARGS: K3 held against its plain
    version on the inputs the outer steps gave it (cli_kernel_checks),
    then kstep_training: the profiler's kernel events count one K3 forward
    and one backward per outer step, k = KSTEP bit-identical to k = 1."""
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.trainer import Trainer

    path = os.path.join(root, "hier_lstm.py")
    with open(path, "w") as f:
        f.write(HIER_LSTM)
    cfg = parse_config(path, HIER_ARGS)
    docs = nest_docs(np.random.default_rng(1), NEST_B * NEST_BATCHES, 30000)
    batches, _ = nest_batches(docs, NEST_B, 30000, 2)
    want = route_total(hier_lstm_route, batches[:1])
    n = cli_kernel_checks("hier_lstm", cfg, batches, [], want)
    log(f"[nested] hier_lstm: {n} K3 check(s) at the outer steps' shapes "
        f"passed")
    kstep_training("[nested] hier_lstm", smi,
                   lambda: Trainer(cfg, seed=1), batches, hier_lstm_route,
                   (NEST_B, "documents"), timed=KSTEP,
                   profiled_steps=KSTEP)


def h0_nonzero(attr, args, kw) -> bool:
    """A recurrent kernel's call whose boot state is not all zeros: the
    LSTM's h0 or c0 (args 4, 5), the GRU's h0 (arg 4)."""
    return any(bool(t.abs().max() > 0) for t in args[4:6]
               if torch.is_tensor(t) and t.dim() == 2)


def check_carried_calls(tag: str, calls: dict, attrs: set) -> int:
    """Each recorded call (booted from a carried state) against the
    kernels' plain version on the same inputs (CLI_CHECKS); each wrapper of
    `attrs` must have such a call.  Returns the number of checks."""
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    for (attr, _, _), (args, kw) in calls.items():
        shape, text, ok = CLI_CHECKS[attr](g, args, kw)
        boot = ", ".join(f"|{n}| max {float(t.abs().max()):.3g}"
                         for n, t in zip(("h0", "c0"), args[4:6])
                         if torch.is_tensor(t) and t.dim() == 2)
        log(f"[nested] {tag}: {attr} booted from the carried state ({boot})"
            f" at {shape} against its plain version: {text} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[nested] {tag}: {attr} disagrees with "
                                 f"its plain version")
    if {attr for attr, _, _ in calls} != attrs:
        raise AssertionError(f"[nested] {tag}: no call of {sorted(attrs)} "
                             f"booted from a carried state")
    return len(calls)


def chunk_oracle(root: str) -> None:
    """(c) --prev_batch_state on the card: for each CHUNK_RUNS layer, two
    consecutive chunks of T/2 steps (ragged rows, some ending in the first
    chunk) with the carried state end in the state one whole-T forward
    ends in, and each row's last valid output is the same, within 1e-5 of
    the largest; the second chunk's kernel call, booted from the carried
    state, held against the plain version; one forward kernel launch a
    chunk and no plain call."""
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.parameter import Argument
    from paddle_tpu_torch.trainer import Trainer

    path = os.path.join(root, "chunk.py")
    with open(path, "w") as f:
        f.write(CHUNK)
    for kind, hidden, B, T, attr, sym in CHUNK_RUNS:
        cfg = parse_config(path, f"kind={kind},hidden={hidden},"
                                 f"batch_size={B}")
        tr = Trainer(cfg, seed=1)
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        x = torch.randn(B, T, 64, generator=g, device="cuda")
        lens = torch.randint(1, T + 1, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        lens[0] = T
        lens[1] = T // 4
        half = T // 2
        first = lens.clamp(max=half)
        label = Argument(ids=torch.zeros(B, dtype=torch.long,
                                         device="cuda"))

        def fwd(xs, ln, state):
            return tr.executor.forward(tr.params, {
                "x": Argument(value=xs, lengths=ln), "label": label},
                state=state)

        with carried_state():
            reset_counts()
            with recorded_inputs(h0_nonzero) as calls:
                out1, _, st1 = fwd(x[:, :half], first, {})
                out2, _, st2 = fwd(x[:, half:], lens - first, st1)
            launched = wrapper_counts([sym])[sym]
            plain = any(plain_calls().values())
            full, _, stf = fwd(x, lens, {})
        worst = 0.0
        for key, want in stf.items():
            worst = max(worst, float((st2[key] - want).abs().max())
                        / max(float(want.abs().max()), 1e-30))
        rows = torch.arange(B, device="cuda")
        last = lens.long() - 1
        in_second = last >= half
        got = torch.where(in_second[:, None],
                          out2["rnn"].value[rows, (last - half).clamp(min=0)],
                          out1["rnn"].value[rows, last.clamp(max=half - 1)])
        want = full["rnn"].value[rows, last]
        out_err = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        worst = max(worst, out_err)
        n = check_carried_calls(f"chunk {kind}", calls, {attr})
        ok = worst <= 1e-5 and launched == 2 and not plain
        log(f"[nested] chunk oracle {kind} [{B}, {T}] hidden {hidden}: two "
            f"chunks of {half} steps with the carried state against one "
            f"forward of {T}: final states {sorted(stf)} and each row's "
            f"last valid output, worst {worst:.2e} of max (tol 1e-05); "
            f"{launched} {sym} launches for the two chunks, plain calls "
            f"{int(plain)}; {n} carried-state kernel check(s) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[nested] chunk oracle {kind} fails")
        del tr
    torch.cuda.empty_cache()


SENTIMENT = "demo/sentiment/trainer_config.py"
SMALL_LAST = 100        # rows of the smaller last batch of (d)'s passes


def sentiment_carry(smi: str, root: str) -> None:
    """(d) `python -m paddle_tpu_torch train --config=SENTIMENT
    --prev_batch_state` on its provider at full width: first a Trainer
    here with the flag steps twice and tests once, each forward LSTM's
    kernel calls booted from the carried state (non-zero h0, c0) held
    against the plain version; then cli_pair with the flag (K3 launches
    as the route says, k = KSTEP bit-identical to k = 1, the steady
    pass) and --job=test of its checkpoint with the flag equal to an
    in-process load + test(); then two trainers, k = 1 and k = KSTEP, two
    passes of the feeder's batches each ending with a smaller batch of
    SMALL_LAST rows (which ignores the carried state; the next pass's
    first batch ignores the small one's): bit-identical after each pass,
    the carried state included, the second pass profiled."""
    from paddle_tpu_torch.config.parser import parse_config
    from paddle_tpu_torch.parameter import Argument
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer.trainer import make_feeder

    extra = ("--prev_batch_state",)
    with carried_state():
        cfg = parse_config(SENTIMENT, "")
        train_b = list(make_feeder(cfg, cfg.data_config, True).batches())
        test_b = list(make_feeder(cfg, cfg.test_data_config,
                                  False).batches())
        tr = Trainer(cfg, seed=1)
        with recorded_inputs(h0_nonzero) as calls:
            tr.train_one_pass(train_b[:2])
            tr.test(test_b[:1])
        carried = sorted(tr.net_state)
        del tr
        n = check_carried_calls("sentiment", calls, {"lstm_fused"})
        log(f"[nested] sentiment --prev_batch_state: the carried states "
            f"{carried}; {n} K3 check(s) booted from them passed")
        res = cli_pair("sentiment-carry", SENTIMENT, "", _lstm_train,
                       _lstm_test, os.path.join(root, "sentiment"), smi,
                       extra)
        got = cli_test_round_trip("sentiment-carry", SENTIMENT, "",
                                  res["runs"][1]["save"], res["cfg"], extra)
        log(f"[nested] sentiment --prev_batch_state --job=test: {got}")

        def small(b):
            return {n: Argument(**{f: (None if getattr(a, f) is None
                                       else getattr(a, f)[:SMALL_LAST])
                                   for f in ("value", "ids", "lengths")})
                    for n, a in b.items()}
        passes = [train_b[:7] + [small(train_b[7])],
                  train_b[8:15] + [small(train_b[15])]]
        t1, tk = Trainer(cfg, seed=1), Trainer(cfg, seed=1)
        for p, batches in enumerate(passes):
            res = {}
            want = route_total(_lstm_train, batches)
            for tr, k in ((t1, 1), (tk, KSTEP)):
                reset_counts()
                res[k], wall, kernels, calls_ = profiled(
                    lambda: pass_with_losses(tr, batches, k))
                line = check_launches(f"[nested] sentiment carry pass "
                                      f"{p + 1} k={k}", kernels, want, k > 1)
                busy = sum(dev_us(e) for e in kernels) / 1e3
                log(f"[nested] sentiment carry pass {p + 1} k={k}: "
                    f"{len(batches)} batches (the last of {SMALL_LAST} "
                    f"rows), device {busy / len(batches):.3f} ms/step, busy "
                    f"{busy / wall:.1%}, "
                    f"{sum(e.count for e in kernels) / len(batches):.0f} "
                    f"kernels and {calls_ / len(batches):.1f} host launch "
                    f"calls a step (profiler on); {line} [{smi}]")
            differ = training_state_differs(t1, tk)
            same = (res[1][0] == res[KSTEP][0]
                    and torch.equal(res[1][1], res[KSTEP][1]))
            shapes = {n: tuple(v.shape) for n, v in tk.net_state.items()}
            log(f"[nested] sentiment carry pass {p + 1}: k={KSTEP} against "
                f"k=1: statistics and losses "
                f"{'bit-identical' if same else 'DIFFER'}, state "
                f"{'bit-identical' if not differ else 'DIFFERS: ' + str(differ[:5])}"
                f"; carried state {shapes}; {tk.n_settle_steps} eager first "
                f"steps, graphs {graph_replays(tk)}")
            if differ or not same:
                raise AssertionError(f"[nested] sentiment carry pass "
                                     f"{p + 1}: k={KSTEP} differs from k=1")
        del t1, tk
    torch.cuda.empty_cache()


def phase_nested(smi: str) -> None:
    """Nested sequences and carried recurrent state (module docstring,
    phase 19): (a) nested_configs, (b) hierarchical_lstm, (c)
    chunk_oracle, (d) sentiment_carry."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        for name, fn, args in (("a", nested_configs, (smi, root)),
                               ("b", hierarchical_lstm, (smi, root)),
                               ("c", chunk_oracle, (root,)),
                               ("d", sentiment_carry, (smi, root))):
            start = time.perf_counter()
            fn(*args)
            log(f"[nested] ({name}) {fn.__name__}: "
                f"{time.perf_counter() - start:.1f} s [{smi}]")
            torch.cuda.empty_cache()


# -- the port's threefry (utils/prng.py) and the layer zoo of slice 21 ----

# Random123's threefry2x32-20 known answers: (key, counter, result)
THREEFRY_KAT = (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0)))
RNG_KEYS, RNG_SHAPE = 64, (8, 32000)
# the float draws that go through torch.erfinv / torch.log, card against
# CPU, absolute
RNG_TOL = {"normal": 2e-5, "gumbel": 2e-6}
RNG_REQUESTS = 16


def rng_draws(keys: torch.Tensor) -> dict:
    """Every draw of the port's threefry from `keys` [N, 2] at RNG_SHAPE,
    on the keys' device."""
    from paddle_tpu_torch.utils import prng
    data = torch.arange(int(np.prod(RNG_SHAPE)), device=keys.device) \
        .reshape(RNG_SHAPE)
    return {"bits": prng.bits(keys, RNG_SHAPE),
            "split": prng.split(keys, RNG_SHAPE),
            "fold_in": prng.fold_in(keys[:, None, None], data),
            "uniform": prng.uniform(keys, RNG_SHAPE),
            "uniform [-0.3, 0.45)": prng.uniform(keys, RNG_SHAPE,
                                                 minval=-0.3, maxval=0.45),
            "bernoulli": prng.bernoulli(keys, 0.7, RNG_SHAPE),
            "normal": prng.normal(keys, RNG_SHAPE),
            "gumbel": prng.gumbel(keys, RNG_SHAPE)}


def rng_streams(smi: str) -> None:
    """The known answers on the card, and RNG_KEYS keys' draws at
    RNG_SHAPE on the card against the port on the CPU: the integer
    streams, uniform and bernoulli bit for bit, normal and gumbel within
    RNG_TOL (their count of differing values logged)."""
    from paddle_tpu_torch.utils import prng
    for key, count, want in THREEFRY_KAT:
        got = prng.threefry2x32(*(torch.tensor(v, device="cuda")
                                  for v in key + count))
        got = tuple(int(g) for g in got)
        if got != want:
            raise AssertionError(f"[rng] threefry2x32{key}{count} = "
                                 f"{got}, want {want}")
    log(f"[rng] the {len(THREEFRY_KAT)} Random123 known answers hold on "
        f"the card")
    keys = prng.split(prng.PRNGKey(2026), RNG_KEYS)
    t0 = time.perf_counter()
    card = rng_draws(keys.cuda())
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = rng_draws(keys)
    t_host = time.perf_counter() - t0
    bad = []
    for name, want in host.items():
        got = card[name].cpu()
        if name in RNG_TOL:
            err = float((got - want).abs().max())
            n = int((got != want).sum())
            log(f"[rng] {name}: {n} of {want.numel()} values differ from "
                f"the CPU's, max abs {err:.3g} (tol {RNG_TOL[name]:g})")
            if not err <= RNG_TOL[name]:
                bad.append(name)
        elif not torch.equal(got, want):
            bad.append(name)
    log(f"[rng] {RNG_KEYS} keys at {list(RNG_SHAPE)}: bits, split, "
        f"fold_in, uniform (two ranges) and bernoulli "
        f"{'bit-identical to the CPU' if not bad else 'DIFFER: ' + str(bad)}"
        f"; all draws {t_card * 1e3:.1f} ms on the card (first call), "
        f"{t_host:.1f} s on the CPU [{smi}]")
    if bad:
        raise AssertionError(f"[rng] the card's draws differ from the "
                             f"CPU's: {bad}")


def rng_requests(vocab: int):
    """RNG_REQUESTS sampled requests: prompts of 16-200 tokens, max_new
    16-64, temperature 0.6-1.4, top_k among 0, 20 and 200, top_p among 0,
    0.8 and 0.95, a seed each; eos off."""
    from paddle_tpu_torch.serving import Request
    rng = np.random.default_rng(21)
    return [Request(i, rng.integers(2, vocab, int(rng.integers(16, 201))),
                    max_new=int(rng.integers(16, 65)),
                    temperature=float(rng.uniform(0.6, 1.4)),
                    top_k=(0, 20, 200)[i % 3],
                    top_p=(0.0, 0.8, 0.95)[(i // 3) % 3], seed=500 + i)
            for i in range(RNG_REQUESTS)]


def noise_cost(eng, k: int, smi: str) -> None:
    """What the in-graph noise adds to a window of k bodies: the draw of
    one window ([S, k, V] Gumbel rows from the staged keys and generation
    counts, as `_Window.body` draws them) captured alone into a CUDA
    graph, its kernels counted by the profiler and its replay timed with
    events."""
    from paddle_tpu_torch.serving.sampler import slot_noise
    from paddle_tpu_torch.utils import prng
    S = len(eng.slots)
    gen = torch.arange(S, dtype=torch.int64, device="cuda")
    max_new = torch.full((S,), 64, dtype=torch.int64, device="cuda")

    def draws():
        g = gen[:, None] + torch.arange(k, device="cuda")
        return slot_noise(prng.fold_in(eng._d_keys[:, None], torch.minimum(
            g, max_new[:, None] - 1)), eng.vocab)

    draws()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = draws()
    _, _, kernels, _ = profiled(draws)
    launches = sum(e.count for e in kernels)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    reps = 50
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    us = e0.elapsed_time(e1) * 1e3 / reps
    log(f"[rng] the noise of a window of {k} bodies (S {S}, vocab "
        f"{eng.vocab}): {launches} kernels, {us:.1f} us replayed as a "
        f"graph ({us / k:.1f} us a body) [{smi}]")
    del graph, out


def rng_serving(smi: str) -> None:
    """RNG_REQUESTS sampled requests at DECODE_MODEL's width on three
    engines: k = 1 (eager steps, the noise drawn from the staged keys),
    decode_steps = KSTEP (windows as CUDA graphs drawing inside the graph)
    and speculative decode (SPEC_K n-gram drafts, chain position i with
    generation gen + i's key): the same tokens; K5 launched once per layer
    per step at k = 1, the plain version never."""
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import ServingEngine

    c = DECODE_MODEL
    model = transformer_lm_config(**c)
    ex = GraphExecutor(model, compute_dtype="bfloat16")
    params = init_params(model, seed=1)
    kw = dict(num_slots=16, page_size=16, max_context=768,
              prefix_cache=False)
    results, figures = {}, {}
    for what, extra in (("k=1", {}), (f"k={KSTEP}",
                                       dict(decode_steps=KSTEP)),
                        ("spec", dict(spec_k=SPEC_K))):
        eng = ServingEngine(ex, params, **kw, **extra)
        eng.run(rng_requests(c["vocab"])[:2])          # warm-up
        pa.counts.reset()
        steps0 = eng.n_decode_steps
        res, wall = timed_run(lambda: eng.run(rng_requests(c["vocab"])))
        steps = eng.n_decode_steps - steps0
        results[what] = res
        figures[what] = (steps, wall, pa.counts.kernel, pa.counts.plain)
        if pa.counts.plain:
            raise AssertionError(f"[rng] {what}: {pa.counts.plain} plain "
                                 f"paged-attention calls")
        if what == "k=1" and pa.counts.kernel != c["layers"] * steps:
            raise AssertionError(f"[rng] k=1: {pa.counts.kernel} K5 "
                                 f"launches for {steps} steps")
        if what == f"k={KSTEP}":
            noise_cost(eng, KSTEP, smi)
        del eng
    want = results["k=1"]
    same = {what: sorted(r) == sorted(want) and all(
        np.array_equal(r[i], want[i]) for i in want)
        for what, r in results.items()}
    log(f"[rng] {RNG_REQUESTS} sampled requests (mixed temperature, top_k, "
        f"top_p) at vocab {c['vocab']}, dim {c['dim']}, {c['layers']} "
        f"layers: " + "; ".join(
            f"{w} {s} steps {wall:.0f} ms, K5 launches {n}"
            for w, (s, wall, n, _) in figures.items())
        + f"; tokens at k={KSTEP} and with spec "
        f"{'equal k=1' if all(same.values()) else 'DIFFER: ' + str(same)}"
        f" [{smi}]")
    if not all(same.values()):
        raise AssertionError("[rng] sampled tokens depend on the decode "
                             "path")


def rng_dropout(smi: str) -> None:
    """The sentiment net trained with dropout (vocab 30000, batch 32, 50
    steps a row): k = KSTEP groups (CUDA graphs reading each step's key
    from the staged buffer) against the k = 1 loop, bit for bit over 12
    batches; one TRAIN step's keep-masks on the card against the port's
    CPU draws from the same keys, bit for bit."""
    from paddle_tpu_torch.models import stacked_lstm_net_config
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils import prng

    vocab, B, T = 30000, 32, 50
    cfg = stacked_lstm_net_config(vocab, batch_size=B)
    batches = sentiment_batches(12, B, T, vocab, seed=3, ragged=True)
    t1, tk = Trainer(cfg, seed=5), Trainer(cfg, seed=5)
    s1, l1 = pass_with_losses(t1, batches, 1)
    sk, lk = pass_with_losses(tk, batches, KSTEP)
    differ = training_state_differs(t1, tk)
    same = s1 == sk and torch.equal(l1, lk) and not differ
    log(f"[rng] sentiment with dropout, 12 batches [{B}, {T}]: k={KSTEP} "
        f"({graph_replays(tk)} graph replays by group size) against k=1: "
        f"losses, parameters, slots, counters and key "
        f"{'bit-identical' if same else 'DIFFER: ' + str(differ[:5])}")
    if not same or not any(graph_replays(tk).values()):
        raise AssertionError("[rng] the k-step groups' dropout is not the "
                             "k = 1 loop's")
    drawn = []
    real = prng.bernoulli

    def recording(key, p, shape=None, device=None):
        mask = real(key, p, shape, device)
        drawn.append((key.clone(), p, shape, mask))
        return mask

    prng.bernoulli = recording
    try:
        t1.compute_gradients(t1.prepare_batch(batches[0]))
    finally:
        prng.bernoulli = real
    torch.cuda.synchronize()
    equal = [m.is_cuda and torch.equal(m.cpu(), real(key.cpu(), p, shape))
             for key, p, shape, m in drawn]
    log(f"[rng] one TRAIN step's {len(drawn)} keep-masks ("
        + ", ".join(str(list(m.shape)) for *_, m in drawn)
        + f") {'equal' if all(equal) else 'DIFFER from'} the port's CPU "
        f"draws from the same keys [{smi}]")
    if not drawn or not all(equal):
        raise AssertionError("[rng] dropout masks on the card differ from "
                             "the CPU's")
    del t1, tk
    torch.cuda.empty_cache()


def phase_rng(smi: str) -> None:
    start = time.perf_counter()
    rng_streams(smi)
    rng_serving(smi)
    rng_dropout(smi)
    log(f"[rng] {time.perf_counter() - start:.1f}s")


# [zoo]: the 25 layer types ported last, in five models built with the
# port's DSL, each at the size its users train it on the card and at a
# small size the CPU tests (tests/test_torch_layers_zoo.py) hold against
# the JAX package: text — nce and hsigmoid over the sentiment demo's
# 30000-word dictionary (Zipf negatives and labels), eos_id; misc — the 16
# combination layers, concat2, sampling_id choosing multiplex's input;
# ctc — an acoustic model's softmax over 29 characters (28 and the blank)
# at 200-256 frames; moe — DECODE_MODEL's width over 4096 valid tokens of
# 8 experts; mdlstm — a 28x28 image grid (MNIST's).
ZOO_SIZES = {
    "text": (dict(vocab=30000, B=32, T=50, emb=128, hidden=256, neg=10),
             dict(vocab=40, B=4, T=5, emb=8, hidden=6, neg=3)),
    "misc": (dict(B=32, F=256, H=64, S=64), dict(B=4, F=12, H=8, S=6)),
    "ctc": (dict(B=16, T=(200, 256), feat=40, hidden=128, C=29,
                 L=(40, 60)),
            dict(B=3, T=(6, 9), feat=5, hidden=6, C=5, L=(1, 3))),
    "moe": (dict(B=16, T=(240, 272), D=512, E=8, H=2048),
            dict(B=3, T=(3, 5), D=8, E=3, H=6)),
    "mdlstm": (dict(B=32, grid=(28, 28), D=32),
               dict(B=3, grid=(2, 3), D=4)),
}
ZOO_KEY = 17                # the TRAIN forward's key (sampling_id, nce)
ZOO_TYPES = ("concat2", "scaling", "slope_intercept", "interpolation",
             "power", "convex_comb", "linear_comb", "cos_vm", "out_prod",
             "tensor", "multiplex", "trans", "resize", "featmap_expand",
             "prelu", "conv_shift", "print", "selective_fc", "moe",
             "mdlstmemory", "sampling_id", "eos_id", "ctc", "nce",
             "hsigmoid")


def _zoo_raw(type_: str, inputs: list, size: int, bias: bool = False):
    """A layer the DSL has no helper for (concat2, prelu; linear_comb,
    whose helper writes convex_comb), as the reference's config parser
    writes it: inputs [(LayerOutput, parameter
    dims or None, projection type or None)]."""
    from paddle_tpu_torch.config.schema import (LayerConfig, LayerInput,
                                                ProjectionConfig)
    from paddle_tpu_torch.dsl.base import LayerOutput, current_context
    from paddle_tpu_torch.dsl.layers import _bias_name, _make_param
    ctx = current_context()
    name = ctx.unique_name(type_)
    cfg = LayerConfig(name=name, type=type_, size=size)
    for i, (inp, dims, proj) in enumerate(inputs):
        li = LayerInput(input_layer_name=inp.name)
        if dims:
            li.input_parameter_name = _make_param(name, i, dims, None)
        if proj:
            li.proj = ProjectionConfig(type=proj, input_size=inp.size,
                                       output_size=dims[-1])
        cfg.inputs.append(li)
    if bias:
        cfg.bias_parameter_name = _bias_name(name, True, [1, size])
    ctx.add_layer(cfg)
    return LayerOutput(name, type_, size, parents=[i[0] for i in inputs])


def _zipf(n: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


def _zoo_text(s: dict) -> None:
    import paddle_tpu_torch.dsl as D
    word = D.data_layer("word", s["vocab"])
    nxt = D.data_layer("next", s["vocab"])
    D.eos_layer(word, eos_id=1)
    emb = D.embedding_layer(word, s["emb"])
    h = D.fc_layer(D.pooling_layer(emb, D.AvgPooling()), s["hidden"],
                   act=D.TanhActivation())
    D.nce_layer(h, nxt, num_classes=s["vocab"], num_neg_samples=s["neg"],
                neg_distribution=_zipf(s["vocab"]).tolist())
    D.hsigmoid(h, nxt, num_classes=s["vocab"])


def _zoo_misc(s: dict) -> None:
    import paddle_tpu_torch.dsl as D
    H = s["H"]
    x = D.data_layer("x", s["F"])
    sel = D.data_layer("sel", s["S"])
    label = D.data_layer("label", 10)

    def fc(size, act):
        return D.fc_layer(x, size, act=act)

    a, b = fc(H, D.TanhActivation()), fc(H, D.TanhActivation())
    c2 = _zoo_raw("concat2", [(x, [s["F"], H], "fc"), (b, None, None)],
                  2 * H, bias=True)
    w1 = fc(1, D.SigmoidActivation())
    si = D.slope_intercept_layer(D.scaling_layer(w1, c2), slope=2.5,
                                 intercept=-0.75)
    ip = D.interpolation_layer(w1, a, b)
    pw = D.power_layer(w1, fc(H, D.SigmoidActivation()))
    cc = D.convex_comb_layer(fc(4, D.SoftmaxActivation()), c2, H // 2)
    lc = _zoo_raw("linear_comb", [(fc(4, D.LinearActivation()), None, None),
                                  (si, None, None)], H // 2)
    cv = D.cos_sim_vecmat(a, fc(4 * H, D.LinearActivation()), 4, scale=2.0)
    op = D.out_prod_layer(fc(8, D.TanhActivation()), cc)
    tn = D.tensor_layer(a, b, 16)
    sid = D.sampling_id_layer(fc(3, D.SoftmaxActivation()))
    mx = D.multiplex_layer(sid, [a, b, ip])
    tt = D.trans_layer(D.trans_layer(mx))
    rr = D.resize_layer(D.resize_layer(c2, H), 2 * H)
    fe = D.repeat_layer(ip, 3)
    pr = _zoo_raw("prelu", [(si, [1, 8], None)], 2 * H)
    cs = D.conv_shift_layer(a, fc(5, D.SoftmaxActivation()))
    pt = D.print_layer(w1)
    sf = D.selective_fc_layer(a, sel, s["S"], act=D.SoftmaxActivation())
    parts = [pw, cc, lc, cv, op, tn, tt, rr, fe, pr, cs, pt, sf]
    prob = D.fc_layer(D.concat_layer(parts), 10,
                      act=D.SoftmaxActivation())
    D.classification_cost(prob, label)


def _zoo_ctc(s: dict) -> None:
    import paddle_tpu_torch.dsl as D
    frames = D.data_layer("frames", s["feat"])
    chars = D.data_layer("chars", s["C"])
    h = D.fc_layer(frames, s["hidden"], act=D.TanhActivation())
    prob = D.fc_layer(h, s["C"], act=D.SoftmaxActivation())
    D.ctc_layer(prob, chars, size=s["C"], norm_by_times=True)


def _zoo_moe(s: dict) -> None:
    import paddle_tpu_torch.dsl as D
    x = D.data_layer("x", s["D"])
    y = D.moe_layer(x, num_experts=s["E"], expert_hidden=s["H"], top_k=2,
                    capacity_factor=1.25, aux_weight=0.01)
    prob = D.fc_layer(D.pooling_layer(y, D.AvgPooling()), 10,
                      act=D.SoftmaxActivation())
    D.classification_cost(prob, D.data_layer("label", 10))


def _zoo_mdlstm(s: dict) -> None:
    import paddle_tpu_torch.dsl as D
    height, width = s["grid"]
    pix = D.data_layer("pixels", 1)
    g = D.fc_layer(pix, 5 * s["D"], act=D.LinearActivation())
    h = D.mdlstm_layer(g, height, width, directions=(True, False))
    prob = D.fc_layer(D.pooling_layer(h, D.MaxPooling()), 10,
                      act=D.SoftmaxActivation())
    D.classification_cost(prob, D.data_layer("label", 10))


def _zoo_lengths(rng, B: int, span: tuple) -> np.ndarray:
    return rng.integers(span[0], span[1] + 1, B).astype(np.int32)


def zoo_feed(name: str, s: dict, seed: int = 0) -> dict:
    """A batch for zoo model `name` at sizes s: {data layer: ("value" |
    "ids", array, lengths or None)}."""
    rng = np.random.default_rng(seed)
    B = s["B"]
    if name == "text":
        lens = _zoo_lengths(rng, B, (s["T"] // 2, s["T"]))
        p = _zipf(s["vocab"])
        return {"word": ("ids", rng.choice(s["vocab"], (B, s["T"]), p=p)
                         .astype(np.int32), lens),
                "next": ("ids", rng.choice(s["vocab"], B, p=p)
                         .astype(np.int32), None)}
    if name == "misc":
        return {"x": ("value", rng.normal(size=(B, s["F"]))
                      .astype(np.float32), None),
                "sel": ("value", (rng.uniform(size=(B, s["S"])) < 0.5)
                        .astype(np.float32), None),
                "label": ("ids", rng.integers(0, 10, B).astype(np.int32),
                          None)}
    if name == "ctc":
        T, L = s["T"], s["L"]
        lens = _zoo_lengths(rng, B, L)
        return {"frames": ("value", rng.normal(size=(B, T[1], s["feat"]))
                           .astype(np.float32), _zoo_lengths(rng, B, T)),
                "chars": ("ids", rng.integers(0, s["C"] - 1, (B, L[1]))
                          .astype(np.int32), lens)}
    if name == "moe":
        T = s["T"]
        lens = np.where(np.arange(B) < B // 2, T[1], T[0]).astype(np.int32)
        return {"x": ("value", rng.normal(size=(B, T[1], s["D"]))
                      .astype(np.float32), lens),
                "label": ("ids", rng.integers(0, 10, B).astype(np.int32),
                          None)}
    if name == "mdlstm":
        cells = s["grid"][0] * s["grid"][1]
        return {"pixels": ("value", rng.uniform(size=(B, cells, 1))
                           .astype(np.float32),
                           np.full(B, cells, np.int32)),
                "label": ("ids", rng.integers(0, 10, B).astype(np.int32),
                          None)}
    raise KeyError(name)


def zoo_model(name: str, small: bool = False):
    """(TrainerConfig, feed) of zoo model `name`, at its card size or its
    small one."""
    from paddle_tpu_torch.config.parser import parse_config_callable
    s = ZOO_SIZES[name][1 if small else 0]
    build = {"text": _zoo_text, "misc": _zoo_misc, "ctc": _zoo_ctc,
             "moe": _zoo_moe, "mdlstm": _zoo_mdlstm}[name]
    return parse_config_callable(build, s), zoo_feed(name, s)


def zoo_graph_run(model, params: dict, feed: dict, device: str):
    """GraphExecutor.loss in TRAIN mode (key PRNGKey(ZOO_KEY)) and its
    backward on `device`, float32: (loss, {layer: Argument}, {cost:
    per-sample cost}, {parameter: gradient}, print-layer lines)."""
    import io

    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.parameter import Argument
    from paddle_tpu_torch.utils import prng
    p = {n: torch.tensor(np.asarray(a), device=device, requires_grad=True)
         for n, a in params.items()}
    f = {}
    for n, (kind, a, lens) in feed.items():
        t = torch.tensor(a, device=device)
        lengths = None if lens is None else torch.tensor(lens, device=device)
        f[n] = Argument(value=t, lengths=lengths) if kind == "value" else \
            Argument(ids=t.long(), lengths=lengths)
    out = io.StringIO()
    with torch.enable_grad(), contextlib.redirect_stdout(out):
        loss, (outs, costs, _) = GraphExecutor(model).loss(
            p, f, rng=prng.PRNGKey(ZOO_KEY, device=device))
        loss.backward()
    printed = [ln for ln in out.getvalue().splitlines()
               if ln.startswith("print layer")]
    return loss, outs, costs, {n: t.grad for n, t in p.items()}, printed


def _zoo_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|): within 1e-4 is within 1e-4
    absolute and relative."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float(((got - want).abs() / (1.0 + want.abs())).max()) \
        if want.numel() else 0.0


def zoo_compare(got: tuple, want: tuple) -> tuple[dict, list]:
    """Two zoo_graph_run results: ({what: max err}, [what differs]) over
    the loss, every layer's values (ids exactly), every cost and every
    gradient, within 1e-4."""
    errs, bad = {"loss": _zoo_err(got[0], want[0])}, []
    for n, w in want[1].items():
        g = got[1][n]
        if (w.ids is None) != (g.ids is None) or (
                w.ids is not None and not torch.equal(g.ids.cpu(),
                                                      w.ids.cpu())):
            bad.append(f"{n} ids")
        if w.value is not None:
            errs[n] = _zoo_err(g.value, w.value)
    for n, w in want[2].items():
        errs[f"cost {n}"] = _zoo_err(got[2][n], w)
    for n, w in want[3].items():
        g = got[3][n]
        if (w is None) != (g is None):
            bad.append(f"d/d{n}")
        elif w is not None:
            errs[f"d/d{n}"] = _zoo_err(g, w)
    if sorted(got[2]) != sorted(want[2]) or len(got[4]) != len(want[4]):
        bad.append("costs or print lines")
    bad += [n for n, e in errs.items() if not e <= 1e-4]
    return errs, bad


def phase_zoo(smi: str) -> None:
    """Each ZOO_SIZES model at its card size: GraphExecutor.loss (TRAIN)
    and its backward on the card against the port on the CPU, float32
    with TF32 off, the same parameters (init_params, seed 1) and batch:
    the loss, every layer's values, every cost and every gradient within
    1e-4, ids exact (sampling_id and nce draw from the same key on
    both)."""
    from paddle_tpu_torch.parameter import init_params
    start = time.perf_counter()
    types_seen, bad = set(), {}
    for name in ZOO_SIZES:
        t0 = time.perf_counter()
        cfg, feed = zoo_model(name)
        model = cfg.model_config
        types_seen |= {lc.type for lc in model.layers}
        params = {n: v.numpy() for n, v in
                  init_params(model, seed=1, device="cpu").items()}
        want = zoo_graph_run(model, params, feed, "cpu")
        t_cpu = time.perf_counter() - t0
        zoo_graph_run(model, params, feed, "cuda")           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = zoo_graph_run(model, params, feed, "cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        errs, bad[name] = zoo_compare(got, want)
        worst = max(errs, key=errs.get)
        n_params = sum(a.size for a in params.values())
        log(f"[zoo] {name}: {len(model.layers)} layers, {n_params:,} "
            f"parameters, batch " + ", ".join(
                f"{n} {list(a.shape)}" for n, (_, a, _) in feed.items())
            + f": loss {float(want[0].detach()):.6g}, {len(errs)} values "
            f"and gradients, worst {worst} {errs[worst]:.2e} (|err| / "
            f"(1 + |CPU|)); card {t_card * 1e3:.1f} ms (second call), CPU "
            f"{t_cpu:.1f} s; print layer lines {len(got[4])}"
            + (f"; FAIL: {bad[name]}" if bad[name] else "") + f" [{smi}]")
    missing = sorted(set(ZOO_TYPES) - types_seen)
    failed = {n: b for n, b in bad.items() if b}
    log(f"[zoo] the {len(ZOO_TYPES)} layer types ported last, in "
        f"{len(ZOO_SIZES)} models, forward and backward on the card "
        + ("within 1e-4 of the CPU, ids exact" if not failed else
           f"DIFFER: {failed}")
        + (f"; not held: {missing}" if missing else "")
        + f" ({time.perf_counter() - start:.1f}s)")
    if missing or failed:
        raise AssertionError(f"[zoo] failed: {failed}, not held: {missing}")


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
    phase("serve-prefix", phase_serve_prefix, smi)
    phase("serve-spec", phase_serve_spec, smi)
    decode = phase("decode", phase_decode, smi)
    spill = phase("serve-spill", phase_serve_spill, smi)
    fleet = phase("serve-fleet", phase_serve_fleet, smi)
    phase("routes", phase_routes)
    phase("flash", phase_flash)
    flash = phase("train", phase_train, smi)
    flash += phase("train-fp32", phase_train_fp32, smi)
    flash += phase("train-routes", phase_train_routes, smi)
    flash += phase("train-jobs", phase_train_jobs, smi)
    phase("lstm", phase_lstm)
    lstm = phase("sentiment", phase_sentiment, smi)
    phase("sentiment-routes", phase_sentiment_routes)
    phase("gru", phase_gru)
    phase("additive", phase_additive)
    seq2seq = phase("seq2seq", phase_seq2seq, smi)
    phase("seq2seq-routes", phase_seq2seq_routes)
    phase("cli", phase_cli, smi)
    phase("image", phase_image, smi)
    tagging = phase("tagging", phase_tagging, smi)
    phase("nested", phase_nested, smi)
    phase("rng", phase_rng, smi)
    phase("zoo", phase_zoo, smi)
    log(f"[done] {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{n} {t:.1f}" for n, t in seconds.items())
        + f"; the profiler around its runs {PROFILER_SECONDS[0]:.1f}")
    print(json.dumps({"kernels": [record] + flash + decode + spill + fleet
                      + lstm + seq2seq + tagging}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
