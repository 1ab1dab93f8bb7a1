"""Where a serving step's host time goes, sampled requests against greedy.

    python paddle_tpu_torch/tools/sample_step_profile.py [--rounds 3]

Serves the transformer LM at the serving smoke's width (vocab 32000, dim
512, 8 heads, 2 layers, bfloat16 compute, random weights from seed 1) on
a `ServingEngine` of 16 slots at decode_steps 1, with 32 requests of
32-256 prompt tokens and 64 new tokens each, in two mixes: every fourth
request sampled (temperature 0.8, top_k 50, top_p 0.9, a seed each), and
all greedy.  Each round times one run of each mix (the order swapped from
round to round): ms a step, and the host ms a step inside the engine's
sampling (`ServingEngine._sample`, which waits for the step's forward
when it reads the tokens back) and its forward calls.  Then one run of
each mix under cProfile: the functions with the most own time, in ms a
step, and the sampling step's parts whatever their rank.  The last line
is one JSON object of the numbers.

The script imports whichever `paddle_tpu_torch` comes first on the path,
so `PYTHONPATH=<another checkout>` times that checkout's package with the
same workload.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time

import numpy as np
import torch


# listed under cProfile whatever their rank: the sampling step's parts and
# the calls that can wait for the stream
WATCH = ("_sample", "_draw_noise", "_to_device", "pick_next_chain",
         "replay", "<method 'to' of 'torch._C.TensorBase' objects>",
         "<method 'cpu' of 'torch._C.TensorBase' objects>",
         "<method 'copy_' of 'torch._C.TensorBase' objects>",
         "<method 'pin_memory' of 'torch._C.TensorBase' objects>")


def requests(sampled: bool, vocab: int = 32000):
    from paddle_tpu_torch.serving import Request
    rng = np.random.default_rng(1)
    out = []
    for i in range(32):
        p = rng.integers(2, vocab, int(rng.integers(32, 257)))
        kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1000 + i) \
            if sampled and i % 4 == 0 else {}
        out.append(Request(i, p, max_new=64, **kw))
    return out


class Timed:
    """Wraps a bound method: calls and host seconds spent inside it."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds = fn, 0, 0.0

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **k)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def steps(eng) -> int:
    return eng.n_decode_steps + eng.n_mixed_steps


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_run(eng, sampled: bool) -> dict:
    sample, forward = eng._sample, eng.executor.forward
    eng._sample, eng.executor.forward = Timed(sample), Timed(forward)
    try:
        n0 = steps(eng)
        sync()
        t0 = time.perf_counter()
        eng.run(requests(sampled))
        sync()
        wall = time.perf_counter() - t0
        n = steps(eng) - n0
        return dict(steps=n, ms_step=wall / n * 1e3,
                    sample_ms_step=eng._sample.seconds / n * 1e3,
                    forward_ms_step=eng.executor.forward.seconds / n * 1e3)
    finally:
        eng._sample, eng.executor.forward = sample, forward


def profiled_run(eng, sampled: bool, top: int) -> list:
    prof = cProfile.Profile()
    n0 = steps(eng)
    prof.enable()
    eng.run(requests(sampled))
    sync()
    prof.disable()
    n = steps(eng) - n0
    st = pstats.Stats(prof)
    rows = sorted(((v[2], v[3], k) for k, v in st.stats.items()),
                  reverse=True)
    rows = rows[:top] + [r for r in rows[top:] if r[2][2] in WATCH]
    return [dict(fn=f"{k[0].split('/')[-1]}:{k[1]} {k[2]}",
                 own_ms_step=tt / n * 1e3, cum_ms_step=ct / n * 1e3)
            for tt, ct, k in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sample_step_profile: CUDA is not available")
        return 1
    import paddle_tpu_torch
    from paddle_tpu_torch.graph import GraphExecutor
    from paddle_tpu_torch.models import transformer_lm_config
    from paddle_tpu_torch.parameter import init_params
    from paddle_tpu_torch.serving import ServingEngine
    model = transformer_lm_config(vocab=32000, dim=512, layers=2, heads=8)
    ex = GraphExecutor(model, compute_dtype="bfloat16")
    eng = ServingEngine(ex, init_params(model, seed=1), num_slots=16,
                        page_size=16, max_context=768, prefix_cache=False)
    eng.run(requests(True)[:8])                     # warm-up
    runs = {"sampled": [], "greedy": []}
    for r in range(args.rounds):
        for mix in (("sampled", "greedy") if r % 2 == 0
                    else ("greedy", "sampled")):
            runs[mix].append(timed_run(eng, mix == "sampled"))
    out = dict(label=args.label, package=paddle_tpu_torch.__file__,
               runs=runs, profile={})
    for mix in runs:
        out["profile"][mix] = profiled_run(eng, mix == "sampled", args.top)
    for mix, rows in runs.items():
        for i, row in enumerate(rows):
            print(f"{args.label} {mix} run {i + 1}: {row['steps']} steps, "
                  f"{row['ms_step']:.3f} ms/step; host in _sample "
                  f"{row['sample_ms_step']:.3f}, in forward "
                  f"{row['forward_ms_step']:.3f} ms/step")
    for mix, rows in out["profile"].items():
        print(f"{args.label} {mix} under cProfile, own / cumulative ms a "
              f"step:")
        for row in rows:
            print(f"  {row['own_ms_step']:8.3f} {row['cum_ms_step']:8.3f}  "
                  f"{row['fn']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
