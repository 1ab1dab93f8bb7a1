"""Runs of steps as CUDA graphs.

The trainer's fused dispatch (`Trainer.train_one_pass(steps_per_dispatch=
k)`) captures a group of up to k training steps into one
`torch.cuda.CUDAGraph`, and the serving engine's multi-step decode
(`decode_steps=k`) a window of k decode bodies, where the JAX package runs
the k steps inside one `lax.scan`.  One replay runs the whole group or
window.  A `StepGraph` owns one such graph.

The hand-written kernels' wrappers count their launches in Python
(`ops/*.counts`) where they call the launch.  Under capture that call
records the launch into the graph, and it counts once, there.  A replay
runs no Python and moves no count: `StepGraph.replays` counts the replays,
and what a replay launched on the card is read from the profiler's kernel
events (`chip_smoke.py`'s k-step runs).

A capture that fails raises (torch's own error); nothing here falls back to
running the steps eagerly.
"""

from __future__ import annotations

import gc
from typing import Callable, Iterable, Optional

import torch


class StepGraph:
    """One captured run of steps.  `pool` is a
    `torch.cuda.graph_pool_handle()` the graphs of one owner share (safe
    while they all replay on one stream and the owner has read a replay's
    outputs before the next replay); `generators` are the CUDA generators
    the steps draw from besides the default one (registered, so that every
    replay advances each of them as the eager steps would)."""

    def __init__(self, pool=None,
                 generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            if gen.device.type == "cuda":
                self.graph.register_generator_state(gen)
        self.pool = pool
        self.replays = 0

    def capture(self, steps: Callable[[], object]):
        """Capture `steps()` (run once by Python, launching nothing) and
        return what it returned: tensors in the graph's memory, which every
        replay overwrites.  Only this thread's CUDA calls are held to the
        capture's rules ("thread_local"): the trainer's staging thread
        pins host memory and copies the next group on a side stream
        meanwhile, which under the default, process-wide mode would
        invalidate the capture.  The cyclic garbage collector is off
        while it captures: a collection there can free an older graph
        left in a reference cycle, and destroying a graph on the
        capturing thread invalidates the capture."""
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                return steps()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


def new_pool(device: torch.device) -> Optional[object]:
    """A memory pool for the graphs of one owner (None off the card)."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None
