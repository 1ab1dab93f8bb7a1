"""Parallel-training support of the port.  So far the single-process part
of the barrier statistics (`barrier_stat.BarrierTimer`); the mesh, the
data-parallel and pipeline tiers are queued in ROADMAP.md."""
