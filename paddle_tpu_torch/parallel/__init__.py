"""Parallel-training support of the port.  So far the single-process part
of the barrier statistics (`barrier_stat.BarrierTimer`) and the
mixture-of-experts FFN on one device (`moe`); the mesh, the
data-parallel, pipeline and expert-sharded tiers are queued in
ROADMAP.md."""
