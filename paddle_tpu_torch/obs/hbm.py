"""Device-memory accounting: the hbm_* gauges — the port's copy of
paddle_tpu/obs/hbm.py, reading the CUDA caching allocator.

The KV page pools and the parameters are the two deliberate tenants of a
serving replica's device memory; everything else (prefill activations,
window graphs' pools, a leaked buffer) shows as the gap between them and
the allocator's own accounting.  The gauge names are the reference's:

  * `device_memory_stats()` — `torch.cuda.memory_stats()` and
    `torch.cuda.mem_get_info()` under the reference's keys
    (`bytes_in_use`, `bytes_limit`, ...); None on the CPU (the gauges
    are then absent, as the reference's are on its CPU backend);
  * `live_array_bytes()` — torch has no `jax.live_arrays()`: the caching
    allocator's live bytes and live allocation count
    (`allocated_bytes.all.current`, `allocation.all.current`), None on
    the CPU;
  * `tree_bytes()` / `kv_pool_bytes()` — `numel() * element_size()`
    summed over the params and the paged-KV pools (always available).

Every read is a host-side allocator statistic or tensor metadata: no
kernel launches and no tensor is read, so the metrics render (asyncio
thread) and the history sampler (its own thread) may call these while
the pump thread captures a window graph.  `hbm_collector()` adapts them
into an obs.metrics registry at render time.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_stats() -> Optional[dict]:
    """The current card's allocator statistics under the reference's
    keys, or None when no card is in use (CPU)."""
    if not _cuda_ready():
        return None
    try:
        stats = torch.cuda.memory_stats()
        free, total = torch.cuda.mem_get_info()
    except Exception:                      # noqa: BLE001 — no card, no gauge
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "num_allocs": int(stats.get("allocation.all.allocated", 0)),
            "bytes_free": int(free),
            "bytes_limit": int(total)}


def live_array_bytes() -> Optional[tuple[int, int]]:
    """(bytes, count) of the caching allocator's live allocations, or
    None when no card is in use."""
    if not _cuda_ready():
        return None
    try:
        stats = torch.cuda.memory_stats()
    except Exception:                      # noqa: BLE001
        return None
    return (int(stats.get("allocated_bytes.all.current", 0)),
            int(stats.get("allocation.all.current", 0)))


def tree_bytes(tree) -> int:
    """numel() * element_size() summed over the tensor leaves of a nested
    dict/list/tuple (numpy arrays count their nbytes)."""
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif hasattr(x, "nbytes"):
            total += int(x.nbytes)
    return total


def kv_pool_bytes(kv) -> int:
    """Bytes held by a PagedKVCache's per-layer page pools."""
    return tree_bytes(kv.pools)


def hbm_collector(params_fn: Optional[Callable] = None,
                  kv_fn: Optional[Callable] = None):
    """obs.metrics collector for the hbm_* gauges.  `params_fn()` -> the
    live params; `kv_fn()` -> the PagedKVCache; either may be None.  The
    allocator's gauges are emitted only when it answers: an absent
    `hbm_bytes_in_use` means "no card", a zero would lie."""

    def collect():
        out = []
        stats = device_memory_stats()
        if stats is not None:
            out.append(("hbm_bytes_in_use", "gauge", None,
                        float(stats["bytes_in_use"])))
            out.append(("hbm_bytes_limit", "gauge", None,
                        float(stats["bytes_limit"])))
        live = live_array_bytes()
        if live is not None:
            out.append(("hbm_live_array_bytes", "gauge", None,
                        float(live[0])))
            out.append(("hbm_live_arrays", "gauge", None, float(live[1])))
        if params_fn is not None:
            out.append(("hbm_param_bytes", "gauge", None,
                        float(tree_bytes(params_fn()))))
        if kv_fn is not None:
            out.append(("hbm_kv_pool_bytes", "gauge", None,
                        float(kv_pool_bytes(kv_fn()))))
        return out

    return collect


def hbm_snapshot(params=None, kv=None) -> dict:
    """One-shot dict of everything measurable — the postmortem-bundle
    shape."""
    out: dict = {}
    stats = device_memory_stats()
    if stats is not None:
        out["device_memory_stats"] = stats
    live = live_array_bytes()
    if live is not None:
        out["live_array_bytes"], out["live_arrays"] = live
    if params is not None:
        out["param_bytes"] = tree_bytes(params)
    if kv is not None:
        out["kv_pool_bytes"] = kv_pool_bytes(kv)
    return out
