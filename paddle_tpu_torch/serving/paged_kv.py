"""Paged KV cache: per attention layer a fixed pool of
[num_pages, page_size, h_kv, dh] pages on the device, plus a host-side page
allocator — the counterpart of paddle_tpu/serving/paged_kv.py's
`PagedKVCache` without its prefix sharing, copy-on-write, host spill tier,
page export/import and tensor-parallel sharding (queued in ROADMAP.md).

Physical page 0 is the TRASH page: unmapped table entries are 0, so
writes of empty slots and padding rows land there, and reads of unmapped
logical pages are masked out.  The pool holds 1 + num_slots *
pages_per_slot pages — every slot can fill its whole context, so the pool
is never overcommitted.  The pools are updated in place by the attention
layers.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.parameter.init import torch_dtype


class PagedKVCache:
    """Device page pools + host page allocator for `num_slots` slots."""

    def __init__(self, executor, num_slots: int, page_size: int,
                 pages_per_slot: int, device: torch.device):
        if page_size <= 0 or pages_per_slot <= 0 or num_slots <= 0:
            raise ValueError("page_size, pages_per_slot and num_slots must "
                             "be positive")
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.num_slots = int(num_slots)
        self.num_pages = 1 + self.num_slots * self.pages_per_slot
        dtype = torch_dtype(executor.compute_dtype) \
            if executor.compute_dtype else torch.float32
        self.pools: dict[str, dict[str, torch.Tensor]] = {}
        for l in executor.model.layers:
            if l.type != "multi_head_attention":
                continue
            heads = int(l.attrs["num_heads"])
            h_kv = int(l.attrs.get("num_kv_heads", 0) or heads)
            dh = int(l.size) // heads
            shape = (self.num_pages, self.page_size, h_kv, dh)
            self.pools[l.name] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        if not self.pools:
            raise ValueError("model has no multi_head_attention layers to "
                             "page")
        # table[s, j] = physical page backing logical page j of slot s
        self.table = np.zeros((self.num_slots, self.pages_per_slot), np.int32)
        # bumped by every table write: the engine re-uploads its device copy
        # of the table only when it moved
        self.version = 0
        # pop() hands out page 1 first
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._n_pages = np.zeros(self.num_slots, np.int32)

    @property
    def capacity_tokens(self) -> int:
        """Max tokens (prompt + generated) one slot can hold."""
        return self.pages_per_slot * self.page_size

    @property
    def free_page_count(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def try_grow(self, slot: int, n_tokens: int) -> bool:
        """Ensure `slot` has pages covering `n_tokens` tokens; False when
        the free list is dry (pages already taken stay with the slot)."""
        need = self.pages_for(n_tokens)
        if need > self.pages_per_slot:
            raise ValueError(f"slot {slot}: {n_tokens} tokens exceed the "
                             f"{self.capacity_tokens}-token slot capacity")
        while self._n_pages[slot] < need:
            if not self._free:
                return False
            self.table[slot, self._n_pages[slot]] = self._free.pop()
            self._n_pages[slot] += 1
            self.version += 1
        return True

    def release(self, slot: int) -> None:
        """Return every page of `slot` to the free list (idempotent)."""
        for j in range(int(self._n_pages[slot])):
            self._free.append(int(self.table[slot, j]))
        self.table[slot, :] = 0
        self._n_pages[slot] = 0
        self.version += 1

    def check(self) -> None:
        """Raise AssertionError unless the allocator invariants hold: every
        mapped page is a real page mapped once, and the free list is
        exactly the unmapped pages, without duplicates."""
        mapped = []
        for s in range(self.num_slots):
            n = int(self._n_pages[s])
            row = self.table[s]
            if (row[n:] != 0).any():
                raise AssertionError(f"slot {s} maps pages past its "
                                     f"{n} allocated ones")
            mapped += [int(p) for p in row[:n]]
        if any(not 0 < p < self.num_pages for p in mapped):
            raise AssertionError(f"a slot maps an invalid page: {mapped}")
        if len(set(mapped)) != len(mapped):
            raise AssertionError("a page is mapped twice")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds duplicates")
        if free != set(range(1, self.num_pages)) - set(mapped):
            raise AssertionError(f"free list {sorted(free)} != unmapped "
                                 f"pages")
