"""Paged KV cache: per attention layer a fixed pool of
[num_pages, page_size, h_kv, dh] pages on the device, plus a host-side
refcounted page allocator — the counterpart of
paddle_tpu/serving/paged_kv.py's `PagedKVCache`, with its prefix sharing,
copy-on-write and overcommitted pools.  Not ported (ROADMAP.md): the host
spill tier, page export/import and tensor-parallel sharding.

Physical page 0 is the TRASH page: unmapped table entries are 0, so
writes of empty or paused slots and of padding rows land there, and reads
of unmapped logical pages are masked out.  The pools are updated in place
by the attention layers (and by `ensure_writable`'s page copy).

Sharing (the reference's PR 7 contract):
  * `_ref[p]` counts slot-table mappings of physical page p; `_cached[p]`
    marks pages held read-only by the prefix index
    (serving/prefix_tree.py).  A page returns to the free list only when
    both drop away.
  * a page with `_ref > 1` or `_cached` set is SHARED and never written:
    the engine calls `ensure_writable` before writing into a mapped page,
    which copies it to a private page and remaps (copy-on-write).
  * when the free list runs dry the allocator first asks
    `on_page_pressure(n)` (the prefix index's LRU eviction) to reclaim
    cached refcount-zero pages — eviction before pausing slots,
    preemption last.

`num_pages` defaults to 1 + num_slots * pages_per_slot (every slot can
fill its whole context); a smaller pool is OVERCOMMITTED and the engine
pauses and preempts slots when it runs dry.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.parameter.init import torch_dtype


class PagedKVCache:
    """Device page pools + host page allocator for `num_slots` slots."""

    def __init__(self, executor, num_slots: int, page_size: int,
                 pages_per_slot: int, device: torch.device,
                 num_pages: Optional[int] = None):
        if page_size <= 0 or pages_per_slot <= 0 or num_slots <= 0:
            raise ValueError("page_size, pages_per_slot and num_slots must "
                             "be positive")
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.num_slots = int(num_slots)
        self.num_pages = int(num_pages) if num_pages else \
            1 + self.num_slots * self.pages_per_slot
        if self.num_pages < 2:
            raise ValueError("the pool needs the trash page and one real "
                             "page")
        dtype = torch_dtype(executor.compute_dtype) \
            if executor.compute_dtype else torch.float32
        # layer -> (h_kv, dh)
        self.layer_specs: dict[str, tuple[int, int]] = {}
        self.pools: dict[str, dict[str, torch.Tensor]] = {}
        for l in executor.model.layers:
            if l.type != "multi_head_attention":
                continue
            heads = int(l.attrs["num_heads"])
            h_kv = int(l.attrs.get("num_kv_heads", 0) or heads)
            dh = int(l.size) // heads
            self.layer_specs[l.name] = (h_kv, dh)
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
        self._free = self._canonical_free()
        self._n_pages = np.zeros(self.num_slots, np.int32)
        # per physical page: slot-mapping refcount, prefix-index membership
        self._ref = np.zeros(self.num_pages, np.int32)
        self._cached = np.zeros(self.num_pages, bool)
        # called with the page shortfall when the free list runs dry;
        # returns the pages reclaimed (the engine wires the prefix index's
        # LRU eviction).  None: no reclaimer, fail dry.
        self.on_page_pressure: Optional[Callable[[int], int]] = None
        self.n_cow = 0                  # copy-on-write page copies made

    def _canonical_free(self) -> list:
        """The free list in construction order (pop() hands out page 1
        first); reset() rebuilds exactly this."""
        return list(range(self.num_pages - 1, 0, -1))

    # -- capacity ---------------------------------------------------------
    @property
    def capacity_tokens(self) -> int:
        """Max tokens (prompt + generated) one slot can hold."""
        return self.pages_per_slot * self.page_size

    @property
    def free_page_count(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages not on the free list: slot-mapped or held by the prefix
        index."""
        return (self.num_pages - 1) - len(self._free)

    @property
    def private_pages_in_use(self) -> int:
        """Pages mapped by exactly one slot and not in the prefix index."""
        return int(np.sum((self._ref == 1) & ~self._cached))

    @property
    def shared_pages_in_use(self) -> int:
        """Slot-mapped pages that are shared: mapped by more than one slot,
        or mapped while also in the prefix index."""
        return int(np.sum((self._ref >= 1) &
                          ((self._ref > 1) | self._cached)))

    @property
    def cached_page_count(self) -> int:
        """Pages held only by the prefix index (reclaimable by eviction)."""
        return int(np.sum((self._ref == 0) & self._cached))

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the K/V page pools."""
        return sum(t.numel() * t.element_size()
                   for p in self.pools.values() for t in p.values())

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    # -- allocator --------------------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        """Pop one free page, asking the pressure hook to reclaim when the
        list is dry.  None: the pool is out."""
        if not self._free and self.on_page_pressure is not None:
            self.on_page_pressure(1)
        if not self._free:
            return None
        page = self._free.pop()
        assert self._ref[page] == 0 and not self._cached[page], \
            f"free list held a referenced page {page}"
        return page

    def try_grow(self, slot: int, n_tokens: int, evict: bool = True) -> bool:
        """Ensure `slot` has pages covering `n_tokens` tokens, evicting
        cached prefixes under pressure (unless `evict` is False).  False
        when the pool is dry: pages already taken stay with the slot, and
        the caller pauses it or defers the admission."""
        need = self.pages_for(n_tokens)
        if need > self.pages_per_slot:
            raise ValueError(f"slot {slot}: {n_tokens} tokens exceed the "
                             f"{self.capacity_tokens}-token slot capacity")
        # the whole shortfall in one pressure call (one tree walk)
        shortfall = (need - int(self._n_pages[slot])) - len(self._free)
        if shortfall > 0 and evict and self.on_page_pressure is not None:
            if shortfall > self.cached_page_count:
                # infeasible even after evicting every reclaimable page:
                # fail without evicting, so a doomed retry destroys no
                # cached prefix (a preempted prefill's donated pages among
                # them, which its own re-admission will hit)
                return False
            self.on_page_pressure(shortfall)
        while self._n_pages[slot] < need:
            if not self._free and not evict:
                return False
            page = self._alloc_page()
            if page is None:
                return False
            self._ref[page] = 1
            self.table[slot, self._n_pages[slot]] = page
            self._n_pages[slot] += 1
            self.version += 1
        return True

    def map_shared(self, slot: int, pages) -> None:
        """Map committed (prefix-index) pages read-only into an EMPTY
        slot's table as its first logical pages — the prefix-hit
        admission.  Each page's refcount rises; the slot must never write
        them until `ensure_writable` copies them."""
        assert self._n_pages[slot] == 0, \
            f"slot {slot} is not empty — shared prefixes map at admission"
        assert len(pages) <= self.pages_per_slot
        for j, page in enumerate(pages):
            page = int(page)
            assert 0 < page < self.num_pages and (
                self._ref[page] > 0 or self._cached[page]), \
                f"page {page} is not a live committed page"
            self._ref[page] += 1
            self.table[slot, j] = page
        self._n_pages[slot] = len(pages)
        self.version += 1

    def page_writable(self, page: int) -> bool:
        return self._ref[page] == 1 and not self._cached[page]

    def ensure_writable(self, slot: int, j: int) -> Optional[bool]:
        """Make logical page `j` of `slot` safe to write: a shared page is
        copied to a fresh private page in every layer's k and v pool and
        remapped.  True if it copied, False if the page was private, None
        if a copy was needed but the pool is dry (the caller rolls
        back)."""
        assert j < self._n_pages[slot], f"slot {slot} has no logical page {j}"
        page = int(self.table[slot, j])
        if self.page_writable(page):
            return False
        fresh = self._alloc_page()
        if fresh is None:
            return None
        for pool in self.pools.values():
            for t in pool.values():
                t[fresh].copy_(t[page])
        self._ref[fresh] = 1
        self.table[slot, j] = fresh
        self.version += 1
        self._unref(page)
        self.n_cow += 1
        return True

    def _unref(self, page: int) -> None:
        assert self._ref[page] >= 1, \
            f"page {page} unreferenced below zero (double release?)"
        self._ref[page] -= 1
        if self._ref[page] == 0 and not self._cached[page]:
            self._free.append(page)

    def release(self, slot: int) -> None:
        """Drop every mapping of `slot`: pages no slot maps and the prefix
        index does not hold return to the free list.  Idempotent."""
        for j in range(int(self._n_pages[slot])):
            self._unref(int(self.table[slot, j]))
        self.table[slot, :] = 0
        self._n_pages[slot] = 0
        self.version += 1

    def uncommit_tail(self, slot: int, n_tokens: int) -> int:
        """Release the slot's trailing pages beyond `pages_for(n_tokens)` —
        the speculative verify step's page rollback: draft K/V was written
        into pages grown past the slot's committed length, and a rejected
        suffix leaves them holding only positions no query will attend
        before they are written again.  Tail pages are private (drafts
        never write shared pages; growth allocates fresh ones), which is
        asserted: releasing a shared page here would corrupt a cached
        prefix.  Returns the number of pages released."""
        keep = self.pages_for(n_tokens)
        freed = 0
        while int(self._n_pages[slot]) > keep:
            j = int(self._n_pages[slot]) - 1
            page = int(self.table[slot, j])
            assert self.page_writable(page), \
                f"slot {slot}: uncommit_tail hit shared page {page} at " \
                f"logical index {j}"
            self.table[slot, j] = 0
            self._n_pages[slot] -= 1
            self._unref(page)
            freed += 1
        if freed:
            self.version += 1
        return freed

    def reset(self) -> None:
        """Release every slot, forget all prefix retention and rebuild the
        free list in canonical order, so page placement afterwards is
        reproducible.  The owner of a prefix index clears it too
        (ServingEngine.reset_prefix_cache does both).  Pool contents need
        no zeroing: unmapped pages are unreachable."""
        self.table[:, :] = 0
        self._n_pages[:] = 0
        self._ref[:] = 0
        self._cached[:] = False
        self._free = self._canonical_free()
        self.version += 1

    # -- prefix-index retention -------------------------------------------
    def cache_page(self, page: int) -> None:
        """Mark `page` as held by the prefix index (at donation: the donor
        slot still maps it)."""
        page = int(page)
        assert 0 < page < self.num_pages
        assert self._ref[page] >= 1, \
            f"page {page} donated to the prefix index without a live mapping"
        self._cached[page] = True

    def uncache_page(self, page: int) -> None:
        """Drop prefix-index retention of `page` (eviction); frees it when
        no slot maps it either."""
        page = int(page)
        assert self._cached[page], f"page {page} is not prefix-cached"
        self._cached[page] = False
        if self._ref[page] == 0:
            self._free.append(page)

    # -- invariants (tests and chip_smoke call these) ----------------------
    def check(self) -> None:
        """Raise AssertionError unless the allocator invariants hold:
        refcounts agree with the tables, the free list is exactly the
        unreferenced and uncached pages, without duplicates, and trash
        page 0 is never referenced."""
        ref = np.zeros(self.num_pages, np.int32)
        for s in range(self.num_slots):
            n = int(self._n_pages[s])
            if (self.table[s, n:] != 0).any():
                raise AssertionError(f"slot {s} maps pages past its {n} "
                                     f"allocated ones")
            for j in range(n):
                page = int(self.table[s, j])
                if not 0 < page < self.num_pages:
                    raise AssertionError(f"slot {s} maps invalid page "
                                         f"{page}")
                ref[page] += 1
        if not (ref == self._ref).all():
            raise AssertionError(f"refcounts disagree with tables: "
                                 f"{self._ref.tolist()} vs recomputed "
                                 f"{ref.tolist()}")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds duplicates")
        expect = {p for p in range(1, self.num_pages)
                  if self._ref[p] == 0 and not self._cached[p]}
        if free != expect:
            raise AssertionError(f"free list {sorted(free)} != unreferenced "
                                 f"pages {sorted(expect)}")
        if self._cached[0] or self._ref[0] != 0:
            raise AssertionError("trash page 0 must never be referenced or "
                                 "cached")

    def check_reclaimed(self) -> None:
        """check() plus the end-of-workload invariant: no slot maps a page,
        and every page off the free list is held only by the prefix index
        (evictable on demand)."""
        self.check()
        if self.private_pages_in_use or self.shared_pages_in_use:
            raise AssertionError(
                f"{self.private_pages_in_use} private and "
                f"{self.shared_pages_in_use} shared pages still slot-mapped")
        if self.free_page_count + self.cached_page_count != \
                self.num_pages - 1:
            raise AssertionError(
                f"free {self.free_page_count} + cached "
                f"{self.cached_page_count} != pool {self.num_pages - 1}")
