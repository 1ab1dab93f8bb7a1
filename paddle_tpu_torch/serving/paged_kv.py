"""Paged KV cache: per attention layer a fixed pool of
[num_pages, page_size, h_kv, dh] pages on the device, plus a host-side
refcounted page allocator — the counterpart of
paddle_tpu/serving/paged_kv.py's `PagedKVCache`, with its prefix sharing,
copy-on-write, overcommitted pools, host spill tier and page export /
import.  Not ported (ROADMAP.md): tensor-parallel sharding.

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

Host spill tier (`spill_bytes_budget` > 0): a cold refcount-zero cached
page that the prefix index would destroy under pressure is copied to host
memory instead (`spill_page`: the page's k and v of every layer gathered
into one buffer, one synchronous device-to-host copy, so the freed page
cannot be written before its bytes left) and its device page freed.  The prefix
index owns the policy (which page spills, which host entry drops for
budget room); this class owns the mechanism and the byte accounting.  An
admission that hits a spilled run takes fresh pages (`take_pages`),
scatters the host copies back (`restore_pages`: one host-to-device copy,
then one in-place `index_copy_` per layer part, the page count padded to
a power of two with rows aimed at trash page 0, as the reference buckets
its scatter) and re-marks them cached (`adopt_restored`).  A restore is a
move: the host copy drops.  `_host_gen` stamps every entry and moves on
reset(), so an entry of a dead generation never restores.

Page transfer (`export_pages` / `import_pages`): committed pages to and
from the reference's wire layout — over layers in sorted name order, the
k block then the v block, each [n, page_size, h_kv, dh] row-major, the
raw bytes through a same-width integer view (bfloat16 has no numpy
dtype); `meta` equals the reference's field for field.  An import
validates everything before it writes the device.

The pools are only ever written in place (`index_put_`, `index_copy_`,
`copy_`): captured decode windows (CUDA graphs) read them by address.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.obs.compile_watch import (_dtype_name,
                                                get_compile_watch,
                                                signature_of)
from paddle_tpu_torch.parameter.init import torch_dtype

# same-width integer dtypes the wire bytes pass through
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


class PagedKVCache:
    """Device page pools + host page allocator for `num_slots` slots."""

    def __init__(self, executor, num_slots: int, page_size: int,
                 pages_per_slot: int, device: torch.device,
                 num_pages: Optional[int] = None,
                 spill_bytes_budget: int = 0):
        if page_size <= 0 or pages_per_slot <= 0 or num_slots <= 0:
            raise ValueError("page_size, pages_per_slot and num_slots must "
                             "be positive")
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.num_slots = int(num_slots)
        # the pools' shards over a model axis: one, as a mesh is refused
        self.tp_shards = 1
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
        self.device = torch.device(device)
        self.dtype = dtype
        # the page's layer parts in wire order (sorted layer name, k then
        # v): the layout of a host entry's flat buffer and of a payload
        self._parts = [(name, part) for name in sorted(self.pools)
                       for part in ("k", "v")]
        self._part_numel = [self.page_size * h * d for name, _ in self._parts
                            for h, d in (self.layer_specs[name],)]
        # the pools' shapes: the signature of the COW copy
        self._pool_sig = signature_of(
            tuple(t for pool in self.pools.values() for t in pool.values()),
            {})
        # -- host spill tier (module docstring) ---------------------------
        # hid -> {"gen", "nbytes", "flat": host tensor of the page's parts}
        self.spill_bytes_budget = int(spill_bytes_budget or 0)
        self._host: dict[int, dict] = {}
        self._next_hid = 1
        self._host_bytes = 0
        self._host_gen = 0              # moved by reset(): the stale-entry
                                        # guard
        self.n_spilled = 0              # pages spilled device -> host (ever)
        self.n_restored = 0             # pages restored host -> device (ever)
        self.n_host_evicted = 0         # host-tier LRU drops (budget)
        self._host_drained = 0          # drops that are neither
        # -- page transfer: committed pages to and from wire bytes --------
        self.n_exported = 0
        self.n_imported = 0

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

    @property
    def pool_bytes_per_shard(self) -> int:
        """Pool bytes resident on each device of the model axis."""
        return self.pool_bytes // self.tp_shards

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
        with get_compile_watch().watch("serving.cow_copy", self._pool_sig):
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
        # drain the host tier and move the generation: an entry surviving
        # a reset would restore K/V of a dead index generation
        self._host_drained += len(self._host)
        self._host.clear()
        self._host_bytes = 0
        self._host_gen += 1
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

    # -- host spill tier ---------------------------------------------------
    @property
    def page_nbytes(self) -> int:
        """Host bytes one spilled page costs: k + v across every layer."""
        item = torch.empty((), dtype=self.dtype).element_size()
        return sum(self._part_numel) * item

    @property
    def host_page_count(self) -> int:
        return len(self._host)

    @property
    def host_bytes(self) -> int:
        return self._host_bytes

    def host_entry_live(self, hid) -> bool:
        """The generation guard: an entry from before the last reset() (or
        one already dropped) never restores."""
        e = self._host.get(int(hid))
        return e is not None and e["gen"] == self._host_gen

    def _wire(self, pages) -> torch.Tensor:
        """Pages `pages` of every part in wire order — each part's
        [n, page_size, h_kv, dh] block in turn — gathered on the device and
        copied to the host in one synchronous copy: [n * E] (for one page,
        the host entry's flat layout)."""
        if len(pages) == 1:
            blocks = [self.pools[name][part][int(pages[0])].reshape(-1)
                      for name, part in self._parts]
        else:
            idx = torch.tensor([int(p) for p in pages], device=self.device)
            blocks = [self.pools[name][part].index_select(0, idx).reshape(-1)
                      for name, part in self._parts]
        return torch.cat(blocks).to("cpu")

    def spill_page(self, page: int) -> Optional[int]:
        """Copy a cold cached page's K/V to the host tier and free the
        device page.  Returns the host id the prefix index stores on its
        node, or None when the budget cannot hold one more page (the index
        makes room first, with drop_host_page).  The copy is synchronous:
        the freed page may be written by the very next forward."""
        page = int(page)
        assert self._ref[page] == 0 and self._cached[page], \
            f"page {page} is not a cold cached page — only refcount-zero " \
            f"prefix-index pages spill"
        nbytes = self.page_nbytes
        if self._host_bytes + nbytes > self.spill_bytes_budget:
            return None
        flat = self._wire([page])
        hid = self._next_hid
        self._next_hid += 1
        self._host[hid] = {"gen": self._host_gen, "nbytes": nbytes,
                           "flat": flat}
        self._host_bytes += nbytes
        self.n_spilled += 1
        self._cached[page] = False          # uncache_page at refcount 0,
        self._free.append(page)             # its contents live on as `hid`
        self.version += 1
        return hid

    def drop_host_page(self, hid, reason: str = "evict") -> None:
        """Forget one host entry.  `reason` keeps the ledger exact: "evict"
        (budget pressure, n_host_evicted), "drain" (cache clear,
        re-donation, stale generation; _host_drained), "restore" (the move
        to the device, counted by restore_pages).  An entry already gone
        is a no-op."""
        e = self._host.pop(int(hid), None)
        if e is None:
            return
        self._host_bytes -= e["nbytes"]
        if reason == "evict":
            self.n_host_evicted += 1
        elif reason == "drain":
            self._host_drained += 1

    def take_pages(self, n: int) -> Optional[list]:
        """Pop `n` free pages for a restore or an import without mapping
        them (one pressure call for the whole shortfall).  None, nothing
        taken, when the pool cannot cover it; untake_pages rolls a batch
        back exactly."""
        n = int(n)
        shortfall = n - len(self._free)
        if shortfall > 0 and self.on_page_pressure is not None:
            if shortfall > self.cached_page_count:
                return None
            self.on_page_pressure(shortfall)
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self._ref[p] == 0 and not self._cached[p], \
                f"free list held a referenced page {p}"
        self.version += 1
        return pages

    def untake_pages(self, pages) -> None:
        """Return a take_pages batch to the free list in the order it came
        off, so page placement stays reproducible."""
        for p in reversed(pages):
            self._free.append(int(p))
        self.version += 1

    def adopt_restored(self, pages) -> None:
        """Mark freshly restored or imported pages as held by the prefix
        index; unlike cache_page no slot maps them yet."""
        for p in pages:
            p = int(p)
            assert 0 < p < self.num_pages and self._ref[p] == 0 and \
                not self._cached[p], f"page {p} is not a fresh taken page"
            self._cached[p] = True

    def _scatter(self, pages, parts: list) -> None:
        """Write `parts` (per part in wire order, [n, numel] on the device)
        into device pages `pages` in place: the page count padded to a
        power of two, pad rows writing zeros to trash page 0, one
        index_copy_ per part."""
        n = len(pages)
        bucket = 1
        while bucket < n:
            bucket *= 2
        idx = np.zeros(bucket, np.int64)            # pad -> trash page 0
        idx[:n] = [int(p) for p in pages]
        with get_compile_watch().observe("serving.spill_restore",
                                         idx, self._pool_sig):
            d_idx = torch.from_numpy(idx).to(self.device)
            for (name, part), src in zip(self._parts, parts):
                pool = self.pools[name][part]
                if bucket > n:
                    src = torch.cat([src, src.new_zeros(bucket - n,
                                                        src.shape[1])])
                pool.index_copy_(0, d_idx,
                                 src.reshape(bucket, *pool.shape[1:]))

    def restore_pages(self, hids, pages) -> None:
        """Scatter each host entry's K/V into its taken device page (one
        host-to-device copy of the entries, then _scatter).  A move: the
        host copies drop here."""
        n = len(hids)
        assert n == len(pages) and n > 0
        dev = torch.stack([self._host[int(h)]["flat"] for h in hids]).to(
            self.device)
        parts, off = [], 0
        for w in self._part_numel:
            parts.append(dev[:, off:off + w])
            off += w
        self._scatter(pages, parts)
        for hid in hids:
            self.drop_host_page(hid, reason="restore")
        self.n_restored += n

    # -- page transfer -----------------------------------------------------
    def export_pages(self, pages) -> tuple[dict, bytes]:
        """Serialize live committed pages: `(meta, payload)`, the payload
        over layers in sorted name order, each layer's k block then its v
        block, [n, page_size, h_kv, dh] row-major, raw bytes.  Pages must
        be live (slot-mapped or prefix-cached)."""
        pages = [int(p) for p in pages]
        assert pages, "export_pages needs at least one page"
        for p in pages:
            assert 0 < p < self.num_pages and (
                self._ref[p] > 0 or self._cached[p]), \
                f"page {p} is not a live committed page"
        n = len(pages)
        host = self._wire(pages)
        wire = host.view(_INT_OF_WIDTH[host.element_size()])
        layers = [{"name": name, "h_kv": self.layer_specs[name][0],
                   "dh": self.layer_specs[name][1],
                   "dtype": _dtype_name(self.dtype)}
                  for name in sorted(self.pools)]
        meta = {"n_pages": n, "page_size": self.page_size, "layers": layers}
        self.n_exported += n
        return meta, wire.numpy().tobytes()

    def import_pages(self, meta: dict, payload: bytes, pages) -> None:
        """Scatter an export_pages payload into freshly taken pages.
        Everything (page count, page size, layer set, each layer's shape
        and dtype, the exact payload length) is validated before any
        device write, and a mismatch raises ValueError, so the caller's
        untake_pages restores the allocator exactly."""
        n = len(pages)
        if int(meta.get("n_pages", -1)) != n:
            raise ValueError(
                f"kv import: blob holds {meta.get('n_pages')} pages, "
                f"caller took {n}")
        if int(meta.get("page_size", -1)) != self.page_size:
            raise ValueError(
                f"kv import: page_size {meta.get('page_size')} != "
                f"pool page_size {self.page_size}")
        layers = meta.get("layers") or []
        if [l.get("name") for l in layers] != sorted(self.pools):
            raise ValueError(
                f"kv import: layer set {[l.get('name') for l in layers]} "
                f"!= pool layers {sorted(self.pools)}")
        dtype = _dtype_name(self.dtype)
        item = torch.empty((), dtype=self.dtype).element_size()
        total = 0
        for l in layers:
            h_kv, dh = self.layer_specs[l["name"]]
            if int(l.get("h_kv", -1)) != h_kv or int(l.get("dh", -1)) != dh \
                    or str(l.get("dtype")) != dtype:
                raise ValueError(
                    f"kv import: layer {l['name']!r} shape/dtype "
                    f"({l.get('h_kv')},{l.get('dh')},{l.get('dtype')}) != "
                    f"pool ({h_kv},{dh},{dtype})")
            total += 2 * n * self.page_size * h_kv * dh * item
        if len(payload) != total:
            raise ValueError(
                f"kv import: payload is {len(payload)} bytes, "
                f"meta declares {total}")
        for p in pages:
            p = int(p)
            assert 0 < p < self.num_pages and self._ref[p] == 0 and \
                not self._cached[p], f"page {p} is not a fresh taken page"
        wide = torch.empty((), dtype=_INT_OF_WIDTH[item]).numpy().dtype
        dev = torch.from_numpy(np.frombuffer(payload, wide).copy()).to(
            self.device).view(self.dtype)
        parts, off = [], 0
        for w in self._part_numel:
            parts.append(dev[off:off + n * w].view(n, w))
            off += n * w
        self._scatter(pages, parts)
        self.n_imported += n

    # -- invariants (tests and chip_smoke call these) ----------------------
    def check(self) -> None:
        """Raise AssertionError unless the allocator invariants hold:
        refcounts agree with the tables, the free list is exactly the
        unreferenced and uncached pages, without duplicates, trash page 0
        is never referenced, and the host tier's accounting holds."""
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
        # the host tier: bytes agree with the entries, every entry is of
        # the current generation, and the tier keeps within its budget
        if self._host_bytes != sum(e["nbytes"] for e in self._host.values()):
            raise AssertionError(f"host-tier bytes {self._host_bytes} "
                                 f"disagree with its entries")
        if any(e["gen"] != self._host_gen for e in self._host.values()):
            raise AssertionError("host tier holds entries of a dead "
                                 "generation")
        if self._host_bytes > self.spill_bytes_budget:
            raise AssertionError(f"host tier {self._host_bytes}B exceeds "
                                 f"the {self.spill_bytes_budget}B budget")

    def check_reclaimed(self) -> None:
        """check() plus the end-of-workload invariant: no slot maps a page,
        every page off the free list is held only by the prefix index
        (evictable on demand), and the spill counters reconcile with the
        host pages still resident."""
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
        if self.host_page_count != self.n_spilled - self.n_restored - \
                self.n_host_evicted - self._host_drained:
            raise AssertionError(
                f"host tier {self.host_page_count} pages != spilled "
                f"{self.n_spilled} - restored {self.n_restored} - evicted "
                f"{self.n_host_evicted} - drained {self._host_drained}")
