"""Radix prefix index over committed KV pages — the counterpart of
paddle_tpu/serving/prefix_tree.py's `PrefixTree`, with its host spill tier
and its flight records.

The index is a radix tree keyed on token-id runs at PAGE granularity:
each node covers exactly `page_size` consecutive token ids and names the
one physical page holding their committed K/V, so a path from the root
spells a prompt prefix in whole pages.  `match` also probes one page
deeper for a partial run — a child whose run starts with the remaining
(< page_size) tokens.  Mapping that boundary page gives an admission up
to page_size - 1 more cached tokens; the request then writes its own
suffix into that page, so the engine copies it first
(PagedKVCache.ensure_writable).

Ownership: the tree holds pages through PagedKVCache's `_cached` mark.  A
node whose page no slot maps is reclaimable; when the allocator runs dry
it calls `evict_for` (wired as `kv.on_page_pressure`), which evicts
least-recently-used LEAVES first — parents outlive their children, and a
page a live slot maps is never evicted.

Two-level eviction (the host spill tier, `kv.spill_bytes_budget` > 0): a
device-eviction victim is first offered to the host tier — the node keeps
its tokens and trades `page` for `host_id` (resident HOST) instead of being
destroyed.  A HOST node's whole subtree is HOST (spills go
device-frontier first), so "no DEVICE child" is "no DEVICE descendant".
Budget room inside the tier comes from dropping the least recently used
HOST leaves; destroying a device node whose children spilled drops that
HOST subtree with it.  A hit on a spilled run is restored by the engine's
admission (`match_nodes`, then `promote`).  Residency: DEVICE is `page >
0, host_id None`; HOST is `page == -1, host_id int`.

Single-threaded: every call happens on the thread driving
ServingEngine.step().
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from paddle_tpu_torch.obs.flight import get_flight_recorder


class _Node:
    __slots__ = ("run", "page", "parent", "children", "by_first",
                 "last_use", "host_id")

    def __init__(self, run: tuple, page: int, parent: Optional["_Node"]):
        self.run = run                  # page_size token ids (() for root)
        self.page = page                # physical page (-1 for the root
        self.host_id = None             # and for HOST nodes, which carry a
        self.parent = parent            # host-tier id instead)
        self.children: dict[tuple, _Node] = {}
        # first token -> children whose run starts with it: the partial
        # probe scans only those
        self.by_first: dict[int, dict[tuple, _Node]] = {}
        self.last_use = 0

    def add_child(self, child: "_Node") -> None:
        self.children[child.run] = child
        self.by_first.setdefault(child.run[0], {})[child.run] = child

    def drop_child(self, child: "_Node") -> None:
        del self.children[child.run]
        d = self.by_first[child.run[0]]
        del d[child.run]
        if not d:
            del self.by_first[child.run[0]]


class PrefixTree:
    """Radix index over committed pages of one PagedKVCache."""

    def __init__(self, kv):
        self.kv = kv
        self.ps = int(kv.page_size)
        self.root = _Node((), -1, None)
        self._clock = 0
        self.flight = get_flight_recorder()
        self.n_nodes = 0
        self.n_evictions = 0
        # set by the engine's restore while it takes fresh pages: pressure
        # eviction then destroys instead of spilling, so the host entries
        # being restored stay put
        self._spill_inhibit = False

    # -- LRU ---------------------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    # -- lookup ------------------------------------------------------------
    def match_nodes(self, tokens) -> \
            tuple[list[_Node], Optional[tuple[_Node, int]]]:
        """Longest cached prefix of `tokens` as nodes, whatever their
        residency (a path is DEVICE nodes, then HOST ones): the whole-page
        path, and `partial` = (boundary node, r) when a child's run also
        matches the next r (1 <= r < page_size, or up to the tokens left)
        tokens.  Ties between partially matching children go to the
        longest match, then the smallest run.  Touches the matched nodes
        for LRU."""
        toks = np.asarray(tokens).reshape(-1)
        node, nodes = self.root, []
        i, n = 0, int(toks.size)
        while n - i >= self.ps:
            child = node.children.get(
                tuple(int(t) for t in toks[i:i + self.ps]))
            if child is None:
                break
            node = child
            self._touch(node)
            nodes.append(child)
            i += self.ps
        partial = None
        rest = tuple(int(t) for t in toks[i:i + self.ps])
        if rest:
            best, best_r = None, 0
            for run, child in node.by_first.get(rest[0], {}).items():
                r = 1
                while r < len(rest) and run[r] == rest[r]:
                    r += 1
                if r > best_r or (r == best_r and
                                  best is not None and run < best.run):
                    best, best_r = child, r
            if best is not None:
                self._touch(best)
                partial = (best, best_r)
        return nodes, partial

    def match(self, tokens) -> tuple[list[int], Optional[tuple[int, int]]]:
        """The DEVICE-resident view of match_nodes: the pages of the
        whole-page path up to its first spilled node, and (boundary page,
        r) when the partial boundary and every run before it are on the
        device.  The caller maps the boundary page too and must copy it
        before its first write."""
        nodes, partial = self.match_nodes(tokens)
        pages = []
        for nd in nodes:
            if nd.host_id is not None:
                return pages, None
            pages.append(nd.page)
        if partial is not None and partial[0].host_id is None:
            return pages, (partial[0].page, partial[1])
        return pages, None

    # -- insertion (donation at retire, preempt and cancel) ----------------
    def insert(self, tokens, pages, adopted: bool = False) -> int:
        """Register `len(pages)` fully committed pages: pages[j] holds the
        K/V of tokens[j*ps:(j+1)*ps].  A run already on the device keeps
        its page (the donor's duplicate frees with the donor's release); a
        new run retains its page through kv.cache_page; a spilled run
        adopts the donor's bit-identical page and drops its host copy.
        Returns the nodes added.

        `adopted=True` is the import's mount: the pages came through
        kv.adopt_restored (already retained, mapped by no slot), so they
        skip cache_page, and a run already on the device frees the
        imported duplicate at once (no donor slot will release it)."""
        toks = np.asarray(tokens).reshape(-1)
        assert toks.size >= len(pages) * self.ps
        node, added = self.root, 0
        for j, page in enumerate(pages):
            run = tuple(int(t) for t in toks[j * self.ps:(j + 1) * self.ps])
            child = node.children.get(run)
            if child is None:
                child = _Node(run, int(page), node)
                node.add_child(child)
                if not adopted:
                    self.kv.cache_page(int(page))
                self.n_nodes += 1
                added += 1
            elif child.host_id is not None:
                # insert walks top-down, so the promoted node's ancestors
                # promoted in this same call: residency stays consistent
                self.kv.drop_host_page(child.host_id, reason="drain")
                child.host_id = None
                child.page = int(page)
                if not adopted:
                    self.kv.cache_page(int(page))
            elif adopted:
                self.kv.uncache_page(int(page))
            self._touch(child)
            node = child
        return added

    # -- eviction (the allocator's page-pressure hook) ----------------------
    def _evictable_leaves(self) -> list[_Node]:
        """The device-eviction frontier: DEVICE nodes no slot maps and
        without DEVICE children."""
        out = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.host_id is not None:
                continue                 # a HOST subtree: nothing on device
            dev = [c for c in node.children.values() if c.host_id is None]
            if dev:
                stack.extend(dev)
            elif self.kv._ref[node.page] == 0:
                out.append(node)
        return out

    def _host_leaves(self) -> list[_Node]:
        """Leaves resident HOST: the host tier's LRU victims (non-empty
        whenever the tier is)."""
        out = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.host_id is not None:
                out.append(node)
        return out

    def _drop_host_node(self, node: _Node, reason: str = "evict") -> None:
        """Detach one HOST leaf and forget its host entry."""
        node.parent.drop_child(node)
        self.kv.drop_host_page(node.host_id, reason=reason)
        node.host_id = None
        self.n_nodes -= 1
        if reason == "evict":
            self.flight.record("prefix_evict", host=True,
                               nodes_left=self.n_nodes)

    def drop_host_subtree(self, top: _Node) -> None:
        """Detach `top` and its all-HOST subtree, draining its host
        entries (a node whose entry is of a dead generation never
        restores)."""
        top.parent.drop_child(top)
        stack = [top]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd.host_id is not None:
                self.kv.drop_host_page(nd.host_id, reason="drain")
                nd.host_id = None
            nd.page = -1
            self.n_nodes -= 1

    def _try_spill(self, victim: _Node) -> bool:
        """Offer a device-eviction victim to the host tier, dropping LRU
        HOST leaves for budget room first.  False: the caller destroys
        it."""
        kv = self.kv
        if self._spill_inhibit or kv.spill_bytes_budget <= 0 or \
                kv.page_nbytes > kv.spill_bytes_budget:
            return False
        while kv.host_bytes + kv.page_nbytes > kv.spill_bytes_budget:
            leaves = self._host_leaves()
            assert leaves, "host tier non-empty but no HOST leaf found"
            self._drop_host_node(min(leaves, key=lambda n: n.last_use))
        page = victim.page
        hid = kv.spill_page(page)
        if hid is None:
            return False
        victim.host_id = hid
        victim.page = -1
        self.flight.record("spill", page=int(page),
                           host_pages=kv.host_page_count,
                           host_bytes=kv.host_bytes)
        return True

    def evict_for(self, n_pages: int) -> int:
        """Reclaim up to `n_pages` DEVICE pages from the least recently
        used frontier nodes.  Each victim is offered to the host tier
        first; one that cannot spill is destroyed with any HOST subtree
        under it.  A victim's parent joins the candidates once it has no
        device child and no slot maps it.  One tree walk per call.
        Returns the pages freed."""
        freed = 0
        heap = [(nd.last_use, i, nd)
                for i, nd in enumerate(self._evictable_leaves())]
        heapq.heapify(heap)
        seq = len(heap)
        while freed < int(n_pages) and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            if not self._try_spill(victim):
                for ch in list(victim.children.values()):
                    self.drop_host_subtree(ch)
                parent.drop_child(victim)
                page, victim.page = victim.page, -1
                self.kv.uncache_page(page)
                self.n_nodes -= 1
                self.flight.record("prefix_evict", page=int(page),
                                   nodes_left=self.n_nodes)
            self.n_evictions += 1
            freed += 1
            if parent is not self.root and \
                    not any(c.host_id is None
                            for c in parent.children.values()) and \
                    self.kv._ref[parent.page] == 0:
                heapq.heappush(heap, (parent.last_use, seq, parent))
                seq += 1
        return freed

    # -- restore (the engine's admission of a hit on a spilled run) ----------
    def promote(self, nodes, pages) -> None:
        """Re-attach restored device pages to their HOST nodes (already
        re-marked cached by kv.adopt_restored), top-down."""
        for nd, page in zip(nodes, pages):
            assert nd.host_id is not None
            nd.host_id = None
            nd.page = int(page)
            self._touch(nd)

    def clear(self) -> None:
        """Forget every node without touching the device allocator — pair
        with kv.reset(), which drops the `_cached` marks.  Host entries
        drain with the nodes that name them (a no-op after kv.reset, which
        empties the tier)."""
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.host_id is not None:
                self.kv.drop_host_page(node.host_id, reason="drain")
                node.host_id = None
        self.root = _Node((), -1, None)
        self.n_nodes = 0

    # -- checkpoints -------------------------------------------------------
    def snapshot(self) -> dict:
        """The nodes in depth-first order, each with its parent's index
        (the root first) and its host id, the LRU clock and the eviction
        count."""
        nodes = []
        stack = [(self.root, -1)]
        while stack:
            node, pidx = stack.pop()
            idx = len(nodes)
            nodes.append({"run": list(node.run), "page": node.page,
                          "host_id": node.host_id,
                          "last_use": node.last_use, "parent": pidx})
            stack.extend((ch, idx) for ch in node.children.values())
        return {"nodes": nodes, "clock": self._clock,
                "n_evictions": self.n_evictions}

    def restore(self, snap: dict) -> None:
        """Rebuild the tree from `snapshot()`'s dict."""
        built: list[_Node] = []
        for nd in snap["nodes"]:
            node = _Node(tuple(nd["run"]), nd["page"],
                         None if nd["parent"] < 0 else built[nd["parent"]])
            node.host_id = nd["host_id"]
            node.last_use = nd["last_use"]
            if node.parent is not None:
                node.parent.add_child(node)
            built.append(node)
        self.root = built[0]
        self.n_nodes = len(built) - 1
        self._clock = snap["clock"]
        self.n_evictions = snap["n_evictions"]
