"""Radix prefix index over committed KV pages — the counterpart of
paddle_tpu/serving/prefix_tree.py's `PrefixTree`, without its host spill
tier (ROADMAP.md) and its flight records.

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

Single-threaded: every call happens on the thread driving
ServingEngine.step().
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np


class _Node:
    __slots__ = ("run", "page", "parent", "children", "by_first",
                 "last_use")

    def __init__(self, run: tuple, page: int, parent: Optional["_Node"]):
        self.run = run                  # page_size token ids (() for root)
        self.page = page                # physical page (-1 for the root)
        self.parent = parent
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
        self.n_nodes = 0
        self.n_evictions = 0

    # -- LRU ---------------------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    # -- lookup ------------------------------------------------------------
    def match_nodes(self, tokens) -> \
            tuple[list[_Node], Optional[tuple[_Node, int]]]:
        """Longest cached prefix of `tokens` as nodes: the whole-page path,
        and `partial` = (boundary node, r) when a child's run also matches
        the next r (1 <= r < page_size, or up to the tokens left) tokens.
        Ties between partially matching children go to the longest match,
        then the smallest run.  Touches the matched nodes for LRU."""
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
        """match_nodes as physical pages: the whole-page path's pages, and
        (boundary page, r) for a partial match.  The caller maps the
        boundary page too and must copy it before its first write."""
        nodes, partial = self.match_nodes(tokens)
        return ([nd.page for nd in nodes],
                None if partial is None else (partial[0].page, partial[1]))

    # -- insertion (donation at retire, preempt and cancel) ----------------
    def insert(self, tokens, pages) -> int:
        """Register `len(pages)` fully committed pages: pages[j] holds the
        K/V of tokens[j*ps:(j+1)*ps].  A run already present keeps its
        page (the donor's duplicate frees with the donor's release); a new
        run retains its page through kv.cache_page.  Returns the nodes
        added."""
        toks = np.asarray(tokens).reshape(-1)
        assert toks.size >= len(pages) * self.ps
        node, added = self.root, 0
        for j, page in enumerate(pages):
            run = tuple(int(t) for t in toks[j * self.ps:(j + 1) * self.ps])
            child = node.children.get(run)
            if child is None:
                child = _Node(run, int(page), node)
                node.add_child(child)
                self.kv.cache_page(int(page))
                self.n_nodes += 1
                added += 1
            self._touch(child)
            node = child
        return added

    # -- eviction (the allocator's page-pressure hook) ----------------------
    def _evictable_leaves(self) -> list[_Node]:
        """Leaves whose page no slot maps."""
        out = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.kv._ref[node.page] == 0:
                out.append(node)
        return out

    def evict_for(self, n_pages: int) -> int:
        """Reclaim up to `n_pages` pages from the least recently used
        evictable leaves; a victim's parent joins the candidates once it is
        an unmapped leaf.  One tree walk per call.  Returns the pages
        freed."""
        freed = 0
        heap = [(nd.last_use, i, nd)
                for i, nd in enumerate(self._evictable_leaves())]
        heapq.heapify(heap)
        seq = len(heap)
        while freed < int(n_pages) and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            parent.drop_child(victim)
            page, victim.page = victim.page, -1
            self.kv.uncache_page(page)
            self.n_nodes -= 1
            self.n_evictions += 1
            freed += 1
            if parent is not self.root and not parent.children and \
                    self.kv._ref[parent.page] == 0:
                heapq.heappush(heap, (parent.last_use, seq, parent))
                seq += 1
        return freed

    def clear(self) -> None:
        """Forget every node without touching the allocator — pair with
        kv.reset(), which drops the `_cached` marks."""
        self.root = _Node((), -1, None)
        self.n_nodes = 0

    # -- checkpoints -------------------------------------------------------
    def snapshot(self) -> dict:
        """The nodes in depth-first order, each with its parent's index
        (the root first), the LRU clock and the eviction count."""
        nodes = []
        stack = [(self.root, -1)]
        while stack:
            node, pidx = stack.pop()
            idx = len(nodes)
            nodes.append({"run": list(node.run), "page": node.page,
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
            node.last_use = nd["last_use"]
            if node.parent is not None:
                node.parent.add_child(node)
            built.append(node)
        self.root = built[0]
        self.n_nodes = len(built) - 1
        self._clock = snap["clock"]
        self.n_evictions = snap["n_evictions"]
