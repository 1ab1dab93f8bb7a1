"""KV-aware placement: prefix affinity first, least-loaded otherwise.

Why affinity matters: PR 7's prefix cache lives INSIDE each replica — a
cached system prompt only pays off when the next request sharing it lands
on the SAME replica.  Under naive fan-out a pool of K popular prefixes
spread over N replicas costs ~K*N cold prefills instead of K, and the
steady-state hit rate drops with every replica added (the fleet bench's
affinity-vs-random A/B measures exactly this).

The index keys on the FIRST page_size-aligned token run of the prompt —
`tuple(prompt[:page_size])` — deliberately mirroring
`serving/prefix_tree.py`'s node granularity: two prompts that agree on
that run share at least one cached page on whichever replica saw either
first, and prompts shorter than one page have nothing cacheable to steer
by (they place least-loaded).  Hashing deeper would split traffic that
shares a long prefix but diverges late (worse: those requests WANT the
same replica); hashing shallower than a page would collide prompts that
share no cached page at all.

The index is a bounded LRU (capacity knob): the router stays a thin
stateless-restartable tier — losing the index costs a few extra cold
prefills, never correctness.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from paddle_tpu_torch.fleet.replica import Replica

#: placement reasons — the `policy` label on fleet_placements_total and
#: the flight recorder's `route` events
AFFINITY = "affinity"
LEAST_LOADED = "least_loaded"
RANDOM = "random"
#: not a mode — the placement REASON stamped when the router routes the
#: decode half of a disaggregated prefill/decode request at the replica
#: its KV pages were just kv_push-mounted on (docs/serving.md)
DISAGG = "disagg"


class AffinityIndex:
    """Bounded LRU: first-page token run -> replica id."""

    def __init__(self, window: int, capacity: int = 8192):
        self.window = int(window)
        self.capacity = int(capacity)
        self._map: OrderedDict = OrderedDict()

    def key_of(self, prompt) -> Optional[tuple]:
        """The first page_size-aligned run, or None when the prompt is
        shorter than one page (nothing cacheable to steer by)."""
        if self.window <= 0 or len(prompt) < self.window:
            return None
        return tuple(int(t) for t in prompt[:self.window])

    def get(self, key) -> Optional[str]:
        rid = self._map.get(key)
        if rid is not None:
            self._map.move_to_end(key)
        return rid

    def put(self, key, rid: str) -> None:
        self._map[key] = rid
        self._map.move_to_end(key)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def drop_replica(self, rid: str) -> int:
        """Forget every key steering at a departed replica (its cached
        pages died with it); returns entries dropped."""
        stale = [k for k, v in self._map.items() if v == rid]
        for k in stale:
            del self._map[k]
        return len(stale)

    def __len__(self):
        return len(self._map)


class PlacementPolicy:
    """Pick a replica for one prompt from the placeable candidates.

    Modes: "affinity" (the default — affinity index, falling back to
    least-loaded and recording the fallback so the NEXT request with the
    same prefix sticks), "least_loaded" (ignore the index), "random"
    (the degenerate baseline the fleet bench A/Bs hit rates against).
    """

    def __init__(self, mode: str = AFFINITY, window: int = 0,
                 capacity: int = 8192, rng=None):
        if mode not in (AFFINITY, LEAST_LOADED, RANDOM):
            raise ValueError(f"unknown placement mode {mode!r}")
        self.mode = mode
        self.index = AffinityIndex(window, capacity)
        import random as _random

        self.rng = rng or _random.Random(0)

    def set_window(self, window: int) -> None:
        """Adopt the fleet's page size once the first replica's hello
        reveals it (the index starts empty, so re-keying is free)."""
        if window and window != self.index.window:
            self.index = AffinityIndex(window, self.index.capacity)

    def place(self, prompt, candidates: list[Replica]) -> tuple[Replica, str]:
        """(replica, reason) — `candidates` must be non-empty (the router
        sheds BEFORE calling when the fleet is saturated)."""
        assert candidates
        if self.mode == RANDOM:
            return self.rng.choice(candidates), RANDOM
        key = self.index.key_of(prompt) if self.mode == AFFINITY else None
        if key is not None:
            rid = self.index.get(key)
            if rid is not None:
                for r in candidates:
                    if r.rid == rid:
                        return r, AFFINITY
                # the remembered replica is gone/draining/saturated:
                # fall through to least-loaded and RE-POINT the key —
                # the new replica is about to cache this prefix, so
                # followers should chase it there, not the old home
        best = min(candidates, key=lambda r: r.score())
        if key is not None:
            self.index.put(key, best.rid)
        return best, LEAST_LOADED
