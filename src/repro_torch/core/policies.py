"""Cache update (eviction) policies.

The paper's key twist is that the *policy is described to the LLM in natural
language* and the LLM executes it; each policy therefore carries both a
programmatic ``victim`` implementation (the paper's "upper bound", Table III)
and a ``describe()`` prompt text (the GPT-driven path). LRU is primary; LFU,
RR, FIFO are the Table II ablations; Belady is a beyond-paper oracle bound.
"""
from __future__ import annotations

import random
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence

from repro_torch.core.cache import CacheEntry


class Policy:
    name = "base"

    def victim(self, entries: Dict[str, CacheEntry]) -> str:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


class LRU(Policy):
    name = "lru"

    def victim(self, entries):
        return min(entries.values(), key=lambda e: e.last_access).key

    def describe(self):
        return ("Least Recently Used (LRU): when the cache is full, evict the "
                "entry whose last access is the OLDEST. Each entry below lists "
                "its last_access timestamp; remove the one with the smallest "
                "last_access, then insert the new key.")


class LFU(Policy):
    name = "lfu"

    def victim(self, entries):
        return min(entries.values(),
                   key=lambda e: (e.access_count, e.last_access)).key

    def describe(self):
        return ("Least Frequently Used (LFU): when the cache is full, evict "
                "the entry with the SMALLEST access_count (break ties by "
                "oldest last_access), then insert the new key.")


class FIFO(Policy):
    name = "fifo"

    def victim(self, entries):
        return min(entries.values(), key=lambda e: e.insert_order).key

    def describe(self):
        return ("First In First Out (FIFO): when the cache is full, evict the "
                "entry that was INSERTED first (smallest insert_order), then "
                "insert the new key.")


class RR(Policy):
    name = "rr"

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def victim(self, entries):
        return self._rng.choice(sorted(entries.keys()))

    def describe(self):
        return ("Random Replacement (RR): when the cache is full, evict a "
                "uniformly random entry, then insert the new key.")


class Belady(Policy):
    """Oracle (beyond-paper upper bound): evicts the entry whose next use is
    farthest in the future. Requires the future key sequence.

    Assigning :attr:`future` indexes it once into per-key sorted position
    lists; each eviction then bisects against :attr:`cursor` — O(cache ×
    log future) per victim instead of the old O(cache × future) linear
    rescan of the remaining request stream. Advance ``cursor`` as requests
    are consumed rather than re-assigning a sliced ``future``.
    """
    name = "belady"

    def __init__(self, future: Optional[Sequence[str]] = None):
        self.cursor = 0
        self.future = list(future or [])   # property: builds the index

    @property
    def future(self) -> List[str]:
        return self._future

    @future.setter
    def future(self, seq: Sequence[str]) -> None:
        self._future = list(seq)
        positions: Dict[str, List[int]] = {}
        for i, k in enumerate(self._future):
            positions.setdefault(k, []).append(i)
        self._positions = positions
        self.cursor = 0

    def victim(self, entries):
        def next_use(key: str) -> int:
            pos = self._positions.get(key)
            if pos:
                j = bisect_left(pos, self.cursor)
                if j < len(pos):
                    return pos[j]
            return 1 << 30
        return max(entries.values(), key=lambda e: next_use(e.key)).key

    def describe(self):
        return ("Belady/MIN oracle: evict the entry whose next use lies "
                "farthest in the future (the provided upcoming-request list "
                "tells you future accesses).")


POLICIES = {"lru": LRU, "lfu": LFU, "fifo": FIFO, "rr": RR, "belady": Belady}


def make_policy(name: str, **kw) -> Policy:
    return POLICIES[name](**kw)
