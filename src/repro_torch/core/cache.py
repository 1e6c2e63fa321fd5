"""The localized data cache (paper §III, "Cache specifications").

Key = ``dataset-year`` string (temporal granularity — the paper found
long-lat keys too spatially skewed); value = the per-year imagery-metadata
frame (a ``GeoFrame``, 50-100 MB in the paper); capacity = 5 entries.

The cache itself is mechanism only: *who decides* reads/updates is the
controller layer (``repro_torch.core.controller``) — programmatic, or GPT-driven
via prompting (the paper's contribution).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

DEFAULT_CAPACITY = 5


@dataclasses.dataclass
class CacheEntry:
    key: str
    value: Any
    size_bytes: int
    created_at: float
    last_access: float
    access_count: int = 0
    insert_order: int = 0
    # datastore version this copy was read at (mutable data plane).
    # 0 everywhere until a MutationPlan is wired; the coherence layer
    # compares it against the key's current version at every consume.
    version: int = 0


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    puts: int = 0
    drops: int = 0   # explicit removals (replica demotion) — not evictions
    # admission accounting (zero unless an AdmissionPolicy is wired in the
    # controller): full-cache decisions to install vs bypass. A bypassed
    # load streams to the caller without evicting any resident.
    admitted: int = 0
    bypassed: int = 0
    # GPT-hit accounting (paper Table III): decisions where the LLM correctly
    # used the cache when it should have (and main memory when it should have)
    llm_correct_decisions: int = 0
    llm_total_decisions: int = 0

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def gpt_hit_rate(self) -> float:
        if not self.llm_total_decisions:
            return 1.0
        return self.llm_correct_decisions / self.llm_total_decisions


class DataCache:
    """Capacity-bounded key-value cache over tool data."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None):
        self.capacity = capacity
        self._clock = clock or (lambda: float(self._ticks))
        self._ticks = 0
        self._entries: Dict[str, CacheEntry] = {}
        self._insert_counter = 0
        self.stats = CacheStats()

    # -- time ---------------------------------------------------------------
    def _now(self) -> float:
        # strictly monotonic even when the sim clock has not advanced
        # between operations (unique last_access -> deterministic LRU order
        # for both the programmatic policy and the LLM grader)
        self._ticks += 1
        return self._clock() + 1e-9 * self._ticks

    # -- queries ------------------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> List[str]:
        return list(self._entries.keys())

    def entries(self) -> Dict[str, CacheEntry]:
        return dict(self._entries)

    def peek(self, key: str):
        """Read without touching recency/frequency metadata."""
        e = self._entries.get(key)
        return None if e is None else e.value

    def get(self, key: str):
        """Cache read (the ``read_cache`` tool). Raises KeyError on miss —
        a miss surfaces as a failed tool call that the agent re-plans around
        (paper: 'the LLM is prompted to reassess its tool sequence')."""
        e = self._entries.get(key)
        if e is None:
            self.stats.misses += 1
            raise KeyError(f"cache miss: {key!r} not in cache "
                           f"(contents: {sorted(self._entries)})")
        self.stats.hits += 1
        e.last_access = self._now()
        e.access_count += 1
        return e.value

    # -- updates ------------------------------------------------------------
    def entry(self, key: str) -> Optional[CacheEntry]:
        """The live entry object (or None) WITHOUT touching recency or
        frequency metadata — the coherence layer's version/age probe."""
        return self._entries.get(key)

    def put(self, key: str, value: Any, size_bytes: int = 0,
            victim: Optional[str] = None, version: int = 0) -> Optional[str]:
        """Insert ``key``; if full, evict ``victim`` (caller-chosen — the
        controller decides, per the paper's prompt-driven update policy).
        Returns the evicted key, if any."""
        evicted = None
        if key not in self._entries and len(self._entries) >= self.capacity:
            if victim is None or victim not in self._entries:
                raise ValueError(
                    f"cache full and victim {victim!r} invalid "
                    f"(contents: {sorted(self._entries)})")
            del self._entries[victim]
            self.stats.evictions += 1
            evicted = victim
        now = self._now()
        self._insert_counter += 1
        prev = self._entries.get(key)
        self._entries[key] = CacheEntry(
            key=key, value=value, size_bytes=size_bytes, created_at=now,
            last_access=now,
            access_count=prev.access_count if prev else 0,
            insert_order=prev.insert_order if prev else self._insert_counter,
            version=version)
        self.stats.puts += 1
        return evicted

    def drop(self, key: str) -> bool:
        """Explicitly remove ``key`` (replica demotion — distinct from a
        capacity eviction in the stats). Returns whether it was present."""
        if key not in self._entries:
            return False
        del self._entries[key]
        self.stats.drops += 1
        return True

    def apply_state(self, keys: List[str], loader: Callable[[str], Any],
                    size_of: Callable[[Any], int]):
        """Force the cache to exactly ``keys`` (the GPT-driven update path:
        the LLM returns the new cache state as JSON; we reconcile). Invalid
        states (too many keys, dropped-but-needed data) are the LLM's errors
        and are visible in metrics."""
        keys = list(dict.fromkeys(keys))[: self.capacity]
        for k in list(self._entries):
            if k not in keys:
                del self._entries[k]
                self.stats.evictions += 1
        for k in keys:
            if k not in self._entries:
                v = loader(k)
                self.put(k, v, size_of(v))

    # -- serialization for prompts -------------------------------------------
    def contents_json(self) -> str:
        return json.dumps({
            k: {"last_access": e.last_access,
                "access_count": e.access_count,
                "insert_order": e.insert_order,
                "size_mb": round(e.size_bytes / 1e6, 1)}
            for k, e in sorted(self._entries.items())
        }, sort_keys=True)
