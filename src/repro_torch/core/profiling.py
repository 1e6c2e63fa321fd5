"""Process-wide cumulative performance counters (``benchmarks.run
--profile``).

A deliberately tiny facility: components bump named counters in bulk at
natural boundaries (an engine run's end, a memo lookup), never per-event in
a hot loop, so the counters are always on and cost nothing measurable. The
benchmark driver snapshots the table before/after each section and writes
the per-phase deltas into the JSON record (schema ``bench_dcache/v3``),
which is what lets a perf regression be localised to a phase *and* a
mechanism (e.g. "the admission table's wall grew because sketch flushes
tripled") without rerunning under a profiler.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict

COUNTERS: Dict[str, float] = defaultdict(float)
_LOCK = threading.Lock()     # --parallel runs cells on a thread pool


def add(name: str, value: float = 1.0) -> None:
    """Accumulate ``value`` into the named counter (thread-safe: the
    read-modify-write must not lose increments under ``--parallel``)."""
    with _LOCK:
        COUNTERS[name] += value


def snapshot() -> Dict[str, float]:
    """Point-in-time copy of every counter."""
    with _LOCK:
        return dict(COUNTERS)


def delta(before: Dict[str, float],
          after: Dict[str, float]) -> Dict[str, float]:
    """Counter increments between two snapshots (zero-delta keys omitted;
    values rounded for stable JSON)."""
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0.0)
        if d:
            out[k] = round(d, 6)
    return out
