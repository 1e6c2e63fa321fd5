"""Deterministic latency accounting + discrete-event queue helpers.

The paper measures wall-clock on an Azure deployment with hundreds of GPT
endpoints. Offline we account *modeled* latency on a deterministic clock so
every benchmark is exactly reproducible; constants are calibrated so that
absolute per-task times land in the paper's 5-7 s range and the cache-vs-DB
ratio is in the paper's 5-10x band (DESIGN §9).

:class:`EventQueue` is the scheduling primitive behind the event-granular
concurrent engine (``repro_torch.agent.concurrency``): a time-ordered heap with a
deterministic total order — (time, priority, tiebreak) — so simulations are
bit-reproducible regardless of heap internals. See docs/architecture.md for
the determinism contract.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class LatencyModel:
    # LLM endpoint
    llm_round_base_s: float = 0.20        # request overhead
    llm_prefill_s_per_tok: float = 2.0e-5
    llm_decode_s_per_tok: float = 6.5e-3
    # data plane
    db_load_base_s: float = 0.62          # remote DB / blob storage
    db_load_s_per_mb: float = 0.003
    cache_read_base_s: float = 0.10       # local (the 5-10x faster path)
    cache_read_s_per_mb: float = 0.0002
    # generic tool execution
    tool_op_s: float = 0.03

    def llm_round(self, prompt_tokens: int, completion_tokens: int) -> float:
        return (self.llm_round_base_s
                + prompt_tokens * self.llm_prefill_s_per_tok
                + completion_tokens * self.llm_decode_s_per_tok)

    def db_load(self, size_mb: float) -> float:
        return self.db_load_base_s + size_mb * self.db_load_s_per_mb

    def cache_read(self, size_mb: float) -> float:
        return self.cache_read_base_s + size_mb * self.cache_read_s_per_mb


class SimClock:
    """Monotonic simulated clock; tools/LLM calls advance it."""

    def __init__(self, latency: LatencyModel | None = None):
        self._t = 0.0
        self.latency = latency or LatencyModel()

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> float:
        assert seconds >= 0.0, seconds
        self._t += seconds
        return self._t

    def advance_to(self, t: float) -> float:
        """Advance to absolute time ``t`` (no-op if already past it)."""
        if t > self._t:
            self._t = t
        return self._t


# ---------------------------------------------------------------------------
# Discrete-event queue
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled event (the *wrapper* view; the heap stores plain
    tuples — see :class:`EventQueue`).

    Ordering is (time, priority, tiebreak): lower priority values run first
    at equal times (e.g. pod-load completions *before* session resumes, so a
    session resuming exactly at a load's completion time observes the key
    already installed), and ``tiebreak`` (session id, or an insertion
    sequence number) makes the order total and deterministic.
    """
    time: float
    priority: int
    tiebreak: int
    payload: Any = None

    def sort_key(self) -> Tuple[float, int, int]:
        return (self.time, self.priority, self.tiebreak)


class EventQueue:
    """Deterministic time-ordered event heap for discrete-event simulation.

    ``push``/``pop`` are O(log n); the pop order is the total order
    (time, priority, tiebreak, insertion-seq), never heap insertion order,
    so simulations driven off this queue are bit-reproducible.

    The heap holds plain ``(time, priority, tiebreak, seq, payload)``
    tuples — no per-event object allocation on the hot path (the concurrent
    engine pushes/pops one event per clock advance). ``pop``/``peek``/
    ``drain`` wrap the tuple in an :class:`Event` for callers that want the
    named view; :meth:`pop_payload` is the allocation-free fast path the
    scheduler uses. The unique ``seq`` component also guarantees the tuple
    comparison never reaches ``payload`` (which may be unorderable).
    """

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, int, int, Any]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, time: float, priority: int = 0,
             tiebreak: Optional[int] = None, payload: Any = None) -> None:
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap,
                       (time, priority, seq if tiebreak is None else tiebreak,
                        seq, payload))

    def pop(self) -> Event:
        t, pri, tb, _, payload = heapq.heappop(self._heap)
        return Event(t, pri, tb, payload)

    def pop_payload(self) -> Any:
        """Pop the next event, returning only its payload (the scheduler's
        fast path — same total order as :meth:`pop`)."""
        return heapq.heappop(self._heap)[4]

    def pop_timed(self) -> Tuple[float, Any]:
        """Pop the next event as ``(time, payload)`` — the scheduler's fast
        path when it also drives time-epoch work (e.g. the replicator)."""
        item = heapq.heappop(self._heap)
        return item[0], item[4]

    def peek(self) -> Event:
        t, pri, tb, _, payload = self._heap[0]
        return Event(t, pri, tb, payload)

    def drain(self) -> Iterator[Event]:
        """Pop events in order until the queue is empty (events pushed
        while draining are sequenced into the same order)."""
        while self._heap:
            yield self.pop()
