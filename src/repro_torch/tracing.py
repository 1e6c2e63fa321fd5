"""Spans of the serving path, kept in memory on the profiler's clock.

Tracing is on exactly while a torch profiler records
(``torch.autograd._profiler_enabled()``) or inside ``recording()``. Off,
``span`` returns one shared no-op context after a single check: no clock
call, no allocation.

A span records its name, start and end in ``time.time_ns()`` (Unix
nanoseconds, the clock of kineto's ``_KinetoEvent.start_ns()``, so a
profiler trace and the spans line up without a conversion), its own id,
the id of its parent (the innermost span open on the same thread, 0 for
none), and the integer counts a metric reads (``rows``, ``tokens``,
``padded``, ``admitted``; None where a span takes none). Counts are values
the host already holds: tracing adds no device sync. The program emits no
``record_function`` range, because those also show on the device as
annotations a reader would count as busy time.

Records stay in memory, at most ``LIMIT`` of them (past that they are
counted in ``dropped()`` and not kept); ``records()`` reads them and
``take()`` reads and clears them. A process that profiles the engine
again and again calls ``take()`` after each profile, or its records grow
to the bound and stay there.

Spans taken in ``repro_torch``:

- ``engine.step``: all of ``ServingEngine.step()``; counts ``rows`` (active
  after admission) and ``admitted``;
- ``engine.queue``: a request's wait from its submit to the start of its
  admission, recorded at admission; no parent;
- ``engine.admit``: one request's admission; counts ``tokens`` (its
  length) and ``padded`` (the length it is prefilled at);
- ``model.prefill`` and ``model.decode``: the ``prefill_step`` call and
  the ``decode_step`` call;
- ``engine.sync``: each blocking copy to the host;
- ``moe.experts``: the expert products of one MoE layer call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Iterator, List, Optional

import torch

LIMIT = 1_000_000

_profiler_enabled = torch.autograd._profiler_enabled


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    name: str
    start: int = 0          # ns, time.time_ns()
    end: int = 0            # ns
    id: int = 0
    parent: int = 0         # 0: no parent
    rows: Optional[int] = None
    tokens: Optional[int] = None
    padded: Optional[int] = None
    admitted: Optional[int] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, typ, value, tb) -> bool:
        self.end = time.time_ns()
        _local.stack.pop()
        _keep(self)
        return False


class _Off:
    """The shared context ``span`` returns while tracing is off; a count
    set on it (``s.rows = n``) is dropped."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, typ, value, tb) -> bool:
        return False

    def __setattr__(self, name, value) -> None:
        pass


OFF = _Off()

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_records: List[Span] = []
_dropped = 0
_recording = 0


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(span: Span) -> None:
    global _dropped
    with _lock:
        if len(_records) < LIMIT:
            _records.append(span)
        else:
            _dropped += 1


def span(name: str, tokens: Optional[int] = None,
         padded: Optional[int] = None):
    """A context that records one span of ``name`` while tracing is on.
    Counts known only once it is open are set on it (``s.admitted = n``)."""
    if not (_recording or _profiler_enabled()):
        return OFF
    return Span(name, tokens=tokens, padded=padded)


def record(name: str, since: float) -> None:
    """Record a span of ``name`` with no parent, from ``since`` (a
    ``time.perf_counter()`` reading) to now; nothing while tracing is off.
    The start is mapped to ``time.time_ns()`` through the time elapsed."""
    if not (_recording or _profiler_enabled()):
        return
    end = time.time_ns()
    start = end - round((time.perf_counter() - since) * 1e9)
    _keep(Span(name, start, end, next(_ids), 0))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this block, with or without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def records() -> List[Span]:
    """The spans recorded so far, oldest first (a copy of the list)."""
    with _lock:
        return list(_records)


def take() -> List[Span]:
    """The spans recorded so far; clears them and the dropped count."""
    global _records, _dropped
    with _lock:
        out, _records, _dropped = _records, [], 0
    return out


def dropped() -> int:
    """Spans not kept since the last ``take()``, past ``LIMIT``."""
    return _dropped
