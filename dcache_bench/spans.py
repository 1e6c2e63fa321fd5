"""The program's own spans in a traced run, lined up with its trace.

``repro_torch.tracing`` records spans in memory while the profiler runs,
stamped with ``time.time_ns()``: the clock of kineto's events, so a span
and the trace's events compare without a conversion. This module takes
them from the program (``take``; a program without the tracer gives none,
and every reader of a span then returns no value), keeps those that meet
the traced window (``of``: taken once per trace, shared by its readers),
clips and merges their intervals to it (``intervals``), measures what two
sets of intervals share (``overlap``), gives the window's idle device time
(``idle``), and lays spans over the trace as host ranges
(``with_ranges``), so ``Trace.launches_in`` and
``Trace.device_s_launched_in`` attribute launches and device time to them.

Spans (name: parent; counts): ``engine.step`` (rows, admitted),
``engine.queue`` (no parent; ends where its admission starts),
``engine.admit``: engine.step (tokens, padded), ``model.prefill``:
engine.admit, ``model.decode``: engine.step, ``engine.sync``:
engine.admit or engine.step, ``moe.experts``: the model span. Each
carries ``start``, ``end`` (ns), ``id``, ``parent`` (0 for none) and the
counts (None where a span takes none).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from dcache_bench.trace import Event, Trace

Interval = Tuple[int, int]

_taken: Tuple[Optional[Trace], Optional[List]] = (None, None)


def take() -> Optional[List]:
    """Every span the program has recorded, cleared from its records, or
    None for a program with no tracer."""
    try:
        import repro_torch.tracing as tracing
    except ModuleNotFoundError as e:
        if e.name != "repro_torch.tracing":
            raise
        return None
    return tracing.take()


def of(ctx) -> Optional[List]:
    """The spans that meet the traced window, or None where there is no
    trace or no span. The program's records are taken at the first call
    for a trace and shared by the later ones."""
    global _taken
    tr = ctx.trace
    if tr is None:
        return None
    if _taken[0] is not tr:
        got = [s for s in take() or () if s.end > tr.t0 and s.start < tr.t1]
        _taken = (tr, got or None)
    return _taken[1]


def pure_steps(spans: Iterable) -> List:
    """The ``engine.step`` spans that admitted nothing and decoded."""
    return [s for s in spans if s.name == "engine.step"
            and s.admitted == 0 and s.rows]


def intervals(spans: Iterable, t0: int, t1: int) -> List[Interval]:
    """The union of the spans' intervals, clipped to [t0, t1], sorted."""
    merged: List[List[int]] = []
    for a, b in sorted((max(s.start, t0), min(s.end, t1)) for s in spans):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def overlap(xs: List[Interval], ys: List[Interval]) -> int:
    """Nanoseconds two sorted lists of disjoint intervals share."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(tr: Trace) -> List[Interval]:
    """The window's intervals with no device operation running."""
    out, at = [], tr.t0
    for a, b in tr.busy_intervals():
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if tr.t1 > at:
        out.append((at, tr.t1))
    return out


def with_ranges(tr: Trace, name: str, spans: Iterable) -> Trace:
    """``tr`` with the spans added to its host events as ranges ``name``."""
    return Trace(tr.host + [Event(name, s.start, s.end) for s in spans], tr.device)
