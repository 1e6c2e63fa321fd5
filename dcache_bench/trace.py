"""The device trace of a sub-window and its reduction to sums.

A traced run (``harness.traced``) runs a few closed-loop steps under
``torch.profiler``; ``from_profiler`` keeps its raw events: the host's
ranges and launch calls, and the device's operations with their times.
The harness's own ranges name what the host was doing: ``bench.window`` around the traced steps, ``bench.step.admit``
or ``bench.step.decode`` around each engine step (a step admits when a call
waits and a slot is free), and ``bench.moe`` around each expert layer call
(``harness`` wraps the program's ``mlp_moe.moe`` in traced runs only).

A device operation is attributed to a host range by the time of the
launch call that enqueued it (linked by the profiler's correlation id), so
time on the device is charged to the layer that launched it and not read
off kernel names.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC",
               "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
NAME_CHARS = 160


@dataclasses.dataclass
class Event:
    name: str
    start: int          # ns
    end: int            # ns
    corr: int = 0


@dataclasses.dataclass
class Trace:
    host: List[Event]       # host ranges and calls
    device: List[Event]     # device operations (kernels, copies, sets)

    def __post_init__(self):
        win = [e for e in self.host if e.name == "bench.window"]
        if len(win) != 1:
            raise ValueError(f"trace: {len(win)} bench.window ranges")
        self.t0, self.t1 = win[0].start, win[0].end
        self.device = sorted((e for e in self.device
                              if not e.name.startswith("bench.")
                              and e.end > self.t0 and e.start < self.t1),
                             key=lambda e: e.start)
        self.launch_at = {e.corr: e.start for e in self.host
                          if e.name in LAUNCH_APIS and e.corr}

    # -- sums -----------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for e in self.device:
            a, b = max(e.start, self.t0), min(e.end, self.t1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_s(self, needle: str) -> float:
        """Device seconds of operations whose name contains ``needle``."""
        return sum(e.end - e.start for e in self.device if needle in e.name) / 1e9

    def ranges(self, name: str) -> List[Event]:
        return sorted((e for e in self.host if e.name == name), key=lambda e: e.start)

    def launches_in(self, name: str) -> Tuple[int, int]:
        """(launch calls inside ranges called ``name``, number of ranges)."""
        rs = self.ranges(name)
        starts = [r.start for r in rs]
        n = 0
        for e in self.host:
            if e.name in LAUNCH_APIS:
                i = bisect.bisect_right(starts, e.start) - 1
                if i >= 0 and e.start <= rs[i].end:
                    n += 1
        return n, len(rs)

    def device_s_launched_in(self, name: str) -> float:
        """Device seconds of operations launched inside ranges ``name``."""
        rs = self.ranges(name)
        starts = [r.start for r in rs]
        total = 0
        for e in self.device:
            at = self.launch_at.get(e.corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= rs[i].end:
                total += e.end - e.start
        return total / 1e9

    # -- breakdown ------------------------------------------------------------
    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for e in self.device:
            k = e.name[:NAME_CHARS]
            by[k] = by.get(k, 0) + e.end - e.start
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time in the window, summed by what the host was
        doing at each gap's middle: the step kind and the innermost host
        call then running (``python`` where none was)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted((e for e in self.host if e.name != "bench.window"),
                      key=lambda e: (e.start, -e.end))
        steps = self.ranges("bench.step.admit") + self.ranges("bench.step.decode")
        steps.sort(key=lambda e: e.start)
        step_starts = [s.start for s in steps]
        by: Dict[str, int] = {}
        stack: List[Event] = []
        j = 0
        for a, b in gaps:
            mid = (a + b) // 2
            while j < len(host) and host[j].start <= mid:
                stack.append(host[j])
                j += 1
            live = [e for e in stack if e.end >= mid]
            stack = live
            ops = [e for e in live if not e.name.startswith("bench.")]
            op = ops[-1].name if ops else "python"
            i = bisect.bisect_right(step_starts, mid) - 1
            step = (steps[i].name[len("bench.step."):]
                    if i >= 0 and mid <= steps[i].end else "between steps")
            key = f"{step}: {op}"[:NAME_CHARS]
            by[key] = by.get(key, 0) + b - a
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def from_profiler(prof) -> Trace:
    """The raw events of a finished ``torch.profiler.profile``."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.correlation_id())
        (host if str(e.device_type()).endswith("CPU") else device).append(ev)
    return Trace(host, device)
