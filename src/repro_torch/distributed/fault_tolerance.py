"""Fault tolerance: heartbeats, straggler detection, preemption handling (a
copy of ``repro.distributed.fault_tolerance``).

Single-process analogues of the coordinator-side machinery a 1000-node run
needs; every piece is exercised by tests with injected failures:

* ``HeartbeatMonitor``   — per-step timing, straggler z-score detection
                           (the mitigation at scale: re-dispatch the slow
                           host's shard / exclude it at the next re-mesh);
* ``WorkerFailure``      — the injected fault; ``TrainLoop`` restores the
                           last checkpoint and retries (bounded);
* ``PreemptionGuard``    — SIGTERM-style notice -> synchronous checkpoint
                           before exit (testable by invoking the handler).
"""
from __future__ import annotations

import signal
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional


class WorkerFailure(RuntimeError):
    """A (simulated) worker/node failure inside a training step."""


class HeartbeatMonitor:
    def __init__(self, window: int = 50, straggler_sigma: float = 3.0,
                 timeout_s: Optional[float] = None):
        self.window = window
        self.sigma = straggler_sigma
        self.timeout_s = timeout_s
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.failures: List[Dict] = []
        self.last_beat = time.monotonic()

    def record_step(self, step: int, dt: float):
        self.last_beat = time.monotonic()
        hist = self.step_times[-self.window:]
        if len(hist) >= 8:
            mu = statistics.fmean(hist)
            sd = statistics.pstdev(hist) or 1e-9
            if dt > mu + self.sigma * sd:
                self.stragglers.append(step)
        self.step_times.append(dt)

    def record_failure(self, step: int, restored: bool):
        self.failures.append({"step": step, "restored": restored,
                              "t": time.monotonic()})

    def is_straggling(self, dt: float) -> bool:
        hist = self.step_times[-self.window:]
        if len(hist) < 8:
            return False
        mu = statistics.fmean(hist)
        sd = statistics.pstdev(hist) or 1e-9
        return dt > mu + self.sigma * sd

    def healthy(self) -> bool:
        if self.timeout_s is None:
            return True
        return (time.monotonic() - self.last_beat) < self.timeout_s


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps once."""

    def __init__(self, fail_at: List[int]):
        self.fail_at = set(fail_at)
        self.fired = set()

    def __call__(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise WorkerFailure(f"injected node failure at step {step}")


class PreemptionGuard:
    """Checkpoint-on-preemption: arm a signal (or call ``notify`` directly in
    tests); the guard runs ``on_preempt`` exactly once."""

    def __init__(self, on_preempt: Callable[[], None],
                 sig: Optional[int] = None):
        self.on_preempt = on_preempt
        self._fired = threading.Event()
        if sig is not None:
            signal.signal(sig, lambda *_: self.notify())

    def notify(self):
        if not self._fired.is_set():
            self._fired.set()
            self.on_preempt()

    @property
    def preempted(self) -> bool:
        return self._fired.is_set()
