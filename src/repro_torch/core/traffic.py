"""Open-loop traffic: deterministic seeded session-arrival processes.

The base engine is *closed-loop*: a fixed session count, everything
spawned at t=0, the next task issued on completion. That caps "traffic"
at the session count and makes tail wins non-monotone in the remote
penalty (hops decongest queues — the documented locality caveat). This module
is the *open-loop* measurement frame (the paper's "hundreds of GPT
endpoints"/"millions of users" regime): an arrival process emits
``SessionArrival`` events — spawn time + bounded lifetime — which the
engine turns into first-class spawn/retire events on its EventQueue.

Processes (all seeded, all deterministic — ``schedule()`` is a pure
function of the constructor arguments):

* :class:`ClosedLoopTraffic` — the degenerate case: N sessions at t=0,
  unbounded lifetimes. The engine under this process replays the
  closed-loop engine **bit-identically** (the degeneracy contract
  tests/test_traffic.py locks down, like the penalty-1x and
  empty-plan contracts).
* :class:`PoissonTraffic` — homogeneous Poisson arrivals (exponential
  inter-arrival times at ``rate_per_s``) over ``horizon_s``.
* :class:`DiurnalTraffic` — non-homogeneous Poisson with a sinusoidal
  day/night rate profile, generated by Lewis-Shedler thinning against
  the peak rate (exact, not binned).
* :class:`MMPPTraffic` — 2-state Markov-modulated Poisson (bursty):
  exponential dwells alternate a low-rate and a high-rate regime;
  within a regime arrivals are Poisson at that regime's rate. The
  regime switches are themselves sim-time events, so surges have real
  onsets the autoscaler can react to (and over-react to — the warm-up
  gate's test bed).

:class:`TrafficStats` is the engine-side ledger: spawn/retire instants
per session, from which the queueing-theory locks are computed — flow
balance (spawned == completed + in_system, exactly), the time-average
number-in-system L (event-sweep integration, an independent code path
from the sojourn sums), mean sojourn W, and the Little's-law residual
|L - lambda*W| that ties them together.

Everything here fails fast: a non-positive rate, horizon, or lifetime
raises ``ValueError`` at construction — not NaN rows or a stalled sweep
twenty minutes into a capacity run.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "SessionArrival",
    "ArrivalProcess",
    "ClosedLoopTraffic",
    "PoissonTraffic",
    "DiurnalTraffic",
    "MMPPTraffic",
    "TrafficStats",
    "make_traffic",
    "find_knee",
    "slo_attainment",
]

# one-shot guard against pathological configs: a mis-set rate*horizon
# must fail loudly at schedule() time, not OOM the event heap
MAX_ARRIVALS_DEFAULT = 100_000

LifetimeSpec = Union[None, int, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class SessionArrival:
    """One spawn: absolute sim time + task-stream bound.

    ``lifetime_tasks=None`` means the engine default (the closed-loop
    ``tasks_per_session``); a positive int bounds the session to that
    many tasks, after which it retires."""
    at: float
    lifetime_tasks: Optional[int] = None


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_lifetime(lifetime_tasks: LifetimeSpec) -> None:
    if lifetime_tasks is None:
        return
    if isinstance(lifetime_tasks, int):
        _require(lifetime_tasks >= 1,
                 f"lifetime_tasks must be >= 1, got {lifetime_tasks}")
        return
    lo, hi = lifetime_tasks
    _require(1 <= lo <= hi,
             f"lifetime_tasks range must satisfy 1 <= lo <= hi, "
             f"got ({lo}, {hi})")


class ArrivalProcess:
    """Base: a deterministic, seeded session-arrival schedule.

    Subclasses set ``offered_rate`` (mean arrivals/s over the horizon —
    the load axis of the capacity sweep) and implement
    :meth:`_generate`. ``schedule()`` validates and memoizes: two calls
    return the same list object, and the engine may call it once at
    construction to size the fleet."""

    name = "base"
    offered_rate = 0.0

    def __init__(self, *, seed: int = 0,
                 lifetime_tasks: LifetimeSpec = None,
                 max_arrivals: int = MAX_ARRIVALS_DEFAULT):
        _check_lifetime(lifetime_tasks)
        _require(max_arrivals >= 1,
                 f"max_arrivals must be >= 1, got {max_arrivals}")
        self.seed = seed
        self.lifetime_tasks = lifetime_tasks
        self.max_arrivals = max_arrivals
        self._schedule: Optional[List[SessionArrival]] = None

    # -- lifetime sampling ---------------------------------------------------
    def _lifetime(self, rng: random.Random) -> Optional[int]:
        lt = self.lifetime_tasks
        if lt is None or isinstance(lt, int):
            return lt
        lo, hi = lt
        return rng.randint(lo, hi)

    # -- schedule ------------------------------------------------------------
    def _generate(self) -> List[SessionArrival]:  # pragma: no cover
        raise NotImplementedError

    def schedule(self) -> List[SessionArrival]:
        if self._schedule is None:
            sched = self._generate()
            _require(len(sched) >= 1,
                     f"{self.name} arrival schedule is empty — raise the "
                     f"rate or the horizon (offered "
                     f"{self.offered_rate:.4g}/s)")
            _require(len(sched) <= self.max_arrivals,
                     f"{self.name} schedule has {len(sched)} arrivals, "
                     f"over the max_arrivals={self.max_arrivals} guard")
            self._schedule = sched
        return self._schedule

    def __len__(self) -> int:
        return len(self.schedule())


class ClosedLoopTraffic(ArrivalProcess):
    """Degenerate open-loop config: ``n_sessions`` spawns at t=0 with
    unbounded lifetimes. The engine under this process must replay the
    traffic-free engine bit-identically (the degeneracy contract)."""

    name = "closed"

    def __init__(self, n_sessions: int):
        _require(isinstance(n_sessions, int) and n_sessions >= 1,
                 f"n_sessions must be a positive int, got {n_sessions!r}")
        super().__init__(seed=0, lifetime_tasks=None)
        self.n_sessions = n_sessions

    def _generate(self) -> List[SessionArrival]:
        return [SessionArrival(0.0, None) for _ in range(self.n_sessions)]


class PoissonTraffic(ArrivalProcess):
    """Homogeneous Poisson arrivals: exponential inter-arrival times at
    ``rate_per_s``, truncated at ``horizon_s``."""

    name = "poisson"

    def __init__(self, rate_per_s: float, horizon_s: float, *,
                 seed: int = 0, lifetime_tasks: LifetimeSpec = None,
                 max_arrivals: int = MAX_ARRIVALS_DEFAULT):
        _require(rate_per_s > 0.0,
                 f"rate_per_s must be > 0, got {rate_per_s}")
        _require(horizon_s > 0.0,
                 f"horizon_s must be > 0, got {horizon_s}")
        super().__init__(seed=seed, lifetime_tasks=lifetime_tasks,
                         max_arrivals=max_arrivals)
        self.rate_per_s = rate_per_s
        self.horizon_s = horizon_s
        self.offered_rate = rate_per_s

    def expected_sessions(self) -> float:
        return self.rate_per_s * self.horizon_s

    def _generate(self) -> List[SessionArrival]:
        rng = random.Random(self.seed)
        out: List[SessionArrival] = []
        t = rng.expovariate(self.rate_per_s)
        while t < self.horizon_s and len(out) <= self.max_arrivals:
            out.append(SessionArrival(t, self._lifetime(rng)))
            t += rng.expovariate(self.rate_per_s)
        return out


class DiurnalTraffic(ArrivalProcess):
    """Non-homogeneous Poisson with a sinusoidal rate profile:

        rate(t) = base_rate_per_s * (1 - amplitude * cos(2*pi*t/period_s))

    (starts at the trough, peaks mid-period — a day/night cycle).
    Generated by Lewis-Shedler thinning: candidate arrivals at the peak
    rate ``base*(1+amplitude)``, each kept with probability
    ``rate(t)/peak``. Exact for any profile bounded by the peak."""

    name = "diurnal"

    def __init__(self, base_rate_per_s: float, horizon_s: float, *,
                 amplitude: float = 0.8, period_s: float = 120.0,
                 seed: int = 0, lifetime_tasks: LifetimeSpec = None,
                 max_arrivals: int = MAX_ARRIVALS_DEFAULT):
        _require(base_rate_per_s > 0.0,
                 f"base_rate_per_s must be > 0, got {base_rate_per_s}")
        _require(horizon_s > 0.0,
                 f"horizon_s must be > 0, got {horizon_s}")
        _require(0.0 <= amplitude <= 1.0,
                 f"amplitude must be in [0, 1], got {amplitude}")
        _require(period_s > 0.0,
                 f"period_s must be > 0, got {period_s}")
        super().__init__(seed=seed, lifetime_tasks=lifetime_tasks,
                         max_arrivals=max_arrivals)
        self.base_rate_per_s = base_rate_per_s
        self.horizon_s = horizon_s
        self.amplitude = amplitude
        self.period_s = period_s
        self.offered_rate = base_rate_per_s

    def rate_at(self, t: float) -> float:
        return self.base_rate_per_s * (
            1.0 - self.amplitude * math.cos(2.0 * math.pi * t
                                            / self.period_s))

    def expected_sessions(self) -> float:
        """Exact integral of rate(t) over [0, horizon]."""
        w = 2.0 * math.pi / self.period_s
        return self.base_rate_per_s * (
            self.horizon_s - self.amplitude * math.sin(w * self.horizon_s)
            / w)

    def _generate(self) -> List[SessionArrival]:
        rng = random.Random(self.seed)
        peak = self.base_rate_per_s * (1.0 + self.amplitude)
        out: List[SessionArrival] = []
        t = 0.0
        while len(out) <= self.max_arrivals:
            t += rng.expovariate(peak)
            if t >= self.horizon_s:
                break
            if rng.random() * peak <= self.rate_at(t):
                out.append(SessionArrival(t, self._lifetime(rng)))
        return out


class MMPPTraffic(ArrivalProcess):
    """2-state Markov-modulated Poisson process (bursty arrivals).

    The modulating chain alternates a low-rate and a high-rate regime
    with exponential dwell times; within a regime arrivals are Poisson
    at that regime's rate. Exponential memorylessness makes restarting
    the inter-arrival draw at each regime switch exact. Stationary
    occupancy of the high regime is ``dwell_high/(dwell_low+dwell_high)``
    and the mean offered rate is the dwell-weighted rate average (both
    statistically locked in tests/test_traffic.py).

    After ``schedule()`` runs, ``high_time_s``/``low_time_s`` hold the
    realized regime occupancy and ``switches`` the regime transitions."""

    name = "mmpp"

    def __init__(self, rate_low_per_s: float, rate_high_per_s: float,
                 horizon_s: float, *, dwell_low_s: float = 60.0,
                 dwell_high_s: float = 20.0, start_high: bool = False,
                 seed: int = 0, lifetime_tasks: LifetimeSpec = None,
                 max_arrivals: int = MAX_ARRIVALS_DEFAULT):
        _require(rate_low_per_s > 0.0,
                 f"rate_low_per_s must be > 0, got {rate_low_per_s}")
        _require(rate_high_per_s >= rate_low_per_s,
                 f"rate_high_per_s ({rate_high_per_s}) must be >= "
                 f"rate_low_per_s ({rate_low_per_s})")
        _require(horizon_s > 0.0,
                 f"horizon_s must be > 0, got {horizon_s}")
        _require(dwell_low_s > 0.0 and dwell_high_s > 0.0,
                 f"dwell times must be > 0, got "
                 f"({dwell_low_s}, {dwell_high_s})")
        super().__init__(seed=seed, lifetime_tasks=lifetime_tasks,
                         max_arrivals=max_arrivals)
        self.rate_low_per_s = rate_low_per_s
        self.rate_high_per_s = rate_high_per_s
        self.horizon_s = horizon_s
        self.dwell_low_s = dwell_low_s
        self.dwell_high_s = dwell_high_s
        self.start_high = start_high
        d = dwell_low_s + dwell_high_s
        self.offered_rate = (rate_low_per_s * dwell_low_s
                             + rate_high_per_s * dwell_high_s) / d
        self.stationary_high = dwell_high_s / d
        # realized regime stats, filled by _generate()
        self.high_time_s = 0.0
        self.low_time_s = 0.0
        self.switches = 0

    def _generate(self) -> List[SessionArrival]:
        rng = random.Random(self.seed)
        out: List[SessionArrival] = []
        t = 0.0
        high = self.start_high
        self.high_time_s = self.low_time_s = 0.0
        self.switches = 0
        while t < self.horizon_s and len(out) <= self.max_arrivals:
            dwell = rng.expovariate(
                1.0 / (self.dwell_high_s if high else self.dwell_low_s))
            end = min(t + dwell, self.horizon_s)
            rate = self.rate_high_per_s if high else self.rate_low_per_s
            tt = t + rng.expovariate(rate)
            while tt < end and len(out) <= self.max_arrivals:
                out.append(SessionArrival(tt, self._lifetime(rng)))
                tt += rng.expovariate(rate)
            if high:
                self.high_time_s += end - t
            else:
                self.low_time_s += end - t
            t = end
            if t < self.horizon_s:
                high = not high
                self.switches += 1
        return out


def make_traffic(spec, n_sessions: int) -> ArrivalProcess:
    """Resolve the engine's ``traffic=`` argument: an
    :class:`ArrivalProcess` passes through; the string ``"closed"``
    builds the degenerate :class:`ClosedLoopTraffic` over the engine's
    session count (so any existing table cell opts in via one kwarg)."""
    if isinstance(spec, ArrivalProcess):
        return spec
    if spec == "closed":
        return ClosedLoopTraffic(n_sessions)
    raise ValueError(
        f"traffic must be an ArrivalProcess or 'closed', got {spec!r}")


# ---------------------------------------------------------------------------
# Engine-side ledger: flow balance + Little's law inputs
# ---------------------------------------------------------------------------

class TrafficStats:
    """Spawn/retire bookkeeping for one open-loop episode.

    The queueing locks come from here: **flow balance** is exact
    (``spawned == completed + in_system`` by construction — the test
    asserts ``in_system == 0`` at episode end, i.e. nothing leaked);
    **L** (time-average sessions in system) is integrated by an event
    sweep over the spawn/retire instants — deliberately an independent
    code path from the sojourn sums behind **W**, so the Little's-law
    residual ``|L - lambda*W|`` catches bookkeeping bugs in either."""

    def __init__(self, offered_rate: float = 0.0):
        self.offered_rate = offered_rate
        self.spawned_at: Dict[int, float] = {}
        self.retired_at: Dict[int, float] = {}

    # -- recording (called from the engine's event handlers) -----------------
    def note_spawn(self, t: float, sid: int) -> None:
        self.spawned_at[sid] = t

    def note_retire(self, t: float, sid: int) -> None:
        self.retired_at[sid] = t

    # -- derived -------------------------------------------------------------
    @property
    def spawned(self) -> int:
        return len(self.spawned_at)

    @property
    def completed(self) -> int:
        return len(self.retired_at)

    @property
    def in_system(self) -> int:
        return self.spawned - self.completed

    def mean_sojourn_s(self) -> float:
        if not self.retired_at:
            return 0.0
        total = sum(t - self.spawned_at[sid]
                    for sid, t in self.retired_at.items())
        return total / len(self.retired_at)

    def mean_in_system(self, makespan_s: float) -> float:
        """Time-average N(t) over [0, makespan] by event-sweep
        integration (sessions never retired extend to the makespan)."""
        if makespan_s <= 0.0 or not self.spawned_at:
            return 0.0
        deltas = [(t, 1) for t in self.spawned_at.values()]
        deltas += [(min(t, makespan_s), -1)
                   for t in self.retired_at.values()]
        deltas.sort()
        area = 0.0
        n = 0
        prev = 0.0
        for t, d in deltas:
            area += n * (t - prev)
            n += d
            prev = t
        area += n * (makespan_s - prev)
        return area / makespan_s

    def measured_rate(self, makespan_s: float) -> float:
        return self.spawned / makespan_s if makespan_s > 0.0 else 0.0

    def little_residual(self, makespan_s: float) -> float:
        """|L - lambda*W| with lambda measured over the makespan. When
        every session retires inside the horizon this is an identity up
        to float error; a non-tiny residual means the spawn/retire
        ledger itself is wrong."""
        lam = self.measured_rate(makespan_s)
        return abs(self.mean_in_system(makespan_s)
                   - lam * self.mean_sojourn_s())


# ---------------------------------------------------------------------------
# Capacity-sweep helpers (the knee + SLO attainment)
# ---------------------------------------------------------------------------

def slo_attainment(latencies: Sequence[float], slo_s: float) -> float:
    """Fraction of task latencies meeting the SLO target."""
    _require(slo_s > 0.0, f"SLO target must be > 0, got {slo_s}")
    if not latencies:
        return 0.0
    return sum(1 for x in latencies if x <= slo_s) / len(latencies)


def find_knee(points: Sequence[Tuple[float, float]],
              slo_p99_s: float) -> Optional[float]:
    """Max sustainable arrival rate: the largest swept rate whose p99
    task latency meets the SLO. ``points`` is [(rate, p99), ...];
    returns None when no swept rate sustains the target."""
    _require(slo_p99_s > 0.0,
             f"SLO target must be > 0, got {slo_p99_s}")
    ok = [r for r, p99 in points if p99 <= slo_p99_s]
    return max(ok) if ok else None
