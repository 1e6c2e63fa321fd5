"""Deterministic fault/elasticity layer for the discrete-event engine.

The paper's deployment is an industry-scale platform spanning hundreds of
GPT endpoints — a fleet that size loses pods and gets resized mid-traffic.
This module supplies the *schedule* side of that story as plain sim-time
data, so membership changes can land as first-class
:class:`~repro_torch.agent.geollm.simclock.EventQueue` events with exact ordering
against loads, prefetches and replication epochs (the engine-side semantics
— aborts, retries, warm-up transients — live in
``repro_torch.agent.concurrency``; see docs/architecture.md):

* :class:`FaultPlan`        — a sorted schedule of ``fail``/``restore``/
                              ``scale_out``/``scale_in`` events, plus
                              parametric generators (single, periodic,
                              random-seeded, correlated multi-pod, elastic);
* :class:`RetryPolicy`      — bounded sim-time exponential backoff for
                              sessions whose in-flight load died with its
                              pod;
* :class:`SimFailureInjector` / :class:`SimStragglerDetector` — the seed
  fault-tolerance idioms (``repro_torch.distributed.fault_tolerance``) ported to
  sim time: a deterministic fail-at-sim-times schedule and z-score
  straggler / heartbeat-timeout detection that never touch
  ``time.monotonic()`` (the wall-clock originals stay quarantined to the
  training loop);
* :class:`ThresholdRecovery` / :class:`LLMRecovery` — the GPT-driven
  post-failover decision, mirroring admission/replication's dual-policy
  shape: after a pod dies, each hot key it held is judged *re-warm now*
  (background load onto the new rendezvous owner) vs *lazy refill* (the
  next demand pays); the LLM path prompts with the programmatic rule's
  ``describe()`` text and is graded against it;
* :class:`BacklogAutoscaler` — a simple open-loop policy driving
  ``scale_out``/``scale_in`` from the engine's backlog/EWMA queueing signals.

The degeneracy contract: an **empty** :class:`FaultPlan` (no events, no
autoscaler) replays the fault-free engine bit-identically — locked by
property-based replay in tests/test_faults.py.
"""
from __future__ import annotations

import dataclasses
import json
import random
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

FAIL = "fail"
RESTORE = "restore"
SCALE_OUT = "scale_out"
SCALE_IN = "scale_in"
ACTIONS = (FAIL, RESTORE, SCALE_OUT, SCALE_IN)
# same-instant ordering: capacity arrives before capacity leaves, and a
# restore of pod A runs before a fail of pod B (a correlated plan that
# swaps two pods at one instant never passes through a zero-pod fleet)
_ACTION_ORDER = {SCALE_OUT: 0, RESTORE: 1, FAIL: 2, SCALE_IN: 3}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One membership change at an absolute sim time."""
    at: float
    action: str
    pod: str

    def __post_init__(self):
        assert self.action in ACTIONS, self.action
        assert self.at >= 0.0, self.at


class FaultPlan:
    """A deterministic sim-time schedule of membership changes.

    Events are kept sorted by ``(at, action-order, pod)`` so injecting them
    into the scheduler is order-independent of construction. An empty plan
    is falsy and must replay the fault-free engine bit-identically (the
    degeneracy contract)."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.at, _ACTION_ORDER[e.action], e.pod))

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __iter__(self):
        return iter(self.events)

    def __repr__(self) -> str:
        return f"FaultPlan({self.events!r})"

    # -- parametric generators ------------------------------------------------
    @staticmethod
    def single(pod: str, fail_at: float,
               restore_at: Optional[float] = None) -> "FaultPlan":
        """One pod failure, optionally restored later (cold — its cache
        contents died with it)."""
        evs = [FaultEvent(fail_at, FAIL, pod)]
        if restore_at is not None:
            assert restore_at > fail_at
            evs.append(FaultEvent(restore_at, RESTORE, pod))
        return FaultPlan(evs)

    @staticmethod
    def periodic(pods: Sequence[str], period_s: float, downtime_s: float,
                 start_s: float, horizon_s: float) -> "FaultPlan":
        """Round-robin rolling failures: every ``period_s`` starting at
        ``start_s`` the next pod in ``pods`` fails for ``downtime_s``."""
        assert period_s > 0 and 0 < downtime_s < period_s
        evs, i, t = [], 0, start_s
        while t < horizon_s:
            pod = pods[i % len(pods)]
            evs.append(FaultEvent(t, FAIL, pod))
            evs.append(FaultEvent(t + downtime_s, RESTORE, pod))
            i += 1
            t += period_s
        return FaultPlan(evs)

    @staticmethod
    def random_plan(pods: Sequence[str], n_faults: int, horizon_s: float,
                    downtime_s: float, seed: int = 0,
                    min_gap_s: float = 1.0) -> "FaultPlan":
        """Seeded random failures: ``n_faults`` fail/restore pairs at
        uniform times in ``[min_gap_s, horizon_s)``, pods drawn with
        replacement. Deterministic in ``seed``; a pod already down at its
        drawn fail time simply no-ops (fail is idempotent)."""
        rng = random.Random(seed)
        evs = []
        for _ in range(n_faults):
            t = min_gap_s + rng.random() * max(0.0, horizon_s - min_gap_s)
            pod = pods[rng.randrange(len(pods))]
            evs.append(FaultEvent(t, FAIL, pod))
            evs.append(FaultEvent(t + downtime_s, RESTORE, pod))
        return FaultPlan(evs)

    @staticmethod
    def correlated(pods: Sequence[str], at: float,
                   downtime_s: float) -> "FaultPlan":
        """Correlated multi-pod outage (one rack/zone): every pod in
        ``pods`` fails at the same instant and restores together."""
        evs = [FaultEvent(at, FAIL, p) for p in pods]
        evs += [FaultEvent(at + downtime_s, RESTORE, p) for p in pods]
        return FaultPlan(evs)

    @staticmethod
    def elastic(pod: str, out_at: float,
                in_at: Optional[float] = None) -> "FaultPlan":
        """Fleet resize: add ``pod`` at ``out_at``; optionally retire it
        again at ``in_at`` (its contents re-route like a failure, but it is
        accounted as a scale event, not a failover)."""
        evs = [FaultEvent(out_at, SCALE_OUT, pod)]
        if in_at is not None:
            assert in_at > out_at
            evs.append(FaultEvent(in_at, SCALE_IN, pod))
        return FaultPlan(evs)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded sim-time exponential backoff for aborted in-flight loads.

    A session whose load died with its pod waits ``delay(attempt)`` and
    re-issues against the key's new rendezvous owner; after
    ``max_retries`` aborts of the same key it stops retrying the cache
    path and bypasses to a direct DB read (never a stall-forever)."""
    base_s: float = 0.25
    factor: float = 2.0
    cap_s: float = 8.0
    max_retries: int = 4

    def delay(self, attempt: int) -> float:
        assert attempt >= 1
        return min(self.cap_s, self.base_s * self.factor ** (attempt - 1))


# ---------------------------------------------------------------------------
# Seed fault-tolerance idioms, ported to sim time (never time.monotonic())
# ---------------------------------------------------------------------------

class SimFailureInjector:
    """Sim-clock analogue of the training loop's
    :class:`~repro_torch.distributed.fault_tolerance.FailureInjector`: fail the
    given pods once at given *sim times*. ``plan()`` renders the schedule
    as a :class:`FaultPlan` for the engine; ``due(now)`` drains events up
    to ``now`` for direct driving in tests."""

    def __init__(self, fail_at: Dict[float, str],
                 downtime_s: Optional[float] = None):
        self.schedule = sorted(fail_at.items())
        self.downtime_s = downtime_s
        self._fired: set = set()

    def plan(self) -> FaultPlan:
        evs = []
        for t, pod in self.schedule:
            evs.append(FaultEvent(t, FAIL, pod))
            if self.downtime_s is not None:
                evs.append(FaultEvent(t + self.downtime_s, RESTORE, pod))
        return FaultPlan(evs)

    def due(self, now: float) -> List[Tuple[float, str]]:
        out = [(t, pod) for t, pod in self.schedule
               if t <= now and t not in self._fired]
        self._fired.update(t for t, _ in out)
        return out


class SimStragglerDetector:
    """Sim-time straggler + heartbeat-timeout detection (the
    :class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor` idiom
    with every wall-clock read replaced by the caller's sim ``now``).

    ``record(now, dt)`` feeds one observed load dwell; a dwell more than
    ``sigma`` standard deviations above the trailing-window mean is a
    straggler. ``healthy(now)`` is the heartbeat: false once ``timeout_s``
    of sim time passes without a recorded load."""

    def __init__(self, window: int = 50, sigma: float = 3.0,
                 timeout_s: Optional[float] = None, min_samples: int = 8):
        self.window = window
        self.sigma = sigma
        self.timeout_s = timeout_s
        self.min_samples = min_samples
        self.dwells: List[float] = []
        self.stragglers: List[Tuple[float, float]] = []   # (sim time, dwell)
        self.last_beat = 0.0

    def is_straggling(self, dt: float) -> bool:
        hist = self.dwells[-self.window:]
        if len(hist) < self.min_samples:
            return False
        mu = statistics.fmean(hist)
        sd = statistics.pstdev(hist) or 1e-9
        return dt > mu + self.sigma * sd

    def record(self, now: float, dt: float) -> bool:
        self.last_beat = now
        straggled = self.is_straggling(dt)
        if straggled:
            self.stragglers.append((now, dt))
        self.dwells.append(dt)
        return straggled

    def healthy(self, now: float) -> bool:
        if self.timeout_s is None:
            return True
        return (now - self.last_beat) < self.timeout_s


# ---------------------------------------------------------------------------
# GPT-driven cache recovery (re-warm now vs lazy refill), dual-policy shape
# ---------------------------------------------------------------------------

class RecoveryPolicy:
    """Decides, per hot key lost in a failover, ``"rewarm"`` (issue a
    background load onto the new rendezvous owner now) or ``"lazy"``
    (let the next demand access pay the DB load). Mirrors the
    admission/replication policy shape: a programmatic rule plus a
    natural-language ``describe()`` the GPT-driven path prompts with."""

    name = "base"
    rewarm_min: int = 4

    def decide(self, key: str, freq: int) -> str:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


class ThresholdRecovery(RecoveryPolicy):
    """Re-warm a lost key iff its sketch frequency reaches ``rewarm_min``
    — hot keys pay the failover DB load once, in the background, instead
    of per consumer; cold keys refill lazily (a background load for a key
    nobody re-reads is pure wasted pod bandwidth)."""

    name = "threshold"

    def __init__(self, rewarm_min: int = 4):
        assert rewarm_min >= 1
        self.rewarm_min = rewarm_min

    def decide(self, key, freq):
        return "rewarm" if freq >= self.rewarm_min else "lazy"

    def describe(self):
        return (f"threshold (re-warm NOW when the key's estimated frequency "
                f"is >= {self.rewarm_min}; otherwise refill lazily on the "
                "next demand access). A hot key left cold makes every "
                "consumer pay the failover DB load; a cold key re-warmed "
                "wastes the new owner's bandwidth.")


class LLMRecovery(RecoveryPolicy):
    """GPT-driven recovery: after a failover, the base rule's
    ``describe()`` text plus the sketch evidence are rendered into a
    prompt (``prompts.recovery_decision_prompt``) and the LLM answers
    rewarm/lazy per lost hot key. Graded against the programmatic
    decision; unparseable completions fall back to it. Token cost
    accumulates off the critical path (failover handling is background
    work), surfaced as ``recovery_tokens`` in the episode metrics."""

    def __init__(self, base: RecoveryPolicy, llm, few_shot: bool = True):
        self.base = base
        self.llm = llm
        self.few_shot = few_shot
        self.name = f"llm-{base.name}"
        self.rewarm_min = base.rewarm_min
        self.llm_total = 0
        self.llm_correct = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0
        # resilience fallbacks to the programmatic base (ungraded): garbled
        # prompt/completion vs endpoint pool down
        self.parse_fallbacks = 0
        self.degraded = 0
        self._top_json = "[]"            # evidence block, set per failover

    def describe(self):
        return self.base.describe()

    @property
    def agreement(self) -> float:
        return self.llm_correct / self.llm_total if self.llm_total else 1.0

    def set_evidence(self, top: List[Tuple[str, int]]) -> None:
        self._top_json = json.dumps([{"key": k, "freq": f} for k, f in top])

    def decide(self, key, freq):
        from repro_torch.core.endpoints import LLMUnavailableError
        from repro_torch.core.prompts import LLMParseError, parse_json_tail, \
            recovery_decision_prompt
        prompt = recovery_decision_prompt(
            self.base.describe(), key, freq, self.base.rewarm_min,
            self._top_json, self.few_shot)
        expected = self.base.decide(key, freq)
        try:
            completion = self.llm.complete(prompt)
        except LLMUnavailableError:
            # endpoint pool down: programmatic twin, ungraded (the router
            # already billed the wasted retry tokens)
            self.degraded += 1
            return expected
        except LLMParseError:
            self.parse_fallbacks += 1
            self.prompt_tokens += len(prompt) // 4
            return expected
        self.prompt_tokens += len(prompt) // 4
        self.completion_tokens += len(completion) // 4
        try:
            raw = parse_json_tail(completion)
            decision = raw.get("decision") if isinstance(raw, dict) else None
        except ValueError:
            decision = None
        if decision not in ("rewarm", "lazy"):
            # garbled/meaningless completion: programmatic twin, ungraded
            self.parse_fallbacks += 1
            return expected
        self.llm_total += 1
        self.llm_correct += int(decision == expected)
        return decision


def make_recovery(*, impl: str = "python", llm=None, few_shot: bool = True,
                  rewarm_min: int = 4) -> RecoveryPolicy:
    """Build a recovery policy; ``impl="llm"`` wraps the threshold rule in
    the GPT-driven path (requires an ``llm`` with ``complete()``)."""
    base = ThresholdRecovery(rewarm_min=rewarm_min)
    if impl == "llm":
        assert llm is not None, "LLM-driven recovery needs an llm backend"
        return LLMRecovery(base, llm, few_shot=few_shot)
    return base


# ---------------------------------------------------------------------------
# Autoscaler: scale_out/in from the engine's backlog/EWMA queueing signals
# ---------------------------------------------------------------------------

class BacklogAutoscaler:
    """Open-loop fleet sizing on the contention layer's queueing signals.

    Polled by the scheduler at ``check_every_s`` sim-time boundaries (like
    replication epochs: background bookkeeping, no session clock charged).
    ``decide(now, backlogs)`` looks at the mean demand backlog (seconds of
    queued service) across live pods:

    * mean backlog > ``high_backlog_s``  -> ``"scale_out"`` (add a pod);
    * mean backlog < ``low_backlog_s`` AND this scaler previously added
      pods -> ``"scale_in"`` (retire the most recent addition — the
      initial fleet is never scaled away, so session home pods and the
      rendezvous baseline stay intact);
    * otherwise hold.

    ``cooldown_s`` of sim time must pass between actions (a membership
    change invalidates the very signal that triggered it: the reshuffled
    keys demand-load against their new owners, inflating backlog for a
    while — reacting to that echo would flap).

    **Warm-up-aware gate** (``warmup_aware=True``, closing the naive
    open-loop follow-up): a scale_out is only worth paying when the
    surge is predicted to outlive the warm-up of the pod it adds — the
    rendezvous reshuffle forces ~1/(n+1) of resident keys to re-warm via
    demand loads, and a short burst ends before the new pod serves a
    single warm hit, so the fleet pays the reshuffle twice (out AND in).
    The gate uses observed surge persistence as the surge-length
    predictor: the backlog must have stayed above ``high_backlog_s`` for
    at least ``warmup_margin x rewarm_cost_s`` contiguous seconds
    (``rewarm_cost_s`` is the engine's prediction, passed per decision)
    before a scale_out fires; gated checks are counted in ``deferred``.
    Default OFF — the naive policy, digest-locked, is unchanged."""

    def __init__(self, check_every_s: float = 20.0,
                 high_backlog_s: float = 1.5, low_backlog_s: float = 0.2,
                 max_extra: int = 2, cooldown_s: float = 60.0,
                 warmup_aware: bool = False, warmup_margin: float = 1.0):
        assert check_every_s > 0 and high_backlog_s > low_backlog_s >= 0.0
        assert warmup_margin >= 0.0
        self.check_every_s = check_every_s
        self.high_backlog_s = high_backlog_s
        self.low_backlog_s = low_backlog_s
        self.max_extra = max_extra
        self.cooldown_s = cooldown_s
        self.warmup_aware = warmup_aware
        self.warmup_margin = warmup_margin
        self.next_check = check_every_s
        self.added: List[str] = []       # pods this scaler added (LIFO)
        self.last_action_at = -1e18
        self.decisions: List[Tuple[float, str]] = []
        self.surge_since: Optional[float] = None  # backlog-high onset
        self.deferred = 0                # scale_outs the warm-up gate held

    def decide(self, now: float, backlogs: Dict[str, float],
               rewarm_cost_s: float = 0.0) -> Optional[str]:
        # surge-age tracking runs on every check (even inside cooldown):
        # persistence is a property of the signal, not of our actions
        mean = (sum(backlogs.values()) / len(backlogs)) if backlogs else 0.0
        if backlogs and mean > self.high_backlog_s:
            if self.surge_since is None:
                self.surge_since = now
        else:
            self.surge_since = None
        if now - self.last_action_at < self.cooldown_s or not backlogs:
            return None
        if mean > self.high_backlog_s and len(self.added) < self.max_extra:
            if self.warmup_aware:
                age = now - self.surge_since
                if age < self.warmup_margin * rewarm_cost_s:
                    self.deferred += 1
                    return None
            return SCALE_OUT
        if mean < self.low_backlog_s and self.added:
            return SCALE_IN
        return None

    def note_action(self, now: float, action: str, pod: str) -> None:
        self.last_action_at = now
        self.decisions.append((now, action))
        if action == SCALE_OUT:
            self.added.append(pod)
        elif action == SCALE_IN and pod in self.added:
            self.added.remove(pod)
