"""Simulated GPT endpoint pool: fault schedules, routing, and degradation.

The paper's decision plane runs on "hundreds of GPT endpoints"; until now
our simulated GPT was perfectly reliable. This module makes the *decision*
plane failure-prone the same way ``core.faults`` made the data pods fail:

- ``EndpointFaultPlan`` — a deterministic sim-time schedule of endpoint
  fault windows (outages, rate-limit regimes with a retry-after hint,
  straggler slowdown multipliers, malformed-response injection), with
  ``single``/``periodic``/``random_plan``/``correlated`` generators
  mirroring ``FaultPlan`` and fail-fast validation at construction.
- ``EndpointRouter`` — owns every routed ``SimLLM.complete()`` call:
  per-call endpoint selection (blind to liveness, like a real client),
  bounded sim-time exponential backoff with jitter (``RetryPolicy``),
  optional hedged requests (second request to a *different* endpoint after
  an EWMA-p95 hedge delay, first wins, the loser's tokens are still
  charged), and a per-endpoint circuit breaker (closed / open / half-open).
- ``RoutedLLM`` — wraps a ``SimLLM`` so cache-op decision calls pass an
  admission gate first; when retries exhaust or every breaker is open it
  raises ``LLMUnavailableError`` and the ``LLM*`` policy wrappers fall
  back to their programmatic twins (degraded mode). Planning rounds never
  raise: they pay the full retry latency on the session clock and, during
  a total blackout, jump to the analytically-known next-available instant
  — structural never-stall-forever.

Degeneracy contract: an **empty** plan must replay the router-free engine
bit-identically. The router draws from a private RNG, adds exactly 0.0
latency when no window is active, and hedging/breaker are opt-in, so the
only observable difference is the router's own counters.

Timing is sim-time only: nothing here reads a wall clock.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.faults import RetryPolicy

# Endpoint fault actions. *_END closes the matching window; a start without
# an end is an open-ended window (allowed per endpoint, but a plan that
# leaves the whole pool permanently dead is rejected by the router).
OUTAGE = "outage"
RESTORE = "restore"
LIMIT = "limit"
LIMIT_END = "limit_end"
SLOW = "slow"
SLOW_END = "slow_end"
MALFORM = "malform"
MALFORM_END = "malform_end"

ACTIONS = (OUTAGE, RESTORE, LIMIT, LIMIT_END,
           SLOW, SLOW_END, MALFORM, MALFORM_END)
_ACTION_ORDER = {a: i for i, a in enumerate(ACTIONS)}

# (start-action, end-action) pairs per window kind
_WINDOW_KINDS = ((OUTAGE, RESTORE), (LIMIT, LIMIT_END),
                 (SLOW, SLOW_END), (MALFORM, MALFORM_END))


class LLMUnavailableError(RuntimeError):
    """No endpoint could serve a cache-op decision within the retry budget.

    Deliberately *not* a ``ValueError``: the generic decision-parse
    handlers must not swallow it — the ``LLM*`` wrappers catch it
    explicitly and fall back to their programmatic twin (ungraded)."""


@dataclasses.dataclass(frozen=True)
class EndpointFaultEvent:
    at: float
    action: str
    endpoint: str
    value: float = 0.0  # retry-after (limit) / multiplier (slow) / p (malform)

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown endpoint action {self.action!r}")
        if not (self.at >= 0.0 and math.isfinite(self.at)):
            raise ValueError(f"event time must be finite and >= 0: {self.at}")
        if self.action == LIMIT and not self.value > 0.0:
            raise ValueError(f"limit needs retry_after_s > 0, got {self.value}")
        if self.action == SLOW and not self.value >= 1.0:
            raise ValueError(f"slow needs multiplier >= 1, got {self.value}")
        if self.action == MALFORM and not 0.0 < self.value <= 1.0:
            raise ValueError(f"malform needs p in (0, 1], got {self.value}")
        if self.action not in (LIMIT, SLOW, MALFORM) and self.value != 0.0:
            raise ValueError(f"{self.action} takes no value, got {self.value}")


class EndpointFaultPlan:
    """A deterministic sim-time schedule of endpoint fault windows.

    Events are kept sorted by ``(at, action-order, endpoint)`` so injection
    order is independent of construction order. Start/end events are paired
    into per-endpoint windows at construction and validated fail-fast:
    an end without a matching start, or two overlapping starts of the same
    kind on one endpoint, raise ``ValueError``. An empty plan is falsy and
    must replay the router-free engine bit-identically."""

    def __init__(self, events: Sequence[EndpointFaultEvent] = ()):
        self.events: List[EndpointFaultEvent] = sorted(
            events, key=lambda e: (e.at, _ACTION_ORDER[e.action], e.endpoint))
        # windows[kind][endpoint] -> [(start, end_or_inf, value), ...]
        self.windows: Dict[str, Dict[str, List[Tuple[float, float, float]]]] \
            = {start: {} for start, _ in _WINDOW_KINDS}
        for start, end in _WINDOW_KINDS:
            table = self.windows[start]
            open_at: Dict[str, Tuple[float, float]] = {}
            for ev in self.events:
                if ev.action == start:
                    if ev.endpoint in open_at:
                        raise ValueError(
                            f"overlapping {start!r} windows on {ev.endpoint}")
                    open_at[ev.endpoint] = (ev.at, ev.value)
                elif ev.action == end:
                    if ev.endpoint not in open_at:
                        raise ValueError(
                            f"{end!r} at t={ev.at} without an open "
                            f"{start!r} window on {ev.endpoint}")
                    s, v = open_at.pop(ev.endpoint)
                    if not ev.at > s:
                        raise ValueError(
                            f"empty {start!r} window on {ev.endpoint} "
                            f"[{s}, {ev.at})")
                    table.setdefault(ev.endpoint, []).append((s, ev.at, v))
            for ep, (s, v) in open_at.items():  # open-ended windows
                table.setdefault(ep, []).append((s, math.inf, v))
            for wins in table.values():
                wins.sort()

    @property
    def endpoints(self):
        return sorted({e.endpoint for e in self.events})

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __iter__(self):
        return iter(self.events)

    def __add__(self, other: "EndpointFaultPlan") -> "EndpointFaultPlan":
        return EndpointFaultPlan(self.events + list(other))

    def __repr__(self) -> str:
        return f"EndpointFaultPlan({self.events!r})"

    # -- parametric generators ------------------------------------------------
    @staticmethod
    def single(endpoint: str, at: float, until: Optional[float] = None,
               kind: str = OUTAGE, value: float = 0.0) -> "EndpointFaultPlan":
        """One fault window of ``kind`` on one endpoint; ``until=None``
        leaves it open-ended."""
        starts = dict(_WINDOW_KINDS)
        if kind not in starts:
            raise ValueError(f"unknown window kind {kind!r}")
        evs = [EndpointFaultEvent(at, kind, endpoint, value)]
        if until is not None:
            evs.append(EndpointFaultEvent(until, starts[kind], endpoint))
        return EndpointFaultPlan(evs)

    @staticmethod
    def correlated(endpoints: Sequence[str], at: float,
                   downtime_s: float) -> "EndpointFaultPlan":
        """Correlated blackout (one region/provider incident): every listed
        endpoint goes down at the same instant and restores together."""
        evs = [EndpointFaultEvent(at, OUTAGE, e) for e in endpoints]
        evs += [EndpointFaultEvent(at + downtime_s, RESTORE, e)
                for e in endpoints]
        return EndpointFaultPlan(evs)

    @staticmethod
    def periodic(endpoints: Sequence[str], period_s: float, downtime_s: float,
                 start_s: float, horizon_s: float) -> "EndpointFaultPlan":
        """Round-robin rolling outages: every ``period_s`` starting at
        ``start_s`` the next endpoint goes down for ``downtime_s``."""
        assert period_s > 0 and 0 < downtime_s < period_s
        evs, i, t = [], 0, start_s
        while t < horizon_s:
            ep = endpoints[i % len(endpoints)]
            evs.append(EndpointFaultEvent(t, OUTAGE, ep))
            evs.append(EndpointFaultEvent(t + downtime_s, RESTORE, ep))
            i += 1
            t += period_s
        return EndpointFaultPlan(evs)

    @staticmethod
    def random_plan(endpoints: Sequence[str], n_faults: int, horizon_s: float,
                    downtime_s: float, seed: int = 0,
                    min_gap_s: float = 1.0) -> "EndpointFaultPlan":
        """Seeded random outages: ``n_faults`` outage/restore pairs at
        uniform times; a draw overlapping an existing window on the same
        endpoint is skipped (windows of one kind may not overlap)."""
        rng = random.Random(seed)
        taken: Dict[str, List[Tuple[float, float]]] = {}
        evs = []
        for _ in range(n_faults):
            t = min_gap_s + rng.random() * max(0.0, horizon_s - min_gap_s)
            ep = endpoints[rng.randrange(len(endpoints))]
            span = (t, t + downtime_s)
            if any(s < span[1] and span[0] < e
                   for s, e in taken.get(ep, ())):
                continue
            taken.setdefault(ep, []).append(span)
            evs.append(EndpointFaultEvent(t, OUTAGE, ep))
            evs.append(EndpointFaultEvent(t + downtime_s, RESTORE, ep))
        return EndpointFaultPlan(evs)

    @staticmethod
    def outage_straggler(endpoints: Sequence[str], horizon_s: float,
                         start_s: float = 15.0, outage_s: float = 10.0,
                         stagger_s: float = 25.0,
                         slowdown: float = 8.0) -> "EndpointFaultPlan":
        """The headline mixed regime: staggered finite outages roll across
        all endpoints but the last, while the last endpoint straggles at
        ``slowdown``x for the whole horizon (a bad replica that answers,
        slowly — the case retries alone cannot fix)."""
        assert len(endpoints) >= 2, "need a straggler plus at least one more"
        evs = [EndpointFaultEvent(5.0, SLOW, endpoints[-1], slowdown),
               EndpointFaultEvent(horizon_s, SLOW_END, endpoints[-1])]
        t, i = start_s, 0
        while t + outage_s < horizon_s and i < len(endpoints) - 1:
            evs.append(EndpointFaultEvent(t, OUTAGE, endpoints[i]))
            evs.append(EndpointFaultEvent(t + outage_s, RESTORE, endpoints[i]))
            i += 1
            t += stagger_s
        return EndpointFaultPlan(evs)


# Circuit-breaker states (per endpoint, derived from open-timestamp + now)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class EndpointRouter:
    """Routes every decision-plane request across a pool of N endpoints.

    Two request classes share the pool but differ in failure semantics:

    - ``plan_call`` (planning rounds): must complete. Failed attempts pay
      fail-fast detection plus jittered exponential backoff on the session
      clock; when the retry budget exhausts during a total blackout the
      call waits to the analytically-known next-available instant (finite
      by construction) and restarts the budget. Optional hedging launches
      a second request on a different endpoint once the primary has been
      in flight for an EWMA-p95 delay; first answer wins, the loser's
      tokens are still charged.
    - ``decision_call`` (cache-op decisions: admit / replicate / recover /
      cache-update / read-plan): latency-free, so a failure cannot be
      waited out — after the retry budget (or instantly, when every
      breaker is open) the call raises ``LLMUnavailableError`` and the
      caller degrades to its programmatic twin.

    The per-endpoint circuit breaker (opt-in) trips after
    ``breaker_threshold`` consecutive bad signals (failed attempts, lost
    hedges, malformed replies), rejects the endpoint while open, and
    half-opens one probe after ``breaker_cooldown_s``."""

    def __init__(self, n_endpoints: int = 4,
                 plan: Optional[EndpointFaultPlan] = None, seed: int = 0,
                 retry: Optional[RetryPolicy] = None,
                 hedge: bool = False, breaker: bool = False,
                 hedge_min_s: float = 0.25, hedge_z: float = 1.645,
                 hedge_alpha: float = 0.2, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 20.0,
                 fail_fast_s: float = 0.05):
        if n_endpoints < 1:
            raise ValueError(f"need at least one endpoint, got {n_endpoints}")
        if breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1")
        if breaker_cooldown_s <= 0 or fail_fast_s <= 0 or hedge_min_s <= 0:
            raise ValueError("breaker_cooldown_s / fail_fast_s / hedge_min_s "
                             "must be positive")
        self.names = [f"ep{i}" for i in range(n_endpoints)]
        self.plan = plan if plan is not None else EndpointFaultPlan()
        unknown = set(self.plan.endpoints) - set(self.names)
        if unknown:
            raise ValueError(f"plan names endpoints outside the pool: "
                             f"{sorted(unknown)} (pool {self.names})")
        # a pool that is permanently dead can never satisfy the
        # never-stall-forever contract — reject it up front
        outages = self.plan.windows[OUTAGE]
        if all(any(e == math.inf for _, e, _ in outages.get(n, ()))
               for n in self.names):
            raise ValueError("plan leaves every endpoint in an open-ended "
                             "outage: the pool would be permanently dead")
        self.retry = retry if retry is not None else RetryPolicy()
        self.hedge = hedge
        self.breaker = breaker
        self.hedge_min_s = hedge_min_s
        self.hedge_z = hedge_z
        self.hedge_alpha = hedge_alpha
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.fail_fast_s = fail_fast_s
        self.rng = random.Random(f"{seed}|endpoints")
        self.now = 0.0
        # EWMA service-time moments feeding the hedge delay
        self._mu = 0.0
        self._var = 0.0
        self._obs = 0
        # breaker state: consecutive bad signals + open timestamp
        self._bad = {n: 0 for n in self.names}
        self._open_at: Dict[str, Optional[float]] = \
            {n: None for n in self.names}
        # counters (surfaced on EpisodeMetrics)
        self.plan_calls = 0
        self.decision_calls = 0
        self.read_checks = 0
        self.retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.rate_limited = 0
        self.malformed = 0
        self.degraded = 0
        self.retry_tokens = 0
        self.breaker_opens = 0
        self.breaker_closes = 0
        self.fault_events = 0

    # -- analytic schedule queries (windows, not mutable state) --------------
    def _window(self, kind: str, ep: str, t: float) -> Optional[float]:
        for s, e, v in self.plan.windows[kind].get(ep, ()):
            if s <= t < e:
                return v
        return None

    def up(self, ep: str, t: float) -> bool:
        return self._window(OUTAGE, ep, t) is None

    def retry_after(self, ep: str, t: float) -> float:
        return self._window(LIMIT, ep, t) or 0.0

    def slow_mult(self, ep: str, t: float) -> float:
        v = self._window(SLOW, ep, t)
        return 1.0 if v is None else v

    def malform_p(self, ep: str, t: float) -> float:
        return self._window(MALFORM, ep, t) or 0.0

    def next_available(self, t: float) -> float:
        """Earliest instant >= t at which *some* endpoint is up. Finite for
        any valid plan (construction rejects a permanently dead pool)."""
        best = math.inf
        for ep in self.names:
            nxt = t
            for s, e, _ in self.plan.windows[OUTAGE].get(ep, ()):
                if s <= t < e:
                    nxt = e
                    break
            best = min(best, nxt)
        return best

    # -- circuit breaker -----------------------------------------------------
    def breaker_state(self, ep: str, t: float) -> str:
        if not self.breaker or self._open_at[ep] is None:
            return CLOSED
        if t - self._open_at[ep] >= self.breaker_cooldown_s:
            return HALF_OPEN
        return OPEN

    def _note_fail(self, ep: str, t: float) -> None:
        if not self.breaker:
            return
        if self.breaker_state(ep, t) == HALF_OPEN:
            self._open_at[ep] = t  # probe failed: re-open for a fresh cooldown
            self.breaker_opens += 1
            return
        self._bad[ep] += 1
        if self._bad[ep] >= self.breaker_threshold \
                and self._open_at[ep] is None:
            self._open_at[ep] = t
            self.breaker_opens += 1

    def _note_ok(self, ep: str, t: float) -> None:
        if not self.breaker:
            return
        if self._open_at[ep] is not None:  # successful half-open probe
            self.breaker_closes += 1
        self._open_at[ep] = None
        self._bad[ep] = 0

    # -- selection (blind to liveness, like a real client) -------------------
    def _candidates(self, t: float) -> List[str]:
        return [ep for ep in self.names if self.breaker_state(ep, t) != OPEN]

    def _pick(self, cands: Sequence[str],
              exclude: Optional[str] = None) -> str:
        pool = [c for c in cands if c != exclude] or list(cands)
        return pool[self.rng.randrange(len(pool))]

    # -- hedging -------------------------------------------------------------
    def _observe(self, service_s: float) -> None:
        if self._obs == 0:
            self._mu = service_s
        else:
            d = service_s - self._mu
            self._mu += self.hedge_alpha * d
            self._var += self.hedge_alpha * (d * d - self._var)
        self._obs += 1

    def _hedge_delay(self, nominal_s: float) -> float:
        # EWMA-p95: mean + z*sigma of observed round service times; until
        # the first observation the nominal itself (never hedges a healthy
        # first call)
        if self._obs == 0:
            base = nominal_s
        else:
            base = self._mu + self.hedge_z * math.sqrt(max(0.0, self._var))
        return max(self.hedge_min_s, base)

    # -- request classes -----------------------------------------------------
    def plan_call(self, t0: float, nominal_s: float,
                  tokens: int) -> Tuple[float, int, int, int, float]:
        """Route one planning round starting at ``t0`` whose fault-free
        service time ``nominal_s`` the caller has already paid. Returns
        ``(extra_s, retries, hedges, hedge_wins, wait_s)`` where
        ``extra_s`` is the additional session-clock latency (0.0 exactly
        when no fault window is active) and ``wait_s`` the part spent on
        detection/backoff/retry-after rather than inflated service."""
        self.plan_calls += 1
        t, extra, wait = t0, 0.0, 0.0
        retries = hedges = wins = 0
        attempt = 0
        while True:
            cands = self._candidates(t)
            if not cands:
                # every breaker open: planning must still complete, so the
                # client abandons breaker discipline and probes the pool
                cands = self.names
            ep = self._pick(cands)
            if not self.up(ep, t):
                attempt += 1
                retries += 1
                self.retries += 1
                self.retry_tokens += tokens  # the prompt was sent and lost
                self._note_fail(ep, t)
                if attempt > self.retry.max_retries:
                    # budget exhausted: wait out the blackout (finite by
                    # construction), then restart the budget
                    step = max(self.fail_fast_s, self.next_available(t) - t)
                    attempt = 0
                else:
                    d = self.retry.delay(attempt)
                    step = self.fail_fast_s + d * (0.5 + self.rng.random())
                extra += step
                wait += step
                t += step
                continue
            ra = self.retry_after(ep, t)
            if ra > 0.0:
                # 429 with a retry-after hint: honor it, then the same
                # endpoint's bucket has refilled
                retries += 1
                self.retries += 1
                self.rate_limited += 1
                extra += ra
                wait += ra
                t += ra
            service = nominal_s * self.slow_mult(ep, t)
            hedged_ok = False
            if self.hedge and len(self.names) > 1:
                delay = self._hedge_delay(nominal_s)
                if service > delay:
                    alt_cands = self._candidates(t) or self.names
                    alt = self._pick(alt_cands, exclude=ep)
                    if alt != ep and self.up(alt, t + delay):
                        hedges += 1
                        self.hedges += 1
                        self.retry_tokens += tokens  # loser is still billed
                        alt_service = (delay
                                       + nominal_s * self.slow_mult(alt, t + delay))
                        if alt_service < service:
                            wins += 1
                            self.hedge_wins += 1
                            self._note_fail(ep, t)  # lost its own hedge
                            self._note_ok(alt, t)
                            service = alt_service
                            hedged_ok = True
            if not hedged_ok:
                self._note_ok(ep, t)
            self._observe(service)
            extra += service - nominal_s
            return extra, retries, hedges, wins, wait

    def decision_call(self, prompt_chars: int) -> bool:
        """Route one latency-free cache-op decision at ``self.now``.

        Returns True when the chosen endpoint garbles the response (the
        caller must truncate it). Raises ``LLMUnavailableError`` when the
        retry budget exhausts or every breaker is open — the caller falls
        back to its programmatic twin."""
        self.decision_calls += 1
        t = self.now
        tokens = max(1, prompt_chars // 4)
        for _ in range(self.retry.max_retries + 1):
            cands = self._candidates(t)
            if not cands:
                break  # every breaker open: fail fast, nothing is sent
            ep = self._pick(cands)
            if not self.up(ep, t):
                self.retries += 1
                self.retry_tokens += tokens
                self._note_fail(ep, t)
                continue
            if self.retry_after(ep, t) > 0.0:
                # a latency-free decision cannot wait out a 429
                self.retries += 1
                self.rate_limited += 1
                continue
            mp = self.malform_p(ep, t)
            if mp > 0.0 and self.rng.random() < mp:
                self.malformed += 1
                self._note_fail(ep, t)  # garbled replies are breaker evidence
                return True
            self._note_ok(ep, t)
            return False
        self.degraded += 1
        raise LLMUnavailableError(
            f"no endpoint available for a decision at t={t:.3f}s")

    def decision_available(self) -> bool:
        """Cheap availability probe for the eps-simulated read path (the
        read plan rides the planning prompt; no separate request is sent).
        Counts a degraded decision when the pool cannot serve."""
        self.read_checks += 1
        t = self.now
        ok = any(self.up(ep, t) and self.retry_after(ep, t) == 0.0
                 for ep in self._candidates(t))
        if not ok:
            self.degraded += 1
        return ok

    def decision_serviceable(self) -> bool:
        """Pure twin of :meth:`decision_available`: same window logic, NO
        counter side effects. Used by the plan-cache hit path to burn the
        exact eps draws a fresh plan would have consumed — the skipped
        round must not perturb ``read_checks``/``degraded`` (and through
        them ``fallback_share``), or a hit would change the episode's
        decision-plane accounting."""
        t = self.now
        return any(self.up(ep, t) and self.retry_after(ep, t) == 0.0
                   for ep in self._candidates(t))

    # -- scheduler hook ------------------------------------------------------
    def apply(self, t: float, ev: EndpointFaultEvent) -> None:
        """PRI_FAULT bookkeeping: windows are analytic, so events only
        advance the router clock and count regime transitions."""
        self.now = t
        self.fault_events += 1

    @property
    def llm_calls(self) -> int:
        return self.plan_calls + self.decision_calls

    @property
    def fallback_share(self) -> float:
        denom = self.decision_calls + self.read_checks
        return self.degraded / denom if denom else 0.0


class RoutedLLM:
    """Wraps a ``SimLLM`` so every ``complete()`` is admitted by the
    router first. Truncates the completion when the router injects a
    malformed response (downstream JSON parsing then fails and the policy
    wrapper counts a parse fallback). Everything else — profile, rng,
    ``draw_*`` — delegates to the wrapped backend."""

    def __init__(self, llm, router: EndpointRouter):
        self._llm = llm
        self.router = router

    def complete(self, prompt: str) -> str:
        malform = self.router.decision_call(len(prompt))
        text = self._llm.complete(prompt)
        if malform:
            return text[:max(1, len(text) // 2)]
        return text

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_llm"), name)
