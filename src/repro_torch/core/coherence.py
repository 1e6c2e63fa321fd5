"""Mutable data plane: mutation schedules + cache-coherence policies.

The datastore was read-only before this module, so the paper's *cache update*
surface had no teeth: no cached copy could ever be wrong. This module
adds the write path as data — a :class:`MutationPlan` of seeded
:class:`MutationEvent` s on sim time (frame row updates, new imagery
arrivals), scheduled into the engine's event heap exactly like the
fault events — and the *coherence policies* that decide what a cache may
serve once writes exist:

* ``write-invalidate`` — a mutation purges every copy (owner, replicas,
  superseded in-flight fills). Nothing stale is ever consumed; readers
  pay the re-fetch.
* ``write-through`` — a mutation pushes the new version into every live
  copy in place (writer-side cost, counted per copy). Caches never lag.
* ``ttl`` — the llm-cache idiom: a copy serves until its *age* exceeds
  ``ttl_s``, then refreshes on next read. A version-lagged copy inside
  its TTL serves stale, but staleness can never exceed the TTL (the
  mutation happened after the install), so ``ttl_s`` is the declared
  staleness bound.
* ``serve-stale`` — bounded staleness: a version-lagged copy serves as
  long as its staleness (now minus the first unapplied mutation) is at
  most ``bound_s``; beyond the bound the read refreshes. This is the
  programmatic base the GPT-driven ``cache_update`` path is graded
  against.

The policies follow the established dual-policy shape (admission /
replication / recovery): a programmatic rule plus an
:class:`LLMCoherence` wrapper that renders the rule as natural language,
asks the LLM per stale read (refresh-now vs serve-stale-within-bound),
grades every verdict against the programmatic expectation, and falls
back to it on malformed output. Whatever the LLM answers, the engine
CLAMPS consumption to the declared bound — serve-stale past the bound is
forced to refresh — so the staleness contract is a hard property, not a
model behavior.

Degeneracy contract (property-locked like the locality and traffic ones): ``mutations=None``
or an EMPTY plan replays the immutable-data engine bit-identically — versions
never move, every read is fresh, no counter increments.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Iterator, List, Optional, Sequence

from repro_torch.core.prompts import coherence_decision_prompt, parse_json_tail

UPDATE = "update"      # in-place frame rows changed (version bump)
ARRIVAL = "arrival"    # new imagery landed for the key (version bump)
_KINDS = (UPDATE, ARRIVAL)
_KIND_ORDER = {UPDATE: 0, ARRIVAL: 1}

REFRESH = "refresh"
SERVE_STALE = "serve_stale"

MAX_MUTATIONS_DEFAULT = 100_000


def _require(cond: bool, msg: str) -> None:
    """Fail-fast parameter validation (like core.traffic): a bad
    rate or bound here silently corrupts every downstream staleness
    property — reject loudly at construction."""
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class MutationEvent:
    """One datastore write at sim time ``at``: ``key``'s version bumps by
    one. ``kind`` distinguishes in-place row updates from new-imagery
    arrivals (both version the key; workloads and tables use the split
    for reporting and for the flash-crowd-on-fresh-data pairing)."""

    at: float
    key: str
    kind: str = UPDATE

    def __post_init__(self):
        _require(isinstance(self.at, (int, float)) and self.at >= 0.0,
                 f"mutation time must be >= 0, got {self.at!r}")
        _require(isinstance(self.key, str) and bool(self.key),
                 f"mutation key must be a non-empty string, got {self.key!r}")
        _require(self.kind in _KINDS,
                 f"mutation kind must be one of {_KINDS}, got {self.kind!r}")


class MutationPlan:
    """A deterministic schedule of datastore writes (like
    :class:`~repro_torch.core.faults.FaultPlan` for membership changes).

    Events are sorted by (time, kind, key) so same-instant writes apply
    in a fixed order whatever order the generator produced them. An
    EMPTY plan is falsy and is the degeneracy reference: the coherence
    layer runs every hook yet replays the mutation-free engine
    bit-identically (locked by tests/test_coherence.py)."""

    def __init__(self, events: Sequence[MutationEvent] = ()):
        evs = list(events)
        for e in evs:
            _require(isinstance(e, MutationEvent),
                     f"MutationPlan takes MutationEvents, got {e!r}")
        self.events: List[MutationEvent] = sorted(
            evs, key=lambda e: (e.at, _KIND_ORDER[e.kind], e.key))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[MutationEvent]:
        return iter(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __repr__(self) -> str:
        return f"MutationPlan({self.events!r})"

    # -- parametric generators (deterministic in their seed) -----------------
    @staticmethod
    def single(key: str, at: float, kind: str = UPDATE) -> "MutationPlan":
        """One write to ``key`` at ``at``."""
        return MutationPlan([MutationEvent(at, key, kind)])

    @staticmethod
    def periodic(keys: Sequence[str], period_s: float, *,
                 start_s: float = 0.0, horizon_s: float,
                 kind: str = UPDATE) -> "MutationPlan":
        """Round-robin writes over ``keys`` every ``period_s`` from
        ``start_s`` to ``horizon_s`` (exclusive) — the steady drumbeat of
        a re-imaged region, or (with ``kind=ARRIVAL``) a feed of new
        scenes walking the key list."""
        _require(len(keys) > 0, "periodic plan needs at least one key")
        _require(period_s > 0.0, f"period_s must be > 0, got {period_s}")
        _require(start_s >= 0.0, f"start_s must be >= 0, got {start_s}")
        _require(horizon_s > start_s,
                 f"horizon_s ({horizon_s}) must be > start_s ({start_s})")
        evs, t, i = [], start_s, 0
        while t < horizon_s:
            evs.append(MutationEvent(t, keys[i % len(keys)], kind))
            i += 1
            t = start_s + i * period_s
        return MutationPlan(evs)

    @staticmethod
    def random_plan(keys: Sequence[str], rate_per_s: float,
                    horizon_s: float, *, seed: int = 0,
                    arrival_p: float = 0.0,
                    max_events: int = MAX_MUTATIONS_DEFAULT,
                    ) -> "MutationPlan":
        """Poisson write stream at ``rate_per_s`` over ``horizon_s``:
        each event hits a uniformly drawn key from ``keys`` and is an
        ARRIVAL with probability ``arrival_p`` (else an UPDATE).
        Deterministic in ``seed``."""
        _require(len(keys) > 0, "random plan needs at least one key")
        _require(rate_per_s > 0.0,
                 f"rate_per_s must be > 0, got {rate_per_s}")
        _require(horizon_s > 0.0,
                 f"horizon_s must be > 0, got {horizon_s}")
        _require(0.0 <= arrival_p <= 1.0,
                 f"arrival_p must be in [0, 1], got {arrival_p}")
        _require(max_events >= 1,
                 f"max_events must be >= 1, got {max_events}")
        rng = random.Random(seed)
        evs: List[MutationEvent] = []
        t = rng.expovariate(rate_per_s)
        while t < horizon_s:
            _require(len(evs) < max_events,
                     f"mutation plan exceeded max_events={max_events} "
                     f"(rate {rate_per_s}/s over {horizon_s}s)")
            kind = ARRIVAL if rng.random() < arrival_p else UPDATE
            evs.append(MutationEvent(t, keys[rng.randrange(len(keys))],
                                     kind))
            t += rng.expovariate(rate_per_s)
        return MutationPlan(evs)


# ---------------------------------------------------------------------------
# Coherence policies (dual shape: programmatic rule + LLM wrapper)
# ---------------------------------------------------------------------------

class CoherencePolicy:
    """What a cache may do with a copy once the datastore has moved on.

    Two hooks: the *mutation-time* behavior is declared by the class
    flags (``invalidate_on_write`` purges every copy;
    ``refresh_on_write`` pushes the new version into every copy), and
    the *read-time* behavior is :meth:`on_stale_read` — called when a
    consumer is about to serve a version-lagged copy, returning
    ``"refresh"`` or ``"serve_stale"``. ``bound_s`` is the declared
    staleness bound the engine enforces as a hard clamp (``0.0`` means
    nothing stale is ever consumable)."""

    name = "?"
    invalidate_on_write = False
    refresh_on_write = False
    bound_s: float = 0.0

    def on_stale_read(self, key: str, staleness_s: float, age_s: float,
                      freq: int) -> str:
        return REFRESH

    def expired(self, age_s: float) -> bool:
        """TTL-style age expiry, independent of versions (False for
        every policy but TTL)."""
        return False

    def describe(self) -> str:
        raise NotImplementedError


class WriteInvalidate(CoherencePolicy):
    """Purge every copy at write time; nothing stale is ever served."""

    name = "write-invalidate"
    invalidate_on_write = True

    def describe(self) -> str:
        return ("every write invalidates all cached copies; a read after "
                "a write always re-fetches (zero staleness)")


class WriteThrough(CoherencePolicy):
    """Push the new version into every live copy at write time."""

    name = "write-through"
    refresh_on_write = True

    def describe(self) -> str:
        return ("every write refreshes all cached copies in place; "
                "caches never lag the store (zero staleness)")


class TTLCoherence(CoherencePolicy):
    """Age-based expiry (the llm-cache idiom): a copy serves — fresh or
    version-lagged — until its age exceeds ``ttl_s``, then the next read
    refreshes it. Staleness never exceeds the TTL because the mutation
    postdates the install."""

    name = "ttl"

    def __init__(self, ttl_s: float = 30.0):
        _require(ttl_s > 0.0, f"ttl_s must be > 0, got {ttl_s}")
        self.ttl_s = ttl_s
        self.bound_s = ttl_s

    def expired(self, age_s: float) -> bool:
        return age_s > self.ttl_s

    def on_stale_read(self, key: str, staleness_s: float, age_s: float,
                      freq: int) -> str:
        return SERVE_STALE if age_s <= self.ttl_s else REFRESH

    def describe(self) -> str:
        return (f"serve any cached copy younger than {self.ttl_s:g}s "
                f"(even if the store has newer data); refresh a copy "
                f"older than {self.ttl_s:g}s on its next read")


class ServeStaleCoherence(CoherencePolicy):
    """Bounded staleness: serve a version-lagged copy while its
    staleness (seconds since the first unapplied write) is at most
    ``bound_s``; refresh beyond the bound."""

    name = "serve-stale"

    def __init__(self, bound_s: float = 20.0):
        _require(bound_s > 0.0, f"bound_s must be > 0, got {bound_s}")
        self.bound_s = bound_s

    def on_stale_read(self, key: str, staleness_s: float, age_s: float,
                      freq: int) -> str:
        return SERVE_STALE if staleness_s <= self.bound_s else REFRESH

    def describe(self) -> str:
        return (f"serve a stale cached copy while its staleness is at "
                f"most {self.bound_s:g} seconds; refresh now once the "
                f"staleness exceeds {self.bound_s:g} seconds")


class LLMCoherence(CoherencePolicy):
    """GPT-driven ``cache_update``: each stale read is described to the
    LLM (key, staleness, bound, observed frequency) and its
    refresh-now vs serve-stale-within-bound verdict is used — graded
    against the wrapped programmatic rule exactly like the admission /
    replication / recovery paths. Malformed output falls back to the
    programmatic expectation. The engine's bound clamp applies to the
    LLM's answers too: a serve-stale verdict past ``bound_s`` is forced
    to refresh, so the staleness contract survives any decision noise."""

    def __init__(self, base: CoherencePolicy, llm, few_shot: bool = True):
        _require(base is not None and not isinstance(base, LLMCoherence),
                 "LLMCoherence wraps a programmatic policy")
        self.base = base
        self.llm = llm
        self.few_shot = few_shot
        self.name = f"llm-{base.name}"
        self.llm_total = 0
        self.llm_correct = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0
        # resilience fallbacks to the programmatic base (ungraded): garbled
        # prompt/completion vs endpoint pool down
        self.parse_fallbacks = 0
        self.degraded = 0

    @property
    def invalidate_on_write(self) -> bool:          # type: ignore[override]
        return self.base.invalidate_on_write

    @property
    def refresh_on_write(self) -> bool:             # type: ignore[override]
        return self.base.refresh_on_write

    @property
    def bound_s(self) -> float:                     # type: ignore[override]
        return self.base.bound_s

    @property
    def agreement(self) -> float:
        return self.llm_correct / self.llm_total if self.llm_total else 1.0

    def expired(self, age_s: float) -> bool:
        return self.base.expired(age_s)

    def render_prompt(self, key: str, staleness_s: float, freq: int) -> str:
        return coherence_decision_prompt(
            self.base.describe(), key, staleness_s, self.base.bound_s,
            freq, few_shot=self.few_shot)

    def on_stale_read(self, key: str, staleness_s: float, age_s: float,
                      freq: int) -> str:
        from repro_torch.core.endpoints import LLMUnavailableError
        from repro_torch.core.prompts import LLMParseError
        expected = self.base.on_stale_read(key, staleness_s, age_s, freq)
        prompt = self.render_prompt(key, staleness_s, freq)
        try:
            out = self.llm.complete(prompt)
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
        self.completion_tokens += len(out) // 4
        try:
            parsed = parse_json_tail(out)
            decision = (parsed.get("decision")
                        if isinstance(parsed, dict) else None)
        except ValueError:
            decision = None
        if decision not in (REFRESH, SERVE_STALE):
            # garbled/meaningless completion: programmatic twin, ungraded
            self.parse_fallbacks += 1
            return expected
        self.llm_total += 1
        if decision == expected:
            self.llm_correct += 1
        return decision

    def describe(self) -> str:
        return self.base.describe()


_POLICIES = ("write-invalidate", "write-through", "ttl", "serve-stale")


def make_coherence(policy: str = "write-invalidate", *,
                   impl: str = "python", llm=None, few_shot: bool = True,
                   ttl_s: float = 30.0,
                   bound_s: float = 20.0) -> CoherencePolicy:
    """Factory for the engine's ``coherence=`` argument.

    ``impl="llm"`` wraps the read-time decision in the GPT-driven
    :class:`LLMCoherence` path — only meaningful for the policies that
    HAVE a read-time decision (``ttl`` / ``serve-stale``);
    write-invalidate and write-through act at write time and never
    consult a reader."""
    _require(policy in _POLICIES,
             f"unknown coherence policy {policy!r} (expected one of "
             f"{_POLICIES})")
    _require(impl in ("python", "llm"),
             f"coherence impl must be 'python' or 'llm', got {impl!r}")
    if policy == "write-invalidate":
        base: CoherencePolicy = WriteInvalidate()
    elif policy == "write-through":
        base = WriteThrough()
    elif policy == "ttl":
        base = TTLCoherence(ttl_s=ttl_s)
    else:
        base = ServeStaleCoherence(bound_s=bound_s)
    if impl == "llm":
        _require(policy in ("ttl", "serve-stale"),
                 f"impl='llm' needs a read-time decision; {policy!r} "
                 f"decides at write time")
        _require(llm is not None, "impl='llm' requires an llm backend")
        return LLMCoherence(base, llm, few_shot=few_shot)
    return base


# ---------------------------------------------------------------------------
# Accounting (engine-side counters live here so tests can assert on one
# object; the CoherenceRuntime in repro_torch.agent.concurrency fills it)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CoherenceStats:
    mutations: int = 0
    updates: int = 0
    arrivals: int = 0
    invalidations: int = 0      # copies purged at write time (WI)
    writethroughs: int = 0      # copies refreshed in place at write time
    superseded_fills: int = 0   # in-flight fills outdated by a write
    expired_reads: int = 0      # TTL age expiries (refresh, never stale)
    clamped: int = 0            # serve-stale verdicts forced to refresh
    fresh_reads: int = 0
    stale_reads: int = 0
    refresh_reads: int = 0
    max_staleness_s: float = 0.0

    def consumes(self) -> int:
        return self.fresh_reads + self.stale_reads + self.refresh_reads

    def stale_share(self) -> float:
        n = self.consumes()
        return self.stale_reads / n if n else 0.0
