"""Plan-cache tier: cache the LLM planning round itself.

The engine caches *data* aggressively, yet every task still pays a full
GPT planning round — the single largest sim-time item — even when the
same task template over the same context keys was planned moments ago by
another session. This module adds a shared, capacity-bounded **plan
cache** with request-level semantics (the related repos' model:
``llm-cache``'s hashed request→response store, ``mnimi``'s request-level
caching + retry-correctness warnings):

* **key model** — ``(task_template_id, context_digest)``. The template id
  is the task's step-kind chain (its "shape"); the context digest hashes
  the sorted required keys *with their current datastore versions* (via
  :class:`~repro_torch.agent.concurrency.CoherenceRuntime` when a mutable data
  plane is wired, version 0 otherwise) *and their current cache
  residency* (a read plan is a pure function of keys × residency × eps
  noise, so residency IS request context — without it a cold-start
  all-``load_db`` plan would replay redundant DB loads all episode). A
  write to any covered key bumps its version, so every digest that
  included the key moves and the old plan becomes unreachable — **no
  stale plan is ever served**, by construction, under any coherence
  policy. Under an invalidating policy the write additionally evicts the
  dead entries eagerly (counted as ``invalidations``);
* **request-level semantics** — a hit serves the stored
  :class:`~repro_torch.core.controller.ReadPlan` verbatim and the planning LLM
  round is skipped entirely: no endpoint latency, no retry/hedge
  exposure, zero plan tokens. Only a small sim-time lookup cost is
  charged (a pod-local metadata read). A miss goes through
  ``SimLLM.complete()`` exactly as before and installs on the way back;
* **admission/invalidation policy** — programmatic TTL + frequency
  (:class:`PlanCachePolicy` over the cache's own
  :class:`~repro_torch.core.admission.FrequencySketch` of plan keys: entries
  expire after ``ttl_s``; a full cache only evicts its LRU entry for a
  candidate at least as frequent), or the GPT-prompted path
  (:class:`LLMPlanCache`, graded agreement + the degraded-mode
  contract — unavailable → programmatic twin, ungraded; garbled →
  parse fallback).

Replay correctness (mnimi's "caching changes semantics" warning, locked
by tests/test_plan_cache.py): serving a stored plan must not shift the
session's decision-noise RNG stream, or every later task's answers would
diverge from a forced-miss replay. The engine therefore burns the exact
eps draws a fresh plan would have consumed on every hit
(:meth:`~repro_torch.agent.concurrency.SharedCacheController.consume_plan_noise`).
A stored plan may still mispredict *current* residency — that surfaces
through the existing failed-``read_cache`` → re-plan path (time/tokens
shift, answers never do), exactly like an eps-flipped fresh decision.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.admission import FrequencySketch
from repro_torch.core.controller import ReadPlan


def task_template_id(task) -> str:
    """Stable task-template identity: the step-kind chain plus the number
    of context keys. Pure in the task's structure, so every session that
    samples the same template computes the same id (cross-session
    sharing); the data context itself lives in the digest."""
    kinds = ">".join(s.kind for s in task.steps)
    return f"{kinds}#{len(task.required_keys)}"


@dataclasses.dataclass
class PlanCacheStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0           # includes expired lookups
    expired: int = 0          # TTL lapses observed at lookup time
    installs: int = 0
    rejected: int = 0         # admission bypasses (policy said no)
    evictions: int = 0        # LRU victims displaced by an admit
    invalidations: int = 0    # entries dropped by a covered-key write
    # paranoid serve-time guard: a served entry whose recorded key
    # versions no longer match the store. Structurally impossible (the
    # digest embeds the versions), counted so the safety lock can assert
    # zero instead of trusting the construction
    stale_served: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class PlanCachePolicy:
    """Programmatic admission/invalidation: TTL + frequency.

    An entry expires ``ttl_s`` after install (checked at lookup; expired
    entries count as misses and are dropped). Admission requires the
    candidate plan key's sketch frequency to reach ``min_freq``, and —
    when the cache is full — to be at least the LRU victim's frequency
    (the TinyLFU shape over plan keys instead of data keys)."""

    kind = "python"
    name = "ttl-lfu"

    def __init__(self, ttl_s: float = 180.0, min_freq: int = 1):
        if ttl_s <= 0.0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        if min_freq < 1:
            raise ValueError(f"min_freq must be >= 1, got {min_freq}")
        self.ttl_s = ttl_s
        self.min_freq = min_freq

    def admit(self, freq: int, victim_freq: Optional[int]) -> bool:
        """Cache the candidate plan? ``victim_freq`` is None while a free
        slot exists (only the frequency floor applies)."""
        if freq < self.min_freq:
            return False
        if victim_freq is None:
            return True
        return freq >= victim_freq

    def describe(self) -> str:
        return (f"TTL + frequency (a cached plan expires {self.ttl_s:g} "
                f"seconds after install; CACHE a new plan only if its "
                f"request frequency is at least {self.min_freq} and, when "
                f"the cache is full, at least the evicted plan's "
                f"frequency).")


class LLMPlanCache:
    """GPT-prompted plan-cache admission (the paper's prompted cache ops
    extended to the decision plane), graded against the programmatic twin.

    Shares the degraded-mode contract: ``LLMUnavailableError`` answers
    from the programmatic policy without tokens or grading
    (``degraded``); a garbled prompt/completion charges the prompt and
    falls back (``parse_fallbacks``); a parsed-but-foreign decision falls
    back ungraded. Free-slot installs skip the prompt entirely — like
    LLMAdmission, the GPT is only consulted when caching costs an
    eviction."""

    kind = "llm"

    def __init__(self, base: PlanCachePolicy, llm, few_shot: bool = True):
        self.base = base
        self.llm = llm
        self.few_shot = few_shot
        self.llm_total = 0
        self.llm_correct = 0
        self.degraded = 0
        self.parse_fallbacks = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0

    # TTL enforcement reads through the wrapper
    @property
    def ttl_s(self) -> float:
        return self.base.ttl_s

    @property
    def min_freq(self) -> int:
        return self.base.min_freq

    @property
    def agreement(self) -> float:
        return self.llm_correct / self.llm_total if self.llm_total else 1.0

    def describe(self) -> str:
        return self.base.describe()

    def admit(self, freq: int, victim_freq: Optional[int],
              template: str = "", victim_template: str = "") -> bool:
        expected = self.base.admit(freq, victim_freq)
        if victim_freq is None:
            return expected          # free slot: no eviction to reason about
        from repro_torch.core.endpoints import LLMUnavailableError
        from repro_torch.core.prompts import (
            LLMParseError,
            parse_json_tail,
            plan_cache_decision_prompt,
        )
        prompt = plan_cache_decision_prompt(
            self.base.describe(), template, victim_template, freq,
            victim_freq, self.base.ttl_s, self.few_shot)
        try:
            completion = self.llm.complete(prompt)
        except LLMUnavailableError:
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
        if decision not in ("cache", "bypass"):
            self.parse_fallbacks += 1
            return expected
        got = decision == "cache"
        self.llm_total += 1
        self.llm_correct += int(got == expected)
        return got


@dataclasses.dataclass
class PlanEntry:
    plan: ReadPlan
    template: str
    digest: str
    keys: Tuple[str, ...]
    versions: Tuple[Tuple[str, int], ...]
    installed_at: float
    last_used: float
    uses: int = 0


class PlanCache:
    """Shared, capacity-bounded plan cache keyed on
    ``(task_template_id, context_digest)``.

    One instance serves every session of an episode (like the admission
    sketch): a plan installed by one session is a hit for any session
    planning the same template over the same context. Recency is the
    entry dict's insertion order (a hit reinserts — exact LRU); the
    frequency evidence is the cache's own plan-key sketch, touched on
    every lookup."""

    def __init__(self, capacity: int = 128, policy=None,
                 version_of: Optional[Callable[[str], int]] = None,
                 sketch_kw: Optional[Dict] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.policy = policy if policy is not None else PlanCachePolicy()
        # current datastore version per key; the engine points this at
        # CoherenceRuntime.current_version when a mutable data plane is
        # wired. Version 0 everywhere otherwise (digests never move).
        self.version_of: Callable[[str], int] = version_of or (lambda k: 0)
        # current cache residency per key; the engine points this at the
        # pod router's locate(). A read plan is a pure function of
        # (keys, residency, eps noise), so residency is part of the
        # request context: folding it into the digest means a stored plan
        # is only served against the cache state it was computed for —
        # a cold-start all-load_db plan stops hitting the moment the
        # fleet warms up, instead of replaying redundant DB loads all
        # episode. None (standalone use) pins the bit to False.
        self.resident_of: Optional[Callable[[str], bool]] = None
        self.sketch = FrequencySketch(**(sketch_kw or {}))
        self.entries: Dict[Tuple[str, str], PlanEntry] = {}
        self.by_key: Dict[str, Set[Tuple[str, str]]] = {}
        self.stats = PlanCacheStats()

    # -- key model -----------------------------------------------------------
    def context_versions(self, keys: Sequence[str]
                         ) -> Tuple[Tuple[str, int, bool], ...]:
        res = self.resident_of
        return tuple((k, self.version_of(k), bool(res(k)) if res else False)
                     for k in sorted(keys))

    def context_digest(self, keys: Sequence[str]) -> str:
        parts = "|".join(f"{k}@{v}@{int(r)}"
                         for k, v, r in self.context_versions(keys))
        return hashlib.blake2b(parts.encode(), digest_size=8).hexdigest()

    # -- request path --------------------------------------------------------
    def lookup(self, template: str, keys: Sequence[str],
               now: float) -> Optional[ReadPlan]:
        """Serve the stored plan for ``(template, digest(keys))`` or None.
        Counts the lookup, touches the plan-key sketch (the admission
        evidence), enforces TTL, and keeps LRU order."""
        st = self.stats
        st.lookups += 1
        digest = self.context_digest(keys)
        ck = (template, digest)
        self.sketch.touch(f"{template}|{digest}", now)
        entry = self.entries.get(ck)
        if entry is None:
            st.misses += 1
            return None
        ttl = self.policy.ttl_s
        if now - entry.installed_at > ttl:
            st.expired += 1
            st.misses += 1
            self._drop(ck)
            return None
        if entry.versions != self.context_versions(keys):
            # structurally unreachable (the digest embeds the versions);
            # counted so the zero-stale-served lock measures, not trusts
            st.stale_served += 1
            st.misses += 1
            self._drop(ck)
            return None
        st.hits += 1
        entry.last_used = now
        entry.uses += 1
        del self.entries[ck]          # reinsert: dict order is recency
        self.entries[ck] = entry
        return entry.plan

    def install(self, template: str, keys: Sequence[str], plan: ReadPlan,
                now: float) -> bool:
        """Offer a freshly planned ``ReadPlan`` after a miss. The policy
        (programmatic or GPT-prompted) decides cache vs bypass; a full
        cache evicts its LRU entry on admit."""
        digest = self.context_digest(keys)
        ck = (template, digest)
        if ck in self.entries:
            return False               # racing sessions: first install wins
        freq = int(self.sketch.estimate(f"{template}|{digest}"))
        victim_ck = victim_freq = victim_template = None
        if len(self.entries) >= self.capacity:
            victim_ck = next(iter(self.entries))
            victim_freq = int(self.sketch.estimate("|".join(victim_ck)))
            victim_template = victim_ck[0]
        pol = self.policy
        if isinstance(pol, LLMPlanCache):
            ok = pol.admit(freq, victim_freq, template=template,
                           victim_template=victim_template or "")
        else:
            ok = pol.admit(freq, victim_freq)
        if not ok:
            self.stats.rejected += 1
            return False
        if victim_ck is not None:
            self._drop(victim_ck)
            self.stats.evictions += 1
        entry = PlanEntry(plan=plan, template=template, digest=digest,
                          keys=tuple(keys),
                          versions=self.context_versions(keys),
                          installed_at=now, last_used=now)
        self.entries[ck] = entry
        for k in entry.keys:
            self.by_key.setdefault(k, set()).add(ck)
        self.stats.installs += 1
        return True

    # -- write coupling ------------------------------------------------------
    def note_write(self, key: str, invalidate: bool) -> int:
        """A datastore write landed on ``key``. The version bump already
        moved every digest covering it (old plans are unreachable); under
        an invalidating coherence policy the dead entries are additionally
        dropped now (capacity hygiene, counted)."""
        if not invalidate:
            return 0
        dropped = 0
        for ck in list(self.by_key.get(key, ())):
            self._drop(ck)
            dropped += 1
        if dropped:
            self.stats.invalidations += dropped
        return dropped

    # -- internals -----------------------------------------------------------
    def _drop(self, ck: Tuple[str, str]) -> None:
        entry = self.entries.pop(ck, None)
        if entry is None:
            return
        for k in entry.keys:
            covers = self.by_key.get(k)
            if covers is not None:
                covers.discard(ck)
                if not covers:
                    del self.by_key[k]

    # -- reporting -----------------------------------------------------------
    @property
    def agreement(self) -> float:
        return getattr(self.policy, "agreement", 1.0)

    @property
    def tokens(self) -> int:
        return (getattr(self.policy, "prompt_tokens", 0)
                + getattr(self.policy, "completion_tokens", 0))

    def covered_entries(self, key: str) -> List[Tuple[str, str]]:
        """Plan-cache keys whose context digest covers ``key``
        (diagnostics + the ``cache_plan`` probe)."""
        return sorted(self.by_key.get(key, ()))


def make_plan_cache(impl: str = "python", *, llm=None, few_shot: bool = True,
                    capacity: int = 128, ttl_s: float = 180.0,
                    min_freq: int = 1,
                    sketch_kw: Optional[Dict] = None) -> PlanCache:
    """Factory mirroring ``make_admission``/``make_coherence``:
    ``impl="python"`` (or ``"programmatic"``) builds the TTL+frequency
    policy, ``impl="llm"`` wraps it in the graded GPT-prompted path."""
    base = PlanCachePolicy(ttl_s=ttl_s, min_freq=min_freq)
    if impl in ("python", "programmatic"):
        policy = base
    elif impl == "llm":
        assert llm is not None, "impl='llm' requires an llm"
        policy = LLMPlanCache(base, llm, few_shot=few_shot)
    else:
        raise ValueError(
            f"unknown plan-cache impl {impl!r} "
            f"(expected 'python', 'programmatic' or 'llm')")
    return PlanCache(capacity=capacity, policy=policy, sketch_kw=sketch_kw)
