"""Cross-pod replication of super-hot keys.

The pod-sharded cache places each key on exactly one owner pod; under heavy
multi-session traffic the hottest few keys serve a disproportionate share of
all accesses, and whenever churn evicts one from its owner every consumer
pays a remote DB load (plus FCFS queueing on the owner's bandwidth). Systems
in this layer (Cortex's semantic caches, ToolCaching) win by *replicating or
placing hot data near the consumer* — the shared
:class:`~repro_torch.core.admission.FrequencySketch` already identifies the global
top-k, so the evidence is free.

:class:`HotKeyReplicator` promotes hot-but-homeless keys through two feeds:
on each simulated **epoch** it consumes the sketch's ``top_k`` intersected
with the router's per-key demand-load counts (a key that keeps paying
physical DB loads is hot AND unplaceable at its owner), and **between
epochs** the admission layer offers every key it *bypasses* for spill
(:meth:`HotKeyReplicator.offer` via ``router.spill``) — the exact moment we
learn a warm key's owner is full of hotter residents. A promotion pushes
copies via :meth:`PodLocalCacheRouter.replicate`, charging capacity on each
receiving pod: the displaced entry is the host's **minimum-frequency**
resident (placement arbitrage — the swap must beat the globally coldest
stream available), and only if the key's estimate exceeds it by
``gain_ratio``. ``fanout`` bounds copies per key (one copy already converts
the whole miss stream; reads resolve through ``router.locate`` owner-first,
replicas second, at equal pod-local cost).

Demotion is epoch-driven with a **hysteresis band** plus a utility veto: a
replicated key is dropped when its estimate falls below ``demote_frac *
promote_min`` — between the thresholds a *used* replica always holds, so
keys hovering at the promote threshold cannot flap replicate/drop across
epochs (locked in by tests) — and a replica that served no reads for a full
epoch (grace: its promote epoch) returns its slot even inside the band.

Measured effect (zipf-global, the many-endpoints-one-event regime): against
the install-everything engine, replication alone lifts 16-session/4-pod
local hits by 2-4 points with p95 reduced at every tested seed; stacked on
TinyLFU admission it is roughly hit-neutral (placement under TinyLFU is
already near-optimal when every read costs the same pod-locally) while
still trimming the tail — the win is queueing relief on hot owners.

Mirroring admission and eviction, the decision layer is dual: the
programmatic :class:`ThresholdReplication` rule, and the GPT-driven
:class:`LLMReplication` path that renders ``describe()`` + the sketch
evidence into a prompt (``prompts.replication_decision_prompt``), parses the
LLM's replicate/drop/hold answer, and grades it against the programmatic
rule. Like the paper's prompted update, decisions run off the critical path
(background epoch work): they cost tokens, never user-perceived latency.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.core.admission import FrequencySketch


@dataclasses.dataclass
class ReplicationStats:
    epochs: int = 0
    promotes: int = 0            # keys promoted (replicas pushed)
    demotes: int = 0             # keys demoted (replicas dropped)
    holds: int = 0               # in-band decisions that changed nothing
    copies_installed: int = 0    # physical per-pod replica installs
    copies_dropped: int = 0
    replica_bytes: int = 0       # background bytes pushed (off critical path)


class ReplicationPolicy:
    """Decides, per key and epoch, ``"replicate"`` | ``"drop"`` | ``"hold"``.

    Mirrors the admission/eviction policy shape: a programmatic rule plus a
    natural-language ``describe()`` the GPT-driven path prompts with.
    """

    name = "base"
    promote_min: int = 8
    demote_min: int = 4

    def decide(self, key: str, freq: int, replicated: bool) -> str:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


class ThresholdReplication(ReplicationPolicy):
    """Threshold rule with a hysteresis band.

    Promote when the sketch estimate reaches ``promote_min``; demote an
    already-replicated key only when it falls below ``demote_min =
    int(promote_min * demote_frac)``. Estimates inside ``[demote_min,
    promote_min)`` hold the current state — the band is what prevents
    replicate/drop flapping as aging halves the counters each window.
    """

    name = "threshold"

    def __init__(self, promote_min: int = 8, demote_frac: float = 0.5):
        assert promote_min >= 1 and 0.0 <= demote_frac <= 1.0
        self.promote_min = promote_min
        self.demote_min = max(1, int(promote_min * demote_frac))

    def decide(self, key, freq, replicated):
        if not replicated:
            return "replicate" if freq >= self.promote_min else "hold"
        return "drop" if freq < self.demote_min else "hold"

    def describe(self):
        return (f"threshold (replicate when frequency >= {self.promote_min}; "
                f"drop a replica when frequency < {self.demote_min}). Keys "
                "whose frequency sits between the two thresholds KEEP their "
                "current state (hysteresis: no flapping).")


class LLMReplication(ReplicationPolicy):
    """GPT-driven replication: the base policy's ``describe()`` text plus
    the sketch evidence are rendered into a prompt and the LLM answers
    replicate/drop/hold (the paper's prompted-eviction twist applied to
    placement). Graded against the programmatic decision; unparseable
    completions fall back to it. Token cost accumulates off the critical
    path, surfaced as ``replication_tokens`` in the episode metrics."""

    def __init__(self, base: ReplicationPolicy, llm, few_shot: bool = True):
        self.base = base
        self.llm = llm
        self.few_shot = few_shot
        self.name = f"llm-{base.name}"
        self.promote_min = base.promote_min
        self.demote_min = base.demote_min
        self.llm_total = 0
        self.llm_correct = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0
        # resilience fallbacks to the programmatic base (ungraded): garbled
        # prompt/completion vs endpoint pool down
        self.parse_fallbacks = 0
        self.degraded = 0
        self._top_json = "[]"          # evidence block, set per epoch
        self._home_demand: Dict[str, Dict[str, int]] = {}   # locality feed

    def describe(self):
        return self.base.describe()

    @property
    def agreement(self) -> float:
        return self.llm_correct / self.llm_total if self.llm_total else 1.0

    def set_evidence(self, top: List[Tuple[str, int]]) -> None:
        self._top_json = json.dumps([{"key": k, "freq": f} for k, f in top])

    def set_home_demand(self, demand: Dict[str, Dict[str, int]]) -> None:
        """Locality evidence: per-key remote-read counts by consumer home
        pod (``LocalityModel.remote_demand``). Rendered into the prompt so
        the GPT-driven path can reason about WHERE a copy would pay off;
        empty (the default) leaves the prompt byte-identical to the
        locality-free one."""
        self._home_demand = demand

    def decide(self, key, freq, replicated):
        from repro_torch.core.endpoints import LLMUnavailableError
        from repro_torch.core.prompts import LLMParseError, parse_json_tail, \
            replication_decision_prompt
        hd = self._home_demand.get(key)
        prompt = replication_decision_prompt(
            self.base.describe(), key, freq, replicated,
            self.base.promote_min, self.base.demote_min,
            self._top_json, self.few_shot,
            home_demand_json=(json.dumps(hd, sort_keys=True) if hd
                              else None))
        expected = self.base.decide(key, freq, replicated)
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
        if decision not in ("replicate", "drop", "hold"):
            # garbled/meaningless completion: programmatic twin, ungraded
            self.parse_fallbacks += 1
            return expected
        if decision == "replicate" and replicated:
            decision = "hold"            # already replicated: idempotent
        if decision == "drop" and not replicated:
            decision = "hold"
        self.llm_total += 1
        self.llm_correct += int(decision == expected)
        return decision


class HotKeyReplicator:
    """Promotion/demotion of hot-but-homeless keys across pods.

    ``run_epoch(now)`` is called by the concurrent engine's scheduler the
    first time simulated time crosses each ``epoch_s`` boundary (background
    bookkeeping: no session clock is charged). One epoch:

    1. **demote pass** — every currently replicated key is re-judged
       against the (aged) sketch (plus the usage veto: an unused replica
       past its grace epoch returns its slot); a ``drop`` removes its
       replicas from all pods (the owner copy, if any, is untouched);
    2. **promote pass** — candidates are the keys with the most physical
       demand loads since the last epoch (``router.demand_counts``, drained
       here), judged by the policy on their sketch estimate; a
       ``replicate`` pushes copies onto the pods whose coldest residents
       lose the ``gain_ratio`` arbitrage, bounded by ``fanout`` copies and
       ``max_replicated`` concurrently replicated keys.

    Between epochs, :meth:`offer` (wired as ``router.spill``) promotes keys
    the admission layer bypasses, with the same gates — no epoch lag for
    the clearest hot-but-homeless signal there is.

    ``value_of(key)`` supplies the pushed payload (the engine passes the
    datastore's latency-free ``peek`` — replication is a background
    transfer, so only ``replica_bytes`` is accounted, never session time).
    """

    def __init__(self, router, sketch: FrequencySketch, value_of, *,
                 policy: Optional[ReplicationPolicy] = None,
                 top_k: int = 8, max_replicated: int = 4,
                 epoch_s: float = 60.0, fanout: Optional[int] = 1,
                 miss_min: int = 2, gain_ratio: float = 2.0,
                 durability: bool = False, stale_demote_min: int = 2):
        assert epoch_s > 0
        assert stale_demote_min >= 1
        self.router = router
        self.sketch = sketch
        self.value_of = value_of
        self.policy = policy or ThresholdReplication()
        self.top_k = top_k
        self.max_replicated = max_replicated
        self.epoch_s = epoch_s
        self.fanout = fanout              # copies per key (None = every pod)
        self.miss_min = miss_min          # demand loads/epoch to qualify
        self.gain_ratio = gain_ratio      # key must beat the victim by this
        self.durability = durability      # also judge hot RESIDENT keys
        self.next_epoch = epoch_s
        self.replicated: Dict[str, int] = {}     # key -> promote epoch index
        # coherence-churn demotion ("replication
        # earns its demotion path"): the router counts, per key, every
        # replica copy a mutation staled out (``replica_stale_counts``).
        # That churn is folded into a decaying ``stale_pressure`` score
        # each epoch (halved after use, so the ban lifts once the write
        # stream cools); a replicated key at or above ``stale_demote_min``
        # is demoted past its grace epoch, and a key under pressure is
        # vetoed from (re-)promotion — a copy that keeps going stale pays
        # invalidation fan-out every write and serves nothing for it.
        # Always empty without a MutationPlan (digest-locked no-op).
        self.stale_demote_min = stale_demote_min
        self.stale_pressure: Dict[str, int] = {}
        self.stats = ReplicationStats()

    def _stale_pressure(self, key: str) -> int:
        """Current coherence churn on ``key``'s replicas: the decayed
        cross-epoch score plus churn accumulated since the last epoch
        (``offer`` runs between epochs and must see live pressure)."""
        return (self.stale_pressure.get(key, 0)
                + self.router.replica_stale_counts.get(key, 0))

    def _locality(self):
        """The router's locality model when it actually penalizes remote
        reads (None otherwise — at penalty 1x a replica on a consumer pod
        buys nothing a copy anywhere else wouldn't, so the feeds must stay
        bit-identical to the locality-free replicator)."""
        loc = getattr(self.router, "locality", None)
        return loc if loc is not None and loc.penalty > 1.0 else None

    def _demand(self, key: str) -> int:
        """Promotion evidence for one key: physical demand loads since the
        last epoch, plus — under a locality penalty — remote reads paying
        cross-pod hops (a key can be perfectly resident at its owner and
        still be worth a consumer-pod copy)."""
        demand = self.router.demand_counts.get(key, 0)
        loc = self._locality()
        if loc is not None:
            demand += sum(loc.remote_demand.get(key, {}).values())
        return demand

    def _sync_llm_evidence(self) -> None:
        """Refresh the GPT-driven path's prompt evidence: the sketch's
        current top-k plus (under a locality penalty) the per-key remote
        consumer demand by home pod."""
        if not isinstance(self.policy, LLMReplication):
            return
        self.policy.set_evidence(self.sketch.top_k(self.top_k))
        loc = self._locality()
        self.policy.set_home_demand(loc.remote_demand if loc is not None
                                    else {})

    def offer(self, key: str, value, size_bytes: int) -> bool:
        """Spill promotion (between epochs): the owner pod just BYPASSED
        ``key`` — admission found it warmer than nothing but colder than
        every local resident. Another pod may hold someone *globally*
        colder: judge the key now (no epoch lag — by its next access the
        admission layer would simply bypass it again) and, on
        ``replicate``, place one copy where the displaced resident is
        coldest, subject to the same ``gain_ratio`` margin. Returns whether
        a copy was installed. Wired via ``router.spill``."""
        if key in self.replicated:
            return False
        if len(self.replicated) >= self.max_replicated:
            return False
        if self._demand(key) < self.miss_min:
            return False                 # one-shot traffic: not worth a slot
        if self._stale_pressure(key) >= self.stale_demote_min:
            return False                 # keeps going stale: no re-promote
        freq = self.sketch.estimate(key)
        # spill decisions run between epochs: refresh the prompt's
        # "hottest keys right now" (+ consumer demand) evidence so the
        # LLM is graded on the state it actually sees
        self._sync_llm_evidence()
        if self.policy.decide(key, freq, False) != "replicate":
            self.stats.holds += 1
            return False
        copies = self.router.replicate(key, value, size_bytes, self.fanout,
                                       self.gain_ratio)
        if not copies:
            return False
        self.replicated[key] = self.stats.epochs     # grace: current epoch
        self.stats.promotes += 1
        self.stats.copies_installed += copies
        self.stats.replica_bytes += copies * size_bytes
        return True

    def maybe_run(self, now: float) -> None:
        """Run every epoch boundary crossed up to ``now`` (the scheduler
        calls this with each event's timestamp; boundaries are processed
        before the event executes, so placement state at time t never
        depends on events after t)."""
        while now >= self.next_epoch:
            self.run_epoch(self.next_epoch)
            self.next_epoch += self.epoch_s

    def run_epoch(self, now: float) -> None:
        st = self.stats
        st.epochs += 1
        self._sync_llm_evidence()
        # fold the epoch's coherence churn into the decaying pressure score
        # (drained here like demand_counts/replica_reads; see __init__)
        for key, n in self.router.replica_stale_counts.items():
            self.stale_pressure[key] = self.stale_pressure.get(key, 0) + n
        self.router.replica_stale_counts.clear()
        # demote pass: re-judge every replicated key against the aged
        # sketch, then apply the *utility veto* — a replica that served no
        # reads for a full epoch (grace: the epoch it was promoted in) is
        # not earning its slot and is dropped even inside the frequency
        # hysteresis band. Within the band, a USED replica always holds
        # (the no-flap invariant the tests lock in); the veto only reclaims
        # dead capacity as the working set drifts.
        used = self.router.replica_reads
        for key in sorted(self.replicated):
            freq = self.sketch.estimate(key)
            decision = self.policy.decide(key, freq, True)
            grace = self.replicated[key] == st.epochs - 1
            if decision != "drop" and not grace and not used.get(key, 0):
                decision = "drop"
            if (decision != "drop" and not grace
                    and self.stale_pressure.get(key, 0)
                    >= self.stale_demote_min):
                decision = "drop"        # coherence churn: copies keep
                                         # going stale under the write load
            if decision == "drop":
                st.copies_dropped += self.router.drop_replica(key)
                del self.replicated[key]
                st.demotes += 1
            else:
                st.holds += 1
                # repair: install traffic may have evicted every copy since
                # promotion; re-push only when the key is resident NOWHERE
                # (a live copy — owner or replica — already serves reads at
                # the same pod-local cost, so extra copies are pure
                # capacity loss)
                if self.router.locate(key) is None:
                    value = self.value_of(key)
                    size = getattr(value, "size_bytes", 0)
                    copies = self.router.replicate(key, value, size,
                                                   self.fanout,
                                                   self.gain_ratio)
                    st.copies_installed += copies
                    st.replica_bytes += copies * size
        used.clear()
        # promote pass: candidates are the keys that paid the most physical
        # demand loads since the last epoch (the router's ``demand_counts``
        # feed, drained here) — a key that keeps demand-loading is hot AND
        # homeless: its crowded owner pod cannot retain it (it keeps losing
        # the admission contest there, or the owner's slots are monopolised
        # by even hotter siblings), so its whole access stream is paying
        # remote DB service + FCFS queueing. Spilling it onto another pod's
        # capacity converts that stream into pod-local hits; a key the
        # owner retains never accumulates misses, so it is never promoted
        # (extra copies of it would buy nothing — reads resolve owner-first
        # at equal cost). The sketch still gates on global frequency
        # (``promote_min``) so one epoch's burst cannot promote a cold key.
        # Under a locality penalty the feed gains the consumer term: remote
        # reads paying cross-pod hops count alongside physical demand loads
        # (a key resident at its owner never misses, but its off-home
        # consumers still pay a hop per read — a copy on THEIR pod is the
        # paper-faithful localized win). At penalty 1x the merged feed is
        # exactly ``demand_counts`` — bit-identical to the locality-free
        # replicator.
        missed = self.router.demand_counts
        loc = self._locality()
        if loc is not None and loc.remote_demand:
            missed = dict(missed)
            for key, per_pod in loc.remote_demand.items():
                missed[key] = missed.get(key, 0) + sum(per_pod.values())
        feed = sorted(missed.items(), key=lambda kv: (-kv[1], kv[0]))

        def missed_clear():              # drained whether promoted or not
            self.router.demand_counts.clear()
            if loc is not None:
                loc.remote_demand.clear()
        for key, miss_n in feed[:self.top_k]:
            if miss_n < self.miss_min or key in self.replicated:
                continue
            if self.stale_pressure.get(key, 0) >= self.stale_demote_min:
                continue                 # keeps going stale: no re-promote
            if len(self.replicated) >= self.max_replicated:
                break
            freq = self.sketch.estimate(key)
            decision = self.policy.decide(key, freq, False)
            if decision != "replicate":
                st.holds += 1
                continue
            value = self.value_of(key)
            size = getattr(value, "size_bytes", 0)
            copies = self.router.replicate(key, value, size, self.fanout,
                                           self.gain_ratio)
            if not copies:
                continue              # every host vetoed (hotter residents)
            self.replicated[key] = st.epochs      # promote epoch (grace)
            st.promotes += 1
            st.copies_installed += copies
            st.replica_bytes += copies * size
        missed_clear()
        # durability pass (opt-in; off by default and bit-identical to the
        # miss-fed replicator when off): the miss feed structurally never
        # promotes a key the owner retains — it never misses — yet exactly
        # those hot residents are what a pod failure destroys. Judging the
        # sketch's global top-k too places copies that buy no latency
        # (reads resolve owner-first at equal cost) but let the hottest
        # keys SURVIVE owner loss: replication doubling as resilience
        # (table_resilience measures the recovery-time delta). Runs after
        # the miss feed — homeless keys have latency value on top of the
        # durability value, so they get the replica slots first.
        if self.durability:
            for key, _est in self.sketch.top_k(self.top_k):
                if key in self.replicated:
                    continue
                if self.stale_pressure.get(key, 0) >= self.stale_demote_min:
                    continue             # churned-out copies aren't durable
                if len(self.replicated) >= self.max_replicated:
                    break
                freq = self.sketch.estimate(key)
                if self.policy.decide(key, freq, False) != "replicate":
                    st.holds += 1
                    continue
                value = self.value_of(key)
                size = getattr(value, "size_bytes", 0)
                copies = self.router.replicate(key, value, size, self.fanout,
                                               self.gain_ratio)
                if not copies:
                    continue          # every host vetoed (hotter residents)
                self.replicated[key] = st.epochs
                st.promotes += 1
                st.copies_installed += copies
                st.replica_bytes += copies * size
        # decay the coherence-pressure score (halve per epoch): once the
        # write stream off a key cools, the promotion ban lifts within a
        # couple of epochs instead of banning it forever
        self.stale_pressure = {k: v // 2 for k, v in
                               self.stale_pressure.items() if v // 2 > 0}

    # -- reporting ------------------------------------------------------------
    @property
    def agreement(self) -> float:
        return getattr(self.policy, "agreement", 1.0)

    @property
    def tokens(self) -> int:
        return (getattr(self.policy, "prompt_tokens", 0)
                + getattr(self.policy, "completion_tokens", 0))


def make_replication(*, impl: str = "python", llm=None, few_shot: bool = True,
                     promote_min: int = 8, demote_frac: float = 0.5,
                     ) -> ReplicationPolicy:
    """Build a replication policy; ``impl="llm"`` wraps the threshold rule
    in the GPT-driven path (requires an ``llm`` with ``complete()``)."""
    base = ThresholdReplication(promote_min=promote_min,
                                demote_frac=demote_frac)
    if impl == "llm":
        assert llm is not None, "LLM-driven replication needs an llm backend"
        return LLMReplication(base, llm, few_shot=few_shot)
    return base
