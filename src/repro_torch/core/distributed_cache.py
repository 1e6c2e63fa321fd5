"""Pod-local data caching for multi-pod deployments (DESIGN §3).

The paper runs on "hundreds of GPT endpoints"; at multi-pod scale the
localized cache becomes a *sharded* cache: each pod owns a partition of the
``dataset-year`` key space (rendezvous hashing) and requests are routed with
pod affinity, so a key's data is cached on exactly one pod and reuse
concentrates there. Pod failure triggers deterministic re-partitioning
(elastic), and the remaining pods absorb the failed pod's keys.

Loads can be **asynchronous**: :meth:`PodLocalCacheRouter.start_load`
registers an in-flight load with its simulated completion time (the
concurrent engine's prefetcher and demand loads both use it), and
:meth:`PodLocalCacheRouter.finish_load` installs the value into the owning
pod's cache when the simulation reaches that time. While a load is in
flight, sessions needing the same key *join* it (wait for the existing
completion) instead of issuing a duplicate DB load. See
docs/architecture.md for the full data flow.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional

from repro_torch.core.admission import AdmissionPolicy, FrequencySketch
from repro_torch.core.cache import DataCache
from repro_torch.core.policies import Policy, make_policy


def _score(key: str, pod: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(f"{key}|{pod}".encode(), digest_size=8).digest(), "big")


@dataclasses.dataclass
class RoutingStats:
    """Logical-access accounting (one increment of ``routed`` per session
    data access) plus physical prefetch issuance.

    Invariant: ``routed == local_hits + remote_loads + joined_in_flight``.
    ``prefetch_issued`` counts physical loads started by a prefetcher; they
    are *not* logical accesses (the later consume is, and lands in one of
    the three buckets above — usually ``joined_in_flight`` or
    ``local_hits``).
    """
    routed: int = 0
    local_hits: int = 0
    remote_loads: int = 0
    failovers: int = 0
    joined_in_flight: int = 0
    prefetch_issued: int = 0
    # admission accounting (all zero when no admission policy is wired):
    # ``admitted``/``bypassed`` count full-cache admission decisions;
    # ``bypass_reads`` counts logical accesses served straight from a
    # completed-but-bypassed load (the invariant gains a fourth bucket:
    # routed == local_hits + remote_loads + joined_in_flight + bypass_reads)
    admitted: int = 0
    bypassed: int = 0
    bypass_reads: int = 0
    # hot-key replication accounting (all zero without a HotKeyReplicator):
    # ``replica_installs``/``replica_drops`` count per-pod copy churn;
    # ``replica_hits`` counts local hits served by a NON-owner pod's copy —
    # they are a subset of ``local_hits`` (a replica hit is a local hit
    # that would otherwise have been a remote load or join)
    replica_installs: int = 0
    replica_drops: int = 0
    replica_hits: int = 0
    # fault/elasticity accounting (all zero without a FaultPlan):
    # ``aborted_loads`` counts in-flight loads killed with their pod;
    # ``retried_loads`` counts the physical re-issues the engine makes on
    # behalf of aborted waiters (the physical-load invariant becomes
    # remote_loads + prefetch_issued + retried_loads == total pod loads);
    # ``timeout_loads`` counts waiters that exhausted their retry budget
    # and bypassed to a direct DB read (never a stall-forever);
    # ``scale_outs``/``scale_ins`` count elastic membership changes (a
    # scale_in re-routes like a failure but is not a failover)
    aborted_loads: int = 0
    retried_loads: int = 0
    timeout_loads: int = 0
    scale_outs: int = 0
    scale_ins: int = 0
    # coherence accounting (all zero without a MutationPlan):
    # ``stale_reads`` counts logical accesses that consumed a version-lagged
    # copy under a bounded-staleness policy (a sub-bucket of
    # local_hits/joined_in_flight/bypass_reads — the access still lands in
    # its normal invariant bucket); ``refresh_loads`` counts physical
    # reloads forced by a coherence verdict (a sub-bucket of remote_loads:
    # the logical access routes as a remote load AND is marked a refresh);
    # ``superseded_fills`` counts in-flight fills whose version was
    # outdated by a write before completion and that a zero-staleness
    # policy therefore refused to install
    stale_reads: int = 0
    refresh_loads: int = 0
    superseded_fills: int = 0


@dataclasses.dataclass
class InFlightLoad:
    """A DB load that has been issued but whose (simulated) service has not
    completed yet. ``completes_at`` is the absolute sim time at which the
    value lands in the owning pod's cache."""
    key: str
    pod: str
    issued_at: float
    completes_at: float
    value: object
    size_bytes: int
    prefetched: bool = False
    joiners: int = 0
    credited: bool = False    # overlap credited (once per physical load)
    installed: bool = False   # completion installed it into the pod cache
    bypassed: bool = False    # completion was rejected by admission
    aborted: bool = False     # the serving pod died before completes_at
    # datastore version the read serialized at (its issue instant). A write
    # landing mid-flight leaves this behind the key's current version; the
    # coherence layer decides at consume/install time what that means.
    version: int = 0
    superseded: bool = False  # outdated mid-flight; fill not installed


@dataclasses.dataclass
class FailoverReport:
    """What one membership change destroyed — computed *before* the pod
    leaves service so the engine can abort/retry the affected sessions
    with exact state. ``lost_keys`` are the residents of the dying pod's
    cache (its working set, now cold); ``aborted`` are the in-flight loads
    that died with it (each marked ``aborted=True`` and removed from the
    router's in-flight table); ``lost_replicas`` are keys that lost a
    replica copy hosted on the pod (they may still be resident at their
    owner or on other replica pods)."""
    pod: str
    lost_keys: List[str]
    aborted: List[InFlightLoad]
    lost_replicas: List[str]


class PodLocalCacheRouter:
    """Rendezvous-hash router over per-pod DataCaches."""

    def __init__(self, pod_ids: List[str], capacity_per_pod: int = 5,
                 policy_name: str = "lru",
                 clock: Optional[Callable[[], float]] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 sketch: Optional[FrequencySketch] = None):
        self._clock = clock
        self._policy_name = policy_name
        self._capacity = capacity_per_pod   # default for scale_out pods
        # shared cross-session admission: one policy + one frequency sketch
        # for ALL pods (popularity is a property of the key, not the pod)
        self.admission = admission
        self.sketch = sketch
        self.pods: Dict[str, DataCache] = {
            p: DataCache(capacity_per_pod, clock) for p in pod_ids}
        self.policies: Dict[str, Policy] = {
            p: make_policy(policy_name) for p in pod_ids}
        self.alive: Dict[str, bool] = {p: True for p in pod_ids}
        self.stats = RoutingStats()
        self.in_flight: Dict[str, InFlightLoad] = {}
        # owner() memo: rendezvous hashing is deterministic in (key, live
        # pod set), so the winner is cached per key and the whole memo is
        # invalidated whenever membership changes (fail/restore). At 256
        # sessions the blake2-per-(key,pod) max() walk dominated routing.
        self._owner_memo: Dict[str, str] = {}
        # hot-key replicas: key -> pods (never the owner) a HotKeyReplicator
        # has pushed a copy to. The list is *advisory* — a replica can be
        # evicted later by that pod's own install traffic, so lookups verify
        # membership (see ``locate``). Empty without a replicator, in which
        # case every replica-aware path reduces exactly to the owner-only
        # behavior (digest-locked).
        self.replicas: Dict[str, List[str]] = {}
        # per-key demand-load counter since the last replication epoch: the
        # replicator's promotion feed (a key that keeps paying physical DB
        # loads is hot AND homeless — exactly what a replica fixes). Only
        # maintained while a replicator is wired (``spill`` is set); the
        # replicator drains it each epoch.
        self.demand_counts: Dict[str, int] = {}
        # per-key reads served by a replica since the last epoch: the
        # replicator's *demotion* feed (a replica that serves no reads for
        # a full epoch is not earning its slot). Drained each epoch.
        self.replica_reads: Dict[str, int] = {}
        # spill hook: a HotKeyReplicator registers itself here; a full
        # owner pod that BYPASSES a candidate offers it for spill
        # replication at that instant (admission knows the key is warm but
        # cannot place it locally — another pod may hold someone globally
        # colder). None without replication.
        self.spill = None
        # locality cost model (repro_torch.core.locality.LocalityModel): set by
        # the concurrent engine when session->pod affinity is enabled.
        # None keeps every routing decision exactly the owner-first
        # behavior; with a model whose penalty > 1, ``locate`` becomes
        # cheapest-first and ``replicate`` targets consumer pods.
        self.locality = None
        # mutable-data-plane hooks, all inert without mutations:
        # ``version_of`` maps key -> current datastore version (None means
        # the store is immutable and every copy is version 0 forever);
        # ``fresh_fills_only`` is set by the zero-staleness policies
        # (write-invalidate / write-through) so a fill outdated mid-flight
        # is never installed; ``replica_stale_counts`` accumulates, per
        # key, how many REPLICA copies a mutation staled out — the
        # HotKeyReplicator's coherence-churn demotion feed (drained each
        # epoch, like demand_counts/replica_reads).
        self.version_of: Optional[Callable[[str], int]] = None
        self.fresh_fills_only = False
        self.replica_stale_counts: Dict[str, int] = {}

    # -- membership ----------------------------------------------------------
    def _purge_pod(self, pod_id: str) -> FailoverReport:
        """Everything a pod's departure invalidates, computed before it
        leaves service: abort its in-flight loads (they can never
        ``finish_load`` — a dangling record would block the key's next
        demand load forever), un-count their demand-feed contribution (the
        load never completed; the replicator must not promote on it — the
        engine's retry re-counts when it re-issues), drop its replica
        copies, and purge the ``replica_reads`` demotion feed for keys
        left with no replicas at all."""
        aborted = [rec for rec in self.in_flight.values()
                   if rec.pod == pod_id]
        for rec in aborted:
            del self.in_flight[rec.key]
            rec.aborted = True
            self.stats.aborted_loads += 1
            if not rec.prefetched and rec.key in self.demand_counts:
                self.demand_counts[rec.key] -= 1
                if self.demand_counts[rec.key] <= 0:
                    del self.demand_counts[rec.key]
        lost_replicas = []
        for key in list(self.replicas):
            pods = self.replicas[key]
            if pod_id in pods:
                pods.remove(pod_id)
                lost_replicas.append(key)
            if not pods:
                del self.replicas[key]
                self.replica_reads.pop(key, None)
        self._owner_memo.clear()
        return FailoverReport(pod=pod_id,
                              lost_keys=sorted(self.pods[pod_id].keys()),
                              aborted=aborted,
                              lost_replicas=sorted(lost_replicas))

    def fail_pod(self, pod_id: str) -> Optional[FailoverReport]:
        """Simulated pod failure: its cache contents are lost; its key range
        re-routes deterministically to survivors (rendezvous property). The
        rebuilt cache keeps the router's clock so the restored pod stays on
        simulated time (recency metadata stays comparable across pods).

        Idempotent: failing an already-dead pod is a no-op returning
        ``None`` (no failover counted, nothing purged twice). Otherwise
        returns the :class:`FailoverReport` of what died with the pod."""
        if not self.alive.get(pod_id, False):
            return None
        report = self._purge_pod(pod_id)
        self.alive[pod_id] = False
        self.pods[pod_id] = DataCache(self.pods[pod_id].capacity, self._clock)
        self.policies[pod_id] = make_policy(self._policy_name)
        self.stats.failovers += 1
        return report

    def restore_pod(self, pod_id: str) -> bool:
        """Return a failed pod to service (cold — its contents died with
        it). Idempotent: restoring a live pod is a no-op returning False."""
        if self.alive.get(pod_id, False):
            return False
        assert pod_id in self.pods, f"unknown pod {pod_id}"
        self.alive[pod_id] = True
        self._owner_memo.clear()
        return True

    def scale_out(self, pod_id: str,
                  capacity: Optional[int] = None) -> None:
        """Elastic fleet growth: add a brand-new (cold, empty) pod. The
        rendezvous property means only the keys it now wins re-route onto
        it; everything else keeps its owner and its warm cache."""
        assert pod_id not in self.pods, f"pod {pod_id} already exists"
        self.pods[pod_id] = DataCache(capacity or self._capacity, self._clock)
        self.policies[pod_id] = make_policy(self._policy_name)
        self.alive[pod_id] = True
        self._owner_memo.clear()
        self.stats.scale_outs += 1

    def scale_in(self, pod_id: str) -> Optional[FailoverReport]:
        """Elastic fleet shrink: retire a pod entirely. Its keys re-route
        like a failure (same purge/abort semantics, same
        :class:`FailoverReport`) but it is accounted as a scale event, not
        a failover. No-op returning ``None`` for an unknown pod; refuses
        to retire the last live pod."""
        if pod_id not in self.pods:
            return None
        live = self.live_pods()
        assert not (live == [pod_id]), "cannot scale in the last live pod"
        report = (self._purge_pod(pod_id) if self.alive.get(pod_id, False)
                  else FailoverReport(pod=pod_id, lost_keys=[], aborted=[],
                                      lost_replicas=[]))
        del self.pods[pod_id]
        del self.policies[pod_id]
        del self.alive[pod_id]
        self._owner_memo.clear()
        self.stats.scale_ins += 1
        return report

    def live_pods(self) -> List[str]:
        return [p for p, ok in self.alive.items() if ok]

    # -- routing -------------------------------------------------------------
    def owner(self, key: str) -> str:
        pod = self._owner_memo.get(key)
        if pod is None:
            live = self.live_pods()
            if not live:
                raise RuntimeError("no live pods")
            pod = max(live, key=lambda p: _score(key, p))
            self._owner_memo[key] = pod
        return pod

    def locate(self, key: str, home: Optional[str] = None) -> Optional[str]:
        """The pod whose cache currently holds ``key``, cheapest placement
        first for the consumer homed on ``home``.

        Without a locality penalty every pod-local read costs the same, so
        the order is the original one: the owner when it holds the key (the
        common case and the only case without replication), else the first
        live replica pod that still holds a copy (deterministic:
        replica-list insertion order), else ``None``. With a locality model
        whose ``penalty > 1`` and a consumer ``home``, a copy on the home
        pod is strictly cheaper than any other placement (it skips the
        cross-pod hop), so it wins; all non-home placements still cost the
        same single hop and keep the owner-first tie-break. Replica lists
        are advisory — membership is verified against the actual pod
        cache."""
        pod = self.owner(key)
        held = key in self.pods[pod]
        if held and (home is None or pod == home):
            return pod
        if (home is not None and home != pod and self.locality is not None
                and self.locality.penalty > 1.0):
            pods = self.replicas.get(key)
            if (pods and home in pods and self.alive.get(home, False)
                    and key in self.pods[home]):
                return home
        if held:
            return pod
        pods = self.replicas.get(key)
        if pods:
            for p in pods:
                if self.alive.get(p, False) and key in self.pods[p]:
                    return p
        return None

    def note_access(self, key: str, now: Optional[float] = None) -> None:
        """Record one logical access in the shared frequency sketch (no-op
        without a sketch). Callers on a sim clock pass ``now`` so the
        sketch ages on simulated time."""
        if self.sketch is not None:
            self.sketch.touch(key, now)

    def install(self, pod: str, key: str, value: object,
                size_bytes: int, version: int = 0) -> bool:
        """Install a loaded value into ``pod``'s cache, evicting per the
        pod's policy when full (shared by ``fetch`` and the concurrent
        engine's load path, so eviction semantics cannot diverge).

        With an admission policy wired, a full cache consults it first:
        a rejected candidate **bypasses** — nothing is installed, no
        resident is evicted, and the caller keeps streaming the value to
        the session. Returns whether ``key`` resides in the pod cache
        after the call."""
        cache = self.pods[pod]
        if key in cache:
            return True
        victim = None
        if len(cache) >= cache.capacity:
            victim = self.policies[pod].victim(cache.entries())
            if self.admission is not None:
                if not self.admission.admit(key, victim, self.sketch,
                                            cache.entries(),
                                            size_bytes=size_bytes):
                    self.stats.bypassed += 1
                    if self.spill is not None:
                        # hot-but-homeless: offer the rejected key for
                        # spill replication onto another pod's capacity
                        self.spill(key, value, size_bytes)
                    return False
                self.stats.admitted += 1
        cache.put(key, value, size_bytes, victim=victim, version=version)
        return True

    # -- hot-key replication --------------------------------------------------
    def replicate(self, key: str, value: object, size_bytes: int,
                  fanout: Optional[int] = None,
                  gain_ratio: float = 1.0) -> int:
        """Push copies of ``key`` to live non-owner pods (the
        HotKeyReplicator's promote action). Capacity is charged on each
        receiving pod: a full pod evicts its update policy's victim to make
        room — unless the shared sketch says the victim is at least as hot
        as ``key`` (replication must not churn out someone hotter).

        ``fanout=None`` pushes to *every* eligible pod; a bounded fanout
        takes the cheapest hosts first — pods with free capacity, then pods
        whose would-be victim is coldest (deterministic: ties break by pod
        id). One copy already converts the key's whole miss stream into
        pod-local hits (reads resolve owner-first, replicas second at equal
        cost), so bounded fanout buys the same hits for fewer evictions.

        The replica's victim is the host pod's MINIMUM-FREQUENCY resident
        (per the shared sketch), not the pod's update-policy victim: the
        update policy optimises the pod's own demand stream (recency), but
        a replica install is a *placement arbitrage* — it only pays off
        when the displaced stream is the globally coldest one available.
        Skips pods already holding a copy; skips pods whose coldest
        resident is at least as hot as ``key``. Returns the number of new
        copies.

        With a locality model whose ``penalty > 1``, placement targets
        **consumer pods**: hosts are ordered by the key's remote-read
        demand from sessions homed there (``LocalityModel.remote_demand``,
        highest first — a copy on such a pod converts every one of those
        reads from a penalized hop into a pod-local hit), and the
        gain-ratio arbitrage scales the key's frequency by ``penalty`` on
        demanding hosts (each converted read is worth a whole hop, so the
        swap clears the bar earlier exactly where the locality benefit is
        real). At penalty 1x the demand map is ignored and the ordering is
        bit-identical to the coldest-resident-first rule."""
        owner = self.owner(key)
        kf = self.sketch.estimate(key) if self.sketch is not None else None
        loc = self.locality
        demand = (loc.remote_demand.get(key) or {}
                  if loc is not None and loc.penalty > 1.0 else {})
        candidates = []
        for p in self.live_pods():
            if p == owner:
                continue
            cache = self.pods[p]
            if key in cache:
                continue
            gain = loc.penalty if demand.get(p) else 1.0
            victim = None
            vf = -1                      # free slot: cheapest possible host
            if len(cache) >= cache.capacity:
                entries = cache.entries()
                if self.sketch is not None:
                    ests = self.sketch.estimate_many(sorted(entries))
                    vf, victim = min(zip(ests, sorted(entries)))
                    # the swap only pays when the key's stream decisively
                    # beats the displaced one: require a gain_ratio margin
                    # over the coldest resident (>= 1.0; higher = pickier)
                    if kf is not None and kf * gain < gain_ratio * max(vf, 1):
                        continue
                else:
                    victim = self.policies[p].victim(entries)
                    vf = 0
            candidates.append((-demand.get(p, 0), vf, p, victim))
        candidates.sort()
        if fanout is not None:
            candidates = candidates[:fanout]
        installed = 0
        ver = self.version_of(key) if self.version_of is not None else 0
        for _, _, p, victim in candidates:
            self.pods[p].put(key, value, size_bytes, victim=victim,
                             version=ver)
            pods = self.replicas.setdefault(key, [])
            if p not in pods:
                pods.append(p)
            installed += 1
            self.stats.replica_installs += 1
        return installed

    def drop_replica(self, key: str) -> int:
        """Remove every tracked replica of ``key`` (the demote action). The
        owner pod's copy — if any — is untouched: ownership placement stays
        the admission/eviction layer's business. Returns copies removed."""
        dropped = 0
        for p in self.replicas.pop(key, []):
            if self.alive.get(p, False) and self.pods[p].drop(key):
                dropped += 1
                self.stats.replica_drops += 1
        return dropped

    # -- coherence fan-out (every method a no-op on a key with no
    # live copies, so the mutation-free engine never reaches this code) ------
    def _note_replica_stale(self, key: str) -> None:
        self.replica_stale_counts[key] = (
            self.replica_stale_counts.get(key, 0) + 1)

    def invalidate_copies(self, key: str) -> int:
        """Write-invalidate fan-out: purge EVERY live copy of ``key`` —
        owner resident and every replica the HotKeyReplicator placed —
        and untrack its replica list (dead pods' copies were already
        destroyed with the pod, so they cannot serve stale either).
        Replica purges feed ``replica_stale_counts`` (demotion pressure:
        a copy that keeps getting invalidated is not earning its slot).
        Returns the number of copies purged."""
        owner = self.owner(key)
        purged = 0
        for p, cache in self.pods.items():
            if self.alive.get(p, False) and cache.drop(key):
                purged += 1
                if p != owner:
                    self._note_replica_stale(key)
        self.replicas.pop(key, None)
        return purged

    def refresh_copies(self, key: str, version: int) -> int:
        """Write-through fan-out: push ``version`` into every live copy in
        place (the writer pays per copy; values are content-identical in
        the sim, so the version stamp IS the refresh). Replica refreshes
        still count as coherence churn for the demotion feed. Returns the
        number of copies refreshed."""
        owner = self.owner(key)
        refreshed = 0
        for p, cache in self.pods.items():
            if not self.alive.get(p, False):
                continue
            e = cache.entry(key)
            if e is not None:
                e.version = version
                refreshed += 1
                if p != owner:
                    self._note_replica_stale(key)
        return refreshed

    def stale_copies(self, key: str) -> int:
        """Bounded-staleness bookkeeping at write time: copies stay in
        place (readers decide at consume time) but replica copies that
        just went version-lagged still count demotion pressure. Returns
        the number of live copies now lagging."""
        owner = self.owner(key)
        lagging = 0
        for p, cache in self.pods.items():
            if not self.alive.get(p, False) or key not in cache:
                continue
            lagging += 1
            if p != owner:
                self._note_replica_stale(key)
        return lagging

    # -- async completion -----------------------------------------------------
    def start_load(self, key: str, value: object, size_bytes: int, *,
                   issued_at: float, completes_at: float,
                   prefetched: bool = False) -> InFlightLoad:
        """Register an in-flight load of ``key`` on its owning pod.

        The caller has already arbitrated pod bandwidth (``completes_at``
        reflects any queueing); until :meth:`finish_load` runs, the key is
        neither cached nor loadable again — sessions that need it join this
        record instead of re-issuing the DB load.
        """
        assert key not in self.in_flight, f"{key} already in flight"
        rec = InFlightLoad(key=key, pod=self.owner(key), issued_at=issued_at,
                           completes_at=completes_at, value=value,
                           size_bytes=size_bytes, prefetched=prefetched,
                           version=(self.version_of(key)
                                    if self.version_of is not None else 0))
        self.in_flight[key] = rec
        if prefetched:
            self.stats.prefetch_issued += 1
        elif self.spill is not None:     # replication wired: feed promotion
            self.demand_counts[key] = self.demand_counts.get(key, 0) + 1
        return rec

    def finish_load(self, key: str) -> InFlightLoad:
        """Complete an in-flight load: install the value into the owning
        pod's cache (evicting per policy). Called by the discrete-event
        scheduler when sim time reaches ``completes_at``."""
        rec = self.in_flight.pop(key)
        if self.alive.get(rec.pod, False):
            if (self.fresh_fills_only and self.version_of is not None
                    and rec.version < self.version_of(key)):
                # a write outdated this fill mid-flight and the policy
                # forbids stale installs: the value still streams to its
                # waiters (their reads serialized before the write) but
                # nothing lands in the cache — the next read re-fetches
                rec.superseded = True
                self.stats.superseded_fills += 1
                return rec
            rec.installed = self.install(rec.pod, rec.key, rec.value,
                                         rec.size_bytes,
                                         version=rec.version)
            rec.bypassed = not rec.installed
        return rec

    def fetch(self, key: str, loader: Callable[[str], object],
              size_of: Callable[[object], int]):
        """Route to the owning pod; hit its local cache or load+install."""
        pod = self.owner(key)
        cache = self.pods[pod]
        self.stats.routed += 1
        self.note_access(key, self._clock() if self._clock else None)
        if key in cache:
            self.stats.local_hits += 1
            return cache.get(key), pod, True
        self.stats.remote_loads += 1
        value = loader(key)
        if not self.install(pod, key, value, size_of(value)):
            # admission bypass: the value streams through uncached
            return value, pod, False
        # install counts as first access
        return cache.get(key), pod, False

    # -- reporting -----------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        return {
            "pods": {p: {"keys": sorted(c.keys()),
                         "hit_rate": round(c.stats.hit_rate, 4)}
                     for p, c in self.pods.items()},
            "routed": self.stats.routed,
            "local_hit_rate": (self.stats.local_hits / self.stats.routed
                               if self.stats.routed else 0.0),
            "failovers": self.stats.failovers,
            "admission": (self.admission.name if self.admission else None),
            "admitted": self.stats.admitted,
            "bypassed": self.stats.bypassed,
        }
