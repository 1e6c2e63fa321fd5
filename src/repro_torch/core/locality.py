"""Session→pod affinity + consumer-side locality cost model.

The paper's headline is *localized* data caching: a read served from the pod
a session lives on is cheap, a read served across pods is not. Until now the
simulator charged every pod-local read the same, so cross-pod replication
only ever won through queueing relief. This module makes locality real:

* an :class:`AffinityPolicy` assigns every session a **home pod** (sticky
  hashing, round-robin, least-loaded, or per-task migration), and
* a :class:`LocalityModel` charges a ``remote_read_penalty`` whenever the
  pod *serving* a value is not the consuming session's home pod: the read
  pays an extra cross-pod **hop** of ``(penalty - 1) x cache_read(size)``
  seconds, optionally serialized on the home pod's ingress link
  (``link_queue=True`` — concurrent remote reads into one pod queue FCFS on
  its bandwidth, exactly like demand loads queue on the owner's).

Degeneracy contract (locked by tests/test_locality.py): with
``penalty == 1.0`` the hop is zero seconds, the link never accumulates a
busy window, and every engine trace is bit-identical to the affinity-free
engine — the model then only *classifies* reads (local vs remote), which is
what the differential harness and the partition invariant check.

The model also keeps the replicator's consumer evidence: every penalized
remote read increments ``remote_demand[key][home_pod]``, so promotion can
target the pods whose sessions are actually paying hops (placement
arbitrage gains a locality term — see
:meth:`PodLocalCacheRouter.replicate`). The map is drained each
replication epoch alongside ``demand_counts``; when no replicator is
wired, the engine sets ``demand_window_s`` and the map self-drains on
that simulated-time window instead.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional


# ---------------------------------------------------------------------------
# Affinity: which pod is a session's home?
# ---------------------------------------------------------------------------

class AffinityPolicy:
    """Maps ``(session id, task index)`` to a home-pod index.

    Policies are deterministic in their constructor arguments; ``home`` is
    called at every task boundary, so a policy may migrate a session over
    its task stream (see :class:`MigratingAffinity`).
    """

    name = "base"

    def __init__(self, n_pods: int):
        assert n_pods >= 1
        self.n_pods = n_pods

    def home(self, sid: int, task_index: int) -> int:
        raise NotImplementedError


class StickyAffinity(AffinityPolicy):
    """Hash the session id onto a pod once; the session never moves. The
    blake2 spread is uniform but not round-robin — neighbouring sessions
    can share a home, like real sticky load-balancing."""

    name = "sticky"

    def home(self, sid, task_index):
        h = hashlib.blake2b(f"sess{sid}".encode(), digest_size=8).digest()
        return int.from_bytes(h, "big") % self.n_pods


class RoundRobinAffinity(AffinityPolicy):
    """Session ``sid`` homes on ``sid % n_pods`` — perfectly even by
    construction (the scheduler-assigns-in-order model)."""

    name = "round_robin"

    def home(self, sid, task_index):
        return sid % self.n_pods


class LoadBalancedAffinity(AffinityPolicy):
    """Assign each session, at first sight, to the pod currently homing the
    fewest sessions (ties break by pod index). With sessions created in id
    order this equals round-robin; it diverges once session populations do
    (e.g. a later wave of sessions joining mid-episode)."""

    name = "load_balanced"

    def __init__(self, n_pods: int):
        super().__init__(n_pods)
        self._counts = [0] * n_pods
        self._assigned: Dict[int, int] = {}

    def home(self, sid, task_index):
        pod = self._assigned.get(sid)
        if pod is None:
            pod = min(range(self.n_pods), key=lambda p: (self._counts[p], p))
            self._counts[pod] += 1
            self._assigned[sid] = pod
        return pod


class MigratingAffinity(AffinityPolicy):
    """The session's home drifts one pod every ``period`` tasks (rebalancer
    moving sessions mid-episode): a resident hot set built for one home
    turns remote after a migration — the adversarial case for placement."""

    name = "migrating"

    def __init__(self, n_pods: int, period: int = 5):
        super().__init__(n_pods)
        assert period >= 1
        self.period = period

    def home(self, sid, task_index):
        return (sid + task_index // self.period) % self.n_pods


AFFINITIES = {"sticky": StickyAffinity, "round_robin": RoundRobinAffinity,
              "load_balanced": LoadBalancedAffinity,
              "migrating": MigratingAffinity}


def make_affinity(name: str, n_pods: int, **kw) -> AffinityPolicy:
    return AFFINITIES[name](n_pods, **kw)


# ---------------------------------------------------------------------------
# Locality cost model: the cross-pod read penalty
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocalityStats:
    """Consumer-side read classification. Invariant (tests): with affinity
    enabled, ``local_reads + remote_reads`` equals the router's ``routed``
    logical-access count — every consumed value is served from exactly one
    pod, home or not."""
    local_reads: int = 0
    remote_reads: int = 0
    remote_hop_s: float = 0.0     # cross-pod transfer seconds charged
    link_stall_s: float = 0.0     # FCFS waits on home-pod ingress links

    @property
    def remote_share(self) -> float:
        total = self.local_reads + self.remote_reads
        return self.remote_reads / total if total else 0.0


class LocalityModel:
    """Charges the consumer-side cost of every value a session consumes.

    ``charge`` is called once per logical access, *after* the serving path's
    base latency (cache read / DB dwell / join wait) has been charged, with
    the session clock's post-advance time. It classifies the read, records
    the replicator's consumer evidence, and returns the extra seconds the
    session must additionally wait for the cross-pod hop (0.0 when local,
    and exactly 0.0 at ``penalty == 1.0`` — the degeneracy contract).
    """

    def __init__(self, latency, penalty: float = 1.0,
                 link_queue: bool = False):
        assert penalty >= 1.0, penalty
        self.latency = latency
        self.penalty = penalty
        self.link_queue = link_queue
        self.stats = LocalityStats()
        # per-home-pod ingress link busy window (only with link_queue)
        self._link_busy: Dict[str, float] = {}
        # key -> {home pod -> remote reads since the last drain}. Only
        # populated under a penalty (it is placement evidence — at 1x a
        # consumer-pod copy buys nothing, and nothing reads the map).
        # Drained by the HotKeyReplicator's epoch when one is wired;
        # otherwise the engine sets ``demand_window_s`` and the map
        # self-drains on that sim-time window, so prompt evidence (LLM
        # admission, cache_admit) stays a recent-demand signal instead of
        # an all-time count.
        self.remote_demand: Dict[str, Dict[str, int]] = {}
        self.demand_window_s = 0.0      # 0 = drained externally
        self._last_drain = 0.0

    def hop_s(self, size_mb: float) -> float:
        """Cross-pod transfer time for one value: the read pays ``penalty``
        times the pod-local read, i.e. an extra ``(penalty - 1) x
        cache_read(size)`` on top of the base latency already charged."""
        return (self.penalty - 1.0) * self.latency.cache_read(size_mb)

    def charge(self, key: str, serving_pod: str, home_pod: Optional[str],
               size_mb: float, now: float) -> float:
        """Classify + charge one consumed value; returns extra seconds."""
        st = self.stats
        if home_pod is None or serving_pod == home_pod:
            st.local_reads += 1
            return 0.0
        st.remote_reads += 1
        hop = self.hop_s(size_mb)
        if hop <= 0.0:
            return 0.0              # penalty 1x: classification only
        if self.demand_window_s > 0.0 and \
                now - self._last_drain >= self.demand_window_s:
            # no replicator is draining the consumer evidence: window it
            # on sim time so it stays a recent-demand signal
            self.remote_demand.clear()
            while now - self._last_drain >= self.demand_window_s:
                self._last_drain += self.demand_window_s
        d = self.remote_demand.get(key)
        if d is None:
            d = self.remote_demand[key] = {}
        d[home_pod] = d.get(home_pod, 0) + 1
        wait = 0.0
        if self.link_queue:
            # the value crosses into the consumer's home pod over its
            # ingress link. Transfers are serialized in the scheduler's
            # global EXECUTION order — which equals the order the reads
            # were issued (sessions execute at the global-minimum event
            # time) — while ``now`` is the value-READY time (the caller's
            # post-base-latency clock), so a transfer never starts before
            # its value exists nor before the link frees. Ready times are
            # not globally monotone across sessions (a read issued later
            # can be ready earlier), so this is request-order FCFS, not
            # ready-time FCFS: a transfer can wait on a predecessor whose
            # value became ready after its own, by at most one base
            # read/dwell. Deterministic either way.
            busy = self._link_busy.get(home_pod, 0.0)
            start = max(now, busy)
            wait = start - now
            self._link_busy[home_pod] = start + hop
            st.link_stall_s += wait
        st.remote_hop_s += hop
        return wait + hop
