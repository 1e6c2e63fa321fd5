"""Cache operations as callable API tools (the paper's key design choice).

``read_cache`` / ``load_db`` are ordinary :class:`ToolSpec` entries exposed
in the function-calling schema *alongside every other platform tool*, so the
LLM plans cache usage exactly the way it plans any tool call, and a cache
miss is just a failed tool call it re-plans around.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class ToolSpec:
    name: str
    description: str
    parameters: Dict[str, Any]          # JSON-schema properties
    fn: Callable[..., Any]
    latency_s: float = 0.0              # modeled execution latency (SimClock)

    def schema(self) -> Dict[str, Any]:
        """OpenAI-style function-calling schema entry."""
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": {"type": "object", "properties": self.parameters,
                               "required": list(self.parameters)},
            },
        }


@dataclasses.dataclass
class ToolResult:
    name: str
    ok: bool
    value: Any = None
    error: str = ""
    latency_s: float = 0.0


class ToolError(Exception):
    pass


def make_cache_tools(cache, datastore, clock) -> List[ToolSpec]:
    """The two dCache tools. ``datastore`` is "main memory" (5-10x slower,
    paper §IV); ``clock`` is the SimClock that accumulates modeled latency."""

    def read_cache(key: str):
        t0 = clock.now()
        value = cache.get(key)          # raises KeyError on miss
        clock.advance(datastore.cache_read_latency(key))
        return value

    def load_db(key: str):
        value = datastore.load(key)     # advances clock by DB latency itself
        return value

    return [
        ToolSpec(
            name="read_cache",
            description=("Read imagery metadata for a `dataset-year` key "
                         "from the LOCAL CACHE. Fast (local). Fails if the "
                         "key is not currently cached."),
            parameters={"key": {"type": "string",
                                "description": "dataset-year, e.g. xview1-2022"}},
            fn=read_cache),
        ToolSpec(
            name="load_db",
            description=("Load imagery metadata for a `dataset-year` key "
                         "from the REMOTE DATABASE. Slow (network + storage)."),
            parameters={"key": {"type": "string",
                                "description": "dataset-year, e.g. xview1-2022"}},
            fn=load_db),
    ]


def make_admission_tool(admission, sketch, entries_of, victim_of,
                        capacity_of, locality=None) -> ToolSpec:
    """Admission as a callable cache op: ``cache_admit(key)`` answers
    whether a freshly loaded ``key`` would be installed or bypassed, with
    the evidence (victim + sketch estimates) the decision is based on.

    Exposed in the same function-calling schema as ``read_cache`` /
    ``load_db`` so the agent — or the GPT-driven controller — can query the
    admission verdict like any other tool. ``entries_of(key)`` returns the
    owning cache's entries, ``victim_of(key, entries)`` the would-be
    eviction victim, ``capacity_of(key)`` the owning cache's capacity;
    factoring these out lets the single-cache runtime and the pod-sharded
    router share one implementation. With a ``locality`` model wired
    (session->pod affinity), the verdict additionally reports the key's
    remote consumer demand by home pod — the evidence the locality-aware
    prompt path reasons over.
    """

    def cache_admit(key: str):
        entries = entries_of(key)
        kf = sketch.estimate(key) if sketch is not None else 0
        out = {"key": key, "decision": "admit", "victim": None,
               "key_freq": kf, "victim_freq": 0, "reason": "cache not full"}
        if len(entries) >= capacity_of(key):
            victim = victim_of(key, entries)
            ok = admission.admit(key, victim, sketch, entries)
            vf = sketch.estimate(victim) if sketch is not None else 0
            out.update(decision="admit" if ok else "bypass", victim=victim,
                       victim_freq=vf, reason=admission.name)
        if locality is not None and locality.penalty > 1.0:
            # only under a penalty — at 1x nothing populates the map (the
            # same gate every other locality surface uses)
            out["remote_demand"] = dict(locality.remote_demand.get(key, {}))
        return out

    return ToolSpec(
        name="cache_admit",
        description=("Ask the cache ADMISSION policy whether loading "
                     "`dataset-year` from the database would install it "
                     "into the cache (evicting the named victim) or bypass "
                     "the cache entirely (data streams through, residents "
                     "untouched)."),
        parameters={"key": {"type": "string",
                            "description": "dataset-year, e.g. xview1-2022"}},
        fn=cache_admit)


def make_replication_tool(replicator) -> ToolSpec:
    """Hot-key replication as a callable cache op: ``cache_replicate(key)``
    answers whether the replication policy would REPLICATE the key to every
    pod, DROP its existing replicas, or HOLD the current placement — with
    the evidence (sketch estimate, thresholds, current replica state) the
    decision is based on.

    Exposed in the same function-calling schema as ``read_cache`` /
    ``load_db`` / ``cache_admit`` so the agent — or the GPT-driven
    controller — can query the placement verdict like any other tool (the
    paper's cache-ops-as-tools design extended to placement). Querying is
    side-effect-free: actual promotion/demotion happens on the
    replicator's epoch, and the sketch is read without interning (a
    queried-but-never-accessed key must not join the top-k candidate
    population). The verdict is always the programmatic base rule — a
    diagnostic probe must not consume LLM tokens or grading samples."""

    def cache_replicate(key: str):
        pol = replicator.policy
        base = getattr(pol, "base", pol)     # LLM wrapper: probe the rule
        freq = replicator.sketch.estimate_peek(key)
        replicated = key in replicator.replicated
        decision = base.decide(key, freq, replicated)
        out = {"key": key, "decision": decision, "key_freq": freq,
               "replicated": replicated,
               "promote_min": pol.promote_min,
               "demote_min": pol.demote_min,
               "reason": pol.name}
        locality = getattr(replicator.router, "locality", None)
        if locality is not None and locality.penalty > 1.0:
            # under a cross-pod penalty, the verdict surfaces WHO is
            # paying hops for this key — the placement evidence
            out["remote_demand"] = dict(
                locality.remote_demand.get(key, {}))
        return out

    return ToolSpec(
        name="cache_replicate",
        description=("Ask the hot-key REPLICATION policy whether "
                     "`dataset-year` should be replicated to every pod "
                     "(converting remote joins into local hits at the cost "
                     "of cache capacity), have its replicas dropped, or "
                     "keep its current placement."),
        parameters={"key": {"type": "string",
                            "description": "dataset-year, e.g. xview1-2022"}},
        fn=cache_replicate)


def make_recovery_tool(recovery, sketch) -> ToolSpec:
    """Post-failover recovery as a callable cache op: ``cache_recover(key)``
    answers whether the recovery policy would RE-WARM the key now (one
    background DB load onto its new rendezvous owner) or refill it LAZILY
    on the next demand access — with the evidence (sketch estimate,
    re-warm threshold) the decision is based on.

    Exposed in the same function-calling schema as ``read_cache`` /
    ``load_db`` / ``cache_admit`` / ``cache_replicate`` (the paper's
    cache-ops-as-tools design extended to failover handling). Querying is
    side-effect-free: actual re-warms happen in the fault runtime's
    failover handler, and the sketch is read without interning. The
    verdict is always the programmatic base rule — a diagnostic probe
    must not consume LLM tokens or grading samples."""

    def cache_recover(key: str):
        base = getattr(recovery, "base", recovery)   # LLM wrapper: the rule
        freq = (int(sketch.estimate_peek(key)) if sketch is not None else 0)
        return {"key": key, "decision": base.decide(key, freq),
                "key_freq": freq, "rewarm_min": base.rewarm_min,
                "reason": recovery.name}

    return ToolSpec(
        name="cache_recover",
        description=("Ask the failover RECOVERY policy whether a "
                     "`dataset-year` key lost in a pod failure should be "
                     "re-warmed now (one background database load onto its "
                     "new owner pod) or refilled lazily by the next demand "
                     "access."),
        parameters={"key": {"type": "string",
                            "description": "dataset-year, e.g. xview1-2022"}},
        fn=cache_recover)


def make_coherence_tool(runtime, sketch) -> ToolSpec:
    """Cache coherence as a callable cache op: ``cache_update(key)``
    answers what the coherence policy would do with the key's cached copy
    RIGHT NOW — fresh (versions match), refresh (reload before consuming)
    or serve_stale (the lagging copy is within the declared bound) — with
    the evidence (current datastore version, the copy's version, its
    staleness, the bound) the decision is based on.

    This is the paper's *cache update* op surfaced as a tool (the read op
    is one too). Exposed in the same function-calling schema
    as ``read_cache`` / ``load_db`` / ``cache_admit`` /
    ``cache_replicate`` / ``cache_recover``. Querying is side-effect-free:
    real verdicts happen at the consume checkpoint inside the engine's
    read path, and the probe always answers with the programmatic base
    rule — a diagnostic must not consume LLM tokens or grading samples."""

    def cache_update(key: str):
        current = runtime.current_version(key)
        pol = runtime.policy
        base = getattr(pol, "base", pol)     # LLM wrapper: probe the rule
        out = {"key": key, "version": current, "copy_version": None,
               "decision": "fresh", "staleness_s": 0.0,
               "bound_s": base.bound_s, "reason": base.name}
        placed = runtime.router.locate(key)
        if placed is None:
            out["reason"] = f"{base.name} (no cached copy)"
            return out
        entry = runtime.router.pods[placed].entry(key)
        out["copy_version"] = entry.version
        if entry.version >= current:
            return out
        now = runtime.clock_now()
        freq = (int(sketch.estimate_peek(key)) if sketch is not None else 0)
        staleness = runtime.staleness_of(key, entry.version, now)
        # the engine enforces TTL on staleness, which lower-bounds age
        # (the missed write postdates the install) — same contract, no
        # dependence on the pod caches' tick-order recency clock
        decision = base.on_stale_read(key, staleness, staleness, freq)
        if decision == "serve_stale" and staleness > base.bound_s:
            decision = "refresh"             # the engine's hard clamp
        out.update(decision=decision, staleness_s=round(staleness, 6))
        return out

    return ToolSpec(
        name="cache_update",
        description=("Ask the cache COHERENCE policy what to do with the "
                     "cached copy of a `dataset-year` key whose data may "
                     "have been updated in the database since it was "
                     "cached: serve it as-is (fresh or stale-within-bound) "
                     "or refresh it from the database before use."),
        parameters={"key": {"type": "string",
                            "description": "dataset-year, e.g. xview1-2022"}},
        fn=cache_update)


def make_plan_cache_tool(plan_cache) -> ToolSpec:
    """The plan-cache tier as a callable cache op: ``cache_plan(key)``
    answers whether a fresh plan whose context covers `dataset-year` would
    currently be CACHED or BYPASSED by the plan-cache admission policy —
    with the evidence (the key's covering entries, the cache's occupancy,
    the LRU victim's plan frequency) the decision is based on.

    Exposed in the same function-calling schema as ``read_cache`` /
    ``load_db`` / ``cache_admit`` / ``cache_replicate`` / ``cache_recover``
    / ``cache_update`` (the paper's cache-ops-as-tools design extended to
    the decision plane). Querying is side-effect-free: real admissions
    happen on the install path after a planning round, the plan-key sketch
    is read without interning, and the probe always answers with the
    programmatic base rule — a diagnostic must not consume LLM tokens or
    grading samples."""

    def cache_plan(key: str):
        pol = plan_cache.policy
        base = getattr(pol, "base", pol)     # LLM wrapper: probe the rule
        covered = plan_cache.covered_entries(key)
        out = {"key": key, "decision": "cache",
               "covered_plans": ["|".join(ck) for ck in covered],
               "entries": len(plan_cache.entries),
               "capacity": plan_cache.capacity,
               "victim": None, "victim_freq": 0,
               "ttl_s": base.ttl_s, "min_freq": base.min_freq,
               "reason": "plan cache not full"}
        if len(plan_cache.entries) >= plan_cache.capacity:
            victim_ck = next(iter(plan_cache.entries))
            vf = int(plan_cache.sketch.estimate_peek("|".join(victim_ck)))
            # probe verdict for a typical repeat (frequency = min_freq):
            # would a plan exactly at the floor displace the LRU victim?
            ok = base.admit(base.min_freq, vf)
            out.update(decision="cache" if ok else "bypass",
                       victim="|".join(victim_ck), victim_freq=vf,
                       reason=base.name)
        return out

    return ToolSpec(
        name="cache_plan",
        description=("Ask the PLAN-CACHE admission policy whether a fresh "
                     "planning round over a context covering `dataset-year` "
                     "would currently be cached (evicting the named victim "
                     "plan when full) or bypassed, and which cached plans "
                     "already cover the key."),
        parameters={"key": {"type": "string",
                            "description": "dataset-year, e.g. xview1-2022"}},
        fn=cache_plan)


class ToolRegistry:
    """Function-calling registry: schemas for the prompt, dispatch at runtime."""

    def __init__(self, tools: Optional[List[ToolSpec]] = None):
        self._tools: Dict[str, ToolSpec] = {}
        for t in tools or []:
            self.register(t)

    def register(self, tool: ToolSpec):
        if tool.name in self._tools:
            raise ValueError(f"duplicate tool {tool.name}")
        self._tools[tool.name] = tool

    def names(self) -> List[str]:
        return sorted(self._tools)

    def schemas(self) -> List[Dict[str, Any]]:
        return [self._tools[n].schema() for n in self.names()]

    def __contains__(self, name: str) -> bool:
        return name in self._tools

    def get(self, name: str) -> ToolSpec:
        return self._tools[name]

    def call(self, name: str, clock=None, **kwargs) -> ToolResult:
        # dispatch is the engine's innermost loop (every tool call of every
        # session goes through here): one dict lookup, no wall-clock timing
        # — latency accounting is *modeled* (SimClock), and ToolResult's
        # latency_s field reports the modeled charge
        spec = self._tools.get(name)
        if spec is None:
            return ToolResult(name=name, ok=False,
                              error=f"unknown tool {name!r}; available: "
                                    f"{self.names()}")
        if clock is not None and spec.latency_s:
            clock.advance(spec.latency_s)
        try:
            return ToolResult(name=name, ok=True, value=spec.fn(**kwargs),
                              latency_s=spec.latency_s)
        except (ToolError, KeyError, ValueError) as e:
            return ToolResult(name=name, ok=False, error=str(e),
                              latency_s=spec.latency_s)
