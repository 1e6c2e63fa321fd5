"""The port's concurrent multi-session engine against the reference.

Each case runs one scenario through the reference package (``repro``) and
through the port (``repro_torch``) on the same seeds and requires exact
equality (``test_torch_agent.canon``): both sides are the same numpy and
Python code, so any difference (an event popped out of order, an RNG draw
moved, a prompt off by one character) is a fault of the copy. The modules
are the pod-sharded router, session->pod affinity and the locality model,
the arrival processes, the mutable data plane, hot-key replication and the
engine itself over a grid that turns on one plane at a time; the four
golden LLM transcripts are rebuilt from the port's modules. The last cases
serve a reduced ``dcache-agent-150m`` in fp32 as the engine's admission and
replication decision model: ``JaxLLM`` on the JAX engine behind the
reference's engine and ``TorchLLM`` on the port's CPU engine behind the
port's, on the same weights, must give the same prompts, completions,
metrics and traces.
"""
import dataclasses
import importlib
import inspect
import json
import pathlib
import random
import textwrap
import types

import jax
import numpy as np
import pytest

from test_torch_agent import PKGS, Recorder, canon, mod, same

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
PODS = [f"pod{i}" for i in range(4)]
ZIPF_GLOBAL = {"scenario": "zipf", "scenario_kw": {"zipf_a": 1.1, "zipf_global": True}}


# ---------------------------------------------------------------------------
# pod-sharded router
# ---------------------------------------------------------------------------

def router_stream(pkg, capacity):
    """A seeded key stream through the router, one pod failed at the middle
    and restored at three quarters, a pod added near the end."""
    router = mod(pkg, "core.distributed_cache").PodLocalCacheRouter(
        list(PODS), capacity_per_pod=capacity)
    rng = random.Random(7)
    keys = [f"d{min(int(rng.paretovariate(1.2)), 40)}-20{rng.randint(10, 14)}"
            for _ in range(600)]
    owners, fetched, events = [], [], []
    for i, k in enumerate(keys):
        owners.append(router.owner(k))
        fetched.append(router.fetch(k, str.upper, len))
        if i == 300:
            victim = router.owner(k)
            events.append(("fail", victim, router.fail_pod(victim),
                           router.fail_pod(victim)))
        elif i == 450:
            events.append(("restore", router.restore_pod(events[0][1]),
                           router.restore_pod(events[0][1])))
        elif i == 520:
            router.scale_out("pod4")
            events.append(("scale_out", router.live_pods()))
    return owners, fetched, events, router.summary(), router.stats


@pytest.mark.parametrize("capacity", (3, 5))
def test_router_owners_hits_and_failover(capacity):
    owners, fetched, events, summary, stats = same(router_stream, capacity)
    assert len(set(owners)) == 5 and stats.failovers == 1
    assert 0.0 < summary["local_hit_rate"] < 1.0


def router_in_flight(pkg):
    """start_load / finish_load on the owner, a failure aborting a load."""
    router = mod(pkg, "core.distributed_cache").PodLocalCacheRouter(
        list(PODS), capacity_per_pod=2)
    recs = [router.start_load(k, k.upper(), 10 + i, issued_at=float(i),
                              completes_at=float(i) + 2.5, prefetched=i % 2 == 1)
            for i, k in enumerate(("a-2020", "b-2021", "c-2022", "d-2023"))]
    report = router.fail_pod(recs[1].pod)
    done = [router.finish_load(r.key) for r in recs if r.key in router.in_flight]
    return recs, report, done, router.summary(), router.stats


def test_router_in_flight_loads_and_failover_report():
    recs, report, done, _, _ = same(router_in_flight)
    assert report is not None and len(done) == 4 - len(report.aborted)


# ---------------------------------------------------------------------------
# session->pod affinity and the locality model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", (("sticky", {}), ("round_robin", {}),
                                     ("load_balanced", {}),
                                     ("migrating", {"period": 3})))
def test_affinity_policies(name, kw):
    def homes(pkg):
        pol = mod(pkg, "core.locality").make_affinity(name, 4, **kw)
        return [pol.home(sid, t) for sid in (5, 0, 3, 1, 7, 2, 5, 11, 0)
                for t in range(7)]
    assert len(set(same(homes))) > 1


@pytest.mark.parametrize("penalty,link_queue", ((1.0, False), (2.0, False),
                                                (3.0, True)))
def test_locality_model_classifies_and_charges(penalty, link_queue):
    def charges(pkg):
        from_sim = mod(pkg, "agent.geollm.simclock")
        loc = mod(pkg, "core.locality").LocalityModel(
            from_sim.LatencyModel(), penalty=penalty, link_queue=link_queue)
        loc.demand_window_s = 30.0 if penalty == 2.0 else 0.0
        rng = random.Random(11)
        out = [loc.charge(f"k{rng.randint(0, 6)}-2020", rng.choice(PODS),
                          rng.choice(PODS + [None]), rng.uniform(5.0, 200.0),
                          2.0 * i) for i in range(120)]
        return out, loc.stats, loc.remote_demand, loc.stats.remote_share
    out, stats, _, _ = same(charges)
    assert stats.local_reads + stats.remote_reads == 120
    assert (max(out) == 0.0) == (penalty == 1.0)


# ---------------------------------------------------------------------------
# arrival processes and the capacity helpers
# ---------------------------------------------------------------------------

TRAFFIC = {
    "closed": lambda t: t.ClosedLoopTraffic(6),
    "poisson": lambda t: t.PoissonTraffic(0.4, 120.0, seed=3),
    "diurnal": lambda t: t.DiurnalTraffic(0.4, 150.0, amplitude=0.8, seed=5),
    "mmpp": lambda t: t.MMPPTraffic(0.2, 1.2, 150.0, dwell_low_s=40.0, seed=2),
    "make_closed": lambda t: t.make_traffic("closed", 5),
}


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_traffic_schedules(name):
    def schedule(pkg):
        proc = TRAFFIC[name](mod(pkg, "core.traffic"))
        return proc.schedule(), proc.offered_rate
    sched, _ = same(schedule)
    assert sched and [a.at for a in sched] == sorted(a.at for a in sched)


def test_traffic_stats_slo_and_knee():
    def stats(pkg):
        t = mod(pkg, "core.traffic")
        ts = t.TrafficStats()
        rng = random.Random(4)
        for sid in range(20):
            at = 3.0 * sid + rng.random()
            ts.note_spawn(at, sid)
            if sid % 4:
                ts.note_retire(at + rng.uniform(5.0, 40.0), sid)
        lat = [rng.uniform(1.0, 30.0) for _ in range(50)]
        pts = [(r, 5.0 + 40.0 * r * r) for r in (0.1, 0.2, 0.4, 0.8)]
        return (ts.spawned, ts.completed, ts.in_system, ts.mean_sojourn_s(),
                ts.mean_in_system(90.0), ts.measured_rate(90.0),
                ts.little_residual(90.0), t.slo_attainment(lat, 12.0),
                t.slo_attainment([], 12.0), t.find_knee(pts, 12.0),
                t.find_knee(pts, 1.0))
    out = same(stats)
    assert out[:3] == (20, 15, 5) and out[-1] is None


# ---------------------------------------------------------------------------
# the mutable data plane
# ---------------------------------------------------------------------------

def test_mutation_plans():
    def plans(pkg):
        c = mod(pkg, "core.coherence")
        keys = ["xview1-2015", "fair1m-2019", "dota-2021"]
        return (c.MutationPlan.single("xview1-2015", 12.5).events,
                c.MutationPlan.periodic(keys, 7.0, start_s=3.0, horizon_s=60.0,
                                        kind=c.ARRIVAL).events,
                c.MutationPlan.random_plan(keys, 0.3, 100.0, seed=5,
                                           arrival_p=0.25).events,
                repr(c.MutationPlan.random_plan(keys, 0.2, 50.0, seed=1)))
    single, periodic, rnd, _ = same(plans)
    assert len(single) == 1 and periodic and rnd


COHERENCE = (("write-invalidate", "python", {}), ("write-through", "python", {}),
             ("ttl", "python", {"ttl_s": 10.0}),
             ("serve-stale", "python", {"bound_s": 15.0}),
             ("ttl", "llm", {"ttl_s": 10.0}),
             ("serve-stale", "llm", {"bound_s": 15.0}))


@pytest.mark.parametrize("policy,impl,kw", COHERENCE)
def test_coherence_policy_verdicts(policy, impl, kw):
    def verdicts(pkg):
        be = mod(pkg, "agent.backends")
        llm = (be.SimLLM(be.Profile("gpt-4-turbo", "cot", True), seed=17)
               if impl == "llm" else None)
        pol = mod(pkg, "core.coherence").make_coherence(policy, impl=impl,
                                                        llm=llm, **kw)
        rng = random.Random(9)
        out = [(pol.on_stale_read(f"k{rng.randint(0, 5)}-2020",
                                  rng.uniform(0.0, 30.0), rng.uniform(0.0, 40.0),
                                  rng.randint(0, 12)),
                pol.expired(rng.uniform(0.0, 40.0))) for _ in range(30)]
        return (out, pol.describe(), pol.invalidate_on_write,
                pol.refresh_on_write, pol.bound_s,
                getattr(pol, "agreement", None),
                getattr(pol, "parse_fallbacks", None))
    same(verdicts)


# ---------------------------------------------------------------------------
# hot-key replication
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ("python", "llm"))
def test_hot_key_replicator_epochs(impl):
    def epochs(pkg):
        adm = mod(pkg, "core.admission")
        be = mod(pkg, "agent.backends")
        rep = mod(pkg, "core.replication")
        sketch = adm.FrequencySketch(width=256, age_period_s=0)
        router = mod(pkg, "core.distributed_cache").PodLocalCacheRouter(
            list(PODS), capacity_per_pod=3, admission=adm.TinyLFU(),
            sketch=sketch)
        llm = (be.SimLLM(be.Profile("gpt-4-turbo", "cot", True), seed=3)
               if impl == "llm" else None)
        pol = rep.make_replication(impl=impl, llm=llm, promote_min=4)
        r = rep.HotKeyReplicator(router, sketch, str.upper, policy=pol,
                                 epoch_s=10.0, max_replicated=4)
        router.spill = r.offer
        rng = random.Random(3)
        log = []
        for step in range(420):
            now = 0.5 * step
            k = f"h{min(int(rng.paretovariate(1.1)), 24)}-2020"
            r.maybe_run(now)
            router.note_access(k, now)
            pod = router.locate(k, home=PODS[step % 4])
            if pod is None:
                router.start_load(k, k.upper(), 40, issued_at=now,
                                  completes_at=now + 0.25)
                rec = router.finish_load(k)
                pod = (rec.pod, rec.installed, rec.bypassed)
            log.append((k, pod))
        return (log, r.stats, r.replicated, router.replicas, router.stats,
                r.agreement, r.tokens)
    log, stats, _, _, _, _, _ = same(epochs)
    assert stats.epochs == 20 and stats.promotes > 0


# ---------------------------------------------------------------------------
# the engine, one plane at a time
# ---------------------------------------------------------------------------

def _faults(pkg):
    f = mod(pkg, "core.faults")
    return {"fault_plan": f.FaultPlan.single("pod3", 40.0, restore_at=70.0),
            "recovery_impl": "llm", "autoscale": True,
            "autoscale_kw": {"check_every_s": 15.0, "high_backlog_s": 0.5,
                             "low_backlog_s": 0.05, "max_extra": 2,
                             "cooldown_s": 30.0}}


def _mutations(pkg):
    from_w = mod(pkg, "agent.geollm.workload")
    plan = mod(pkg, "core.coherence").MutationPlan.random_plan(
        from_w.mutation_hot_keys(4), 0.2, 150.0, seed=5)
    return {"mutations": plan, "coherence": "serve-stale",
            "coherence_impl": "llm", "coherence_kw": {"bound_s": 20.0},
            "scenario": "update_heavy",
            "scenario_kw": {"hot_k": 4, "hot_p": 0.85}}


def _endpoints(pkg):
    ep = mod(pkg, "core.endpoints")
    return {"endpoint_fault_plan": ep.EndpointFaultPlan.outage_straggler(
                [f"ep{i}" for i in range(4)], horizon_s=200.0),
            "admission": "tinylfu", "admission_impl": "llm",
            "endpoint_kw": {"hedge": True, "breaker": True}}


REPL_KW = {"replication_kw": {"epoch_s": 8.0, "promote_min": 3, "miss_min": 1}}
GRID = {
    "lazy": lambda pkg: {},
    "prefetch-fixed": lambda pkg: {"prefetch": True, "prefetch_adaptive": False},
    "prefetch-adaptive": lambda pkg: {"prefetch": True},
    "admission-python": lambda pkg: {"admission": "tinylfu"},
    "admission-llm": lambda pkg: {"admission": "tinylfu", "admission_impl": "llm"},
    "replication-python": lambda pkg: {"replication": True, **REPL_KW, **ZIPF_GLOBAL},
    "replication-llm": lambda pkg: {"replication": True, "replication_impl": "llm",
                                    "admission": "tinylfu", **REPL_KW,
                                    **ZIPF_GLOBAL},
    "sticky-1x": lambda pkg: {"affinity": "sticky", "remote_read_penalty": 1.0},
    "sticky-2x-link": lambda pkg: {"affinity": "sticky", "remote_read_penalty": 2.0,
                                   "link_queue": True, "replication": True,
                                   **REPL_KW},
    "faults-recovery-llm": _faults,
    "poisson": lambda pkg: {"traffic": mod(pkg, "core.traffic").PoissonTraffic(
        0.2, 60.0, lifetime_tasks=3, seed=4)},
    "closed": lambda pkg: {"traffic": "closed"},
    "mutations-coherence-llm": _mutations,
    "endpoint-faults": _endpoints,
    "plan-cache-llm": lambda pkg: {"plan_cache": "llm",
                                   "plan_cache_kw": {"capacity": 8},
                                   "scenario": "zipf",
                                   "scenario_kw": {"zipf_a": 1.1,
                                                   "zipf_global": True,
                                                   "repeat_p": 0.6}},
}


# (sessions, tasks) where the default 6 x 5 leaves a plane idle: the plan
# cache needs repeats of one template to hit
SIZES = {"plan-cache-llm": (8, 8)}


def episode(pkg, name):
    n_sessions, tasks = SIZES.get(name, (6, 5))
    res = mod(pkg, "agent.concurrency").run_episode(
        n_sessions, tasks, n_pods=4, reuse_rate=0.5, seed=1,
        capacity_per_pod=4, **GRID[name](pkg))
    return (res.metrics, [(s.sid, s.home_pod, s.traces, s.stats)
                          for s in res.sessions],
            res.evaluate_answers(), res.router.summary(), res.router.stats,
            res.contention.pods)


@pytest.mark.parametrize("name", list(GRID))
def test_episode_equals_the_reference(name):
    m, sessions, _, _, _, _ = same(episode, name)
    assert m.n_tasks == sum(len(tr) for _, _, tr, _ in sessions) > 0


def test_episode_planes_are_live():
    """The grid's planes each move their counters (so equality above is
    not a comparison of two idle engines)."""
    row = {n: episode("repro_torch", n)[0] for n in
           ("admission-llm", "replication-llm", "sticky-2x-link",
            "faults-recovery-llm", "poisson", "mutations-coherence-llm",
            "endpoint-faults", "plan-cache-llm", "prefetch-fixed")}
    assert row["admission-llm"].admission_tokens > 0
    assert row["replication-llm"].replication_epochs > 0
    assert row["replication-llm"].replication_tokens > 0
    assert row["sticky-2x-link"].locality_remote_reads > 0
    assert row["faults-recovery-llm"].resilience_failovers == 1
    assert row["poisson"].traffic_spawned > 0
    assert row["mutations-coherence-llm"].coherence_mutations > 0
    assert row["endpoint-faults"].llm_calls > 0
    assert row["plan-cache-llm"].plancache_hits > 0
    assert row["prefetch-fixed"].prefetch_issued > 0


def test_session_seed_and_engine_exports():
    for pkg in PKGS:
        agent = importlib.import_module(f"{pkg}.agent")
        assert agent.session_seed(7, 3) == 10
        assert agent.run_episode is mod(pkg, "agent.concurrency").run_episode
    ref, port = (set(n for n in vars(importlib.import_module(f"{p}.core"))
                     if not n.startswith("_")) for p in PKGS)
    assert port == ref


def test_profiling_counters_are_the_ports_own():
    ref, port = (mod(p, "core.profiling") for p in PKGS)
    assert port.COUNTERS is not ref.COUNTERS
    p0 = port.snapshot()
    port.add("test_counter", 2.5)
    port.add("test_counter", 0.5)
    assert port.delta(p0, port.snapshot())["test_counter"] == 3.0


# ---------------------------------------------------------------------------
# the four golden transcripts, rebuilt from the port's modules
# ---------------------------------------------------------------------------

def port_builder(test_module, fn_name):
    """The reference test's transcript builder, re-bound to the port: its
    source is executed in a namespace whose ``repro`` names (module-level
    and inline imports) resolve to their ``repro_torch`` counterparts."""
    ref_mod = importlib.import_module(test_module)
    g = {}
    for k, v in vars(ref_mod).items():
        if isinstance(v, types.ModuleType):
            name = v.__name__
            g[k] = (importlib.import_module("repro_torch" + name[5:])
                    if name.split(".")[0] == "repro" else v)
            continue
        origin = getattr(v, "__module__", None) or ""
        if origin.split(".")[0] == "repro" and hasattr(v, "__qualname__"):
            g[k] = getattr(importlib.import_module("repro_torch" + origin[5:]),
                           v.__qualname__)
        else:
            g[k] = v
    src = textwrap.dedent(inspect.getsource(getattr(ref_mod, fn_name)))
    assert "repro_torch" not in src
    exec(compile(src.replace("from repro.", "from repro_torch."),
                 f"<{fn_name}>", "exec"), g)
    fn = g[fn_name]
    for n in fn.__code__.co_names:
        origin = getattr(g.get(n), "__module__", None) or ""
        assert origin.split(".")[0] != "repro", f"{n} still from {origin}"
    return fn


@pytest.mark.parametrize("name,module,builder", (
    ("admission_locality", "test_locality", "_build_admission_transcript"),
    ("replication_locality", "test_locality", "_build_replication_transcript"),
    ("recovery", "test_faults", "_build_recovery_transcript"),
    ("cache_update", "test_coherence", "_build_coherence_transcript")))
def test_golden_transcripts_from_the_port(name, module, builder):
    got = port_builder(module, builder)()
    assert got == json.loads((GOLDEN / f"{name}.json").read_text())
    assert got["agreement"] >= 0.90


# ---------------------------------------------------------------------------
# the served model as the admission and replication decision plane
# ---------------------------------------------------------------------------

def served_episode(pkg, decision_llm, n_sessions, n_tasks):
    """The chip's small concurrent episode (2 pods of capacity 2,
    zipf_global) with ``decision_llm`` behind both the admission and the
    replication plane; the sessions' runners keep their own SimLLMs."""
    eng = mod(pkg, "agent.concurrency").ConcurrentEpisodeEngine(
        n_sessions, n_pods=2, capacity_per_pod=2, seed=0, admission="tinylfu",
        admission_impl="llm", replication=True, replication_impl="llm",
        **ZIPF_GLOBAL)
    eng.admission_policy.llm = decision_llm
    eng.replicator.policy.llm = decision_llm
    res = eng.run(n_tasks, reuse_rate=0.8)
    return (res.metrics.row(), [(s.sid, s.traces) for s in res.sessions],
            (eng.admission_policy.parse_fallbacks,
             eng.replicator.policy.parse_fallbacks,
             eng.admission_policy.degraded, eng.replicator.policy.degraded))


@pytest.fixture(scope="module")
def engines():
    """Reduced dcache-agent-150m at fp32, JAX-initialised, in both engines."""
    from repro.agent.backends import JaxLLM
    from repro.configs import get_config as jax_get_config
    from repro.models import Init, init_model as jax_init_model, unbox
    from repro.serving import ServingEngine as JaxServingEngine
    from repro_torch.agent import TorchLLM
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine

    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               vocab_size=512, dtype="float32")
    tcfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                               vocab_size=512, dtype="float32")
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(5),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (JaxLLM(JaxServingEngine(jcfg, jp, max_batch=4, max_len=128),
                   max_new_tokens=8),
            TorchLLM(ServingEngine(tcfg, tp, max_batch=4, max_len=128,
                                   device="cpu"), max_new_tokens=8))


# (sessions, tasks): the chip's phase-4 episode (11 admission and 1
# replication decision under SimLLM; none of replication once the served
# model's fallbacks change what contends) and one that reaches the
# replication plane under fallbacks too
EPISODES = ((2, 2), (3, 2))


@pytest.fixture(scope="module", params=EPISODES, ids=lambda e: "x".join(map(str, e)))
def served(request, engines):
    """Each package's concurrent engine with its own package's served model
    behind the admission and replication planes."""
    jllm, tllm = (Recorder(llm) for llm in engines)
    return (jllm, tllm, served_episode("repro", jllm, *request.param),
            served_episode("repro_torch", tllm, *request.param))


def test_served_decision_plane_gives_the_jax_completions(served):
    jllm, tllm, _, _ = served
    assert tllm.calls
    assert [p for p, _ in tllm.calls] == [p for p, _ in jllm.calls]
    assert [c for _, c in tllm.calls] == [c for _, c in jllm.calls]
    assert any("cache admission controller" in p for p, _ in tllm.calls)


def test_served_decision_plane_gives_the_jax_metrics_and_traces(served):
    _, tllm, ref, port = served
    assert canon(port) == canon(ref)
    row, _, (adm_fb, rep_fb, adm_deg, rep_deg) = port
    assert adm_deg == rep_deg == 0
    assert adm_fb + rep_fb <= len(tllm.calls) and row["n_tasks"] > 0


def test_served_model_reaches_the_replication_plane(engines):
    """Under the served model the (3, 2) episode also asks the replication
    plane (the (2, 2) one does not once admission falls back)."""
    _, tllm = engines
    llm = Recorder(tllm)
    served_episode("repro_torch", llm, 3, 2)
    assert any("cache REPLICATION controller" in p for p, _ in llm.calls)
