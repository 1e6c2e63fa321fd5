"""The port's copy of the cache simulator against the reference, and the
served model as the cache controller's LLM.

Each simulator case runs one scenario through the reference package
(``repro``) and through the port (``repro_torch``) on the same seeds and
requires exact equality: both sides are the same numpy and Python code, so
any difference (an RNG draw out of order, a prompt off by one character) is
a fault of the copy. The last cases serve a reduced ``dcache-agent-150m`` in
fp32 as ``LLMController``'s decision model: the JAX engine behind ``JaxLLM``
and the port's engine behind ``TorchLLM`` on the CPU, on the same weights,
must give the same completions, read plans and task traces.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest

PKGS = ("repro", "repro_torch")
MODULES = ("core.prompts", "core.cache", "core.policies", "core.admission",
           "core.faults", "core.endpoints", "core.controller",
           "core.plan_cache", "core.tools", "agent.geollm.simclock",
           "agent.geollm.datastore", "agent.geollm.geotools",
           "agent.geollm.workload", "agent.geollm.evaluator",
           "agent.backends", "agent.agent", "agent.runtime", "core.profiling",
           "core.locality", "core.distributed_cache", "core.replication",
           "core.traffic", "core.coherence", "agent.concurrency")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def canon(x):
    """A comparable, package-free form of a simulator value: dataclasses
    and GeoFrames by class name and fields, arrays by dtype, shape and
    bytes, floats by repr (so NaN equals NaN and -0.0 differs from 0.0)."""
    if type(x).__name__ == "GeoFrame":
        return ("GeoFrame", x.key, len(x), tuple(canon(getattr(x, c)) for c in (
            "filename", "lon", "lat", "timestamp", "class_id", "det_count",
            "land_cover", "cloud_pct")))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple((f.name, canon(getattr(x, f.name)))
                                        for f in dataclasses.fields(x)))
    if isinstance(x, np.ndarray):
        body = x.tolist() if x.dtype == object else x.tobytes()
        return ("ndarray", str(x.dtype), x.shape, body)
    if isinstance(x, np.generic):
        return ("np", type(x).__name__, canon(x.item()))
    if isinstance(x, float):
        return ("float", repr(x))
    if isinstance(x, dict):
        return ("dict", tuple((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(map(repr, x))))
    assert x is None or isinstance(x, (str, int, bool)), type(x)
    return x


def same(scenario, *args):
    """Run ``scenario`` in both packages; return the port's result."""
    ref, port = (scenario(pkg, *args) for pkg in PKGS)
    assert canon(port) == canon(ref)
    return port


# ---------------------------------------------------------------------------
# prompts
# ---------------------------------------------------------------------------

CACHE_JSON = ('{"xview1-2022": {"access_count": 2, "insert_order": 1, '
              '"last_access": 3.1, "size_mb": 71.3}}')
TOP_JSON = '[["fair1m-2021", 7], ["xview1-2022", 3]]'
DEMAND = '{"pod1": 4, "pod3": 1}'
PROMPT_ARGS = {
    "read_decision_prompt": lambda fs: (
        "Show fair1m and xview1 imgs from 2022",
        ["xview1-2022", "fair1m-2022"], CACHE_JSON, fs),
    "update_decision_prompt": lambda fs: (
        "Least Recently Used (LRU): evict ...", ["fair1m-2022"], CACHE_JSON,
        3, fs),
    "admission_decision_prompt": lambda fs: (
        "TinyLFU: admit when strictly higher", "fair1m-2022", "xview1-2022",
        5, 2, CACHE_JSON, fs, DEMAND if fs else None),
    "replication_decision_prompt": lambda fs: (
        "replicate hot keys", "fair1m-2022", 9, fs, 6, 2, TOP_JSON, fs,
        DEMAND if fs else None),
    "recovery_decision_prompt": lambda fs: (
        "re-warm hot keys", "fair1m-2022", 4, 3, TOP_JSON, fs),
    "coherence_decision_prompt": lambda fs: (
        "serve stale within the bound", "fair1m-2022", 12.5, 30.0, 3, fs),
    "plan_cache_decision_prompt": lambda fs: (
        "cache plans whose frequency is at least 2", "detect|lcc",
        "vqa", 3, 1, 180.0, fs),
}


@pytest.mark.parametrize("few_shot", (False, True))
@pytest.mark.parametrize("prompt_fn", sorted(PROMPT_ARGS))
def test_prompt_strings(prompt_fn, few_shot):
    text = same(lambda pkg: getattr(mod(pkg, "core.prompts"), prompt_fn)(
        *PROMPT_ARGS[prompt_fn](few_shot)))
    assert len(text) > 100


@pytest.mark.parametrize("text", (
    'Thought: x\nAnswer: {"a-2020": "read_cache"}', 'noise [1, "b"] tail',
    '{"broken": ', "no json here", ' [ ] ', '{"x": [1, {"y": 2}]} junk {'))
def test_parse_json_tail(text):
    def parse(pkg):
        m = mod(pkg, "core.prompts")
        try:
            return m.parse_json_tail(text)
        except m.LLMParseError as e:
            return ("LLMParseError", str(e))
    same(parse)


# ---------------------------------------------------------------------------
# cache, policies, sketch, admission
# ---------------------------------------------------------------------------

KEYS = [f"ds{i}-20{10 + i % 7}" for i in range(11)]


def _cache_ops(pkg, policy):
    """One seeded sequence of reads and inserts through ``policy``."""
    cache_m, pol_m = mod(pkg, "core.cache"), mod(pkg, "core.policies")
    rng = np.random.default_rng(7)
    seq = [KEYS[i] for i in rng.integers(0, len(KEYS), 200)]
    pol = pol_m.make_policy(policy, **({"future": seq} if policy == "belady"
                                       else {"seed": 3} if policy == "rr" else {}))
    cache = cache_m.DataCache(4)
    evicted = []
    for i, k in enumerate(seq):
        if policy == "belady":
            pol.cursor = i + 1
        try:
            cache.get(k)
        except KeyError:
            victim = pol.victim(cache.entries()) if len(cache) >= 4 else None
            evicted.append(cache.put(k, f"v{k}", 1000 + i, victim=victim))
    return evicted, cache.stats, cache.contents_json(), pol.describe()


@pytest.mark.parametrize("policy", ("lru", "lfu", "fifo", "rr", "belady"))
def test_cache_and_policy_evictions(policy):
    evicted, stats, _, _ = same(_cache_ops, policy)
    assert len(evicted) == 200 - stats.hits and stats.evictions > 0


def _apply_state(pkg):
    cache = mod(pkg, "core.cache").DataCache(3)
    for k in KEYS[:3]:
        cache.put(k, k, 10)
    cache.apply_state([KEYS[1], KEYS[5], KEYS[5], KEYS[6], KEYS[7]],
                      lambda k: k.upper(), len)
    return cache.keys(), cache.stats, cache.contents_json()


def test_cache_apply_state():
    same(_apply_state)


def _sketch(pkg):
    sk = mod(pkg, "core.admission").FrequencySketch(width=64, depth=4,
                                                     age_period_s=5.0)
    rng = np.random.default_rng(11)
    t = 0.0
    est = []
    for i in range(400):
        t += float(rng.exponential(0.1))
        k = KEYS[min(int(rng.zipf(1.5)) - 1, len(KEYS) - 1)]
        if i % 3:
            sk.touch(k, t)
        else:
            sk.touch_many([k, KEYS[i % len(KEYS)]], t)
        if i % 50 == 49:
            est.append(sk.estimate_many(KEYS))
    return est, sk.top_k(5), sk.table, sk.ages, sk.touches


def test_frequency_sketch_estimates():
    same(_sketch)


@pytest.mark.parametrize("name", ("always", "tinylfu", "tinylfu-cost",
                                  "doorkeeper", "scan-tinylfu"))
@pytest.mark.parametrize("impl", ("python", "llm"))
def test_admission_decisions(name, impl):
    def run(pkg):
        adm_m, be = mod(pkg, "core.admission"), mod(pkg, "agent.backends")
        cache_m = mod(pkg, "core.cache")
        llm = be.SimLLM(be.Profile("gpt-3.5-turbo", "react", False), seed=5)
        adm = adm_m.make_admission(name, impl=impl, llm=llm)
        sk = adm_m.FrequencySketch(width=64, depth=4)
        cache = cache_m.DataCache(3)
        rng = np.random.default_rng(2)
        out = []
        for i in range(60):
            k = KEYS[int(rng.integers(0, len(KEYS)))]
            sk.touch(k, float(i))
            if k in cache:
                continue
            if len(cache) < 3:
                cache.put(k, k, 100)
                continue
            victim = min(cache.entries())
            ok = adm.admit(k, victim, sk, cache.entries(), size_bytes=1000 + i)
            out.append(ok)
            if ok:
                cache.put(k, k, 100, victim=victim)
        return out, adm.describe(), getattr(adm, "parse_fallbacks", None)
    same(run)


# ---------------------------------------------------------------------------
# the GeoLLM-Engine simulator: frames, workload, evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ("xview1-2022", "fair1m-2017", "sentinel2-2020"))
@pytest.mark.parametrize("rows", (None, (100, 400)))
def test_synth_frame_arrays(key, rows):
    frame = same(lambda pkg: mod(pkg, "agent.geollm.datastore").synth_frame(
        key, rows))
    assert len(frame) > 0


@pytest.mark.parametrize("n,reuse,seed", ((12, 0.8, 1), (9, 0.0, 4), (10, 0.5, 2)))
def test_make_benchmark_tasks_and_gold(n, reuse, seed):
    def run(pkg):
        ds, sc = mod(pkg, "agent.geollm.datastore"), mod(pkg, "agent.geollm.simclock")
        return mod(pkg, "agent.geollm.workload").make_benchmark(
            n, reuse, seed, ds.GeoDataStore(sc.SimClock()))
    tasks = same(run)
    assert len(tasks) == n and all(s.gold is not None for t in tasks for s in t.steps)


def test_workload_sampler_regimes():
    def run(pkg):
        w = mod(pkg, "agent.geollm.workload")
        return (w.WorkloadSampler(0.6, seed=3, repeat_p=0.4).sample(15),
                w.mutation_hot_keys(6))
    same(run)


@pytest.mark.parametrize("cfg", (
    dict(model="gpt-4-turbo", prompting="cot", few_shot=True),
    dict(model="gpt-3.5-turbo", prompting="react", few_shot=False,
         policy="lfu", read_impl="python"),
    dict(model="gpt-3.5-turbo", prompting="cot", few_shot=True,
         use_cache=False),
    dict(model="gpt-4-turbo", prompting="react", few_shot=True,
         policy="rr", admission="tinylfu", admission_impl="llm"),
))
def test_runtime_traces_and_report(cfg):
    def run(pkg):
        rt_m = mod(pkg, "agent.runtime")
        rt = rt_m.build_runtime(seed=2, **cfg)
        tasks = rt_m.build_tasks(10, reuse_rate=0.8, seed=1, store=rt.store)
        traces = rt.run(tasks)
        rep = mod(pkg, "agent.geollm.evaluator").evaluate(tasks, traces,
                                                          rt.cache.stats)
        return traces, rep, rt.cache.stats, rt.clock.now()
    same(run)


def test_evaluator_rouge():
    same(lambda pkg: [mod(pkg, "agent.geollm.evaluator").rouge_l(a, b) for a, b in (
        ("ship near the port", "a ship near port"), ("", "x"), ("a b c", "a b c"))])


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("read_impl,update_impl", (
    ("python", "python"), ("llm", "python"), ("python", "llm"), ("llm", "llm")))
@pytest.mark.parametrize("model", ("gpt-3.5-turbo", "gpt-4-turbo"))
def test_controller_plans(read_impl, update_impl, model):
    def run(pkg):
        be, ctl = mod(pkg, "agent.backends"), mod(pkg, "core.controller")
        cache = mod(pkg, "core.cache").DataCache(3)
        llm = be.SimLLM(be.Profile(model, "cot", True), seed=1)
        c = ctl.make_controller(cache, mod(pkg, "core.policies").make_policy("lru"),
                                llm=llm, read_impl=read_impl,
                                update_impl=update_impl)
        rng = np.random.default_rng(5)
        out = []
        for i in range(40):
            keys = sorted({KEYS[j] for j in rng.integers(0, 8, 2)})
            plan = c.plan_reads(f"query {i}", keys)
            loads = plan.load_keys() if hasattr(plan, "load_keys") else [
                k for k, v in plan.choices.items() if v == "load_db"]
            for k in keys:
                if plan.choices[k] == "read_cache":
                    try:
                        cache.get(k)
                    except KeyError:
                        loads.append(k)
            out.append((plan, c.update(loads, lambda k: k * 3, len),
                        cache.contents_json()))
        return out, cache.stats, type(c).__name__
    same(run)


# ---------------------------------------------------------------------------
# endpoints, fault schedules, plan cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("faults", ("straggler", "random"))
@pytest.mark.parametrize("hedge,breaker", ((False, False), (True, True)))
def test_endpoint_router_under_a_fault_plan(seed, faults, hedge, breaker):
    def run(pkg):
        ep = mod(pkg, "core.endpoints")
        names = ["ep0", "ep1", "ep2", "ep3"]
        plan = (ep.EndpointFaultPlan.outage_straggler(names, horizon_s=150.0)
                if faults == "straggler" else
                ep.EndpointFaultPlan.random_plan(names, 8, 150.0, 12.0, seed=seed))
        plan = plan + ep.EndpointFaultPlan.single("ep1", 100.0, 130.0,
                                                  kind=ep.MALFORM, value=0.5)
        r = ep.EndpointRouter(4, plan, seed=seed, hedge=hedge, breaker=breaker)
        be = mod(pkg, "agent.backends")
        routed = ep.RoutedLLM(be.SimLLM(be.Profile("gpt-4-turbo", "cot", True)), r)
        prompt = mod(pkg, "core.prompts").read_decision_prompt(
            "q", ["xview1-2022"], CACHE_JSON, False)
        out, t = [], 0.0
        for _ in range(60):
            out.append(r.plan_call(t, 2.0, 500))
            r.now = t
            try:
                out.append(routed.complete(prompt))
            except ep.LLMUnavailableError:
                out.append("degraded")
            t += 2.5
        out.append((r.retries, r.hedges, r.hedge_wins, r.malformed,
                    r.retry_tokens, r.breaker_opens, r.breaker_closes,
                    r.fallback_share, r.llm_calls))
        return out
    same(run)


def test_fault_plans_and_detectors():
    def run(pkg):
        f = mod(pkg, "core.faults")
        pods = ["pod0", "pod1", "pod2"]
        plans = [f.FaultPlan.single("pod1", 5.0, 9.0),
                 f.FaultPlan.periodic(pods, 20.0, 4.0, 3.0, 100.0),
                 f.FaultPlan.elastic("pod3", 40.0, 70.0),
                 f.FaultPlan.random_plan(pods, 5, 100.0, 6.0, seed=4),
                 f.FaultPlan.correlated(pods[:2], 30.0, 5.0)]
        retry = f.RetryPolicy()
        det = f.SimStragglerDetector()
        flags = [det.record(float(i), 1.0 + (3.0 if i % 9 == 8 else 0.01 * i))
                 for i in range(40)]
        sim = f.SimFailureInjector({8.0: "pod0", 30.0: "pod2"}, downtime_s=5.0)
        return ([p.events for p in plans], [retry.delay(a) for a in range(1, 7)],
                flags, det.stragglers, sim.plan().events,
                [sim.due(t) for t in (10.0, 31.0, 36.0)])
    same(run)


@pytest.mark.parametrize("impl", ("python", "llm"))
def test_plan_cache_hits(impl):
    def run(pkg):
        pc_m, be = mod(pkg, "core.plan_cache"), mod(pkg, "agent.backends")
        ReadPlan = mod(pkg, "core.controller").ReadPlan
        llm = be.SimLLM(be.Profile("gpt-4-turbo", "react", True), seed=9)
        pc = pc_m.make_plan_cache(impl, llm=llm, capacity=4, ttl_s=30.0,
                                  min_freq=2)
        tasks = mod(pkg, "agent.geollm.workload").WorkloadSampler(
            0.8, seed=6, repeat_p=0.6).sample(40)
        out = []
        for i, t in enumerate(tasks):
            tmpl, now = pc_m.task_template_id(t), 2.0 * i
            hit = pc.lookup(tmpl, t.required_keys, now)
            if hit is None:
                plan = ReadPlan({k: "load_db" for k in t.required_keys})
                out.append(("install", pc.install(tmpl, t.required_keys, plan, now)))
            else:
                out.append(("hit", hit))
            if i % 7 == 6:
                out.append(("write", pc.note_write(t.required_keys[0], i % 2 == 0)))
        return out, pc.stats, pc.tokens, pc.agreement
    out, stats, _, _ = same(run)
    assert stats.hits > 0 and any(tag == "hit" for tag, _ in out)


# ---------------------------------------------------------------------------
# the served model as the controller's LLM
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps a decision backend and records each prompt and completion."""

    def __init__(self, llm):
        self.llm, self.calls = llm, []

    def complete(self, prompt):
        out = self.llm.complete(prompt)
        self.calls.append((prompt, out))
        return out


def served_agent(pkg, decision_llm, n_tasks=2, seed=0):
    """The hand composition of ``build_runtime``'s parts with the served
    model making the controller's read and update decisions and ``SimLLM``
    driving the runner. Returns the read plans, the traces and the
    controller's fallback counts."""
    sc = mod(pkg, "agent.geollm.simclock")
    ds = mod(pkg, "agent.geollm.datastore")
    be = mod(pkg, "agent.backends")
    tools = mod(pkg, "core.tools")
    clock = sc.SimClock()
    store = ds.GeoDataStore(clock)
    cache = mod(pkg, "core.cache").DataCache(5, clock=clock.now)
    controller = mod(pkg, "core.controller").make_controller(
        cache, mod(pkg, "core.policies").make_policy("lru"), llm=decision_llm,
        read_impl="llm", update_impl="llm")
    plans = []
    plan_reads = controller.plan_reads

    def recorded(*a, **kw):
        plans.append(plan_reads(*a, **kw))
        return plans[-1]
    controller.plan_reads = recorded
    registry = tools.ToolRegistry(tools.make_cache_tools(cache, store, clock)
                                  + mod(pkg, "agent.geollm.geotools").make_geo_tools(clock))
    sim = be.SimLLM(be.Profile("gpt-4-turbo", "cot", True), seed=seed)
    runner = mod(pkg, "agent.agent").AgentRunner(registry, controller, sim,
                                                 clock, store)
    tasks = mod(pkg, "agent.runtime").build_tasks(n_tasks, reuse_rate=0.8,
                                                  seed=1, store=store)
    traces = [runner.run_task(t) for t in tasks]
    return plans, traces, (controller.parse_fallbacks, controller.degraded), cache.stats


@pytest.fixture(scope="module")
def served():
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
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(3),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jllm = Recorder(JaxLLM(JaxServingEngine(jcfg, jp, max_batch=4, max_len=128),
                           max_new_tokens=8))
    tllm = Recorder(TorchLLM(ServingEngine(tcfg, tp, max_batch=4, max_len=128,
                                           device="cpu"), max_new_tokens=8))
    ref = served_agent("repro", jllm)
    port = served_agent("repro_torch", tllm)
    return jllm, tllm, ref, port


def test_served_model_gives_the_jax_completions(served):
    jllm, tllm, _, _ = served
    assert len(tllm.calls) >= 2
    assert [p for p, _ in tllm.calls] == [p for p, _ in jllm.calls]
    assert [c for _, c in tllm.calls] == [c for _, c in jllm.calls]
    prompts = [p for p, _ in tllm.calls]
    assert any("Respond with a JSON object mapping each key" in p for p in prompts)
    assert any("return the NEW cache state" in p for p in prompts)


def test_served_model_gives_the_jax_plans_and_traces(served):
    _, _, ref, port = served
    assert canon(port) == canon(ref)
    plans, traces, (_, degraded), _ = port
    assert len(plans) == len(traces) == 2 and degraded == 0


def test_served_decisions_are_graded_or_fall_back(served):
    """Every served decision is either parsed and graded or counted as a
    parse fallback; none is lost."""
    _, tllm, _, port = served
    _, _, (fallbacks, _), stats = port
    assert fallbacks + stats.llm_total_decisions >= len(tllm.calls)


def test_port_modules_are_copies_of_the_reference():
    """Each module's public names are the reference's (the port adds
    ``TorchLLM`` in place of ``JaxLLM``)."""
    for name in MODULES:
        ref, port = (set(n for n in vars(mod(p, name)) if not n.startswith("__"))
                     for p in PKGS)
        if name == "agent.backends":
            ref = ref - {"JaxLLM"} | {"TorchLLM"}
        assert port == ref, name
