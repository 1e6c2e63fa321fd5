"""One-call assembly of the full LLM-dCache runtime: clock, datastore,
tools, cache, controller, agent — the harness every benchmark/example uses.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.agent.agent import AgentRunner, TaskTrace
from repro_torch.agent.backends import Profile, SimLLM
from repro_torch.agent.geollm.datastore import GeoDataStore
from repro_torch.agent.geollm.evaluator import Report, evaluate
from repro_torch.agent.geollm.geotools import make_geo_tools
from repro_torch.agent.geollm.simclock import SimClock
from repro_torch.agent.geollm.workload import Task, compute_gold, make_benchmark
from repro_torch.core.admission import FrequencySketch, make_admission
from repro_torch.core.cache import DataCache
from repro_torch.core.controller import make_controller
from repro_torch.core.policies import make_policy
from repro_torch.core.tools import ToolRegistry, make_admission_tool, \
    make_cache_tools


@dataclasses.dataclass
class Runtime:
    clock: SimClock
    store: GeoDataStore
    cache: DataCache
    registry: ToolRegistry
    runner: AgentRunner
    llm: SimLLM

    def run(self, tasks: List[Task]) -> List[TaskTrace]:
        return [self.runner.run_task(t) for t in tasks]

    def run_and_evaluate(self, tasks: List[Task]) -> Report:
        traces = self.run(tasks)
        return evaluate(tasks, traces, self.cache.stats)


def build_runtime(*, model: str = "gpt-4-turbo", prompting: str = "cot",
                  few_shot: bool = True, use_cache: bool = True,
                  policy: str = "lru", read_impl: str = "llm",
                  update_impl: str = "llm", capacity: int = 5,
                  seed: int = 0, llm=None, admission: Optional[str] = None,
                  admission_impl: str = "python") -> Runtime:
    """``admission`` (e.g. ``"tinylfu"``) adds the admission gate + shared
    frequency sketch to the cache controller; ``admission_impl="llm"``
    routes the decision through the GPT-driven prompt path. The default
    (``None``) is bit-identical to the pre-admission runtime — Tables I-III
    digests depend on it."""
    clock = SimClock()
    store = GeoDataStore(clock)
    cache = DataCache(capacity, clock=clock.now)
    sim = llm or SimLLM(Profile(model, prompting, few_shot), seed=seed)
    pol = make_policy(policy)
    if not use_cache:
        read_impl = update_impl = "python"
    sketch = adm = None
    if admission is not None:
        sketch = FrequencySketch(clock=clock.now)
        adm = make_admission(admission, impl=admission_impl, llm=sim,
                             few_shot=few_shot)
    controller = make_controller(cache, pol, llm=sim,
                                 read_impl=read_impl,
                                 update_impl=update_impl,
                                 few_shot=few_shot,
                                 admission=adm, sketch=sketch)
    tools = make_cache_tools(cache, store, clock) + make_geo_tools(clock)
    if adm is not None:
        tools.append(make_admission_tool(
            adm, sketch,
            entries_of=lambda key: cache.entries(),
            victim_of=lambda key, entries: pol.victim(entries),
            capacity_of=lambda key: cache.capacity))
    registry = ToolRegistry(tools)
    runner = AgentRunner(registry, controller, sim, clock, store,
                         use_cache=use_cache)
    return Runtime(clock=clock, store=store, cache=cache, registry=registry,
                   runner=runner, llm=sim)


def build_tasks(n: int, reuse_rate: float = 0.8, seed: int = 0,
                store: Optional[GeoDataStore] = None) -> List[Task]:
    if store is None:
        store = GeoDataStore(SimClock())
    return make_benchmark(n, reuse_rate, seed, store)
