"""Tool-augmented agent loop (CoT / ReAct, zero- and few-shot).

Execution pattern per task:
  1. read planning — the cache controller plans read_cache vs load_db per
     required key *up front* (the decision rides the planning round, paper:
     "seamlessly integrating with existing function-calling mechanisms");
     the :attr:`AgentRunner.on_plan` hook fires here, which is where the
     concurrent engine's async prefetcher overlaps pod loads with the
     planning round (docs/architecture.md);
  2. planning LLM round(s) — CoT plans once; ReAct interleaves a round per
     tool call (token/latency accounting follows the prompting style);
  3. data acquisition — executes the read plan; a cache MISS is a failed
     tool call that triggers a re-plan round (paper: the LLM "reassesses
     its tool sequence");
  4. step execution over the tool registry with the SimLLM's calibrated
     tool-error injections (erroneous call -> error result -> retry);
  5. cache update — prompt-driven (LLM) or programmatic, per controller;
  6. final answer round.

The loop is written as a generator (:meth:`AgentRunner.iter_task`) that
yields control after every simulated-clock advance (LLM round, tool call,
pod load), so a discrete-event scheduler can interleave many sessions with
*exact* global time ordering. :meth:`AgentRunner.run_task` simply drains
the generator — the single-session path is bit-identical to the plain loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.agent.backends import SimLLM
from repro_torch.agent.geollm import geotools
from repro_torch.agent.geollm.workload import Step, Task, _frame_var
from repro_torch.core.controller import (LLMController, ProgrammaticController,
                                   ReadPlan)
from repro_torch.core.plan_cache import task_template_id
from repro_torch.core.tools import ToolRegistry

# token-accounting constants (calibrated to Table I "Avg Tokens/Task").
# CoT: one planning round over the whole task; ReAct: one thought/action
# round per step.
PLAN_PROMPT_TOKENS = {"cot": 11_000, "react": 5_500}
PLAN_PROMPT_TOKENS_FS = {"cot": 13_500, "react": 7_200}
PLAN_COMPLETION_TOKENS = {"cot": 260, "react": 55}
STEP_SUMMARY_TOKENS = 1_500
FINAL_PROMPT_TOKENS = 4_500
FINAL_COMPLETION_TOKENS = 150
BAD_CALL_TOKENS = 150          # error round-trip folded into the same round


@dataclasses.dataclass
class TaskTrace:
    tid: int
    success: bool
    time_s: float
    tokens: int
    tool_calls: int
    bad_calls: int
    cache_miss_replans: int
    answers: Dict[int, Any]       # step index -> produced answer
    # loads this task streamed through the cache uninstalled (admission
    # bypass); always 0 without an admission policy
    cache_bypasses: int = 0
    # fault accounting (filled by the concurrent engine's fault layer;
    # always zero without a FaultPlan): retry cycles this task's aborted
    # loads went through, the extra wait they charged, loads that fell
    # back to direct DB reads after exhausting the retry budget, and
    # service seconds wasted on pods that died mid-load
    retried_loads: int = 0
    retry_wait_s: float = 0.0
    timeout_loads: int = 0
    lost_work_s: float = 0.0
    # LLM decision-plane accounting (filled by the concurrent engine's
    # endpoint router; always zero without an EndpointFaultPlan): planning
    # rounds retried against another endpoint, hedged rounds and how many
    # the hedge won, and the wait seconds spent on detection/backoff
    llm_retries: int = 0
    llm_hedges: int = 0
    llm_hedge_wins: int = 0
    llm_retry_wait_s: float = 0.0
    # plan-cache tier (always zero without a PlanCache): planning rounds
    # this task skipped because a stored plan was served verbatim
    plancache_hits: int = 0


class AgentRunner:
    """Drives one agent session.

    ``on_plan`` is the plan-time hook: called as ``on_plan(task, plan)`` the
    moment the :class:`~repro_torch.core.controller.ReadPlan` lands — *before* the
    planning LLM round is charged — so a scheduler can issue asynchronous
    pod loads that overlap the round's latency (the concurrent engine's
    prefetcher). ``None`` (the default) keeps the plain lazy-loading path.
    """

    def __init__(self, registry: ToolRegistry, controller, llm: SimLLM,
                 clock, datastore, use_cache: bool = True,
                 on_plan: Optional[Callable[[Task, Any], None]] = None,
                 endpoints=None, plan_cache=None):
        self.registry = registry
        self.controller = controller
        self.llm = llm
        self.clock = clock
        self.store = datastore
        self.use_cache = use_cache
        self.on_plan = on_plan
        # optional shared PlanCache: consult before planning; a
        # hit serves the stored read plan verbatim and skips the planning
        # round (zero plan tokens, no endpoint exposure). None = off, the
        # planning path is byte-identical to the pre-plan-cache engine.
        self.plan_cache = plan_cache
        # optional EndpointRouter: planning rounds route across the
        # simulated GPT endpoint pool and pay retry/hedge latency on this
        # session's clock. Cumulative counters; the engine snapshots them
        # around each task to fill the TaskTrace llm_* fields.
        self.endpoints = endpoints
        self.llm_retries = 0
        self.llm_hedges = 0
        self.llm_hedge_wins = 0
        self.llm_retry_wait_s = 0.0

    # -- latency/token helpers ------------------------------------------------
    def _llm_round(self, prompt_tokens: int, completion_tokens: int) -> int:
        nominal = self.clock.latency.llm_round(prompt_tokens,
                                               completion_tokens)
        self.clock.advance(nominal)
        ep = self.endpoints
        if ep is not None:
            # in-round token additions (miss re-plans, the _acquire prefill
            # ride-along) stay direct clock advances: they are part of this
            # round, not separate endpoint requests
            extra, retries, hedges, wins, wait_s = ep.plan_call(
                self.clock.now(), nominal, prompt_tokens + completion_tokens)
            if extra:
                self.clock.advance(extra)
            self.llm_retries += retries
            self.llm_hedges += hedges
            self.llm_hedge_wins += wins
            self.llm_retry_wait_s += wait_s
        return prompt_tokens + completion_tokens

    # -- acquisition ----------------------------------------------------------
    def _acquire(self, task: Task, env: Dict[str, Any], trace: TaskTrace,
                 plan):
        """Generator: executes the read plan, yielding after every clock
        advance. Returns the list of keys acquired via ``load_db``."""
        keys = task.required_keys
        loads: List[str] = []
        if not self.use_cache:
            for k in keys:
                res = self.registry.call("load_db", clock=self.clock, key=k)
                assert res.ok, res.error
                env[_frame_var(k)] = res.value
                trace.tool_calls += 1
                yield
            return loads

        if isinstance(self.controller, LLMController) and plan.prompt_tokens:
            # the read decision rides the existing planning round (paper:
            # "seamlessly integrating with existing function-calling
            # mechanisms with minimal overhead"): the prompt grows by the
            # cache-contents block (prefill time) while the Action line the
            # agent emits anyway simply names read_cache vs load_db (~a few
            # extra decode tokens, already part of the plan completion)
            lat = self.clock.latency
            self.clock.advance(
                plan.prompt_tokens * lat.llm_prefill_s_per_tok
                + 5 * lat.llm_decode_s_per_tok)
            trace.tokens += plan.prompt_tokens + plan.completion_tokens
            yield
        for k in keys:
            choice = plan.choices[k]
            res = self.registry.call(choice, clock=self.clock, key=k)
            trace.tool_calls += 1
            yield
            if not res.ok:
                # cache miss (or bad decision): the failed call's error
                # message returns in-round; the LLM corrects its tool choice
                # in the same round (token time, no extra round-trip)
                trace.bad_calls += 1
                trace.cache_miss_replans += 1
                lat = self.clock.latency
                self.clock.advance(900 * lat.llm_prefill_s_per_tok
                                   + 25 * lat.llm_decode_s_per_tok)
                trace.tokens += 925
                yield
                res = self.registry.call("load_db", clock=self.clock, key=k)
                trace.tool_calls += 1
                assert res.ok, res.error
                yield
            if choice == "load_db" or not res.ok:
                loads.append(k)
            env[_frame_var(k)] = res.value
        # reused keys refresh recency even when read via cache
        return loads

    # -- step execution ---------------------------------------------------------
    def _run_step(self, step: Step, env: Dict[str, Any], trace: TaskTrace,
                  react: bool, prompt_tokens: int):
        """Generator: executes one step's tool plan, yielding after every
        clock advance. Returns the step's answer value."""
        local = dict(env)
        answer = None
        if react:  # one thought/action round per step
            trace.tokens += self._llm_round(
                prompt_tokens, PLAN_COMPLETION_TOKENS["react"])
            yield
        for call in step.plan:
            # erroneous attempts (hallucinated tool / bad args) precede the
            # correct call; the error round-trip is folded into the round
            for _ in range(self.llm.draw_bad_calls()):
                trace.tool_calls += 1
                trace.bad_calls += 1
                self.registry.call(call.name + "_v2", clock=self.clock)
                trace.tokens += BAD_CALL_TOKENS
            args = {k: (local[v[1:]] if isinstance(v, str)
                        and v.startswith("$") else v)
                    for k, v in call.args.items()}
            res = self.registry.call(call.name, clock=self.clock, **args)
            trace.tool_calls += 1
            yield
            if not res.ok:
                trace.bad_calls += 1
                continue
            if call.out:
                local[call.out] = res.value
            if call.out == "answer":
                answer = res.value
        return answer

    # -- full task ----------------------------------------------------------
    def iter_task(self, task: Task):
        """Run one task as a generator yielding after every clock advance.

        The yields are the discrete-event scheduler's interleave points: a
        session is resumed only while its clock is the global minimum, so
        every shared-state operation between two yields (cache read/install,
        pod-load arbitration, read-plan decision) executes in exact global
        time order. The generator's return value (via ``StopIteration``) is
        the finished :class:`TaskTrace`.
        """
        t0 = self.clock.now()
        trace = TaskTrace(tid=task.tid, success=True, time_s=0.0, tokens=0,
                          tool_calls=0, bad_calls=0, cache_miss_replans=0,
                          answers={})
        prof = self.llm.profile
        react = prof.prompting == "react"
        plan_tokens = (PLAN_PROMPT_TOKENS_FS if prof.few_shot
                       else PLAN_PROMPT_TOKENS)[prof.prompting]

        # read planning happens up front (it rides the planning round): the
        # decisions are fixed here, but their latency/token accounting stays
        # where it always was (inside _acquire), so single-session traces
        # are unchanged. The on_plan hook lets a scheduler start the planned
        # loads NOW, overlapping them with the planning round below.
        plan = None
        plan_hit = False
        # the tier caches the up-front CoT planning round; ReAct has no
        # discrete planning round to skip (read decisions ride the per-step
        # thought/action rounds), so the cache would be pure lookup cost —
        # ReAct profiles bypass it entirely
        pc = self.plan_cache if not react else None
        if self.use_cache:
            if pc is not None:
                # plan-cache consult: one pod-local metadata read, charged
                # on hit AND miss (the lookup itself is never free)
                self.clock.advance(self.clock.latency.cache_read(0.0))
                cached = pc.lookup(task_template_id(task),
                                   task.required_keys, self.clock.now())
                yield
                if cached is not None:
                    plan = cached
                    plan_hit = True
                    trace.plancache_hits += 1
                    # replay correctness (mnimi's warning): the skipped
                    # planning round would have consumed eps draws from the
                    # shared decision RNG — burn the same draws so every
                    # later draw in the episode lands exactly where a
                    # forced-miss replay would put it
                    burn = getattr(self.controller, "consume_plan_noise",
                                   None)
                    if burn is not None:
                        burn(task.required_keys)
            if plan is None:
                plan = self.controller.plan_reads(task.query,
                                                  task.required_keys)
                if pc is not None:
                    # install a token-zeroed copy: a future hit serves the
                    # choices verbatim but charges zero plan tokens (and,
                    # for an LLMController, no prompt ride-along either)
                    pc.install(task_template_id(task), task.required_keys,
                               ReadPlan(dict(plan.choices)),
                               self.clock.now())
            if self.on_plan is not None:
                self.on_plan(task, plan)

        if not react and not plan_hit:
            # CoT: single planning round over the full task — skipped
            # entirely on a plan-cache hit (zero plan tokens, no endpoint
            # latency, no retry/hedge exposure)
            trace.tokens += self._llm_round(
                plan_tokens + STEP_SUMMARY_TOKENS * len(task.steps),
                PLAN_COMPLETION_TOKENS["cot"])
            yield

        env: Dict[str, Any] = {}
        loads = yield from self._acquire(task, env, trace, plan)

        task_failed = self.llm.draw_task_failure()
        for i, step in enumerate(task.steps):
            ans = yield from self._run_step(env=env, step=step, trace=trace,
                                            react=react,
                                            prompt_tokens=plan_tokens)
            if self.llm.draw_step_corruption(step.kind):
                ans = _corrupt(ans, self.llm)
            trace.answers[i] = ans
        if task_failed and task.steps:
            # the failing tasks resolve to a wrong/incomplete final answer
            trace.answers[len(task.steps) - 1] = None

        # cache update (prompt-driven when controller is LLM). The update
        # query runs OFF the critical path — after the user response, like
        # the paper's post-round bookkeeping (Table III shows ~0 latency
        # delta between GPT-driven and programmatic updates) — so it costs
        # tokens but not user-perceived latency.
        if self.use_cache and loads:
            def loader(k):
                return self.store.peek(k)
            upd = self.controller.update(loads, loader,
                                         lambda v: v.size_bytes)
            if isinstance(upd, dict) and upd.get("prompt_tokens"):
                trace.tokens += (upd["prompt_tokens"]
                                 + upd["completion_tokens"])
            if isinstance(upd, dict):
                trace.cache_bypasses = upd.get("bypassed", 0)

        # final answer round
        trace.tokens += self._llm_round(FINAL_PROMPT_TOKENS,
                                        FINAL_COMPLETION_TOKENS)
        trace.time_s = self.clock.now() - t0
        trace.success = not task_failed
        yield
        return trace

    def run_task(self, task: Task) -> TaskTrace:
        """Synchronous execution: drain :meth:`iter_task` to completion."""
        gen = self.iter_task(task)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value


def _corrupt(ans: Any, llm: SimLLM):
    """Deterministic answer corruption for failed steps."""
    r = llm.rng
    if isinstance(ans, dict) and "detections" in ans:
        out = dict(ans)
        out["detections"] = int(ans["detections"] * r.uniform(0.2, 0.8))
        out["images"] = int(ans["images"] * r.uniform(0.2, 0.8))
        return out
    if isinstance(ans, list) and ans and isinstance(ans[0], str):
        return list(reversed(ans))
    if isinstance(ans, str):
        words = ans.split()
        r.shuffle(words)
        return " ".join(words[: max(len(words) // 2, 1)])
    if isinstance(ans, int):
        return int(ans * r.uniform(0.2, 0.8))
    if isinstance(ans, list):
        return [int(x * r.uniform(0.2, 0.8)) if isinstance(x, int) else x
                for x in ans]
    return None
