"""Cache-decision controllers: programmatic (the paper's upper bound) and
GPT-driven via prompting (the paper's contribution, Table III rows 2-4).

The two decision points are factored exactly as in the paper:
  * read  — read_cache vs load_db per required key;
  * update — new cache state after this round's loads (policy-by-prompt).

Either side can independently be "python" or "llm", reproducing the four
Table III configurations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.admission import AdmissionPolicy, FrequencySketch
from repro_torch.core.cache import DataCache
from repro_torch.core.endpoints import LLMUnavailableError
from repro_torch.core.policies import Policy
from repro_torch.core.prompts import (
    LLMParseError,
    parse_json_tail,
    read_decision_prompt,
    update_decision_prompt,
)


def _admission_tokens(admission, since=(0, 0)):
    """Prompt/completion tokens an LLM-driven admission policy has consumed
    beyond ``since`` (zeros for programmatic policies — they have no token
    counters). Lets the controllers fold GPT-admission cost into the same
    update-round accounting the runner already charges (off the critical
    path, like the paper's prompted update)."""
    pt = getattr(admission, "prompt_tokens", 0) - since[0]
    ct = getattr(admission, "completion_tokens", 0) - since[1]
    return pt, ct


def admit_loads(cache: DataCache, policy: Policy,
                admission: Optional[AdmissionPolicy],
                sketch: Optional[FrequencySketch],
                loads: Sequence[str],
                sizer: Optional[Callable[[str], int]] = None) -> List[str]:
    """Admission pre-filter for the LLM update path: drop this round's
    loads that must *bypass* (no eviction; the caller already holds the
    loaded value) before the update prompt is built, counting them in
    ``cache.stats.bypassed``. Victims are estimated against the pre-round
    cache snapshot — the same snapshot the LLM sees in its prompt. With no
    admission policy this reduces to the pre-admission new-loads filter,
    so default behavior is bit-identical to pre-admission code. ``sizer``
    (optional) supplies the candidate's byte size for cost-aware policies."""
    if admission is None:
        return [k for k in loads if k not in cache]
    kept: List[str] = []
    stats = cache.stats
    occupancy = len(cache)
    for k in loads:
        if k in cache or k in kept:
            continue
        if occupancy + len(kept) >= cache.capacity:
            victim = policy.victim(cache.entries())
            if not admission.admit(k, victim, sketch, cache.entries(),
                                   size_bytes=sizer(k) if sizer else None):
                stats.bypassed += 1
                continue
            # admitted/bypassed count only consulted (full-cache)
            # decisions, matching ProgrammaticController and the router
            stats.admitted += 1
        kept.append(k)
    return kept


@dataclasses.dataclass
class ReadPlan:
    """Per-key tool choice ("read_cache" | "load_db").

    A ReadPlan "lands" at plan time — before the planning LLM round is
    charged (see ``AgentRunner.iter_task``). Schedulers subscribe to that
    moment via the runner's ``on_plan`` hook and may start the
    :meth:`load_keys` asynchronously, overlapping DB service with the
    planning round (the concurrent engine's prefetcher does exactly this).
    """
    choices: Dict[str, str]
    prompt_tokens: int = 0
    completion_tokens: int = 0

    def load_keys(self) -> List[str]:
        """Keys this plan will acquire via ``load_db``, in plan order —
        the prefetcher's work list."""
        return [k for k, c in self.choices.items() if c == "load_db"]


class ProgrammaticController:
    """Direct Python implementation (Table III row 1 / 'upper bound').

    ``admission``/``sketch`` (both optional) add the cross-session admission
    gate: a full cache consults the policy before evicting for a new load;
    rejected keys bypass (no eviction, the value streams to the caller).
    Defaults keep the pre-admission behavior bit-identical.
    """

    kind = "python"

    def __init__(self, cache: DataCache, policy: Policy,
                 admission: Optional[AdmissionPolicy] = None,
                 sketch: Optional[FrequencySketch] = None):
        self.cache = cache
        self.policy = policy
        self.admission = admission
        self.sketch = sketch

    # -- read ---------------------------------------------------------------
    def plan_reads(self, query: str, required_keys: Sequence[str],
                   few_shot: bool = False) -> ReadPlan:
        if self.sketch is not None:
            for k in required_keys:      # every planned access is evidence
                self.sketch.touch(k)
        return ReadPlan({k: ("read_cache" if k in self.cache else "load_db")
                         for k in required_keys})

    # -- update -------------------------------------------------------------
    def update(self, loads: Sequence[str], loader: Callable[[str], Any],
               size_of: Callable[[Any], int]) -> Dict[str, int]:
        bypassed = 0
        tok0 = _admission_tokens(self.admission)
        for k in loads:
            if k in self.cache:
                continue
            victim = None
            v = None
            if len(self.cache) >= self.cache.capacity:
                victim = self.policy.victim(self.cache.entries())
                if self.admission is not None:
                    # loader is a latency-free peek; reading the value up
                    # front (for its byte size, which cost-aware admission
                    # weighs) does not change any clock or RNG stream
                    v = loader(k)
                    if not self.admission.admit(k, victim, self.sketch,
                                                self.cache.entries(),
                                                size_bytes=size_of(v)):
                        self.cache.stats.bypassed += 1
                        bypassed += 1
                        continue
                    self.cache.stats.admitted += 1
            if v is None:
                v = loader(k)
            self.cache.put(k, v, size_of(v), victim=victim)
        pt, ct = _admission_tokens(self.admission, since=tok0)
        return {"prompt_tokens": pt, "completion_tokens": ct,
                "bypassed": bypassed}


class LLMController:
    """GPT-driven cache operations: both decisions made by prompting an LLM.

    ``read_impl`` / ``update_impl`` select "llm" or "python" per decision
    point (the Table III grid). The LLM is any backend with
    ``complete(prompt) -> str`` (SimLLM offline, TorchLLM for the real served
    model).
    """

    kind = "llm"

    def __init__(self, cache: DataCache, policy: Policy, llm,
                 read_impl: str = "llm", update_impl: str = "llm",
                 few_shot: bool = True,
                 admission: Optional[AdmissionPolicy] = None,
                 sketch: Optional[FrequencySketch] = None):
        self.cache = cache
        self.policy = policy
        self.llm = llm
        self.read_impl = read_impl
        self.update_impl = update_impl
        self.few_shot = few_shot
        self.admission = admission
        self.sketch = sketch
        self._fallback = ProgrammaticController(cache, policy,
                                                admission=admission,
                                                sketch=sketch)
        # resilience fallbacks (ungraded -- there is no LLM answer to
        # grade): unparseable prompt/completion vs endpoint pool down
        self.parse_fallbacks = 0
        self.degraded = 0

    def _programmatic_plan(self, required_keys: Sequence[str],
                           prompt_tokens: int = 0,
                           completion_tokens: int = 0) -> ReadPlan:
        # inline twin of ProgrammaticController.plan_reads WITHOUT the
        # sketch touch (plan_reads already touched these keys before the
        # LLM call failed)
        return ReadPlan({k: ("read_cache" if k in self.cache else "load_db")
                         for k in required_keys},
                        prompt_tokens=prompt_tokens,
                        completion_tokens=completion_tokens)

    # -- read ---------------------------------------------------------------
    def plan_reads(self, query: str, required_keys: Sequence[str],
                   few_shot: Optional[bool] = None) -> ReadPlan:
        if self.read_impl == "python" or not required_keys:
            return self._fallback.plan_reads(query, required_keys)
        if self.sketch is not None:
            for k in required_keys:      # every planned access is evidence
                self.sketch.touch(k)
        fs = self.few_shot if few_shot is None else few_shot
        prompt = read_decision_prompt(query, required_keys,
                                      self.cache.contents_json(), fs)
        try:
            completion = self.llm.complete(prompt)
        except LLMUnavailableError:
            # endpoint pool down: degrade to the programmatic plan (the
            # router already charged the wasted retry tokens)
            self.degraded += 1
            return self._programmatic_plan(required_keys)
        except LLMParseError:
            self.parse_fallbacks += 1
            return self._programmatic_plan(required_keys,
                                           prompt_tokens=len(prompt) // 4)
        stats = self.cache.stats
        try:
            raw = parse_json_tail(completion)
        except LLMParseError:
            # garbled completion: every key falls back programmatically,
            # ungraded (there is no per-key decision to grade)
            self.parse_fallbacks += 1
            return self._programmatic_plan(
                required_keys, prompt_tokens=len(prompt) // 4,
                completion_tokens=len(completion) // 4)
        choices: Dict[str, str] = {}
        for k in required_keys:
            c = raw.get(k) if isinstance(raw, dict) else None
            if c not in ("read_cache", "load_db"):
                c = "load_db"  # malformed decision -> safe slow path
            correct = (c == "read_cache") == (k in self.cache)
            stats.llm_total_decisions += 1
            stats.llm_correct_decisions += int(correct)
            choices[k] = c
        return ReadPlan(choices,
                        prompt_tokens=len(prompt) // 4,
                        completion_tokens=len(completion) // 4)

    # -- update -------------------------------------------------------------
    def update(self, loads: Sequence[str], loader: Callable[[str], Any],
               size_of: Callable[[Any], int]) -> Dict[str, int]:
        if self.update_impl == "python":
            return self._fallback.update(loads, loader, size_of)
        before = self.cache.stats.bypassed
        tok0 = _admission_tokens(self.admission)
        new_loads = admit_loads(self.cache, self.policy, self.admission,
                                self.sketch, loads,
                                sizer=lambda k: size_of(loader(k)))
        bypassed = self.cache.stats.bypassed - before
        adm_pt, adm_ct = _admission_tokens(self.admission, since=tok0)
        if not new_loads:
            # still refresh recency metadata for reused keys
            return {"prompt_tokens": adm_pt, "completion_tokens": adm_ct,
                    "bypassed": bypassed}
        prompt = update_decision_prompt(
            self.policy.describe(), new_loads, self.cache.contents_json(),
            self.cache.capacity, self.few_shot)
        try:
            completion = self.llm.complete(prompt)
        except (LLMParseError, LLMUnavailableError) as exc:
            if isinstance(exc, LLMUnavailableError):
                self.degraded += 1
                pt = 0  # nothing served; the router billed the retries
            else:
                self.parse_fallbacks += 1
                pt = len(prompt) // 4
            self.cache.apply_state(self._expected_state(new_loads),
                                   loader, size_of)
            return {"prompt_tokens": pt + adm_pt,
                    "completion_tokens": adm_ct, "bypassed": bypassed}
        stats = self.cache.stats
        try:
            new_state = parse_json_tail(completion)
            assert isinstance(new_state, list)
            new_state = [str(k) for k in new_state]
        except (ValueError, AssertionError):
            new_state = None
        expected = self._expected_state(new_loads)
        if new_state is None:
            # unparseable completion -> programmatic fallback, ungraded
            self.parse_fallbacks += 1
            new_state = expected
        else:
            # grade the LLM's update against the programmatic policy
            stats.llm_total_decisions += 1
            stats.llm_correct_decisions += int(
                set(new_state) == set(expected))
        self.cache.apply_state(new_state, loader, size_of)
        return {"prompt_tokens": len(prompt) // 4 + adm_pt,
                "completion_tokens": len(completion) // 4 + adm_ct,
                "bypassed": bypassed}

    def _expected_state(self, new_loads: Sequence[str]) -> List[str]:
        keys = list(self.cache.keys())
        entries = dict(self.cache.entries())
        for k in new_loads:
            if k in keys:
                continue
            if len(keys) >= self.cache.capacity:
                victim = self.policy.victim(
                    {kk: entries[kk] for kk in keys if kk in entries})
                keys.remove(victim)
            keys.append(k)
        return keys


def make_controller(cache: DataCache, policy: Policy, *, llm=None,
                    read_impl: str = "python", update_impl: str = "python",
                    few_shot: bool = True, admission=None, sketch=None):
    if read_impl == "python" and update_impl == "python":
        return ProgrammaticController(cache, policy, admission=admission,
                                      sketch=sketch)
    assert llm is not None, "LLM-driven cache ops need an llm backend"
    return LLMController(cache, policy, llm, read_impl=read_impl,
                         update_impl=update_impl, few_shot=few_shot,
                         admission=admission, sketch=sketch)
