"""LLM decision-model backends.

``SimLLM`` is the offline stand-in for the paper's GPT endpoints: a
deterministic, seeded simulator whose (a) cache-operation decisions are
produced by actually *parsing the same prompts* the paper would send to GPT,
with a calibrated error rate matching the paper's measured GPT-hit rates
(~96-98%), and (b) agent-quality profile (success / correctness / task
metrics) matches Table I per (model x prompting x shot) cell.

``TorchLLM`` routes ``complete()`` through the port's serving engine
(``repro_torch.serving``), the counterpart of the reference's ``JaxLLM``:
served ``dcache-agent-150m`` making the controller's cache decisions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import re
from typing import Dict, Optional

from repro_torch.core.prompts import LLMParseError, parse_json_tail

# Table I targets: (success, correctness, obj-det F1, LCC recall, VQA rouge)
PROFILES: Dict[tuple, Dict[str, float]] = {
    ("gpt-3.5-turbo", "cot", False): dict(
        success=0.4945, corr=0.3847, f1=0.7068, lcc=0.7019, rouge=0.5662),
    ("gpt-3.5-turbo", "cot", True): dict(
        success=0.5442, corr=0.7050, f1=0.8903, lcc=0.8219, rouge=0.6258),
    ("gpt-3.5-turbo", "react", False): dict(
        success=0.5085, corr=0.7004, f1=0.8794, lcc=0.8912, rouge=0.6141),
    ("gpt-3.5-turbo", "react", True): dict(
        success=0.6345, corr=0.7106, f1=0.8259, lcc=0.9236, rouge=0.6935),
    ("gpt-4-turbo", "cot", False): dict(
        success=0.7048, corr=0.8204, f1=0.8634, lcc=0.8491, rouge=0.6978),
    ("gpt-4-turbo", "cot", True): dict(
        success=0.7289, corr=0.8487, f1=0.8375, lcc=0.9729, rouge=0.7215),
    ("gpt-4-turbo", "react", False): dict(
        success=0.7430, corr=0.8580, f1=0.8849, lcc=0.9452, rouge=0.7218),
    ("gpt-4-turbo", "react", True): dict(
        success=0.7671, corr=0.8567, f1=0.6449, lcc=0.9895, rouge=0.7423),
}

# cache-decision error rates calibrated to Table III GPT-hit rates
CACHE_EPS = {"gpt-3.5-turbo": 0.055, "gpt-4-turbo": 0.034}


@dataclasses.dataclass
class Profile:
    model: str
    prompting: str      # "cot" | "react"
    few_shot: bool

    @property
    def targets(self) -> Dict[str, float]:
        return PROFILES[(self.model, self.prompting, self.few_shot)]

    @property
    def cache_eps(self) -> float:
        return CACHE_EPS[self.model]


class SimLLM:
    """Deterministic GPT stand-in (see module docstring)."""

    def __init__(self, profile: Profile, seed: int = 0):
        self.profile = profile
        ident = f"{seed}|{profile.model}|{profile.prompting}|{profile.few_shot}"
        self.rng = random.Random(
            int.from_bytes(hashlib.blake2b(ident.encode(),
                                           digest_size=8).digest(), "big"))

    # -- generic completion --------------------------------------------------
    def complete(self, prompt: str) -> str:
        handler = None
        if "Respond with a JSON object mapping each key" in prompt:
            handler = self._read_decision
        elif "return the NEW cache state" in prompt:
            handler = self._update_decision
        elif "ADMIT the candidate" in prompt:
            handler = self._admission_decision
        elif "REPLICATION controller" in prompt:
            handler = self._replication_decision
        elif "RECOVERY controller" in prompt:
            handler = self._recovery_decision
        elif "COHERENCE controller" in prompt:
            handler = self._coherence_decision
        elif "PLAN-CACHE controller" in prompt:
            handler = self._plan_cache_decision
        if handler is None:
            # planning / answer prompts: canned completion (token accounting
            # is handled by the agent's latency model)
            return ("Thought: I will decompose the task and call the tools "
                    "in order.\nAction: proceed.")
        try:
            return handler(prompt)
        except LLMParseError:
            raise
        except (AttributeError, IndexError, KeyError, TypeError,
                ValueError) as exc:
            # a prompt the parser cannot read (missing evidence line, garbled
            # JSON, bad numeric field) is a typed parse failure, never a raw
            # AttributeError/JSONDecodeError bubbling into the caller
            raise LLMParseError(
                f"unparseable {handler.__name__} prompt: {exc!r}") from exc

    # -- cache READ ----------------------------------------------------------
    def _read_decision(self, prompt: str) -> str:
        keys = parse_json_tail(
            re.search(r"Required keys: (\[.*?\])", prompt).group(1))
        # the live cache-contents line is the LAST "Cache:" line (few-shot
        # examples above it also contain Cache: lines)
        cache = json.loads(re.findall(r"Cache: (\{.*\})", prompt)[-1])
        eps = self.profile.cache_eps
        out = {}
        for k in keys:
            correct = "read_cache" if k in cache else "load_db"
            if self.rng.random() < eps:
                correct = ("load_db" if correct == "read_cache"
                           else "read_cache")
            out[k] = correct
        return ("Thought: comparing required keys against cache contents.\n"
                f"Answer: {json.dumps(out)}")

    # -- cache UPDATE --------------------------------------------------------
    def _update_decision(self, prompt: str) -> str:
        cache = json.loads(
            re.findall(r"Current cache: (\{.*\})", prompt)[-1])
        loads = parse_json_tail(
            re.search(r"this round: (\[.*?\])", prompt).group(1))
        cap = int(re.search(r"at most (\d+) entries", prompt).group(1))
        policy = prompt.lower()
        state = dict(cache)
        protected = set(loads)  # just-loaded keys are the most recent
        for k in loads:
            if k in state:
                continue
            if len(state) >= cap:
                victim = self._victim(state, policy, protected)
                state.pop(victim)
            state[k] = {}
        keys = list(state)
        eps = self.profile.cache_eps
        if len(cache) >= cap and loads and self.rng.random() < eps:
            # LLM slip: evicts the wrong entry
            keys = self._perturb(cache, loads, cap)
        return ("Thought: applying the update policy as described.\n"
                f"Answer: {json.dumps(keys)}")

    # -- cache ADMISSION -----------------------------------------------------
    def _admission_decision(self, prompt: str) -> str:
        """Admission decided by *reading the policy text* (like eviction):
        the frequency estimates are in the prompt, the rule is in the
        policy description, and the calibrated error rate applies."""
        # the live lines are the LAST matches (few-shot examples above them
        # also contain Candidate/victim frequency lines)
        kf = int(re.findall(r"Candidate key: \S+ \(estimated frequency: "
                            r"(\d+)\)", prompt)[-1])
        vf = int(re.findall(r"Eviction victim if admitted: \S+ \(estimated "
                            r"frequency: (\d+)\)", prompt)[-1])
        # the live policy line precedes the few-shot examples (which mention
        # other policies): take the FIRST match
        policy = re.search(r"Admission policy: (.*)", prompt).group(1).lower()
        if "strictly higher" in policy:
            admit = kf > vf
        elif "at least twice" in policy:
            admit = kf >= 2
        elif "always-admit" in policy or "never bypass" in policy:
            admit = True
        else:
            admit = kf > vf
        if self.rng.random() < self.profile.cache_eps:
            admit = not admit
        decision = "admit" if admit else "bypass"
        return ("Thought: weighing the candidate's frequency against the "
                "victim's under the stated policy.\n"
                f'Answer: {json.dumps({"decision": decision})}')

    # -- hot-key REPLICATION -------------------------------------------------
    def _replication_decision(self, prompt: str) -> str:
        """Replication decided by reading the policy text: the sketch
        estimate, current replica state and thresholds are all in the
        prompt; the calibrated error rate applies (a slip lands on the
        nearest wrong decision — promoting a cold key or holding a hot
        one — never on the opposite extreme)."""
        freq, rep = re.findall(
            r"Key: \S+ \(estimated frequency: (\d+); currently "
            r"replicated: (yes|no)\)", prompt)[-1]
        freq, replicated = int(freq), rep == "yes"
        promote = int(re.findall(r"replicate at >= (\d+)", prompt)[-1])
        demote = int(re.findall(r"drop a replica at < (\d+)", prompt)[-1])
        if not replicated:
            decision = "replicate" if freq >= promote else "hold"
        elif freq < demote:
            decision = "drop"
        else:
            decision = "hold"
        if self.rng.random() < self.profile.cache_eps:
            if decision == "hold":
                decision = "drop" if replicated else "replicate"
            else:
                decision = "hold"
        return ("Thought: comparing the key's frequency against the "
                "promote/demote thresholds.\n"
                f'Answer: {json.dumps({"decision": decision})}')

    # -- post-failover RECOVERY ----------------------------------------------
    def _recovery_decision(self, prompt: str) -> str:
        """Failover recovery decided by reading the policy text: the lost
        key's sketch estimate and the re-warm threshold are in the prompt;
        the calibrated error rate flips the verdict."""
        freq = int(re.findall(r"Lost key: \S+ \(estimated frequency: "
                              r"(\d+)\)", prompt)[-1])
        rewarm_min = int(re.findall(r"re-warm at >= (\d+)", prompt)[-1])
        decision = "rewarm" if freq >= rewarm_min else "lazy"
        if self.rng.random() < self.profile.cache_eps:
            decision = "lazy" if decision == "rewarm" else "rewarm"
        return ("Thought: weighing the lost key's frequency against the "
                "re-warm threshold.\n"
                f'Answer: {json.dumps({"decision": decision})}')

    # -- cache COHERENCE (refresh vs serve-stale) ----------------------------
    def _coherence_decision(self, prompt: str) -> str:
        """Refresh-vs-serve-stale decided by reading the evidence block:
        the copy's staleness and the policy's declared bound are in the
        prompt; the calibrated error rate flips the verdict (the engine
        clamps beyond-bound serve_stale answers, so a slip can cost
        latency but never the staleness contract)."""
        staleness = float(re.findall(r'"staleness_s": ([0-9.]+)',
                                     prompt)[-1])
        bound = float(re.findall(r'"bound_s": ([0-9.eE+-]+)', prompt)[-1])
        decision = "serve_stale" if staleness <= bound else "refresh"
        if self.rng.random() < self.profile.cache_eps:
            decision = ("refresh" if decision == "serve_stale"
                        else "serve_stale")
        return ("Thought: weighing the copy's staleness against the "
                "declared bound.\n"
                f'Answer: {json.dumps({"decision": decision})}')

    # -- PLAN-CACHE admission (cache vs bypass a fresh plan) -----------------
    def _plan_cache_decision(self, prompt: str) -> str:
        """Plan-cache admission decided by reading the policy text: the
        candidate and victim plan frequencies are in the prompt; the
        calibrated error rate flips the verdict (a slip can cost planning
        rounds or churn a hot plan, never correctness — a served plan is
        always version-exact)."""
        kf = int(re.findall(r"Candidate plan: \S+ \(estimated frequency: "
                            r"(\d+)\)", prompt)[-1])
        vf = int(re.findall(r"Eviction victim if cached: \S+ \(estimated "
                            r"frequency: (\d+)\)", prompt)[-1])
        # live policy line precedes the few-shot examples: FIRST match
        policy = re.search(r"Plan-cache policy: (.*)", prompt).group(1).lower()
        floor = re.search(r"frequency is at least (\d+)", policy)
        cache = kf >= (int(floor.group(1)) if floor else 1) and kf >= vf
        if self.rng.random() < self.profile.cache_eps:
            cache = not cache
        decision = "cache" if cache else "bypass"
        return ("Thought: weighing the candidate plan's request frequency "
                "against the victim's under the stated policy.\n"
                f'Answer: {json.dumps({"decision": decision})}')

    def _victim(self, state: Dict[str, dict], policy_text: str,
                protected=()) -> str:
        def meta(k, field, default):
            v = state.get(k) or {}
            return v.get(field, default)
        keys = sorted(k for k in state if k not in protected) or sorted(state)
        if "least frequently" in policy_text:
            return min(keys, key=lambda k: (meta(k, "access_count", 0),
                                            meta(k, "last_access", 0)))
        if "first in first out" in policy_text:
            return min(keys, key=lambda k: meta(k, "insert_order", 0))
        if "random" in policy_text:
            return self.rng.choice(keys)
        if "farthest in the future" in policy_text:
            return keys[0]
        # default LRU
        return min(keys, key=lambda k: meta(k, "last_access", 0))

    def _perturb(self, cache, loads, cap):
        keys = sorted(cache)
        self.rng.shuffle(keys)
        keep = keys[: max(cap - len(loads), 0)]
        return (keep + list(loads))[:cap]

    # -- agent-quality error draws (used by the runner) ----------------------
    def draw_task_failure(self) -> bool:
        return self.rng.random() > self.profile.targets["success"]

    def draw_bad_calls(self) -> int:
        """Erroneous tool attempts preceding a correct call (geometric, so
        the correctness *ratio* converges to the profile target even below
        50%), capped to keep single traces bounded."""
        c = self.profile.targets["corr"]
        n = 0
        while n < 4 and self.rng.random() > c:
            n += 1
        return n

    def draw_step_corruption(self, kind: str) -> bool:
        t = self.profile.targets
        target = {"detect": t["f1"], "lcc": t["lcc"], "vqa": t["rouge"]}.get(
            kind, max(t["success"], 0.9))
        return self.rng.random() > target


class TorchLLM:
    """Real decision model: completions generated by the port's serving
    engine (``repro_torch.serving.ServingEngine``); the counterpart of the
    reference's ``JaxLLM``."""

    def __init__(self, engine, max_new_tokens: int = 64):
        self.engine = engine
        self.max_new_tokens = max_new_tokens

    def complete(self, prompt: str) -> str:
        return self.engine.generate_text(prompt, self.max_new_tokens)
