"""Prompt templates for GPT-driven cache operations (paper Fig. 2).

Two prompt-based decisions:
  * READ  — given the user query and current cache contents, choose
            ``read_cache(key)`` vs ``load_db(key)`` per required key.
  * UPDATE — the eviction policy is *described in natural language*; the LLM
            is given this round's loads + cache contents (JSON) and returns
            the updated cache state.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence


class LLMParseError(ValueError):
    """A prompt or completion could not be parsed into a decision.

    Subclasses ``ValueError`` so every existing generic decision handler
    (and ``ToolRegistry.call``'s error surface) keeps catching it; typed so
    the ``LLM*`` policy wrappers can uniformly fall back to their
    programmatic twin and count the fallback."""


SYSTEM_HEADER = (
    "As a Copilot handling geospatial data, you have access to the following "
    "tools [...]\n"
    " - load_db(key): load imagery metadata for `dataset-year` from the "
    "remote database (slow)\n"
    " - read_cache(key): read imagery metadata for `dataset-year` from the "
    "local cache (fast; fails if the key is not cached)\n"
)

READ_FEWSHOT = """Example 1:
Query: Plot the xview1 images from 2022
Cache: {}
Thought: The user asks for the xview1-2022 imagery. The cache is empty, so I must go to the database.
Action: To complete the task I will call load_db(xview1-2022), then plot the results.

Example 2:
Query: Show fair1m and xview1 imgs from 2022
Cache: {"xview1-2022": {...}}
Thought: The user wants both fair1m-2022 and xview1-2022. The cache already contains the latter, so only fair1m must come from the database.
Action: To complete the task I will first call load_db(fair1m-2022), then read_cache(xview1-2022).
"""


def read_decision_prompt(query: str, required_keys: Sequence[str],
                         cache_json: str, few_shot: bool) -> str:
    parts = [SYSTEM_HEADER]
    if few_shot:
        parts.append(READ_FEWSHOT)
    parts.append(
        "Given the user query, the cache content, and the examples above, "
        "decide for EACH required data key whether to call read_cache(key) "
        "or load_db(key). Respond with a JSON object mapping each key to "
        "\"read_cache\" or \"load_db\".\n")
    parts.append(f"User Query: {query}\n")
    parts.append(f"Required keys: {json.dumps(sorted(required_keys))}\n")
    parts.append(f"Cache: {cache_json}\n")
    parts.append("Answer (JSON): ")
    return "".join(parts)


def update_decision_prompt(policy_text: str, loads: Sequence[str],
                           cache_json: str, capacity: int,
                           few_shot: bool) -> str:
    parts = [SYSTEM_HEADER,
             "You are now the cache controller. Apply the cache update "
             "policy below and return the NEW cache state as a JSON list of "
             f"keys (at most {capacity} entries).\n",
             f"Update policy: {policy_text}\n"]
    if few_shot:
        parts.append(
            'Example: policy=LRU, capacity=2, cache={"a": {"last_access": 1},'
            ' "b": {"last_access": 5}}, this round loaded ["c"].\n'
            'Thought: the cache is full; "a" is least recent; evict "a".\n'
            'Answer: ["b", "c"]\n')
    parts.append(f"Current cache: {cache_json}\n")
    parts.append(f"Keys loaded from the database this round: "
                 f"{json.dumps(list(loads))}\n")
    parts.append("Answer (JSON list of keys): ")
    return "".join(parts)


ADMISSION_FEWSHOT = """Example 1:
Admission policy: TinyLFU (admit only if the candidate's frequency is STRICTLY HIGHER than the victim's).
Candidate key: fair1m-2021 (estimated frequency: 4)
Eviction victim if admitted: modis-2016 (estimated frequency: 1)
Thought: the candidate is clearly hotter than the victim, so caching it is worth an eviction.
Answer: {"decision": "admit"}

Example 2:
Admission policy: TinyLFU (admit only if the candidate's frequency is STRICTLY HIGHER than the victim's).
Candidate key: naip-2018 (estimated frequency: 1)
Eviction victim if admitted: xview1-2022 (estimated frequency: 6)
Thought: a one-shot key must not churn out a hot resident; stream it through instead.
Answer: {"decision": "bypass"}
"""


def admission_decision_prompt(policy_text: str, key: str, victim: str,
                              key_freq: int, victim_freq: int,
                              cache_json: str, few_shot: bool,
                              home_demand_json: Optional[str] = None) -> str:
    """Prompt for the GPT-driven admission decision: given the admission
    policy in natural language plus the frequency-sketch estimates, decide
    whether to ADMIT the candidate into the cache (evicting the victim) or
    BYPASS it (serve the data through without caching).

    ``home_demand_json`` (only rendered when provided — the locality-free
    prompt stays byte-identical) exposes the candidate's remote consumer
    demand by home pod, so a locality-aware LLM can weigh WHO is paying
    cross-pod hops for the key."""
    parts = [SYSTEM_HEADER,
             "You are now the cache admission controller. A key was just "
             "loaded from the database and the cache is FULL. Apply the "
             "admission policy below and decide whether to ADMIT the "
             "candidate into the cache (evicting the victim) or BYPASS the "
             "cache (the data is served to the caller but nothing is "
             "cached and no resident is evicted).\n",
             f"Admission policy: {policy_text}\n"]
    if few_shot:
        parts.append(ADMISSION_FEWSHOT)
    parts.append(f"Current cache: {cache_json}\n")
    parts.append(f"Candidate key: {key} (estimated frequency: {key_freq})\n")
    parts.append(f"Eviction victim if admitted: {victim} "
                 f"(estimated frequency: {victim_freq})\n")
    if home_demand_json is not None:
        parts.append("Remote consumer demand for the candidate (reads "
                     "paying a cross-pod hop, by consumer home pod): "
                     f"{home_demand_json}\n")
    parts.append('Respond with a JSON object: {"decision": "admit"} or '
                 '{"decision": "bypass"}.\n')
    parts.append("Answer (JSON): ")
    return "".join(parts)


REPLICATION_FEWSHOT = """Example 1:
Replication policy: threshold (replicate when frequency >= 8; drop a replica when frequency < 4).
Key: xview1-2022 (estimated frequency: 11; currently replicated: no)
Thought: the key is clearly above the promote threshold, so pushing copies to every pod converts its remote joins into local hits.
Answer: {"decision": "replicate"}

Example 2:
Replication policy: threshold (replicate when frequency >= 8; drop a replica when frequency < 4).
Key: modis-2016 (estimated frequency: 6; currently replicated: yes)
Thought: the key cooled below the promote threshold but is still above the demote threshold — inside the hysteresis band, keep the replicas (no flapping).
Answer: {"decision": "hold"}

Example 3:
Replication policy: threshold (replicate when frequency >= 8; drop a replica when frequency < 4).
Key: naip-2018 (estimated frequency: 2; currently replicated: yes)
Thought: the key fell below the demote threshold; its replicas now waste capacity other keys could use.
Answer: {"decision": "drop"}
"""


def replication_decision_prompt(policy_text: str, key: str, freq: int,
                                replicated: bool, promote_min: int,
                                demote_min: int, top_json: str,
                                few_shot: bool,
                                home_demand_json: Optional[str] = None,
                                ) -> str:
    """Prompt for the GPT-driven hot-key replication decision: given the
    replication policy in natural language, the key's sketch estimate, and
    whether it is currently replicated, decide REPLICATE (push a copy to
    every pod), DROP (remove its replicas) or HOLD (change nothing).

    ``home_demand_json`` (only rendered when provided — the locality-free
    prompt stays byte-identical) exposes the key's remote consumer demand
    by home pod: under a cross-pod read penalty, that is exactly the
    evidence that says WHERE a copy converts penalized hops into pod-local
    hits."""
    parts = [SYSTEM_HEADER,
             "You are now the cache REPLICATION controller of a pod-sharded "
             "deployment. Each key's data is cached on exactly one owner "
             "pod; SUPER-HOT keys can additionally be replicated to every "
             "pod, converting other pods' remote joins into local hits at "
             "the cost of cache capacity on each pod. Apply the replication "
             "policy below to ONE key.\n",
             f"Replication policy: {policy_text}\n"]
    if few_shot:
        parts.append(REPLICATION_FEWSHOT)
    parts.append(f"Hottest keys right now (frequency sketch): {top_json}\n")
    parts.append(f"Key: {key} (estimated frequency: {freq}; currently "
                 f"replicated: {'yes' if replicated else 'no'})\n")
    if home_demand_json is not None:
        parts.append("Remote consumer demand for the key (reads paying a "
                     "cross-pod hop, by consumer home pod): "
                     f"{home_demand_json}\n")
    parts.append(f"Thresholds: replicate at >= {promote_min}; drop a "
                 f"replica at < {demote_min}; otherwise hold.\n")
    parts.append('Respond with a JSON object: {"decision": "replicate"}, '
                 '{"decision": "drop"} or {"decision": "hold"}.\n')
    parts.append("Answer (JSON): ")
    return "".join(parts)


RECOVERY_FEWSHOT = """Example 1:
Recovery policy: threshold (re-warm NOW when the key's estimated frequency is >= 4; otherwise refill lazily on the next demand access).
Lost key: xview1-2022 (estimated frequency: 9)
Thought: the key is clearly hot — every consumer would pay the failover DB load; one background re-warm onto the new owner pays it once.
Answer: {"decision": "rewarm"}

Example 2:
Recovery policy: threshold (re-warm NOW when the key's estimated frequency is >= 4; otherwise refill lazily on the next demand access).
Lost key: naip-2018 (estimated frequency: 1)
Thought: a near-cold key may never be read again — a background load for it would only waste the new owner's bandwidth.
Answer: {"decision": "lazy"}
"""


def recovery_decision_prompt(policy_text: str, key: str, freq: int,
                             rewarm_min: int, top_json: str,
                             few_shot: bool) -> str:
    """Prompt for the GPT-driven post-failover recovery decision: a pod
    just died and ``key`` was resident in its cache (now lost; its key
    range re-routed to a new owner pod). Decide REWARM (issue a background
    DB load onto the new owner now, so consumers find it warm) or LAZY
    (let the next demand access pay the load)."""
    parts = [SYSTEM_HEADER,
             "You are now the cache RECOVERY controller of a pod-sharded "
             "deployment. A pod just FAILED: its cached keys are lost and "
             "their key ranges re-routed to the surviving pods. For ONE "
             "lost key, decide whether to RE-WARM it now (issue one "
             "background database load onto its new owner pod) or refill "
             "it LAZILY (the next session that needs it pays the database "
             "load on demand). Apply the recovery policy below.\n",
             f"Recovery policy: {policy_text}\n"]
    if few_shot:
        parts.append(RECOVERY_FEWSHOT)
    parts.append(f"Hottest keys right now (frequency sketch): {top_json}\n")
    parts.append(f"Lost key: {key} (estimated frequency: {freq})\n")
    parts.append(f"Threshold: re-warm at >= {rewarm_min}; otherwise lazy.\n")
    parts.append('Respond with a JSON object: {"decision": "rewarm"} or '
                 '{"decision": "lazy"}.\n')
    parts.append("Answer (JSON): ")
    return "".join(parts)


COHERENCE_FEWSHOT = """Example 1:
Coherence policy: serve a stale cached copy while its staleness is at most 20 seconds; refresh now once the staleness exceeds 20 seconds.
Key: xview1-2022 (staleness: 7.5s; staleness bound: 20s; estimated frequency: 9)
Thought: the copy lags the store by well under the bound — serving it keeps the hot read stream off the database, and the contract still holds.
Answer: {"decision": "serve_stale"}

Example 2:
Coherence policy: serve a stale cached copy while its staleness is at most 20 seconds; refresh now once the staleness exceeds 20 seconds.
Key: modis-2016 (staleness: 31.2s; staleness bound: 20s; estimated frequency: 2)
Thought: the copy is past the declared bound; serving it would break the freshness contract — pay the reload now.
Answer: {"decision": "refresh"}
"""


def coherence_decision_prompt(policy_text: str, key: str, staleness_s: float,
                              bound_s: float, freq: int,
                              few_shot: bool) -> str:
    """Prompt for the GPT-driven ``cache_update`` decision: the
    datastore has newer data for ``key`` than the cached copy a session is
    about to consume. Decide REFRESH (reload from the database now — the
    reader pays the load) or SERVE_STALE (serve the lagging copy, allowed
    only within the policy's declared staleness bound — the engine clamps
    anything beyond it)."""
    parts = [SYSTEM_HEADER,
             "You are now the cache COHERENCE controller. The database was "
             "UPDATED after the cached copy of ONE key was installed, so "
             "the copy is stale by the staleness shown below. Decide "
             "whether the session about to consume it should REFRESH "
             "(reload from the database now, paying the load) or "
             "SERVE_STALE (use the lagging copy — permitted only while its "
             "staleness is within the declared bound). Apply the coherence "
             "policy below.\n",
             f"Coherence policy: {policy_text}\n"]
    if few_shot:
        parts.append(COHERENCE_FEWSHOT)
    parts.append(f"Key: {key} (staleness: {staleness_s:.1f}s; staleness "
                 f"bound: {bound_s:g}s; estimated frequency: {freq})\n")
    parts.append(f'Evidence (JSON): {{"staleness_s": {staleness_s:.3f}, '
                 f'"bound_s": {bound_s:g}}}\n')
    parts.append('Respond with a JSON object: {"decision": "refresh"} or '
                 '{"decision": "serve_stale"}.\n')
    parts.append("Answer (JSON): ")
    return "".join(parts)


PLAN_CACHE_FEWSHOT = """Example 1:
Plan-cache policy: TTL + frequency (a cached plan expires 180 seconds after install; CACHE a new plan only if its request frequency is at least 1 and, when the cache is full, at least the evicted plan's frequency).
Candidate plan: detect>plot#2 (estimated frequency: 5)
Eviction victim if cached: count>vqa#1 (estimated frequency: 1)
Thought: the candidate template is requested far more often than the coldest resident — caching it converts repeated planning rounds into lookups.
Answer: {"decision": "cache"}

Example 2:
Plan-cache policy: TTL + frequency (a cached plan expires 180 seconds after install; CACHE a new plan only if its request frequency is at least 1 and, when the cache is full, at least the evicted plan's frequency).
Candidate plan: timeseries#1 (estimated frequency: 1)
Eviction victim if cached: detect>lcc>plot#3 (estimated frequency: 7)
Thought: a one-shot plan must not displace a frequently replayed one; let this request stream through.
Answer: {"decision": "bypass"}
"""


def plan_cache_decision_prompt(policy_text: str, template: str,
                               victim_template: str, freq: int,
                               victim_freq: int, ttl_s: float,
                               few_shot: bool) -> str:
    """Prompt for the GPT-driven PLAN-CACHE admission decision:
    a planning round just completed for a (task template, context digest)
    request and the plan cache is FULL. Decide CACHE (store the fresh plan,
    evicting the least-recently-used resident) or BYPASS (serve this
    request's plan without storing it)."""
    parts = [SYSTEM_HEADER,
             "You are now the PLAN-CACHE controller. The agent just paid a "
             "full LLM planning round for the task template below and the "
             "plan cache is FULL. A cached plan is served verbatim to every "
             "later request with the same template over the same data-key "
             "versions, skipping that request's planning round entirely. "
             "Apply the plan-cache policy below and decide whether to "
             "CACHE the fresh plan (evicting the victim) or BYPASS the "
             "cache (the plan is used once and not stored).\n",
             f"Plan-cache policy: {policy_text}\n"]
    if few_shot:
        parts.append(PLAN_CACHE_FEWSHOT)
    parts.append(f"Candidate plan: {template} "
                 f"(estimated frequency: {freq})\n")
    parts.append(f"Eviction victim if cached: {victim_template} "
                 f"(estimated frequency: {victim_freq})\n")
    parts.append(f"Entry time-to-live: {ttl_s:g}s\n")
    parts.append('Respond with a JSON object: {"decision": "cache"} or '
                 '{"decision": "bypass"}.\n')
    parts.append("Answer (JSON): ")
    return "".join(parts)


def parse_json_tail(text: str):
    """Parse the trailing JSON object/list from an LLM completion."""
    text = text.strip()
    for start in range(len(text)):
        if text[start] in "[{":
            try:
                return json.loads(text[start:])
            except json.JSONDecodeError:
                continue
    raise LLMParseError(f"no JSON found in completion: {text[:200]!r}")
