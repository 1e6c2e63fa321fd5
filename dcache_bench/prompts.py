"""Frozen copies of the agent's LLM-call templates and token budgets.

The benchmark builds its traffic from these copies, so a change to the
program's prompts or budgets does not change what the benchmark sends.
Each block names the file and lines of ``repro_torch`` it was copied from,
at the commit that introduced the benchmark.

- ``SYSTEM_HEADER`` .. ``replication_decision_prompt``:
  ``src/repro_torch/core/prompts.py:25-197`` (read, update, admission and
  replication decisions with their few-shot blocks), verbatim.
- ``LRU_TEXT``: ``src/repro_torch/core/policies.py:35-38`` (``LRU.describe``).
- ``TINYLFU_COST_TEXT``: ``src/repro_torch/core/admission.py:327-338``
  (``TinyLFUCost.describe``).
- ``replication_text``: ``src/repro_torch/core/replication.py:110-113``
  (``ThresholdReplication.describe``, promote 8, demote 4).
- ``PLAN_*`` budgets: ``src/repro_torch/agent/agent.py:42-47``.
- ``DATASETS``, ``YEARS``, ``REGIONS``, ``CLASSES``:
  ``src/repro_torch/agent/geollm/datastore.py:31-41``.
- ``GEO_TOOLS``: the tool names of ``src/repro_torch/agent/geollm/geotools.py``.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

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


LRU_TEXT = ("Least Recently Used (LRU): when the cache is full, evict the "
            "entry whose last access is the OLDEST. Each entry below lists "
            "its last_access timestamp; remove the one with the smallest "
            "last_access, then insert the new key.")

TINYLFU_COST_TEXT = (
    "Cost-aware TinyLFU admission: when the cache is full, "
    "compare SLOT VALUE \u2014 the candidate's estimated access "
    "frequency times its miss penalty (a fixed per-load "
    "overhead plus its size in bytes) against the eviction "
    "victim's frequency times the victim's miss penalty. ADMIT "
    "(evict the victim, install the candidate) only if the "
    "candidate's slot value is STRICTLY HIGHER; otherwise "
    "BYPASS the cache \u2014 stream the loaded data through to the "
    "caller without caching it, leaving every resident entry "
    "untouched. Intuition: with slot-bounded capacity, a large "
    "hot frame is worth MORE than a small equally-hot one \u2014 "
    "every miss on it costs a longer database load.")


def replication_text(promote_min: int = 8, demote_min: int = 4) -> str:
    return (f"threshold (replicate when frequency >= {promote_min}; "
            f"drop a replica when frequency < {demote_min}). Keys "
            "whose frequency sits between the two thresholds KEEP their "
            "current state (hysteresis: no flapping).")


# token budgets of one planning round (GeoLLM-Engine accounting)
PLAN_PROMPT_TOKENS = {"cot": 11_000, "react": 5_500}
PLAN_PROMPT_TOKENS_FS = {"cot": 13_500, "react": 7_200}
PLAN_COMPLETION_TOKENS = {"cot": 260, "react": 55}
STEP_SUMMARY_TOKENS = 1_500

DATASETS = ("xview1", "fair1m", "dota", "spacenet", "landsat",
            "sentinel2", "naip", "modis")
YEARS = tuple(range(2015, 2024))
CLASSES = ("airplane", "ship", "vehicle", "building", "storage_tank",
           "harbor", "bridge", "helicopter")
REGIONS = ("newport beach", "san francisco", "houston", "miami")
GEO_TOOLS = ("filter_bbox", "filter_class", "filter_clouds",
             "filter_date_range", "count_images", "detect_objects",
             "land_cover_stats", "dominant_land_covers", "vqa_answer",
             "image_stats", "sample_images", "sort_by_time", "merge_frames",
             "plot_images", "plot_heatmap", "timeseries")
