"""Benchmark sampler (paper §IV): multi-step geospatial tasks with a
parameterised data-reuse rate, plus the model-checker that verifies each
generated task's gold plan executes correctly.

The GeoLLM-Engine-1k set is not public; this re-implements its *sampler*:
1,000 multi-step prompts (~50k tool calls) whose probability of requiring
data already in the working set is the ``reuse_rate`` (0.8 for the main
benchmark; 0.0-0.8 for the Table II ablation), and a 500-query mini set.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.agent.geollm.datastore import (
    CLASSES,
    REGIONS,
    GeoDataStore,
    GeoFrame,
    all_keys,
)
from repro_torch.agent.geollm import geotools

WORKING_SET = 5   # matches the cache capacity (5 entries)


def mutation_hot_keys(k: int) -> List[str]:
    """The seed-independent mutation-hot key set: the first ``k``
    keys of the 0x5EED-shuffled key order — the same shuffle
    ``zipf_global`` / ``affinity_zipf`` use, so every session, every
    MutationPlan generator, and every benchmark cell agree on WHICH keys
    are being written without coordinating through seeds."""
    if k < 1:
        raise ValueError(f"mutation_hot_keys needs k >= 1, got {k}")
    order = list(all_keys())
    random.Random(0x5EED).shuffle(order)
    return order[:k]


@dataclasses.dataclass
class ToolCall:
    name: str
    args: Dict[str, Any]       # "$var" strings reference the env
    out: Optional[str] = None


@dataclasses.dataclass
class Step:
    kind: str                  # detect | lcc | vqa | plot | count | timeseries
    key: str
    prompt: str
    plan: List[ToolCall]
    gold: Any = None


@dataclasses.dataclass
class Task:
    tid: int
    query: str
    steps: List[Step]
    required_keys: List[str]

    @property
    def n_tool_calls(self) -> int:
        return sum(len(s.plan) for s in self.steps) + len(self.required_keys)


def _frame_var(key: str) -> str:
    return f"frame_{key.replace('-', '_')}"


def _mk_step(kind: str, key: str, rng: random.Random) -> Step:
    region = rng.choice(sorted(REGIONS))
    cls = rng.choice(CLASSES)
    fv = "$" + _frame_var(key)
    if kind == "detect":
        prompt = f"Detect {cls}s in the {key} imagery around {region}."
        plan = [
            ToolCall("filter_bbox", {"frame": fv, "region": region}, "roi"),
            ToolCall("filter_clouds", {"frame": "$roi", "max_pct": 60}, "clear"),
            ToolCall("detect_objects", {"frame": "$clear", "class_name": cls},
                     "answer"),
            ToolCall("plot_images", {"frame": "$clear"}, "ui"),
        ]
    elif kind == "lcc":
        prompt = f"Classify the dominant land cover near {region} in {key}."
        plan = [
            ToolCall("filter_bbox", {"frame": fv, "region": region}, "roi"),
            ToolCall("dominant_land_covers", {"frame": "$roi", "top_k": 2},
                     "answer"),
            ToolCall("plot_heatmap", {"frame": "$roi", "value": "land_cover"},
                     "ui"),
        ]
    elif kind == "vqa":
        q = f"What does the {region} area look like?"
        prompt = f"{q} (use {key})"
        plan = [
            ToolCall("filter_bbox", {"frame": fv, "region": region}, "roi"),
            ToolCall("vqa_answer", {"frame": "$roi", "question": q}, "answer"),
        ]
    elif kind == "plot":
        prompt = f"Plot the {cls} scenes from {key} around {region}."
        plan = [
            ToolCall("filter_bbox", {"frame": fv, "region": region}, "roi"),
            ToolCall("filter_class", {"frame": "$roi", "class_name": cls},
                     "sel"),
            ToolCall("plot_images", {"frame": "$sel"}, "answer"),
        ]
    elif kind == "count":
        m0, m1 = sorted(rng.sample(range(1, 13), 2))
        prompt = (f"How many {key} images around {region} were taken between "
                  f"months {m0} and {m1}?")
        plan = [
            ToolCall("filter_bbox", {"frame": fv, "region": region}, "roi"),
            ToolCall("filter_date_range",
                     {"frame": "$roi", "start_month": m0, "end_month": m1},
                     "rng_sel"),
            ToolCall("count_images", {"frame": "$rng_sel"}, "answer"),
        ]
    else:  # timeseries
        prompt = f"Show the monthly acquisition counts for {key} at {region}."
        plan = [
            ToolCall("filter_bbox", {"frame": fv, "region": region}, "roi"),
            ToolCall("sort_by_time", {"frame": "$roi"}, "sorted"),
            ToolCall("timeseries", {"frame": "$sorted", "freq": "month"},
                     "answer"),
        ]
    return Step(kind=kind, key=key, prompt=prompt, plan=plan)


STEP_KINDS = ("detect", "lcc", "vqa", "plot", "count", "timeseries")


class WorkloadSampler:
    """Samples tasks under one of several key-popularity *scenarios*.

    The default ``"working"`` scenario is the paper's: keys repeat out of a
    sliding working set with probability ``reuse_rate`` (its RNG draw
    sequence is untouched by the scenario machinery — Table I-III digests
    depend on it). The additional scenarios stress the shared cache in
    qualitatively different ways (the admission benchmark sweeps them):

    * ``"zipf"`` — stationary skew: keys drawn from a Zipf(``zipf_a``)
      distribution over a seed-shuffled key order. High skew rewards
      keeping the few hot keys resident; the long tail is one-shot
      traffic that churns an admission-less cache.
    * ``"scan"`` — sequential sweep through the whole key space (the
      classic cache-adversarial pattern): every access is a compulsory
      miss, so *nothing* deserves admission once the cache warms.
    * ``"hotspot"`` — shifting phases: for ``phase_len`` key draws a hot
      set of ``hot_k`` keys serves ``hot_p`` of the traffic, then the hot
      set resamples. Tests how quickly admission+aging track drift.
    * ``"affinity_zipf"`` — per-pod hot sets with cross-pod spillover (the
      session->pod affinity regime): the key space is partitioned
      round-robin into ``n_groups`` groups over a seed-INDEPENDENT shuffle
      (every session agrees on the partition, like ``zipf_global``), each
      group carries its own Zipf(``zipf_a``) ranking, and a sampler bound
      to ``group`` g draws from its own group's ranking with probability
      ``1 - spill_p``, else from a uniformly chosen *other* group's. The
      concurrent engine binds ``group`` to the session's home pod, so each
      pod's sessions share a hot set — but rendezvous hashing owns those
      keys on arbitrary pods, which is exactly what makes consumer-side
      locality (and consumer-targeted replication) matter.
    * ``"update_heavy"`` — mutation-focused traffic (the mutable-data-plane
      regime): ``hot_p`` of the key draws land on the
      seed-independent :func:`mutation_hot_keys` set of size ``hot_k`` —
      the same keys a benchmark-level :class:`MutationPlan` keeps writing
      — so most reads race recent writes and the coherence policy is on
      the critical path.
    * ``"mixed_rw"`` — balanced read/write interleaving: key draws
      alternate deterministically between the mutation-hot set and the
      uniform key space (~50/50 regardless of ``hot_p``), the middle
      ground between ``update_heavy`` and pure-read scenarios.
    * ``"flash_fresh"`` — flash crowd on fresh data: a hot window of
      ``hot_k`` consecutive keys in the 0x5EED-shuffled order serves
      ``hot_p`` of the traffic and advances by one key every
      ``phase_len`` draws. Paired with a periodic ARRIVAL MutationPlan
      over the same order, the crowd keeps piling onto keys whose data
      just changed — worst case for serve-stale bounds.
    """

    def __init__(self, reuse_rate: float = 0.8, seed: int = 0,
                 scenario: str = "working", zipf_a: float = 1.2,
                 zipf_global: bool = False,
                 hot_k: int = 4, hot_p: float = 0.9, phase_len: int = 60,
                 n_groups: int = 4, group: int = 0, spill_p: float = 0.15,
                 repeat_p: float = 0.0, repeat_pool: int = 12):
        # fail-fast parameter validation: a bad rate/probability
        # here silently skews every downstream table — reject loudly
        if not 0.0 <= reuse_rate <= 1.0:
            raise ValueError(f"reuse_rate must be in [0, 1], "
                             f"got {reuse_rate}")
        if scenario not in ("working", "zipf", "scan", "hotspot",
                            "affinity_zipf", "update_heavy", "mixed_rw",
                            "flash_fresh"):
            raise ValueError(f"unknown scenario {scenario!r}")
        if zipf_a <= 0.0:
            raise ValueError(f"zipf_a must be > 0, got {zipf_a}")
        if not 0.0 <= hot_p <= 1.0:
            raise ValueError(f"hot_p must be in [0, 1], got {hot_p}")
        if not 0.0 <= spill_p <= 1.0:
            raise ValueError(f"spill_p must be in [0, 1], got {spill_p}")
        if hot_k < 1 or phase_len < 1:
            raise ValueError(f"hot_k/phase_len must be >= 1, "
                             f"got ({hot_k}, {phase_len})")
        self.reuse_rate = reuse_rate
        self.rng = random.Random(seed)
        self.keys = all_keys()
        self.working: List[str] = []
        self.scenario = scenario
        if scenario == "zipf":
            # seed-shuffled rank order (drawn from a separate RNG so the
            # "working" draw stream stays byte-identical to pre-scenario
            # code); cumulative weights for rng.choices' internal bisect.
            # ``zipf_global=True`` fixes the rank order across ALL sessions
            # (seed-independent shuffle): every session then agrees on
            # which keys are hot — the paper's many-endpoints-one-event
            # regime, and the workload where cross-pod replication of
            # super-hot keys has real signal. The default (per-session
            # order) keeps each session's skew private, so the *global*
            # popularity field stays nearly flat even at high zipf_a.
            order = list(self.keys)
            random.Random(0x5EED if zipf_global else seed ^ 0x5EED
                          ).shuffle(order)
            self._zipf_keys = order
            w = [1.0 / (r + 1) ** zipf_a for r in range(len(order))]
            self._zipf_cum = list(itertools.accumulate(w))
        if scenario == "affinity_zipf":
            # seed-independent partition (all sessions agree on the groups)
            order = list(self.keys)
            random.Random(0x5EED).shuffle(order)
            g = max(1, int(n_groups))
            self._aff_groups = [order[i::g] for i in range(g)]
            self._aff_cums = [
                list(itertools.accumulate(1.0 / (r + 1) ** zipf_a
                                          for r in range(len(grp))))
                for grp in self._aff_groups]
            self._aff_group = int(group) % g
            self._aff_spill = spill_p
        if scenario in ("update_heavy", "mixed_rw", "flash_fresh"):
            # seed-independent shuffle (separate RNG: the "working" draw
            # stream stays byte-identical): every session AND every
            # MutationPlan built from mutation_hot_keys() agree on which
            # keys are write-hot.
            order = list(self.keys)
            random.Random(0x5EED).shuffle(order)
            self._mut_order = order
        self._scan_pos = 0
        self.hot_k, self.hot_p, self.phase_len = hot_k, hot_p, phase_len
        self._hot: List[str] = []
        self._draws = 0
        # request-level task repeats: with probability
        # ``repeat_p`` a task draw returns a fresh-tid copy of one of
        # ``repeat_pool`` canned tasks — the "users keep asking the same
        # question" pattern that makes a plan cache worth having. The
        # library is seed-INDEPENDENT (like zipf_global / the mutation-hot
        # order), so every session of an episode samples the same canned
        # tasks and repeats collide ACROSS sessions; its keys skew to the
        # head of the shared 0x5EED shuffle so repeated tasks also share
        # data. ``repeat_p == 0`` (the default) skips the gate draw
        # entirely — every pre-existing scenario's RNG stream, and every
        # digest built on it, is byte-identical.
        if not 0.0 <= repeat_p <= 1.0:
            raise ValueError(f"repeat_p must be in [0, 1], got {repeat_p}")
        if repeat_pool < 1:
            raise ValueError(f"repeat_pool must be >= 1, got {repeat_pool}")
        self.repeat_p = repeat_p
        self._library: List[Task] = []
        if repeat_p > 0.0:
            lib_rng = random.Random(0x9A17)
            order = list(self.keys)
            random.Random(0x5EED).shuffle(order)
            head = order[:max(2 * WORKING_SET, hot_k)]
            for i in range(repeat_pool):
                steps, keys = [], []
                for _ in range(lib_rng.randint(3, 5)):
                    kind = lib_rng.choice(STEP_KINDS)
                    key = lib_rng.choice(head)
                    steps.append(_mk_step(kind, key, lib_rng))
                    if key not in keys:
                        keys.append(key)
                self._library.append(Task(
                    tid=-1 - i, query=" Then, ".join(s.prompt for s in steps),
                    steps=steps, required_keys=keys))

    def _sample_key(self) -> str:
        if self.scenario == "zipf":
            return self.rng.choices(self._zipf_keys,
                                    cum_weights=self._zipf_cum)[0]
        if self.scenario == "affinity_zipf":
            gi = self._aff_group
            n = len(self._aff_groups)
            if n > 1 and self.rng.random() < self._aff_spill:
                gi = self.rng.randrange(n - 1)    # spill: another group's
                if gi >= self._aff_group:         # hot set, uniformly
                    gi += 1
            return self.rng.choices(self._aff_groups[gi],
                                    cum_weights=self._aff_cums[gi])[0]
        if self.scenario == "scan":
            key = self.keys[self._scan_pos % len(self.keys)]
            self._scan_pos += 1
            return key
        if self.scenario == "update_heavy":
            if self.rng.random() < self.hot_p:
                return self.rng.choice(self._mut_order[:self.hot_k])
            return self.rng.choice(self.keys)
        if self.scenario == "mixed_rw":
            self._draws += 1
            if self._draws % 2:       # deterministic ~50/50 interleave
                return self.rng.choice(self._mut_order[:self.hot_k])
            return self.rng.choice(self.keys)
        if self.scenario == "flash_fresh":
            w = self._draws // self.phase_len   # window advances per phase
            self._draws += 1
            if self.rng.random() < self.hot_p:
                n = len(self._mut_order)
                win = [self._mut_order[(w + i) % n]
                       for i in range(self.hot_k)]
                return self.rng.choice(win)
            return self.rng.choice(self.keys)
        if self.scenario == "hotspot":
            if self._draws % self.phase_len == 0:
                self._hot = self.rng.sample(self.keys, self.hot_k)
            self._draws += 1
            if self.rng.random() < self.hot_p:
                return self.rng.choice(self._hot)
            return self.rng.choice(self.keys)
        # "working" (default; draw sequence is digest-locked)
        if self.working and self.rng.random() < self.reuse_rate:
            return self.rng.choice(self.working)
        key = self.rng.choice(self.keys)
        self.working.append(key)
        if len(self.working) > WORKING_SET:
            self.working.pop(0)
        return key

    def sample_task(self, tid: int) -> Task:
        if self.repeat_p and self.rng.random() < self.repeat_p:
            lib = self.rng.choice(self._library)
            # fresh-tid copy with per-copy Step objects: compute_gold fills
            # gold per copy, and shared immutable plans/prompts are safe
            return Task(tid=tid, query=lib.query,
                        steps=[Step(kind=s.kind, key=s.key, prompt=s.prompt,
                                    plan=s.plan) for s in lib.steps],
                        required_keys=list(lib.required_keys))
        n_steps = self.rng.randint(3, 5)
        steps, keys = [], []
        for _ in range(n_steps):
            kind = self.rng.choice(STEP_KINDS)
            key = self._sample_key()
            steps.append(_mk_step(kind, key, self.rng))
            if key not in keys:
                keys.append(key)
        query = " Then, ".join(s.prompt for s in steps)
        return Task(tid=tid, query=query, steps=steps, required_keys=keys)

    def sample(self, n: int) -> List[Task]:
        return [self.sample_task(i) for i in range(n)]


# ---------------------------------------------------------------------------
# Gold execution + model checker
# ---------------------------------------------------------------------------

def execute_plan(step: Step, env: Dict[str, Any]) -> Any:
    """Run a step's gold plan against an env of frame variables."""
    fns = {n: getattr(geotools, n) for n in (
        "filter_bbox", "filter_class", "filter_clouds", "filter_date_range",
        "count_images", "detect_objects", "land_cover_stats",
        "dominant_land_covers", "vqa_answer", "image_stats", "sample_images",
        "sort_by_time", "merge_frames", "plot_images", "plot_heatmap",
        "timeseries")}
    local = dict(env)
    answer = None
    for call in step.plan:
        args = {k: (local[v[1:]] if isinstance(v, str) and v.startswith("$")
                    else v) for k, v in call.args.items()}
        out = fns[call.name](**args)
        if call.out:
            local[call.out] = out
        if call.out == "answer":
            answer = out
    return answer


def compute_gold(tasks: List[Task], store: GeoDataStore) -> None:
    """Fill ``step.gold`` (latency-free peek — the checker's oracle)."""
    for t in tasks:
        env = {_frame_var(k): store.peek(k) for k in t.required_keys}
        for s in t.steps:
            s.gold = execute_plan(s, env)


def answers_equal(a: Any, b: Any) -> bool:
    """Structural equality over the answer value domain (dicts, sequences,
    scalars, numpy arrays, GeoFrames). Unlike ``repr`` comparison, numpy's
    print truncation cannot mask a real mismatch in a large array."""
    if a is b:
        return True
    if isinstance(a, GeoFrame) or isinstance(b, GeoFrame):
        if not (isinstance(a, GeoFrame) and isinstance(b, GeoFrame)):
            return False
        return (a.key == b.key and len(a) == len(b)
                and all(np.array_equal(getattr(a, c), getattr(b, c))
                        for c in ("filename", "lon", "lat", "timestamp",
                                  "class_id", "det_count", "land_cover",
                                  "cloud_pct")))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).shape == np.asarray(b).shape
                and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.keys() == b.keys()
                and all(answers_equal(v, b[k]) for k, v in a.items()))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (len(a) == len(b)
                and all(answers_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, bool) or isinstance(b, bool):
        return a == b and isinstance(a, bool) == isinstance(b, bool)
    if isinstance(a, (int, float, np.integer, np.floating)) and \
            isinstance(b, (int, float, np.integer, np.floating)):
        return float(a) == float(b)
    return type(a) is type(b) and a == b


def model_check(tasks: List[Task], store: GeoDataStore) -> List[int]:
    """Paper §IV: 'use the model-checker module to verify the functional
    correctness of the generated tasks'. Returns ids of BROKEN tasks.

    Only the expected failure modes of a malformed task mark it broken:
    ``KeyError`` (a required key the store does not carry, an unresolved
    ``$var`` reference) and ``ValueError`` (a tool rejecting bad arguments,
    the gold mismatch below). Anything else — a ``TypeError`` from a buggy
    tool, an ``AttributeError`` from a bad frame object — is a programming
    error in the checker's own dependencies and must propagate, not be
    silently laundered into "task is broken"."""
    bad = []
    for t in tasks:
        try:
            env = {_frame_var(k): store.peek(k) for k in t.required_keys}
            for s in t.steps:
                a = execute_plan(s, env)
                if a is None or (s.gold is not None and
                                 not answers_equal(a, s.gold)):
                    raise ValueError(f"step gold mismatch in task {t.tid}")
        except (ValueError, KeyError):
            bad.append(t.tid)
    return bad


def make_benchmark(n_tasks: int = 1000, reuse_rate: float = 0.8,
                   seed: int = 0, store: Optional[GeoDataStore] = None,
                   ) -> List[Task]:
    tasks = WorkloadSampler(reuse_rate, seed).sample(n_tasks)
    if store is not None:
        compute_gold(tasks, store)
        assert not model_check(tasks, store)
    return tasks
