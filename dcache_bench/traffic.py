"""The one traffic generator: closed-loop agent sessions read from a mix file.

A mix (``dcache_bench/mixes/<name>.json``) is data: the number of sessions,
the session ``kind`` and its parameters. Each session is an agent that
sends its next LLM call as soon as the reply to its previous one arrives
(a closed loop, no think time). Two kinds of session exist:

- ``decisions``: cache operations made as LLM calls (read, update,
  admission and replication decisions), each prompt built from the frozen
  templates of ``prompts.py`` over a cache state drawn from the seed;
- ``react``: ReAct thought/action rounds of GeoLLM tasks; the rounds of a
  task share their preamble (header, tool list, examples, query) and
  history, and each round's prompt is the last one's plus one more block.

The sizes (call kinds, prompt lengths, new tokens, rounds per task) of
session ``i`` come from ``default_rng([mix["shape_seed"], i])``, so every
seed runs the same set of sizes; ``--seed`` assigns those size streams to
slots in another order and draws every byte of content. The first call of
each session is cut to a share ``(i + 1) / sessions`` of its new tokens,
so the sessions' first replies arrive spread out and the loop starts
near its steady state.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Iterator, List

import numpy as np

from dcache_bench import prompts as P

BOS_TOKENS = 1          # the byte tokenizer puts BOS before the prompt's bytes


@dataclasses.dataclass(frozen=True)
class Call:
    kind: str
    prompt: str
    max_new_tokens: int


def load_mix(root: Path, name: str) -> Dict:
    path = Path(root) / "dcache_bench" / "mixes" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def _seed_words(seed: int) -> List[int]:
    """A seed of any size or sign as non-negative 32-bit words."""
    s = int(seed)
    words = [1 if s < 0 else 0]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            return words


def sessions(mix: Dict, seed: int) -> List[Iterator[Call]]:
    """One endless call stream per session, in slot order."""
    n = int(mix["sessions"])
    order = np.random.default_rng(_seed_words(seed)).permutation(n)
    build = SESSION_KINDS[mix["kind"]]
    out = []
    for slot in range(n):
        shape_idx = int(order[slot])
        shape_rng = np.random.default_rng([int(mix["shape_seed"]), shape_idx])
        text_rng = np.random.default_rng(_seed_words(seed) + [slot])
        out.append(_first_call_cut(build(mix, shape_idx, shape_rng, text_rng),
                                   (shape_idx + 1) / n))
    return out


def _first_call_cut(stream: Iterator[Call], share: float) -> Iterator[Call]:
    first = next(stream)
    yield dataclasses.replace(
        first, max_new_tokens=max(1, int(np.ceil(share * first.max_new_tokens))))
    yield from stream


# ---------------------------------------------------------------------------
# decision calls (the paper's cache operations)
# ---------------------------------------------------------------------------

def _key(rng) -> str:
    return f"{P.DATASETS[rng.integers(len(P.DATASETS))]}-{P.YEARS[rng.integers(len(P.YEARS))]}"


def _query(rng, keys: List[str]) -> str:
    phrases = []
    for k in keys:
        cls = P.CLASSES[rng.integers(len(P.CLASSES))]
        region = P.REGIONS[rng.integers(len(P.REGIONS))]
        phrases.append(
            [f"Plot the {cls} scenes from {k} around {region}.",
             f"How many {k} images around {region} were taken between "
             f"months {rng.integers(1, 7)} and {rng.integers(7, 13)}?",
             f"Detect {cls}s in the {k} imagery around {region}."]
            [rng.integers(3)])
    return " Then, ".join(phrases)


def _cache_json(rng, n_entries: int, full: bool) -> str:
    entries = {}
    while len(entries) < n_entries:
        k = _key(rng)
        e = {"last_access": round(float(rng.uniform(0, 4000)), 1),
             "access_count": int(rng.integers(1, 12))}
        if full:
            e["insert_order"] = int(rng.integers(0, 200))
            e["size_mb"] = round(float(rng.uniform(20, 900)), 1)
        entries[k] = e
    return json.dumps(dict(sorted(entries.items())), sort_keys=True)


def _decision_prompt(kind: str, few_shot: bool, n_entries: int, rng,
                     capacity: int) -> str:
    if kind == "read":
        keys = sorted({_key(rng) for _ in range(int(rng.integers(1, 4)))})
        return P.read_decision_prompt(_query(rng, keys), keys,
                                      _cache_json(rng, n_entries, True),
                                      few_shot)
    if kind == "update":
        loads = [_key(rng) for _ in range(int(rng.integers(1, 3)))]
        return P.update_decision_prompt(P.LRU_TEXT, loads,
                                        _cache_json(rng, n_entries, True),
                                        capacity, few_shot)
    if kind == "admission":
        return P.admission_decision_prompt(
            P.TINYLFU_COST_TEXT, _key(rng), _key(rng),
            int(rng.integers(1, 12)), int(rng.integers(1, 12)),
            _cache_json(rng, capacity, False), few_shot)
    if kind == "replication":
        top = json.dumps([{"key": _key(rng), "freq": int(rng.integers(1, 20))}
                          for _ in range(n_entries + 3)])
        return P.replication_decision_prompt(
            P.replication_text(8, 4), _key(rng), int(rng.integers(1, 20)),
            bool(rng.integers(2)), 8, 4, top, few_shot)
    raise ValueError(f"unknown decision kind {kind!r}")


def decision_session(mix: Dict, idx: int, shape_rng, text_rng) -> Iterator[Call]:
    kinds = list(mix["calls"])
    weights = np.array([mix["calls"][k] for k in kinds], dtype=float)
    few_shot = idx < round(mix["few_shot_share"] * mix["sessions"])
    lo, hi = mix["new_tokens"]
    cap = int(mix["cache_capacity"])
    lo_e, hi_e = mix["cache_entries"]
    while True:
        kind = kinds[shape_rng.choice(len(kinds), p=weights / weights.sum())]
        n_entries = int(shape_rng.integers(lo_e, hi_e + 1))
        new = int(shape_rng.integers(lo, hi + 1))
        yield Call(kind, _decision_prompt(kind, few_shot, n_entries, text_rng, cap),
                   new)


# ---------------------------------------------------------------------------
# ReAct planning rounds
# ---------------------------------------------------------------------------

def _ascii_words(rng, n_bytes: int, vocab: List[str]) -> str:
    """Seeded filler text of exactly n_bytes ASCII bytes."""
    out, size = [], 0
    while size <= n_bytes:
        w = vocab[rng.integers(len(vocab))]
        out.append(w)
        size += len(w) + 1
    return " ".join(out)[:n_bytes]


def _history_block(rng, r: int, n_bytes: int, vocab: List[str]) -> str:
    tool = P.GEO_TOOLS[rng.integers(len(P.GEO_TOOLS))]
    head = (f"\nThought {r + 1}: I need {tool} on {_key(rng)} next.\n"
            f"Action {r + 1}: {tool}(frame_{r}, \"{_key(rng)}\")\n"
            f"Observation {r + 1}: ")
    return head + _ascii_words(rng, n_bytes - len(head), vocab)


REACT_HEADER = (
    "You are a geospatial Copilot. Solve the task by interleaving Thought, "
    "Action and Observation steps. An Action calls exactly one tool.\n"
    "Tools:\n")


def react_session(mix: Dict, idx: int, shape_rng, text_rng) -> Iterator[Call]:
    few_shot = idx < round(mix["few_shot_share"] * mix["sessions"])
    mean = mix["prompt_tokens"]["few_shot" if few_shot else "zero_shot"]
    growth = int(mix["round_growth_tokens"])
    rounds = [int(k) for k in mix["rounds_per_task"]]
    shares = np.array(list(mix["rounds_per_task"].values()), dtype=float)
    mean_r = float(np.dot(rounds, shares / shares.sum()))
    first = int(round(mean - growth * (mean_r - 1) / 2))
    vocab = list(P.DATASETS) + list(P.CLASSES) + list(P.GEO_TOOLS) + [
        "tiles", "cloud", "cover", "images", "count", "month", "region",
        "frame", "scene", "bbox", "detections", "land", "stats"]
    while True:
        n_rounds = rounds[shape_rng.choice(len(rounds), p=shares / shares.sum())]
        keys = [_key(text_rng) for _ in range(n_rounds)]
        preamble = (REACT_HEADER
                    + "".join(f" - {t}(frame, ...)\n" for t in P.GEO_TOOLS)
                    + P.SYSTEM_HEADER + f"Query: {_query(text_rng, keys)}\n")
        suffix_len = len("\nThought 1:")
        # the text of round r is preamble + context + blocks[:r] + suffix,
        # exactly first + r * growth tokens with the BOS
        ctx_len = first - BOS_TOKENS - len(preamble) - suffix_len
        if ctx_len < 0:
            raise ValueError("react mix: prompt_tokens below the preamble")
        context = "Context: " + _ascii_words(text_rng, ctx_len - 9, vocab)
        blocks = [_history_block(text_rng, r, growth, vocab)
                  for r in range(n_rounds - 1)]
        for r in range(n_rounds):
            text = preamble + context + "".join(blocks[:r]) + f"\nThought {r + 1}:"
            yield Call("react", text, int(mix["new_tokens"]))


SESSION_KINDS: Dict[str, Callable[..., Iterator[Call]]] = {
    "decisions": decision_session,
    "react": react_session,
}
