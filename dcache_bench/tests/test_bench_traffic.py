"""The traffic mixes: deterministic by seed, the same sizes for every seed,
and lengths in the ranges the cells state."""
import itertools
from collections import Counter

import pytest

from dcache_bench import prompts, traffic
from bench_tiny import REPO

SEEDS = (0, 12345, 2 ** 31 + 17, 2 ** 40 + 3, -5)


def calls(name, seed, per_session=10):
    mix = traffic.load_mix(REPO, name)
    return [list(itertools.islice(s, per_session)) for s in traffic.sessions(mix, seed)]


def tokens(call):
    return len(call.prompt.encode()) + traffic.BOS_TOKENS


@pytest.mark.parametrize("name", ["decide", "react"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_calls(name, seed):
    assert calls(name, seed) == calls(name, seed)


@pytest.mark.parametrize("name", ["decide", "react"])
def test_seeds_share_sizes_not_content(name):
    a, b = calls(name, 1), calls(name, 2)
    assert a != b
    # every seed runs the same multiset of (kind, new tokens) streams
    shape = lambda ss: Counter(tuple((c.kind, c.max_new_tokens) for c in s[1:]) for s in ss)
    assert shape(a) == shape(b)
    if name == "react":
        length = lambda ss: Counter(tuple(tokens(c) for c in s) for s in ss)
        assert length(a) == length(b)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_decide_ranges(seed):
    ss = calls("decide", seed, per_session=20)
    kinds = Counter(c.kind for s in ss for c in s)
    assert set(kinds) == {"read", "update", "admission", "replication"}
    assert abs(kinds["read"] - kinds["update"]) < 0.25 * kinds["read"]
    assert kinds["replication"] < kinds["admission"] < kinds["read"]
    lens = [tokens(c) for s in ss for c in s]
    assert 1100 <= min(lens) and max(lens) <= 2600
    news = [c.max_new_tokens for s in ss for c in s[1:]]
    assert min(news) >= 89 and max(news) <= 204
    # the first calls are cut so that their replies arrive spread out
    firsts = sorted(s[0].max_new_tokens for s in ss)
    assert firsts[0] < 20 and len(set(firsts)) > 20
    assert all(c.prompt.startswith(prompts.SYSTEM_HEADER) for s in ss for c in s)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_react_ranges_and_shared_rounds(seed):
    mix = traffic.load_mix(REPO, "react")
    ss = calls("react", seed, per_session=14)
    lens = sorted({tokens(c) for s in ss for c in s})
    assert lens[0] >= 5100 and lens[-1] <= 7800 and lens[-1] < 8192
    assert all(c.max_new_tokens == 55 for s in ss for c in s[1:])
    steps = set()
    for s in ss:
        for a, b in zip(s, s[1:]):
            if tokens(b) > tokens(a):     # the next round of the same task
                assert tokens(b) - tokens(a) == mix["round_growth_tokens"]
                assert b.prompt.startswith(a.prompt[:-len("\nThought 1:")])
                steps.add(tokens(b) - tokens(a))
    assert steps == {mix["round_growth_tokens"]}
    # the few-shot half sends the longer prompts
    means = sorted(sum(tokens(c) for c in s) / len(s) for s in ss)
    assert means[-1] - means[0] > 1200


def test_react_sizes_are_the_agents_budgets():
    mix = traffic.load_mix(REPO, "react")
    assert mix["prompt_tokens"] == {"zero_shot": prompts.PLAN_PROMPT_TOKENS["react"],
                                    "few_shot": prompts.PLAN_PROMPT_TOKENS_FS["react"]}
    assert mix["new_tokens"] == prompts.PLAN_COMPLETION_TOKENS["react"]


def test_rounds_per_task_shares():
    mix = traffic.load_mix(REPO, "react")
    rounds = Counter()
    for s in traffic.sessions(mix, 9):
        n = 0
        for c in itertools.islice(s, 200):
            if c.prompt.endswith("\nThought 1:") and n:
                rounds[n] += 1
                n = 0
            n += 1
    total = sum(rounds.values())
    assert set(rounds) == {3, 4, 5}
    for r, share in mix["rounds_per_task"].items():
        assert abs(rounds[int(r)] / total - share) < 0.06
