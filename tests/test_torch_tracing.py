"""The port's tracer (``repro_torch.tracing``) and the spans the serving
engine and the expert layer take with it, on tiny engines on the CPU.

Off, a span is one shared no-op context (no clock call, no record) and
the served tokens are those of a traced run. Under the profiler, the span
tree follows the engine's calls, one call's queue wait ends where its
admission starts and its prefill and first-token sync nest in that
admission, the counts are the engine's own, and the spans sit on kineto's
clock: the operations kineto records inside a decode step fall inside
that step's ``model.decode`` span.
"""
import dataclasses
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as engine_mod

PROMPTS = ("alpha", "a much longer prompt about satellites", "geo",
           "the fourth request, queued behind the others", "five")
SLACK_NS = 50_000
PARENTS = {"engine.step": {None}, "engine.queue": {None},
           "engine.admit": {"engine.step"}, "model.prefill": {"engine.admit"},
           "model.decode": {"engine.step"},
           "engine.sync": {"engine.admit", "engine.step"}}


@pytest.fixture(autouse=True)
def clear():
    tracing.take()
    yield
    tracing.take()


def make_engine(arch="dcache-agent-150m", max_batch=2, max_len=64, **kw):
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=512,
                              dtype="float32", **kw)
    params = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    return ServingEngine(cfg, params, max_batch=max_batch, max_len=max_len,
                         device="cpu")


def serve(eng, prompts=PROMPTS, new=4):
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_done()
    return [r.out_ids for r in reqs]


def by_id(spans):
    return {s.id: s for s in spans}


def test_off_records_nothing_and_serves_the_same_tokens():
    assert not torch.autograd._profiler_enabled()
    off = serve(make_engine())
    assert tracing.records() == [] and tracing.dropped() == 0
    with tracing.recording():
        on = serve(make_engine())
    assert on == off
    names = {s.name for s in tracing.take()}
    assert names == set(PARENTS)
    assert serve(make_engine()) == off and tracing.records() == []


def test_off_path_is_one_shared_context_with_no_clock_call(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read while tracing is off")

    monkeypatch.setattr(tracing.time, "time_ns", no_clock)
    ctxs = {id(tracing.span("engine.step")),
            id(tracing.span("engine.admit", tokens=3, padded=8))}
    assert ctxs == {id(tracing.OFF)}
    with tracing.span("engine.step") as s:
        s.rows = 1
    tracing.record("engine.queue", 123.0)
    assert tracing.records() == []


def test_span_tree_rids_and_counts_under_the_profiler():
    eng = make_engine(max_batch=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        submitted = time.time_ns()
        reqs = [eng.submit(p, max_new_tokens=4) for p in PROMPTS]
        eng.run_until_done()
    spans = tracing.take()
    ids = by_id(spans)
    for s in spans:
        assert s.start <= s.end
        parent = ids.get(s.parent)
        assert (parent.name if parent else None) in PARENTS[s.name], s
        if parent:
            assert parent.start <= s.start and s.end <= parent.end
    # the program emits no profiler range: kineto knows none of the names
    assert not {e.name() for e in prof.profiler.kineto_results.events()} & set(PARENTS)

    # calls are admitted in the order they were submitted
    def ordered(name):
        return sorted((s for s in spans if s.name == name), key=lambda s: s.start)

    queued, admits = ordered("engine.queue"), ordered("engine.admit")
    assert len(queued) == len(admits) == len(reqs)
    for r, queue, admit in zip(reqs, queued, admits):
        assert submitted - SLACK_NS <= queue.start <= queue.end <= admit.start
        kids = sorted(s.name for s in spans if s.parent == admit.id)
        assert kids == ["engine.sync", "model.prefill"]
        n = len(r.prompt_ids)
        assert admit.tokens == n
        assert admit.padded - admit.tokens == eng._prefill_len(n) - n

    steps = [s for s in spans if s.name == "engine.step"]
    assert len(steps) == eng.steps
    assert sum(s.admitted for s in steps) == eng.prefills == len(PROMPTS)
    # each row decoded in a step gave its call one token past the first
    assert sum(s.rows for s in steps) == sum(len(r.out_ids) - 1 for r in reqs)
    for st in steps:
        kids = [s for s in spans if s.parent == st.id]
        assert sum(k.name == "engine.admit" for k in kids) == st.admitted
        dec = [k for k in kids if k.name == "model.decode"]
        assert len(dec) == 1 and 0 < st.rows <= eng.max_batch
        assert sum(k.name == "engine.sync" for k in kids) == 2


def test_spans_share_the_profilers_clock(monkeypatch):
    real = engine_mod.decode_step

    def decode(*a, **k):
        with record_function("test.decode"):
            return real(*a, **k)

    monkeypatch.setattr(engine_mod, "decode_step", decode)
    eng = make_engine(max_batch=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(eng, PROMPTS[:2], new=6)
    spans = tracing.take()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    ranges = sorted((e for e in events if e[0] == "test.decode"), key=lambda e: e[1])
    ids = by_id(spans)
    decodes = sorted((s for s in spans if s.name == "model.decode"),
                     key=lambda s: s.start)
    assert len(ranges) == len(decodes) == eng.steps
    pure = [(s, r) for s, r in zip(decodes, ranges)
            if ids[s.parent].admitted == 0]
    assert len(pure) >= 3
    for s, (_, a, b) in pure:
        assert s.start - SLACK_NS <= a and b <= s.end + SLACK_NS
        ops = [e for e in events if e[0].startswith("aten::") and a <= e[1] <= b]
        assert ops
        for _, oa, ob in ops:
            assert s.start - SLACK_NS <= oa and ob <= s.end + SLACK_NS


def test_moe_records_the_experts_once_per_layer_call():
    eng = make_engine("mixtral-8x22b", max_batch=2, n_layers=2)
    with tracing.recording():
        serve(eng, PROMPTS[:3], new=3)
    spans = tracing.take()
    ids = by_id(spans)
    experts = [s for s in spans if s.name == "moe.experts"]
    models = [s for s in spans if s.name in ("model.prefill", "model.decode")]
    layers = sum(eng.cfg.moe_layer_mask())
    assert layers == 2 and len(experts) == layers * len(models)
    for s in experts:
        model = ids[s.parent]
        assert model.name in ("model.prefill", "model.decode")
        assert model.start <= s.start and s.end <= model.end
    for m in models:
        assert sum(s.parent == m.id for s in experts) == layers


def test_bounded_records_count_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    with tracing.recording():
        for i in range(5):
            with tracing.span("engine.admit", tokens=i):
                pass
    assert [s.tokens for s in tracing.records()] == [0, 1, 2]
    assert tracing.dropped() == 2
    assert len(tracing.take()) == 3
    assert tracing.records() == [] and tracing.dropped() == 0


def test_threads_keep_their_own_parents_and_lose_no_record(monkeypatch):
    """More threads than cores, switching often: each thread's spans nest
    under its own, and every span is kept or counted as dropped."""
    threads_n, pairs = 16, 200
    monkeypatch.setattr(tracing, "LIMIT", threads_n * pairs)   # half are dropped
    barrier = threading.Barrier(threads_n)

    def work(i):
        barrier.wait(timeout=30)
        for _ in range(pairs):
            with tracing.span("engine.step") as step:
                step.rows = i
                with tracing.span("model.decode") as decode:
                    decode.rows = i

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tracing.dropped() == threads_n * pairs
    spans = tracing.take()
    assert len(spans) == threads_n * pairs
    ids = by_id(spans)
    for s in spans:
        if s.name == "engine.step":
            assert s.parent == 0
        elif s.parent in ids:
            assert ids[s.parent].name == "engine.step" and ids[s.parent].rows == s.rows
