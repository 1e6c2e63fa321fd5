"""``model.decode_replay_share`` on fixed spans over a synthetic trace: the
share of the window's pure decode steps whose ``model.decode`` span holds
a ``model.replay`` span."""
import pytest

from bench_tiny import REPO
from dcache_bench import harness, spans
from dcache_bench.trace import Event, Trace
from repro_torch.tracing import Span

SIZES = dict(n_layers=1, d_model=8, d_ff=16, n_heads=4, n_kv_heads=2, head_dim=4,
             vocab_size=10, tie_embeddings=True, sliding_window=None, ring=100,
             n_experts=0, top_k=0, max_batch=2)

# the window is [0, 10,000] ns: a step that admits (10) and two pure decode
# steps (20, 30), each with its model.decode span (14, 21, 31)
STEPS = [
    Span("engine.step", 1000, 4000, 10, 0, rows=2, admitted=1),
    Span("engine.admit", 1000, 2500, 11, 10, tokens=6, padded=8),
    Span("model.prefill", 1100, 2000, 12, 11),
    Span("model.decode", 2600, 3200, 14, 10),
    Span("engine.step", 4500, 7000, 20, 0, rows=2, admitted=0),
    Span("model.decode", 4600, 5600, 21, 20),
    Span("engine.step", 7500, 9800, 30, 0, rows=2, admitted=0),
    Span("model.decode", 7600, 8200, 31, 30),
]


def replay(i, decode, start):
    return Span("model.replay", start, start + 50, i, decode)


def trace():
    return Trace([Event("bench.window", 0, 10000)], [Event("op", 4700, 5800, 1)])


@pytest.fixture
def recorded(monkeypatch):
    got = []
    monkeypatch.setattr(spans, "take", lambda: got)
    return got


@pytest.fixture
def read():
    return harness.load_metric(REPO, "model.decode_replay_share")


@pytest.mark.parametrize("replays, want", [
    ([replay(22, 21, 4700), replay(32, 31, 7700)], 100.0),
    ([replay(32, 31, 7700)], 50.0),
    ([], 0.0),
    # a replay in the admitting step is no pure decode step's
    ([replay(15, 14, 2700)], 0.0),
], ids=["every", "half", "none", "admitting-only"])
def test_share_of_pure_steps_replayed(recorded, read, replays, want):
    recorded.extend(STEPS + replays)
    assert read(harness.Readings(SIZES, [], [], trace())) == pytest.approx(want)


def test_no_spans_or_no_pure_step_reads_nothing(recorded, monkeypatch, read):
    assert read(harness.Readings(SIZES, [], [], trace())) is None
    assert read(harness.Readings(SIZES, [], [], None)) is None
    recorded.extend(STEPS[:4])        # the admitting step alone
    assert read(harness.Readings(SIZES, [], [], trace())) is None
    monkeypatch.setattr(spans, "take", lambda: None)    # a program with no tracer
    assert read(harness.Readings(SIZES, [], [], trace())) is None
