"""The readers of the program's spans (``dcache_bench/spans.py`` and the
metrics that use it) on synthetic spans over a synthetic trace, where
each reads an exact value, and in a tiny traced run on the CPU."""
import pytest

from bench_tiny import REPO, make_root
from dcache_bench import arith, harness, spans
from dcache_bench.trace import Event, Trace
from repro_torch.tracing import Span

SIZES = dict(n_layers=1, d_model=8, d_ff=16, n_heads=4, n_kv_heads=2, head_dim=4,
             vocab_size=10, tie_embeddings=True, sliding_window=None, ring=100,
             n_experts=0, top_k=0, max_batch=2)
SHARED = ("engine.queue_wait_ms", "engine.prefill_pad_share",
          "model.decode_dispatch_ms", "engine.sync_wait_ms",
          "device.idle_in_dispatch_share", "device.idle_outside_engine_share")


def span(name, i, parent, start, end, **counts):
    return Span(name, start, end, i, parent, **counts)


# the window is [0, 10,000] ns: one step that admits (10), two pure decode
# steps (20, 30); spans wholly outside the window are left out
STEPS = [
    span("engine.queue", 1, 0, -500, 1000),
    span("engine.queue", 2, 0, 3000, 12000),       # admitted after the close
    span("engine.queue", 3, 0, -2000, -50),        # outside
    span("engine.admit", 40, 0, -1000, -600, tokens=3, padded=8),
    span("engine.step", 10, 0, 1000, 4000, rows=2, admitted=1),
    span("engine.admit", 11, 10, 1000, 2500, tokens=6, padded=8),
    span("model.prefill", 12, 11, 1100, 2000),
    span("engine.sync", 13, 11, 2100, 2400),
    span("model.decode", 14, 10, 2600, 3200),
    span("engine.sync", 15, 10, 3300, 3800),
    span("engine.sync", 16, 10, 3800, 3900),
    span("engine.step", 20, 0, 4500, 7000, rows=2, admitted=0),
    span("model.decode", 21, 20, 4600, 5600),
    span("engine.sync", 22, 20, 5700, 6800),
    span("engine.sync", 23, 20, 6800, 6900),
    span("engine.step", 30, 0, 7500, 9800, rows=2, admitted=0),
    span("model.decode", 31, 30, 7600, 8200),
    span("engine.sync", 32, 30, 8300, 9500),
    span("engine.sync", 33, 30, 9500, 9600),
]
BUSY = [(1200, 1900), (2700, 3300), (4700, 5800), (7700, 8400)]
WANT = {
    "engine.queue_wait_ms": 1500e-6,
    "engine.prefill_pad_share": 25.0,
    "model.decode_dispatch_ms": (1000 + 600) / 2 * 1e-6,
    "engine.sync_wait_ms": (1100 + 100 + 1200 + 100) / 2 * 1e-6,
    # idle within model calls: 100 ns at each edge of [1100, 2000] and at
    # the start of each decode call
    "device.idle_in_dispatch_share": 100 * 500 / 10000,
    # idle outside engine.step: [0, 1000], [4000, 4500], [7000, 7500],
    # [9800, 10000]
    "device.idle_outside_engine_share": 100 * 2200 / 10000,
}


def trace(busy=BUSY, host=(), window=(0, 10000)):
    return Trace([Event("bench.window", *window)] + [Event(*h) for h in host],
                 [Event(f"op{i}", a, b, i + 1) for i, (a, b) in enumerate(busy)])


@pytest.fixture
def recorded(monkeypatch):
    got = []
    monkeypatch.setattr(spans, "take", lambda: got)
    return got


@pytest.mark.parametrize("name", SHARED)
def test_each_reader_reads_its_exact_value(recorded, name):
    recorded.extend(STEPS)
    ctx = harness.Readings(SIZES, [], [], trace())
    got = harness.load_metric(REPO, name)(ctx)
    assert got == pytest.approx(WANT[name], rel=1e-12)
    idle = harness.load_metric(REPO, "device.idle_share")(ctx)
    assert idle == pytest.approx(69.0)
    if name.startswith("device."):
        assert got <= idle


@pytest.mark.parametrize("name", SHARED + ("moe.expert_roofline",))
def test_a_reader_with_no_spans_reads_nothing(recorded, monkeypatch, name):
    read = harness.load_metric(REPO, name)
    sizes = dict(SIZES, n_experts=4, top_k=2)
    assert read(harness.Readings(sizes, [], [], trace())) is None
    assert read(harness.Readings(sizes, [], [], None)) is None
    recorded.extend(STEPS)
    assert read(harness.Readings(sizes, [], [], None)) is None
    # a program with no tracer
    monkeypatch.setattr(spans, "take", lambda: None)
    assert read(harness.Readings(sizes, [], [], trace())) is None


def test_take_tells_a_missing_tracer_from_a_broken_one(monkeypatch):
    import builtins
    import sys

    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spans.take() is None
    monkeypatch.undo()

    real = builtins.__import__

    def broken(name, *a, **k):
        if name == "repro_torch.tracing":
            raise ModuleNotFoundError("No module named 'gone'", name="gone")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", broken)
    with pytest.raises(ModuleNotFoundError):
        spans.take()


def test_a_traces_spans_are_taken_once_and_shared(monkeypatch):
    taken = []
    monkeypatch.setattr(spans, "take", lambda: taken.append(1) or list(STEPS))
    tr = trace()
    ctx = harness.Readings(SIZES, [], [], tr)
    first = spans.of(ctx)
    assert spans.of(ctx) is first and spans.of(harness.Readings(SIZES, [], [], tr)) is first
    assert len(taken) == 1 and [s.id for s in first] == [s.id for s in STEPS[:2] + STEPS[4:]]
    spans.of(harness.Readings(SIZES, [], [], trace()))
    assert len(taken) == 2


def test_expert_roofline_counts_true_routed_work(recorded):
    sizes = dict(SIZES, n_experts=4, top_k=2)
    recorded.extend([span("model.prefill", 1, 0, 50, 250),
                     span("moe.experts", 2, 1, 100, 200),
                     span("model.decode", 3, 0, 280, 450),
                     span("moe.experts", 4, 3, 300, 400)])
    host = [("cudaLaunchKernel", 60, 62, 9), ("cudaLaunchKernel", 150, 152, 1),
            ("cudaLaunchKernel", 350, 352, 2), ("cudaLaunchKernel", 500, 502, 3)]
    tr = Trace([Event("bench.window", 0, 1000)] + [Event(*h) for h in host],
               [Event("router", 590, 600, 9), Event("bmm", 600, 640, 1),
                Event("bmm", 650, 700, 2), Event("combine", 710, 800, 3)])
    steps = [harness.Step(0, 1, 2, 1, [5], [3, 4])]
    weights = 4 * 3 * 8 * 16 * arith.BF16_BYTES
    least = (arith.least_seconds(5 * 2 * 6 * 8 * 16, weights)
             + arith.least_seconds(2 * 2 * 6 * 8 * 16, weights))
    read = harness.load_metric(REPO, "moe.expert_roofline")
    decoder = harness.load_architecture(REPO, "decoder")
    got = read(harness.Readings(sizes, [], steps, tr, decoder))
    assert got == pytest.approx(100 * least / 90e-9, rel=1e-12)
    # a dense model has no experts
    assert read(harness.Readings(SIZES, [], steps, tr, decoder)) is None


def test_spans_attribute_launches_as_the_harness_ranges_do(recorded):
    recorded.extend(STEPS)
    launches = [("cudaLaunchKernel", t, t + 5, i) for i, t in
                enumerate((1150, 2650, 2700, 4650, 4660, 7650, 7700, 7710), 1)]
    host = launches + [("bench.step.admit", 990, 4010), ("bench.step.decode", 4490, 7010),
                       ("bench.step.decode", 7490, 9810)]
    tr = trace(host=host)
    pure = spans.pure_steps(spans.of(harness.Readings(SIZES, [], [], tr)))
    assert [s.id for s in pure] == [20, 30]
    merged = spans.with_ranges(tr, "engine.step.pure", pure)
    assert merged.launches_in("engine.step.pure") == tr.launches_in("bench.step.decode") == (5, 2)


def test_interval_helpers():
    ss = [span("a", 1, 0, 5, 10), span("a", 2, 0, 8, 12), span("a", 3, 0, 20, 30),
          span("a", 4, 0, -5, 2)]
    assert spans.intervals(ss, 0, 25) == [(0, 2), (5, 12), (20, 25)]
    assert spans.overlap([(0, 2), (5, 12)], [(1, 6), (11, 40)]) == 1 + 1 + 1
    assert spans.idle(trace([(0, 100), (50, 300), (9000, 10000)])) == [(300, 9000)]


@pytest.mark.parametrize("cell", ["tiny-decide", "tiny-react"])
def test_a_tiny_traced_run_reports_the_span_metrics(tmp_path, cell):
    r = harness.run(make_root(tmp_path), cell, 2 ** 33 + 5, 1.0, trace=True,
                    device="cpu")
    assert r["correct"]
    got = {harness.quantity(k): v["value"] for k, v in r["metrics"].items()}
    # no device operation on the CPU: every idle share reads the time the
    # host spent in its spans, and the expert roofline has no device time
    assert set(SHARED) <= set(got) and "moe.expert_roofline" not in got
    assert got["model.decode_dispatch_ms"] > 0 and got["engine.queue_wait_ms"] > 0
    assert 0 <= got["engine.prefill_pad_share"] < 100
    for name in ("device.idle_in_dispatch_share", "device.idle_outside_engine_share"):
        assert 0 < got[name] <= got["device.idle_share"]
