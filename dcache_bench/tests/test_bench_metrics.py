"""The benchmark's arithmetic on synthetic inputs: the tail over censored
calls, the roofline counts, step_mfu and the trace's reductions."""
import types

import numpy as np
import pytest

from bench_tiny import REPO
from dcache_bench import arith, harness
from dcache_bench.trace import Event, Trace

DECODER = harness.load_architecture(REPO, "decoder")

SIZES = dict(n_layers=2, d_model=8, d_ff=16, n_heads=4, n_kv_heads=2, head_dim=4,
             vocab_size=10, tie_embeddings=True, sliding_window=None, ring=100,
             n_experts=0, top_k=0, max_batch=4)


def req(sub, first, fin, n_out, max_new=10):
    return types.SimpleNamespace(submitted_at=sub, first_token_at=first,
                                 finished_at=fin, out_ids=[0] * n_out,
                                 max_new_tokens=max_new)


def test_tail_counts_calls_in_flight_at_their_age():
    reqs = [req(10.0 + i, 10.1 + i, 11.0 + i, 10) for i in range(19)]
    # one call stalls: still in flight at the close, 80 s old
    reqs.append(req(20.0, 20.1, None, 3))
    loop = types.SimpleNamespace(requests=reqs + [req(5.0, 5.1, 12.0, 10)])
    e = harness.end_to_end(loop, t_open=9.0, t_close=100.0, setup_s=1.0)
    calls = [1.0] * 19 + [80.0]
    assert e["call_p95_ms"] == pytest.approx(1e3 * np.percentile(calls, 95))
    assert e["call_p95_ms"] > 1e3 * 4        # the stall raises the tail
    assert e["ttft_p95_ms"] == pytest.approx(100.0)
    tpot = [0.9 / 9] * 19 + [79.9 / 2]
    assert e["tpot_p95_ms"] == pytest.approx(1e3 * np.percentile(tpot, 95))
    # completions in the window count toward the rate, whenever submitted
    assert e["calls_per_s"] == pytest.approx(20 / 91.0)
    assert e["_calls"] == 20


def test_a_call_with_no_first_token_counts_its_wait():
    loop = types.SimpleNamespace(requests=[req(1.0, None, None, 0)])
    e = harness.end_to_end(loop, 0.5, 3.0, 0.0)
    assert e["ttft_p95_ms"] == pytest.approx(2000.0)
    assert e["tpot_p95_ms"] is None and e["calls_per_s"] == 0


def test_attention_counts():
    assert arith.causal_pairs(4) == 10
    assert arith.causal_pairs(6, window=2) == 3 + 4 * 2
    assert DECODER.decode_valid(9, ring=100) == 10
    assert DECODER.decode_valid(500, ring=100) == 100
    assert DECODER.decode_valid(500, ring=100, window=64) == 64
    f, b = DECODER.prefill_attention(SIZES, 4)
    assert f == 4 * 2 * 4 * 4 * 10
    assert b == 2 * 4 * (2 * 4 + 2 * 2) * 4 * 2
    f, b = DECODER.decode_attention(SIZES, [2, 4])      # 3 and 5 valid positions
    assert f == 4 * 2 * 4 * 4 * 8
    assert b == 2 * (8 * 2 * 2 * 4 * 2 + 2 * 2 * 4 * 4 * 2)


def test_params_from_shapes():
    # granite-3-2b: 40 x (attention 10,485,760 + FFN 50,331,648 + norms)
    # + the tied 49,408 x 2,048 embedding + the final norm
    s = DECODER.sizes(harness.load_config(REPO, "granite-3-2b"))
    assert DECODER.weight_params(s) == 2_534_049_792
    m = DECODER.sizes(harness.load_config(REPO, "mixtral-8x22b-8l"))
    assert DECODER.weight_params(m) == 20_435_146_752
    active = 2 * 8 * (2 * 6144 * 6144 + 2 * 6144 * 1024 + 2 * 3 * 6144 * 16384
                      + 6144 * 8)
    assert DECODER.matmul_flops_per_token(m) == active


def test_model_flops_and_mfu():
    mm, lg = DECODER.matmul_flops_per_token(SIZES), DECODER.logits_flops(SIZES)
    assert mm == 2 * 2 * (2 * 8 * 16 + 2 * 8 * 8 + 3 * 8 * 16)
    got = DECODER.model_flops(SIZES, [4], [4, 5])
    want = (4 * mm + lg + DECODER.attn_flops(SIZES, 10)
            + 2 * (mm + lg) + DECODER.attn_flops(SIZES, 5 + 6))
    assert got == want
    step = harness.Step(0, 1, 2, 1, [4], [4, 5])
    tr = trace_of([("k", 0, 10)], window=(0, 1_000_000_000))
    ctx = harness.Readings(SIZES, [step], [step], tr, DECODER)
    read = harness.load_metric(REPO, "step_mfu")
    assert read(ctx) == pytest.approx(100 * want / arith.PEAK_BF16_FLOPS)
    # an architecture that counts no model FLOPs leaves the metric unread
    assert read(harness.Readings(SIZES, [step], [step], tr)) is None


def trace_of(device, window=(0, 1000), host=()):
    hs = [Event("bench.window", *window)] + [Event(*h) for h in host]
    return Trace(hs, [Event(*d) for d in device])


def test_busy_idle_and_kernel_time():
    tr = trace_of([("flash_kernel_mma", 100, 200), ("gemm", 150, 300),
                   ("decode_kernel", 500, 600), ("bench.moe", 0, 1000),
                   ("late", 990, 1200)])
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx((200 + 100 + 10) / 1e9)
    assert tr.device_s("flash_kernel") == pytest.approx(100e-9)
    idle = harness.load_metric(REPO, "device.idle_share")
    assert idle(harness.Readings(SIZES, [], [], tr)) == pytest.approx(69.0)


def test_launches_and_device_time_by_host_range():
    host = [("bench.step.decode", 0, 400), ("cudaLaunchKernel", 10, 12, 1),
            ("cudaLaunchKernel", 20, 22, 2), ("bench.moe", 15, 30),
            ("bench.step.admit", 500, 900), ("cudaLaunchKernel", 600, 602, 3),
            ("cudaMemcpyAsync", 300, 310, 4), ("aten::mm", 40, 90)]
    dev = [("a", 100, 150, 1), ("b", 160, 260, 2), ("c", 700, 710, 3),
           ("memcpy", 320, 330, 4)]
    tr = trace_of(dev, host=host)
    assert tr.launches_in("bench.step.decode") == (3, 1)
    assert tr.launches_in("bench.step.admit") == (1, 1)
    assert tr.device_s_launched_in("bench.moe") == pytest.approx(100e-9)
    share = harness.load_metric(REPO, "moe.expert_device_share")
    assert share(harness.Readings(SIZES, [], [], tr)) == pytest.approx(
        100 * 100 / (50 + 100 + 10 + 10))
    # gaps labelled at their middle: (0, 100) in aten::mm, (150, 160) and
    # (260, 320) in the decode step, (330, 700) and (710, 1000) in the admit
    assert dict(tr.idle_gaps()) == pytest.approx(
        {"decode: aten::mm": 100e-9, "decode: python": 70e-9,
         "admit: python": 660e-9})


def test_rooflines_count_true_work():
    sizes = dict(SIZES, n_layers=1)
    steps = [harness.Step(0, 1, 2, 1, [1000], [1000, 10])]
    flops, nbytes = DECODER.prefill_attention(sizes, 1000)
    least = arith.least_seconds(flops, nbytes)
    ns = int(4 * least * 1e9)
    tr = trace_of([("flash_kernel_fma", 0, ns)], window=(0, 10 ** 9))
    flash = harness.load_metric(REPO, "kernel.flash_roofline")
    assert flash(harness.Readings(sizes, [], steps, tr, DECODER)) == pytest.approx(
        100 * least / (ns / 1e9))
    assert ns < 4 * least * 1e9 + 1
    f, b = DECODER.decode_attention(sizes, [1000, 10])  # the ring holds 100
    least = arith.least_seconds(f, b)
    ns = int(2 * least * 1e9)
    tr = trace_of([("decode_kernel<64>", 0, ns)], window=(0, 10 ** 9))
    dec = harness.load_metric(REPO, "kernel.decode_attention_roofline")
    assert dec(harness.Readings(sizes, [], steps, tr, DECODER)) == pytest.approx(
        100 * least / (ns / 1e9))
    # nothing to read: no value rather than 0
    empty = trace_of([], window=(0, 10 ** 9))
    assert flash(harness.Readings(sizes, [], steps, empty, DECODER)) is None
    assert dec(harness.Readings(sizes, [], steps, empty, DECODER)) is None
    # nor without an architecture to count the work
    assert flash(harness.Readings(sizes, [], steps, tr)) is None
    assert dec(harness.Readings(sizes, [], steps, tr)) is None


def test_engine_readings():
    steps = [harness.Step(0.0, 0.05, 4, 0, [], []), harness.Step(0.05, 0.15, 3, 2, [], []),
             harness.Step(0.15, 0.2, 4, 0, [], []), harness.Step(0.2, 0.3, 4, 1, [], [])]
    ctx = harness.Readings(SIZES, steps, [], None)
    assert harness.load_metric(REPO, "engine.slot_occupancy")(ctx) == pytest.approx(93.75)
    assert harness.load_metric(REPO, "engine.prefills_per_admit_step")(ctx) == 1.5
    assert harness.load_metric(REPO, "model.decode_step_ms")(ctx) == pytest.approx(50.0)
    assert harness.load_metric(REPO, "model.launches_per_decode_step")(ctx) is None
