"""DeepSeek-V2 (``architectures/deepseek_v2.py``, ``reference/deepseek_v2.py``)
joins the benchmark as files alone and is served by the harness on the CPU.

- a tree without its files refuses the configuration at once; with them and
  appended entries alone, the harness serves a tiny DeepSeek cell, traced;
  the two new readers read synthetic traces exactly, and nothing where the
  program takes no ``mla.attend`` span;
- in float32 the engine's logits (prefill at the bucket, then decode steps
  of 32 rows through the latent ring, past the capped group size) are the
  reference's within 1e-4, and every served token is its best;
- the reference's capacity rule is the port's, place for place, under
  softmax-over-all top-k routing;
- a planted fault in the reference reads not correct;
- the counts at full size are frozen, and agree with the configuration's
  ``bytes_on_card`` and with the port's ``ModelConfig.param_count``;
- ``react-64`` is ``react`` with 64 sessions.
"""
import json
import shutil

import pytest
import torch

from bench_tiny import (BENCH, EVERY_CELL, REPO, TINY_LIMITS, assert_appended_only,
                        make_root)
from dcache_bench import harness, judge, program, spans
from dcache_bench.trace import Event, Trace
from repro_torch.tracing import Span

ARCH = harness.load_architecture(REPO, "deepseek_v2")
REF = judge.load_reference(REPO, "deepseek_v2")
FULL = harness.load_config(REPO, "deepseek-v2-lite")
CELL = "tiny-dsv2-react"
# the published configuration at tiny widths: 2 layers (the first dense),
# 4 heads, a latent of 32 with rope 8, 8 experts of width 32, top-3, 2 shared
TINY = dict(FULL, num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            moe_intermediate_size=32, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=8, num_experts_per_tok=3, vocab_size=300,
            serve={"max_batch": 4, "max_len": 64})
for _k in ("assumed", "bytes_on_card", "deployment", "reduced"):
    TINY.pop(_k)
FILES = (("architectures", "deepseek_v2.py"), ("reference", "deepseek_v2.py"))


def add_deepseek_cell(root, reference_text=None):
    """The DeepSeek files and a tiny cell on them, added to a tree that
    lacks them as files and appended ``configs``, ``workloads`` and
    ``per_layer`` entries alone; returns every file there was before."""
    bench = root / "dcache_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    shutil.copy(BENCH / "architectures" / "deepseek_v2.py",
                bench / "architectures" / "deepseek_v2.py")
    (bench / "reference" / "deepseek_v2.py").write_text(
        reference_text or (BENCH / "reference" / "deepseek_v2.py").read_text())
    (bench / "configs" / "tiny-dsv2.json").write_text(json.dumps(TINY))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": TINY_LIMITS["react"]}))
    accepted = json.loads((root / "BENCHMARK.json").read_text())
    spec = json.loads(json.dumps(accepted))
    spec["configs"].append({"name": "tiny-dsv2", "source": "test",
                            "file": "dcache_bench/configs/tiny-dsv2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tiny-dsv2",
                              "traffic": "tiny-react", "chips": 1, "why": "test"})
    for q in ("step_mfu", "mla.device_share", "moe.expert_device_share",
              "kernel.mla_decode_roofline"):
        spec["per_layer"].append({"name": f"{q}.{CELL}", "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "test",
                                  "moves": "calls_per_s", "workloads": [CELL]})
    assert_appended_only(accepted, spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return before


def parent_root(tmp_path):
    """A tree as the parent had it: no DeepSeek files."""
    root = make_root(tmp_path)
    for kind, name in FILES:
        (root / "dcache_bench" / kind / name).unlink()
    return root


def test_a_tree_without_the_files_refuses_the_cell(tmp_path):
    root = parent_root(tmp_path)
    add_deepseek_cell(root)
    for kind, name in FILES:
        (root / "dcache_bench" / kind / name).unlink()
    with pytest.raises(FileNotFoundError):
        harness.prepare(root, CELL)


def test_deepseek_added_as_files_alone_is_served(tmp_path):
    root = parent_root(tmp_path)
    before = add_deepseek_cell(root)
    assert {p: p.read_bytes() for p in before} == before
    cell = harness.prepare(root, CELL)
    cfg = program.model_config(cell.arch.model_fields(CELL, cell.sizes))
    assert cfg.is_mla and cfg.moe.scoring == "softmax_topk" and cfg.moe.d_expert == 32
    assert cfg.moe_layer_mask() == (False, True)
    params = cell.arch.make_params(cell.sizes, 3, "cpu")
    assert cell.arch.weight_params(cell.sizes) == sum(
        t.numel() for t in _leaves(params))
    assert cell.arch.weight_params(cell.sizes) == cfg.param_count() + cfg.d_model
    torch.manual_seed(0)
    r = harness.run(root, CELL, 3, 3.0, trace=True, device="cpu")
    assert r["correct"], r["check"]
    m = r["metrics"]
    assert m[f"step_mfu.{CELL}"]["value"] > 0
    for q in ("mla.device_share", "moe.expert_device_share", "kernel.mla_decode_roofline"):
        assert f"{q}.{CELL}" not in m          # no device time on the CPU: not read
    r = harness.run(root, CELL, 4, 1.0, trace=False, device="cpu")
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == set(EVERY_CELL)


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def fp32(**serve):
    sizes = ARCH.sizes(dict(TINY, torch_dtype="bfloat16", serve=dict(TINY["serve"], **serve)))
    return dict(sizes, dtype="float32")


def test_engine_logits_are_the_references_through_the_latent_ring():
    """32 rows at float32: each admitted by the engine (a prefill right-padded
    to its bucket, capped groups), then 6 decode steps of all 32 rows
    (32 x 3 choices, past the 64 the capacity rule never caps) through the
    latent ring; every row's logits against the reference's within 1e-4
    (absorbed decode against decompressed attention, and the port's
    kernels' plain versions against the reference's ops, sum in other
    orders)."""
    from repro_torch.models.model import decode_step
    from repro_torch.serving import ServingEngine

    sizes = fp32(max_batch=32, max_len=64)
    cfg = program.model_config(ARCH.model_fields("t", sizes))
    params = ARCH.make_params(sizes, 11, "cpu")
    eng = ServingEngine(cfg, params, max_batch=32, max_len=64, device="cpu")
    g = torch.Generator().manual_seed(2)
    prompts = ["".join(chr(97 + int(c)) for c in torch.randint(0, 26, (n,), generator=g))
               for n in torch.randint(3, 31, (32,), generator=g).tolist()]
    reqs = [eng.submit(p, 7) for p in prompts]
    first = []
    import repro_torch.serving.engine as engine_mod
    real = engine_mod.sample

    def record(logits, gen, temperature=0.0):
        first.append(logits.clone())
        return real(logits, gen, temperature=temperature)

    engine_mod.sample = record
    try:
        eng._admit()
    finally:
        engine_mod.sample = real
    logits = [[f[0]] for f in first]
    cache = eng.cache
    for _ in range(6):
        toks = torch.tensor([[r.out_ids[-1]] for r in reqs], dtype=torch.int32)
        out, cache = decode_step(cfg, params, toks, cache)
        for i, r in enumerate(reqs):
            logits[i].append(out[i, -1])
            r.out_ids.append(int(out[i, -1].argmax()))
    worst = 0.0
    for r, got in zip(reqs, logits):
        want = REF.served_logits(sizes, params, r.prompt_ids, r.out_ids, max_len=64)
        got = torch.stack(got)[:, :sizes["vocab_size"]]
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        worst = max(worst, (got - want).abs().max().item())
        assert judge.gaps(want, torch.tensor(r.out_ids)).max() < 1e-4
    assert worst > 0                    # two routes, not one


def test_capacity_and_routing_rule_equal_the_ports():
    from repro_torch.models import mlp_moe

    sizes = fp32()
    cfg = program.model_config(ARCH.model_fields("t", sizes))
    p = ARCH.make_params(sizes, 5, "cpu")["layers"][1]["moe"]
    g = torch.Generator().manual_seed(1)
    for tokens in (20, 128, 2048):
        x = (torch.randn(8, sizes["d_model"], generator=g)[
            torch.randint(0, 8, (tokens,), generator=g)]
            + 0.1 * torch.randn(tokens, sizes["d_model"], generator=g))
        T = mlp_moe.GROUP_TOKENS if tokens % mlp_moe.GROUP_TOKENS == 0 else tokens
        dispatch, combine, _ = mlp_moe._routing(p, cfg, x.reshape(tokens // T, T, -1))
        port = dispatch.sum(-1).reshape(tokens, -1) > 0
        idx, gates, kept = REF._route(x, p["router"].float(), sizes, True, REF.plain_linear)
        ref = torch.zeros_like(port)
        w = torch.zeros(port.shape)
        for k in range(idx.shape[1]):
            ref[torch.arange(tokens)[kept[:, k]], idx[kept[:, k], k]] = True
            w[torch.arange(tokens), idx[:, k]] += gates[:, k] * kept[:, k]
        assert torch.equal(port, ref)
        torch.testing.assert_close(combine.sum(-1).reshape(tokens, -1), w)
        assert (w.sum(-1) < 1).all()                     # not renormalised
        assert (~kept).any() == (tokens > 20)            # 20 x 3 <= 64: never capped
    # a decode step of 32 rows x 3 choices: the port's group is not capped,
    # and the reference's decode stream never is
    x = torch.randn(1, 32, sizes["d_model"], generator=g).expand(1, 32, -1)
    dispatch, _, _ = mlp_moe._routing(p, cfg, x.contiguous(), decode=True)
    assert dispatch.sum().item() == 32 * 3
    _, _, kept = REF._route(x[0], p["router"].float(), sizes, False, REF.plain_linear)
    assert kept.all()


def test_a_fault_in_the_reference_reads_not_correct(tmp_path):
    # the planted fault: the reference leaves out the shared experts
    text = (BENCH / "reference" / "deepseek_v2.py").read_text()
    old = ('    outs = [_swiglu(x, m["ws_gate"].float(), m["ws_up"].float(), '
           'm["ws_down"].float(),\n                    linear) for x, _ in streams]')
    assert old in text
    broken = text.replace(old, "    outs = [torch.zeros_like(x) for x, _ in streams]")
    root = parent_root(tmp_path)
    add_deepseek_cell(root, broken)
    torch.manual_seed(0)
    r = harness.run(root, CELL, 3, 3.0, trace=False, device="cpu")
    assert not r["correct"], r["check"]


# the architecture's counts at full size, frozen when it was added (the
# formulas are in its docstring)
STEPS = [harness.Step(0, 1, 64, 1, [5197, 7697], list(range(100, 8100, 125))),
         harness.Step(1, 2, 64, 0, [], list(range(7000, 7064))),
         harness.Step(2, 3, 64, 2, [5197, 7697, 8000], [0, 1, 16383, 16384, 40000])]
FROZEN = {
    "weight_params": 15706484224, "cache_bytes": 32614907904,
    "prefill_attention": (6774727680000, 3870720000),
    "mla_decode_attention": (36445040640, 1209662208),
    "expert_work": (172738215936, 28789702656),
    "model_flops": 70289124319232,
    "kernel.mla_decode_roofline": "2.35746208477612",
    "mla.device_share": "50.0",
}


def test_the_full_size_counts_are_frozen_and_match_the_configuration():
    s = ARCH.sizes(FULL)
    assert ARCH.weight_params(s) == FROZEN["weight_params"]
    assert ARCH.weight_params(s) * 2 == FULL["bytes_on_card"]["weights"]
    assert ARCH.cache_bytes(s, 64, 16384) == FROZEN["cache_bytes"]
    assert FROZEN["cache_bytes"] == FULL["bytes_on_card"]["kv_ring"]
    cfg = program.model_config(ARCH.model_fields("deepseek-v2-lite", s))
    assert cfg.param_count() + cfg.d_model == FROZEN["weight_params"]
    from repro_torch.configs import get_config
    assert program.model_config(ARCH.model_fields("deepseek-v2-lite", s)) == \
        get_config("deepseek-v2-lite")
    assert ARCH.prefill_attention(s, 7000) == FROZEN["prefill_attention"]
    assert ARCH.mla_decode_attention(s, [0, 6000, 16383, 40000]) == \
        FROZEN["mla_decode_attention"]
    assert ARCH.expert_work(s, 64) == FROZEN["expert_work"]
    assert ARCH.model_flops(s, [5197, 7697], list(range(100, 8100, 125))) == \
        FROZEN["model_flops"]


def test_the_new_readers_on_synthetic_traces(monkeypatch):
    s = ARCH.sizes(FULL)
    tr = Trace([Event("bench.window", 0, 10 ** 9)],
               [Event("mla_latent_kernel", 0, 3 * 10 ** 8),
                Event("decode_kernel<1>", 3 * 10 ** 8, 5 * 10 ** 8)])
    ctx = harness.Readings(s, [], STEPS, tr, ARCH)
    read = harness.load_metric(REPO, "kernel.mla_decode_roofline")
    assert repr(read(ctx)) == FROZEN["kernel.mla_decode_roofline"]
    got = [Span("model.prefill", 1, 2 * 10 ** 8, 1, 0),
           Span("mla.attend", 10 ** 7, 2 * 10 ** 8, 2, 1),
           Span("model.decode", 3 * 10 ** 8, 5 * 10 ** 8, 3, 0),
           Span("mla.attend", 3 * 10 ** 8, 4 * 10 ** 8, 4, 3)]
    monkeypatch.setattr(spans, "take", lambda: list(got))
    host = [Event("bench.window", 0, 10 ** 9),
            Event("cudaLaunchKernel", 5 * 10 ** 7, 5 * 10 ** 7 + 5, 1),
            Event("cudaLaunchKernel", 35 * 10 ** 7, 35 * 10 ** 7 + 5, 2),
            Event("cudaLaunchKernel", 45 * 10 ** 7, 45 * 10 ** 7 + 5, 3)]
    tr = Trace(host, [Event("mm", 10 ** 8, 3 * 10 ** 8, 1),
                      Event("mla_latent_kernel", 4 * 10 ** 8, 5 * 10 ** 8, 2),
                      Event("mm", 5 * 10 ** 8, 8 * 10 ** 8, 3)])
    read = harness.load_metric(REPO, "mla.device_share")
    assert repr(read(harness.Readings(s, [], STEPS, tr, ARCH))) == FROZEN["mla.device_share"]
    # no such span (the parent's program): nothing is read, nothing raises
    monkeypatch.setattr(spans, "take", lambda: [x for x in got if x.name != "mla.attend"])
    tr = Trace(host, list(tr.device))         # a new trace: its spans taken anew
    assert read(harness.Readings(s, [], STEPS, tr, ARCH)) is None
    # a decoder's architecture has no latent decode count
    dec = harness.load_architecture(REPO, "decoder")
    assert harness.load_metric(REPO, "kernel.mla_decode_roofline")(
        harness.Readings(s, [], STEPS, tr, dec)) is None


def test_react_64_is_react_at_64_sessions():
    react = json.loads((BENCH / "mixes" / "react.json").read_text())
    r64 = json.loads((BENCH / "mixes" / "react-64.json").read_text())
    assert r64.pop("sessions") == 64 and react.pop("sessions") == 32
    r64.pop("about"), react.pop("about")
    assert r64 == react
    assert FULL["serve"]["max_batch"] == 64
