"""Each configuration names its architecture (``architectures/<name>.py``):
the decoder's weights, ``ModelConfig`` and work counts are what they were
before architectures were files of their own, and an architecture the
decoder cannot build joins a tree as files alone."""
import hashlib
import json
import shutil

import pytest
import torch

from bench_tiny import (BENCH, EVERY_CELL, REPO, TINY_CONFIGS, TINY_LIMITS,
                        assert_appended_only, make_root)
from dcache_bench import harness, program, spans
from dcache_bench.trace import Event, Trace
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.tracing import Span

DECODER = harness.load_architecture(REPO, "decoder")
QK_NORM = BENCH / "tests" / "qk_norm"


def digest(params) -> str:
    """sha256 over every leaf's name, shape and bits, in key order."""
    h = hashlib.sha256()

    def walk(x, key):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{key}/{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{key}/{i}")
        else:
            h.update(key.encode())
            h.update(str(tuple(x.shape)).encode())
            h.update(x.contiguous().view(torch.int16).numpy().tobytes())
    walk(params, "")
    return h.hexdigest()


# frozen from weights.make_params as it was before architectures were files
PARENT_DIGESTS = {
    ("tiny-dense", 5): "5b20fc8ba8bcab5c2e2e0a0ca415f5067d801409d759393e4868e23d39329954",
    ("tiny-dense", 2 ** 33 + 7): "dd705585dfc51ecbb09606ca50d0c747070995e5c640af53bd1940dc4f328422",
    ("tiny-moe", 5): "2edb4ee77a228a416c3bf13dafcae49843b76cf91b46c807dddc7508dd59a03b",
    ("tiny-moe", 2 ** 33 + 7): "a81226d42a9c345d0fd38e0b474f0d941d45e535c18a96f5cdcf19a7a95f7a99",
}


@pytest.mark.parametrize("name,seed", sorted(PARENT_DIGESTS))
def test_the_decoders_weights_are_the_parents(name, seed):
    sizes = DECODER.sizes(TINY_CONFIGS[name])
    assert digest(DECODER.make_params(sizes, seed, "cpu")) == PARENT_DIGESTS[name, seed]


def parent_model_config(name, s):
    """The ModelConfig the benchmark built before architectures were files."""
    moe = (MoEConfig(n_experts=s["n_experts"], top_k=s["top_k"], interleave=1)
           if s.get("n_experts") else None)
    return ModelConfig(
        name=name, family=s["family"], n_layers=s["n_layers"], d_model=s["d_model"],
        n_heads=s["n_heads"], n_kv_heads=s["n_kv_heads"], d_ff=s["d_ff"],
        vocab_size=s["vocab_size"], head_dim=s["head_dim"], rope_theta=s["rope_theta"],
        sliding_window=s.get("sliding_window"), moe=moe, norm_eps=s["norm_eps"],
        tie_embeddings=s["tie_embeddings"], dtype=s["dtype"])


def config(name):
    return TINY_CONFIGS[name] if name in TINY_CONFIGS else harness.load_config(REPO, name)


@pytest.mark.parametrize("name", ["granite-3-2b", "mixtral-8x22b-8l", "tiny-dense", "tiny-moe"])
def test_the_decoders_model_config_is_the_parents(name):
    cfg = config(name)
    assert cfg["architecture"] == "decoder"
    s = DECODER.sizes(cfg)
    got = program.model_config(DECODER.model_fields(name, s))
    assert got == parent_model_config(name, s)
    assert isinstance(got.moe, MoEConfig) is bool(s["n_experts"])


def test_model_config_takes_nested_dataclasses_by_their_declared_type():
    fields = DECODER.model_fields("t", DECODER.sizes(TINY_CONFIGS["tiny-moe"]))
    fields["moe"] = dict(fields["moe"], n_shared_experts=1)
    assert program.model_config(fields).moe == MoEConfig(4, 2, 1, 1)
    with pytest.raises(TypeError):
        program.model_config(dict(fields, no_such_field=1))
    with pytest.raises(TypeError):
        program.model_config(dict(fields, n_layers={"x": 1}))


# the readers on fixed traced steps, as the benchmark read them before
# architectures were files (repr of each value)
PARENT_READINGS = {
    "granite-3-2b": {
        "weight_params": 2534049792, "cache_bytes": 10737418240,
        "kernel.flash_roofline": "8.72866175784294",
        "kernel.decode_attention_roofline": "2.5538376597014927",
        "step_mfu": "14.760488877168857", "moe.expert_roofline": "None"},
    "mixtral-8x22b-8l": {
        "weight_params": 20435146752, "cache_bytes": 17179869184,
        "kernel.flash_roofline": "5.237197054705764",
        "kernel.decode_attention_roofline": "1.539381951044776",
        "step_mfu": "29.19649210256178", "moe.expert_roofline": "91.70096762424738"},
}
STEPS = [harness.Step(0, 1, 32, 1, [1164, 2537], list(range(100, 4100, 125))),
         harness.Step(1, 2, 32, 0, [], list(range(7000, 7032))),
         harness.Step(2, 3, 32, 2, [5197, 7697, 8000], [0, 1, 4095, 4096, 16383])]


@pytest.mark.parametrize("name", sorted(PARENT_READINGS))
def test_the_decoders_counts_and_readings_are_the_parents(name, monkeypatch):
    want = PARENT_READINGS[name]
    s = DECODER.sizes(harness.load_config(REPO, name))
    assert DECODER.weight_params(s) == want["weight_params"]
    assert DECODER.cache_bytes(s, s["max_batch"], s["max_len"]) == want["cache_bytes"]
    tr = Trace([Event("bench.window", 0, 10 ** 9)],
               [Event("flash_kernel_x", 0, 3 * 10 ** 8),
                Event("decode_kernel<1>", 3 * 10 ** 8, 5 * 10 ** 8)])
    ctx = harness.Readings(s, [], STEPS, tr, DECODER)
    for m in ("kernel.flash_roofline", "kernel.decode_attention_roofline", "step_mfu"):
        assert repr(harness.load_metric(REPO, m)(ctx)) == want[m], m
    got = [Span("model.prefill", 1, 2 * 10 ** 8, 1, 0),
           Span("moe.experts", 10 ** 7, 2 * 10 ** 8, 2, 1),
           Span("model.decode", 3 * 10 ** 8, 5 * 10 ** 8, 3, 0),
           Span("moe.experts", 3 * 10 ** 8, 4 * 10 ** 8, 4, 3)]
    monkeypatch.setattr(spans, "take", lambda: list(got))
    host = [Event("bench.window", 0, 10 ** 9),
            Event("cudaLaunchKernel", 5 * 10 ** 7, 5 * 10 ** 7 + 5, 1),
            Event("cudaLaunchKernel", 35 * 10 ** 7, 35 * 10 ** 7 + 5, 2)]
    tr = Trace(host, [Event("bmm", 10 ** 8, 3 * 10 ** 8, 1),
                      Event("bmm", 4 * 10 ** 8, 5 * 10 ** 8, 2)])
    read = harness.load_metric(REPO, "moe.expert_roofline")
    assert repr(read(harness.Readings(s, [], STEPS, tr, DECODER))) == want["moe.expert_roofline"]


def test_an_unknown_architecture_is_refused(tmp_path):
    root = make_root(tmp_path)
    p = root / "dcache_bench" / "configs" / "tiny-dense.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), architecture="no-such")))
    with pytest.raises(FileNotFoundError):
        harness.prepare(root, "tiny-decide")
    with pytest.raises(FileNotFoundError):
        harness.load_architecture(root, "no-such")


CELL = "tiny-qk-decide"


def add_qk_norm_cell(root, reference_text=None):
    """The qk-norm decoder and a cell on it, added to ``root`` as files and
    appended ``configs``, ``workloads`` and ``per_layer`` entries alone (no
    ``end_to_end`` entry: the cell reports the unsuffixed ones); returns
    every file there was before, with its bytes."""
    bench = root / "dcache_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    shutil.copy(QK_NORM / "architecture.py", bench / "architectures" / "qk_norm_decoder.py")
    (bench / "reference" / "qk_norm_decoder.py").write_text(
        reference_text or (QK_NORM / "reference.py").read_text())
    cfg = dict(TINY_CONFIGS["tiny-dense"], architecture="qk_norm_decoder",
               reference="qk_norm_decoder")
    (bench / "configs" / "tiny-qk-norm.json").write_text(json.dumps(cfg))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": TINY_LIMITS["decide"]}))
    accepted = json.loads((root / "BENCHMARK.json").read_text())
    spec = json.loads(json.dumps(accepted))
    spec["configs"].append({"name": "tiny-qk-norm", "source": "test",
                            "file": "dcache_bench/configs/tiny-qk-norm.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tiny-qk-norm",
                              "traffic": "tiny-decide", "chips": 1, "why": "test"})
    for q in ("step_mfu", "engine.slot_occupancy", "kernel.flash_roofline"):
        spec["per_layer"].append({"name": f"{q}.{CELL}", "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "test",
                                  "moves": "calls_per_s", "workloads": [CELL]})
    assert_appended_only(accepted, spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return before


def test_an_architecture_added_as_files_alone_is_served(tmp_path):
    root = make_root(tmp_path)
    before = add_qk_norm_cell(root)
    assert {p: p.read_bytes() for p in before} == before
    cell = harness.prepare(root, CELL)
    fields = cell.arch.model_fields(CELL, cell.sizes)
    assert program.model_config(fields).qk_norm
    # the decoder's files could build neither its ModelConfig nor its weights
    assert not program.model_config(DECODER.model_fields(CELL, cell.sizes)).qk_norm
    params = cell.arch.make_params(cell.sizes, 3, "cpu")
    assert "q_norm" in params["layers"][0]["attn"]
    assert cell.arch.weight_params(cell.sizes) == sum(t.numel() for t in _leaves(params))
    torch.manual_seed(0)
    r = harness.run(root, CELL, 3, 3.0, trace=True, device="cpu")
    assert r["correct"], r["check"]
    assert r["metrics"][f"step_mfu.{CELL}"]["value"] > 0
    assert f"kernel.flash_roofline.{CELL}" not in r["metrics"]    # no flash kernel on the CPU
    # untraced, the cell reports the end-to-end entries with no workloads key
    r = harness.run(root, CELL, 4, 1.0, trace=False, device="cpu")
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == set(EVERY_CELL)
    assert all(v["value"] > 0 for v in r["metrics"].values())


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def test_a_fault_in_the_added_reference_reads_not_correct(tmp_path):
    # the planted fault: the reference leaves out the q and k norms (with
    # their gains, whose 0.1 spread alone flips no greedy token on some seeds)
    text = (QK_NORM / "reference.py").read_text()
    broken = text
    for x in "qk":
        broken = broken.replace(
            f'{x} = base._rms(linear(h, a["w{x}"]).view(S, -1, hd), a["{x}_norm"], eps)',
            f'{x} = linear(h, a["w{x}"]).view(S, -1, hd)')
    assert 'a["q_norm"]' not in broken and 'a["k_norm"]' not in broken
    root = make_root(tmp_path)
    add_qk_norm_cell(root, broken)
    torch.manual_seed(0)
    r = harness.run(root, CELL, 3, 3.0, trace=False, device="cpu")
    assert not r["correct"], r["check"]
