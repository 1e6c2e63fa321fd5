"""A copy of the benchmark's tree with tiny cells, for tests on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_CONFIGS = {
    "tiny-dense": {
        "source": "test", "family": "dense", "num_hidden_layers": 2,
        "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 300,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "hidden_act": "silu",
        "tie_word_embeddings": True, "torch_dtype": "bfloat16",
        "serve": {"max_batch": 4, "max_len": 32}, "reference": "decoder",
        "architecture": "decoder"},
    "tiny-moe": {
        "source": "test", "family": "moe", "num_hidden_layers": 2,
        "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 300,
        "rope_theta": 1e6, "rms_norm_eps": 1e-5, "hidden_act": "silu",
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "sliding_window": None, "num_local_experts": 4, "num_experts_per_tok": 2,
        "serve": {"max_batch": 4, "max_len": 32}, "reference": "decoder",
        "architecture": "decoder"},
}


# limits between the tiny cells' sound runs and their planted faults on the
# CPU (sound: gap_max <= 0.012 dense, gap_mean <= 0.0082 and miss_share <= 5%
# MoE; the faults of test_bench_faults read gap_max >= 0.486, gap_mean >=
# 0.0268 dense, gap_mean >= 0.356 and miss_share >= 20% MoE), compared as the
# full-size cells compare theirs
TINY_LIMITS = {"decide": {"gap_max": 0.2, "gap_mean": 0.01},
               "react": {"gap_mean": 0.05, "miss_share": 12.0}}


# the end-to-end quantities every cell reports: one entry each with no
# ``workloads`` key, so a cell added with no end_to_end entry reports them
EVERY_CELL = ("call_p95_ms", "ttft_p95_ms", "tpot_p95_ms", "calls_per_s", "setup_s")


def assert_appended_only(accepted: dict, spec: dict) -> None:
    """``spec`` differs from ``accepted`` only by entries appended to its
    lists, and its ``end_to_end`` not at all: how a cell joins as files
    alone."""
    assert set(spec) == set(accepted)
    assert spec["end_to_end"] == accepted["end_to_end"]
    for key, value in accepted.items():
        if isinstance(value, list):
            assert spec[key][:len(value)] == value, key
        else:
            assert spec[key] == value, key


def tiny_mix(name: str) -> dict:
    mix = json.loads((BENCH / "mixes" / f"{name}.json").read_text())
    mix.update(sessions=4, trace_seconds=0.5, check_tokens=80)
    if mix["kind"] == "decisions":
        mix["new_tokens"] = [6, 14]
    else:
        mix["new_tokens"] = 16
    return mix


def make_root(tmp: Path, cells=(("tiny-decide", "tiny-dense", "decide"),
                                ("tiny-react", "tiny-moe", "react"))) -> Path:
    """A checkout-like root: the benchmark's files, the program's sources
    and a BENCHMARK.json whose cells are ``cells`` on tiny configurations."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "dcache_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    family = {c["name"]: json.loads((REPO / c["file"]).read_text())["family"]
              for c in spec["configs"]}
    # a real cell's metrics go to the tiny cell of its traffic and family
    kind_of = {w["name"]: (w["traffic"], family[w["config"]]) for w in spec["workloads"]}
    spec["configs"] = [{"name": n, "source": "test", "file": f"dcache_bench/configs/{n}.json",
                        "reduced": [], "why": "test"} for n in TINY_CONFIGS]
    for n, c in TINY_CONFIGS.items():
        (root / "dcache_bench" / "configs" / f"{n}.json").write_text(json.dumps(c))
    spec["workloads"] = []
    for cell, cfg, mix in cells:
        (root / "dcache_bench" / "mixes" / f"tiny-{mix}.json").write_text(
            json.dumps(tiny_mix(mix)))
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": f"tiny-{mix}",
                                  "chips": 1, "why": "test"})
        (root / "dcache_bench" / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": TINY_LIMITS[mix]}))
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if "workloads" in m:
                kinds = {kind_of[w] for w in m["workloads"]}
                m["workloads"] = [c for c, cfg, mix in cells
                                  if (mix, TINY_CONFIGS[cfg]["family"]) in kinds]
        spec[kind] = [m for m in spec[kind] if m.get("workloads", True)]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
