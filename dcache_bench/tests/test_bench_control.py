"""The control: the reference in the program's place one precision step
below the configuration's bf16 (every weight product in float8 e4m3) reads
far above the program, so the limits set between the two readings fail
it. On the CPU at a tiny size; on the card (``card`` marker) at each
cell's own size and load, on three seeds, against the committed limits.
"""
import json
import subprocess
import sys

import pytest
import torch

from bench_tiny import REPO, make_root
from dcache_bench import harness, judge


def test_fp8_linear_rounds_harder_than_bf16():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(64, 256, generator=g), torch.randn(256, 128, generator=g) / 16
    exact = x @ w
    bf16 = (x.bfloat16().float() @ w.bfloat16().float())
    fp8 = judge.fp8_linear(x, w)
    err = lambda y: float((y - exact).norm() / exact.norm())
    assert err(fp8) > 8 * err(bf16) > 0


def test_control_reads_far_above_the_program(tmp_path):
    # the tiny MoE cell: the tiny dense model's greedy tokens cycle so soon
    # that a sample of its calls can hold no choice the control would flip
    root = make_root(tmp_path)
    cell = harness.prepare(root, "tiny-react")
    prog, ctrl = [], []
    for seed in (1, 2, 3):
        sv = harness.serve(cell, seed, 3.0, False, "cpu", 0.0)
        sample = judge.sample(sv.finished, seed, 80)
        prog.append(judge.readings(cell.ref, cell.sizes, sv.params, sample, sv.prompts,
                                   cell.sizes["max_len"]))
        ctrl.append(judge.readings(cell.ref, cell.sizes, sv.params, sample, sv.prompts,
                                   cell.sizes["max_len"], control=True))
    for k in ("gap_mean", "miss_share"):
        low, high = max(p[k] for p in prog), min(c[k] for c in ctrl)
        assert high > 0 and high >= 3 * low
    assert all(p[k] <= v for p in prog for k, v in cell.limits.items())
    assert all(any(c[k] > v for k, v in cell.limits.items()) for c in ctrl)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["granite-decide", "mixtral-react", "mixtral-decide"])
def test_control_fails_the_committed_limits_on_the_card(card, tmp_path, cell):
    out = tmp_path / "cal.jsonl"
    subprocess.run([sys.executable, str(REPO / "dcache_bench" / "calibrate.py"),
                    "--workload", cell, "--seeds", "901,902,903", "--seconds", "15",
                    "--control", "3", "--out", str(out)], check=True, timeout=3000)
    limits = judge.load_limits(REPO, cell)
    for row in map(json.loads, out.read_text().splitlines()):
        assert all(row["program"][k] <= v for k, v in limits.items())
        assert any(row["control"][k] > v for k, v in limits.items())
