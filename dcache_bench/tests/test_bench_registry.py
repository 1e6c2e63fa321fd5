"""BENCHMARK.json keeps to its contract, and every cell, mix, configuration,
limit and per-layer metric is a file found by name, so a new one is added
without editing any file that is there."""
import json
import re
import shutil
import subprocess
import sys
import types

import pytest

from bench_tiny import EVERY_CELL, REPO, assert_appended_only, make_root
from dcache_bench import harness, traffic

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["dcache_bench"]
    assert SPEC["command"] == ["python3", "dcache_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_list_lengths_keep_to_the_contract():
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    assert all(len(c["reduced"]) <= 16 for c in SPEC["configs"])


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("dcache_bench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(cells)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= cells
        # each cell the metric lists reports the metric it moves
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.prepare(REPO, cell)
    assert c.sizes["max_batch"] == int(c.mix["sessions"])
    assert c.limits and set(c.limits) <= {"gap_max", "gap_mean", "miss_share"}
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(SPEC, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert callable(harness.load_metric(REPO, m["name"]))
        assert m["moves"] in e2e


@pytest.mark.parametrize("q", EVERY_CELL)
def test_each_quantity_has_one_entry_for_every_cell(q):
    entries = [m for m in SPEC["end_to_end"] if m["name"] == q]
    assert len(entries) == 1 and "workloads" not in entries[0]
    assert entries[0]["bound"] == 0.25 and entries[0]["source"] == "host_clock"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_the_unsuffixed_quantities(cell):
    names = [m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")]
    assert set(EVERY_CELL) <= set(names)
    # any other entry is named for the cell and reads one of the same quantities
    for n in set(names) - set(EVERY_CELL):
        assert n.endswith(f".{cell}") and harness.quantity(n) in EVERY_CELL, n


def test_a_cell_entry_is_tighter_than_the_every_cell_one():
    # an entry named for a cell that only repeated its unsuffixed namesake's
    # bound would spend one of the 16 end_to_end places on nothing
    every = {m["name"]: m for m in SPEC["end_to_end"] if "workloads" not in m}
    for m in SPEC["end_to_end"]:
        if "workloads" in m:
            q = every[harness.quantity(m["name"])]
            assert m["bound"] < q["bound"], m["name"]
            assert (m["unit"], m["better"], m["source"]) == (q["unit"], q["better"], q["source"])


# each tiny cell and the real cell whose ``<quantity>.<cell>`` entries it takes
# (granite-decide has none: the unsuffixed entries hold it at its bound)
NAMESAKES = {"tiny-decide": None, "tiny-react": "mixtral-react",
             "tiny-moe-decide": "mixtral-decide"}


@pytest.mark.parametrize("cell", ["tiny-decide", "tiny-react", "tiny-moe-decide"])
def test_unsuffixed_metrics_equal_their_cells_namesakes(tmp_path, cell):
    root = make_root(tmp_path, cells=(("tiny-decide", "tiny-dense", "decide"),
                                      ("tiny-react", "tiny-moe", "react"),
                                      ("tiny-moe-decide", "tiny-moe", "decide")))
    r = harness.run(root, cell, 2 ** 33 + 11, 1.0, trace=False, device="cpu")
    assert r["correct"], r["check"]
    got = r["metrics"]
    real = NAMESAKES[cell]
    named = {f"{q}.{real}" for q in EVERY_CELL if q != "setup_s"} if real else set()
    assert set(got) == set(EVERY_CELL) | named
    for k in named:
        assert got[k] == got[harness.quantity(k)], k


def test_a_metric_named_for_its_cell_reads_its_quantity():
    assert harness.quantity("call_p95_ms.granite-decide") == "call_p95_ms"
    assert harness.quantity("step_mfu.mixtral-react") == "step_mfu"
    assert harness.quantity("setup_s") == "setup_s"
    read = harness.load_metric(REPO, "engine.slot_occupancy.granite-decide")
    ctx = types.SimpleNamespace(steps=[types.SimpleNamespace(active=3)],
                                sizes={"max_batch": 4})
    assert read(ctx) == 75.0
    with pytest.raises(FileNotFoundError):
        harness.load_metric(REPO, "engine.no_such.granite-decide")


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    bench = root / "dcache_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    # one new configuration, mix, limit and metric: files only, plus their
    # entries appended to configs, workloads and per_layer (none to end_to_end)
    cfg = json.loads((bench / "configs" / "tiny-dense.json").read_text())
    cfg["num_hidden_layers"] = 3
    (bench / "configs" / "tiny-dense-3l.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "mixes" / "tiny-decide.json").read_text())
    mix["new_tokens"] = [3, 5]
    (bench / "mixes" / "short-answers.json").write_text(json.dumps(mix))
    (bench / "limits" / "new-cell.json").write_text(
        json.dumps({"limits": {"gap_max": 0.5, "gap_mean": 0.05}}))
    (bench / "metrics" / "engine.steps.py").write_text(
        "def read(ctx):\n    return float(len(ctx.steps))\n")
    accepted = json.loads((root / "BENCHMARK.json").read_text())
    spec = json.loads(json.dumps(accepted))
    spec["configs"].append({"name": "tiny-dense-3l", "source": "test",
                            "file": "dcache_bench/configs/tiny-dense-3l.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "new-cell", "config": "tiny-dense-3l",
                              "traffic": "short-answers", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "engine.steps", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "engine",
                              "moves": "calls_per_s", "workloads": ["new-cell"]})
    assert_appended_only(accepted, spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    cell = harness.prepare(root, "new-cell")
    assert cell.sizes["n_layers"] == 3 and cell.mix["new_tokens"] == [3, 5]
    names = [m["name"] for m in harness.cell_metrics(spec, "new-cell", "per_layer")]
    assert "engine.steps" in names and "moe.expert_device_share" not in names
    r = harness.run(root, "new-cell", 3, 2.0, trace=True, device="cpu")
    assert r["correct"] and r["metrics"]["engine.steps"]["value"] > 0
    # untraced, it reports the end-to-end entries with no workloads key
    r = harness.run(root, "new-cell", 4, 1.0, trace=False, device="cpu")
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == set(EVERY_CELL)


def test_missing_files_are_refused(tmp_path):
    root = make_root(tmp_path)
    with pytest.raises(FileNotFoundError):
        traffic.load_mix(root, "no-such-mix")
    with pytest.raises(FileNotFoundError):
        harness.load_config(root, "no-such-config")
    with pytest.raises(FileNotFoundError):
        harness.load_metric(root, "no.such.metric")
    with pytest.raises(KeyError):
        harness.prepare(root, "no-such-cell")


def run_py(root, cwd):
    return subprocess.run([sys.executable, str(root / "dcache_bench" / "run.py"),
                           "--workload", "granite-decide", "--seed", str(2 ** 33 + 1),
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(REPO / "dcache_bench", tmp_path / "dcache_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = run_py(tmp_path, tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_run_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = run_py(REPO, REPO)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA device" in r.stderr
