"""The port's benchmark driver and multi-pod example against the reference.

``repro_torch.launch.run --skip-serving`` must print the rows of
``benchmarks.run --skip-jax`` and write the same record (sections, their
sizes and the summary; ``args.skip_serving`` in place of ``args.skip_jax``).
``repro_torch.launch.multi_pod_cache`` must print exactly
``examples/multi_pod_cache.py``'s lines. Without ``--skip-serving`` the
driver follows the device rule: ``cuda`` unless ``--device cpu``, and no
CUDA raises before any table runs.
"""
import contextlib
import io
import json
import pathlib
import runpy
import sys

import pytest
import torch

from benchmarks import run as ref_run
from benchmarks import tables as ref_tables
from repro_torch.launch import multi_pod_cache, run, serving_bench, tables

ROOT = pathlib.Path(__file__).resolve().parents[1]
TABLES = ("table1", "table2", "table3", "table_concurrency", "table_prefetch",
          "table_admission", "table_replication", "table_locality",
          "table_resilience", "table_capacity", "table_coherence",
          "table_llmfault", "table_plancache", "belady_bound")


def _rows(text):
    """Printed lines without the ones that carry wall times."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("## ") and not ln.startswith("# done")]


def _ref_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["benchmarks.run"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_run.main()
    return out.getvalue()


def _port_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run.main(argv)
    return out.getvalue()


def test_driver_equals_the_reference(tmp_path, monkeypatch):
    ref_json, port_json = tmp_path / "ref.json", tmp_path / "port.json"
    ref_out = _ref_main(["--skip-jax", "--json", str(ref_json)], monkeypatch)
    port_out = _port_main(["--skip-serving", "--json", str(port_json)])
    assert _rows(port_out)[:-1] == _rows(ref_out)[:-1]     # but "# wrote PATH"
    ref, port = (json.loads(p.read_text()) for p in (ref_json, port_json))
    assert port.keys() == ref.keys() and port["schema"] == ref["schema"]
    assert ([(s["id"], s["name"], s["n_rows"]) for s in port["sections"]]
            == [(s["id"], s["name"], s["n_rows"]) for s in ref["sections"]])
    assert port["summary"] == ref["summary"]
    assert all(v is not None for v in port["summary"].values())
    ref_args = dict(ref["args"], skip_serving=ref["args"].pop("skip_jax"))
    assert port["args"] == ref_args


def _stub_tables(monkeypatch, module, calls):
    for name in TABLES:
        def stub(name=name, **kw):
            calls.append((name, kw))
            return [f"stub_{name},header", f"stub_{name},1"]
        monkeypatch.setattr(module, name, stub)


@pytest.mark.parametrize("argv", ([], ["--pr3-grid"], ["--full", "--parallel"]))
def test_driver_calls_each_table_as_the_reference(argv, monkeypatch):
    """Every table stubbed in both packages: the same tables, in the same
    order, with the same sizes and flags, and the same printed rows."""
    ref_calls, port_calls = [], []
    _stub_tables(monkeypatch, ref_tables, ref_calls)
    _stub_tables(monkeypatch, tables, port_calls)
    ref_out = _ref_main(argv + ["--skip-jax"], monkeypatch)
    port_out = _port_main(argv + ["--skip-serving"])
    assert port_calls == ref_calls and len(port_calls) >= 7
    assert _rows(port_out) == _rows(ref_out)


def test_driver_without_skip_serving_raises_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    calls = []
    _stub_tables(monkeypatch, tables, calls)
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main([])
    assert calls == []


def test_driver_serving_sections_on_cpu(tmp_path, monkeypatch):
    """``--device cpu`` runs the serving and cache-op sections on the CPU
    and leaves out the kernel section (a CPU time is no kernel time);
    ``--profile`` records the port's counters."""
    calls = []
    _stub_tables(monkeypatch, tables, calls)
    seen = []
    monkeypatch.setattr(serving_bench, "bench_serving",
                        lambda device: seen.append(device) or ["bench,metric,value"])
    monkeypatch.setattr(serving_bench, "bench_kernels",
                        lambda device: pytest.fail("kernels timed off the card"))
    path = tmp_path / "cpu.json"
    out = _port_main(["--device", "cpu", "--profile", "--json", str(path)])
    rec = json.loads(path.read_text())
    ids = [s["id"] for s in rec["sections"]]
    assert ids[-2:] == ["serving", "cache_ops"] and "kernels" not in ids
    assert [str(d) for d in seen] == ["cpu"]
    assert rec["args"]["skip_serving"] is False
    assert "cache_ops,us_per_call," in out
    assert set(rec["profile"]) == set(ids) | {"cumulative"}


def test_bench_cache_ops_row():
    row, = serving_bench.bench_cache_ops(n=2_000)
    name, metric, us = row.split(",")
    assert (name, metric) == ("cache_ops", "us_per_call") and float(us) > 0


def test_multi_pod_cache_prints_the_reference_lines():
    port, ref = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(port):
        multi_pod_cache.main()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(str(ROOT / "examples" / "multi_pod_cache.py"),
                       run_name="__main__")
    assert port.getvalue() == ref.getvalue()
    assert "--- killing pod" in port.getvalue()
