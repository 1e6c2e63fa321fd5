"""The port's Tables I-III and quickstart twins against the reference.

``repro_torch.launch.tables`` and ``repro_torch.launch.quickstart`` run the
port's copies of the simulator modules; their rows and printed lines must
equal ``benchmarks/tables.py``'s and ``examples/quickstart.py``'s string for
string, and the tables' digests the constants that lock the reference
(``tests/test_tables_determinism.py``).
"""
import contextlib
import hashlib
import io
import pathlib
import runpy

import pytest

from benchmarks import tables as ref_tables
from repro_torch.launch import quickstart, tables
from test_tables_determinism import (TABLE1_N40_DIGEST, TABLE2_N30_DIGEST,
                                     TABLE3_N30_DIGEST)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = {"table1": (40, TABLE1_N40_DIGEST), "table2": (30, TABLE2_N30_DIGEST),
         "table3": (30, TABLE3_N30_DIGEST)}


def _digest(rows) -> str:
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(CASES))
def test_table_rows_equal_the_reference_and_its_digest(name):
    n, digest = CASES[name]
    rows = getattr(tables, name)(n=n)
    assert rows == getattr(ref_tables, name)(n=n)
    assert _digest(rows) == digest


@pytest.mark.parametrize("name", sorted(CASES))
def test_parallel_cells_give_the_sequential_rows(name):
    n, digest = CASES[name]
    assert _digest(getattr(tables, name)(n=n, parallel=True)) == digest


def test_table1_summary_in_paper_band():
    summary = tables.table1(n=40)[-1].split(",")
    assert summary[0] == "table1_summary" and summary[-1] == "in_paper_range=True"


@pytest.mark.parametrize("argv,sizes", (([], (300, 200)), (["--full"], (1000, 500))))
def test_tables_main_prints_each_tables_rows(monkeypatch, argv, sizes):
    """main's sizes are benchmarks/run.py's; each table is stubbed to its
    rows at a small n, so the test checks the order, sizes and flags."""
    calls = []
    for name, small in (("table1", 12), ("table2", 10), ("table3", 10)):
        def stub(n, parallel, name=name, small=small):
            calls.append((name, n, parallel))
            return getattr(ref_tables, name)(n=small)
        monkeypatch.setattr(tables, name, stub)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tables.main(argv + ["--parallel"])
    n1, n23 = sizes
    assert calls == [("table1", n1, True), ("table2", n23, True),
                     ("table3", n23, True)]
    assert out.getvalue().splitlines() == (
        ref_tables.table1(n=12) + ref_tables.table2(n=10) + ref_tables.table3(n=10))


def test_quickstart_prints_the_reference_lines():
    port, ref = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(port):
        quickstart.main()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
    assert port.getvalue() == ref.getvalue()
    assert "speedup: " in port.getvalue() and "GPT-hit rate" in port.getvalue()


def test_task_memo_is_the_ports_own():
    tables._tasks(12, 0.8)
    assert (12, 0.8, 1) in tables._TASK_MEMO
    assert tables._TASK_MEMO is not ref_tables._TASK_MEMO
    assert type(tables._TASK_MEMO[(12, 0.8, 1)][0]).__module__.startswith(
        "repro_torch.")
