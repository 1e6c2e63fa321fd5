"""The port's table and quickstart twins against the reference.

``repro_torch.launch.tables`` and ``repro_torch.launch.quickstart`` run the
port's copies of the simulator modules; their rows and printed lines must
equal ``benchmarks/tables.py``'s and ``examples/quickstart.py``'s string for
string, and the tables' digests the constants that lock the reference
(``tests/test_tables_determinism.py``, ``test_perf_scale.py``,
``test_locality.py`` and ``test_coherence.py``).
"""
import contextlib
import hashlib
import io
import pathlib
import runpy

import pytest

from benchmarks import tables as ref_tables
from repro_torch.launch import quickstart, tables
import test_coherence
import test_locality
import test_perf_scale
from repro_torch.core.coherence import MutationPlan
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


def locked(module, what):
    """The digest constant of a reference test module whose name ends in
    ``_<what>`` (each module locks one digest per table)."""
    names = [n for n in vars(module) if n.endswith("_" + what)]
    assert len(names) == 1, (module.__name__, what, names)
    return getattr(module, names[0])


# the concurrent-engine tables the reference locks by digest: (table,
# kwargs, digest), the kwargs of the reference's own locking tests
ENGINE_DIGESTS = {
    "concurrency": ("table_concurrency", {"tasks_per_session": 25},
                    locked(test_locality, "CONCURRENCY_DIGEST")),
    "prefetch": ("table_prefetch", {"tasks_per_session": 25},
                 locked(test_locality, "PREFETCH_DIGEST")),
    "admission": ("table_admission", {"tasks_per_session": 25},
                  locked(test_locality, "ADMISSION_DIGEST")),
    "replication": ("table_replication", {"tasks_per_session": 25},
                    locked(test_locality, "REPLICATION_DIGEST")),
    "belady": ("belady_bound", {"n": 200}, locked(test_locality, "BELADY_DIGEST")),
    "concurrency-no-scale": ("table_concurrency",
                             {"tasks_per_session": 25, "scale": ()},
                             locked(test_perf_scale, "CONCURRENCY_DIGEST")),
    "prefetch-fixed": ("table_prefetch", {"tasks_per_session": 25,
                                          "adaptive": False},
                       locked(test_perf_scale, "PREFETCH_DIGEST")),
    "admission-no-extras": ("table_admission", {"tasks_per_session": 25,
                                                "extras": False},
                            locked(test_perf_scale, "ADMISSION_DIGEST")),
    "belady-base": ("belady_bound", {"n": 200},
                    locked(test_perf_scale, "BELADY_DIGEST")),
    "concurrency-empty-mutations": (
        "table_concurrency", {"tasks_per_session": 25,
                              "engine_kw": {"mutations": MutationPlan()}},
        locked(test_coherence, "CONCURRENCY_DIGEST")),
    "resilience-12-empty-mutations": (
        "table_resilience", {"tasks_per_session": 12,
                             "engine_kw": {"mutations": MutationPlan()}},
        locked(test_coherence, "RESILIENCE_DIGEST_12")),
}


@pytest.mark.parametrize("case", sorted(ENGINE_DIGESTS))
def test_engine_table_reproduces_the_reference_digest(case):
    name, kw, digest = ENGINE_DIGESTS[case]
    assert _digest(getattr(tables, name)(**kw)) == digest


# the tables no reference test locks by digest: the twin's rows must equal
# the reference's string for string
UNLOCKED = {"locality": ("table_locality", {"tasks_per_session": 25}),
            "capacity": ("table_capacity", {}),
            "coherence": ("table_coherence", {}),
            "llmfault": ("table_llmfault", {}),
            "plancache": ("table_plancache", {}),
            "resilience": ("table_resilience", {"tasks_per_session": 25})}


@pytest.mark.parametrize("case", sorted(UNLOCKED))
def test_engine_table_rows_equal_the_reference(case):
    name, kw = UNLOCKED[case]
    rows = getattr(tables, name)(**kw)
    assert len(rows) > 1 and rows == getattr(ref_tables, name)(**kw)


@pytest.mark.parametrize("case", ("replication", "admission-no-extras",
                                  "resilience-12-empty-mutations"))
def test_engine_table_parallel_cells_give_the_sequential_rows(case):
    name, kw, digest = ENGINE_DIGESTS[case]
    assert _digest(getattr(tables, name)(parallel=True, **kw)) == digest


@pytest.mark.parametrize("case", ("coherence", "plancache"))
def test_unlocked_table_parallel_cells_give_the_sequential_rows(case):
    name, kw = UNLOCKED[case]
    assert getattr(tables, name)(parallel=True, **kw) == getattr(tables, name)(**kw)
