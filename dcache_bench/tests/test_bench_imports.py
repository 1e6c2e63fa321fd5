"""No module the benchmark loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; ``repro_torch`` is compared as a
whole name and is not it), and the reference loads nothing of the
program."""
import json
import re
import subprocess
import sys

from bench_tiny import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_top_levels(code: str) -> set:
    prelude = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n")
    tail = "\nprint(__import__('json').dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", prelude + code + tail], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_and_program_load_no_jax():
    names = loaded_top_levels(
        "from dcache_bench import harness, program, judge, calibrate\n"
        "import dcache_bench.run\n"
        "from pathlib import Path\n"
        "root = Path(harness.__file__).parents[1]\n"
        "spec = harness.load_spec(root)\n"
        "[harness.load_metric(root, m['name']) for m in spec['per_layer']]\n"
        "[harness.prepare(root, w['name']) for w in spec['workloads']]\n"
        "from repro_torch.serving import engine\n"
        "from repro_torch.kernels import ops\n")
    assert "repro_torch" in names and "dcache_bench" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_top_levels(
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('r', {str(BENCH / 'reference' / 'decoder.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n")
    assert "torch" in names
    assert not names & (FORBIDDEN | {"repro_torch", "dcache_bench"})


def test_no_source_under_the_benchmark_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)(\s|\.|$)", re.M)
    for p in BENCH.rglob("*.py"):
        assert not pat.search(p.read_text()), p
    ref = re.compile(r"^\s*(import|from)\s+(repro_torch|dcache_bench)", re.M)
    for p in (BENCH / "reference").rglob("*.py"):
        assert not ref.search(p.read_text()), p


def test_no_architecture_loads_the_program_or_jax():
    archs = sorted((BENCH / "architectures").glob("*.py")) + [
        BENCH / "tests" / "qk_norm" / "architecture.py"]
    names = loaded_top_levels(
        "import importlib.util\n"
        f"for i, p in enumerate({[str(p) for p in archs]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'a{i}', p)\n"
        "    m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "    assert callable(m.sizes) and callable(m.model_fields)\n")
    assert "torch" in names and "dcache_bench" in names
    assert not names & (FORBIDDEN | {"repro_torch"})
    pat = re.compile(r"^\s*(import|from)\s+(repro_torch|jax|jaxlib|flax|repro)(\s|\.|$)", re.M)
    for p in archs:
        assert not pat.search(p.read_text()), p
