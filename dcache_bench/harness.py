"""One run of one cell: set-up, the measured window, the trace, the check.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``dcache_bench/configs/<config>.json``, the
configuration's architecture (its sizes, weights, the port's
``ModelConfig`` fields and its work counts) in
``dcache_bench/architectures/<architecture>.py``, its traffic in
``dcache_bench/mixes/<traffic>.json``, its limits in
``dcache_bench/limits/<cell>.json``, its reference in
``dcache_bench/reference/<reference>.py`` and each per-layer metric in
``dcache_bench/metrics/<metric>.py`` (a metric named for its cell,
``<metric>.<cell>``, by the reader of ``<metric>``). Adding a cell, a mix, a
configuration, an architecture or a metric adds files and edits none of
these.

A cell reports every ``end_to_end`` entry that lists it under
``workloads`` and every entry with no ``workloads`` key: ``call_p95_ms``,
``ttft_p95_ms``, ``tpot_p95_ms``, ``calls_per_s`` and ``setup_s``. A cell
added as new files and appended ``configs``, ``workloads`` and
``per_layer`` entries, with no ``end_to_end`` entry, reports only those
five; its per-layer entries are ``<metric>.<cell>`` and move the unsuffixed
names. Entries named for a cell, ``<quantity>.<cell>``, read the same
quantity under a tighter bound fitted to that cell; ``end_to_end`` holds
at most 16 entries in all.

A run:

1. set-up (``setup_s``, from process start): the weights made on the
   device from the seed, the engine, the kernel library (built into the
   checkout's ``build/kernels/`` on the first run, loaded after), one
   prefill at each prompt length bucket the mix sends and a few decode
   steps of the full batch, then the ramp: every session submits its first
   call and the step that has admitted them all closes the set-up;
2. the window: the closed loop of sessions for ``--seconds`` (each session
   submits its next call as soon as its reply arrives);
3. with ``--trace 1``, a few more steps of the same loop under the
   profiler (the mix's ``trace_seconds``);
4. the check: the program's state is freed and the reference judges a
   seeded sample of the calls the window finished.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from dcache_bench import arith, judge, traffic
from dcache_bench.trace import from_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_DECODE_STEPS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# what the cell is
# ---------------------------------------------------------------------------

def load_spec(root: Path) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(root: Path, name: str) -> Dict:
    path = Path(root) / "dcache_bench" / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} at {path}")
    return json.loads(path.read_text())


_ARCHITECTURES: Dict[Path, object] = {}


def load_architecture(root: Path, name: str):
    """The module ``architectures/<name>.py`` (its interface:
    ``architectures/decoder.py``), loaded once for each file."""
    path = (Path(root) / "dcache_bench" / "architectures" / f"{name}.py").resolve()
    if path not in _ARCHITECTURES:
        if not path.is_file():
            raise FileNotFoundError(f"no architecture {name!r} at {path}")
        spec = importlib.util.spec_from_file_location(
            f"dcache_bench_architecture_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ARCHITECTURES[path] = mod
    return _ARCHITECTURES[path]


def quantity(name: str) -> str:
    """What a metric named for its cell reads: ``call_p95_ms.mixtral-decide``
    is ``call_p95_ms`` in that cell, held to a bound of its own; a name with
    no dot (``setup_s``, ``call_p95_ms``) is its own quantity, and an
    ``end_to_end`` entry of that name with no ``workloads`` key is reported
    by every cell, including one added with no ``end_to_end`` entry."""
    return name.rsplit(".", 1)[0]


def load_metric(root: Path, name: str):
    """The reader ``metrics/<name>.py``; a name with no file of its own is
    read by the reader of its ``quantity``."""
    metrics = Path(root) / "dcache_bench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.is_file():
        path = metrics / f"{quantity(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} in {metrics}")
    spec = importlib.util.spec_from_file_location(f"dcache_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: Dict, workload: str, kind: str) -> List[Dict]:
    """The end_to_end or per_layer entries this cell reports."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    active: int
    admitted: int
    prefill_lens: List[int]
    decode_pos: List[int]


class Loop:
    """Closed-loop sessions over one engine: each session has one call in
    the engine at a time and submits the next when the reply arrives."""

    def __init__(self, eng, mix: Dict, seed: int):
        if int(mix["sessions"]) != eng.max_batch:
            raise ValueError("the mix's sessions must equal the engine's slots")
        self.eng = eng
        self.streams = traffic.sessions(mix, seed)
        self.owner: Dict[int, int] = {}      # rid -> session
        self.prompts: Dict[int, str] = {}    # rid -> prompt text
        self.requests: List = []
        self.n_seen = 0
        self.steps: List[Step] = []

    def submit(self, session: int):
        call = next(self.streams[session])
        # greedy: the check holds each served token against the reference's best
        req = self.eng.submit(call.prompt, call.max_new_tokens, 0.0)
        self.owner[req.rid] = session
        self.prompts[req.rid] = call.prompt
        self.requests.append(req)

    def step(self, detail: bool = False) -> Step:
        eng = self.eng
        before = {r.rid for r in eng.slots if r is not None}
        p0 = eng.prefills
        t0 = time.perf_counter()
        active = eng.step()
        t1 = time.perf_counter()
        done = eng.finished[self.n_seen:]
        self.n_seen = len(eng.finished)
        lens, pos = [], []
        if detail:
            ran = [r for r in eng.slots if r is not None] + list(done)
            lens = [len(r.prompt_ids) for r in ran if r.rid not in before]
            pos = [len(r.prompt_ids) + len(r.out_ids) - 2 for r in ran]
        for r in done:
            self.submit(self.owner[r.rid])
        s = Step(t0, t1, active, eng.prefills - p0, lens, pos)
        self.steps.append(s)
        return s

    def admits_next(self) -> bool:
        return bool(self.eng.waiting) and any(r is None for r in self.eng.slots)


def warm_up(eng, mix: Dict, seed: int, device) -> None:
    """One prefill at each prompt bucket the mix's first calls reach, and a
    few decode steps of the full batch, so nothing builds or first-runs in
    the window. Draws from a stream of its own (seed + 1)."""
    buckets = {}
    for stream in traffic.sessions(mix, seed + 1):
        for _ in range(3):
            call = next(stream)
            n = min(len(call.prompt.encode()) + traffic.BOS_TOKENS, eng.max_len // 2)
            buckets.setdefault(eng._prefill_len(n), call.prompt)
    for prompt in buckets.values():
        eng.submit(prompt, WARM_DECODE_STEPS + 1)
    eng.run_until_done()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    eng.finished.clear()


def pct(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=float), q))


def end_to_end(loop: Loop, t_open: float, t_close: float, setup_s: float) -> Dict:
    reqs = loop.requests
    in_win = [r for r in reqs if r.submitted_at >= t_open]
    call, ttft, tpot = [], [], []
    for r in in_win:
        done = r.finished_at is not None and r.finished_at <= t_close
        call.append((r.finished_at if done else t_close) - r.submitted_at)
        first = r.first_token_at if (r.first_token_at is not None
                                     and r.first_token_at <= t_close) else None
        ttft.append((first if first is not None else t_close) - r.submitted_at)
        if first is not None and len(r.out_ids) >= 2:
            end = r.finished_at if done else t_close
            tpot.append((end - first) / (len(r.out_ids) - 1))
    completed = [r for r in reqs if r.finished_at is not None
                 and t_open < r.finished_at <= t_close]
    window = t_close - t_open
    ms = lambda v: None if v is None else 1e3 * v
    return {"call_p95_ms": ms(pct(call, 95)), "ttft_p95_ms": ms(pct(ttft, 95)),
            "tpot_p95_ms": ms(pct(tpot, 95)),
            "calls_per_s": len(completed) / window, "setup_s": setup_s,
            "_calls": len(call), "_completed": len(completed), "_window_s": window}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Readings:
    """What a per-layer metric reader may read: the window's steps, the
    traced steps and their trace, the sizes and the architecture that
    counts their work."""

    def __init__(self, sizes, steps, traced_steps, trace, arch=None):
        self.sizes, self.steps = sizes, steps
        self.traced_steps, self.trace = traced_steps, trace
        self.arch = arch


def traced(loop: Loop, seconds: float):
    """Steps of the loop under the profiler: one untraced-range step to let
    the profiler settle, then ``seconds`` of steps in ``bench.window``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from dcache_bench import program
    orig = program.MOE_MODULE.moe

    def moe(*a, **k):
        with record_function("bench.moe"):
            return orig(*a, **k)

    program.MOE_MODULE.moe = moe
    steps = []
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop.step()
            with record_function("bench.window"):
                t_end = time.perf_counter() + seconds
                while time.perf_counter() < t_end:
                    name = "bench.step.admit" if loop.admits_next() else "bench.step.decode"
                    with record_function(name):
                        s = loop.step(detail=True)
                    if (name == "bench.step.admit") != (s.admitted > 0):
                        raise RuntimeError("a step admitted other than predicted")
                    steps.append(s)
    finally:
        program.MOE_MODULE.moe = orig
    return steps, from_profiler(prof)


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    root: Path
    spec: Dict
    entry: Dict         # the workload entry of BENCHMARK.json
    mix: Dict
    sizes: Dict
    limits: Dict[str, float]
    ref: object         # the reference module
    arch: object        # the architecture module


def prepare(root: Path, workload: str) -> Cell:
    root = Path(root)
    spec = load_spec(root)
    entry = find(spec["workloads"], workload, "workload")
    find(spec["configs"], entry["config"], "configuration")
    cfg = load_config(root, entry["config"])
    arch = load_architecture(root, cfg["architecture"])
    return Cell(root, spec, entry, traffic.load_mix(root, entry["traffic"]),
                arch.sizes(cfg), judge.load_limits(root, workload),
                judge.load_reference(root, cfg["reference"]), arch)


@dataclasses.dataclass
class Served:
    e2e: Dict
    window_steps: List[Step]
    finished: List        # calls finished by the window's close
    prompts: Dict[int, str]
    params: Dict
    peak: int
    trace: Optional[tuple] = None   # (traced steps, Trace)


def serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> Served:
    """Set-up, the window and, with ``trace``, the traced steps; the
    engine is freed before this returns, the weights are kept."""
    from dcache_bench import program

    sizes, mix, arch = cell.sizes, cell.mix, cell.arch
    on_card = torch.device(device).type == "cuda"
    need = (arch.weight_params(sizes) * arith.BF16_BYTES
            + arch.cache_bytes(sizes, sizes["max_batch"], sizes["max_len"]))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        free = torch.cuda.mem_get_info()[0]
        if need >= free:
            raise RuntimeError(f"{cell.entry['config']}: weights and cache need "
                               f"{need / 2**30:.2f} GiB, {free / 2**30:.2f} GiB free")
    params = arch.make_params(sizes, seed, device)
    if on_card:
        # part of setup_s: nvcc in a checkout's first run, a load after it
        t0 = time.perf_counter()
        built = program.load_kernels() is not None
        log(f"kernel library {'built by nvcc' if built else 'loaded'} in "
            f"{time.perf_counter() - t0:.3f} s, part of setup_s")
    eng = program.engine(arch.model_fields(cell.entry["config"], sizes), sizes,
                         params, device)
    warm_up(eng, mix, seed, device)
    loop = Loop(eng, mix, seed)
    for s in range(len(loop.streams)):
        loop.submit(s)
    first_calls = list(loop.requests)
    while any(r.first_token_at is None for r in first_calls):
        loop.step()
    t_open = loop.steps[-1].t1
    ramp_steps = len(loop.steps)

    t_end = t_open + seconds
    while time.perf_counter() < t_end:
        loop.step()
    t_close = loop.steps[-1].t1
    e2e = end_to_end(loop, t_open, t_close, t_open - t_start)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    traced_out = traced(loop, float(mix["trace_seconds"])) if trace else None
    finished = [r for r in loop.requests if r.finished_at is not None
                and r.finished_at <= t_close]
    out = Served(e2e, loop.steps[ramp_steps:], finished, loop.prompts, params,
                 peak, traced_out)
    del loop, eng
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def served_share(finished: List) -> str:
    got = sum(len(r.out_ids) for r in finished)
    asked = sum(r.max_new_tokens for r in finished)
    return (f"calls finished by the close {len(finished)}; tokens served {got} "
            f"of {asked} requested (share {got / max(asked, 1):.4f}; the rest "
            "ended at EOS)")


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None) -> Dict:
    """One run of ``workload``; returns the result line's object (with
    ``correct``) and logs to standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = prepare(root, workload)
    readers = {m["name"]: load_metric(cell.root, m["name"])
               for m in cell_metrics(cell.spec, workload, "per_layer")} if trace else {}
    on_card = torch.device(device).type == "cuda"
    sv = serve(cell, seed, seconds, trace, device, t_start)
    log(served_share(sv.finished))

    t_check = time.perf_counter()
    sample = judge.sample(sv.finished, seed, int(cell.mix["check_tokens"]))
    got = judge.readings(cell.ref, cell.sizes, sv.params, sample, sv.prompts,
                         cell.sizes["max_len"])
    check = {k: {"value": got[k], "limit": v} for k, v in cell.limits.items()}
    correct = bool(sample) and all(c["value"] <= c["limit"] for c in check.values())
    log(f"check of {got['calls']} calls, {got['tokens']} served tokens, "
        f"{time.perf_counter() - t_check:.1f} s")

    e2e = sv.e2e
    result = {"correct": correct, "attempted": e2e["_calls"], "failed": 0}
    if trace:
        steps, tr = sv.trace
        ctx = Readings(cell.sizes, sv.window_steps, steps, tr, cell.arch)
        metrics = {}
        for m in cell_metrics(cell.spec, workload, "per_layer"):
            v = readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {
            m["name"]: {"value": e2e[quantity(m["name"])], "unit": m["unit"]}
            for m in cell_metrics(cell.spec, workload, "end_to_end")}
        empty = [k for k, v in result["metrics"].items() if v["value"] is None]
        if empty:
            raise RuntimeError(f"the window gave no reading of {empty}")
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": torch.cuda.get_device_name() if on_card else "cpu",
                        "count": 1, "memory_peak_bytes": sv.peak}
    if trace:
        lens = [n for st in steps for n in st.prefill_lens]
        pos = [q for st in steps for q in st.decode_pos]
        log(f"traced {len(steps)} steps, {sum(1 for st in steps if st.admitted)} "
            f"admitting, {len(lens)} prefills of {np.mean(lens) if lens else 0:.0f} "
            f"true tokens on average, {len(pos)} decode rows at position "
            f"{np.mean(pos) if pos else 0:.0f} on average; device ops: flash "
            f"{sum('flash_kernel' in e.name for e in tr.device)}, decode "
            f"{sum('decode_kernel' in e.name for e in tr.device)}")
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["check"] = check
    log(f"setup {e2e['setup_s']:.3f} s; window {e2e['_window_s']:.3f} s: "
        f"{e2e['_completed']} calls completed, "
        f"{e2e['_calls']} submitted in it, {len(sv.window_steps)} steps, "
        f"{sum(s.admitted for s in sv.window_steps)} admissions; peak "
        f"{sv.peak / 2**30:.2f} GiB; card {power_limit() if on_card else 'none'}")
    for k, c in check.items():
        log(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}")
    return result
