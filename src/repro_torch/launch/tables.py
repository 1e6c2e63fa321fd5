"""The paper's tables on the GeoLLM-Engine simulator, the counterpart of
``benchmarks/tables.py``: Tables I-III, the concurrent-engine tables
(``table_concurrency`` ... ``table_plancache``) and the Belady bound;
``repro_torch.launch.run`` drives them.

Each function returns a list of CSV rows, equal string for string to the
reference's (the simulator modules are copies, every RNG draw in its
order). The task sets (gold answers and model check included) are memoised
per (n, reuse, seed) and shared across cells: a cell re-runs the agent, not
the workload generator. With ``parallel=True`` the cells of a table run on
a thread pool (row order, and every number, is unchanged).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.agent import build_runtime, build_tasks, run_episode
from repro_torch.core.faults import FaultPlan

# paper reference numbers for the summary comparison
PAPER_MEAN_SPEEDUP = 1.24
PAPER_SPEEDUP_RANGE = (1.15, 1.33)
PAPER_GPT_HIT = (0.962, 0.977)

_TASK_MEMO: Dict[tuple, list] = {}


def _tasks(n: int, reuse: float, seed: int = 1) -> list:
    """Shared, gold-annotated task sets (immutable once built)."""
    key = (n, reuse, seed)
    if key not in _TASK_MEMO:
        from repro_torch.agent.geollm.datastore import GeoDataStore
        from repro_torch.agent.geollm.simclock import SimClock
        _TASK_MEMO[key] = build_tasks(n, reuse_rate=reuse, seed=seed,
                                      store=GeoDataStore(SimClock()))
    return _TASK_MEMO[key]


def _run_cells(cells: Sequence[Callable[[], object]],
               parallel: bool = False) -> List[object]:
    """Evaluate independent cell thunks, optionally on a thread pool.
    Results come back in input order either way."""
    if not parallel or len(cells) <= 1:
        return [c() for c in cells]
    workers = min(len(cells), os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda c: c(), cells))


def _cell(model, prompting, few_shot, use_cache, *, n, reuse=0.8, seed=0,
          policy="lru", read_impl="llm", update_impl="llm"):
    rt = build_runtime(model=model, prompting=prompting, few_shot=few_shot,
                       use_cache=use_cache, seed=seed, policy=policy,
                       read_impl=read_impl, update_impl=update_impl)
    return rt.run_and_evaluate(_tasks(n, reuse))


def table1(n: int = 300, parallel: bool = False) -> List[str]:
    """Models x prompting x shot, with/without LLM-dCache."""
    rows = ["table,model,prompting,few_shot,dcache,success,correctness,"
            "obj_det_f1,lcc_recall,vqa_rouge,avg_tokens,avg_time_s,speedup"]
    grid = [(model, prompting, fs)
            for model in ("gpt-3.5-turbo", "gpt-4-turbo")
            for prompting in ("cot", "react")
            for fs in (False, True)]
    _tasks(n, 0.8)     # prewarm the shared set before the pool fans out
    cells = [lambda m=m, p=p, f=f, u=u: _cell(m, p, f, u, n=n)
             for (m, p, f) in grid for u in (False, True)]
    reports = _run_cells(cells, parallel)
    speedups = []
    for i, (model, prompting, fs) in enumerate(grid):
        base, dc = reports[2 * i], reports[2 * i + 1]
        sp = base.avg_time_s / dc.avg_time_s
        speedups.append(sp)
        for tag, r, s in (("off", base, ""),
                          ("on", dc, f"{sp:.2f}")):
            rows.append(
                f"table1,{model},{prompting},{int(fs)},{tag},"
                f"{r.success_rate:.4f},{r.correctness:.4f},"
                f"{r.obj_det_f1:.4f},{r.lcc_recall:.4f},"
                f"{r.vqa_rouge:.4f},{r.avg_tokens:.0f},"
                f"{r.avg_time_s:.3f},{s}")
    mean_sp = float(np.mean(speedups))
    rows.append(f"table1_summary,mean_speedup,{mean_sp:.3f},"
                f"paper={PAPER_MEAN_SPEEDUP},"
                f"in_paper_range={PAPER_SPEEDUP_RANGE[0] <= mean_sp <= PAPER_SPEEDUP_RANGE[1] + 0.05}")
    return rows


def table2(n: int = 200, parallel: bool = False) -> List[str]:
    """Reuse-rate sweep + cache-policy ablation (mini 500-query style).

    Reuse rate changes the sampled tasks themselves (more distinct keys at
    low reuse), so the no-cache baseline is re-measured per rate and the
    paper's claim is read off the per-rate speedup column."""
    rows = ["table,config,value,avg_time_s,no_cache_time_s,speedup"]
    rates = (0.0, 0.2, 0.4, 0.6, 0.8)
    pols = ("lru", "lfu", "rr", "fifo")
    if parallel:
        for rr in rates:
            _tasks(n, rr)
    cells = [lambda rr=rr, u=u: _cell("gpt-3.5-turbo", "cot", False, u,
                                      n=n, reuse=rr)
             for rr in rates for u in (False, True)]
    cells += [lambda p=p: _cell("gpt-3.5-turbo", "cot", False, True,
                                n=n, policy=p)
              for p in pols]
    reports = _run_cells(cells, parallel)
    for i, rr in enumerate(rates):
        r0, r1 = reports[2 * i], reports[2 * i + 1]
        rows.append(f"table2,reuse_rate,{rr},{r1.avg_time_s:.3f},"
                    f"{r0.avg_time_s:.3f},"
                    f"{r0.avg_time_s / r1.avg_time_s:.3f}")
    for j, pol in enumerate(pols):
        r = reports[2 * len(rates) + j]
        rows.append(f"table2,policy,{pol},{r.avg_time_s:.3f},,")
    return rows


def table3(n: int = 200, parallel: bool = False) -> List[str]:
    """GPT-driven vs programmatic cache read/update (gpt-4 CoT few-shot)."""
    rows = ["table,read_impl,update_impl,cache_hit_pct,gpt_hit_pct,success,"
            "correctness,obj_det_f1,lcc_recall,vqa_rouge,avg_tokens,"
            "avg_time_s"]
    grid = (("python", "python"), ("llm", "python"),
            ("python", "llm"), ("llm", "llm"))
    _tasks(n, 0.8)
    cells = [lambda ri=ri, ui=ui: _cell("gpt-4-turbo", "cot", True, True,
                                        n=n, read_impl=ri, update_impl=ui)
             for ri, ui in grid]
    reports = _run_cells(cells, parallel)
    for (read_impl, update_impl), r in zip(grid, reports):
        rows.append(
            f"table3,{read_impl},{update_impl},{100*r.cache_hit_rate:.2f},"
            f"{100*r.gpt_hit_rate:.2f},{r.success_rate:.4f},"
            f"{r.correctness:.4f},{r.obj_det_f1:.4f},{r.lcc_recall:.4f},"
            f"{r.vqa_rouge:.4f},{r.avg_tokens:.0f},{r.avg_time_s:.3f}")
    return rows


def table_concurrency(tasks_per_session: int = 25,
                      sessions: Sequence[int] = (1, 2, 4, 8, 16),
                      n_pods: int = 4,
                      scale: Sequence[Sequence[int]] = ((128, 16),
                                                       (256, 32)),
                      parallel: bool = False,
                      engine_kw: Dict = None) -> List[str]:
    """Beyond-paper: N concurrent sessions contending on the pod-sharded
    cache (the paper's "hundreds of GPT endpoints" regime). Latency
    percentiles are per-task simulated seconds; stalls are time spent
    queued behind another session's DB load on the same pod.

    The ``scale`` cells (128 and 256 sessions, pods scaled to keep the
    8:1 pressure of the 4-pod grid's top cell) exist because of the
    batching work — the per-clock-advance Python stepping of the
    old engine capped the default bench at 64 sessions. They run 10 tasks
    per session (the ``tasks`` column reports the total): session COUNT is
    the scaled dimension, and a shorter stream keeps the default run's
    wall budget. The original ``sessions`` x ``n_pods`` rows are
    bit-identical to the original grid (digest-locked)."""
    rows = ["table,n_sessions,n_pods,tasks,p50_s,p95_s,mean_s,makespan_s,"
            "throughput_tps,stall_total_s,stall_per_task_s,stalled_loads,"
            "total_loads,local_hit_pct,pod_imbalance,miss_replans"]
    configs = ([(ns, n_pods, tasks_per_session) for ns in sessions]
               + [(c[0], c[1], min(10, tasks_per_session)) for c in scale])
    # engine_kw threads extra engine kwargs into every cell — the
    # degeneracy digest tests replay this table under traffic="closed"
    ekw = dict(engine_kw or {})
    cells = [lambda ns=ns, npod=npod, tps=tps: run_episode(
                 ns, tps, n_pods=npod, seed=0, **ekw)
             for ns, npod, tps in configs]
    for res in _run_cells(cells, parallel):
        m = res.metrics
        rows.append(
            f"concurrency,{m.n_sessions},{m.n_pods},{m.n_tasks},"
            f"{m.p50_task_latency_s:.3f},{m.p95_task_latency_s:.3f},"
            f"{m.mean_task_latency_s:.3f},{m.makespan_s:.3f},"
            f"{m.throughput_tasks_per_s:.4f},{m.total_stall_s:.3f},"
            f"{m.stall_per_task_s:.4f},{m.stalled_loads},{m.total_loads},"
            f"{100*m.local_hit_rate:.2f},{m.pod_load_imbalance:.3f},"
            f"{m.cache_miss_replans}")
    return rows


def table_prefetch(tasks_per_session: int = 25,
                   sessions: Sequence[int] = (1, 4, 8, 16),
                   n_pods: int = 8,
                   saturated: Sequence[Sequence[int]] = ((16, 4),),
                   adaptive: bool = True,
                   parallel: bool = False) -> List[str]:
    """Beyond-paper: lazy vs async-prefetch data plane on the event-granular
    engine. ``prefetch`` issues a session's planned ``load_db`` keys the
    moment its ReadPlan lands, overlapping DB service with the planning LLM
    round; ``lazy`` loads each key on demand after planning. Same seeds,
    same answers — only time moves. ``p95_speedup`` is lazy/prefetch p95
    task latency; ``overlap_s`` is DB service hidden behind LLM work.

    The default grid is 8 pods (sessions:pods <= 2:1, the paper's
    many-endpoint regime) plus the ``saturated`` ratio cells (16
    sessions / 4 pods = 4:1). The queueing-aware budget — consume-horizon
    + per-pod depth guard over observed service times — keeps p95 strictly
    reduced at <= 2:1 AND no worse than lazy at 4:1, where the old
    planning-latency budget shut prefetch off entirely. ``pf_skipped``
    counts planned loads the budget left lazy.

    The ``adaptive`` rows run the same cells with the adaptive
    depth guard (``prefetch_adaptive=True``): the fixed threshold is
    replaced by a proportional controller on the fleet's observed
    stall-plus-late-prefetch rate, which lifts the guard in the mid-range
    (recovering the 8/8 win the fixed guard trims) and clamps it past
    saturation. The lazy/prefetch rows are bit-identical to the fixed grid."""
    rows = ["table,n_sessions,n_pods,mode,p50_s,p95_s,mean_s,stall_total_s,"
            "stalled_loads,pf_issued,pf_skipped,pf_hits,pf_wait_s,overlap_s,"
            "joined_loads,p95_speedup"]
    configs = [(ns, n_pods) for ns in sessions] + [tuple(c) for c in saturated]
    # the fixed-guard mode pins prefetch_adaptive=False: the engine
    # defaults the adaptive guard ON, and these rows are the
    # digest-locked fixed-guard reference
    modes = (("lazy", {}),
             ("prefetch", {"prefetch": True, "prefetch_adaptive": False}))
    if adaptive:
        modes += (("adaptive", {"prefetch": True,
                                "prefetch_adaptive": True}),)
    cells = [lambda ns=ns, npod=npod, kw=kw: run_episode(
                 ns, tasks_per_session, n_pods=npod, seed=0, **kw)
             for ns, npod in configs for _, kw in modes]
    results = _run_cells(cells, parallel)
    nm = len(modes)
    for i, (ns, npod) in enumerate(configs):
        lazy = results[nm * i].metrics
        for j, (mode, _) in enumerate(modes):
            m = results[nm * i + j].metrics
            sp = ("" if j == 0 else
                  f"{lazy.p95_task_latency_s / m.p95_task_latency_s:.3f}")
            rows.append(
                f"prefetch,{ns},{npod},{mode},{m.p50_task_latency_s:.3f},"
                f"{m.p95_task_latency_s:.3f},{m.mean_task_latency_s:.3f},"
                f"{m.total_stall_s:.3f},{m.stalled_loads},"
                f"{m.prefetch_issued},{m.prefetch_skipped},"
                f"{m.prefetch_hits},{m.prefetch_wait_s:.3f},"
                f"{m.overlap_credit_s:.3f},{m.joined_loads},{sp}")
    return rows


def table_admission(tasks_per_session: int = 25, extras: bool = True,
                    parallel: bool = False,
                    scan_adaptive: bool = False) -> List[str]:
    """Beyond-paper: cross-session cache admission on the shared pod cache.

    Every cell pairs the install-all baseline (``admission=None``: install every
    load) against TinyLFU admission (shared count-min frequency sketch,
    aged on sim time; rejected keys bypass without evicting residents) on
    the same seeds — answers are identical, only cache state and time move.
    The scenario column sweeps qualitatively different key-popularity
    regimes (see ``WorkloadSampler``), and the scale rows push the
    contention to 32 and 64 sessions. The headline row (working-set low
    reuse, 16 sessions / 4 pods) additionally runs the GPT-driven admission
    path (``llm-tinylfu``): the policy is described to the LLM in natural
    language and graded against the programmatic rule (``agreement_pct``).

    ``hit_delta_pp`` is the local-hit percentage-point gain over the
    baseline row of the same cell; ``p95_speedup`` is baseline p95 over
    this row's p95 (>1 = admission is faster).
    """
    rows = ["table,scenario,n_sessions,n_pods,admission,reuse,local_hit_pct,"
            "p50_s,p95_s,stall_total_s,admitted,bypassed,bypass_reads,"
            "agreement_pct,adm_tokens,p95_speedup,hit_delta_pp"]
    configs = [
        # (label, engine_kw, n_sessions, n_pods, reuse)
        ("working-low", {}, 16, 4, 0.3),
        ("zipf-1.1", {"scenario": "zipf", "scenario_kw": {"zipf_a": 1.1}},
         16, 4, 0.3),
        ("zipf-1.5", {"scenario": "zipf", "scenario_kw": {"zipf_a": 1.5}},
         16, 4, 0.3),
        ("scan", {"scenario": "scan"}, 16, 4, 0.3),
        ("hotspot", {"scenario": "hotspot"}, 16, 4, 0.3),
        ("working-low", {}, 32, 4, 0.3),
        ("working-low", {}, 64, 8, 0.3),
    ]
    grid = [(cfg, adm) for cfg in configs for adm in (None, "tinylfu")]
    grid.append((configs[0], "llm-tinylfu"))    # GPT-driven headline cell
    # appendix rows (the grid above is digest-locked):
    # 128/256-session scale cells — feasible in the default run only
    # because of the batched sketch + de-Pythonized event loop (they run
    # 10 tasks/session: session count is the scaled dimension) — and the
    # cost-aware ablation on a widened frame-size band (10-208 MB), where
    # slot value = frequency x miss penalty has signal.
    if extras:
        scale_cfgs = [("working-low", {}, 128, 16, 0.3),
                      ("working-low", {}, 256, 16, 0.3)]
        grid += [(cfg, adm) for cfg in scale_cfgs
                 for adm in (None, "tinylfu")]
        wide = ("sized-wide", {"rows_range": (2_000, 40_000)}, 16, 4, 0.3)
        grid += [(wide, adm) for adm in (None, "tinylfu", "tinylfu-cost")]
    # scan-resistant admission. The detector
    # tracks the EWMA of the key-vs-victim frequency balance per admit
    # call — a sequential scan (uniform popularity) sits near 0.5 and
    # opens the TinyLFU gate (install-all), skewed traffic closes it.
    # Default-off: the admission grid above is digest-locked.
    if scan_adaptive:
        grid += [(configs[3], "scan-tinylfu"),   # scan scenario
                 (configs[1], "scan-tinylfu")]   # zipf-1.1 control
    scale_tps = min(10, tasks_per_session)
    cells = [lambda cfg=cfg, adm=adm: run_episode(
                 cfg[2],
                 scale_tps if cfg[2] >= 128 else tasks_per_session,
                 n_pods=cfg[3], reuse_rate=cfg[4], seed=0,
                 admission=(None if adm is None else
                            adm if adm in ("tinylfu-cost", "scan-tinylfu")
                            else "tinylfu"),
                 admission_impl=("llm" if adm == "llm-tinylfu"
                                 else "python"),
                 **cfg[1])
             for cfg, adm in grid]
    results = _run_cells(cells, parallel)
    base_hit: Dict[tuple, float] = {}
    base_p95: Dict[tuple, float] = {}
    for ((label, _, ns, npod, reuse), adm), res in zip(grid, results):
        m = res.metrics
        key = (label, ns, npod)
        if adm is None:
            base_hit[key] = m.local_hit_rate
            base_p95[key] = m.p95_task_latency_s
            sp = delta = ""
        else:
            sp = f"{base_p95[key] / m.p95_task_latency_s:.3f}"
            delta = f"{100 * (m.local_hit_rate - base_hit[key]):.2f}"
        rows.append(
            f"admission,{label},{ns},{npod},{adm or 'none'},{reuse},"
            f"{100 * m.local_hit_rate:.2f},{m.p50_task_latency_s:.3f},"
            f"{m.p95_task_latency_s:.3f},{m.total_stall_s:.3f},"
            f"{m.admitted},{m.bypassed},{m.bypass_reads},"
            f"{100 * m.admission_agreement:.2f},{m.admission_tokens},"
            f"{sp},{delta}")
    return rows


def table_replication(tasks_per_session: int = 25,
                      parallel: bool = False) -> List[str]:
    """Beyond-paper: cross-pod replication of super-hot keys.

    Workload: globally-aligned zipf skew (``zipf_global=True`` — every
    session agrees on which keys are hot, the paper's
    many-endpoints-one-event regime; the per-session zipf of the admission
    table leaves the *global* popularity field nearly flat). Each cell
    pairs baselines against ``replication=True`` on the same seeds: the
    :class:`~repro_torch.core.replication.HotKeyReplicator` promotes
    hot-but-homeless keys (epoch top-missed feed + admission-bypass spill),
    placing bounded-fanout copies where the displaced resident is globally
    coldest, and demotes by frequency hysteresis plus a usage veto.

    Row semantics: ``hit_delta_pp``/``p95_speedup`` compare each row
    against the *same-admission* baseline of its cell (tinylfu+repl vs
    tinylfu; repl-only vs none), so the replication effect is isolated
    from the admission effect. The acceptance cell is 16 sessions/4 pods:
    tinylfu+repl must hold local hits strictly above tinylfu with p95 no
    worse (install-everything+repl shows the bigger, seed-robust win:
    +2-4 hit points, p95 reduced). The ``llm-repl`` row routes every
    promote/drop/hold decision through the GPT prompt path, graded
    against the programmatic threshold rule (``agreement_pct``)."""
    rows = ["table,scenario,n_sessions,n_pods,config,local_hit_pct,p50_s,"
            "p95_s,stall_total_s,replica_hits,replica_installs,"
            "replica_drops,promotes,demotes,epochs,agreement_pct,"
            "repl_tokens,p95_speedup,hit_delta_pp"]
    zipfg = {"scenario": "zipf",
             "scenario_kw": {"zipf_a": 1.1, "zipf_global": True}}
    # measured operating point (see repro/core/replication.py)
    rkw = {"epoch_s": 20.0, "max_replicated": 10, "promote_min": 4,
           "miss_min": 2, "gain_ratio": 2.0}
    # (config label, engine kwargs, baseline config label for deltas)
    modes = [
        ("none", {}, None),
        ("repl", {"replication": True, "replication_kw": rkw}, "none"),
        ("tinylfu", {"admission": "tinylfu"}, None),
        ("tinylfu+repl", {"admission": "tinylfu", "replication": True,
                          "replication_kw": rkw}, "tinylfu"),
        ("llm-repl", {"admission": "tinylfu", "replication": True,
                      "replication_impl": "llm", "replication_kw": rkw},
         "tinylfu"),
    ]
    configs = [(16, 4), (64, 8)]
    cells = [lambda ns=ns, npod=npod, kw=kw: run_episode(
                 ns, tasks_per_session, n_pods=npod, reuse_rate=0.3,
                 seed=0, **dict(zipfg, **kw))
             for ns, npod in configs for _, kw, _b in modes]
    results = _run_cells(cells, parallel)
    nm = len(modes)
    for i, (ns, npod) in enumerate(configs):
        base = {label: results[nm * i + j].metrics
                for j, (label, _, _b) in enumerate(modes)}
        for label, _, bline in modes:
            m = base[label]
            if bline is None:
                sp = delta = ""
            else:
                b = base[bline]
                sp = f"{b.p95_task_latency_s / m.p95_task_latency_s:.3f}"
                delta = f"{100 * (m.local_hit_rate - b.local_hit_rate):.2f}"
            rows.append(
                f"replication,zipfg-1.1,{ns},{npod},{label},"
                f"{100 * m.local_hit_rate:.2f},{m.p50_task_latency_s:.3f},"
                f"{m.p95_task_latency_s:.3f},{m.total_stall_s:.3f},"
                f"{m.replica_hits},{m.replica_installs},{m.replica_drops},"
                f"{m.replication_promotes},{m.replication_demotes},"
                f"{m.replication_epochs},"
                f"{100 * m.replication_agreement:.2f},"
                f"{m.replication_tokens},{sp},{delta}")
    return rows


def table_locality(tasks_per_session: int = 25,
                   parallel: bool = False) -> List[str]:
    """Beyond-paper: session->pod affinity with a cross-pod read penalty
    — the consumer-side locality model that makes "localized"
    caching real.

    Workload: ``affinity_zipf`` (per-pod hot sets with 10% cross-pod
    spillover, zipf 1.8 within each group): each home pod's sessions agree
    on which keys are hot, but rendezvous hashing owns those keys on
    arbitrary pods — without placement, ~79% of all reads are served
    off-home and pay the penalty. Sessions are pinned by ``sticky``
    affinity; the headline grid (16 sessions / 4 pods) runs a DOUBLE-length
    task stream (placement is an equilibrium — the longer stream reads p95
    off the converged regime) and sweeps the penalty 1x/2x/4x with
    replication off/on; the scale rows (64/8, 256/16 at 10 tasks/session)
    hold the penalty at 2x.

    Row semantics: ``p95_speedup``/``hit_delta_pp`` compare each ``repl``
    row against the ``none`` row of the same (sessions, pods, penalty)
    cell. The acceptance cell is penalty 2x at 16/4: replication must beat
    install-everything by >1.07x p95 (the locality-free headline),
    with the win now carried by the *local-read share* — remote reads drop
    from ~79% to ~48% of all reads because promotion feeds on consumer
    demand and placement targets the demanding home pod (locality-blind
    replication at penalty 1x leaves the share at ~77%). The p95 win
    is NOT monotone in the penalty: hops slow consumers down, which
    decongests the pod queues of the closed-loop fleet (benchmarks/README
    documents the effect); the share conversion is monotone and is the
    paper-faithful term. ``llm-repl`` routes every decision through the
    locality-aware prompt path (home-pod demand rendered as evidence),
    graded against the programmatic rule."""
    rows = ["table,scenario,n_sessions,n_pods,penalty,config,local_hit_pct,"
            "remote_read_pct,remote_reads,remote_hop_s,link_stall_s,p50_s,"
            "p95_s,stall_total_s,replica_hits,agreement_pct,repl_tokens,"
            "p95_speedup,hit_delta_pp"]
    affz = {"scenario": "affinity_zipf",
            "scenario_kw": {"zipf_a": 1.8, "spill_p": 0.1}}
    # measured operating point (see repro/core/locality.py + tests):
    # short epochs + a permissive gate — consumer-pod copies are cheap to
    # re-place when install-everything churn evicts them
    rkw = {"epoch_s": 10.0, "max_replicated": 12, "promote_min": 3,
           "miss_min": 1, "gain_ratio": 1.2, "top_k": 12}
    modes = [
        ("none", {}, None),
        ("repl", {"replication": True, "replication_kw": rkw}, "none"),
    ]
    llm_mode = ("llm-repl", {"replication": True, "replication_impl": "llm",
                             "replication_kw": rkw}, "none")
    head_tps = 2 * tasks_per_session
    scale_tps = min(10, tasks_per_session)
    # (n_sessions, n_pods, penalty, tasks/session, mode)
    grid = [(16, 4, pen, head_tps, m)
            for pen in (1.0, 2.0, 4.0) for m in modes]
    grid.append((16, 4, 2.0, head_tps, llm_mode))
    grid += [(ns, npod, 2.0, scale_tps, m)
             for ns, npod in ((64, 8), (256, 16)) for m in modes]
    cells = [lambda ns=ns, npod=npod, pen=pen, tps=tps, kw=m[1]: run_episode(
                 ns, tps, n_pods=npod, reuse_rate=0.3, seed=0,
                 affinity="sticky", remote_read_penalty=pen,
                 **dict(affz, **kw))
             for ns, npod, pen, tps, m in grid]
    results = _run_cells(cells, parallel)
    base_hit: Dict[tuple, float] = {}
    base_p95: Dict[tuple, float] = {}
    for (ns, npod, pen, _tps, (label, _, bline)), res in zip(grid, results):
        m = res.metrics
        key = (ns, npod, pen)
        if bline is None:
            base_hit[key] = m.local_hit_rate
            base_p95[key] = m.p95_task_latency_s
            sp = delta = ""
        else:
            sp = f"{base_p95[key] / m.p95_task_latency_s:.3f}"
            delta = f"{100 * (m.local_hit_rate - base_hit[key]):.2f}"
        rows.append(
            f"locality,affz-1.8,{ns},{npod},{pen:g},{label},"
            f"{100 * m.local_hit_rate:.2f},"
            f"{100 * m.locality_remote_read_share:.2f},"
            f"{m.locality_remote_reads},{m.locality_remote_hop_s:.3f},"
            f"{m.locality_link_stall_s:.3f},{m.p50_task_latency_s:.3f},"
            f"{m.p95_task_latency_s:.3f},{m.total_stall_s:.3f},"
            f"{m.replica_hits},{100 * m.replication_agreement:.2f},"
            f"{m.replication_tokens},{sp},{delta}")
    return rows


def table_resilience(tasks_per_session: int = 20,
                     parallel: bool = False,
                     engine_kw: Dict = None) -> List[str]:
    """Beyond-paper: fault-injected elastic fleet.

    Workload: the replication table's globally-aligned zipf skew at
    ``capacity_per_pod=8`` (deeper caches mean a failure destroys real
    state — at tiny capacities every lost key self-heals on its next
    demand access and there is no transient to measure). The failed pod is
    always **pod3**: under ``zipf_global`` the hot ranking is
    seed-independent and rendezvous hashing owns the two globally hottest
    keys (plus 4 of the top 8) on pod3 — the worst-case single-pod loss.

    Fault matrix (all sim-time :class:`~repro_torch.core.faults.FaultPlan`
    schedules): ``none`` (EMPTY plan — the degeneracy reference: the fault
    layer runs every hook yet replays the fault-free engine bit-identically,
    locked by tests/test_faults.py), ``single`` (fail pod3 @60s, restore
    @75s), ``double`` (correlated pod1+pod3 @60s, 15s downtime), ``churn``
    (periodic round-robin failures every 30s), ``elastic`` (scale pod4 out
    @40s, in @100s), and ``autoscale`` (no plan — the
    :class:`~repro_torch.core.faults.BacklogAutoscaler` drives scale_out/in from
    the engine's backlog signals).

    Config axis: replication off vs on — replication uses the
    **durability feed** (``durability=True``: the sketch's global top-k is
    judged alongside the miss feed, so hot *resident* keys get copies that
    buy no latency but survive owner loss). The acceptance comparison is
    the ``single`` fault at seeds 1-3: mean hit-EWMA recovery time must be
    measurably shorter with replication on (replicas keep serving the lost
    owner's hot keys, so the post-restore re-warm transient mostly
    disappears). ``rec-thr``/``rec-llm`` rows add the post-failover
    recovery policy (threshold re-warm vs GPT-prompted re-warm/lazy per
    lost key, graded like admission/replication).

    Row semantics: ``recovery_s`` is the mean time for the fast hit-EWMA
    to regain ``recover_frac`` of the slow pre-failure baseline after
    dipping (0 when a failure never dents the hit rate); ``fo_p95_s`` vs
    ``steady_p95_s`` split task latency by whether the task ended inside a
    failure->recovery window; ``incomplete`` counts sessions that never
    finished their stream — the zero-stall-forever gate (always 0)."""
    rows = ["table,scenario,n_sessions,n_pods,fault,config,seed,"
            "local_hit_pct,p50_s,p95_s,failovers,restores,scale_outs,"
            "scale_ins,aborted,retried,timeouts,lost_keys,lost_replicas,"
            "pf_aborted,retry_wait_s,lost_work_s,recovery_s,unrecovered,"
            "fo_p95_s,steady_p95_s,replica_hits,rewarms,lazy,"
            "rec_agreement_pct,rec_tokens,autoscale_actions,incomplete"]
    zipfg = {"scenario": "zipf",
             "scenario_kw": {"zipf_a": 1.1, "zipf_global": True}}
    # durability replication (see repro/core/replication.py): fanout 1
    # keeps the replica capacity tax low enough that the survivors'
    # caches are not crowded out during the down window
    rkw = {"epoch_s": 20.0, "max_replicated": 8, "promote_min": 4,
           "miss_min": 2, "gain_ratio": 2.0, "durability": True,
           "fanout": 1}
    pods = [f"pod{i}" for i in range(4)]
    plans = {
        "none": FaultPlan(),
        "single": FaultPlan.single("pod3", 60.0, restore_at=75.0),
        "double": FaultPlan.correlated(["pod1", "pod3"], 60.0,
                                       downtime_s=15.0),
        "churn": FaultPlan.periodic(pods, period_s=30.0, downtime_s=10.0,
                                    start_s=30.0, horizon_s=120.0),
        "elastic": FaultPlan.elastic("pod4", 40.0, in_at=100.0),
    }
    repl = {"replication": True, "replication_kw": rkw}
    auto_kw = {"autoscale": True,
               "autoscale_kw": {"check_every_s": 15.0, "high_backlog_s": 0.5,
                                "low_backlog_s": 0.05, "max_extra": 2,
                                "cooldown_s": 30.0}}
    # (fault label, config label, seed, engine kwargs)
    grid = []
    for fault, plan in plans.items():
        seeds = (1, 2, 3) if fault == "single" else (1,)
        for seed in seeds:
            grid.append((fault, "repl-off", seed, {"fault_plan": plan}))
            grid.append((fault, "repl-on", seed,
                         dict({"fault_plan": plan}, **repl)))
    grid.append(("autoscale", "repl-off", 1, dict(auto_kw)))
    single = plans["single"]
    grid.append(("single", "rec-thr", 1,
                 {"fault_plan": single, "recovery_impl": "python"}))
    grid.append(("single", "rec-llm", 1,
                 {"fault_plan": single, "recovery_impl": "llm"}))
    ekw = dict(engine_kw or {})   # degeneracy replays: traffic="closed"
    cells = [lambda seed=seed, kw=kw: run_episode(
                 16, tasks_per_session, n_pods=4, reuse_rate=0.3, seed=seed,
                 prefetch=True, capacity_per_pod=8,
                 **dict(zipfg, **dict(kw, **ekw)))
             for _f, _c, seed, kw in grid]
    results = _run_cells(cells, parallel)
    for (fault, config, seed, _kw), res in zip(grid, results):
        m = res.metrics
        rows.append(
            f"resilience,zipfg-1.1,16,4,{fault},{config},{seed},"
            f"{100 * m.local_hit_rate:.2f},{m.p50_task_latency_s:.3f},"
            f"{m.p95_task_latency_s:.3f},{m.resilience_failovers},"
            f"{m.resilience_restores},{m.resilience_scale_outs},"
            f"{m.resilience_scale_ins},{m.resilience_aborted_loads},"
            f"{m.resilience_retried_loads},{m.resilience_timeout_loads},"
            f"{m.resilience_lost_keys},{m.resilience_lost_replicas},"
            f"{m.resilience_prefetch_aborted},"
            f"{m.resilience_retry_wait_s:.3f},"
            f"{m.resilience_lost_work_s:.3f},"
            f"{m.resilience_recovery_s:.3f},{m.resilience_unrecovered},"
            f"{m.resilience_failover_p95_s:.3f},"
            f"{m.resilience_steady_p95_s:.3f},{m.replica_hits},"
            f"{m.recovery_rewarms},{m.recovery_lazy},"
            f"{100 * m.recovery_agreement:.2f},{m.recovery_tokens},"
            f"{m.autoscale_actions},{m.resilience_incomplete_sessions}")
    return rows


def table_capacity(rates: Sequence[float] = (0.1, 0.2, 0.4, 0.8),
                   horizon_s: float = 150.0, slo_p99_s: float = 10.0,
                   lifetime_tasks: int = 6, n_pods: int = 4,
                   parallel: bool = False) -> List[str]:
    """Beyond-paper: open-loop capacity sweep.

    The closed-loop tables measure a FIXED population racing to drain its
    task streams; this table measures *offered load*: Poisson session
    arrivals at ``rate_sps`` sessions/s over ``horizon_s``, each session a
    bounded ``lifetime_tasks``-task visit (spawn and retire are
    first-class scheduler events — see repro/core/traffic.py). Workload is
    the resilience table's globally-aligned zipf skew (every session
    agrees on the hot set, so cache state carries between visits — an
    open-loop system with no key reuse across sessions has no cache story
    to measure).

    Config axis — (admission, replication, affinity), the same levers as
    the closed-loop tables: ``base`` (install-everything), ``tinylfu``
    (shared-sketch admission), ``repl`` (hot-key replication), and
    ``sticky2x`` (sticky session->pod affinity at a 2x cross-pod read
    penalty). For each config the sweep reports goodput (completed
    tasks/s over the makespan), the latency tail (p50/p95/p99), and
    SLO attainment (fraction of tasks under ``slo_p99_s``); the final
    ``capacity_knee`` row per config is the **max sustainable arrival
    rate**: the largest swept rate whose p99 still meets the SLO.
    Headline (seed 1, defaults): TinyLFU admission sustains 2x the
    arrival rate of install-everything (knee 0.8/s vs 0.4/s) — under
    offered load, keeping one-shot tail keys out of the cache is a
    *capacity* feature, not just a latency one.

    Row invariants (locked by tests/test_traffic.py on every cell):
    flow balance ``spawned == completed + in_system`` with
    ``in_system == 0`` at episode end, ``incomplete == 0`` (the
    zero-stall-forever gate carried over), a Little's-law residual
    |L - lambda*W| at float precision, and ``slo_frac`` monotone
    non-increasing in the offered rate per config."""
    from repro_torch.core.traffic import (DiurnalTraffic, MMPPTraffic,
                                    PoissonTraffic, find_knee,
                                    slo_attainment)

    if slo_p99_s <= 0.0:
        raise ValueError(f"slo_p99_s must be > 0, got {slo_p99_s}")
    rows = ["table,scenario,config,rate_sps,slo_s,spawned,completed,"
            "in_system,goodput_tps,p50_s,p95_s,p99_s,slo_frac,"
            "mean_sojourn_s,mean_in_system,little_resid,local_hit_pct,"
            "incomplete"]
    zipfg = {"scenario": "zipf",
             "scenario_kw": {"zipf_a": 1.1, "zipf_global": True}}
    rkw = {"epoch_s": 20.0, "max_replicated": 8, "promote_min": 4,
           "miss_min": 2, "gain_ratio": 2.0}
    configs = (
        ("base", {}),
        ("tinylfu", {"admission": "tinylfu"}),
        ("repl", {"replication": True, "replication_kw": rkw}),
        ("sticky2x", {"affinity": "sticky", "remote_read_penalty": 2.0}),
    )
    grid = [(name, kw, rate) for name, kw in configs for rate in rates]
    cells = [lambda kw=kw, rate=rate: run_episode(
                 1, 25, n_pods=n_pods, reuse_rate=0.3, seed=1,
                 prefetch=True, capacity_per_pod=8,
                 traffic=PoissonTraffic(rate, horizon_s, seed=1,
                                        lifetime_tasks=lifetime_tasks),
                 **dict(zipfg, **kw))
             for _n, kw, rate in grid]
    results = _run_cells(cells, parallel)
    knees: Dict[str, List[tuple]] = {}
    for (name, _kw, rate), res in zip(grid, results):
        m = res.metrics
        lats = [tr.time_s for s in res.sessions for tr in s.traces]
        frac = slo_attainment(lats, slo_p99_s)
        knees.setdefault(name, []).append((rate, m.p99_task_latency_s))
        rows.append(
            f"capacity,zipfg-1.1,{name},{rate},{slo_p99_s},"
            f"{m.traffic_spawned},{m.traffic_completed},"
            f"{m.traffic_in_system},{m.throughput_tasks_per_s:.4f},"
            f"{m.p50_task_latency_s:.3f},{m.p95_task_latency_s:.3f},"
            f"{m.p99_task_latency_s:.3f},{frac:.4f},"
            f"{m.traffic_mean_sojourn_s:.3f},"
            f"{m.traffic_mean_in_system:.3f},"
            f"{m.traffic_little_residual:.2e},{100*m.local_hit_rate:.2f},"
            f"{m.resilience_incomplete_sessions}")
    for name, pts in knees.items():
        knee = find_knee(pts, slo_p99_s)
        rows.append(f"capacity_knee,zipfg-1.1,{name},"
                    f"{knee if knee is not None else ''},{slo_p99_s}")
    # non-Poisson arrival axes — diurnal (Lewis-Shedler
    # thinned day/night sinusoid) and 2-state MMPP bursts — on the tinylfu
    # config. Rows carry the "capacity_arrival" prefix so the committed
    # "capacity" rows, the knee rows, and the 12-cell CI capacity smoke
    # stay bit-identical; columns match the capacity rows, with the config
    # tagged by the arrival process and rate_sps reporting the process's
    # MEAN offered rate (both obey the same flow-balance and Little's-law
    # locks, applied in tests/test_coherence.py).
    arrivals = (
        ("diurnal", lambda: DiurnalTraffic(
            0.4, horizon_s, amplitude=0.8, period_s=60.0, seed=1,
            lifetime_tasks=lifetime_tasks)),
        ("mmpp", lambda: MMPPTraffic(
            0.2, 1.2, horizon_s, dwell_low_s=40.0, dwell_high_s=15.0,
            seed=1, lifetime_tasks=lifetime_tasks)),
    )
    acells = [lambda mk=mk: run_episode(
                  1, 25, n_pods=n_pods, reuse_rate=0.3, seed=1,
                  prefetch=True, capacity_per_pod=8, admission="tinylfu",
                  traffic=mk(), **zipfg)
              for _n, mk in arrivals]
    for (name, mk), res in zip(arrivals, _run_cells(acells, parallel)):
        m = res.metrics
        lats = [tr.time_s for s in res.sessions for tr in s.traces]
        frac = slo_attainment(lats, slo_p99_s)
        rate = mk().offered_rate
        rows.append(
            f"capacity_arrival,zipfg-1.1,tinylfu+{name},{rate:.3f},"
            f"{slo_p99_s},{m.traffic_spawned},{m.traffic_completed},"
            f"{m.traffic_in_system},{m.throughput_tasks_per_s:.4f},"
            f"{m.p50_task_latency_s:.3f},{m.p95_task_latency_s:.3f},"
            f"{m.p99_task_latency_s:.3f},{frac:.4f},"
            f"{m.traffic_mean_sojourn_s:.3f},"
            f"{m.traffic_mean_in_system:.3f},"
            f"{m.traffic_little_residual:.2e},{100*m.local_hit_rate:.2f},"
            f"{m.resilience_incomplete_sessions}")
    return rows


def table_coherence(tasks_per_session: int = 12,
                    parallel: bool = False,
                    engine_kw: Dict = None) -> List[str]:
    """Beyond-paper: mutable data plane with cache coherence.

    The read-only tables assume a key's data never changes; this table
    runs seeded :class:`~repro_torch.core.coherence.MutationPlan` write streams
    against the mutation-facing workloads (``update_heavy`` /
    ``mixed_rw`` / ``flash_fresh`` — see ``WorkloadSampler``) and sweeps
    the coherence policy axis on identical seeds:

    * ``wi`` — write-invalidate: every write drops all cached copies
      (replicas included); no consumed value is ever stale (locked).
    * ``wt`` — write-through: every write re-stamps all cached copies to
      the new version in place; no stale reads, no invalidation misses.
    * ``ttl30`` — copies served until staleness exceeds 30s, then
      refreshed on consume.
    * ``stale20`` — bounded staleness: a version-lagged copy is served
      as long as its staleness is within 20s, else refreshed; the bound
      is a hard clamp (locked).
    * ``llm`` — the GPT-driven ``cache_update`` path on the stale20
      rule: the refresh-vs-serve-stale verdict comes from the prompted
      decision model, graded against the programmatic rule
      (``agreement_pct``); the engine clamp keeps a slipped verdict from
      ever violating the bound.

    ``p95_speedup`` compares each policy row against the same-scenario
    ``wi`` row (>1 = serving bounded-stale copies beats refreshing
    eagerly). The headline is the ``update_heavy`` cell: ``llm`` must
    beat ``wi`` on p95 at a bounded stale-read share. The two extra
    ``stale20`` rows sweep the mutation rate (monotonicity lock:
    stale-read share is non-decreasing in the write rate — see
    tests/test_coherence.py)."""
    from repro_torch.agent.geollm.workload import mutation_hot_keys
    from repro_torch.core.coherence import ARRIVAL, MutationPlan

    rows = ["table,scenario,n_sessions,n_pods,policy,mut_rate,p50_s,p95_s,"
            "stall_total_s,mutations,invalidations,writethroughs,"
            "stale_reads,refresh_loads,superseded,clamped,stale_share_pct,"
            "max_staleness_s,agreement_pct,coh_tokens,p95_speedup"]
    horizon = 150.0
    hot = mutation_hot_keys(4)

    def plan_for(scenario: str, rate: float) -> MutationPlan:
        if scenario == "flash_fresh":
            # a feed of new scenes walking the same shuffled order the
            # flash crowd's hot window advances over
            return MutationPlan.periodic(hot, 1.0 / rate, start_s=5.0,
                                         horizon_s=horizon, kind=ARRIVAL)
        return MutationPlan.random_plan(hot, rate, horizon, seed=5)

    policies = [
        ("wi", {"coherence": "write-invalidate"}),
        ("wt", {"coherence": "write-through"}),
        ("ttl30", {"coherence": "ttl", "coherence_kw": {"ttl_s": 30.0}}),
        ("stale20", {"coherence": "serve-stale",
                     "coherence_kw": {"bound_s": 20.0}}),
        ("llm", {"coherence": "serve-stale", "coherence_impl": "llm",
                 "coherence_kw": {"bound_s": 20.0}}),
    ]
    scen_kw = {
        "update_heavy": {"scenario": "update_heavy",
                         "scenario_kw": {"hot_k": 4, "hot_p": 0.85}},
        "mixed_rw": {"scenario": "mixed_rw", "scenario_kw": {"hot_k": 4}},
        "flash_fresh": {"scenario": "flash_fresh",
                        "scenario_kw": {"hot_k": 4, "hot_p": 0.85,
                                        "phase_len": 30}},
    }
    base_rate = 0.2
    grid = [(sc, pol, base_rate) for sc in scen_kw for pol in policies]
    # mutation-rate monotonicity axis (update_heavy, serve-stale)
    grid += [("update_heavy", policies[3], r) for r in (0.05, 0.5)]
    ekw = dict(engine_kw or {})   # degeneracy replays: empty endpoint plan
    cells = [lambda sc=sc, kw=pol[1], rate=rate: run_episode(
                 16, tasks_per_session, n_pods=4, reuse_rate=0.3, seed=0,
                 mutations=plan_for(sc, rate),
                 **dict(scen_kw[sc], **dict(kw, **ekw)))
             for sc, pol, rate in grid]
    results = _run_cells(cells, parallel)
    base_p95: Dict[str, float] = {}
    for (sc, (label, _), rate), res in zip(grid, results):
        m = res.metrics
        if label == "wi":
            base_p95[sc] = m.p95_task_latency_s
            sp = ""
        elif rate != base_rate:
            sp = ""     # different write stream: not comparable to wi
        else:
            sp = f"{base_p95[sc] / m.p95_task_latency_s:.3f}"
        rows.append(
            f"coherence,{sc},16,4,{label},{rate:g},"
            f"{m.p50_task_latency_s:.3f},{m.p95_task_latency_s:.3f},"
            f"{m.total_stall_s:.3f},{m.coherence_mutations},"
            f"{m.coherence_invalidations},{m.coherence_writethroughs},"
            f"{m.coherence_stale_reads},{m.coherence_refresh_loads},"
            f"{m.coherence_superseded_fills},{m.coherence_clamped},"
            f"{100 * m.coherence_stale_share:.2f},"
            f"{m.coherence_max_staleness_s:.3f},"
            f"{100 * m.coherence_agreement:.2f},{m.coherence_tokens},{sp}")
    return rows


def table_llmfault(tasks_per_session: int = 10,
                   parallel: bool = False) -> List[str]:
    """Beyond-paper: decision-plane resilience.

    Every GPT call — the per-round planning penalty and the cache-op
    decisions (admission here) — is routed through a pool of 4 simulated
    endpoints under seeded :class:`~repro_torch.core.endpoints.EndpointFaultPlan`
    fault schedules, sweeping regime x mitigation tier on the zipf_global
    16/4 replication-table cell:

    Regimes: ``none`` (empty plan — the degeneracy reference, also the
    p95 baseline), ``mixed`` (``outage_straggler``: ~10% staggered outages
    over three endpoints plus one 8x straggler for the whole horizon — the
    case retries alone cannot fix), ``blackout`` (correlated 12s
    all-endpoint outage: the decision plane is GONE and only programmatic
    fallback keeps cache-op decisions flowing), ``flaky`` (malformed-reply
    windows on two endpoints plus a rate-limit window: parse fallbacks and
    retry-after waits, no hard downtime).

    Tiers are cumulative: ``naive`` = bounded retry/backoff only;
    ``hedge`` adds EWMA-p95 hedged requests (second request to a different
    endpoint, first wins, loser's tokens still charged); ``breaker`` adds
    the per-endpoint circuit breaker whose open state steers calls away
    from bad endpoints and trips cache-op decisions into the programmatic
    twin (``degraded``/``fallback_share_pct``; those decisions are not
    graded — ``adm_agreement_pct`` covers genuine LLM replies only).

    Headline: on ``mixed``, the ``breaker`` tier must hold ``p95_vs_base``
    within ~1.1x of the no-fault baseline while ``naive`` degrades far
    worse (it keeps paying the straggler's 8x rounds and the outage
    backoff on the session clock). ``incomplete`` is the structural
    never-stall-forever gate — 0 in every cell."""
    from repro_torch.core.endpoints import EndpointFaultPlan, LIMIT, MALFORM

    rows = ["table,scenario,n_sessions,n_pods,regime,tier,llm_calls,"
            "retries,hedges,hedge_wins,rate_limited,malformed,"
            "parse_fallbacks,degraded,fallback_share_pct,retry_tokens,"
            "retry_wait_s,breaker_opens,adm_agreement_pct,p50_s,p95_s,"
            "p95_vs_base,incomplete"]
    zipfg = {"scenario": "zipf",
             "scenario_kw": {"zipf_a": 1.1, "zipf_global": True}}
    eps = [f"ep{i}" for i in range(4)]
    horizon = 200.0
    plans = {
        "mixed": EndpointFaultPlan.outage_straggler(eps, horizon_s=horizon),
        "blackout": EndpointFaultPlan.correlated(eps, at=30.0,
                                                 downtime_s=12.0),
        "flaky": (EndpointFaultPlan.single("ep1", 10.0, horizon,
                                           kind=MALFORM, value=0.25)
                  + EndpointFaultPlan.single("ep2", 20.0, horizon,
                                             kind=MALFORM, value=0.25)
                  + EndpointFaultPlan.single("ep0", 40.0, 80.0,
                                             kind=LIMIT, value=5.0)),
    }
    tiers = {"naive": {"hedge": False, "breaker": False},
             "hedge": {"hedge": True, "breaker": False},
             "breaker": {"hedge": True, "breaker": True}}
    # (regime, tier) grid: the no-fault baseline once, mixed and blackout
    # across all three tiers, flaky at the bracketing tiers
    grid = [("none", "naive")]
    grid += [("mixed", t) for t in tiers]
    grid += [("blackout", t) for t in tiers]
    grid += [("flaky", t) for t in ("naive", "breaker")]
    cells = [lambda regime=regime, tier=tier: run_episode(
                 16, tasks_per_session, n_pods=4, reuse_rate=0.3, seed=1,
                 prefetch=True, capacity_per_pod=8,
                 admission="tinylfu", admission_impl="llm",
                 endpoint_fault_plan=plans.get(regime, EndpointFaultPlan()),
                 endpoint_kw=tiers[tier], **zipfg)
             for regime, tier in grid]
    results = _run_cells(cells, parallel)
    base_p95 = results[0].metrics.p95_task_latency_s
    for (regime, tier), res in zip(grid, results):
        m = res.metrics
        rows.append(
            f"llmfault,zipfg-1.1,16,4,{regime},{tier},{m.llm_calls},"
            f"{m.llm_retries},{m.llm_hedges},{m.llm_hedge_wins},"
            f"{m.llm_rate_limited},{m.llm_malformed},"
            f"{m.llm_parse_fallbacks},{m.llm_degraded_decisions},"
            f"{100 * m.llm_fallback_share:.2f},{m.llm_retry_tokens},"
            f"{m.llm_retry_wait_s:.3f},{m.llm_breaker_opens},"
            f"{100 * m.admission_agreement:.2f},"
            f"{m.p50_task_latency_s:.3f},{m.p95_task_latency_s:.3f},"
            f"{m.p95_task_latency_s / base_p95:.3f},"
            f"{m.resilience_incomplete_sessions}")
    return rows


def table_plancache(tasks_per_session: int = 10,
                    parallel: bool = False) -> List[str]:
    """Beyond-paper: the plan-cache tier.

    The planning round is the single largest sim-time item; this table
    sweeps repeat-share x plan-cache impl on the zipf_global 16/4 cell,
    then replays the repeat-heavy cell under the llmfault table's mixed
    outage+straggler regime at the retry-only mitigation tier (the case
    hedging is not there to mask — every straggler-landed planning round
    pays the 8x service time on the session clock).

    Cells: ``none`` regime at repeat 0% (off vs python: the zero-hit
    lock — a non-repeating stream cannot hit, the tier costs one cache
    read per task and nothing else) and repeat 60% (off / python / llm;
    the GPT path runs at capacity 16 so eviction pressure actually
    consults the model — a free-slot install never prompts); ``mixed``
    regime at repeat 60% across the same three impls.

    Headline (the acceptance gate tests/test_plan_cache.py and CI's
    smoke cell hold): on ``mixed``, both cached impls must show
    ``p95_vs_off`` strictly below 1.0 — a plan-cache hit skips the
    planning round entirely, so repeated templates never touch the
    straggler — while ``none``-regime hits hold p95 parity and cut mean
    latency and trace tokens. ``stale_served`` is 0 in every cell (the
    digest embeds datastore versions + residency; version-lagged plans
    are unreachable by construction, and the serve-time guard measures
    it)."""
    from repro_torch.core.endpoints import EndpointFaultPlan

    rows = ["table,scenario,n_sessions,n_pods,regime,repeat_pct,impl,"
            "lookups,hits,hit_rate_pct,installs,rejected,evictions,"
            "expired,invalidations,stale_served,pc_agreement_pct,"
            "pc_tokens,trace_tokens,fleet_tokens,mean_s,p50_s,p95_s,"
            "p95_vs_off,incomplete"]
    eps = [f"ep{i}" for i in range(4)]
    mixed = EndpointFaultPlan.outage_straggler(eps, horizon_s=400.0)
    impls = {"off": {}, "python": {"plan_cache": "python"},
             "llm": {"plan_cache": "llm", "plan_cache_kw": {"capacity": 16}}}
    grid = [("none", 0.0, "off"), ("none", 0.0, "python"),
            ("none", 0.6, "off"), ("none", 0.6, "python"),
            ("none", 0.6, "llm"),
            ("mixed", 0.6, "off"), ("mixed", 0.6, "python"),
            ("mixed", 0.6, "llm")]

    def _cell(regime, repeat, impl):
        skw = {"zipf_a": 1.1, "zipf_global": True}
        if repeat:
            skw["repeat_p"] = repeat
        kw = dict(impls[impl])
        if regime == "mixed":
            kw["endpoint_fault_plan"] = mixed
            kw["endpoint_kw"] = {"hedge": False, "breaker": False}
        return run_episode(16, tasks_per_session, n_pods=4, reuse_rate=0.3,
                           seed=1, prefetch=True, capacity_per_pod=8,
                           scenario="zipf", scenario_kw=skw, **kw)

    cells = [lambda g=g: _cell(*g) for g in grid]
    results = _run_cells(cells, parallel)
    off_p95 = {(regime, repeat): res.metrics.p95_task_latency_s
               for (regime, repeat, impl), res in zip(grid, results)
               if impl == "off"}
    for (regime, repeat, impl), res in zip(grid, results):
        m = res.metrics
        rows.append(
            f"plancache,zipfg-1.1,16,4,{regime},{100 * repeat:g},{impl},"
            f"{m.plancache_lookups},{m.plancache_hits},"
            f"{100 * m.plancache_hit_rate:.2f},{m.plancache_installs},"
            f"{m.plancache_rejected},{m.plancache_evictions},"
            f"{m.plancache_expired},{m.plancache_invalidations},"
            f"{m.plancache_stale_served},"
            f"{100 * m.plancache_agreement:.2f},{m.plancache_tokens},"
            f"{m.tokens_trace_total},{m.tokens_fleet_total},"
            f"{m.mean_task_latency_s:.3f},{m.p50_task_latency_s:.3f},"
            f"{m.p95_task_latency_s:.3f},"
            f"{m.p95_task_latency_s / off_p95[(regime, repeat)]:.3f},"
            f"{m.resilience_incomplete_sessions}")
    return rows


def belady_bound(n: int = 200, parallel: bool = False) -> List[str]:
    """Beyond-paper: Belady/MIN oracle as the eviction upper bound.

    The oracle is given the full upcoming key sequence once (indexed into
    per-key position lists by the policy) and its ``cursor`` advances as
    tasks consume requests — O(1) per task instead of re-slicing the
    remaining stream (identical victims: next-use comparisons shift by a
    constant)."""
    from repro_torch.agent.geollm.evaluator import evaluate

    rows = ["table,policy,avg_time_s,cache_hit_pct"]
    for pol in ("lru", "belady"):
        rt = build_runtime(model="gpt-3.5-turbo", prompting="cot",
                           few_shot=False, use_cache=True, policy=pol,
                           read_impl="python", update_impl="python")
        tasks = _tasks(n, 0.8)
        future = [k for t in tasks for k in t.required_keys]
        if pol == "belady":
            rt.runner.controller.policy.future = future
        traces, consumed = [], 0
        for t in tasks:
            if pol == "belady":
                rt.runner.controller.policy.cursor = consumed
            consumed += len(t.required_keys)
            traces.append(rt.runner.run_task(t))
        r = evaluate(tasks, traces, rt.cache.stats)
        rows.append(f"belady,{pol},{r.avg_time_s:.3f},"
                    f"{100*r.cache_hit_rate:.2f}")
    return rows

