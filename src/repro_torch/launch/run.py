"""Benchmark driver, the counterpart of ``benchmarks/run.py``: one function
per paper table + system micro-benches.

    PYTHONPATH=src python -m repro_torch.launch.run --skip-serving   # tables only
    PYTHONPATH=src python -m repro_torch.launch.run                  # + serving, cuda
    PYTHONPATH=src python -m repro_torch.launch.run --device cpu     # + serving, cpu
    PYTHONPATH=src python -m repro_torch.launch.run --skip-serving --json out.json

Prints CSV (``name,value,derived``-style rows per table) and a summary
comparing the reproduction against the paper's headline claims; the table
rows equal the reference driver's string for string. ``--json`` also writes
the reference's machine-readable record (wall-time, simulated-time and
speedup metrics per table; benchmarks/README.md has the schema), with
``args.skip_serving`` in place of ``args.skip_jax``, to the path given only.

The reference's ``--skip-jax`` is spelt ``--skip-serving`` here. Without it
the serving sections run the port's ``serving_bench`` functions on the
device rule's device: ``cuda`` unless ``--device cpu`` is given, and with
no CUDA and no ``--device cpu`` the driver raises before any table runs.
The kernel section times the CUDA kernel and is run on the card only.
"""
from __future__ import annotations

import argparse
import json
import platform
import time


def _csv_field(rows, prefix, field_idx, row_field=None, cast=float):
    """Pull one field out of a table's CSV rows (summary extraction)."""
    for r in rows:
        cells = r.split(",")
        if cells[0] == prefix and (row_field is None or row_field(cells)):
            try:
                return cast(cells[field_idx])
            except (ValueError, IndexError):
                return None
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale: 1000 tasks (Table I), 500 (ablations)")
    ap.add_argument("--skip-serving", action="store_true",
                    help="skip the serving/cache-op/kernel micro-benches")
    ap.add_argument("--device", default=None,
                    help="device of the serving micro-benches: cuda "
                         "(default) or cpu")
    ap.add_argument("--parallel", action="store_true",
                    help="run independent benchmark cells on a thread pool "
                         "(numbers are unchanged; cells are deterministic)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write wall/sim/speedup metrics per table as "
                         "JSON (perf trajectory tracking across PRs)")
    ap.add_argument("--profile", action="store_true",
                    help="include cumulative per-phase mechanism counters "
                         "(engine events, coalesced generator steps, sketch "
                         "touches/flushes, task-memo hits, ...) in the JSON "
                         "record")
    ap.add_argument("--pr3-grid", action="store_true",
                    help="run exactly the original digest-locked grid (no "
                         "scale/adaptive/cost/replication cells) — the "
                         "wall-budget and digest-lock reference")
    args = ap.parse_args(argv)
    dev = None
    if not args.skip_serving:
        from repro_torch import resolve_device
        dev = resolve_device(args.device)   # raises now, not after the tables

    if args.json:
        with open(args.json, "a"):    # fail fast on an unwritable path,
            pass                      # not after minutes of benchmarking

    n1 = 1000 if args.full else 300
    n23 = 500 if args.full else 200
    conc_tasks = 50 if args.full else 25

    from repro_torch.core import profiling
    from repro_torch.launch import tables

    t0 = time.time()
    sections = []

    def section(sid, title, fn, **kw):
        s0 = time.time()
        p0 = profiling.snapshot()
        rows = fn(**kw)
        sec = {"id": sid, "name": title,
               "wall_s": round(time.time() - s0, 3), "rows": rows}
        if args.profile:
            sec["profile"] = profiling.delta(p0, profiling.snapshot())
        sections.append(sec)

    print(f"# LLM-dCache benchmarks (n_table1={n1}, n_ablation={n23})",
          flush=True)

    par = args.parallel
    section("table1", "Table I (models x prompting, +/- dCache)",
            tables.table1, n=n1, parallel=par)
    section("table2", "Table II (reuse rates & policies)",
            tables.table2, n=n23, parallel=par)
    section("table3", "Table III (GPT-driven vs programmatic)",
            tables.table3, n=n23, parallel=par)
    base_grid = args.pr3_grid
    section("concurrency", "Concurrency (N sessions on the shared pod cache)",
            tables.table_concurrency, tasks_per_session=conc_tasks,
            parallel=par, **({"scale": ()} if base_grid else {}))
    section("prefetch", "Async prefetch (lazy vs plan-time pod loads)",
            tables.table_prefetch, tasks_per_session=conc_tasks,
            parallel=par, adaptive=not base_grid)
    section("admission", "Cross-session admission (TinyLFU vs install-all)",
            tables.table_admission, tasks_per_session=conc_tasks,
            parallel=par, extras=not base_grid,
            scan_adaptive=not base_grid)
    if not base_grid:
        section("replication",
                "Hot-key replication (epoch + spill, zipf-global)",
                tables.table_replication, tasks_per_session=conc_tasks,
                parallel=par)
        section("locality",
                "Session->pod affinity (cross-pod read penalty sweep)",
                tables.table_locality, tasks_per_session=conc_tasks,
                parallel=par)
        section("resilience",
                "Fault-injected elastic fleet (failover + recovery)",
                tables.table_resilience, tasks_per_session=conc_tasks,
                parallel=par)
        section("capacity",
                "Open-loop capacity sweep (Poisson arrivals, SLO knee)",
                tables.table_capacity, parallel=par)
        section("coherence",
                "Mutable data plane (write streams x coherence policies)",
                tables.table_coherence, parallel=par)
        section("llmfault",
                "Decision-plane resilience (endpoint faults x mitigation)",
                tables.table_llmfault, parallel=par)
        section("plancache",
                "Plan-cache tier (repeat-share x impl, faulted regime)",
                tables.table_plancache, parallel=par)
    section("belady", "Beyond-paper: Belady oracle bound",
            tables.belady_bound, n=n23)

    if not args.skip_serving:
        from repro_torch.launch import serving_bench
        section("serving", f"Serving engine ({dev.type} wall-time)",
                serving_bench.bench_serving, device=dev)
        section("cache_ops", "Cache ops", serving_bench.bench_cache_ops)
        if dev.type == "cuda":
            section("kernels", "Kernels (CUDA events)",
                    serving_bench.bench_kernels, device=dev)

    for sec in sections:
        print(f"\n## {sec['name']}  [{sec['wall_s']}s]")
        for r in sec["rows"]:
            print(r)
    total_wall = time.time() - t0
    print(f"\n# done in {total_wall:.1f}s")

    if args.json:
        by_id = {s["id"]: s["rows"] for s in sections}
        t1_rows = by_id.get("table1", [])
        conc_rows = by_id.get("concurrency", [])
        conc = [r.split(",") for r in conc_rows if r.startswith("concurrency")]
        conc_max = max(conc, key=lambda c: int(c[1])) if conc else None
        pf_all = [r.split(",") for r in by_id.get("prefetch", [])
                  if r.startswith("prefetch,")]
        pf_rows = [c for c in pf_all if c[3] == "prefetch"]
        pf_adaptive = {(int(c[1]), int(c[2])): c for c in pf_all
                       if c[3] == "adaptive"}
        # the <=2:1 grid rows (8 pods) vs the 4:1 saturation row (4 pods)
        pf_grid = [c for c in pf_rows if int(c[2]) == 8]
        pf_max = max(pf_grid, key=lambda c: int(c[1])) if pf_grid else None
        pf_sat = next((c for c in pf_rows
                       if int(c[1]) == 16 and int(c[2]) == 4), None)
        adm_rows = [r.split(",") for r in by_id.get("admission", [])
                    if r.startswith("admission,")]
        adm_cell = {c[4]: c for c in adm_rows
                    if c[1] == "working-low" and c[2] == "16"}
        adm_256 = {c[4]: c for c in adm_rows
                   if c[1] == "working-low" and c[2] == "256"}
        adm_wide = {c[4]: c for c in adm_rows if c[1] == "sized-wide"}
        rep_rows = [r.split(",") for r in by_id.get("replication", [])
                    if r.startswith("replication,")]
        rep_cell = {c[4]: c for c in rep_rows if c[2] == "16"}
        loc_rows = [r.split(",") for r in by_id.get("locality", [])
                    if r.startswith("locality,")]
        # headline cell: 16 sessions / 4 pods at each penalty, by config
        loc_cell = {(float(c[4]), c[5]): c for c in loc_rows
                    if c[2] == "16"}
        loc_256 = {(float(c[4]), c[5]): c for c in loc_rows
                   if c[2] == "256"}
        res_rows = [r.split(",") for r in by_id.get("resilience", [])
                    if r.startswith("resilience,")]
        # acceptance cells: the single-pod fail+restore fault at seeds 1-3,
        # replication off vs on — mean hit-EWMA recovery time
        def _res_mean_recovery(config):
            vals = [float(c[22]) for c in res_rows
                    if c[4] == "single" and c[5] == config]
            return round(sum(vals) / len(vals), 3) if vals else None
        res_llm = next((c for c in res_rows if c[5] == "rec-llm"), None)
        res_auto = next((c for c in res_rows if c[4] == "autoscale"), None)
        cap_all = [r.split(",") for r in by_id.get("capacity", [])]
        cap_rows = [c for c in cap_all if c[0] == "capacity"]
        cap_knee = {c[2]: (float(c[3]) if c[3] else None)
                    for c in cap_all if c[0] == "capacity_knee"}
        cap_arr = [c for c in cap_all if c[0] == "capacity_arrival"]
        coh_rows = [r.split(",") for r in by_id.get("coherence", [])
                    if r.startswith("coherence,")]
        # headline cell: update_heavy at the base write rate, by policy
        coh_cell = {c[4]: c for c in coh_rows
                    if c[1] == "update_heavy" and float(c[5]) == 0.2}
        llf_rows = [r.split(",") for r in by_id.get("llmfault", [])
                    if r.startswith("llmfault,")]
        llf_cell = {(c[4], c[5]): c for c in llf_rows}
        pc_rows = [r.split(",") for r in by_id.get("plancache", [])
                   if r.startswith("plancache,")]
        # cells keyed (regime, repeat_pct, impl)
        pc_cell = {(c[4], c[5], c[6]): c for c in pc_rows}
        # scan-resistant admission rows
        adm_scan = {c[4]: c for c in adm_rows
                    if c[1] == "scan" and c[2] == "16"}
        adm_z11 = {c[4]: c for c in adm_rows
                   if c[1] == "zipf-1.1" and c[2] == "16"}

        def _coh_share_monotone_ok():
            """1 when the serve-stale stale-read share is non-decreasing
            in the mutation rate (update_heavy stale20 rows, all rates)."""
            if not coh_rows:
                return None
            pts = sorted((float(c[5]), float(c[16])) for c in coh_rows
                         if (c[1], c[4]) == ("update_heavy", "stale20"))
            return int(all(pts[i][1] <= pts[i + 1][1] + 1e-12
                           for i in range(len(pts) - 1)))

        def _cap_monotone_ok():
            """1 when every config's SLO attainment is non-increasing in
            the offered rate (rows are emitted in sweep order)."""
            if not cap_rows:
                return None
            by_cfg = {}
            for c in cap_rows:
                by_cfg.setdefault(c[2], []).append(float(c[12]))
            return int(all(
                all(f[i] >= f[i + 1] - 1e-12 for i in range(len(f) - 1))
                for f in by_cfg.values()))
        record = {
            "schema": "bench_dcache/v9",
            "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "platform": {"python": platform.python_version(),
                         "machine": platform.machine()},
            "args": {"full": args.full, "skip_serving": args.skip_serving,
                     "parallel": args.parallel, "pr3_grid": args.pr3_grid,
                     "n_table1": n1, "n_ablation": n23},
            "total_wall_s": round(total_wall, 3),
            "sections": [{"id": s["id"], "name": s["name"],
                          "wall_s": s["wall_s"],
                          "n_rows": len(s["rows"])} for s in sections],
            "summary": {
                "table1_mean_sim_speedup": _csv_field(
                    t1_rows, "table1_summary", 2),
                "table1_dcache_mean_sim_time_s": _mean_sim_time(t1_rows),
                "concurrency_max_sessions": (int(conc_max[1])
                                             if conc_max else None),
                "concurrency_p95_latency_s": (float(conc_max[5])
                                              if conc_max else None),
                "concurrency_stall_total_s": (float(conc_max[9])
                                              if conc_max else None),
                "concurrency_local_hit_pct": (float(conc_max[13])
                                              if conc_max else None),
                "prefetch_max_sessions": (int(pf_max[1]) if pf_max else None),
                "prefetch_p95_latency_s": (float(pf_max[5])
                                           if pf_max else None),
                "prefetch_p95_speedup": (float(pf_max[15])
                                         if pf_max else None),
                "prefetch_overlap_s": (float(pf_max[13]) if pf_max else None),
                # 4:1 saturation cell (16 sessions / 4 pods): the
                # queueing-aware budget must keep this >= 1.0
                "prefetch_p95_speedup_4to1": (float(pf_sat[15])
                                              if pf_sat else None),
                # admission headline (working-set low reuse, 16 sessions /
                # 4 pods): baseline vs TinyLFU local-hit % and p95
                "admission_base_local_hit_pct": _adm(adm_cell, "none", 6),
                "admission_tinylfu_local_hit_pct": _adm(adm_cell, "tinylfu",
                                                        6),
                "admission_base_p95_s": _adm(adm_cell, "none", 8),
                "admission_tinylfu_p95_s": _adm(adm_cell, "tinylfu", 8),
                "admission_bypassed": _adm(adm_cell, "tinylfu", 11,
                                           cast=int),
                "admission_llm_agreement_pct": _adm(adm_cell, "llm-tinylfu",
                                                    13),
                # scale cells (batched sketch + de-Pythonized loop)
                "admission_256_local_hit_pct": _adm(adm_256, "tinylfu", 6),
                "admission_256_p95_s": _adm(adm_256, "tinylfu", 8),
                # cost-aware ablation on the widened 10-208 MB band
                "admission_cost_hit_delta_pp": _adm(adm_wide, "tinylfu-cost",
                                                    16),
                # adaptive depth guard: the recovered 8/8 mid-range win and
                # the held 4:1 saturation cell
                "prefetch_adaptive_p95_speedup_8_8": (
                    float(pf_adaptive[(8, 8)][15])
                    if (8, 8) in pf_adaptive else None),
                "prefetch_adaptive_p95_speedup_4to1": (
                    float(pf_adaptive[(16, 4)][15])
                    if (16, 4) in pf_adaptive else None),
                # hot-key replication, 16 sessions / 4 pods zipf-global:
                # vs the same-admission baseline of the cell
                "replication_hit_delta_pp": _adm(rep_cell, "tinylfu+repl",
                                                 18),
                "replication_p95_speedup": _adm(rep_cell, "tinylfu+repl",
                                                17),
                "replication_vs_none_hit_delta_pp": _adm(rep_cell, "repl",
                                                         18),
                "replication_llm_agreement_pct": _adm(rep_cell, "llm-repl",
                                                      15),
                # session->pod affinity: the 16/4 penalty-2x
                # acceptance cell — replication must beat
                # install-everything by >1.07x p95, with the win carried
                # by remote-read-share conversion
                "locality_base_p95_2x_s": _adm(loc_cell, (2.0, "none"), 12),
                "locality_repl_p95_speedup_2x": _adm(loc_cell,
                                                     (2.0, "repl"), 17),
                "locality_repl_p95_speedup_4x": _adm(loc_cell,
                                                     (4.0, "repl"), 17),
                "locality_base_remote_read_pct_2x": _adm(loc_cell,
                                                         (2.0, "none"), 7),
                "locality_repl_remote_read_pct_2x": _adm(loc_cell,
                                                         (2.0, "repl"), 7),
                "locality_repl_hit_delta_pp_2x": _adm(loc_cell,
                                                      (2.0, "repl"), 18),
                "locality_llm_agreement_pct": _adm(loc_cell,
                                                   (2.0, "llm-repl"), 15),
                "locality_256_repl_p95_speedup": _adm(loc_256,
                                                      (2.0, "repl"), 17),
                # fault-injected fleet: hit-EWMA recovery time
                # after the worst-case single-pod failure, mean over seeds
                # 1-3 — replication-on must be measurably shorter
                "resilience_recovery_s_repl_off": _res_mean_recovery(
                    "repl-off"),
                "resilience_recovery_s_repl_on": _res_mean_recovery(
                    "repl-on"),
                # zero-stall-forever gate: total unfinished sessions
                # across every fault-matrix cell (must be 0)
                "resilience_incomplete_total": (
                    sum(int(c[32]) for c in res_rows) if res_rows else None),
                "resilience_llm_agreement_pct": (float(res_llm[29])
                                                 if res_llm else None),
                "resilience_autoscale_actions": (int(res_auto[31])
                                                 if res_auto else None),
                # open-loop capacity sweep: max sustainable
                # Poisson arrival rate per config under the p99 SLO. The
                # headline is the tinylfu:base knee ratio — admission is
                # a CAPACITY feature under offered load
                "capacity_slo_p99_s": (float(cap_rows[0][4])
                                       if cap_rows else None),
                "capacity_knee_base_sps": cap_knee.get("base"),
                "capacity_knee_tinylfu_sps": cap_knee.get("tinylfu"),
                "capacity_knee_repl_sps": cap_knee.get("repl"),
                "capacity_knee_sticky2x_sps": cap_knee.get("sticky2x"),
                # queueing locks aggregated over every swept cell: flow
                # imbalance (spawned - completed - in_system, must be 0),
                # unfinished sessions (must be 0), and SLO-attainment
                # monotonicity per config (must be 1)
                "capacity_flow_imbalance_total": (
                    sum(int(c[5]) - int(c[6]) - int(c[7])
                        for c in cap_rows) if cap_rows else None),
                "capacity_incomplete_total": (
                    sum(int(c[17]) for c in cap_rows)
                    if cap_rows else None),
                "capacity_slo_monotone_ok": _cap_monotone_ok(),
                # non-Poisson arrival axes: the same
                # flow-balance and zero-incomplete gates on the diurnal
                # and MMPP rows
                "capacity_arrival_flow_imbalance_total": (
                    sum(int(c[5]) - int(c[6]) - int(c[7])
                        for c in cap_arr) if cap_arr else None),
                "capacity_arrival_incomplete_total": (
                    sum(int(c[17]) for c in cap_arr) if cap_arr else None),
                # mutable data plane: stale reads under
                # write-invalidate summed over every cell (must be 0),
                # the GPT-driven serve-stale headline (update_heavy llm
                # vs wi p95, must be > 1 at a bounded stale share), the
                # graded agreement of the cache_update verdicts, and the
                # stale-share-monotone-in-write-rate lock (must be 1)
                "coherence_wi_stale_reads_total": (
                    sum(int(c[12]) for c in coh_rows if c[4] == "wi")
                    if coh_rows else None),
                "coherence_mutations_total": (
                    sum(int(c[9]) for c in coh_rows) if coh_rows else None),
                "coherence_headline_p95_speedup": _adm(coh_cell, "llm", 20),
                "coherence_headline_stale_share_pct": _adm(coh_cell, "llm",
                                                           16),
                "coherence_llm_agreement_pct": _adm(coh_cell, "llm", 18),
                "coherence_stale20_max_staleness_s": _adm(coh_cell,
                                                          "stale20", 17),
                "coherence_share_monotone_ok": _coh_share_monotone_ok(),
                # decision-plane resilience: the no-fault
                # baseline p95 and the mixed-regime (10% staggered
                # outages + 8x straggler) p95 ratio per mitigation tier —
                # the headline is breaker-fallback holding <= ~1.1x while
                # naive retry degrades far worse
                "llmfault_base_p95_s": _adm(llf_cell, ("none", "naive"), 20),
                "llmfault_mixed_naive_p95_vs_base": _adm(
                    llf_cell, ("mixed", "naive"), 21),
                "llmfault_mixed_hedge_p95_vs_base": _adm(
                    llf_cell, ("mixed", "hedge"), 21),
                "llmfault_mixed_breaker_p95_vs_base": _adm(
                    llf_cell, ("mixed", "breaker"), 21),
                # blackout cell: the decision plane is gone — cache-op
                # decisions degrade to the programmatic twin instead of
                # stalling (structural never-stall-forever)
                "llmfault_blackout_breaker_degraded": _adm(
                    llf_cell, ("blackout", "breaker"), 13, cast=int),
                "llmfault_blackout_breaker_fallback_share_pct": _adm(
                    llf_cell, ("blackout", "breaker"), 14),
                "llmfault_flaky_parse_fallbacks": _adm(
                    llf_cell, ("flaky", "breaker"), 12, cast=int),
                "llmfault_breaker_adm_agreement_pct": _adm(
                    llf_cell, ("mixed", "breaker"), 18),
                # zero-stall gate across the whole regime x tier matrix
                "llmfault_incomplete_total": (
                    sum(int(c[22]) for c in llf_rows) if llf_rows else None),
                # scan-resistant admission (carried follow-up): the gated
                # variant must close most of the install-all-vs-TinyLFU
                # hit gap on the scan sweep without giving back the
                # TinyLFU win on zipf
                "admission_scan_base_local_hit_pct": _adm(adm_scan, "none",
                                                          6),
                "admission_scan_tinylfu_local_hit_pct": _adm(
                    adm_scan, "tinylfu", 6),
                "admission_scan_gated_local_hit_pct": _adm(
                    adm_scan, "scan-tinylfu", 6),
                "admission_zipf_gated_hit_delta_pp": _adm(
                    adm_z11, "scan-tinylfu", 16),
                # plan-cache tier: repeat-heavy hit rate, token
                # cut at p95 parity on the clean regime, and the faulted
                # headline — hits restore p95 toward the no-fault baseline
                # under the mixed outage+straggler regime at the
                # retry-only tier (p95_vs_off strictly < 1.0)
                "plancache_repeat60_hit_rate_pct": _adm(
                    pc_cell, ("none", "60", "python"), 9),
                "plancache_repeat60_p95_vs_off": _adm(
                    pc_cell, ("none", "60", "python"), 23),
                "plancache_repeat60_fleet_tokens": _adm(
                    pc_cell, ("none", "60", "python"), 19, cast=int),
                "plancache_repeat60_off_fleet_tokens": _adm(
                    pc_cell, ("none", "60", "off"), 19, cast=int),
                "plancache_zero_repeat_hits": _adm(
                    pc_cell, ("none", "0", "python"), 8, cast=int),
                "plancache_mixed_off_p95_s": _adm(
                    pc_cell, ("mixed", "60", "off"), 22),
                "plancache_mixed_python_p95_vs_off": _adm(
                    pc_cell, ("mixed", "60", "python"), 23),
                "plancache_mixed_llm_p95_vs_off": _adm(
                    pc_cell, ("mixed", "60", "llm"), 23),
                "plancache_llm_agreement_pct": _adm(
                    pc_cell, ("none", "60", "llm"), 16),
                "plancache_llm_tokens": _adm(
                    pc_cell, ("none", "60", "llm"), 17, cast=int),
                # zero-stale gate across every cell (measured, not trusted)
                "plancache_stale_served_total": (
                    sum(int(c[15]) for c in pc_rows) if pc_rows else None),
            },
        }
        if args.profile:
            record["profile"] = {
                s["id"]: s.get("profile", {}) for s in sections}
            record["profile"]["cumulative"] = {
                k: round(v, 6)
                for k, v in sorted(profiling.COUNTERS.items())}
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        print(f"# wrote {args.json}")


def _adm(cell_by_admission, admission, idx, cast=float):
    """Pull one field from the admission headline cell's row for the given
    admission mode (None when the row is missing)."""
    row = cell_by_admission.get(admission)
    if row is None:
        return None
    try:
        return cast(row[idx])
    except (ValueError, IndexError):
        return None


def _mean_sim_time(t1_rows) -> float:
    """Mean simulated per-task latency across Table I's dCache-on cells."""
    vals = [float(r.split(",")[11]) for r in t1_rows
            if r.startswith("table1,") and r.split(",")[4] == "on"]
    return round(sum(vals) / len(vals), 4) if vals else None


if __name__ == "__main__":
    main()
