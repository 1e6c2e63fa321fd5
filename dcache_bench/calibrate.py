"""Readings that set a cell's limits: the program's and the control's.

    python3 dcache_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 15 --control 3 [--out build/calibrate_<cell>.jsonl]

For each seed, in one process on the card: the cell's set-up and a short
window at the cell's own load and sizes, then the numbers that decide
``correct`` (``judge.readings``) over the run's own seeded sample; for the
first ``--control`` seeds also the control's numbers on the same sample
(the reference with every weight product in float8 e4m3 in the program's
place). One JSON line per seed, to standard output and to ``--out``. The
benchmark's own runs never run the control.
"""
import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from dcache_bench import harness, judge
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = harness.prepare(ROOT, args.workload)
    out = Path(args.out or ROOT / "build" / f"calibrate_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        sv = harness.serve(cell, seed, args.seconds, False, "cuda", t0)
        sample = judge.sample(sv.finished, seed, int(cell.mix["check_tokens"]))
        row = {"workload": args.workload, "seed": seed,
               "distinct_token_share": sum(len(set(r.out_ids)) / len(r.out_ids)
                                           for r in sample) / max(len(sample), 1),
               "program": judge.readings(cell.ref, cell.sizes, sv.params, sample,
                                         sv.prompts, cell.sizes["max_len"]),
               "calls_per_s": sv.e2e["calls_per_s"], "setup_s": sv.e2e["setup_s"]}
        if i < args.control:
            row["control"] = judge.readings(cell.ref, cell.sizes, sv.params, sample,
                                            sv.prompts, cell.sizes["max_len"],
                                            control=True)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        del sv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
