"""Quickstart: LLM-dCache in 60 seconds (the counterpart of
``examples/quickstart.py``; it prints the same lines).

Builds the GeoLLM-Engine sim + tool-calling agent, runs the same workload
with and without GPT-driven caching, and prints the paper's headline
numbers (speedup, GPT-hit rate, unchanged agent metrics).

    PYTHONPATH=src python -m repro_torch.launch.quickstart
"""
from repro_torch.agent import build_runtime, build_tasks
from repro_torch.core.prompts import read_decision_prompt

N_TASKS = 100


def main():
    print("=" * 70)
    print("LLM-dCache quickstart — GPT-driven localized data caching")
    print("=" * 70)

    # --- what the LLM actually sees for a cache-read decision -------------
    prompt = read_decision_prompt(
        "Show fair1m and xview1 imgs from 2022",
        ["fair1m-2022", "xview1-2022"],
        '{"xview1-2022": {"last_access": 3.1, "access_count": 2}}',
        few_shot=True)
    print("\n--- cache-read decision prompt (truncated) ---")
    print(prompt[:600] + " [...]\n")

    # --- run the benchmark both ways --------------------------------------
    reports = {}
    for use_cache in (False, True):
        rt = build_runtime(model="gpt-4-turbo", prompting="cot",
                           few_shot=True, use_cache=use_cache, seed=0)
        tasks = build_tasks(N_TASKS, reuse_rate=0.8, seed=1, store=rt.store)
        reports[use_cache] = (rt.run_and_evaluate(tasks), rt)

    r0, _ = reports[False]
    r1, rt1 = reports[True]
    print(f"{'':24s}{'no cache':>12s}{'LLM-dCache':>12s}")
    for name, a, b in (
            ("success rate", r0.success_rate, r1.success_rate),
            ("correctness", r0.correctness, r1.correctness),
            ("obj-det F1", r0.obj_det_f1, r1.obj_det_f1),
            ("VQA ROUGE-L", r0.vqa_rouge, r1.vqa_rouge)):
        print(f"{name:24s}{a:12.3f}{b:12.3f}")
    print(f"{'avg tokens/task':24s}{r0.avg_tokens:12.0f}{r1.avg_tokens:12.0f}")
    print(f"{'avg time/task (s)':24s}{r0.avg_time_s:12.2f}"
          f"{r1.avg_time_s:12.2f}")
    print(f"\nspeedup: {r0.avg_time_s / r1.avg_time_s:.2f}x "
          f"(paper: 1.24x avg)")
    st = rt1.cache.stats
    print(f"cache hit rate: {100 * st.hit_rate:.1f}%   "
          f"GPT-hit rate: {100 * st.gpt_hit_rate:.1f}% (paper: ~96-98%)")
    print(f"cache contents now: {sorted(rt1.cache.keys())}")


if __name__ == "__main__":
    main()
