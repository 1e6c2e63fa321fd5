"""Agent-metric evaluation (paper §IV "Metrics").

Success Rate, Correctness Ratio, object-detection F1, LCC recall, VQA
ROUGE-L, average tokens/time per task — the Table I columns — plus cache
statistics (hit rate and GPT-hit rate for Table III).

Latency aggregation follows [20] as the paper does: running average per
task with outliers beyond 2 sigma discarded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.agent.geollm.workload import Task


def rouge_l(pred: str, gold: str) -> float:
    a, b = (pred or "").split(), (gold or "").split()
    if not a or not b:
        return 0.0
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i in range(len(a)):
        for j in range(len(b)):
            dp[i + 1, j + 1] = (dp[i, j] + 1 if a[i] == b[j]
                                else max(dp[i, j + 1], dp[i + 1, j]))
    lcs = int(dp[len(a), len(b)])
    prec, rec = lcs / len(a), lcs / len(b)
    return 0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)


def _det_f1(pred: Optional[Dict], gold: Dict) -> float:
    if not isinstance(pred, dict) or "detections" not in pred:
        return 0.0
    tp = min(pred["detections"], gold["detections"])
    fp = pred["detections"] - tp
    fn = gold["detections"] - tp
    denom = 2 * tp + fp + fn
    return (2 * tp / denom) if denom else 1.0


def _lcc_recall(pred: Optional[List[str]], gold: List[str]) -> float:
    if not isinstance(pred, list) or not gold:
        return 0.0
    return len(set(pred) & set(gold)) / len(set(gold))


@dataclasses.dataclass
class Report:
    n_tasks: int
    success_rate: float
    correctness: float
    obj_det_f1: float
    lcc_recall: float
    vqa_rouge: float
    avg_tokens: float
    avg_time_s: float
    total_tool_calls: int
    cache_hit_rate: float = 0.0
    gpt_hit_rate: float = 1.0

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def trimmed_mean(xs: List[float]) -> float:
    """Running-average policy of [20]: drop outliers beyond 2 sigma."""
    a = np.asarray(xs, np.float64)
    if len(a) < 4:
        return float(a.mean()) if len(a) else 0.0
    m, s = a.mean(), a.std()
    keep = np.abs(a - m) <= 2 * s
    return float(a[keep].mean())


def evaluate(tasks: List[Task], traces: List,
             cache_stats=None) -> Report:
    assert len(tasks) == len(traces)
    succ, f1s, lccs, rouges = [], [], [], []
    good_calls = bad_calls = 0
    for task, tr in zip(tasks, traces):
        succ.append(tr.success and all(
            tr.answers.get(i) is not None for i in range(len(task.steps))))
        good_calls += tr.tool_calls - tr.bad_calls
        bad_calls += tr.bad_calls
        for i, step in enumerate(task.steps):
            pred = tr.answers.get(i)
            if step.kind == "detect":
                f1s.append(_det_f1(pred, step.gold))
            elif step.kind == "lcc":
                lccs.append(_lcc_recall(pred, step.gold))
            elif step.kind == "vqa":
                rouges.append(rouge_l(pred if isinstance(pred, str) else "",
                                      step.gold))
    total_calls = good_calls + bad_calls
    rep = Report(
        n_tasks=len(tasks),
        success_rate=float(np.mean(succ)) if succ else 0.0,
        correctness=good_calls / total_calls if total_calls else 0.0,
        obj_det_f1=float(np.mean(f1s)) if f1s else 0.0,
        lcc_recall=float(np.mean(lccs)) if lccs else 0.0,
        vqa_rouge=float(np.mean(rouges)) if rouges else 0.0,
        avg_tokens=float(np.mean([t.tokens for t in traces])),
        avg_time_s=trimmed_mean([t.time_s for t in traces]),
        total_tool_calls=total_calls,
    )
    if cache_stats is not None:
        rep.cache_hit_rate = cache_stats.hit_rate
        rep.gpt_hit_rate = cache_stats.gpt_hit_rate
    return rep
