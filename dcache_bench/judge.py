"""Whether the served tokens are right: the comparison that decides ``correct``.

Once the window has closed, a sample of the calls the window finished is
drawn from the seed: the call with the most served tokens, then others in
a seeded order until the sample holds ``check_tokens`` served tokens. The
plain reference (``reference/<name>.py``) runs once over each prompt with
its served tokens. Decoding is greedy, so each served token should be the
reference's best at its position up to rounding; the numbers compared are

- ``gap_max``: the widest gap by which a served token's reference logit
  lies below the reference's best logit at its position, over the sample;
- ``gap_mean``: the mean of those gaps;
- ``miss_share``: the share of served tokens that are not the
  reference's best (gap above 0), in %.

Each has a limit of its own in ``dcache_bench/limits/<workload>.json``,
set from the readings of sound runs and of the control (PERF.md).

The control is the reference put in the program's place one precision
step below the configuration's bf16: every weight product with both
operands rounded to float8 e4m3 (a per-tensor scale to the format's
largest value, 448). At each position of the same prompts and tokens it
reads the gap of the token the control puts first.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from dcache_bench.traffic import _seed_words

FP8_MAX = 448.0


def load_limits(root: Path, workload: str) -> Dict[str, float]:
    path = Path(root) / "dcache_bench" / "limits" / f"{workload}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits for {workload!r} at {path}")
    return json.loads(path.read_text())["limits"]


def load_reference(root: Path, name: str):
    path = Path(root) / "dcache_bench" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"dcache_bench_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(finished: Sequence, seed: int, check_tokens: int) -> List:
    """The longest finished call, then others in a seeded order, until
    ``check_tokens`` served tokens are held."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: (len(finished[i].out_ids), len(finished[i].prompt_ids)))
    order = np.random.default_rng(_seed_words(seed) + [7]).permutation(len(finished))
    picked, tokens = [longest], len(finished[longest].out_ids)
    for i in order:
        if tokens >= check_tokens:
            break
        if i != longest:
            picked.append(int(i))
            tokens += len(finished[i].out_ids)
    return [finished[i] for i in picked]


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    def q(t):
        t = t.float()
        s = FP8_MAX / t.abs().amax().clamp_min(1e-30)
        return (t * s).to(torch.float8_e4m3fn).float() / s
    return q(x) @ q(w)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, tokens[:, None].long())[:, 0]


def readings(ref, sizes: Dict, params: Dict, calls: Sequence, prompts: Dict[int, str],
             max_len: int, control: bool = False) -> Dict[str, float]:
    """The numbers compared over ``calls`` (served requests, ``prompts``
    their prompt text by request id): the program's served tokens' gaps,
    or with ``control`` the gaps of the tokens the float8 control puts
    first."""
    all_gaps = []
    for r in calls:
        ids = ref.tokenize(prompts[r.rid], max_len)
        ref_logits = ref.served_logits(sizes, params, ids, list(r.out_ids),
                                       max_len=max_len)
        if control:
            ctrl = ref.served_logits(sizes, params, ids, list(r.out_ids),
                                     max_len=max_len, linear=fp8_linear)
            toks = ctrl.argmax(dim=-1)
            del ctrl
        else:
            toks = torch.tensor(r.out_ids, device=ref_logits.device)
        all_gaps.append(gaps(ref_logits, toks).cpu())
        del ref_logits
    g = torch.cat(all_gaps) if all_gaps else torch.zeros(0)
    if not g.numel():
        return {"gap_max": float("inf"), "gap_mean": float("inf"),
                "miss_share": 100.0, "tokens": 0, "calls": len(calls)}
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "miss_share": 100.0 * float((g > 0).float().mean()),
            "tokens": int(g.numel()), "calls": len(calls)}
