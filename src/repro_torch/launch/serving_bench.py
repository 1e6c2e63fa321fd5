"""Serving-engine and kernel micro-benchmarks, the counterpart of
``benchmarks/serving_bench.py``.

    PYTHONPATH=src python -m repro_torch.launch.serving_bench              # cuda
    PYTHONPATH=src python -m repro_torch.launch.serving_bench --device cpu

``bench_serving`` serves the reference's bench configuration (the reduced
``dcache-agent-150m`` at vocab 512, ``max_batch`` 4, ``max_len`` 128, the
same prompt strings) and prints the same ``bench,metric,value`` rows. Its
head dim is 16. ``bench_kernels`` times the flash-attention kernel on the
card with CUDA events at the reference's shapes (q (1,4,256,64), k/v
(1,2,256,64), fp32); it raises without a card, since a CPU time is no
kernel time. The reference's ``bench_cache_ops`` times the cache of
``repro.core``, which has no counterpart in the port, and is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_model
from repro_torch.serving import ServingEngine


def bench_config() -> ModelConfig:
    """The reference bench's model: reduced dcache-agent-150m, vocab 512."""
    return dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                               vocab_size=512)


def run_bench(cfg: ModelConfig, params: Dict, n_requests: int, max_new: int,
              device) -> Tuple[ServingEngine, List, float]:
    """Submit the bench's requests and serve them to completion. Returns
    (engine, requests, seconds of ``run_until_done``)."""
    eng = ServingEngine(cfg, params, max_batch=4, max_len=128, device=device)
    reqs = [eng.submit(f"benchmark request number {i}", max_new_tokens=max_new)
            for i in range(n_requests)]
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    eng.run_until_done()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, reqs, time.perf_counter() - t0


def bench_serving(n_requests: int = 6, max_new: int = 8, *,
                  cfg: Optional[ModelConfig] = None, params: Optional[Dict] = None,
                  device=None) -> List[str]:
    """The reference's serving rows. Weights are seeded random (a
    ``torch.Generator`` seeded with 0) unless ``params`` is given."""
    dev = resolve_device(device)
    cfg = cfg or bench_config()
    if params is None:
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng, _, dt = run_bench(cfg, params, n_requests, max_new, dev)
    return serving_rows(eng, dt)


def serving_rows(eng: ServingEngine, seconds: float) -> List[str]:
    """The reference's ``bench,metric,value`` rows of a served bench run."""
    s = eng.stats()
    return [
        "bench,metric,value",
        f"serving,requests,{s['finished']}",
        f"serving,wall_s,{seconds:.3f}",
        f"serving,throughput_tok_s,{s['throughput_tok_s']:.2f}",
        f"serving,mean_ttft_s,{s['mean_ttft_s']:.3f}",
    ]


def bench_kernels(device=None) -> List[str]:
    """The flash-attention kernel's time per call on the card (CUDA events
    around 3 calls after one warm-up, as the reference times 3), at the
    reference's shapes."""
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_kernels times the CUDA kernel and runs on "
                           "the card only")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
               for s in ((1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    ops.flash_attention(q, k, v)
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        ops.flash_attention(q, k, v)
    end.record()
    torch.cuda.synchronize(dev)
    us = start.elapsed_time(end) / 3 * 1e3
    return [f"kernel_flash_attn,us_per_call,{us:.1f}"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = bench_serving(device=args.device)
    if resolve_device(args.device).type == "cuda":
        rows += bench_kernels(args.device)
    print("\n".join(rows))


if __name__ == "__main__":
    main()
