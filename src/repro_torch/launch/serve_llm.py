"""End-to-end driver (the counterpart of ``examples/serve_llm.py``): train
a model briefly, serve batched requests through the continuous-batching
engine, then use it as the agent's decision LLM (``TorchLLM``).

    PYTHONPATH=src python -m repro_torch.launch.serve_llm             # full width, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --smoke     # reduced, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --smoke --device cpu

By default it trains full-width ``dcache-agent-150m`` in bf16 on ``cuda``,
weights from a ``torch.Generator`` seeded with 0. ``--smoke`` is the JAX
example's own config (``dcache-agent-150m.reduced()`` with vocab 512, 4
layers, d 128, 4 heads over 2 kv heads, head dim 16), served on the card
by the attention kernels' head-dim 16 instances, or on the CPU by their
plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.agent import TorchLLM
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_model
from repro_torch.serving import ServingEngine
from repro_torch.training import AdamWConfig, TokenStream, TrainLoop

PROMPTS = [
    "Plot the xview1 images from 2022",
    "Detect airplanes around Newport Beach",
    "Show fair1m and xview1 imagery",
    "Classify land cover near Houston",
    "Count ships in Miami 2021",
    "Heatmap of detections for Seattle",
    "Describe the Denver area",
    "List cloudy sentinel2 scenes",
]
DECISION_PROMPT = ('Cache: {}  Required keys: ["xview1-2022"]  '
                   "Answer (JSON): ")


def build_config(smoke: bool) -> ModelConfig:
    cfg = get_config("dcache-agent-150m")
    if smoke:
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=512, n_layers=4,
                                  d_model=128, d_ff=512, n_heads=4,
                                  n_kv_heads=2)
    return cfg


def train(cfg: ModelConfig, params: Dict, data: Iterator[Dict[str, np.ndarray]],
          steps: int, opt_cfg: AdamWConfig, monitor=None
          ) -> Tuple[TrainLoop, List[Dict[str, float]]]:
    """``steps`` AdamW steps over ``data`` (no checkpoints). Returns the
    loop, which holds the trained params, and each step's metrics."""
    loop = TrainLoop(cfg, opt_cfg, params, data, ckpt_every=0,
                     monitor=monitor)
    return loop, [loop.run(i + 1) for i in range(steps)]


def serve(cfg: ModelConfig, params: Dict, prompts: Sequence[str], *,
          max_new_tokens: int = 12, max_batch: int = 4, max_len: int = 192,
          device=None):
    """Serve ``prompts`` to completion; returns (engine, requests)."""
    eng = ServingEngine(cfg, params, max_batch=max_batch, max_len=max_len,
                        device=device)
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    eng.run_until_done()
    return eng, reqs


def decide(eng: ServingEngine, max_new_tokens: int = 24) -> str:
    """The served model as the cache-decision backend."""
    return TorchLLM(eng, max_new_tokens=max_new_tokens).complete(DECISION_PROMPT)


def main(argv: Optional[List[str]] = None) -> ServingEngine:
    """Train, serve the prompts and ask for a cache decision; returns the
    serving engine."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX example's reduced config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = build_config(args.smoke)
    dev = resolve_device(args.device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    print(f"model: {cfg.param_count() / 1e6:.2f}M params on {dev}")

    stream = TokenStream(cfg, batch=8, seq=64, seed=0)
    t0 = time.perf_counter()
    loop, metrics = train(cfg, params, iter(stream.next_batch, None),
                          args.steps, AdamWConfig(lr=1e-3, warmup_steps=5,
                                                  total_steps=args.steps))
    print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f}s: "
          f"loss {loop.history[0]:.3f} -> {loop.history[-1]:.3f}, "
          f"grad_norm {metrics[-1]['grad_norm']:.3f}")

    t0 = time.perf_counter()
    eng, reqs = serve(cfg, loop.params, PROMPTS[:args.requests], device=dev)
    s = eng.stats()
    print(f"\nserved {s['finished']} requests in {time.perf_counter() - t0:.1f}s "
          f"({s['throughput_tok_s']:.1f} tok/s, "
          f"ttft {s['mean_ttft_s'] * 1e3:.0f} ms)")
    for r in reqs[:3]:
        print(f"  [{r.rid}] -> {eng.tok.decode(r.out_ids)!r}")
    print(f"\nTorchLLM cache-decision completion (untuned byte-LM): "
          f"{decide(eng)!r}")
    return eng


if __name__ == "__main__":
    main()
