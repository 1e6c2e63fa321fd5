"""Training launcher (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --preset full \
        --steps 300 --batch 8 --seq 256                      # on cuda
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --preset smoke --device cpu

``--preset smoke`` trains the arch's reduced config; ``--preset full`` the
real one (on one card only sensible for dcache-agent-150m). Weights come
from a ``torch.Generator`` seeded with 0 on the run's device. Checkpoints,
the heartbeat monitor and the prefetching data pipeline are active in both
presets, and ``--resume`` restores the newest checkpoint in ``--ckpt-dir``.
The checkpoints are the JAX launcher's format: either side resumes the
other's. Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_IDS, get_config
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.models.model import init_model
from repro_torch.training.data import Prefetcher, TokenStream
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainLoop


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dcache-agent-150m", choices=ALL_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Tuple[TrainLoop, Prefetcher]:
    """The loop ``main`` runs (restored from the newest checkpoint with
    ``--resume``) and its data pipeline, which the caller closes."""
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M device={dev}")
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    data = Prefetcher(TokenStream(cfg, batch=args.batch, seq=args.seq, seed=0),
                      depth=2)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    loop = TrainLoop(cfg, opt_cfg, params, data,
                     checkpointer=Checkpointer(args.ckpt_dir, keep=2),
                     ckpt_every=args.ckpt_every, accum_steps=args.accum,
                     monitor=HeartbeatMonitor())
    if args.resume and loop.restore_if_available():
        print(f"resumed from step {loop.step_idx}")
    return loop, data


def main(argv: Optional[List[str]] = None) -> TrainLoop:
    args = parse_args(argv)
    loop, data = build(args)
    try:
        t0 = time.perf_counter()
        metrics = loop.run(args.steps)
        dt = time.perf_counter() - t0
    finally:
        data.close()
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"done: {metrics}  ({dt:.1f}s, {tok_s:.0f} tok/s, "
          f"loss {loop.history[0]:.3f} -> {loop.history[-1]:.3f}, "
          f"stragglers={len(loop.monitor.stragglers)})" if loop.history
          else f"done: no step left to run at step {loop.step_idx}")
    return loop


if __name__ == "__main__":
    main()
