"""Train a small config for a few hundred steps with checkpoints, two
injected node failures each recovered from the newest checkpoint on disk,
and a cold restart that resumes from the last one: the fault-tolerance
path end to end (the counterpart of ``examples/train_tiny.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_tiny --device cpu [--steps 200]
    PYTHONPATH=src python -m repro_torch.launch.train_tiny          # on cuda

The arch (qwen3-4b by default) runs at its reduced config. Training
reaches no kernel, so the reduced head dim of 16 runs on the card too.
Failures strike at steps/3 and steps/2; a checkpoint is written every
steps/10 steps (20 at the default 200, as in the reference).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.distributed import Checkpointer, FailureInjector, HeartbeatMonitor
from repro_torch.models.model import init_model
from repro_torch.training import AdamWConfig, Prefetcher, TokenStream, TrainLoop


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    dev = resolve_device(args.device)
    print(f"arch={cfg.name}  params={cfg.param_count() / 1e6:.2f}M  device={dev}")
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir, keep=2)
        mon = HeartbeatMonitor()
        data = Prefetcher(TokenStream(cfg, batch=8, seq=64, seed=0))
        fail_at = [args.steps // 3, args.steps // 2]
        loop = TrainLoop(
            cfg, AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=args.steps),
            params, data, checkpointer=ck, ckpt_every=max(args.steps // 10, 1),
            monitor=mon, failure_injector=FailureInjector(fail_at))
        try:
            t0 = time.perf_counter()
            loop.run(args.steps)
            dt = time.perf_counter() - t0
        finally:
            data.close()
        print(f"loss {loop.history[0]:.3f} -> {loop.history[-1]:.3f} "
              f"({args.steps} steps, {dt:.1f}s, "
              f"{8 * 64 * args.steps / dt:.0f} tok/s)")
        print(f"injected failures at {fail_at}: "
              f"{sum(f['restored'] for f in mon.failures)} of "
              f"{len(mon.failures)} recovered via checkpoint restore")
        kept = ck.available_steps()
        print(f"checkpoints kept: {kept}")

        # cold restart: resume from the last checkpoint
        data2 = Prefetcher(TokenStream(cfg, 8, 64, seed=0))
        try:
            loop2 = TrainLoop(cfg, AdamWConfig(), params, data2,
                              checkpointer=ck)
            if not loop2.restore_if_available():
                raise RuntimeError("cold restart found no checkpoint")
        finally:
            data2.close()
        print(f"cold restart resumes at step {loop2.step_idx} OK")
    return {"loop": loop, "restarted": loop2, "failures": mon.failures,
            "fail_at": fail_at, "kept": kept, "seconds": dt}


if __name__ == "__main__":
    main()
