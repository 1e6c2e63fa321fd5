"""Serving launcher: batched requests through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve            # full width, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke     # reduced, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-32b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --smoke --device cpu

Serves ``--arch`` (``dcache-agent-150m`` by default; ``rwkv6-7b``: 7.6 B
parameters, about 15 GB in bf16; the dense ``granite-3-2b``, ``qwen3-4b``,
``phi3-mini-3.8b`` and ``qwen1.5-32b``: 35.2 B parameters, 70.4 GB, one
H100 at full depth; the hybrid ``hymba-1.5b``, 1.2 B parameters; the MoE
``mixtral-8x22b`` and ``llama4-maverick-400b-a17b``, 141 B and about 400 B
parameters, which need several cards at full depth; the vlm
``llava-next-34b``, 34.4 B parameters, 68.9 GB, one H100, served text
prompts as the engine serves them, with no image; the encoder-decoder
``seamless-m4t-large-v2``, 1.6 B parameters) with random weights from a
``torch.Generator`` seeded with 0. The engine does not take an
encoder-decoder model (its requests carry no frames): for it the launcher
runs ``generate_encdec``, the prompts right-padded in one batch beside
``max_len // 2`` seeded random frame embeddings each (the length the
cache's ``cross_k`` has), through ``prefill_step`` and greedy
``decode_step``s. On the card the weights' bytes
are held against the card's free memory before anything is drawn, and the
launcher raises, naming both, when they do not fit. ``--smoke`` selects
the reduced config (vocab 512, head dim 16), which serves on the card as
on the CPU for every family but rwkv6 (the WKV kernel is built for head
dim 64 only, so ``--smoke --arch rwkv6-7b`` runs with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.bridge import _dict_map, param_shapes
from repro_torch.configs import ALL_IDS, ModelConfig, get_config
from repro_torch.models.model import decode_step, init_model, prefill_step
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.training.optimizer import tree_leaves

PROMPTS = [
    "Plot the xview1 images from 2022 around Newport Beach",
    "Detect airplanes in this area",
    "Show fair1m and xview1 imagery from 2022",
    "Classify the land cover near Houston",
    "How many ships were detected in Miami in 2021?",
    "Render a heatmap of detections for Seattle",
    "What does the Denver area look like?",
    "Count the cloudy scenes in sentinel2-2020",
]


def weight_bytes(cfg: ModelConfig) -> int:
    """The bytes of ``cfg``'s weights in its dtype."""
    es = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return es * sum(tree_leaves(_dict_map(math.prod, param_shapes(cfg))))


def check_fits(cfg: ModelConfig, free_bytes: int) -> None:
    """Raise, naming both numbers, when ``cfg``'s weights need more than
    ``free_bytes``."""
    need = weight_bytes(cfg)
    if need > free_bytes:
        raise MemoryError(
            f"{cfg.name} at {cfg.n_layers} layers has {need / 1e9:.2f} GB of "
            f"{cfg.dtype} weights and the card has {free_bytes / 1e9:.2f} GB "
            "free")


@torch.no_grad()
def generate_encdec(cfg: ModelConfig, params, ids, frames: torch.Tensor,
                    max_len: int, steps: int) -> torch.Tensor:
    """Greedy generation for an encoder-decoder model: the token prompts
    ``ids`` (lists of ints) right-padded into one batch with their true
    lengths, beside ``frames`` (B, S_enc, D), through one ``prefill_step``
    (a ring of ``max_len`` slots) and ``steps`` ``decode_step``s. Returns
    the (B, steps + 1) generated tokens."""
    dev = frames.device
    S = max(len(i) for i in ids)
    toks = torch.tensor([i + [0] * (S - len(i)) for i in ids],
                        dtype=torch.int32, device=dev)
    lens = torch.tensor([len(i) for i in ids], dtype=torch.int32, device=dev)
    cache, logits = prefill_step(cfg, params, {"tokens": toks, "frames": frames},
                                 max_len=max_len, true_lens=lens)
    out = [logits[:, -1].argmax(-1).to(torch.int32)]
    for _ in range(steps):
        logits, cache = decode_step(cfg, params, out[-1][:, None], cache)
        out.append(logits[:, -1].argmax(-1).to(torch.int32))
    return torch.stack(out, dim=1)


def main(argv=None) -> Optional[ServingEngine]:
    """Serve ``--requests`` prompts and print them; returns the engine (None
    for the encoder-decoder, which generates without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dcache-agent-150m", choices=ALL_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=512)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        check_fits(cfg, torch.cuda.mem_get_info(dev)[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_model(cfg, gen, dev)
    if cfg.is_encdec:
        tok = ByteTokenizer()
        ids = [tok.encode(PROMPTS[i % len(PROMPTS)])
               for i in range(args.requests)]
        frames = torch.randn((len(ids), args.max_len // 2,
                              cfg.d_model), generator=gen, device=dev,
                             dtype=cfg.torch_dtype)
        out = generate_encdec(cfg, params, ids, frames, args.max_len,
                              args.max_new - 1)
        for i, row in zip(ids, out.tolist()):
            print(f"{tok.decode(i)!r} + {frames.shape[1]} frames -> "
                  f"{tok.decode(row)!r}")
        return None
    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        max_len=args.max_len, device=dev)
    reqs = [eng.submit(PROMPTS[i % len(PROMPTS)], max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng.run_until_done()
    for r in reqs:
        print(f"[{r.rid}] {eng.tok.decode(r.prompt_ids)!r} -> "
              f"{eng.tok.decode(r.out_ids)!r}")
    print("stats:", eng.stats())
    return eng


if __name__ == "__main__":
    main()
