"""The dry-run's analytic terms (``repro.launch.dryrun``): a first-order
HBM traffic model, the recurrence FLOPs that a scan hides, and the model
FLOPs of a step, for any (architecture, assigned shape, chip count).

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dcache-agent-150m \\
        --shape decode_32k --chips 1

These are the reference's arithmetic, copied as it is, on
``ModelConfig.param_count``'s approximation. The rest of the reference's
dry-run has no counterpart here and is not ported: it lowers and compiles
each cell with XLA on a 256- or 512-device TPU mesh, reads the compiled
artifact's memory and cost analyses, parses collectives out of the HLO
text, extrapolates per-layer costs from unrolled probes, and divides by TPU
peak rates. Device times on the card come from a run (``chip_smoke.py``),
never from these counts alone; a caller that wants a bound divides them by
the card's own rates.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

from repro_torch.configs import (ALL_IDS, SHAPES, ShapeSpec,
                                 effective_cache_len, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, n_chips: int) -> float:
    """Per-chip HBM bytes of one step: the unavoidable streams of weights
    (with the optimizer state when training), boundary activations (with
    the block remat's recompute) and the KV cache's writes (prefill) or
    reads (decode), all in bf16 but the int8 cache, its scales and the fp32
    recurrent states."""
    P = float(cfg.param_count())
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers
    dt = 2.0  # bf16
    kvd = cfg.n_kv_heads * cfg.head_dim_
    C = effective_cache_len(cfg, S)
    if shape.kind == "train":
        tokens = B * S
        # fwd read + bwd read + param write (bf16); grads, m and v in fp32
        weights = P * (3 * dt + 3 * 4.0)
        # remat "block": each layer's input written and read back, and about
        # two more streams a layer recomputed
        acts = tokens * D * L * dt * 4.0
        kv = 0.0
    elif shape.kind == "prefill":
        tokens = B * S
        weights = P * dt
        acts = tokens * D * L * dt * 2.0
        kv = L * B * C * kvd * 2 * dt            # cache writes
    else:  # decode: every weight and the whole cache read once a step
        tokens = B
        weights = P * dt
        acts = tokens * D * L * dt * 4.0
        kv_elt = 1.0 if cfg.kv_quant else dt     # int8 cache halves traffic
        kv = L * B * C * kvd * 2 * kv_elt
        if cfg.kv_quant:
            kv += L * B * C * cfg.n_kv_heads * 2 * dt   # scales
        if cfg.family in ("ssm", "hybrid") and cfg.ssm:
            kv += L * B * cfg.n_ssm_heads * cfg.ssm.head_dim \
                * cfg.ssm.state_size * 4.0 * 2   # fp32 state read+write
    return (weights + acts + kv) / n_chips


def ssm_recurrence_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The recurrence's FLOPs over all tokens of the step (global, not per
    chip): 8 per state element a token and layer, three times over when
    training (forward and backward)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    H, hd = cfg.n_ssm_heads, cfg.ssm.head_dim
    inner = hd * hd if cfg.family == "ssm" else hd * cfg.ssm.state_size
    per_tok = cfg.n_layers * H * 8 * inner
    mult = 3.0 if shape.kind == "train" else 1.0
    return tokens * per_tok * mult


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Model FLOPs of one step (global) on the active parameters N: 6 N B S
    to train, 2 N B S to prefill, 2 N B to decode one token a row."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return float(6 * n_active * B * S)
    if shape.kind == "prefill":
        return float(2 * n_active * B * S)
    return float(2 * n_active * B)


def cell(arch: str, shape_name: str, n_chips: int, kv_quant: bool = False) -> Dict:
    """The analytic terms of one (arch, shape) cell, or its skip reason."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch), kv_quant=kv_quant)
    shape = SHAPES[shape_name]
    out = {"arch": arch, "shape": shape_name, "n_chips": n_chips,
           "kv_quant": kv_quant}
    skip = shape_applicable(cfg, shape)
    if skip:
        out["skipped"] = skip
        return out
    out.update(hbm_bytes=analytic_hbm_bytes(cfg, shape, n_chips),
               ssm_recurrence_flops=ssm_recurrence_flops(cfg, shape),
               model_flops_total=model_flops(cfg, shape),
               model_flops_per_chip=model_flops(cfg, shape) / n_chips)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--kv-quant", action="store_true")
    args = ap.parse_args(argv)
    archs = ALL_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    for a in archs:
        for s in shapes:
            print(json.dumps(cell(a, s, args.chips, args.kv_quant)))


if __name__ == "__main__":
    main()
