"""Decode-time cache shapes (the dense family of ``repro.configs.shapes``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def effective_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """KV entries actually retained at decode time (SWA/chunk bound it)."""
    cap = seq_len
    if cfg.sliding_window is not None:
        cap = min(cap, cfg.sliding_window)
    if cfg.attn_chunk is not None:
        cap = min(cap, cfg.attn_chunk)
    return cap


def alloc_cache(cfg: ModelConfig, batch: int, seq_len: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache, laid out as ``cache_specs`` lays it out.

    ``pos`` (B,) int32 and layer-stacked ring buffers ``k``/``v``
    (L, B, C, KV*hd) in the model dtype.
    """
    if cfg.family != "dense" or cfg.kv_quant:
        raise NotImplementedError(
            f"cache for family {cfg.family!r} (kv_quant={cfg.kv_quant}) is "
            "not ported yet")
    C = effective_cache_len(cfg, seq_len)
    kv = cfg.n_kv_heads * cfg.head_dim_
    shape = (cfg.n_layers, batch, C, kv)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
    }
