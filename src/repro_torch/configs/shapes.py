"""Decode-time cache shapes (``repro.configs.shapes.cache_specs`` for every
family)."""
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

    Every family has ``pos`` (B,) int32. The attention families (dense,
    moe, hybrid) add layer-stacked ring buffers ``k``/``v`` (L, B, C, KV*hd)
    in the model dtype, or, with ``cfg.kv_quant``, in int8 beside
    per-token-per-head scales ``k_scale``/``v_scale`` (L, B, C, KV) in the
    model dtype (0 in an empty slot; a prefilled pad slot gets 1.0 from
    ``quantize_kv``). The hybrid family (Mamba heads) adds the SSM state
    ``ssm_state`` (L, B, H, hd, N) in fp32 and, with a conv wider than 1,
    the conv's last inputs ``conv_state`` (L, B, cw-1, H*hd) in the model
    dtype. The ssm family (rwkv6) has the WKV state ``ssm_state`` (L, B, H,
    hd, hd) in fp32 and the token-shift states ``shift_tm``/``shift_cm``
    (L, B, D) in the model dtype. The vlm family has the dense layout; the
    encdec family adds the cross-attention K/V of the encoder's output,
    ``cross_k``/``cross_v`` (L, B, seq_len // 2, KV*hd) in the model dtype.
    """
    L, dt = cfg.n_layers, cfg.torch_dtype
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        H, hd = cfg.n_ssm_heads, cfg.ssm.head_dim
        cache["ssm_state"] = torch.zeros((L, batch, H, hd, hd),
                                         dtype=torch.float32, device=device)
        for k in ("shift_tm", "shift_cm"):
            cache[k] = torch.zeros((L, batch, cfg.d_model), dtype=dt,
                                   device=device)
        return cache
    C = effective_cache_len(cfg, seq_len)
    shape = (L, batch, C, cfg.n_kv_heads * cfg.head_dim_)
    kv_dt = torch.int8 if cfg.kv_quant else dt
    cache["k"] = torch.zeros(shape, dtype=kv_dt, device=device)
    cache["v"] = torch.zeros(shape, dtype=kv_dt, device=device)
    if cfg.kv_quant:
        for k in ("k_scale", "v_scale"):
            cache[k] = torch.zeros((L, batch, C, cfg.n_kv_heads), dtype=dt,
                                   device=device)
    if cfg.family == "hybrid":
        H, hd, cw = cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.conv_width
        cache["ssm_state"] = torch.zeros((L, batch, H, hd, cfg.ssm.state_size),
                                         dtype=torch.float32, device=device)
        if cw > 1:
            cache["conv_state"] = torch.zeros((L, batch, cw - 1, H * hd),
                                              dtype=dt, device=device)
    if cfg.is_encdec:
        shape = (L, batch, seq_len // 2, cfg.n_kv_heads * cfg.head_dim_)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache
