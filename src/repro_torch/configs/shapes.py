"""The assigned input shapes and the decode-time cache
(``repro.configs.shapes``).

``input_specs`` gives the data arguments of the step function of a
shape's kind (``loss_fn``'s batch, ``prefill_step``'s batch or
``decode_step``'s tokens and cache) as tensors on the ``meta`` device, so
even ``long_500k`` allocates nothing; ``alloc_cache`` is the counterpart of
``cache_specs`` on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES: Dict[str, ShapeSpec] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it is skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "pure full-attention arch: 500K dense-KV decode is skipped"
    return None


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


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, object]:
    """The step function's data arguments for ``shape.kind``, as tensors on
    the meta device: token leaves int32, ``frames`` (encdec: half the
    sequence, the decoder the other half) and ``patches`` (vlm: the
    frontend's tokens before the text) in the model dtype, and for decode
    ``tokens`` (B, 1) beside the cache ``alloc_cache`` lays out for B rows
    of S tokens. The frontends are stubs: frames and patches are
    precomputed embeddings."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def t(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=meta)

    if shape.kind == "decode":
        return {"tokens": t(B, 1), "cache": alloc_cache(cfg, B, S, meta)}
    assert shape.kind in ("train", "prefill"), shape.kind
    if cfg.is_encdec:
        batch = {"frames": t(B, S // 2, cfg.d_model, dtype=cfg.torch_dtype),
                 "tokens": t(B, S // 2)}
        if shape.kind == "train":
            batch["targets"] = t(B, S // 2)
        return batch
    batch = {}
    text_len = S
    if cfg.frontend == "vision_patches":
        n = cfg.n_frontend_tokens
        text_len = S - n
        batch["patches"] = t(B, n, cfg.d_model, dtype=cfg.torch_dtype)
    batch["tokens"] = t(B, text_len)
    if shape.kind == "train":
        batch["targets"] = t(B, text_len)
    return batch


# logical sharding axes of the data arguments' leaves
_CACHE_AXES = {
    "pos": ("batch",),
    "k": ("layers", "batch", "cache_seq", "kv"),
    "v": ("layers", "batch", "cache_seq", "kv"),
    "k_scale": ("layers", "batch", "cache_seq", ""),
    "v_scale": ("layers", "batch", "cache_seq", ""),
    "ssm_state": ("layers", "batch", "", "", ""),
    "shift_tm": ("layers", "batch", "act_embed"),
    "shift_cm": ("layers", "batch", "act_embed"),
    "conv_state": ("layers", "batch", "", "ssm_dim"),
    "cross_k": ("layers", "batch", "cache_seq", "kv"),
    "cross_v": ("layers", "batch", "cache_seq", "kv"),
}

_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "frames": ("batch", "seq", "act_embed"),
    "patches": ("batch", "seq", "act_embed"),
}


def input_axes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, object]:
    """Logical axes with the structure of ``input_specs``."""
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "cache":
            out["cache"] = {ck: _CACHE_AXES[ck] for ck in v}
        else:
            out[k] = _BATCH_AXES[k]
    return out
