"""Attention for every family (``repro.models.attention``): causal
self-attention, the encoder's unmasked self-attention and the decoder's
cross-attention on the encoder's output.

Prefill self-attention (causal, or unmasked in the encoder) runs through
``ops.flash_attention`` and decode through ``ops.decode_attention``
(``ops.decode_attention_int8`` on the int8 cache of ``cfg.kv_quant``, which
dequantizes inside the kernel); q and k are roped by ``ops.rope``, and at a
decode step by ``ops.rope_append``, which also writes the new K/V into the
ring (the int8 ring ropes with ``ops.rope`` and quantizes on its own): on
the card these are the hand-written Hopper kernels, on the CPU their plain
versions. Cross-attention at
prefill has more keys than queries, which the flash kernel does not take
(nor does the Pallas kernel): it runs ``attention_xla``, as the reference
runs its XLA path. Cross-attention at decode is the decode kernel over the
cached encoder K/V, whose ring rule keeps every slot when ``pos`` is the
last slot. The JAX XLA path casts the softmax weights to the model dtype
before P.V. The bf16 prefill kernel does the same (its P.V runs on the
tensor cores); the decode kernels, the fp32 prefill kernel and the plain
versions keep P in fp32, as the Pallas kernels do, so in bf16 they differ
from the XLA path by about one bf16 rounding.

Training (``attend(..., is_train=True)``) takes no kernel: the kernels have
no backward, and JAX trains on its XLA path. ``attention_xla`` is that
path in eager, differentiable torch ops on any device, with the XLA
rounding: fp32 scores, an fp32 softmax, the weights cast to the value
dtype before P.V.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rope import rope_plain
from repro_torch.models.common import init_param, rms_norm

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   device: torch.device, cross: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """One layer's projections, in the JAX (d_in, d_out) orientation; with
    ``cfg.qkv_bias`` the biases ``bq``, ``bk``, ``bv`` (zeros, as JAX
    initialises them), and with ``cfg.qk_norm`` the per-head gains
    ``q_norm`` and ``k_norm``. A ``cross`` layer has neither."""
    hq, d, hd, kv = cfg.n_attn_heads, cfg.d_model, cfg.head_dim_, cfg.n_kv_heads
    dt = cfg.torch_dtype
    p = {
        "wq": init_param((d, hq * hd), generator, dt, device),
        "wk": init_param((d, kv * hd), generator, dt, device),
        "wv": init_param((d, kv * hd), generator, dt, device),
        "wo": init_param((hq * hd, d), generator, dt, device,
                         scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((hq * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dt, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    return p


def _project_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                 kv_x: Optional[torch.Tensor] = None, is_train: bool = False):
    """Returns q (B,S,KV,G,hd), k,v (B,Skv,KV,hd); head h = kv*G + g. K and
    V come from ``kv_x`` (B,Skv,D) when given (cross-attention), else from
    x. With ``bq`` in p the biases are added to the three projections; with
    ``q_norm`` in p, q and k are then RMS-normalised over the head dim (the
    rmsnorm kernel when serving on the card)."""
    src = x if kv_x is None else kv_x
    hd, kvh = cfg.head_dim_, cfg.n_kv_heads
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[:2]
    Skv = src.shape[1]
    g = q.shape[-1] // hd // kvh
    q, k = q.view(B, S, kvh, g, hd), k.view(B, Skv, kvh, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, is_train=is_train)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, is_train=is_train)
    return q, k, v.view(B, Skv, kvh, hd)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, cfg: ModelConfig,
          causal: bool) -> torch.Tensor:
    """(len(qpos), len(kpos)) additive mask in fp32: causal if asked, and
    the window and chunk of ``cfg`` in any case, as the reference masks
    every full-sequence attention."""
    qp, kp = qpos[:, None], kpos[None, :]
    ok = torch.ones((qp.shape[0], kp.shape[1]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kp <= qp
    if cfg.sliding_window is not None:
        ok &= (qp - kp) < cfg.sliding_window
    if cfg.attn_chunk is not None:
        ok &= (qp // cfg.attn_chunk) == (kp // cfg.attn_chunk)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _pick_chunk(s: int, target: int = 1024) -> int:
    if s <= target:
        return s
    c = target
    while s % c:
        c //= 2
    return max(c, 1)


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, causal: bool = True) -> torch.Tensor:
    """Attention as the JAX XLA path computes it, over query chunks of at
    most 1024 rows. q: (B,S,KV,G,hd); k/v: (B,Skv,KV,hd) -> (B,S,KV*G*hd)
    in v's dtype. Query i sits at position i and key j at position j, for
    the causal mask and for the window and chunk of ``cfg``."""
    B, S = q.shape[:2]
    hd = q.shape[-1]
    kf = k.float()
    qpos = torch.arange(S, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    c = _pick_chunk(S)
    outs = []
    for i in range(0, S, c):
        s = torch.einsum("bckgh,btkh->bkgct", q[:, i:i + c].float(), kf) \
            * hd ** -0.5
        s = s + _mask(qpos[i:i + c], kpos, cfg, causal)
        w = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgct,btkh->bckgh", w, v))
    return torch.cat(outs, dim=1).reshape(B, S, -1)


def attend(p: Dict, cfg: ModelConfig, x: torch.Tensor, *,
           causal: bool = True, kv_x: Optional[torch.Tensor] = None,
           use_rope: bool = True, return_kv: bool = False,
           is_train: bool = False):
    """Full-sequence attention. x: (B,S,D) -> (B,S,D).

    Self-attention (``kv_x`` None) is roped when ``use_rope`` and runs
    ``ops.flash_attention`` when serving, causal or not;
    cross-attention on ``kv_x`` (B,Skv,D) is not roped and runs
    ``attention_xla``, as does everything under ``is_train``. With
    ``return_kv`` also returns the flat K/V (B,Skv,KV*hd), roped where q
    is, for the prefill cache."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = _project_qkv(p, cfg, x, kv_x=kv_x, is_train=is_train)
    if use_rope and kv_x is None:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)
        qh = q.reshape(B, S, -1, hd)                         # (B,S,Hq,hd)
        if is_train:      # differentiable torch ops: the kernel has no backward
            qh, k = (rope_plain(qh, pos, cfg.rope_theta),
                     rope_plain(k, pos, cfg.rope_theta))
        else:
            qh, k = ops.rope(qh, k, pos, cfg.rope_theta)     # k (B,S,KV,hd)
        q = qh.view(q.shape)
    if is_train or kv_x is not None:
        out = attention_xla(q, k, v, cfg, causal=causal)
    else:
        out = ops.flash_attention(q.reshape(B, S, -1, hd).transpose(1, 2),
                                  k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=cfg.sliding_window,
                                  chunk=cfg.attn_chunk)
        out = out.transpose(1, 2).reshape(B, S, -1)
    proj = out @ p["wo"]
    if return_kv:
        return proj, (k.reshape(B, k.shape[1], -1), v.reshape(B, v.shape[1], -1))
    return proj


def pack_ring(kv: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Place a prefilled K/V sequence (B,S,F) into its ring-buffer slots
    (token t -> slot t % C), keeping only the last ``cache_len`` tokens."""
    B, S, F = kv.shape
    C = cache_len
    if S == C:
        return kv
    if S > C:
        return torch.roll(kv[:, S - C:], S % C, dims=1)
    pad = torch.zeros((B, C - S, F), dtype=kv.dtype, device=kv.device)
    return torch.cat([kv, pad], dim=1)


# ---------------------------------------------------------------------------
# int8 KV quantization (per-token-per-head symmetric), in JAX's order of
# operations: an fp32 scale max|x| / 127 (1.0 where it is 0), codes
# round(x / scale) (half to even, by division, not by a reciprocal) clamped
# to +-127, and the scale stored in x's dtype. Dequantizing uses that stored
# (in bf16, rounded) scale, so a round trip is not the identity.
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, n_kv_heads: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., KVH*hd) -> (int8 codes of x's shape, scales (..., KVH))."""
    hd = x.shape[-1] // n_kv_heads
    xr = x.reshape(*x.shape[:-1], n_kv_heads, hd).float()
    scale = xr.abs().amax(-1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xr / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(x.shape), scale.to(x.dtype)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of quantize_kv; returns (..., KVH*hd) in ``dtype``."""
    kvh = scale.shape[-1]
    hd = q.shape[-1] // kvh
    xr = q.reshape(*q.shape[:-1], kvh, hd).float() * scale[..., None].float()
    return xr.reshape(q.shape).to(dtype)


def decode_attend(p: Dict, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> Tuple:
    """One-token attention against the ring-buffer cache.

    x: (B,1,D); pos: (B,) int32 tokens so far; k/v_cache: (B,C,KV*hd), int8
    with ``cfg.kv_quant`` beside per-token-per-head scales k/v_scale
    (B,C,KV). The new K/V (codes and scales) is written into slot
    ``pos % C`` IN PLACE (the JAX version returns updated copies); returns
    (out, k_cache, v_cache), or with kv_quant (out, k_cache, v_cache,
    k_scale, v_scale)."""
    B = x.shape[0]
    C = k_cache.shape[1]
    hd, kvh = cfg.head_dim_, cfg.n_kv_heads
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q = q.reshape(B, 1, -1, hd)                                      # (B,1,Hq,hd)
    # (B,C,KV*hd) viewed as the kernel's (B,KV,C,hd): strides, no copy
    kc = k_cache.view(B, C, kvh, hd).transpose(1, 2)
    vc = v_cache.view(B, C, kvh, hd).transpose(1, 2)
    win, chunk = cfg.sliding_window, cfg.attn_chunk
    if cfg.kv_quant:
        q, k_new = ops.rope(q, k_new, pos[:, None], cfg.rope_theta)
        slot = torch.remainder(pos.long(), C)
        bidx = torch.arange(B, device=x.device)
        k_cache[bidx, slot], k_scale[bidx, slot] = quantize_kv(
            k_new[:, 0].reshape(B, -1), kvh)
        v_cache[bidx, slot], v_scale[bidx, slot] = quantize_kv(
            v_new[:, 0].reshape(B, -1), kvh)
        # scales (B,C,KV) as the kernel's (B,KV,C)
        o = ops.decode_attention_int8(q[:, 0], kc, vc, k_scale.transpose(1, 2),
                                      v_scale.transpose(1, 2), pos,
                                      window=win, chunk=chunk)
    else:         # rope q and k_new, then k_new and v_new into slot pos % C
        q = ops.rope_append(q, k_new, v_new, pos, k_cache, v_cache,
                            cfg.rope_theta)
        o = ops.decode_attention(q[:, 0], kc, vc, pos, window=win, chunk=chunk)
    out = o.reshape(B, 1, -1) @ p["wo"]
    if cfg.kv_quant:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


def cross_decode_attend(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                        cross_k: torch.Tensor, cross_v: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention of one token against the encoder's K/V.

    x: (B,1,D); cross_k/v: (B,S_enc,KV*hd), read only; pos: (B,) int32
    equal to S_enc - 1. The decode kernel takes the K/V as its ring of C =
    S_enc slots, seen as (B,KV,S_enc,hd) through strides with no copy:
    with pos = C - 1 slot j holds position j, so no slot is masked and the
    softmax runs over all of them, as the reference's unmasked one."""
    B = x.shape[0]
    hd, kvh = cfg.head_dim_, cfg.n_kv_heads
    S_enc = cross_k.shape[1]
    q = (x @ p["wq"]).view(B, -1, hd)                     # (B,Hq,hd)
    kc = cross_k.view(B, S_enc, kvh, hd).transpose(1, 2)
    vc = cross_v.view(B, S_enc, kvh, hd).transpose(1, 2)
    o = ops.decode_attention(q, kc, vc, pos)
    return o.reshape(B, 1, -1) @ p["wo"]
