"""Model/shape configuration (a copy of ``repro.configs.base``).

The only change from the reference is ``torch_dtype`` in place of
``jnp_dtype``, so that this module imports no JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    # 1 = every layer is MoE, 2 = every other layer (interleaved dense/MoE)
    interleave: int = 1
    n_shared_experts: int = 0  # llama4-style always-on shared expert


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Covers RWKV6 time-mix and Mamba-style heads (hymba)."""
    state_size: int = 16          # per-head recurrent state width
    head_dim: int = 64            # SSM head dim
    conv_width: int = 4           # local conv (mamba); 0 disables
    kind: str = "rwkv6"           # "rwkv6" | "mamba"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA window
    attn_chunk: Optional[int] = None      # chunked local attention
    # families
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    ssm_head_ratio: float = 0.0
    # enc-dec
    n_encoder_layers: int = 0             # >0 => encoder-decoder
    # modality frontend stub: "none" | "audio_frames" | "vision_patches"
    frontend: str = "none"
    n_frontend_tokens: int = 0
    # misc
    act: str = "swiglu"                   # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "block"
    unroll: bool = False
    kv_quant: bool = False

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256."""
        return pad_to_multiple(self.vocab_size, 256)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode state is sub-quadratic (bounded KV or O(1) state)."""
        return (
            self.attn_free
            or self.sliding_window is not None
            or self.attn_chunk is not None
        )

    @property
    def n_attn_heads(self) -> int:
        """Heads doing attention (hybrid splits heads between attn and SSM)."""
        if self.family == "hybrid":
            n_ssm = int(round(self.n_heads * self.ssm_head_ratio))
            return self.n_heads - n_ssm
        return self.n_heads

    @property
    def n_ssm_heads(self) -> int:
        if self.family == "ssm":
            return self.d_model // (self.ssm.head_dim if self.ssm else 64)
        if self.family == "hybrid":
            return self.n_heads - self.n_attn_heads
        return 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """Which decoder layers are MoE layers."""
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        k = self.moe.interleave
        return tuple((i % k) == (k - 1) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim_
        qdim = self.n_attn_heads * hd
        kvdim = self.n_kv_heads * hd
        attn = d * qdim + 2 * d * kvdim + qdim * d
        if self.family == "hybrid" or self.family == "ssm":
            sd = (self.ssm.head_dim if self.ssm else 64) * self.n_ssm_heads
            st = self.ssm.state_size if self.ssm else 16
            ssm_p = 2 * d * sd + sd * d + sd * st * 2
            attn = (attn if self.family == "hybrid" else 0) + ssm_p
        n_ff_mats = 3 if self.act == "swiglu" else 2
        dense_ff = n_ff_mats * d * f
        total = 0
        mask = self.moe_layer_mask()
        for i in range(self.n_layers):
            total += attn + 2 * d  # norms
            if self.moe is not None and mask[i]:
                e = self.moe.n_experts + self.moe.n_shared_experts
                total += e * n_ff_mats * d * f + d * self.moe.n_experts
            else:
                total += dense_ff
        if self.is_encdec:
            enc = self.n_encoder_layers * (attn + dense_ff + 2 * d)
            cross = self.n_layers * (d * qdim + 2 * d * kvdim + qdim * d)
            total += enc + cross
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k active) — for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_ff_mats = 3 if self.act == "swiglu" else 2
        per_expert = n_ff_mats * d * f
        inactive = 0
        for m in self.moe_layer_mask():
            if m:
                inactive += (self.moe.n_experts - self.moe.top_k) * per_expert
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=257,   # deliberately non-round: exercises vocab padding
            head_dim=16,
            sliding_window=8 if self.sliding_window else None,
            attn_chunk=8 if self.attn_chunk else None,
            n_encoder_layers=2 if self.is_encdec else 0,
            n_frontend_tokens=4 if self.frontend != "none" else 0,
        )
        if self.moe:
            kw["moe"] = MoEConfig(
                n_experts=min(4, self.moe.n_experts),
                top_k=min(self.moe.top_k, 2),
                interleave=self.moe.interleave,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
            )
        if self.ssm:
            st = 16 if self.ssm.kind == "rwkv6" else 8  # rwkv: st == hd
            kw["ssm"] = SSMConfig(state_size=st, head_dim=16,
                                  kind=self.ssm.kind)
        if self.family == "hybrid":
            kw["ssm_head_ratio"] = 0.5
        return dataclasses.replace(self, **kw)
