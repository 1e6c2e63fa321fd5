"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
chunked local attention (iRoPE-style), MoE every other layer (a copy of
``repro.configs.llama4_maverick_400b_a17b``). [hf:meta-llama/Llama-4-*;
unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attn_chunk=8192,
    moe=MoEConfig(n_experts=128, top_k=1, interleave=2, n_shared_experts=1),
    rope_theta=500_000.0,
)
