"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, SWA (a copy of
``repro.configs.mixtral_8x22b``). [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, interleave=1),
    rope_theta=1_000_000.0,
)
