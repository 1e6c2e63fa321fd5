"""qwen3-4b [dense] — qk_norm, GQA kv=8, head_dim=128 decoupled from
d_model (a copy of ``repro.configs.qwen3_4b``). [hf:Qwen/Qwen3-*; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
