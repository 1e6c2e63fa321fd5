"""qwen1.5-32b [dense] — QKV bias, MHA kv=40 (a copy of
``repro.configs.qwen1_5_32b``). [hf:Qwen/Qwen1.5-*; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
)
