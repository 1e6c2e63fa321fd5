"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay WKV recurrence.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # 64 WKV heads of dim 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,          # channel-mix hidden
    vocab_size=65536,
    ssm=SSMConfig(state_size=64, head_dim=64, conv_width=0, kind="rwkv6"),
    act="gelu",          # rwkv channel-mix uses squared relu; see models/rwkv.py
)
