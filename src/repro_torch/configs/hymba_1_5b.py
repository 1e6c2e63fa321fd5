"""hymba-1.5b [hybrid] — parallel attention + Mamba heads in every layer,
SWA on the attention heads, ssm_state=16 (a copy of
``repro.configs.hymba_1_5b``). [arXiv:2411.13676; hf]

25 heads x 64 dim = 1600 = d_model. ssm_head_ratio=0.4 gives 10 SSM heads and
15 attention heads (divisible by the 5 KV heads for GQA).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    ssm=SSMConfig(state_size=16, head_dim=64, conv_width=4, kind="mamba"),
    ssm_head_ratio=0.4,
)
