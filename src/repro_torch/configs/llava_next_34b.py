"""llava-next-34b [vlm] — decoder-only LM backbone; anyres tiling enters as
more precomputed patch embeddings via the STUB frontend (a copy of
``repro.configs.llava_next_34b``). [hf:llava-hf/llava-v1.6-*; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision_patches",
    n_frontend_tokens=2880,   # anyres: 5 tiles x 576 patches
)
