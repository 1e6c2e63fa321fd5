"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone, MHA kv=16 (a
copy of ``repro.configs.seamless_m4t_large_v2``). The speech frontend is a
STUB: the caller hands in precomputed frame embeddings (B, S_enc, d_model).
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,    # encoder layers (24L each side)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio_frames",
    act="gelu",
)
