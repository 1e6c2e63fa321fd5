"""deepseek-v2-lite [moe] — latent attention (MLA, no q compression), 64
fine-grained experts top-6 with 2 shared, the first layer dense, yarn rope.
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite]

Not one of the JAX package's architectures: it is registered for
``get_config`` and kept out of ``ARCH_IDS``/``ALL_IDS``, which follow the
JAX package's registry."""
from repro_torch.configs.base import ModelConfig, MoEConfig, YarnScaling

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,                 # qk_nope_head_dim + qk_rope_head_dim
    d_ff=10944,                   # the dense first layer
    vocab_size=102400,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    moe=MoEConfig(n_experts=64, top_k=6, interleave=1, n_shared_experts=2,
                  d_expert=1408, n_dense_layers=1, scoring="softmax_topk"),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_scaling=YarnScaling(factor=40.0, original_max_position_embeddings=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                             mscale_all_dim=0.707),
)
